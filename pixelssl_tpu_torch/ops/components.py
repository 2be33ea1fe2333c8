"""Connected-component labelling on the device (counterpart of
``pixelssl_tpu/ops/components.py``), for CCT's guided cutout.

Min-label propagation with segmented cumulative minima: every foreground
pixel starts with its flat index ``h*W + w``, background pixels with
``H*W``; a sweep takes a segmented running minimum along W forwards and
backwards, then along H forwards and backwards, background pixels being
the segment barriers. ``n_sweeps`` sweeps give the JAX function's labels
exactly (the same integer minima in the same order).

PyTorch has ``torch.cummin`` but no segmented scan. Along an axis of
length ``n``, with ``seg = cumsum(barrier)`` (a barrier opens its own
segment), the key ``(n - seg) * (H*W + 1) + label`` is smaller in every
later segment than in any earlier one, so its running minimum is the
minimum of the current segment; the label is decoded by subtracting the
segment's part again. No host round trip.

The scans run along H, and a component may cross a rank's rows any number
of times: under ``--spatial-train`` CCT labels the whole mask, gathered on
every rank (``models/cct_decoders.py``), so that the labels are one
process's flat indices.
"""

import torch


def _segmented_cummin(labels, barrier, dim, span):
    n = labels.shape[dim]
    seg_part = (n - torch.cumsum(barrier, dim)) * span
    return torch.cummin(seg_part + labels, dim).values - seg_part


def label_components(mask, n_sweeps=6):
    """4-connected component labels of a [B,H,W] bool mask as int64
    [B,H,W]: the smallest flat index in the pixel's component for
    foreground pixels, ``H*W`` for background (JAX components.py:38-76).
    Exact when every component's geodesics need at most ``n_sweeps``
    changes of direction; a longer spiral splits, as in JAX."""
    b, h, w = mask.shape
    big = h * w
    idx = torch.arange(big, device=mask.device).reshape(1, h, w)
    labels = torch.where(mask, idx, big)
    barrier = (~mask).to(torch.int64)
    for _ in range(n_sweeps):
        for dim in (2, 1):
            for rev in (False, True):
                lab = labels.flip(dim) if rev else labels
                bar = barrier.flip(dim) if rev else barrier
                v = _segmented_cummin(lab, bar, dim, big + 1)
                if rev:
                    v = v.flip(dim)
                labels = torch.minimum(labels, torch.where(mask, v, big))
    return labels


def top_k_components(labels, k, min_size=0):
    """The ``k`` largest components of ``label_components``' output, the
    lower label first among equal areas (``jax.lax.top_k``'s order): masks
    [B,k,H,W] bool and areas [B,k] int64; a slot whose component has at
    most ``min_size`` pixels is all False with area 0 (JAX
    components.py:79-98)."""
    b, h, w = labels.shape
    hw = h * w
    flat = labels.reshape(b, hw)
    sizes = torch.zeros((b, hw + 1), dtype=torch.int64, device=labels.device)
    sizes.scatter_add_(1, flat, torch.ones_like(flat))  # hw: the background
    top_sizes, top_labels = torch.sort(sizes[:, :hw], dim=1, descending=True,
                                       stable=True)
    top_sizes, top_labels = top_sizes[:, :k], top_labels[:, :k]
    valid = top_sizes > min_size
    masks = ((labels[:, None] == top_labels[:, :, None, None]) &
             valid[:, :, None, None])
    return masks, torch.where(valid, top_sizes, 0)
