"""CCT's auxiliary-decoder perturbations (counterpart of
``pixelssl_tpu/models/cct_decoders.py``; reference
pixelssl/ssl_algorithm/ssl_cct.py:542-745), NCHW.

Each perturbation is a function of the latent and of its random draw,
which it takes as a tensor; the ``draw_*`` functions make those draws from
a ``torch.Generator``, apart from the arithmetic, so that a caller can hand
over other draws (the JAX package's, in the parity tests). The guided
cutout erases a random box inside each of the two largest foreground
components of the main prediction, the components labelled on the device
(``ops/components.py``), where the reference walks OpenCV contours on the
host.

Inside a ``parallel.spatial.sharded`` block the latent is this rank's rows
of a map whose global height the caller passes, and each draw this rank's
part of the global draw: the per-sample norm and maximum reduce over the
spatial group (``spatial.group_sum``, ``spatial.sample_max``), VAT's
inner gradient runs the decoder's row exchanges backwards on every rank
alike, and the guided cutout labels the components of the whole
foreground mask, gathered on every rank (a component may cross a rank's
rows any number of times), then keeps this rank's rows of its mask; the
masking decoders resize the rank's own rows of the foreground.
"""

import torch

from ..ops.components import label_components, top_k_components
from ..parallel import spatial
from .layers import resize_nearest


def l2_normalize_per_sample(d):
    """``d`` over its per-sample L2 norm plus 1e-8 (reference
    ssl_cct.py:578-582)."""
    norm = torch.sqrt(spatial.group_sum(torch.sum(
        torch.square(d), dim=tuple(range(1, d.dim())), keepdim=True)))
    return d / (norm + 1e-8)


def draw_vat(generator, shape, device):
    """VAT's starting direction, uniform in [-0.5, 0.5) of the latent's
    shape."""
    return torch.rand(shape, generator=generator, device=device) - 0.5


def vat_perturbation(dec, x, d, xi, eps, iterations=1):
    """VAT's adversarial perturbation of the latent ``x`` from the starting
    direction ``d`` (reference ssl_cct.py:555-576). The inner gradient is
    taken with respect to the perturbation only, on a graph from the
    detached latent, so the decoder's parameters gather no gradient. In a
    spatial context the KL is this rank's share (its pixels over the
    samples), whose gradient the decoder's row exchanges complete."""
    x_d = x.detach()
    with torch.no_grad():
        pred = torch.softmax(dec(x_d).float(), dim=1)
    plogp = torch.where(pred > 0, pred * torch.log(pred),
                        torch.zeros_like(pred))
    d = l2_normalize_per_sample(d.float())
    for _ in range(iterations):
        d = d.detach().requires_grad_()
        with torch.enable_grad():
            logp_hat = torch.log_softmax(
                dec(x_d + xi * d.to(x.dtype)).float(), dim=1)
            # F.kl_div(logp_hat, pred, 'batchmean') with 0 log 0 = 0
            kl = torch.sum(plogp - pred * logp_hat) / x.shape[0]
            grad, = torch.autograd.grad(kl, d)
        d = l2_normalize_per_sample(grad)
    return (d * eps).detach().to(x.dtype)


def draw_keep(generator, shape, rate, device):
    """A keep mask, True with probability ``1 - rate``: [B,C,1,1] for
    spatial dropout, the latent's shape for element dropout."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def spatial_dropout(x, keep, rate):
    """``nn.Dropout2d``: whole channels of a sample dropped, ``keep``
    [B,C,1,1]."""
    return x * keep.to(x.dtype) / (1.0 - rate)


def element_dropout(x, keep, rate):
    return x * keep.to(x.dtype) / (1.0 - rate)


def _foreground_mask(main_pred):
    """[B,H,W] bool: the argmax of the [B,C,H,W] logits over classes is not
    0 (reference ssl_cct.py:610-614,663-666)."""
    return main_pred.argmax(dim=1) > 0


def _whole_foreground_mask(main_pred):
    """``_foreground_mask`` of the whole map on every rank of the spatial
    group (each rank's rows fetched, without gradient); of ``main_pred``
    outside a context."""
    with torch.no_grad():
        mask = _foreground_mask(main_pred).to(torch.uint8)
        return spatial.whole_rows(mask, dim=1).bool()


def draw_cutout(generator, batch, n_components, device):
    """The cutout's uniforms: (rows, columns), each [B, k] (k = 1 for the
    union-bbox variant)."""
    k = max(n_components, 1)
    u_h = torch.rand((batch, k), generator=generator, device=device)
    u_w = torch.rand((batch, k), generator=generator, device=device)
    return u_h, u_w


def guided_cutout_mask(main_pred, u_h, u_w, erase, resize, n_components=2):
    """A [B,1,h,w] float mask, 0 in a random box inside each of the
    ``n_components`` largest foreground components (area above 50) of
    ``main_pred`` and 1 elsewhere, nearest-resized from the prediction's
    size to ``resize`` (JAX cct_decoders.py:82-135). The box is
    ``floor(bb * erase)`` of the component's bounding box a side, its start
    ``floor(u * (floor(bb * (1 - erase)) + 1))`` into the box, from the
    uniforms ``u_h``, ``u_w`` [B,k]. ``n_components=0``: one box in the
    union of the foreground's bounding box. In a spatial context
    ``resize`` is the latent's global size, and the result this rank's rows
    of the mask."""
    masks = _whole_foreground_mask(main_pred)
    b, h, w = masks.shape
    device = masks.device
    rows = torch.arange(h, device=device, dtype=torch.float32).reshape(
        1, 1, h, 1)
    cols = torch.arange(w, device=device, dtype=torch.float32).reshape(
        1, 1, 1, w)
    big = 1e9
    if n_components and n_components > 0:
        comp, _ = top_k_components(label_components(masks), n_components,
                                   min_size=50)
    else:
        any_fg = masks.sum(dim=(1, 2)) > 50
        comp = (masks & any_fg[:, None, None])[:, None]

    def extreme(coord, fill, reduce):
        return reduce(torch.where(comp, coord, fill).flatten(2), dim=2)

    min_h = extreme(rows, big, torch.amin)
    max_h = extreme(rows, -big, torch.amax)
    min_w = extreme(cols, big, torch.amin)
    max_w = extreme(cols, -big, torch.amax)
    bb_h = torch.clamp(max_h - min_h, min=0.0)
    bb_w = torch.clamp(max_w - min_w, min=0.0)
    # randint(0, int(bb * (1 - erase))) inclusive == floor(u * (that + 1))
    start_h = min_h + torch.floor(u_h * (torch.floor(bb_h * (1 - erase)) + 1.0))
    start_w = min_w + torch.floor(u_w * (torch.floor(bb_w * (1 - erase)) + 1.0))
    end_h = start_h + torch.floor(bb_h * erase)
    end_w = start_w + torch.floor(bb_w * erase)

    def box(t):
        return t[:, :, None, None]

    present = comp.flatten(2).any(dim=2)
    inside = ((rows >= box(start_h)) & (rows < box(end_h)) &
              (cols >= box(start_w)) & (cols < box(end_w)) & box(present))
    mask_ones = (~inside.any(dim=1, keepdim=True)).float()
    return resize_nearest(mask_ones, resize, whole=True)


def guided_masking(x, main_pred, return_context, h=None):
    """Context masking (the foreground of the main prediction kept) or
    object masking (its background kept), the mask nearest-resized to the
    latent (reference ssl_cct.py:675-690); ``h``: the latent's global
    height in a spatial context."""
    mask = resize_nearest(_foreground_mask(main_pred)[:, None].float(),
                          (x.shape[2] if h is None else h, x.shape[3]),
                          spatial.global_height(main_pred)).to(x.dtype)
    return mask * x if return_context else (1.0 - mask) * x


def draw_feature_drop(generator, batch, device):
    """The attention threshold's fraction of its maximum, uniform in
    [0.7, 0.9) a sample, [B,1,1,1]."""
    u = torch.rand((batch, 1, 1, 1), generator=generator, device=device)
    return 0.7 + 0.2 * u


def feature_dropout(x, u):
    """Zero the pixels whose mean over channels reaches ``u`` [B,1,1,1]
    times its per-sample maximum (reference ssl_cct.py:712-728)."""
    attention = x.float().mean(dim=1, keepdim=True)
    max_val = spatial.sample_max(attention)
    return x * (attention < max_val * u).to(x.dtype)


def draw_feature_noise(generator, shape, uniform_range, device):
    """One [C,H,W] noise, uniform in [-r, r), shared by the batch."""
    u = torch.rand(shape, generator=generator, device=device)
    return (2.0 * u - 1.0) * uniform_range


def feature_noise(x, noise):
    """Multiplicative noise ``x * (1 + noise)``, ``noise`` [C,H,W] shared
    across the batch (reference ssl_cct.py:731-745)."""
    return x * (1.0 + noise[None].to(x.dtype))
