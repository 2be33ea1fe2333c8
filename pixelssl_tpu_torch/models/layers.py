"""Shared building blocks (counterpart of ``pixelssl_tpu/models/layers.py``),
NCHW.

* ``SyncBatchNorm``: the JAX package's cross-replica BatchNorm on one card
  is PyTorch's BatchNorm with torch momentum 0.1, the biased batch variance
  to normalise and the unbiased one in the running variance, eps 1e-5, the
  statistics in float32 (reference batchnorm.py:113-125). On one value per
  channel (PSPNet's 1x1 pyramid bin on one row) it normalises with variance
  0 and moves the running variance by ``var * n / max(n - 1, 1)`` = 0, as
  the JAX layer does, where PyTorch's raises. ``sample_weight`` keeps rows
  of weight 0 out of the statistics. In training under a process group of
  more than one rank (``sync``, a ``parallel.Mesh`` that the algorithm
  sets) it sums the float32 ``(sum, ssum, count)`` over the ranks, and
  differentiates through that sum, as the JAX layer ``psum``s them. On a
  bf16 input (autocast) it applies the statistics as the JAX layer does
  (its layers.py:93-104): float32 statistics folded into ``inv =
  rsqrt(var + eps) * weight`` and ``shift = bias - mean * inv``, each
  rounded to bf16, then ``x * inv + shift`` as two bf16 ops, in training,
  in eval, with ``sample_weight``, ``sync`` or ``update_stats`` off. A
  float32 input takes PyTorch's ``batch_norm`` as before.
* ``conv2d`` / ``Conv2d`` / ``Linear``: under bf16 autocast a bias is added
  after the product, rounded to bf16 first, as flax's ``nn.Conv`` and
  ``nn.Dense`` with ``dtype=bf16`` add it; float32 fuses it as before.
  Where the JAX package casts a bf16 result to float32 at once (a model's
  last convolution or dense layer, ASPP's sum), ``jax.jit`` leaves the
  last op before the cast unrounded; ``float32_out`` does the same.
* ``resize_bilinear``: both ``align_corners`` conventions. ``F.interpolate``
  is the same two-tap arithmetic as the JAX interpolation matrices.
* Row-sharded forms (``parallel.spatial``): inside ``spatial.sharded`` the
  input of each is this rank's rows of a map whose global height ``h`` the
  caller passes, and the output is its rows of the output map. ``Conv2d``
  (an ``nn.Conv2d``, same parameters and names) and ``max_pool2d`` fetch
  the rows their output rows' windows read, zero- or -inf-filled outside
  the map, and run with padding 0 along H; a 1x1 stride-1 convolution
  needs no rows of another rank. ``Conv2d(same=True)`` pads as flax's
  ``'SAME'`` (``total // 2`` before, the rest after), along H from the
  global height. ``resize_bilinear`` (both conventions) and
  ``resize_nearest`` fetch the input rows their output rows read; with
  ``whole=True`` the input is a map every rank holds whole (PSP's pooled
  bins, a gathered mask) and each rank computes its rows of the output
  from it. ``adaptive_avg_pool`` sums each bin's part of the rank's rows
  and the spatial group sums the parts (``spatial.group_sum``): every
  rank holds the whole pooled map. ``pixel_shuffle`` fetches the input
  rows of its output rows in ``row_range`` of the output height, so that
  the output is dealt as every other map (a shuffle of each rank's own
  rows would not be when the height does not divide). ``SyncBatchNorm``
  with ``sync`` sums over every rank, which under ``--spatial-train`` is
  the grid. Outside a context these are the plain functions.
* ``resize_bilinear``'s row taps are PyTorch's float32 source indices
  (``area_pixel_compute_source_index``: ``scale * (i + 0.5) - 0.5``
  clamped at 0 without align_corners, ``i * (in - 1) / (out - 1)`` with
  it), those of ``F.interpolate`` and of the JAX interpolation matrices.
* ``resize_nearest``: source index ``i * in // out`` in integers, a gather;
  ``F.interpolate(mode='nearest')`` takes ``floor(i * (in / out))`` in
  floating point, which can round to another pixel.
* ``adaptive_avg_pool``: ``F.adaptive_avg_pool2d`` in float32; its floor /
  ceil bins are those of the JAX averaging matrices, bins larger than the
  input included.
* ``pixel_shuffle`` / ``icnr_init``: ``F.pixel_shuffle`` (channel
  ``c*r*r + i*r + j``, the JAX docstring's order); ICNR repeats each of the
  ``C`` sub-kernels ``r*r`` times along O, as the JAX initializer repeats
  along the last axis of HWIO.
* ``leaky_relu_02``: LeakyReLU(0.2); the JAX custom vjp was a workaround
  for the TPU compiler. On bf16 the slope is the JAX layer's bf16 0.2.
* ``lecun_normal_``: the flax ``Conv``/``Dense`` defaults the auxiliary
  modules start from.
* ``bf16_autocast``: the bf16 autocast region of every model, its cast
  cache off while a CUDA graph captures the step.
"""

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import all_sum, spatial


def bf16_autocast(x, enabled=True):
    """bf16 autocast on ``x``'s device. While a CUDA graph captures, the
    cache of cast weights is off: it lives for one autocast region, and a
    captured step must not keep tensors of its capture in it (PyTorch's
    rule for graphed autocast regions); the casts are the same either
    way."""
    capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
    return torch.autocast(x.device.type, dtype=torch.bfloat16,
                          enabled=enabled, cache_enabled=not capturing)


class SyncBatchNorm(nn.BatchNorm2d):
    """BatchNorm over (N, H, W) with torch-compatible statistics.

    ``forward(x, sample_weight)``: rows of weight 0 stay out of the batch
    statistics, as the JAX layer's ``sample_weight`` keeps padded samples
    out (its layers.py:50-89). ``update_stats`` False normalises with the
    batch statistics but leaves the running ones where they are: the
    recompute of a ``--remat`` block (``models/resnet.py``) runs its
    forward a second time, which must not move them again. ``sync`` (a
    ``parallel.Mesh`` of more than one rank, or None): the statistics are
    those of every rank's batch.
    """

    def __init__(self, num_features, momentum=0.1, eps=1e-5):
        super(SyncBatchNorm, self).__init__(num_features, eps=eps,
                                            momentum=momentum)
        self.update_stats = True
        self.sync = None

    def forward(self, x, sample_weight=None):
        low = x.dtype == torch.bfloat16
        if not low and not self.training:
            return super(SyncBatchNorm, self).forward(x)
        if (not low and sample_weight is None and self.sync is None and
                x.numel() != x.shape[1]):
            if self.update_stats:
                return super(SyncBatchNorm, self).forward(x)
            # scratch copies take the update: the autograd graph saves the
            # same tensors as the forward that moved the real statistics
            return F.batch_norm(x, self.running_mean.clone(),
                                self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum, self.eps)
        if not self.training:  # bf16 here: float32 took the native path
            return _ApplyBF16.apply(x, self.running_mean, self.running_var,
                                    None, self.weight, self.bias, self.eps,
                                    None)
        s, ss, count = self._sums(x, sample_weight)
        update = self if self.update_stats else None
        if low:
            return _ApplyBF16.apply(x, s, ss, count, self.weight, self.bias,
                                    self.eps, update)
        mean = s / count
        var = ss / count - mean.square()
        if update is not None:
            self._update_running(mean, var, count)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean[None, :, None, None]) *
                inv[None, :, None, None] +
                self.bias[None, :, None, None]).to(x.dtype)

    def _sums(self, x, sample_weight):
        """The per-channel float32 ``(sum, sum of squares, count)`` of
        ``x`` by hand (weighted rows, one value per channel), summed over
        the ranks."""
        per_sample = x.shape[2] * x.shape[3]
        if sample_weight is None:
            # a fill, not a copy from the host: capturable
            count = torch.full((1,), float(x.shape[0] * per_sample),
                               dtype=torch.float32, device=x.device)
            w = None
        else:
            w = sample_weight.float().reshape(-1, 1, 1, 1)
            count = (sample_weight.float().sum() * per_sample).reshape(1)
        if x.dtype == torch.bfloat16:
            s, ss = _Sums.apply(x, w)
        else:
            xf = x.float()
            if w is None:
                s = xf.sum(dim=(0, 2, 3))
                ss = xf.square().sum(dim=(0, 2, 3))
            else:
                s = (xf * w).sum(dim=(0, 2, 3))
                ss = (xf.square() * w).sum(dim=(0, 2, 3))
        if self.sync is not None:
            c = s.shape[0]
            sums = all_sum(torch.cat([s, ss, count]), self.sync)
            s, ss, count = sums[:c], sums[c:2 * c], sums[2 * c:]
        return s, ss, count

    def _update_running(self, mean, var, count):
        """The running statistics moved by the batch's biased ``mean`` and
        ``var`` (the unbiased variance), outside autograd: a recompute
        under ``--remat`` (statistics left alone) must save the tensors
        this forward saves. In place on ``.data``, as PyTorch's kernel
        updates them: an earlier forward's backward may still hold these
        buffers."""
        with torch.no_grad():
            unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
            stats = [self.running_mean.data, self.running_var.data]
            torch._foreach_mul_(stats, 1.0 - self.momentum)
            torch._foreach_add_(stats, [mean, unbiased],
                                alpha=self.momentum)
            self.num_batches_tracked.data.add_(1)


class _Sums(torch.autograd.Function):
    """The per-channel float32 ``(sum, sum of squares)`` of a bf16 ``x``,
    rows weighted by ``w`` ([N, 1, 1, 1] or None), as the JAX layer sums
    ``x.astype(float32)``. Its backward is the closed form of that
    graph's, ``bf16(w * (g_s + 2 x g_ss))`` in one pass, and it saves
    only the bf16 ``x`` (which the apply saves too): autograd through the
    float32 copy would save that copy and make four passes of float32
    maps."""

    @staticmethod
    def forward(ctx, x, w):
        xf = x.float()
        if w is None:
            s = xf.sum(dim=(0, 2, 3))
            ss = xf.square_().sum(dim=(0, 2, 3))
        else:
            s = (xf * w).sum(dim=(0, 2, 3))
            ss = (xf.square_() * w).sum(dim=(0, 2, 3))
        ctx.save_for_backward(x, w)
        return s, ss

    @staticmethod
    def backward(ctx, g_s, g_ss):
        x, w = ctx.saved_tensors
        g_s = g_s[None, :, None, None]
        g2 = 2.0 * g_ss[None, :, None, None]
        if w is None:
            # float32 arithmetic, rounded to bf16 once on the write
            return torch.addcmul(g_s, x, g2, out=torch.empty_like(x)), None
        return (torch.addcmul(g_s, x, g2) * w).to(x.dtype), None


class _ApplyBF16(torch.autograd.Function):
    """The JAX layer's bf16 apply: float32 statistics folded into a
    per-channel scale ``inv = rsqrt(var + eps) * weight`` and shift
    ``bias - mean * inv``, each rounded to bf16, then ``x * inv + shift``
    as one bf16 product and one bf16 sum. ``(a, b)``: the batch's float32
    ``(sum, sum of squares)`` over ``count``, or with ``count`` None the
    ``(mean, var)`` to hold (eval). ``update``: the module whose running
    statistics the batch's move, or None.

    Its backward is autograd's through these ops, written out: the bf16
    input gradient ``g * inv``, the two per-channel bf16 sums of ``g`` and
    ``g * x``, and the float32 chain back to ``(a, b)``, ``weight`` and
    ``bias`` in the same roundings, equal to autograd's bit for bit on
    the CPU. Autograd would record each per-channel op of the forward and
    run its backward op by op: on an H100, ``chip_smoke.py`` phase 40
    counted 42 kernels a BatchNorm call of an MT step that way, 37 this
    way, and 4.5 through cuDNN's ``batch_norm``."""

    @staticmethod
    def forward(ctx, x, a, b, count, weight, bias, eps, update):
        if count is None:
            mean, var = a, b
        else:
            mean = a / count
            var = b / count - mean.square()
            if update is not None:
                update._update_running(mean, var, count)
        r = torch.rsqrt(var + eps)
        inv = r * weight
        shift = bias - mean * inv
        inv_b = inv.to(x.dtype)
        ctx.save_for_backward(x, inv_b, r, inv, mean, weight, count)
        return (x * inv_b[None, :, None, None] +
                shift.to(x.dtype)[None, :, None, None])

    @staticmethod
    def backward(ctx, g):
        x, inv_b, r, inv, mean, weight, count = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = g * inv_b[None, :, None, None] if need[0] else None
        if not any(need[1:6]):
            return dx, None, None, None, None, None, None, None
        d_shift = g.sum(dim=(0, 2, 3)).float()
        d_inv = (g * x).sum(dim=(0, 2, 3)).float() - d_shift * mean
        d_weight = d_inv * r
        if count is None or not (need[1] or need[2]):
            return dx, None, None, None, d_weight, d_shift, None, None
        # rsqrt's backward as autograd writes it, then the square's and
        # the two quotients'
        d_var = -0.5 * (d_inv * weight) * r.pow(3)
        d_mean = torch.add(d_shift * inv, d_var * mean, alpha=2.0).neg_()
        return (dx, d_mean / count, d_var / count, None, d_weight, d_shift,
                None, None)


def bf16_active(x):
    """Whether ``x``'s device runs the current region under bf16
    autocast."""
    device = x.device.type
    return (torch.is_autocast_enabled(device) and
            torch.get_autocast_dtype(device) == torch.bfloat16)


def _add_bias(y, bias, float32_out):
    """The bf16 product ``y`` plus ``bias`` rounded to bf16: a bf16 sum, or
    with ``float32_out`` a float32 one. The JAX package casts such an
    output to float32 at once, and under ``jax.jit`` XLA then leaves the
    last sum unrounded."""
    bias = bias.to(torch.bfloat16)
    return y.float() + bias.float() if float32_out else y + bias


def conv2d(x, weight, bias, stride, padding, dilation, groups,
           float32_out=False):
    """``F.conv2d``; under bf16 autocast the bias is added after the
    product, as flax's ``nn.Conv(dtype=bf16)`` adds it: the product rounded
    to bf16, then ``bias`` in bf16 as a sum of its own (``_add_bias``;
    cuDNN and oneDNN would add it inside the float32 accumulation)."""
    if bias is None or not bf16_active(x):
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    return _add_bias(F.conv2d(x, weight, None, stride, padding, dilation,
                              groups), bias[:, None, None], float32_out)


class Linear(nn.Linear):
    """``nn.Linear`` whose bias, under bf16 autocast, is added after the
    product, as flax's ``nn.Dense(dtype=bf16)`` adds it (``_add_bias``,
    ``float32_out`` as there)."""

    def __init__(self, *args, float32_out=False, **kwargs):
        super(Linear, self).__init__(*args, **kwargs)
        self.float32_out = float32_out

    def forward(self, x):
        if self.bias is None or not bf16_active(x):
            return super(Linear, self).forward(x)
        return _add_bias(F.linear(x, self.weight), self.bias,
                         self.float32_out)


def same_pads(size, kernel, stride, dilation=1):
    """(before, after) of flax's ``'SAME'`` padding along an axis of
    ``size``: ``ceil(size / stride)`` outputs, ``total // 2`` before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + dilation * (kernel - 1) + 1 - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a row-sharded form: ``forward(x, h)`` inside a
    ``spatial.sharded`` block takes this rank's rows of a map ``h`` rows
    high and gives its rows of the output map (``out_height(h)`` rows).
    ``same=True`` (with ``padding=0``) pads each axis as flax's
    ``'SAME'`` does, which at stride 2 is not symmetric. ``float32_out``:
    under bf16 autocast the output is the float32 sum of the bf16 product
    and the bias (``_add_bias``), for a model's last convolution, whose
    output the JAX package casts to float32."""

    def __init__(self, *args, same=False, float32_out=False, **kwargs):
        super(Conv2d, self).__init__(*args, **kwargs)
        self.same = same
        self.float32_out = float32_out

    def _conv_forward(self, x, weight, bias):
        return conv2d(x, weight, bias, self.stride, self.padding,
                      self.dilation, self.groups, self.float32_out)

    def row_pads(self, h):
        """(top, bottom) padding of a map ``h`` rows high."""
        if self.same:
            return same_pads(h, self.kernel_size[0], self.stride[0],
                             self.dilation[0])
        return self.padding[0], self.padding[0]

    def out_height(self, h):
        if h is None:
            return None
        top, bottom = self.row_pads(h)
        return spatial.conv_out(h + top + bottom, self.kernel_size[0],
                                self.stride[0], 0, self.dilation[0])

    def forward(self, x, h=None):
        rows = spatial.active()
        (k, kw), (s, sw), (_, pw), (d, dw) = (self.kernel_size, self.stride,
                                              self.padding, self.dilation)
        if self.same:  # F.pad's order: W, then H
            x = F.pad(x, same_pads(x.shape[3], kw, sw, dw) +
                      (self.row_pads(x.shape[2]) if rows is None else ()))
        if rows is None:
            return super(Conv2d, self).forward(x)
        top, _ = self.row_pads(h)
        if k == 1 and s == 1 and top == 0:
            return super(Conv2d, self).forward(x)
        mesh = rows.mesh
        requests = spatial.window_rows(self.out_height(h), mesh.n_spatial,
                                       s, top, d * (k - 1) + 1)
        xr = spatial.fetch_rows(x, h, requests, mesh, spatial.ZERO)
        if xr.shape[2] == 0:
            return _no_rows(xr, self.out_channels,
                            spatial.conv_out(x.shape[3], kw, sw, pw, dw),
                            [p for p in (self.weight, self.bias)
                             if p is not None])
        return conv2d(xr, self.weight, self.bias, (s, sw), (0, pw), (d, dw),
                      self.groups, self.float32_out)


def _no_rows(fetched, channels, width, params=()):
    """An output of no rows that stays in the graph of the (empty) fetch,
    so that the fetch's backward, an exchange every rank joins, runs on
    this rank too, and of the layer's ``params``, which get a gradient of
    0 as on the ranks with rows (the gradients' all-reduce takes the same
    tensors on every rank)."""
    out = fetched.new_zeros((fetched.shape[0], channels, 0, width))
    return out + sum((p.sum() for p in params), fetched.sum()) * 0


def max_pool2d(x, kernel_size, stride, padding=0, h=None):
    """``F.max_pool2d`` with square windows; inside a ``spatial.sharded``
    block the row-sharded form on a map ``h`` rows high (-inf outside the
    map, as the padding of ``F.max_pool2d``)."""
    rows = spatial.active()
    if rows is None:
        return F.max_pool2d(x, kernel_size, stride=stride, padding=padding)
    mesh = rows.mesh
    h_out = spatial.conv_out(h, kernel_size, stride, padding)
    requests = spatial.window_rows(h_out, mesh.n_spatial, stride, padding,
                                   kernel_size)
    xr = spatial.fetch_rows(x, h, requests, mesh, spatial.NEG_INF)
    if xr.shape[2] == 0:
        return _no_rows(xr, x.shape[1], spatial.conv_out(
            x.shape[3], kernel_size, stride, padding))
    return F.max_pool2d(xr, kernel_size, stride=stride,
                        padding=(0, padding))


def pool_out_height(h, kernel_size, stride, padding=0):
    return None if h is None else spatial.conv_out(h, kernel_size, stride,
                                                  padding)


def resize_bilinear(x, size, align_corners=False, h=None, whole=False):
    """Bilinear resize of [N,C,H,W] to spatial ``size`` (h, w). Inside a
    ``spatial.sharded`` block ``size`` is the global output size, and
    ``x`` holds this rank's rows of a map ``h`` rows high or, with
    ``whole``, every row of it; the output is this rank's rows."""
    size = tuple(int(s) for s in size)
    rows = spatial.active()
    if rows is not None:
        return _resize_rows(x, size, h, align_corners, rows.mesh, whole)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode='bilinear',
                         align_corners=align_corners)


@functools.lru_cache(maxsize=256)
def _linear_taps(h_in, h_out, align_corners):
    """Per output row of a bilinear resize: the two input rows it reads
    and the weight of the second, in float32 as PyTorch's kernel computes
    them (``area_pixel_compute_scale`` / ``_source_index``)."""
    out = np.arange(h_out, dtype=np.float32)
    if align_corners:
        scale = (np.float32(h_in - 1) / np.float32(h_out - 1) if h_out > 1
                 else np.float32(0.0))
        src = scale * out
    else:
        scale = np.float32(h_in) / np.float32(h_out)
        src = np.maximum(scale * (out + np.float32(0.5)) - np.float32(0.5),
                         np.float32(0.0))
    i0 = np.minimum(np.floor(src).astype(np.int64), h_in - 1)
    i1 = np.minimum(i0 + 1, h_in - 1)
    return i0, i1, (src - i0.astype(np.float32)).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _row_taps(h_in, h_out, align_corners, o0, o1, a, device):
    """``_linear_taps`` of output rows [o0, o1) on ``device``, made once
    (a captured step copies nothing from the host), the row indices
    counted from row ``a``."""
    i0, i1, lam = _linear_taps(h_in, h_out, align_corners)
    return (torch.from_numpy(i0[o0:o1] - a).to(device),
            torch.from_numpy(i1[o0:o1] - a).to(device),
            torch.from_numpy(lam[o0:o1]).to(device).reshape(1, 1, -1, 1))


def _nearest_rows(h_in, h_out):
    return np.arange(h_out, dtype=np.int64) * h_in // h_out


def _source_rows(x, h, lo, hi, h_out, mesh, whole):
    """The input rows that this rank's output rows of a resize to
    ``h_out`` rows read, output row o reading rows ``lo[o]..hi[o]``: (the
    rows [a, b) that hold them, fetched from their ranks or, with
    ``whole``, cut from ``x``; a; this rank's output rows (o0, o1))."""
    requests = []
    for q in range(mesh.n_spatial):
        o0, o1 = spatial.row_range(h_out, mesh.n_spatial, q)
        requests.append((int(lo[o0]), int(hi[o1 - 1]) + 1) if o1 > o0
                        else (0, 0))
    a, b = requests[mesh.spatial_rank]
    if whole:
        xr = x.narrow(2, a, b - a)
    else:
        xr = spatial.fetch_rows(x, h, tuple(requests), mesh, spatial.ZERO)
    return xr, a, spatial.local_rows(h_out, mesh)


def _resize_rows(x, size, h, align_corners, mesh, whole):
    h_out, w_out = size
    if whole:
        h = x.shape[2]
    elif h == h_out and x.shape[3] == w_out:
        return x
    i0, i1, lam = _linear_taps(int(h), int(h_out), bool(align_corners))
    xr, a, (o0, o1) = _source_rows(x, h, i0, i1, h_out, mesh, whole)
    if o1 == o0:
        return _no_rows(xr, x.shape[1], w_out)
    idx0, idx1, weight = _row_taps(int(h), int(h_out), bool(align_corners),
                                   o0, o1, a, x.device)
    y = xr.index_select(2, idx0) * (1.0 - weight) + \
        xr.index_select(2, idx1) * weight
    if x.shape[3] != w_out:
        # the rows stay where they are (a scale of 1 in either convention)
        y = F.interpolate(y, size=(o1 - o0, w_out), mode='bilinear',
                          align_corners=align_corners)
    return y.to(x.dtype)


def resize_nearest(x, size, h=None, whole=False):
    """Nearest resize of [N,C,H,W] to ``size`` (h, w): source index
    ``i * in // out`` along each axis (JAX layers.py:160-166). Inside a
    ``spatial.sharded`` block as ``resize_bilinear``."""
    (h_out, w_out) = (int(s) for s in size)
    w_in = x.shape[3]
    wi = torch.arange(w_out, device=x.device) * w_in // w_out
    rows = spatial.active()
    if rows is None:
        h_in = x.shape[2]
        hi = torch.arange(h_out, device=x.device) * h_in // h_out
        return x.index_select(2, hi).index_select(3, wi)
    h = x.shape[2] if whole else int(h)
    src = _nearest_rows(h, h_out)
    xr, a, (o0, o1) = _source_rows(x, h, src, src, h_out, rows.mesh, whole)
    if o1 == o0:
        return _no_rows(xr, x.shape[1], w_out)
    index = spatial._index(tuple(int(i) for i in src[o0:o1] - a), x.device)
    return xr.index_select(2, index).index_select(3, wi)


@functools.lru_cache(maxsize=256)
def _bin_matrix(size, bins, start, stop, device):
    """[bins, stop - start] float32 on ``device``, made once: row i
    averages the rows of bin i (``[floor(i * size / bins), ceil((i + 1) *
    size / bins))`` of ``size``) that lie in [start, stop), each weighed by
    one over the bin's whole count (JAX ``_adaptive_pool_matrix``)."""
    m = np.zeros((bins, stop - start), np.float32)
    for i in range(bins):
        lo, hi = i * size // bins, -(-((i + 1) * size) // bins)
        a, b = max(lo, start), min(hi, stop)
        if b > a:
            m[i, a - start:b - start] = 1.0 / (hi - lo)
    return torch.from_numpy(m).to(device)


def adaptive_avg_pool(x, output_size, h=None):
    """``nn.AdaptiveAvgPool2d`` of [N,C,H,W] in float32, back to the input's
    dtype (JAX layers.py:169-192). Inside a ``spatial.sharded`` block ``x``
    holds this rank's rows of a map ``h`` rows high, and every rank gets
    the whole pooled map: the parts of each bin in each rank's rows,
    summed over the spatial group; the gradient of each rank's rows comes
    from every rank's use of the bins."""
    rows = spatial.active()
    if rows is None:
        return F.adaptive_avg_pool2d(x.float(), output_size).to(x.dtype)
    bh, bw = ((output_size, output_size) if isinstance(output_size, int)
              else output_size)
    r0, r1 = spatial.local_rows(h, rows.mesh)
    mh = _bin_matrix(int(h), bh, r0, r1, x.device)
    mw = _bin_matrix(x.shape[3], bw, 0, x.shape[3], x.device)
    with torch.autocast(x.device.type, enabled=False):
        parts = torch.matmul(torch.matmul(mh, x.float()), mw.t())
    return spatial.group_sum(parts).to(x.dtype)


def pixel_shuffle(x, scale, h=None):
    """[N,C*r*r,H,W] -> [N,C,H*r,W*r], ``out[n, c, h*r+i, w*r+j] =
    in[n, c*r*r + i*r + j, h, w]`` (JAX layers.py:203-214). Inside a
    ``spatial.sharded`` block ``x`` holds this rank's rows of a map ``h``
    rows high, and the output is its rows ``row_range(h * r)``: the input
    rows they come from, ``[o0 // r, ceil(o1 / r))``, are fetched
    first."""
    rows = spatial.active()
    if rows is None:
        return F.pixel_shuffle(x, scale)
    mesh, r = rows.mesh, int(scale)
    h_out = int(h) * r
    requests = []
    for q in range(mesh.n_spatial):
        o0, o1 = spatial.row_range(h_out, mesh.n_spatial, q)
        requests.append((o0 // r, -(-o1 // r)) if o1 > o0 else (0, 0))
    xr = spatial.fetch_rows(x, h, tuple(requests), mesh, spatial.ZERO)
    o0, o1 = spatial.local_rows(h_out, mesh)
    if o1 == o0:
        return _no_rows(xr, x.shape[1] // (r * r), x.shape[3] * r)
    return F.pixel_shuffle(xr, r).narrow(2, o0 - r * (o0 // r), o1 - o0)


def kaiming_normal_(weight, generator=None):
    """flax's ``kaiming_normal``: a normal truncated at two deviations,
    variance 2 / fan_in after the truncation."""
    std = math.sqrt(2.0 / weight[0].numel()) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def icnr_init_(weight, scale=2, generator=None):
    """ICNR for a conv before ``pixel_shuffle(scale)``: the OIHW kernel's
    ``O = C*scale*scale`` outputs are ``C`` kaiming-normal sub-kernels, each
    repeated ``scale*scale`` times, so the shuffle starts as a nearest
    upsampling (JAX layers.py:217-227)."""
    o = weight.shape[0]
    sub = kaiming_normal_(torch.empty((o // (scale * scale),) +
                                      tuple(weight.shape[1:])), generator)
    with torch.no_grad():
        weight.copy_(sub.repeat_interleave(scale * scale, dim=0))
    return weight


# 0.2 rounded to bf16, the JAX layer's ``0.2 * x`` on a bf16 ``x``
_SLOPE_BF16 = 0.2001953125


def leaky_relu_02(x):
    """LeakyReLU(0.2). On bf16 the JAX layer's: the slope rounded to bf16
    and one bf16 product on the negative side, both ways (PyTorch's kernel
    multiplies by 0.2 in float32 before it rounds)."""
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, 0.2)
    return torch.where(x > 0, x, x * _SLOPE_BF16)


def lecun_normal_(layer, generator=None):
    """Weight ~ normal(0, sqrt(1 / fan_in)) and a zero bias, for a conv or
    a linear layer."""
    with torch.no_grad():
        layer.weight.normal_(0.0, math.sqrt(1.0 / layer.weight[0].numel()),
                             generator=generator)
        layer.bias.zero_()
