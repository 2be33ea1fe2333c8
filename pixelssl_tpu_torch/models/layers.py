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
  differentiates through that sum, as the JAX layer ``psum``s them.
* ``resize_bilinear``: both ``align_corners`` conventions. ``F.interpolate``
  is the same two-tap arithmetic as the JAX interpolation matrices.
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
* ``leaky_relu_02``: plain LeakyReLU(0.2); the JAX custom vjp was a
  workaround for the TPU compiler.
* ``lecun_normal_``: the flax ``Conv``/``Dense`` defaults the auxiliary
  modules start from.
* ``bf16_autocast``: the bf16 autocast region of every model, its cast
  cache off while a CUDA graph captures the step.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import all_sum


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
        if not self.training:
            return super(SyncBatchNorm, self).forward(x)
        if (sample_weight is None and self.sync is None and
                x.numel() != x.shape[1]):
            if self.update_stats:
                return super(SyncBatchNorm, self).forward(x)
            # scratch copies take the update: the autograd graph saves the
            # same tensors as the forward that moved the real statistics
            return F.batch_norm(x, self.running_mean.clone(),
                                self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum, self.eps)
        # the statistics by hand: weighted rows, one value per channel
        # (biased variance 0, unbiased 0 * 1 / 1), or summed over the ranks
        xf = x.float()
        per_sample = x.shape[2] * x.shape[3]
        if sample_weight is None:
            # a fill, not a copy from the host: capturable
            count = torch.full((1,), float(x.shape[0] * per_sample),
                               dtype=torch.float32, device=x.device)
            s = xf.sum(dim=(0, 2, 3))
            ss = xf.square().sum(dim=(0, 2, 3))
        else:
            w = sample_weight.float().reshape(-1, 1, 1, 1)
            count = (sample_weight.float().sum() * per_sample).reshape(1)
            s = (xf * w).sum(dim=(0, 2, 3))
            ss = (xf.square() * w).sum(dim=(0, 2, 3))
        if self.sync is not None:
            c = s.shape[0]
            sums = all_sum(torch.cat([s, ss, count]), self.sync)
            s, ss, count = sums[:c], sums[c:2 * c], sums[2 * c:]
        mean = s / count
        var = ss / count - mean.square()
        if self.update_stats:
            unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
            # in place on ``.data``, as PyTorch's kernel updates them: an
            # earlier forward's backward may still hold these buffers
            for stat, batch in ((self.running_mean, mean),
                                (self.running_var, unbiased)):
                stat.data.mul_(1.0 - self.momentum).add_(batch.detach(),
                                                         alpha=self.momentum)
            self.num_batches_tracked.data.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[None, :, None, None]) * inv[None, :, None, None] +
                self.bias[None, :, None, None]).to(x.dtype)


def resize_bilinear(x, size, align_corners=False):
    """Bilinear resize of [N,C,H,W] to spatial ``size`` (h, w)."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode='bilinear',
                         align_corners=align_corners)


def resize_nearest(x, size):
    """Nearest resize of [N,C,H,W] to ``size`` (h, w): source index
    ``i * in // out`` along each axis (JAX layers.py:160-166)."""
    (h_in, w_in), (h_out, w_out) = x.shape[2:], (int(s) for s in size)
    hi = torch.arange(h_out, device=x.device) * h_in // h_out
    wi = torch.arange(w_out, device=x.device) * w_in // w_out
    return x.index_select(2, hi).index_select(3, wi)


def adaptive_avg_pool(x, output_size):
    """``nn.AdaptiveAvgPool2d`` of [N,C,H,W] in float32, back to the input's
    dtype (JAX layers.py:169-192)."""
    return F.adaptive_avg_pool2d(x.float(), output_size).to(x.dtype)


def pixel_shuffle(x, scale):
    """[N,C*r*r,H,W] -> [N,C,H*r,W*r], ``out[n, c, h*r+i, w*r+j] =
    in[n, c*r*r + i*r + j, h, w]`` (JAX layers.py:203-214)."""
    return F.pixel_shuffle(x, scale)


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


def leaky_relu_02(x):
    return F.leaky_relu(x, 0.2)


def lecun_normal_(layer, generator=None):
    """Weight ~ normal(0, sqrt(1 / fan_in)) and a zero bias, for a conv or
    a linear layer."""
    with torch.no_grad():
        layer.weight.normal_(0.0, math.sqrt(1.0 / layer.weight[0].numel()),
                             generator=generator)
        layer.bias.zero_()
