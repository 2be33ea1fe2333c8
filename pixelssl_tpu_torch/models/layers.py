"""Shared building blocks (counterpart of ``pixelssl_tpu/models/layers.py``),
NCHW.

* ``SyncBatchNorm``: the JAX package's cross-replica BatchNorm on one card
  is PyTorch's BatchNorm with torch momentum 0.1, the biased batch variance
  to normalise and the unbiased one in the running variance, eps 1e-5, the
  statistics in float32 (reference batchnorm.py:113-125).
* ``resize_bilinear``: both ``align_corners`` conventions. ``F.interpolate``
  is the same two-tap arithmetic as the JAX interpolation matrices.
* ``leaky_relu_02``: plain LeakyReLU(0.2); the JAX custom vjp was a
  workaround for the TPU compiler.
* ``lecun_normal_``: the flax ``Conv``/``Dense`` defaults the auxiliary
  modules start from.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class SyncBatchNorm(nn.BatchNorm2d):
    """BatchNorm over (N, H, W) with torch-compatible statistics."""

    def __init__(self, num_features, momentum=0.1, eps=1e-5):
        super(SyncBatchNorm, self).__init__(num_features, eps=eps,
                                            momentum=momentum)


def resize_bilinear(x, size, align_corners=False):
    """Bilinear resize of [N,C,H,W] to spatial ``size`` (h, w)."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode='bilinear',
                         align_corners=align_corners)


def leaky_relu_02(x):
    return F.leaky_relu(x, 0.2)


def lecun_normal_(layer, generator=None):
    """Weight ~ normal(0, sqrt(1 / fan_in)) and a zero bias, for a conv or
    a linear layer."""
    with torch.no_grad():
        layer.weight.normal_(0.0, math.sqrt(1.0 / layer.weight[0].numel()),
                             generator=generator)
        layer.bias.zero_()
