"""Rotation classifier for S4L (counterpart of
``pixelssl_tpu/models/rotation.py``; reference
pixelssl/ssl_algorithm/ssl_s4l.py:381-400), NCHW.

Two 4x4 stride-2 conv + BN + LeakyReLU(0.2) blocks (C -> C -> 2C), a
spatial mean, and a linear head ``fc`` over the four angles; the logits
are returned in float32. The head is named ``fc``, not ``classifier``, so
that the task model's 10x lr rule never matches it. With ``bf16`` the
convolutions, the mean and the head run in bf16 under autocast, as the
JAX package's ``aux_compute_dtype`` runs them (its rotation.py:24-35: the
``Dense`` in bf16, its bias added after the product).

Inside a ``parallel.spatial.sharded`` block the input is this rank's rows
of maps of the height that the caller passes (the context's by default;
``sreg``'s latent is a quarter of it): the convolutions run row-sharded
(``models/layers.Conv2d``), BatchNorm sums its statistics over the grid
(``sync``), and the spatial mean is summed over the spatial group
(``spatial.channel_mean``), so that every rank of it gives the same
logits.
"""

import torch.nn as nn

from ..parallel import spatial
from .layers import (Conv2d, Linear, SyncBatchNorm, bf16_autocast,
                     lecun_normal_, leaky_relu_02)


class RotationClassifier(nn.Module):
    def __init__(self, in_channels, bf16=False):
        super(RotationClassifier, self).__init__()
        self.bf16 = bf16
        self.conv1 = Conv2d(in_channels, in_channels, 4, stride=2,
                            padding=1)
        self.bn1 = SyncBatchNorm(in_channels)
        self.conv2 = Conv2d(in_channels, in_channels * 2, 4, stride=2,
                            padding=1)
        self.bn2 = SyncBatchNorm(in_channels * 2)
        self.fc = Linear(in_channels * 2, 4, float32_out=True)

    def init_weights(self, generator=None):
        """LeCun normal weights and zero biases (the JAX package's flax
        defaults), BN scale 1 and shift 0."""
        for m in (self.conv1, self.conv2, self.fc):
            lecun_normal_(m, generator)
        for bn in (self.bn1, self.bn2):
            bn.reset_parameters()

    def forward(self, x, h=None):
        """[N,C,H,W] -> rotation logits [N,4], float32; ``h``: the global
        height of ``x`` inside a spatial context (by default the
        context's)."""
        h = spatial.global_height(x) if h is None else h
        h1 = self.conv1.out_height(h)
        with bf16_autocast(x, self.bf16):
            x = leaky_relu_02(self.bn1(self.conv1(x, h)))
            x = leaky_relu_02(self.bn2(self.conv2(x, h1)))
            x = self.fc(spatial.channel_mean(x, self.conv2.out_height(h1)))
        return x.float()
