"""PSPNet: dilated ResNet + pyramid pooling + PixelShuffle decoder
(counterpart of ``pixelssl_tpu/models/pspnet.py``), NCHW.

The PSP module pools the backbone's feature into bins (1, 2, 3, 6), each
through a 1x1 conv, BN and ReLU and an ``align_corners=False`` resize back,
concatenates them with the feature and reduces it with a 3x3 conv, BN and
ReLU to a quarter of its channels (reference task/sseg/module/
_pspnet.py:57-102). The decoder is a 1x1 conv and log2(8) = 3 PixelShuffle
x2 blocks with ICNR init (_pspnet.py:15-54); the logits are resized to the
input in float32 with ``align_corners=True`` (_pspnet.py:127). With
``bf16`` the convolutions run under bf16 autocast on the card, as
DeepLab-v2's do.

Inside a ``parallel.spatial.sharded`` block the input is this rank's rows
of images of the context's height, and the global height threads through
the model: the backbone and the bottleneck's 3x3 convolution run
row-sharded, each pyramid stage pools its bins over the rows of every
rank of the spatial group (every rank then holds the whole bins, whose
BatchNorm counts them on spatial rank 0: ``spatial.whole_weight``) and
resizes them to this rank's rows, and each x2 shuffle of the decoder
fetches the rows of its output rows (``models/layers.py``).
"""

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from .layers import (Conv2d, SyncBatchNorm, adaptive_avg_pool, bf16_autocast,
                     icnr_init_, kaiming_normal_, pixel_shuffle,
                     resize_bilinear)
from .resnet import build_backbone


def psp_conv_init_(conv, generator=None):
    """torch ``kaiming_uniform_(a=0)`` on fan_in (JAX pspnet.py:23)."""
    bound = math.sqrt(6.0 / conv.weight[0].numel())
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)


class PSPStage(nn.Module):
    def __init__(self, in_channels, out_channels, bins):
        super(PSPStage, self).__init__()
        self.bins = bins
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn = SyncBatchNorm(out_channels)

    def forward(self, x, h=None):
        h = x.shape[2] if h is None else h
        pooled = self.conv(adaptive_avg_pool(x, self.bins, h))
        y = F.relu(self.bn(pooled, spatial.whole_weight(pooled)))
        return resize_bilinear(y, (h, x.shape[3]), align_corners=False,
                               whole=True)


class PSPModule(nn.Module):
    """Pyramid pooling (reference _pspnet.py:57-102)."""

    def __init__(self, in_channels, bin_sizes=(1, 2, 3, 6)):
        super(PSPModule, self).__init__()
        out_channels = in_channels // len(bin_sizes)
        self.stages = nn.ModuleList(PSPStage(in_channels, out_channels, b)
                                    for b in bin_sizes)
        self.bottleneck_conv = Conv2d(
            in_channels + out_channels * len(bin_sizes), out_channels, 3,
            padding=1, bias=False)
        self.bottleneck_bn = SyncBatchNorm(out_channels)

    def init_weights(self, generator=None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                psp_conv_init_(m, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x, h=None):
        y = torch.cat([x] + [stage(x, h) for stage in self.stages], dim=1)
        return F.relu(self.bottleneck_bn(self.bottleneck_conv(y, h)))


class PixelShuffleBlock(nn.Module):
    """conv1x1 (n -> n*r*r, ICNR, bias) -> ReLU -> shuffle x r (reference
    _pspnet.py:40-54)."""

    def __init__(self, channels, scale=2):
        super(PixelShuffleBlock, self).__init__()
        self.scale = scale
        self.conv = Conv2d(channels, channels * scale * scale, 1, bias=True)

    def init_weights(self, generator=None):
        icnr_init_(self.conv.weight, self.scale, generator)
        with torch.no_grad():
            self.conv.bias.zero_()

    def forward(self, x, h=None):
        return pixel_shuffle(F.relu(self.conv(x)), self.scale, h)


class UpsampleDecoder(nn.Module):
    """1x1 conv without bias, then x2 shuffles until ``upscale`` (reference
    _pspnet.py:15-23); CCT's auxiliary decoders are this module too. With
    ``bf16`` it runs under bf16 autocast on the card; without, it leaves
    the caller's autocast as it is (PSPNet's own decoder runs under the
    model's)."""

    def __init__(self, in_channels, out_channels, upscale=8, bf16=False):
        super(UpsampleDecoder, self).__init__()
        self.bf16 = bf16
        self.conv1x1 = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.shuffle = nn.ModuleList(
            PixelShuffleBlock(out_channels)
            for _ in range(int(math.log2(upscale))))

    def init_weights(self, generator=None):
        kaiming_normal_(self.conv1x1.weight, generator)
        for block in self.shuffle:
            block.init_weights(generator)

    def out_height(self, h):
        return h * 2 ** len(self.shuffle)

    def forward(self, x, h=None):
        """``h``: the global height of ``x`` inside a spatial context."""
        with (bf16_autocast(x) if self.bf16 else contextlib.nullcontext()):
            x = self.conv1x1(x)
            for block in self.shuffle:
                x = block(x, h)
                h = None if h is None else h * block.scale
        return x


class PSPNet(nn.Module):
    """Returns (logits at input resolution, PSP latent [N,512,h,w] at
    ResNet-50/101)."""

    def __init__(self, backbone='resnet101', output_stride=16, num_classes=21,
                 bf16=False, remat=False):
        super(PSPNet, self).__init__()
        self.bf16 = bf16
        self.backbone = build_backbone(backbone, output_stride, remat=remat)
        self.psp = PSPModule(2048)
        self.decoder = UpsampleDecoder(512, num_classes, upscale=8)

    def init_weights(self, generator=None):
        self.backbone.init_weights(generator)
        self.psp.init_weights(generator)
        self.decoder.init_weights(generator)

    def forward(self, x):
        h = spatial.global_height(x)
        h16 = self.backbone.out_height(h)
        with bf16_autocast(x, self.bf16):
            px = self.psp(self.backbone(x, h), h16)
            logits = self.decoder(px, h16)
        logits = resize_bilinear(logits.float(), (h, x.shape[3]),
                                 align_corners=True,
                                 h=self.decoder.out_height(h16))
        return logits, px
