"""Dilated multi-grid ResNet-50/101 backbone (counterpart of
``pixelssl_tpu/models/resnet.py``), NCHW.

Same topology as the reference (task/sseg/module/backbone/resnet.py:13-174):
7x7 stem and a 3/2/1 max-pool, bottleneck stages [3,4,{6,23},3] with the
stride on the 3x3 conv, output stride 16 via strides (1,2,2,1) and
dilations (1,1,1,2) (8 via (1,2,1,1) and (1,1,2,4)), and the multi-grid
unit (1,2,4) in layer4. Module names follow the reference's state dict
(conv1/bn1/layerX.Y/downsample.{0,1}).

``remat=True`` (``--remat``) checkpoints every bottleneck, as the JAX
package's ``nn.remat`` does (its resnet.py:71-94): the backward pass
recomputes each block's activations from its input. The recompute runs
the block's BatchNorms with ``update_stats`` off, so that the running
statistics move once a forward, as without remat.

Under ``--spatial-train`` and ``--spatial-val`` (``parallel.spatial``) the
forward takes this rank's rows of the input and the global height ``h``,
and each layer passes on its output's (``Conv2d``, ``max_pool2d``): the
stem, the max pool, the strided and dilated 3x3 convolutions and the
strided 1x1 downsample fetch the rows of other ranks their windows read.
"""

import contextlib
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import Conv2d, SyncBatchNorm, max_pool2d, pool_out_height


def conv_init_(conv, generator=None):
    """normal(0, sqrt(2/n)), n = kh*kw*out_channels (reference _init_weight;
    the JAX package's fan-out variance scaling)."""
    kh, kw = conv.kernel_size
    std = math.sqrt(2.0 / (kh * kw * conv.out_channels))
    with torch.no_grad():
        conv.weight.normal_(0.0, std, generator=generator)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (dilated, strided) -> 1x1 (reference resnet.py:13-50)."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 has_downsample=False):
        super(Bottleneck, self).__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = SyncBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False)
        self.bn2 = SyncBatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = SyncBatchNorm(planes * 4)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                SyncBatchNorm(planes * 4))

    def out_height(self, h):
        return self.conv2.out_height(h)

    def forward(self, x, h=None):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out, h)))
        out = self.bn3(self.conv3(out))
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](x, h))
        return F.relu(out + residual)


def _recompute_contexts(block):
    """``context_fn`` of ``checkpoint``: nothing around the forward; the
    recompute with the block's BatchNorms leaving their statistics."""
    bns = [m for m in block.modules() if isinstance(m, SyncBatchNorm)]

    @contextlib.contextmanager
    def frozen_stats():
        for bn in bns:
            bn.update_stats = False
        try:
            yield
        finally:
            for bn in bns:
                bn.update_stats = True

    return contextlib.nullcontext(), frozen_stats()


class ResNet(nn.Module):
    """Dilated multi-grid ResNet trunk returning the layer4 feature map."""

    def __init__(self, layers, output_stride=16, multi_grid=(1, 2, 4),
                 remat=False):
        super(ResNet, self).__init__()
        self.remat = remat
        if output_stride == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        elif output_stride == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        else:
            raise NotImplementedError(
                'output_stride must be 8 or 16, got {0}'.format(output_stride))
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = SyncBatchNorm(64)

        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            if stage < 3:
                grids = [1] * layers[stage]
            else:
                grids = list(multi_grid)
            blocks = []
            for b, grid in enumerate(grids):
                stride = strides[stage] if b == 0 else 1
                has_ds = b == 0 and (stride != 1 or inplanes != planes * 4)
                blocks.append(Bottleneck(inplanes, planes, stride=stride,
                                         dilation=grid * dilations[stage],
                                         has_downsample=has_ds))
                inplanes = planes * 4
            setattr(self, 'layer{0}'.format(stage + 1), nn.Sequential(*blocks))

    def init_weights(self, generator=None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                conv_init_(m, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def blocks(self):
        return [block for layer in (self.layer1, self.layer2, self.layer3,
                                    self.layer4) for block in layer]

    def out_height(self, h):
        """The global height of the layer4 map of an input ``h`` rows
        high."""
        h = pool_out_height(self.conv1.out_height(h), 3, 2, 1)
        for block in self.blocks():
            h = block.out_height(h)
        return h

    def forward(self, x, h=None):
        x = F.relu(self.bn1(self.conv1(x, h)))
        h = self.conv1.out_height(h)
        x = max_pool2d(x, 3, 2, 1, h)
        h = pool_out_height(h, 3, 2, 1)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks():
            if remat:
                x = checkpoint(block, x, h, use_reentrant=False,
                               context_fn=functools.partial(
                                   _recompute_contexts, block))
            else:
                x = block(x, h)
            h = block.out_height(h)
        return x


def resnet50(output_stride, remat=False):
    return ResNet((3, 4, 6, 3), output_stride, remat=remat)


def resnet101(output_stride, remat=False):
    return ResNet((3, 4, 23, 3), output_stride, remat=remat)


def resnet10(output_stride, remat=False):
    """One block per stage: the test size (no reference analog)."""
    return ResNet((1, 1, 1, 1), output_stride, remat=remat)


def build_backbone(name, output_stride, remat=False):
    name = name.split('-')[0]  # 'resnet101-coco' -> 'resnet101'
    builders = {'resnet10': resnet10, 'resnet50': resnet50,
                'resnet101': resnet101}
    if name not in builders:
        raise ValueError('Unsupported backbone: {0}'.format(name))
    return builders[name](output_stride, remat=remat)
