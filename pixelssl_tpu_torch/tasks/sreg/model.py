"""Pixel-regression task model (counterpart of
``pixelssl_tpu/tasks/sreg/model.py``): ``unet_lite``, a small NCHW
encoder-decoder.

Three stride-1/2/2 3x3 conv + BN + ReLU stages (C, 2C, 4C channels), a
latent stage at 4C, two decoder stages that resize bilinearly in float32
(``align_corners=False``) and concatenate the encoder's skip, and a 1x1
float32 ``head`` with a bias. The 3x3 convs pad as flax's ``'SAME'``: at
stride 2 on an even map one row and column after, none before. With
``bf16`` the stages run under bf16 autocast on the card; the resizes and
the head stay float32.

Inside a ``parallel.spatial.sharded`` block the input is this rank's rows
of maps of the context's height: the 3x3 convolutions run row-sharded
(``models/layers.Conv2d``, the stride-2 ones with ``'SAME'``'s padding
taken from the global height), the resizes give this rank's rows, and
the BatchNorms sum their statistics over the grid, as the JAX model's
plain reductions over the global batch under ``--spatial-train``.

Resulter keys: ``pred`` (the raw one-channel map, float32),
``activated_pred`` (its sigmoid) and ``ssls4l_rc_inp`` (the latent, the
input of S4L's rotation head). The head trains at 10x the lr. Module
names: ``blocks.0``..``blocks.5``, each with ``conv`` and ``bn``, and
``head``; ``models.convert.from_jax`` maps flax's automatic names onto
them.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...models.layers import (Conv2d, SyncBatchNorm, bf16_autocast,
                              resize_bilinear)
from ...parallel import spatial
from ...task_template import model_template
from ...utils import cmd


def add_parser_arguments(parser):
    parser.add_argument('--base-channels', type=int, default=32, metavar='',
                        help='sreg - width of the first encoder stage')
    parser.add_argument('--bf16', type=cmd.str2bool, default=True,
                        metavar='',
                        help='sreg - bf16 autocast for the convolutions on '
                             'the card (float32 statistics and losses)')


def unet_lite():
    return UNetLiteModel


def _lecun_truncated_normal_(weight, generator=None):
    """flax's default kernel init: a normal truncated at two deviations,
    variance 1 / fan_in after the truncation."""
    std = math.sqrt(1.0 / weight[0].numel()) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class ConvBNRelu(nn.Module):
    def __init__(self, in_channels, out_channels, stride=1):
        super(ConvBNRelu, self).__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, stride=stride,
                           padding=1 if stride == 1 else 0, bias=False,
                           same=stride != 1)
        self.bn = SyncBatchNorm(out_channels)

    def out_height(self, h):
        return self.conv.out_height(h)

    def forward(self, x, h=None):
        return F.relu(self.bn(self.conv(x, h)))


class UNetLite(nn.Module):
    """Returns (the one-channel map, float32; the latent)."""

    def __init__(self, base=32, bf16=False):
        super(UNetLite, self).__init__()
        c = base
        self.bf16 = bf16
        self.blocks = nn.ModuleList([
            ConvBNRelu(3, c), ConvBNRelu(c, 2 * c, 2),
            ConvBNRelu(2 * c, 4 * c, 2), ConvBNRelu(4 * c, 4 * c),
            ConvBNRelu(6 * c, 2 * c), ConvBNRelu(3 * c, c)])
        self.head = nn.Conv2d(c, 1, 1)

    def init_weights(self, generator=None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_truncated_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def _amp(self, x):
        return bf16_autocast(x, self.bf16)

    def latent_height(self, h):
        return self.blocks[2].out_height(self.blocks[1].out_height(h))

    def forward(self, x):
        b = self.blocks
        h = spatial.global_height(x)
        h2 = b[1].out_height(h)
        h4 = b[2].out_height(h2)
        with self._amp(x):
            e1 = b[0](x, h)
            e2 = b[1](e1, h)
            latent = b[3](b[2](e2, h2), h4)
        d2 = resize_bilinear(latent.float(), (h2, e2.shape[3]), h=h4)
        with self._amp(x):
            d2 = b[4](torch.cat([d2.to(e2.dtype), e2], dim=1), h2)
        d1 = resize_bilinear(d2.float(), (h, e1.shape[3]), h=h2)
        with self._amp(x):
            d1 = b[5](torch.cat([d1.to(e1.dtype), e1], dim=1), h)
        return self.head(d1.float()), latent


class UNetLiteModel(model_template.TaskModel):
    lr_mult_spec = (('head', 10.0),)

    def __init__(self, args):
        super(UNetLiteModel, self).__init__(args)
        self.net = UNetLite(base=args.base_channels,
                            bf16=getattr(args, 'bf16', True))

    def map_height(self, key, h):
        """The latent (S4L's input) is a quarter of the input's height."""
        return self.net.latent_height(h) if key == 'ssls4l_rc_inp' else h

    def load_pretrained(self, path):
        from ...utils import logger
        logger.log_err('sreg models have no pretrained checkpoints: the '
                       'synthetic task trains from scratch')

    def forward(self, inp):
        if len(inp) != 1:
            raise ValueError('sreg models require exactly one input, got '
                             '{0}'.format(len(inp)))
        pred, latent = self.net(inp[0])
        pred = pred.float()
        return {
            'pred': (pred,),
            'activated_pred': (torch.sigmoid(pred),),
            'ssls4l_rc_inp': latent.float(),
        }
