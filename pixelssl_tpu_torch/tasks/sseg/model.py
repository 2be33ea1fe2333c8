"""Semantic-segmentation task models (counterpart of
``pixelssl_tpu/tasks/sseg/model.py``; reference task/sseg/model.py:21-125).

``DeepLabV2Model`` and ``PSPNetModel`` wrap ``models.DeepLabV2`` and
``models.PSPNet`` in the resulter contract: ``pred`` (logits, float32) and
``activated_pred`` (softmax over classes), NCHW, plus the S4L key (the
logits) and the CCT key (the latent: DeepLab-v2's backbone feature,
PSPNet's PSP output) (reference model.py:60-73). Heads train at 10x the
backbone's lr: DeepLab-v2's classifier (model.py:45-48), PSPNet's PSP
module and decoder (model.py:103-107), three lr groups.
"""

import torch

from ...models.deeplab_v2 import DeepLabV2
from ...models.pspnet import PSPNet
from ...task_template import model_template
from ...utils import cmd


def add_parser_arguments(parser):
    parser.add_argument('--output-stride', type=int, default=16, metavar='',
                        help='sseg - output stride of the ResNet backbone')
    parser.add_argument('--backbone', type=str, default='resnet101',
                        metavar='', help='sseg - backbone architecture')
    parser.add_argument('--bf16', type=cmd.str2bool, default=True, metavar='',
                        help='sseg - bf16 autocast for the convolutions on '
                             'the card (float32 statistics and losses)')
    # the JAX package's other model flags: they parse, and any value but
    # the default is refused (UNPORTED_FLAGS)
    parser.add_argument('--freeze-bn', type=cmd.str2bool, default=False,
                        metavar='', help='sseg - freeze BatchNorm statistics '
                                         '(ROADMAP A3d)')
    parser.add_argument('--pretrained-path', type=str, default='',
                        metavar='', help='sseg - pretrained backbone '
                                         'checkpoint (ROADMAP A3d)')
    parser.add_argument('--remat', type=cmd.str2bool, default=False,
                        metavar='', help='sseg - recompute backbone '
                                         'activations in the backward pass '
                                         '(ROADMAP A3d)')


# (flag, its default, the ROADMAP item that ports it): any value but the
# default is refused by the proxy
UNPORTED_FLAGS = (('freeze_bn', False, 'A3d'), ('pretrained_path', '', 'A3d'),
                  ('remat', False, 'A3d'))


def deeplabv2():
    return DeepLabV2Model


def pspnet():
    return PSPNetModel


class _SsegModel(model_template.TaskModel):
    """The resulter contract around ``self.net``, which returns (logits,
    latent)."""

    net_class = None

    def __init__(self, args):
        super(_SsegModel, self).__init__(args)
        self.net = self.net_class(backbone=args.backbone,
                                  output_stride=args.output_stride,
                                  num_classes=args.num_classes,
                                  bf16=getattr(args, 'bf16', True))

    def forward(self, inp):
        if len(inp) != 1:
            raise ValueError('sseg models require exactly one input, got '
                             '{0}'.format(len(inp)))
        pred, latent = self.net(inp[0])
        return {
            'pred': (pred,),
            'activated_pred': (torch.softmax(pred, dim=1),),
            'ssls4l_rc_inp': pred,
            'sslcct_ad_inp': latent,
        }


class DeepLabV2Model(_SsegModel):
    """DeepLab-v2 wrapper (reference model.py:29-84)."""

    net_class = DeepLabV2
    lr_mult_spec = (('classifier', 10.0),)


class PSPNetModel(_SsegModel):
    """PSPNet wrapper (reference model.py:87-125)."""

    net_class = PSPNet
    lr_mult_spec = (('psp', 10.0), ('decoder', 10.0))
