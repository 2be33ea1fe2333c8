"""Semantic-segmentation task models (counterpart of
``pixelssl_tpu/tasks/sseg/model.py``; reference task/sseg/model.py:21-125).

``DeepLabV2Model`` wraps ``models.DeepLabV2`` in the resulter contract:
``pred`` (logits, float32) and ``activated_pred`` (softmax over classes),
NCHW, plus the S4L/CCT keys (reference model.py:60-73). The classifier
trains at 10x the backbone's lr (model.py:45-48).
"""

import torch

from ...models.deeplab_v2 import DeepLabV2
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


def deeplabv2():
    return DeepLabV2Model


class DeepLabV2Model(model_template.TaskModel):
    """DeepLab-v2 wrapper (reference model.py:29-84)."""

    lr_mult_spec = (('classifier', 10.0),)

    def __init__(self, args):
        super(DeepLabV2Model, self).__init__(args)
        self.net = DeepLabV2(backbone=args.backbone,
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
