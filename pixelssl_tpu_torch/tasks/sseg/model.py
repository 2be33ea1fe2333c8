"""Semantic-segmentation task models (counterpart of
``pixelssl_tpu/tasks/sseg/model.py``; reference task/sseg/model.py:21-125).

``DeepLabV2Model`` and ``PSPNetModel`` wrap ``models.DeepLabV2`` and
``models.PSPNet`` in the resulter contract: ``pred`` (logits, float32) and
``activated_pred`` (softmax over classes), NCHW, plus the S4L key (the
logits) and the CCT key (the latent: DeepLab-v2's backbone feature,
PSPNet's PSP output) (reference model.py:60-73). Heads train at 10x the
backbone's lr: DeepLab-v2's classifier (model.py:45-48), PSPNet's PSP
module and decoder (model.py:103-107), three lr groups.

* ``--freeze-bn``: the net runs in eval mode whatever mode the task model
  is put in (``train`` keeps ``net`` in eval), so BatchNorm normalises with
  its running statistics and never moves them (JAX model.py:64,
  ``train and not freeze_bn``); gradients still flow through it.
* ``--pretrained-path``: a torch checkpoint loaded after the
  initialisation: the reference's full DeepLab-v2 or PSPNet (keys under
  ``backbone.``/``model.backbone.``), else a bare torch ResNet into the
  backbone (JAX model.py:75-84, ``models/convert.py``).
* ``--remat``: every bottleneck of the backbone checkpointed
  (``models/resnet.py``).
"""

import torch

from ...models import convert
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
    parser.add_argument('--freeze-bn', type=cmd.str2bool, default=False,
                        metavar='', help='sseg - freeze BatchNorm statistics')
    parser.add_argument('--pretrained-path', type=str, default='',
                        metavar='', help='sseg - a torch checkpoint: a '
                                         'ResNet backbone or a full model '
                                         '(see models/convert.py)')
    parser.add_argument('--remat', type=cmd.str2bool, default=False,
                        metavar='', help='sseg - recompute backbone '
                                         'activations in the backward pass '
                                         '(less memory, a longer step)')


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
                                  bf16=getattr(args, 'bf16', True),
                                  remat=getattr(args, 'remat', False))
        self.freeze_bn = bool(getattr(args, 'freeze_bn', False))
        self.net.train(not self.freeze_bn)

    def train(self, mode=True):
        super(_SsegModel, self).train(mode)
        if self.freeze_bn:
            self.net.train(False)
        return self

    def load_pretrained(self, path):
        state = convert.load_torch_state_dict(path)
        if any(k.startswith(('backbone.', 'model.backbone.')) for k in state):
            return self.full_converter(state, self.state_dict())[0]
        return convert.load_pretrained_backbone(self, state)

    def map_height(self, key, h):
        """The global height of the resulter's map ``key`` for inputs ``h``
        rows high: the latent's is the backbone's output height."""
        return self.net.backbone.out_height(h) if key == 'sslcct_ad_inp' \
            else h

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
    full_converter = staticmethod(convert.convert_deeplab_v2)


class PSPNetModel(_SsegModel):
    """PSPNet wrapper (reference model.py:87-125)."""

    net_class = PSPNet
    lr_mult_spec = (('psp', 10.0), ('decoder', 10.0))
    full_converter = staticmethod(convert.convert_pspnet)
