"""DeepLab-v2: dilated ResNet + ASPP classifier (counterpart of
``pixelssl_tpu/models/deeplab_v2.py``), NCHW.

Four parallel 3x3 convs with bias and dilations (6,12,18,24), summed
(reference task/sseg/module/deeplab_v2.py:71-85), then an
``align_corners=True`` bilinear resize back to the input size in float32
(deeplab_v2.py:32). With ``bf16`` the convolutions run under bf16 autocast
on the card, as the JAX package's default ``--bf16`` runs them; parameters,
BN statistics and the output stay float32. In bf16 each branch adds its
bias after the product and the branches sum in bf16, but for the last
add, which is float32 (``models/layers.py``).

Inside a ``parallel.spatial.sharded`` block the input is this rank's rows
of images of the context's height: the backbone and ASPP run row-sharded
(``models/layers.py``) and the logits are resized to the global input size.
"""

import torch
import torch.nn as nn

from ..parallel import spatial
from .layers import Conv2d, bf16_autocast, resize_bilinear
from .resnet import build_backbone


class ASPPClassifier(nn.Module):
    def __init__(self, in_channels, num_classes, dilations=(6, 12, 18, 24)):
        super(ASPPClassifier, self).__init__()
        self.conv2d_list = nn.ModuleList(
            Conv2d(in_channels, num_classes, 3, padding=d, dilation=d,
                   bias=True)
            for d in dilations)

    def init_weights(self, generator=None):
        with torch.no_grad():
            for conv in self.conv2d_list:
                conv.weight.normal_(0.0, 0.01, generator=generator)
                conv.bias.zero_()

    def forward(self, x, h=None):
        out, *rest = [conv(x, h) for conv in self.conv2d_list]
        for i, y in enumerate(rest, 1):
            if i == len(rest) and y.dtype == torch.bfloat16:
                # the JAX model casts the sum to float32, and under jax.jit
                # its last add is then not rounded to bf16
                out, y = out.float(), y.float()
            out = out + y
        return out


class DeepLabV2(nn.Module):
    """Returns (logits at input resolution, backbone feature)."""

    def __init__(self, backbone='resnet101', output_stride=16, num_classes=21,
                 bf16=False, remat=False):
        super(DeepLabV2, self).__init__()
        self.bf16 = bf16
        self.backbone = build_backbone(backbone, output_stride, remat=remat)
        self.classifier = ASPPClassifier(2048, num_classes)

    def init_weights(self, generator=None):
        self.backbone.init_weights(generator)
        self.classifier.init_weights(generator)

    def forward(self, x):
        h = spatial.global_height(x)
        h4 = self.backbone.out_height(h)
        with bf16_autocast(x, self.bf16):
            bx = self.backbone(x, h)
            logits = self.classifier(bx, h4)
        logits = resize_bilinear(logits.float(), (h, x.shape[3]),
                                 align_corners=True, h=h4)
        return logits, bx
