"""FC discriminator for AdvSSL (counterpart of
``pixelssl_tpu/models/discriminator.py``; reference
pixelssl/ssl_algorithm/ssl_adv.py:466-503, from Hung et al., "Adversarial
Learning for Semi-supervised Semantic Segmentation", BMVC'18), NCHW.

Four 4x4 stride-2 convolutions (64, 128, 256, 512 channels) with
LeakyReLU(0.2), a 4x4 stride-2 ``classifier`` to one channel, then an
``align_corners=True`` bilinear resize back to the input's size in float32.
No normalisation: the module's output for a sample depends on that sample
alone. With ``bf16`` the convolutions run under bf16 autocast, as the JAX
package's ``aux_compute_dtype`` does.

Inside a ``parallel.spatial.sharded`` block the input is this rank's rows
of maps of the context's height: the convolutions run row-sharded
(``models/layers.Conv2d``, the global height threaded through them), the
resize gives this rank's rows at the input's height, and the BCE is this
rank's share (``spatial.sample_mean``).
"""

import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from .layers import (Conv2d, bf16_autocast, lecun_normal_, resize_bilinear,
                     leaky_relu_02)


class FCDiscriminator(nn.Module):
    NAMES = ('conv1', 'conv2', 'conv3', 'conv4')

    def __init__(self, in_channels, ndf=64, bf16=False):
        super(FCDiscriminator, self).__init__()
        self.bf16 = bf16
        ch = in_channels
        for i, name in enumerate(self.NAMES):
            setattr(self, name, Conv2d(ch, ndf * 2 ** i, 4, stride=2,
                                       padding=1))
            ch = ndf * 2 ** i
        self.classifier = Conv2d(ch, 1, 4, stride=2, padding=1,
                                 float32_out=True)

    def init_weights(self, generator=None):
        """LeCun normal weights and zero biases (the JAX package's flax
        defaults)."""
        for name in self.NAMES + ('classifier',):
            lecun_normal_(getattr(self, name), generator)

    def forward(self, task_pred):
        """[N,C,H,W] -> raw logits [N,1,H,W] (the BCE activates them)."""
        x = task_pred
        h = height = spatial.global_height(task_pred)
        with bf16_autocast(x, self.bf16):
            for name in self.NAMES:
                conv = getattr(self, name)
                x, h = leaky_relu_02(conv(x, h)), conv.out_height(h)
            x, h = self.classifier(x, h), self.classifier.out_height(h)
        return resize_bilinear(x.float(), (height, task_pred.shape[3]),
                               align_corners=True, h=h)


def fc_discriminator_criterion(pred, gt):
    """Per-pixel BCE with logits, the mean over (C,H,W): [N] (reference
    ssl_adv.py:496-503); this rank's share of it inside a spatial
    context."""
    loss = F.binary_cross_entropy_with_logits(pred.float(), gt.float(),
                                              reduction='none')
    return spatial.sample_mean(loss)
