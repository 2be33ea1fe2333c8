"""Flaw detector for GCT (counterpart of
``pixelssl_tpu/models/flaw_detector.py``; reference
pixelssl/ssl_algorithm/ssl_gct.py:539-621), NCHW.

Seven 4x4 convs (four strided, three stride-1), each followed by IBNorm
(BatchNorm on the first ``int(C*0.5+0.5)`` channels, affine-free
InstanceNorm in float32 on the rest) and LeakyReLU(0.2); a strided 4x4
classifier; an ``align_corners=True`` bilinear resize back to the
prediction's size in float32. The input is the channel concatenation of the
task input and the task prediction. With ``bf16`` the convolutions run
under bf16 autocast, as the JAX package's ``aux_compute_dtype`` does.
"""

import torch
import torch.nn as nn

from .layers import (SyncBatchNorm, bf16_autocast, lecun_normal_,
                     resize_bilinear, leaky_relu_02)


class IBNorm(nn.Module):
    """BatchNorm || InstanceNorm channel split (reference ssl_gct.py:588-607)."""

    def __init__(self, channels):
        super(IBNorm, self).__init__()
        self.num_bn = int(channels * 0.5 + 0.5)
        self.bnorm = SyncBatchNorm(self.num_bn)

    def forward(self, x):
        xb = self.bnorm(x[:, :self.num_bn])
        if self.num_bn == x.shape[1]:
            return xb
        xi = x[:, self.num_bn:].float()
        mean = xi.mean(dim=(2, 3), keepdim=True)
        var = xi.var(dim=(2, 3), unbiased=False, keepdim=True)
        xi = (xi - mean) * torch.rsqrt(var + 1e-5)
        return torch.cat([xb, xi.to(xb.dtype)], dim=1)


class FlawDetector(nn.Module):
    SPEC = (('conv1', 1, 2), ('conv2', 2, 2), ('conv2_1', 2, 1),
            ('conv3', 4, 2), ('conv3_1', 4, 1), ('conv4', 8, 2),
            ('conv4_1', 8, 1))

    def __init__(self, in_channels, ndf=64, bf16=False):
        super(FlawDetector, self).__init__()
        self.bf16 = bf16
        ch = in_channels
        for name, mult, stride in self.SPEC:
            setattr(self, name, nn.Conv2d(ch, ndf * mult, 4, stride=stride,
                                          padding=1))
            setattr(self, 'ibn' + name[4:], IBNorm(ndf * mult))
            ch = ndf * mult
        self.classifier = nn.Conv2d(ch, 1, 4, stride=2, padding=1)

    def init_weights(self, generator=None):
        """LeCun normal weights and zero biases (the JAX package's flax
        defaults), BN scale 1 and shift 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, task_inp, task_pred):
        x = torch.cat(tuple(task_inp) + (task_pred,), dim=1)
        with bf16_autocast(x, self.bf16):
            for name, _, _ in self.SPEC:
                x = getattr(self, name)(x)
                x = getattr(self, 'ibn' + name[4:])(x)
                x = leaky_relu_02(x)
            x = self.classifier(x)
        return resize_bilinear(x.float(), task_pred.shape[2:],
                               align_corners=True)


def flaw_detector_criterion(pred, gt, reduction=True):
    """Per-pixel MSE (reference ssl_gct.py:610-621); with ``reduction`` the
    mean over every axis but the first, giving [N]."""
    loss = torch.square(pred.float() - gt.float())
    if reduction:
        return loss.mean(dim=tuple(range(1, loss.dim())))
    return loss
