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

Inside a ``parallel.spatial.sharded`` block the inputs are this rank's rows
at the context's height: the convolutions run row-sharded, IBNorm's
instance statistics sum over the sample's rows on every rank of the spatial
group (its BatchNorm half over every rank, ``SyncBatchNorm.sync``), the
map is resized to the global size, and ``flaw_detector_criterion`` gives
this rank's share of each sample's mean.
"""

import torch
import torch.nn as nn

from ..parallel import all_sum, spatial
from .layers import (Conv2d, SyncBatchNorm, bf16_autocast, lecun_normal_,
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
        rows = spatial.active()
        if rows is None:
            mean = xi.mean(dim=(2, 3), keepdim=True)
            var = xi.var(dim=(2, 3), unbiased=False, keepdim=True)
        else:
            # two passes over the sample's rows on every rank, as ``var``
            # takes them
            mesh, group = rows.mesh, rows.mesh.spatial_group
            count = all_sum(torch.full((1,), float(xi[0, 0].numel()),
                                       device=xi.device), mesh, group)
            mean = all_sum(xi.sum(dim=(2, 3), keepdim=True), mesh,
                           group) / count
            var = all_sum(torch.square(xi - mean).sum(
                dim=(2, 3), keepdim=True), mesh, group) / count
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
            setattr(self, name, Conv2d(ch, ndf * mult, 4, stride=stride,
                                       padding=1))
            setattr(self, 'ibn' + name[4:], IBNorm(ndf * mult))
            ch = ndf * mult
        self.classifier = Conv2d(ch, 1, 4, stride=2, padding=1,
                                 float32_out=True)

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
        size = (spatial.global_height(task_pred), task_pred.shape[3])
        h = spatial.global_height(x)
        with bf16_autocast(x, self.bf16):
            for name, _, _ in self.SPEC:
                conv = getattr(self, name)
                x = conv(x, h)
                h = conv.out_height(h)
                x = getattr(self, 'ibn' + name[4:])(x)
                x = leaky_relu_02(x)
            x = self.classifier(x, h)
            h = self.classifier.out_height(h)
        return resize_bilinear(x.float(), size, align_corners=True, h=h)


def flaw_detector_criterion(pred, gt, reduction=True):
    """Per-pixel MSE (reference ssl_gct.py:610-621) of GCT's NHWC maps;
    with ``reduction`` the mean over every axis but the first, giving [N]
    (inside a ``parallel.spatial.sharded`` block this rank's share of
    it)."""
    loss = torch.square(pred.float() - gt.float())
    if reduction:
        return spatial.sample_mean(loss, h_dim=1)
    return loss
