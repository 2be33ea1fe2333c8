"""Semantic-segmentation task hooks (counterpart of
``pixelssl_tpu/tasks/sseg/func.py``): the validation metrics (reference
task/sseg/func.py:36-80) and the AdvSSL, GCT, S4L and CCT hooks (JAX
func.py:126-152,180-207). The maps are NCHW: a one-hot GT is [N,C,H,W] and
a discriminator's confidence map [N,1,H,W], where the JAX hooks take and
give NHWC.

``metrics`` builds the confusion matrix on the device; only the C x C
counts cross to the host. ``device_prep`` normalises ``--u8-transfer``
batches on the card.
"""

import functools

import torch
import torch.nn.functional as F

from ...ops.confusion import confusion_matrix, scores_from_confusion
from ...task_template import func_template
from ...utils import logger
from . import data


def task_func():
    return SemanticSegmentationFunc


@functools.lru_cache(maxsize=None)
def _mean_std(device):
    """``data.VOC_MEAN`` and ``VOC_STD`` as [3,1,1] float32 tensors on
    ``device``, copied there once: a captured step copies nothing from the
    host."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)[:, None,
                                                                      None]
                 for v in (data.VOC_MEAN, data.VOC_STD))


class SemanticSegmentationFunc(func_template.TaskFunc):
    def device_prep(self, batch):
        """The ``--u8-transfer`` batch made what the algorithms take (JAX
        func.py:48-65): uint8 images normalised on the device with the host
        path's mean and std (``data.normalize_image``), uint8/int8/int16
        labels widened to int64. Other batches pass through unchanged."""
        inp, gt = batch['inp'], batch['gt']
        x = inp[0]
        if x.dtype == torch.uint8:
            mean, std = _mean_std(x.device)
            inp = ((x.float() / 255.0 - mean) / std,) + tuple(inp[1:])
        g = gt[0]
        if g.dtype in (torch.uint8, torch.int8, torch.int16):
            gt = (g.long(),) + tuple(gt[1:])
        if inp is batch['inp'] and gt is batch['gt']:
            return batch
        return dict(batch, inp=inp, gt=gt)

    def metrics(self, pred, gt, inp, meters, id_str=''):
        """Add this batch's confusion matrix to the meter
        ``{id}_confusion_matrix``; the ``{id}_metric_*`` meters then hold
        the scores of the summed matrix (reference func.py:36-80)."""
        if len(pred) != 1 or len(gt) != 1:
            raise ValueError('sseg metrics take one prediction and one gt')
        gt0 = gt[0]
        if gt0.dim() == 4:
            gt0 = gt0[:, 0]
        cm = confusion_matrix(pred[0].argmax(dim=1), gt0,
                              self.args.num_classes, self.args.ignore_index)

        cm_key = '{0}_confusion_matrix'.format(id_str)
        meters.update(cm_key, cm.cpu().numpy())
        scores = scores_from_confusion(meters[cm_key].sum)
        for name in ('acc', 'acc_class', 'mIoU', 'fwIoU'):
            key = '{0}_{1}_{2}'.format(id_str, self.METRIC_STR, name)
            meters.reset(key)
            meters.update(key, scores[name])

    def ssladv_fcd_in_channels(self):
        return self.args.num_classes

    def ssladv_preprocess_fcd_criterion(self, fcd_pred, task_gt, is_real):
        """(masked logits, target) for the discriminator's BCE:
        ``fcd_pred`` [N,1,H,W], ``task_gt`` [N,H,W] labels or None. Both
        are zero on ``ignore_index`` pixels, so the BCE counts each of them
        as log 2, as the JAX hook does."""
        if task_gt is None:
            mask = torch.ones_like(fcd_pred)
        else:
            mask = (task_gt != self.args.ignore_index)[:, None].to(
                fcd_pred.dtype)
        fcd_gt = torch.full_like(fcd_pred, 1.0 if is_real else 0.0) * mask
        return fcd_pred * mask, fcd_gt

    def ssladv_convert_task_gt_to_fcd_input(self, task_gt):
        """[N,H,W] labels -> [N,C,H,W] float32 one-hot, the
        discriminator's real sample. A label outside [0, C), such as
        ``ignore_index``, gives an all-zero pixel, as ``jax.nn.one_hot``
        does (``F.one_hot`` would raise on it)."""
        return self._one_hot(task_gt).permute(0, 3, 1, 2)

    def _one_hot(self, task_gt, keep=None):
        """[N,H,W] labels -> [N,H,W,C] float32 one-hot, zero where the
        label is outside [0, C) or ``keep`` is False."""
        num_classes = self.args.num_classes
        valid = (task_gt >= 0) & (task_gt < num_classes)
        if keep is not None:
            valid = valid & keep
        safe = torch.where(valid, task_gt, torch.zeros_like(task_gt)).long()
        return F.one_hot(safe, num_classes).float() * valid[..., None].float()

    def sslgct_fd_in_channels(self):
        return self.args.num_classes + 3

    def sslgct_prepare_task_gt_for_fdgt(self, task_gt):
        """[N,H,W] labels -> [N,H,W,C] float32 one-hot (NHWC, as the JAX
        hook returns it). Rows at ``ignore_index``, and any label outside
        [0, C), are all zero."""
        return self._one_hot(task_gt, task_gt != self.args.ignore_index)

    def ssls4l_rc_in_channels(self):
        return self.args.num_classes

    def sslcct_activate_ad_preds(self, ad_preds):
        return [torch.softmax(p, dim=1) for p in ad_preds]

    def sslcct_ad_in_channels(self):
        """The latent's channels: PSPNet's PSP output, DeepLab-v2's
        backbone feature."""
        arch = self.args.models['model']
        if arch == 'pspnet':
            return 512
        if arch == 'deeplabv2':
            return 2048
        logger.log_err('sslcct_ad_in_channels does not support model '
                       '`{0}`'.format(arch))

    def sslcct_ad_out_channels(self):
        return self.args.num_classes

    def sslcct_ad_upsample_scale(self):
        arch = self.args.models['model']
        if arch in ('pspnet', 'deeplabv2'):
            return 8
        logger.log_err('sslcct_ad_upsample_scale does not support model '
                       '`{0}`'.format(arch))
