"""Semantic-segmentation task hooks (counterpart of
``pixelssl_tpu/tasks/sseg/func.py``): the validation metrics (reference
task/sseg/func.py:36-80) and the GCT hooks (func.py:176-192).

``metrics`` builds the confusion matrix on the device; only the C x C
counts cross to the host. The ``--u8-transfer`` form of ``device_prep``
belongs to the input path, which is not ported yet.
"""

import torch
import torch.nn.functional as F

from ...ops.confusion import confusion_matrix, scores_from_confusion
from ...task_template import func_template


def task_func():
    return SemanticSegmentationFunc


class SemanticSegmentationFunc(func_template.TaskFunc):
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

    def sslgct_fd_in_channels(self):
        return self.args.num_classes + 3

    def sslgct_prepare_task_gt_for_fdgt(self, task_gt):
        """[N,H,W] labels -> [N,H,W,C] float32 one-hot (NHWC, as the JAX
        hook returns it). Rows at ``ignore_index``, and any label outside
        [0, C), are all zero."""
        num_classes = self.args.num_classes
        keep = ((task_gt >= 0) & (task_gt < num_classes) &
                (task_gt != self.args.ignore_index))
        safe = torch.where(keep, task_gt, torch.zeros_like(task_gt)).long()
        one_hot = F.one_hot(safe, num_classes).float()
        return one_hot * keep[..., None].float()
