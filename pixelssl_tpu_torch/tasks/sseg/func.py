"""Semantic-segmentation task hooks (counterpart of
``pixelssl_tpu/tasks/sseg/func.py``), as far as GCT uses them
(reference task/sseg/func.py:176-192).
"""

import torch
import torch.nn.functional as F

from ...task_template import func_template


def task_func():
    return SemanticSegmentationFunc


class SemanticSegmentationFunc(func_template.TaskFunc):
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
