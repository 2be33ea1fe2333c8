"""Semantic-segmentation criterion (counterpart of
``pixelssl_tpu/tasks/sseg/criterion.py``; reference
task/sseg/criterion.py:18-38).

Per-sample cross entropy: the mean over all H*W pixels, where an invalid
pixel (< 0, >= C, or ``ignore_index``) adds 0 to the sum but still counts
in the denominator, as the reference's ``CrossEntropyLoss(ignore_index,
reduction='none')`` followed by ``torch.mean(loss, dim=(1,2))``. Unlabeled
rows carry -1; they are masked before ``F.cross_entropy``, which raises on
out-of-range targets. Inside a ``parallel.spatial.sharded`` block each rank
holds rows of the sample, and its loss is its share: the sum over its
pixels over the global H*W, whose sum over the spatial group is the
sample's loss.
"""

import torch
import torch.nn.functional as F

from ...parallel import spatial
from ...task_template import criterion_template
from ...utils import logger


def sseg_criterion():
    return CommonSsegCriterion


def cross_entropy_per_sample(logits, gt, ignore_index):
    """[N,C,H,W] logits + [N,H,W] int gt -> [N] loss, in float32."""
    logits = logits.float()
    num_classes = logits.shape[1]
    valid = (gt >= 0) & (gt < num_classes) & (gt != ignore_index)
    safe_gt = torch.where(valid, gt, torch.zeros_like(gt)).long()
    ce = F.cross_entropy(logits, safe_gt, reduction='none')
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    return spatial.sample_mean(ce, h_dim=1)


class CommonSsegCriterion(criterion_template.TaskCriterion):
    def __call__(self, pred, gt, inp):
        if len(pred) != 1 or len(gt) != 1 or len(inp) != 1:
            logger.log_err('sseg criterion requires len(pred) == len(gt) == '
                           'len(inp) == 1')
        target = gt[0]
        if target.dim() == 4:
            target = target[:, 0]
        return cross_entropy_per_sample(pred[0], target, self.args.ignore_index)
