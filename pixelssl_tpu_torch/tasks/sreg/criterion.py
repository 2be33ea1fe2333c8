"""Pixel-regression criterion (counterpart of
``pixelssl_tpu/tasks/sreg/criterion.py``): per sample, the mean squared
error of ``sigmoid(pred)`` against the GT over the pixels whose GT is not
``--ignore-index`` (255.0, the validation loader's padding), in float32.
Inside a ``parallel.spatial.sharded`` block each rank gives its share of
it: its rows' squared errors over the sample's valid pixels on every rank
of the spatial group (``spatial.group_sum``), whose sum over the group is
the sample's MSE.
"""

import torch

from ...parallel import spatial
from ...task_template import criterion_template
from ...utils import logger


def sreg_criterion():
    return MaskedMseCriterion


def mse_per_sample(pred, gt, ignore_index):
    """[N,1,H,W] activated pred + [N,1,H,W] float GT -> [N]."""
    pred = pred.float()
    gt = gt.float()
    valid = (gt != ignore_index).float()
    se = torch.square(pred - gt) * valid
    denom = torch.clamp(spatial.group_sum(valid.sum(dim=(1, 2, 3))), min=1.0)
    return se.sum(dim=(1, 2, 3)) / denom


class MaskedMseCriterion(criterion_template.TaskCriterion):
    def __call__(self, pred, gt, inp):
        if len(pred) != 1 or len(gt) != 1 or len(inp) != 1:
            logger.log_err('sreg criterion requires len(pred) == len(gt) == '
                           'len(inp) == 1')
        return mse_per_sample(torch.sigmoid(pred[0].float()), gt[0],
                              self.args.ignore_index)
