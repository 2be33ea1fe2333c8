"""Task criterion contract (counterpart of
``pixelssl_tpu/task_template/criterion.py``; reference
pixelssl/task_template/criterion.py:18-78).

A criterion maps ``(pred_tuple, gt_tuple, inp_tuple)`` to a per-sample 1-D
loss ``[batch]``; SSL algorithms split and mask that vector along the
labeled/unlabeled boundary without knowing the task.
"""


class TaskCriterion(object):
    def __init__(self, args):
        self.args = args

    def __call__(self, pred, gt, inp):
        raise NotImplementedError
