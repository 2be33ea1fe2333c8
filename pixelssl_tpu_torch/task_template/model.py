"""Task model contract (counterpart of
``pixelssl_tpu/task_template/model.py``; reference
pixelssl/task_template/model.py:17-85).

A task model is an ``nn.Module`` whose ``forward(inp_tuple)`` returns a
``resulter`` dict with at least ``'pred'`` (tuple of raw outputs) and
``'activated_pred'`` (tuple of activated outputs), NCHW. The reference's
param groups (backbone 1x lr, heads 10x) are ``lr_mult_spec`` rules on
parameter names; ``param_groups()`` turns them into optimizer groups that
carry their ``lr_mult``.
"""

import torch.nn as nn


class TaskModel(nn.Module):
    """Subclasses set ``self.net`` and may override ``lr_mult_spec``: a list
    of ``(name_substring, multiplier)`` rules, first match wins, default
    1.0."""

    lr_mult_spec = ()

    def __init__(self, args):
        super(TaskModel, self).__init__()
        self.args = args

    def init_weights(self, generator=None):
        self.net.init_weights(generator)

    def lr_mult(self, name):
        for substr, mult in self.lr_mult_spec:
            if substr in name:
                return float(mult)
        return 1.0

    def param_groups(self):
        return group_by_lr_mult(self.named_parameters(), self.lr_mult)


def group_by_lr_mult(named_parameters, lr_mult):
    """One optimizer group per distinct ``lr_mult(name)``, in first-seen
    order."""
    groups = {}
    for name, p in named_parameters:
        groups.setdefault(lr_mult(name), []).append(p)
    return [{'params': ps, 'lr_mult': m} for m, ps in groups.items()]

