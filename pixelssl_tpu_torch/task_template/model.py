"""Task model contract (counterpart of
``pixelssl_tpu/task_template/model.py``; reference
pixelssl/task_template/model.py:17-85).

A task model is an ``nn.Module`` whose ``forward(inp_tuple)`` returns a
``resulter`` dict with at least ``'pred'`` (tuple of raw outputs) and
``'activated_pred'`` (tuple of activated outputs), NCHW. The reference's
param groups (backbone 1x lr, heads 10x) are ``lr_mult_spec`` rules on
parameter names; ``param_groups()`` turns them into optimizer groups that
carry their ``lr_mult``. ``init_weights`` initialises from the generator
and then, with ``--pretrained-path``, loads that checkpoint
(``load_pretrained``; JAX model.py:46-57).
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
        path = getattr(self.args, 'pretrained_path', '') if self.args else ''
        if path:
            self.load_pretrained(path)

    def load_pretrained(self, path):
        """Default: the file is a torch ResNet backbone checkpoint, loaded
        into ``net.backbone``. Task models override to dispatch full-model
        converters. Returns the tensors copied."""
        from ..models import convert
        return convert.load_pretrained_backbone(
            self, convert.load_torch_state_dict(path))

    def map_height(self, key, h):
        """The global height of the resulter's map ``key`` for inputs ``h``
        rows high (``parallel.spatial``: the row-sharded layers that read
        it need it). Default: the input's; task models whose latent is
        smaller override it."""
        return h

    def lr_rule(self, name):
        """(the first rule's substring that ``name`` holds, its
        multiplier), or (None, 1.0)."""
        for substr, mult in self.lr_mult_spec:
            if substr in name:
                return substr, float(mult)
        return None, 1.0

    def lr_mult(self, name):
        return self.lr_rule(name)[1]

    def param_groups(self):
        return group_by_lr_rule(self.named_parameters(), self.lr_rule)


def group_by_lr_rule(named_parameters, lr_rule):
    """One optimizer group per rule that ``lr_rule(name)`` matches (the
    reference's groups: PSPNet's backbone, PSP module and decoder are
    three), in first-seen order, each carrying its ``lr_mult``."""
    groups = {}
    for name, p in named_parameters:
        groups.setdefault(lr_rule(name), []).append(p)
    return [{'params': ps, 'lr_mult': mult}
            for (_, mult), ps in groups.items()]
