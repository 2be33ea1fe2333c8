"""SSL algorithm base (counterpart of
``pixelssl_tpu/ssl_algorithm/ssl_base.py``), as far as GCT uses it.

An algorithm owns its task models, optimizers and schedules on one device
and takes one train step per ``train_step(batch)``; ``state.step`` counts
the steps taken. ``build()`` initialises every weight from one
``torch.Generator`` seeded with ``--seed``, on the CPU, then moves the
modules to the algorithm's device.
"""

import torch

from ..nn.func import count_params
from ..utils import logger


class TaskContext(object):
    """Everything the harness resolves for an algorithm build (reference
    export-function arguments, ssl_base.py:19-37: args, model_dict,
    optimizer_dict, lrer_dict, criterion_dict, task_func), plus the device,
    the labeled/unlabeled split of the batch and the iterations per epoch.
    """

    def __init__(self, args, models, optimizers, lrers, criterions, task_func,
                 device, lbs=None, ubs=None, iters_per_epoch=None):
        self.args = args
        self.models = models            # dict name -> TaskModel class
        self.optimizers = optimizers    # dict name -> OptimizerFactory
        self.lrers = lrers              # dict name -> LRSchedulerFactory
        self.criterions = criterions    # dict name -> TaskCriterion
        self.task_func = task_func
        self.device = device
        self.n_dev = 1
        self.lbs = lbs
        self.ubs = ubs
        self.iters_per_epoch = iters_per_epoch


class TrainState(object):
    """What the algorithm counts across steps; the weights live in its
    modules and optimizers."""

    def __init__(self):
        self.step = 0


class SSLBase(object):
    NAME = 'ssl_base'
    SUPPORTED_TASK_TYPES = []

    def __init__(self, args, ctx):
        self.args = args
        self.ctx = ctx
        self.device = ctx.device
        self.state = None

    def build(self):
        """Initialise the weights from ``--seed``."""
        generator = torch.Generator().manual_seed(int(self.args.seed))
        modules = self._build_modules(generator)
        for name, module in modules.items():
            module.to(self.device).train()
            logger.log_info('Model `{0}`: {1:,} parameters'.format(
                name, count_params(module)))
        self._build_optimizers()
        self.state = TrainState()
        return self.state

    def _build_modules(self, generator):
        """Create and initialise the modules; returns {name: module}."""
        raise NotImplementedError

    def _build_optimizers(self):
        raise NotImplementedError

    def train_step(self, batch):
        """One train step on ``{'inp': (...), 'gt': (...)}``; returns the
        metrics as 0-d float32 tensors."""
        metrics = self._step_fn(batch)
        self.state.step += 1
        return metrics

    def _step_fn(self, batch):
        raise NotImplementedError

    def _global_mean(self, vec):
        """Mean of a per-sample vector over the batch (one card)."""
        return vec.mean()

    @staticmethod
    def _apply_updates(optimizer, loss, params):
        """Gradient of ``loss`` for ``params`` only, then one optimizer
        step; other leaves of the graph gather no gradient."""
        optimizer.zero_grad(set_to_none=True)
        loss.backward(inputs=list(params))
        optimizer.step()
