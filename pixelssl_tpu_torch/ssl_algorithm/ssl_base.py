"""SSL algorithm base (counterpart of
``pixelssl_tpu/ssl_algorithm/ssl_base.py``).

An algorithm owns its modules, optimizers and schedules on one device and
takes one train step per ``train_step(batch)``; ``state.step`` counts the
steps taken. ``build()`` initialises every weight from one
``torch.Generator`` seeded with ``--seed``, on the CPU, then moves the
modules to the algorithm's device. ``validate`` scores the models that the
algorithm's ``_eval_fn`` names; ``save_checkpoint``/``load_checkpoint``
carry every module, every optimizer, the step, the seed and the
algorithm's name, which ``load_checkpoint`` checks (reference ssl_null.py:194-218).

Per-step randomness comes from ``_step_rng(step, salt)``, a generator
seeded from ``(seed, step)``: resuming needs the seed and the step, which
the checkpoint carries as the JAX package's carries its base key.
"""

import json
import os

import numpy as np
import torch

from ..nn.func import count_params
from ..task_template.func import METRIC_STR
from ..utils import logger
from ..utils.logger import AvgMeterSet


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
    """What the algorithm carries across steps besides the weights, which
    live in its modules and optimizers: the step count and the seed of the
    per-step generators."""

    def __init__(self, seed):
        self.step = 0
        self.seed = int(seed)


class SSLBase(object):
    NAME = 'ssl_base'
    SUPPORTED_TASK_TYPES = []

    def __init__(self, args, ctx):
        self.args = args
        self.ctx = ctx
        self.device = ctx.device
        self.state = None
        self.modules = {}
        self.optimizers = {}
        self.meters = AvgMeterSet()

    def build(self):
        """Initialise the weights from ``--seed``."""
        generator = torch.Generator().manual_seed(int(self.args.seed))
        self.modules = self._build_modules(generator)
        for name, module in self.modules.items():
            module.to(self.device).train()
            logger.log_info('Model `{0}`: {1:,} parameters'.format(
                name, count_params(module)))
        self.optimizers = self._build_optimizers()
        self.state = TrainState(self.args.seed)
        return self.state

    def _build_modules(self, generator):
        """Create and initialise the modules; returns {name: module}."""
        raise NotImplementedError

    def _build_optimizers(self):
        """Create the optimizers; returns {name: optimizer}."""
        raise NotImplementedError

    def train_step(self, batch):
        """One train step on ``{'inp': (...), 'gt': (...)}``; returns the
        metrics as 0-d float32 tensors."""
        metrics = self._step_fn(self.ctx.task_func.device_prep(batch))
        self.state.step += 1
        return metrics

    def _step_fn(self, batch):
        raise NotImplementedError

    def _eval_fn(self, batch):
        """Eval forward, modules in eval mode and without gradients:
        ``{model_id: (activated_pred_tuple, loss_vec)}``, one entry per
        model to score (MT scores student and teacher)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # helpers shared by the step functions
    # ------------------------------------------------------------------

    def _step_rng(self, step, salt=0):
        """A generator on the algorithm's device for step ``step``, seeded
        from ``(seed, step * 131 + salt)`` as the JAX package folds its key
        (ssl_base.py:173-175); the draws themselves differ from JAX's."""
        seq = np.random.SeedSequence([self.state.seed,
                                      int(step) * 131 + int(salt)])
        seed = int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))
        return torch.Generator(device=self.device).manual_seed(seed)

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

    # ------------------------------------------------------------------
    # validation (JAX ssl_base.py:396-445)
    # ------------------------------------------------------------------

    def validate(self, data_loader, epoch):
        """Score every model of ``_eval_fn`` on ``data_loader``'s batches;
        returns ``{metric key: value}``. A batch may carry a ``valid``
        mask [N] that weights its per-sample losses."""
        self.meters = AvgMeterSet()  # no stale training keys
        task_func = self.ctx.task_func
        for module in self.modules.values():
            module.eval()
        try:
            with torch.no_grad():
                for batch in data_loader:
                    batch = task_func.device_prep(batch)
                    valid = batch.get('valid')
                    for model_id, (activated_pred, loss_vec) in \
                            self._eval_fn(batch).items():
                        if valid is not None:
                            v = valid.to(loss_vec)
                            loss = (loss_vec * v).sum() / v.sum().clamp(min=1.0)
                        else:
                            loss = loss_vec.mean()
                        self.meters.update('{0}_loss'.format(model_id),
                                           float(loss))
                        task_func.metrics(activated_pred, batch['gt'],
                                          batch['inp'], self.meters,
                                          id_str=model_id)
        finally:
            for module in self.modules.values():
                module.train()

        results = {key: meter.avg for key, meter in self.meters.items()
                   if METRIC_STR in key}
        losses = {key: meter.avg for key, meter in self.meters.items()
                  if key.endswith('_loss')}
        for key, value in list(results.items()) + list(losses.items()):
            logger.log_info('val epoch {0}: {1} = {2:.5f}'.format(
                epoch, key, float(value)))
        record = {k: float(v) for k, v in results.items()}
        record.update({k: float(v) for k, v in losses.items()})
        self._log_jsonl(dict(record, phase='val', epoch=epoch,
                             algorithm=self.NAME))
        return results

    def _log_jsonl(self, record):
        """Append ``record`` to ``metrics.jsonl`` beside
        ``--checkpoint-path`` (nothing without one)."""
        path = getattr(self.args, 'checkpoint_path', '')
        if not path:
            return
        out = os.path.join(os.path.dirname(path.rstrip('/')), 'metrics.jsonl')
        with open(out, 'a') as f:
            f.write(json.dumps(record) + '\n')

    # ------------------------------------------------------------------
    # checkpoints (JAX ssl_base.py:448-505)
    # ------------------------------------------------------------------

    def save_checkpoint(self, epoch, path=None):
        """``torch.save`` of every module's and optimizer's ``state_dict``,
        the step, the seed, the epoch and the algorithm's name, to ``path`` or
        ``<checkpoint_path>/checkpoint_<epoch>.pth``; a file already there
        is replaced. Returns the path."""
        if path is None:
            path = os.path.join(self.args.checkpoint_path,
                                'checkpoint_{0}.pth'.format(epoch))
        path = os.path.abspath(path)
        payload = {
            'algorithm_name': self.NAME,
            'epoch': int(epoch),
            'step': int(self.state.step),
            'seed': int(self.state.seed),
            'modules': {k: m.state_dict() for k, m in self.modules.items()},
            'optimizers': {k: o.state_dict()
                           for k, o in self.optimizers.items()},
        }
        tmp = path + '.tmp'
        torch.save(payload, tmp)
        os.replace(tmp, path)
        logger.log_info('Saved checkpoint: {0}'.format(path))
        return path

    def load_checkpoint(self, path=None):
        """Restore a checkpoint of ``save_checkpoint`` (``path`` or
        ``--resume``) into the built algorithm; refuses one that another
        algorithm wrote. Returns its epoch."""
        path = os.path.abspath(path or self.args.resume)
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        saved_name = ckpt.get('algorithm_name')
        if saved_name != self.NAME:
            logger.log_err('Checkpoint at {0} was saved by SSL algorithm '
                           '`{1}`, expected `{2}` (reference guard: '
                           'ssl_null.py:206-218)'.format(
                               path, saved_name, self.NAME))
        for key, module in self.modules.items():
            module.load_state_dict(ckpt['modules'][key])
        for key, optimizer in self.optimizers.items():
            optimizer.load_state_dict(ckpt['optimizers'][key])
        self.state.step = int(ckpt['step'])
        self.state.seed = int(ckpt['seed'])
        logger.log_info('Loaded checkpoint: {0} (epoch {1})'.format(
            path, ckpt['epoch']))
        return int(ckpt['epoch'])


@torch.no_grad()
def ema_update(t_params, s_params, decay):
    """Teacher <- decay * teacher + (1 - decay) * student, in place, in
    float32 whatever the teacher's storage dtype; the result is rounded
    back to it (JAX ssl_base.py:517-527)."""
    t_params = list(t_params)
    work = [t.float() for t in t_params]  # float32 leaves: the same tensor
    torch._foreach_mul_(work, decay)
    torch._foreach_add_(work, [s.float() for s in s_params],
                        alpha=1.0 - decay)
    for t, w in zip(t_params, work):
        if w is not t:
            t.copy_(w)


def maybe_bf16(module, enabled):
    """Store a module's float32 parameters in bf16 when enabled, its
    buffers untouched (JAX ssl_base.py:530-536)."""
    if enabled:
        for p in module.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return module
