"""SSL algorithm base (counterpart of
``pixelssl_tpu/ssl_algorithm/ssl_base.py``).

An algorithm owns its modules, optimizers and schedules on one device and
takes one train step per ``train_step(batch)``; ``train(loader, epoch)``
runs an epoch of them and ``state.step`` counts the steps taken.
``build()`` initialises every weight from one
``torch.Generator`` seeded with ``--seed``, on the CPU, then moves the
modules to the algorithm's device. ``validate`` scores the models that the
algorithm's ``_eval_fn`` names; ``save_checkpoint``/``load_checkpoint``
carry every module, every optimizer, the step, the seed and the
algorithm's name, which ``load_checkpoint`` checks (reference ssl_null.py:194-218).

Per-step randomness comes from ``_step_rng(step, salt)``, a generator
seeded from ``(seed, step)``: resuming needs the seed and the step, which
the checkpoint carries as the JAX package's carries its base key.

``--steps-per-dispatch n > 1`` (the JAX package's ``_train_multi``, a
``lax.scan`` of n steps in one dispatch) runs ``train_steps``: on the card
one train step captured into a CUDA graph (``CapturedStep``) and replayed
once a step, with no host sync between replays; on the CPU the same loop
without a graph. The numbers a step takes from the host (lr, ramp-up
coefficients, EMA decay, the ``adam`` rules' bias corrections) come through
``_scalar(fn)`` (``StepScalars``): Python numbers in an eager step, 0-d
float32 tensors refilled before every replay in a captured one.

Under ``--distributed`` (``parallel``) each rank steps on its own slice of
the global batch: ``_global_mean`` is the mean over every rank's samples,
``_apply_updates`` sums the gradients over the ranks between ``backward``
and the optimizer's step, ``SyncBatchNorm`` sums its statistics, and rank
0's weights are broadcast at build. ``validate`` scores each rank's share
of the samples and sums the confusion matrices; rank 0 alone writes
checkpoints, ``metrics.jsonl`` and the ``--visualize`` PNGs (``train``,
``_train_multi``, ``validate``: an eval forward of the batch's first
sample at ``--visual-freq``, outside any CUDA graph).

Under ``--spatial-train`` (``parallel.spatial``, a data x spatial grid)
each rank holds the samples of its data coordinate and its rows of them
(``batch['height']``: the global height), and the step runs inside
``spatial.sharded``: every per-sample loss is the rank's share, whose sum
over the spatial group is the sample's loss; ``_global_mean`` counts the
samples over the data axis only; gradients and BN statistics sum over every
rank; each per-step draw is one draw at the global batch's shape from the
seed one process uses, of which the rank keeps its samples and rows
(``_global_draw``, ``_global_samples``). One step over any grid is then the
step one process takes on the global batch. ``validate`` scores whole
samples, a data rank each, or (``--spatial-val``, a loader with
``spatial_mesh``) the rows of one sample on every rank. ``--visualize``
runs on every rank of rank 0's spatial group (its eval forward exchanges
rows): the first sample's rows are gathered (``_first``) and rank 0 writes
them.
"""

import contextlib
import json
import os

import numpy as np
import torch
from torch.func import functional_call

from .. import parallel
from ..models.layers import SyncBatchNorm
from ..parallel import spatial
from ..nn import imageio
from ..nn import loader as nnloader
from ..nn.func import count_params, sigmoid_rampup
from ..nn.optimizer import ChainOptimizer
from ..ops import blur
from ..task_template.func import METRIC_STR
from ..utils import logger, profiler
from ..utils.logger import AvgMeterSet


class TaskContext(object):
    """Everything the harness resolves for an algorithm build (reference
    export-function arguments, ssl_base.py:19-37: args, model_dict,
    optimizer_dict, lrer_dict, criterion_dict, task_func), plus the device,
    the labeled/unlabeled split of this rank's batch, the iterations per
    epoch and the ``parallel.Mesh`` (by default this process's).
    ``n_dev`` is the number of ranks along the data axis, which the
    reference's lr x GPU-count scalings multiply by (ssl_adv.py:72,
    ssl_gct.py:107): spatial ranks split each image, not the batch.
    """

    def __init__(self, args, models, optimizers, lrers, criterions, task_func,
                 device, lbs=None, ubs=None, iters_per_epoch=None,
                 mesh=None):
        self.args = args
        self.models = models            # dict name -> TaskModel class
        self.optimizers = optimizers    # dict name -> OptimizerFactory
        self.lrers = lrers              # dict name -> LRSchedulerFactory
        self.criterions = criterions    # dict name -> TaskCriterion
        self.task_func = task_func
        self.device = device
        self.mesh = mesh if mesh is not None else parallel.make_mesh(device)
        self.n_dev = parallel.data_axis_size(self.mesh)
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


class StepScalars(object):
    """The numbers a train step takes from the host, each a function of
    the host's state (the step count, an optimizer's update count).

    By default ``get(fn)`` returns ``fn()``, a Python number, and the
    step's arithmetic is that of an eager step. Between ``begin()`` and
    ``end()`` (tensor mode) it returns a 0-d float32 tensor and keeps
    ``fn``: on the card a slot of ``values``, into which ``refill(fns)``
    writes every kept ``fn()`` before each replay of the captured step;
    on the CPU a new tensor holding ``fn()``. Either holds the float32
    rounding of the number that the eager step passes as a Python scalar,
    which a kernel rounds the same way, so both compute alike.
    """

    SLOTS = 64
    # pinned rows the host writes in turn: one is rewritten only after the
    # copy that read it ``RING`` replays ago has run
    RING = 64

    def __init__(self, device):
        self.device = torch.device(device)
        self.fns = None
        self.values = None
        self._pinned = None
        self._events = None
        self._turn = 0

    def get(self, fn):
        if self.fns is None:
            return fn()
        if self.device.type != 'cuda':
            self.fns.append(fn)
            return torch.tensor(fn(), dtype=torch.float32)
        if len(self.fns) == self.SLOTS:
            raise RuntimeError('a step takes more than {0} host scalars'
                               .format(self.SLOTS))
        self.fns.append(fn)
        return self.values[len(self.fns) - 1]

    def begin(self):
        if self.values is None and self.device.type == 'cuda':
            self.values = torch.zeros(self.SLOTS, dtype=torch.float32,
                                      device=self.device)
        self.fns = []

    def end(self):
        """Back to numbers; returns the functions kept since ``begin``."""
        fns, self.fns = self.fns, None
        return fns

    def refill(self, fns):
        """Every ``fn()`` of ``fns`` into its slot, through a pinned row
        copied on the current stream (the card only)."""
        if self._pinned is None:
            self._pinned = torch.zeros((self.RING, self.SLOTS),
                                       dtype=torch.float32).pin_memory()
            self._rows = self._pinned.numpy()
            self._events = [torch.cuda.Event() for _ in range(self.RING)]
        row = self._turn % self.RING
        self._turn += 1
        self._events[row].synchronize()
        self._rows[row, :len(fns)] = [fn() for fn in fns]
        self.values[:len(fns)].copy_(self._pinned[row, :len(fns)],
                                     non_blocking=True)
        self._events[row].record()


class CapturedStep(object):
    """One train step of ``algo`` captured into a CUDA graph, replayed once
    a step (the counterpart of the JAX package's ``lax.scan`` body).

    The graph reads its batch from static buffers, which ``run`` fills
    from each batch on the device, and its per-step numbers from the
    algorithm's ``StepScalars``; the per-step generators of
    ``_step_rng`` are one registered generator a salt, seeded before each
    replay with the seed ``_step_rng`` would give that step, so that the
    draws are the eager step's. Capture runs no kernel and must leave the
    host's state as it was: the update counts that ``ChainOptimizer``s keep
    on the host and every group's lr are put back, and ``run`` moves those
    counts, ``state.step`` and the blur kernel's ``launches`` (by the calls
    the capture recorded) after each replay; torch's capturable ``Adam``
    keeps its count on the device, where the replay advances it.
    Parameters, buffers and optimizer state exist before the capture (an
    eager step ran first) and are updated in place ever after.
    """

    SALTS = (0, 1)

    def __init__(self, algo, batch):
        self.algo = algo
        device = algo.device
        torch.cuda.synchronize(device)
        self.static = {key: tuple(x.clone() for x in batch[key])
                       for key in ('inp', 'gt')}
        self.height = batch.get('height')
        self.generators = {salt: torch.Generator(device=device)
                           for salt in self.SALTS}
        self.graph = torch.cuda.CUDAGraph()
        for generator in self.generators.values():
            self.graph.register_generator_state(generator)
        optimizers = list(algo.optimizers.values())
        self.counted = [opt for opt in optimizers
                        if isinstance(opt, ChainOptimizer)]
        counts = [opt.counts() for opt in self.counted]
        lrs = [[g['lr'] for g in opt.param_groups] for opt in optimizers]
        captured = blur.captured
        algo.step_scalars.begin()
        algo._capture_generators = self.generators
        try:
            with torch.cuda.graph(self.graph), \
                    algo._step_context(dict(self.static,
                                            height=self.height)):
                self.outputs = algo._step_fn(
                    algo.ctx.task_func.device_prep(self.static))
        finally:
            algo._capture_generators = None
            self.fns = algo.step_scalars.end()
            self.count_steps = []
            for opt, before in zip(self.counted, counts):
                after = opt.counts()
                self.count_steps.append({p: n - before.get(p, 0)
                                         for p, n in after.items()})
                opt.advance({p: -n for p, n in self.count_steps[-1].items()})
            for opt, group_lrs in zip(optimizers, lrs):
                for group, lr in zip(opt.param_groups, group_lrs):
                    group['lr'] = lr
        self.blur_calls = blur.captured - captured

    def run(self, batches, history=None):
        """A replay for each batch; returns the last step's metrics (and
        appends each step's to ``history`` when given)."""
        algo = self.algo
        for batch in batches:
            for key, static in self.static.items():
                for dst, src in zip(static, batch[key]):
                    if dst.shape != src.shape or dst.dtype != src.dtype:
                        raise ValueError(
                            'a captured step takes {0} {1}, got {2} {3}'
                            .format(key, tuple(dst.shape),
                                    tuple(src.shape), src.dtype))
                    dst.copy_(src, non_blocking=True)
            step = algo.state.step
            algo.step_scalars.refill(self.fns)
            for salt, generator in self.generators.items():
                generator.manual_seed(algo._step_seed(step, salt))
            self.graph.replay()
            algo._host_lrs(step)
            algo.state.step = step + 1
            for opt, counts in zip(self.counted, self.count_steps):
                opt.advance(counts)
            blur.launches += self.blur_calls
            if history is not None:
                history.append({k: v.clone() for k, v in
                                self.outputs.items()})
        return {k: v.clone() for k, v in self.outputs.items()}


class SSLBase(object):
    NAME = 'ssl_base'
    SUPPORTED_TASK_TYPES = []

    def __init__(self, args, ctx):
        self.args = args
        self.ctx = ctx
        self.device = ctx.device
        self.mesh = ctx.mesh
        self.state = None
        self.modules = {}
        self.optimizers = {}
        self.meters = AvgMeterSet()
        self.step_scalars = StepScalars(self.device)
        self._captured = None
        self._capture_generators = None

    def build(self):
        """Initialise the weights from ``--seed``."""
        generator = torch.Generator().manual_seed(int(self.args.seed))
        self.modules = self._build_modules(generator)
        for name, module in self.modules.items():
            module.to(self.device).train()
            parallel.broadcast_module(module, self.mesh)
            if self.mesh.world_size > 1:
                for m in module.modules():
                    if isinstance(m, SyncBatchNorm):
                        m.sync = self.mesh
            logger.log_info('Model `{0}`: {1:,} parameters'.format(
                name, count_params(module)))
        self.optimizers = self._build_optimizers()
        for optimizer in self.optimizers.values():
            if isinstance(optimizer, ChainOptimizer):
                optimizer.step_scalars = self.step_scalars
        self.state = TrainState(self.args.seed)
        return self.state

    @property
    def steps_per_dispatch(self):
        return max(1, int(getattr(self.args, 'steps_per_dispatch', 1) or 1))

    def _build_modules(self, generator):
        """Create and initialise the modules; returns {name: module}."""
        raise NotImplementedError

    def _build_optimizers(self):
        """Create the optimizers; returns {name: optimizer}."""
        raise NotImplementedError

    def train_step(self, batch):
        """One train step on ``{'inp': (...), 'gt': (...)}``; returns the
        metrics as 0-d float32 tensors."""
        with self._step_context(batch):
            metrics = self._step_fn(self.ctx.task_func.device_prep(batch))
        self.state.step += 1
        return metrics

    def _step_context(self, batch):
        """``spatial.sharded`` over the grid at the batch's global height
        under ``--spatial-train``; nothing otherwise."""
        if not self.mesh.spatial:
            return contextlib.nullcontext()
        if batch.get('height') is None:
            raise ValueError('a --spatial-train batch carries its global '
                             'height (batch["height"])')
        return spatial.sharded(self.mesh, batch['height'])

    def train_steps(self, batches, history=None):
        """``len(batches)`` train steps in one dispatch (``--steps-per-
        dispatch``); returns the last one's metrics. On the card the
        first call runs one eager step that counts, on a side stream
        (cuDNN's autotuning, the optimizer's state, the allocator's
        blocks), then captures the step into a CUDA graph
        (``CapturedStep``); every other step is a replay. On the CPU each
        step runs eagerly with its host numbers as tensors (the captured
        step's arithmetic). Nothing falls back: a failed capture raises.
        ``history``, a list, gets every step's metrics."""
        batches = list(batches)
        if self.device.type != 'cuda':
            return self._tensor_steps(batches, history)
        metrics = None
        if self._captured is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                metrics = self.train_step(batches[0])
            torch.cuda.current_stream(self.device).wait_stream(side)
            if history is not None:
                history.append(metrics)
            self._captured = CapturedStep(self, batches[0])
            batches = batches[1:]
        if batches:
            metrics = self._captured.run(batches, history)
        return metrics

    def _tensor_steps(self, batches, history=None):
        for batch in batches:
            step = self.state.step
            self.step_scalars.begin()
            try:
                metrics = self.train_step(batch)
            finally:
                self.step_scalars.end()
            self._host_lrs(step)
            if history is not None:
                history.append({k: v.clone() for k, v in metrics.items()})
        return {k: v.clone() for k, v in metrics.items()}

    def _host_lrs(self, step):
        """Each optimizer group's lr the number an eager step ``step``
        leaves there (``_set_lr``'s functions), in place of a tensor of a
        step run in tensor mode."""
        now, self.state.step = self.state.step, step
        try:
            for opt in self.optimizers.values():
                for group, fn in zip(opt.param_groups, opt.lr_fns or ()):
                    group['lr'] = fn()
        finally:
            self.state.step = now

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

    def _step_seed(self, step, salt=0):
        seq = np.random.SeedSequence(parallel.fold_rng(
            [self.state.seed, int(step) * 131 + int(salt)], self.mesh))
        return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))

    def _step_rng(self, step, salt=0):
        """A generator on the algorithm's device for step ``step``, seeded
        from ``(seed, step * 131 + salt)`` as the JAX package folds its key
        (ssl_base.py:173-175), and the rank where several draw; the draws
        themselves differ from JAX's.
        While the step is captured: the graph's generator of ``salt``,
        which ``CapturedStep.run`` seeds so before each replay."""
        if self._capture_generators is not None:
            if salt not in self._capture_generators:
                raise ValueError('no captured generator for salt {0}'
                                 .format(salt))
            return self._capture_generators[salt]
        return torch.Generator(device=self.device).manual_seed(
            self._step_seed(step, salt))

    def _scalar(self, fn):
        """``fn()``, a number of this step computed on the host from
        ``self.state``, as the step takes it (``StepScalars``)."""
        return self.step_scalars.get(fn)

    def _metric(self, fn):
        """``_scalar(fn)`` as a 0-d float32 metric tensor."""
        value = self._scalar(fn)
        if torch.is_tensor(value):
            return value
        return torch.tensor(value, dtype=torch.float32)

    def _set_lr(self, optimizer, schedule):
        """Each group's lr = ``schedule(step) * lr_mult`` before the
        optimizer's step (``nn.optimizer.set_lr``); returns the step's lr
        as a metric."""
        fns = [lambda m=group.get('lr_mult', 1.0):
               schedule(self.state.step) * m
               for group in optimizer.param_groups]
        for group, fn in zip(optimizer.param_groups, fns):
            group['lr'] = self._scalar(fn)
        optimizer.lr_fns = fns
        return self._metric(lambda: schedule(self.state.step))

    def _rampup(self, epochs, scale):
        """The ramp-up of ``epochs`` epochs at this step times ``scale``
        (``nn.func.sigmoid_rampup``), one host number."""
        length = self.ctx.iters_per_epoch * max(epochs, 0)
        return self._scalar(
            lambda: sigmoid_rampup(self.state.step, length) * scale)

    def _ema_decay(self, ema_decay):
        """(decay, 1 - decay) of this step's EMA, decay = ``min(1 -
        1/(step+1), ema_decay)``, host numbers."""
        def decay():
            return min(1.0 - 1.0 / (self.state.step + 1.0), ema_decay)
        return self._scalar(decay), self._scalar(lambda: 1.0 - decay())

    def _ema_update(self, teacher, student, ema_decay):
        """The teacher's parameters move to the student's
        (``ema_update``) with this step's ``_ema_decay``."""
        ema_update(teacher.parameters(), student.parameters(),
                   *self._ema_decay(ema_decay))

    def _global_mean(self, vec):
        """Mean of a per-sample vector over every rank's samples, ``Σ local
        / Σ_ranks count`` (JAX ssl_base.py:180-185). Its value is the same
        on every rank; its gradient is this rank's share, ``1 / Σ count``
        a sample, which ``_apply_updates`` sums over the ranks. Under
        ``--spatial-train`` ``vec`` holds shares, summed over every rank,
        and the samples count on the ranks of spatial coordinate 0 only
        (the data axis)."""
        if not self.mesh.distributed:
            return vec.mean()
        local = vec.sum()
        count = torch.full((), float(vec.shape[0]) if
                           self.mesh.spatial_rank == 0 else 0.0,
                           dtype=local.dtype, device=local.device)
        total = parallel.psum_if_parallel(
            torch.stack([local.detach(), count]), self.mesh)
        return (local + (total[0] - local.detach())) / total[1]

    def _global_draw(self, x, draw):
        """``draw(shape)`` at the global batch's shape of ``x`` (this
        rank's samples and rows of a [N,C,H,W] batch) under
        ``--spatial-train``, of which this rank's samples and rows are kept
        (slices: a captured step copies nothing from the host); ``draw(x's
        shape)`` otherwise."""
        if not self.mesh.spatial:
            return draw(x.shape)
        rows = spatial.active()
        full = self._global_samples(lambda n: draw(
            (n, x.shape[1], rows.height, x.shape[3])))
        r0, r1 = spatial.local_rows(rows.height, self.mesh)
        return full[:, :, r0:r1]

    def _global_samples(self, draw):
        """``draw(n)``, a draw of ``n`` samples, at the global batch's
        ``n`` under ``--spatial-train``, of which this rank keeps the
        samples of its data coordinate (``spatial.local_samples``);
        ``draw(this rank's n)`` otherwise."""
        lbs, ubs = self.ctx.lbs, self.ctx.ubs or 0
        if not self.mesh.spatial:
            return draw(lbs + ubs)
        n = self.mesh.data_size
        full = draw((lbs + ubs) * n)
        blocks = [full[a:b] for a, b in spatial.local_samples(
            lbs * n, ubs * n, self.mesh, spatial.pairs_unlabeled(self.args))
            if b > a]
        return torch.cat(blocks)

    def _apply_updates(self, optimizer, loss, params):
        """Gradient of ``loss`` for ``params`` only, summed over the ranks
        in one flat all-reduce, then one optimizer step; other leaves of
        the graph gather no gradient."""
        params = list(params)
        optimizer.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        parallel.all_reduce_grads(params, self.mesh)
        optimizer.step()

    # ------------------------------------------------------------------
    # the epoch loop (JAX ssl_base.py:207-285)
    # ------------------------------------------------------------------

    def train(self, data_loader, epoch):
        """One epoch: a ``train_step`` for each batch of ``data_loader``,
        or with ``--steps-per-dispatch`` n > 1 a ``train_steps`` for each n
        of them (``_train_multi``). The metrics come to the host (a device
        sync) only every ``--log-freq`` iterations and on the last one,
        where they feed the meters, the iteration's log line and a
        ``metrics.jsonl`` record. The record also carries ``batch_time``,
        the wall time per iteration since the last such point, and
        ``data_time``, the part of it spent waiting for the loader (host
        clock; the device runs ahead of the host between syncs).
        ``--profile-dir`` traces steps [1, 1 + ``--profile-steps``] of
        epoch 0 (``utils.profiler.ProfileWindow``). ``--visualize``: every
        ``--visual-freq`` iterations ``idx`` (from 0), the PNGs
        ``<epoch>_<idx>_*`` of the batch (``_visualize``)."""
        if self.steps_per_dispatch > 1:
            return self._train_multi(data_loader, epoch)
        self.meters.reset()
        n_batches = len(data_loader)
        log_freq = max(1, self.args.log_freq)
        prof = profiler.ProfileWindow(self.args, epoch, self.device)
        timer = profiler.StepTimer()
        for idx, batch in enumerate(data_loader):
            timer.host_done()
            prof.tick(idx)
            metrics = self.train_step(batch)
            if self._visual_due(idx):
                self._visualize(batch, '{0}_{1}'.format(epoch, idx))
            due = (idx + 1) % log_freq == 0 or idx == n_batches - 1
            self._step_done(epoch, idx + 1, n_batches, metrics, timer, 1, due)
        prof.close()
        return self.meters

    def _train_multi(self, data_loader, epoch):
        """The multi-step path (JAX ``_train_multi``): the batches of
        ``data_loader`` grouped n a dispatch (``nn.loader.chunked``), each
        chunk one ``train_steps``; a tail of fewer than n batches takes the
        eager single step. The metrics of a dispatch are its last step's,
        logged when the dispatch reaches a multiple of ``--log-freq`` and
        at the epoch's end; the profiler's window counts dispatches.
        ``--visualize``: a dispatch that passes a multiple of
        ``--visual-freq`` visualizes its last batch as ``<epoch>_<done>``,
        after the replays; the tail's single steps do not (JAX
        ``_train_multi``)."""
        self.meters.reset()
        n = self.steps_per_dispatch
        n_batches = len(data_loader)
        log_freq = max(1, self.args.log_freq)
        prof = profiler.ProfileWindow(self.args, epoch, self.device)
        timer = profiler.StepTimer()
        done = dispatches = 0
        for kind, payload in nnloader.chunked(data_loader, n):
            timer.host_done()
            if kind == 'chunk':
                prof.tick(dispatches)
                dispatches += 1
                metrics = self.train_steps(payload)
                steps = len(payload)
                done += steps
                if self._visual_due(done, steps):
                    self._visualize(payload[-1],
                                    '{0}_{1}'.format(epoch, done))
                due = done % max(log_freq, n) < n
            else:
                metrics = self.train_step(payload)
                steps = 1
                done += 1
                due = done % log_freq == 0
            self._step_done(epoch, done, n_batches, metrics, timer, steps,
                            due or done >= n_batches)
        prof.close()
        return self.meters

    def _visual_due(self, idx, steps=1):
        """Whether the iterations up to ``idx`` (the last ``steps`` of
        them) reach a multiple of ``--visual-freq``, with ``--visualize``
        and its train folder set, on rank 0 (which alone writes them) and,
        under ``--spatial-train``, the other ranks of its spatial group,
        whose rows its eval forward exchanges."""
        args = self.args
        return (bool(getattr(args, 'visualize', False)) and
                bool(getattr(args, 'visual_train_path', '')) and
                (self.mesh.data_rank if self.mesh.spatial else
                 self.mesh.rank) == 0 and
                idx % max(1, args.visual_freq) < steps)

    @contextlib.contextmanager
    def _evaluating(self):
        """Every module in eval mode and no gradient inside the block; back
        in train mode after it."""
        for module in self.modules.values():
            module.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            for module in self.modules.values():
                module.train()

    def _visualize(self, batch, name):
        """The PNGs of a train batch's first sample under
        ``--visual-train-path``/``name``: the eval forward of ``_eval_fn``
        (every model: input, prediction, GT) and ``_debug_visualize`` (JAX
        ssl_base.py:246-264). It runs eagerly, outside any CUDA graph, and
        reads the maps to the host. Under ``--spatial-train`` it runs
        row-sharded on every rank of rank 0's spatial group, which gathers
        the sample's rows (``_first``) for rank 0 to write."""
        task_func = self.ctx.task_func
        out = os.path.join(self.args.visual_train_path, name)
        batch = task_func.device_prep(batch)
        with self._evaluating(), self._step_context(batch):
            for model_id, (activated_pred, _) in self._eval_fn(batch).items():
                self._write(task_func.visualize, out, id_str=model_id,
                            inp=_first(batch['inp']),
                            pred=_first(activated_pred),
                            gt=_first(batch['gt']))
            self._debug_visualize(batch, out)

    def _write(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, a PNG writer, on rank 0 only."""
        if self.mesh.rank == 0:
            fn(*args, **kwargs)

    def _debug_visualize(self, batch, out_path):
        """Maps of the algorithm's own beside the input, prediction and GT
        PNGs (JAX ssl_base.py:152; AdvSSL's confidence maps, GCT's
        flawmaps and pseudo-GT), written through ``_write`` from the first
        sample's whole rows (``_first``). Runs in eval mode without
        gradient, inside the step's spatial context. Base: nothing."""

    def _step_done(self, epoch, done, n_batches, metrics, timer, steps, due):
        """``steps`` steps queued, ``done`` of the epoch. When ``due``, the
        metrics come to the host: the meters, the iteration's log line and
        its ``metrics.jsonl`` record with the timer's means since the last
        such point, and the timer starts anew."""
        if not due:
            timer.step_done(steps)
            return
        values = {k: v.item() for k, v in metrics.items()}
        timer.step_done(steps)
        times = {'batch_time': timer.mean_step + timer.mean_data,
                 'data_time': timer.mean_data}
        timer.reset()
        self.meters.update_dict(values)
        self.meters.update_dict(times)
        logger.log_info('epoch {0:>3} iter {1:>5}/{2:<5} {3}'.format(
            epoch, done, n_batches, '  '.join(
                '{0}: {1:.5f}'.format(k, v)
                for k, v in sorted(values.items()))))
        self._log_jsonl(dict(values, phase='train', epoch=epoch, iter=done,
                             algorithm=self.NAME, **times))

    def log_epoch_summary(self, epoch, wall_s, n_iters):
        """The epoch's samples/s through the whole loop (loader, copies to
        the device, steps), logged and written to ``metrics.jsonl``."""
        n_chips = self.mesh.world_size
        sps = n_iters * int(self.args.batch_size) / max(wall_s, 1e-9)
        logger.log_info(
            'epoch {0:>3} done: {1} iters in {2:.1f}s, {3:.1f} samples/s '
            '({4:.1f}/chip x {5} chips), avg step {6:.3f}s'.format(
                epoch, n_iters, wall_s, sps, sps / n_chips, n_chips,
                wall_s / max(1, n_iters)))
        self._log_jsonl(dict(
            phase='epoch_summary', epoch=epoch, algorithm=self.NAME,
            wall_s=round(wall_s, 3), iters=n_iters,
            samples_per_sec=round(sps, 2),
            samples_per_sec_per_chip=round(sps / n_chips, 2),
            n_chips=n_chips))

    # ------------------------------------------------------------------
    # validation (JAX ssl_base.py:396-445)
    # ------------------------------------------------------------------

    def validate(self, data_loader, epoch):
        """Score every model of ``_eval_fn`` on ``data_loader``'s batches;
        returns ``{metric key: value}``. A batch may carry a ``valid``
        mask [N] that weights its per-sample losses. A loader whose
        ``sharded`` is true gives each rank its share of the samples: a
        batch's loss is ``Σ(loss·valid) / max(Σvalid, 1)`` over every
        rank's samples, and the confusion matrices are summed over the
        ranks of its ``group`` (every rank by default; the data axis under
        ``--spatial-train``) (JAX ssl_base.py:396-445). A loader with a
        ``spatial_mesh`` (``--spatial-val``) gives every rank its rows of
        the same sample: the eval forward runs row-sharded, the loss
        shares and the confusion matrices are summed over the ranks, and
        the sample counts once. ``--visualize``: rank 0 writes the
        PNGs of its batch's first sample every ``--visual-freq``
        batches; under ``--spatial-val`` every rank sends its rows of the
        sample to rank 0 first (``_first``: the padded sample, as the JAX
        package writes it)."""
        self.meters = AvgMeterSet()  # no stale training keys
        task_func = self.ctx.task_func
        args = self.args
        reduce = None
        if getattr(data_loader, 'sharded', False):
            group = getattr(data_loader, 'group', None)

            def reduce(tensor):
                return parallel.psum_if_parallel(tensor, self.mesh, group)
        # --spatial-val: each rank holds rows of the batch's sample; the
        # losses are shares, and the sample counts on spatial rank 0
        rows_mesh = getattr(data_loader, 'spatial_mesh', None)
        counts = rows_mesh is None or rows_mesh.spatial_rank == 0
        visual = (bool(getattr(args, 'visualize', False)) and
                  bool(getattr(args, 'visual_val_path', '')) and
                  (self.mesh.rank == 0 or rows_mesh is not None))
        with self._evaluating():
            for idx, batch in enumerate(data_loader):
                batch = task_func.device_prep(batch)
                valid = batch.get('valid')
                with (spatial.sharded(rows_mesh, batch['height'])
                      if rows_mesh is not None else
                      contextlib.nullcontext()):
                    scored = self._eval_fn(batch)
                    if visual and idx % max(1, args.visual_freq) == 0:
                        out = os.path.join(args.visual_val_path,
                                           '{0}_{1}'.format(epoch, idx))
                        for model_id, (activated_pred, _) in scored.items():
                            self._write(task_func.visualize, out,
                                        id_str=model_id,
                                        inp=_first(batch['inp']),
                                        pred=_first(activated_pred),
                                        gt=_first(batch['gt']))
                for model_id, (activated_pred, loss_vec) in scored.items():
                    if valid is not None:
                        v = valid.to(loss_vec)
                        sums = torch.stack([(loss_vec * v).sum(),
                                            v.sum() if counts else
                                            v.sum() * 0])
                        if reduce is not None:
                            sums = reduce(sums)
                        loss = sums[0] / sums[1].clamp(min=1.0)
                    else:
                        loss = loss_vec.mean()
                    self.meters.update('{0}_loss'.format(model_id),
                                       float(loss))
                    task_func.metrics(activated_pred, batch['gt'],
                                      batch['inp'], self.meters,
                                      id_str=model_id, reduce=reduce)

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
        ``--checkpoint-path`` (nothing without one), on rank 0."""
        path = getattr(self.args, 'checkpoint_path', '')
        if not path or self.mesh.rank != 0:
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
        is replaced. Rank 0 writes it, between barriers of every rank: no
        rank goes on before the file is whole. Returns the path."""
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
        parallel.barrier(self.mesh)
        if self.mesh.rank == 0:
            tmp = path + '.tmp'
            torch.save(payload, tmp)
            os.replace(tmp, path)
            logger.log_info('Saved checkpoint: {0}'.format(path))
        parallel.barrier(self.mesh)
        return path

    def load_checkpoint(self, path=None):
        """Restore a checkpoint of ``save_checkpoint`` (``path`` or
        ``--resume``) into the built algorithm, each tensor onto this
        rank's device; refuses one that another algorithm wrote. Returns
        its epoch."""
        path = os.path.abspath(path or self.args.resume)
        # on the host first: ``load_state_dict`` moves each module's and
        # optimizer's tensors to their parameters' device, and leaves on
        # the host what a fresh optimizer keeps there (Adam's step count)
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
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
        # the optimizers' state tensors are new: a captured step would
        # update the old ones, so the next dispatch captures again
        self._captured = None
        self.state.step = int(ckpt['step'])
        self.state.seed = int(ckpt['seed'])
        logger.log_info('Loaded checkpoint: {0} (epoch {1})'.format(
            path, ckpt['epoch']))
        return int(ckpt['epoch'])


def _first(tensors, h_dim=None):
    """The first sample of each tensor of a tuple; inside a spatial
    context its whole map on spatial rank 0, which writes it, every rank's
    rows of it fetched along ``h_dim`` (by default the second-to-last axis:
    NCHW maps, [N,H,W] labels; ``spatial.whole_rows``), and no rows on the
    other ranks."""
    return tuple(spatial.whole_rows(
        t[:1], t.dim() - 2 if h_dim is None else h_dim, to=0)
        for t in tensors)


def save_gray_map(arr, path):
    """A 0-1 map, [1,1,H,W]/[1,H,W,1]/[H,W]-like, as an 8-bit gray PNG:
    clipped to [0, 1], times 255, truncated to uint8 (JAX
    ssl_base.py:539-546; the reference's D confidence maps and flawmaps,
    ssl_adv.py:402-408)."""
    if torch.is_tensor(arr):
        arr = arr.detach().float().cpu().numpy()
    a = np.asarray(arr).astype(np.float32)
    while a.ndim > 2:
        a = a[0] if a.shape[0] == 1 else a[..., 0]
    imageio.write_png(path, (np.clip(a, 0.0, 1.0) * 255).astype('uint8'))


@torch.no_grad()
def ema_update(t_params, s_params, decay, rest=None):
    """Teacher <- decay * teacher + rest * student, ``rest`` = 1 - decay
    unless given, in place, in float32 whatever the teacher's storage
    dtype; the result is rounded back to it (JAX ssl_base.py:517-527).
    ``decay`` and ``rest`` are numbers, or 0-d tensors in a captured
    step (``StepScalars``)."""
    if rest is None:
        rest = 1.0 - decay
    t_params = list(t_params)
    work = [t.float() for t in t_params]  # float32 leaves: the same tensor
    students = [s.float() for s in s_params]
    torch._foreach_mul_(work, decay)
    if torch.is_tensor(rest):
        # w + s * rest in one rounding, as the alpha form below computes it
        torch._foreach_addcmul_(work, students, [rest] * len(students))
    else:
        torch._foreach_add_(work, students, alpha=rest)
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


def forward_with_float32_params(module, inp, enabled):
    """``module(inp)``; when ``enabled`` (an EMA teacher stored in bf16),
    on float32 copies of its parameters."""
    if not enabled:
        return module(inp)
    params = {k: p.float() for k, p in module.named_parameters()}
    return functional_call(module, params, (inp,))
