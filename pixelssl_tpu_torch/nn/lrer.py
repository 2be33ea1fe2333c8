"""Learning-rate schedules (counterpart of ``pixelssl_tpu/nn/lrer.py``;
reference pixelssl/nn/lrer.py:14-179).

A schedule is a function of the global iteration count; the algorithm
evaluates it before each optimizer step, before the step counter moves.
The epoch-wise schedules (``EPOCH_LRERS``) quantise the step to
``step // iters_per_epoch``, so that their lr changes at epoch boundaries
as the reference's per-epoch ``.step()`` does; ``polynomiallr`` is the one
iteration-wise schedule. The proxy refuses a run whose components mix the
two kinds.
"""

import math

from ..utils import cmd, logger

EPOCH_LRERS = ['steplr', 'multisteplr', 'exponentiallr', 'cosineannealinglr']
ITER_LRERS = ['polynomiallr']
VALID_LRER = EPOCH_LRERS + ITER_LRERS


def add_parser_arguments(parser):
    """Flags match the JAX package's (its nn/lrer.py:23-38)."""
    parser.add_argument('--last-epoch', type=int, default=-1, metavar='',
                        help='lrer - index of last epoch (resume)')
    parser.add_argument('--step-size', type=int, default=-1, metavar='',
                        help='lrer - period of lr decay (steplr)')
    parser.add_argument('--milestones', type=cmd.str2intlist, default=[],
                        metavar='',
                        help='lrer - epoch milestones (multisteplr)')
    parser.add_argument('--gamma', type=float, default=-1, metavar='',
                        help='lrer - multiplicative decay factor')
    parser.add_argument('--T-max', type=int, default=-1, metavar='',
                        help='lrer - max iteration count (cosineannealinglr)')
    parser.add_argument('--eta-min', type=float, default=-1, metavar='',
                        help='lrer - minimum lr (cosineannealinglr)')
    parser.add_argument('--power', type=float, default=-1, metavar='',
                        help='lrer - polynomial decay power (polynomiallr)')


def _default(value, default):
    return default if value is None or value == -1 else value


class LRSchedulerFactory(object):
    """``make(base_lr, iters_per_epoch, total_epochs)`` returns
    ``schedule(step) -> lr``; ``kind`` is ``'epoch'`` or ``'iter'``."""

    def __init__(self, name, kind, build_fn):
        self.name = name
        self.kind = kind
        self._build_fn = build_fn

    @property
    def is_epoch_lrer(self):
        return self.kind == 'epoch'

    def make(self, base_lr, iters_per_epoch, total_epochs):
        return self._build_fn(base_lr, iters_per_epoch, total_epochs)


def steplr(args):
    """lr = base * gamma^(epoch // step_size) (reference lrer.py:51-66)."""
    step_size = _default(args.step_size, None)
    gamma = _default(args.gamma, 0.1)
    if step_size is None:
        logger.log_err('steplr requires --step-size')

    def build(base_lr, iters_per_epoch, total_epochs):
        def schedule(step):
            epoch = step // iters_per_epoch
            return base_lr * gamma ** (epoch // step_size)
        return schedule

    return LRSchedulerFactory('steplr', 'epoch', build)


def multisteplr(args):
    """lr = base * gamma^(the milestones that epoch >=) (reference
    lrer.py:69-84)."""
    milestones = list(args.milestones or [])
    gamma = _default(args.gamma, 0.1)
    if not milestones:
        logger.log_err('multisteplr requires --milestones')

    def build(base_lr, iters_per_epoch, total_epochs):
        def schedule(step):
            epoch = step // iters_per_epoch
            return base_lr * gamma ** sum(epoch >= m for m in milestones)
        return schedule

    return LRSchedulerFactory('multisteplr', 'epoch', build)


def exponentiallr(args):
    """lr = base * gamma^epoch (reference lrer.py:87-100)."""
    gamma = _default(args.gamma, None)
    if gamma is None:
        logger.log_err('exponentiallr requires --gamma')

    def build(base_lr, iters_per_epoch, total_epochs):
        def schedule(step):
            return base_lr * gamma ** (step // iters_per_epoch)
        return schedule

    return LRSchedulerFactory('exponentiallr', 'epoch', build)


def cosineannealinglr(args):
    """Cosine annealing over ``T_max`` epochs, ``epochs`` when unset
    (reference lrer.py:103-119)."""
    eta_min = _default(args.eta_min, 0.0)
    t_max = _default(args.T_max, None)

    def build(base_lr, iters_per_epoch, total_epochs):
        period = t_max if t_max is not None else total_epochs

        def schedule(step):
            epoch = step // iters_per_epoch
            return eta_min + 0.5 * (base_lr - eta_min) * (
                1.0 + math.cos(math.pi * epoch / period))
        return schedule

    return LRSchedulerFactory('cosineannealinglr', 'epoch', build)


def polynomiallr(args):
    """lr = base * (1 - iter/max_iters)^power, per iteration (reference
    lrer.py:143-179)."""
    power = _default(args.power, 0.9)

    def build(base_lr, iters_per_epoch, total_epochs):
        max_iters = max(1, iters_per_epoch * total_epochs)

        def schedule(step):
            frac = min(max(1.0 - step / max_iters, 0.0), 1.0)
            return base_lr * frac ** power
        return schedule

    return LRSchedulerFactory('polynomiallr', 'iter', build)


_REGISTRY = {
    'steplr': steplr,
    'multisteplr': multisteplr,
    'exponentiallr': exponentiallr,
    'cosineannealinglr': cosineannealinglr,
    'polynomiallr': polynomiallr,
}


def get(name):
    if name not in _REGISTRY:
        logger.log_err('Unknown lrer `{0}`. Valid: {1}'.format(
            name, VALID_LRER))
    return _REGISTRY[name]
