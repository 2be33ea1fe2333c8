"""Learning-rate schedules (counterpart of ``pixelssl_tpu/nn/lrer.py``;
reference pixelssl/nn/lrer.py:143-179), as far as this slice uses them.

A schedule is a function of the global iteration count; the algorithm
evaluates it before each optimizer step, before the step counter moves.
Every flag of the JAX package's schedules parses, so that a script that
sets one (the AdvSSL recipe's vestigial ``milestones``/``gamma``) is not
warned about; only ``polynomiallr`` is ported, and any other schedule
stops as unknown.
"""

from ..utils import cmd


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
    ``schedule(step) -> lr``."""

    def __init__(self, name, build_fn):
        self.name = name
        self._build_fn = build_fn

    def make(self, base_lr, iters_per_epoch, total_epochs):
        return self._build_fn(base_lr, iters_per_epoch, total_epochs)


def polynomiallr(args):
    """lr = base * (1 - iter/max_iters)^power, per iteration."""
    power = _default(args.power, 0.9)

    def build(base_lr, iters_per_epoch, total_epochs):
        max_iters = max(1, iters_per_epoch * total_epochs)

        def schedule(step):
            frac = min(max(1.0 - step / max_iters, 0.0), 1.0)
            return base_lr * frac ** power
        return schedule

    return LRSchedulerFactory('polynomiallr', build)

