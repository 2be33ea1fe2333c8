"""Optimizers (counterpart of ``pixelssl_tpu/nn/optimizer.py``; reference
pixelssl/nn/optimizer.py:57-75), as far as this slice uses them.

``sgd`` is ``torch.optim.SGD``: weight decay is added to the gradient, the
momentum buffer is a plain trace (the first step stores the gradient). Each
param group carries an ``lr_mult`` (backbone 1x, head 10x); the algorithm
sets ``group['lr'] = schedule(step) * lr_mult`` before every step.
"""

import torch

from ..utils import cmd, logger


def add_parser_arguments(parser):
    parser.add_argument('--lr', type=float, default=-1, metavar='',
                        help='optimizer - base learning rate')
    parser.add_argument('--dampening', type=float, default=-1, metavar='',
                        help='optimizer - dampening for momentum (sgd)')
    parser.add_argument('--nesterov', type=cmd.str2bool, default=False,
                        metavar='', help='optimizer - nesterov momentum (sgd)')
    parser.add_argument('--weight-decay', type=float, default=-1, metavar='',
                        help='optimizer - weight decay')
    parser.add_argument('--momentum', type=float, default=-1, metavar='',
                        help='optimizer - momentum factor (sgd)')
    # the JAX package's other optimizer flags: they parse, and any value
    # but the default is refused (UNPORTED_FLAGS)
    parser.add_argument('--alpha', type=float, default=-1, metavar='',
                        help='optimizer - smoothing constant (rmsprop; '
                             'ROADMAP A3c)')
    parser.add_argument('--centered', type=cmd.str2bool, default=False,
                        metavar='', help='optimizer - centered rmsprop '
                                         '(ROADMAP A3c)')
    parser.add_argument('--eps', type=float, default=-1, metavar='',
                        help='optimizer - numerical-stability epsilon '
                             '(ROADMAP A3c)')
    parser.add_argument('--beta1', type=float, default=-1, metavar='',
                        help='optimizer - adam beta1 (ROADMAP A3c)')
    parser.add_argument('--beta2', type=float, default=-1, metavar='',
                        help='optimizer - adam beta2 (ROADMAP A3c)')
    parser.add_argument('--amsgrad', type=cmd.str2bool, default=False,
                        metavar='', help='optimizer - amsgrad (adam / wdadam; '
                                         'ROADMAP A3c)')
    parser.add_argument('--clip-grad-norm', type=float, default=-1,
                        metavar='', help='optimizer - clip gradients to this '
                                         'global L2 norm (ROADMAP A3c)')
    parser.add_argument('--bf16-opt-state', type=cmd.str2bool, default=False,
                        metavar='', help='optimizer - bf16 optimizer state '
                                         '(ROADMAP A3c)')


# (flag, its default, the ROADMAP item that ports it): any value but the
# default is refused by the proxy
UNPORTED_FLAGS = tuple((name, default, 'A3c') for name, default in (
    ('alpha', -1), ('centered', False), ('eps', -1), ('beta1', -1),
    ('beta2', -1), ('amsgrad', False), ('clip_grad_norm', -1),
    ('bf16_opt_state', False)))


def _default(value, default):
    return default if value is None or value == -1 else value


class OptimizerFactory(object):
    """``make(param_groups)`` builds the optimizer once the task model's
    groups are known."""

    def __init__(self, name, build_fn, base_lr):
        self.name = name
        self._build_fn = build_fn
        self.base_lr = base_lr

    def make(self, param_groups):
        return self._build_fn(param_groups)


def set_lr(optimizer, lr):
    """``lr`` times each group's ``lr_mult``."""
    for group in optimizer.param_groups:
        group['lr'] = lr * group.get('lr_mult', 1.0)


def sgd(args):
    lr = _default(args.lr, None)
    if lr is None:
        logger.log_err('sgd optimizer requires --lr')
    momentum = _default(args.momentum, 0.0)
    dampening = _default(args.dampening, 0.0)
    weight_decay = _default(args.weight_decay, 0.0)
    nesterov = bool(args.nesterov)

    def build(param_groups):
        return torch.optim.SGD(param_groups, lr=lr, momentum=momentum,
                               dampening=dampening,
                               weight_decay=weight_decay, nesterov=nesterov)

    return OptimizerFactory('sgd', build, lr)

