"""Optimizers (counterpart of ``pixelssl_tpu/nn/optimizer.py``; reference
pixelssl/nn/optimizer.py:16-247): ``sgd``, ``rmsprop``, ``adam`` and
``wdadam``, with ``--clip-grad-norm`` and ``--bf16-opt-state``.

The JAX package builds each as an optax chain, and the port follows optax's
arithmetic where it differs from ``torch.optim``'s. ``ChainOptimizer`` is
that chain as a ``torch.optim.Optimizer``, its update math in float32
``torch._foreach_*`` ops:

* ``sgd``: weight decay added to the gradient, then a momentum trace
  ``buf = m*buf + s*g`` whose first step stores ``g`` (``s`` is
  ``1 - dampening`` after the first step, else 1), the update ``buf``, or
  ``g + m*buf`` with nesterov (``optax.trace`` and the JAX package's
  ``_torch_momentum``; ``torch.optim.SGD`` computes the same);
* ``rmsprop``: weight decay added to the gradient,
  ``nu = a*nu + (1-a)*g^2`` and the update ``g / sqrt(nu + eps)``, eps
  inside the root (``optax.scale_by_rms``; ``torch.optim.RMSprop`` puts it
  outside); centered, ``g / sqrt(nu - mu^2 + eps)`` with
  ``mu = a*mu + (1-a)*g`` (``optax.scale_by_stddev``); momentum, a trace
  of that update;
* ``adam``: weight decay added to the gradient, then
  ``mu_hat / (sqrt(nu_hat) + eps)`` on the bias-corrected moments
  (``optax.scale_by_adam``; ``--amsgrad`` is not read, as in the JAX
  package);
* ``wdadam``: the same update plus ``wd * p``, decoupled from the moments
  (``p -= lr * (adam_update + wd * p)``, reference optimizer.py:243); with
  ``--amsgrad`` the update divides by the running maximum of the
  *bias-corrected* second moment, as ``optax.scale_by_amsgrad`` keeps it
  (``torch.optim.AdamW`` keeps the maximum of the raw moment instead).

With ``--clip-grad-norm`` > 0 the raw gradients of the optimizer's own
parameters are scaled by ``max / norm`` where their global L2 norm is at
least ``max``, before weight decay (``optax.clip_by_global_norm``, no
epsilon). With ``--bf16-opt-state`` the momentum buffers and moments are
stored in bf16: each step reads them as float32, updates in float32 and
rounds the new state back (the JAX package's ``_bf16_state``); the step
count stays an integer, and ``load_state_dict`` keeps the bf16 storage.

Each param group carries an ``lr_mult`` (backbone 1x, head 10x); the
algorithm sets ``group['lr'] = schedule(step) * lr_mult`` before every
step (``set_lr``), which scales the final update as the JAX package's
per-leaf multiplier does. A parameter without a gradient is stepped with a
zero one, as every leaf of an optax tree is.

A step captured into a CUDA graph (``--steps-per-dispatch``) must not
freeze a number that changes from step to step: there a group's ``lr`` is
a 0-d float32 device tensor, and the ``adam`` rules' bias corrections come
from ``scalar(fn)``, which the algorithm's ``StepScalars`` turns into such
a tensor, refilled by the host with ``fn()`` before every replay. Either
way the values are the float32 roundings of the same host numbers, so a
replayed step computes what an eager one does. ``Adam`` is torch's own, a
capturable step on the card.
"""

import numpy as np
import torch

from ..utils import cmd, logger

VALID_OPTIMIZER = ['sgd', 'rmsprop', 'adam', 'wdadam']

# bf16 state is upcast in chunks of about this many elements, so that the
# float32 copies of a step stay small beside the state itself
_BF16_CHUNK = 1 << 22


def add_parser_arguments(parser):
    """Flags match the JAX package's (its nn/optimizer.py:29-67)."""
    parser.add_argument('--lr', type=float, default=-1, metavar='',
                        help='optimizer - base learning rate')
    parser.add_argument('--dampening', type=float, default=-1, metavar='',
                        help='optimizer - dampening for momentum (sgd)')
    parser.add_argument('--nesterov', type=cmd.str2bool, default=False,
                        metavar='', help='optimizer - nesterov momentum (sgd)')
    parser.add_argument('--weight-decay', type=float, default=-1, metavar='',
                        help='optimizer - weight decay')
    parser.add_argument('--momentum', type=float, default=-1, metavar='',
                        help='optimizer - momentum factor (sgd / rmsprop)')
    parser.add_argument('--alpha', type=float, default=-1, metavar='',
                        help='optimizer - smoothing constant (rmsprop)')
    parser.add_argument('--centered', type=cmd.str2bool, default=False,
                        metavar='', help='optimizer - centered rmsprop')
    parser.add_argument('--eps', type=float, default=-1, metavar='',
                        help='optimizer - numerical-stability epsilon')
    parser.add_argument('--beta1', type=float, default=-1, metavar='',
                        help='optimizer - adam beta1')
    parser.add_argument('--beta2', type=float, default=-1, metavar='',
                        help='optimizer - adam beta2')
    parser.add_argument('--amsgrad', type=cmd.str2bool, default=False,
                        metavar='', help='optimizer - amsgrad (wdadam)')
    parser.add_argument('--clip-grad-norm', type=float, default=-1,
                        metavar='', help='optimizer - clip the gradients to '
                                         'this global L2 norm before the '
                                         'update (-1 disables)')
    parser.add_argument('--bf16-opt-state', type=cmd.str2bool, default=False,
                        metavar='', help='optimizer - store momentum buffers '
                                         'and Adam moments in bf16 (the '
                                         'update math stays float32)')


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


def _bias_correction(decay, count):
    """``1 - decay ** count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class ChainOptimizer(torch.optim.Optimizer):
    """One of the four update rules of the module docstring, with the
    clipping and the bf16 state. ``hparams`` are the rule's: ``momentum``,
    ``dampening``, ``nesterov``, ``weight_decay``, ``alpha``, ``centered``,
    ``eps``, ``beta1``, ``beta2``, ``amsgrad``."""

    def __init__(self, params, rule, lr, clip_norm=-1, bf16_state=False,
                 **hparams):
        if rule not in VALID_OPTIMIZER:
            raise ValueError('Unknown update rule {0!r}'.format(rule))
        super(ChainOptimizer, self).__init__(params, dict(lr=lr))
        self.rule = rule
        self.clip_norm = clip_norm
        self.bf16_state = bool(bf16_state)
        self.hp = hparams
        # the algorithm's ``StepScalars`` (``ssl_base``); None: numbers
        self.step_scalars = None
        # each group's lr as a function of the host's state (``ssl_base``)
        self.lr_fns = None

    def scalar(self, fn):
        """``fn()``, a number the host computes from the optimizer's
        state, or while the step is captured its device tensor (module
        docstring)."""
        if self.step_scalars is None:
            return fn()
        return self.step_scalars.get(fn)

    def advance(self, counts):
        """Add ``counts`` ({parameter: n}) to the parameters' update
        counts: the host's record of updates that a CUDA graph replay ran
        without this method's Python."""
        for p, n in counts.items():
            self.state[p]['step'] += n

    def counts(self):
        """{parameter: update count} of every parameter with state."""
        return {p: st['step'] for p, st in self.state.items() if st}

    def state_keys(self):
        """The float state each parameter carries under this rule."""
        hp = self.hp
        if self.rule == 'sgd':
            return ['momentum_buffer'] if hp['momentum'] > 0 else []
        if self.rule == 'rmsprop':
            return (['square_avg'] + (['grad_avg'] if hp['centered'] else [])
                    + (['momentum_buffer'] if hp['momentum'] > 0 else []))
        keys = ['exp_avg', 'exp_avg_sq']
        if self.rule == 'wdadam' and hp['amsgrad']:
            keys.append('max_exp_avg_sq')
        return keys

    def load_state_dict(self, state_dict):
        """``torch.optim.Optimizer.load_state_dict`` casts the floating
        state to the parameters' dtype; bf16 state is cast back."""
        super(ChainOptimizer, self).load_state_dict(state_dict)
        if self.bf16_state:
            for st in self.state.values():
                for key, value in st.items():
                    if torch.is_tensor(value) and value.is_floating_point():
                        st[key] = value.to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError('ChainOptimizer.step takes no closure')
        groups = [(g['lr'], list(g['params'])) for g in self.param_groups]
        params = [p for _, ps in groups for p in ps]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.clip_norm is not None and self.clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        keys = self.state_keys()
        start = 0
        for lr, ps in groups:
            gs = grads[start:start + len(ps)]
            start += len(ps)
            for lo, hi in self._chunks(ps):
                self._update(ps[lo:hi], gs[lo:hi], lr, keys)

    def _chunks(self, params):
        """Index ranges of ``params``: all of them at once, or with bf16
        state runs of about ``_BF16_CHUNK`` elements."""
        if not self.bf16_state:
            return [(0, len(params))] if params else []
        out, lo, size = [], 0, 0
        for i, p in enumerate(params):
            size += p.numel()
            if size >= _BF16_CHUNK or i == len(params) - 1:
                out.append((lo, i + 1))
                lo, size = i + 1, 0
        return out

    def _update(self, params, grads, lr, keys):
        dtype = torch.bfloat16 if self.bf16_state else torch.float32
        stored = {k: [] for k in keys}
        for p in params:
            st = self.state[p]
            if not st:
                st['step'] = 0
                for k in keys:
                    st[k] = torch.zeros_like(p, dtype=dtype)
            for k in keys:
                stored[k].append(st[k])
        count = self.state[params[0]]['step']
        work = {k: ([t.float() for t in v] if self.bf16_state else v)
                for k, v in stored.items()}

        update = getattr(self, '_' + self.rule)(params, grads, work, count)
        torch._foreach_add_(params, torch._foreach_mul(update, -lr))

        if self.bf16_state:
            for k in keys:
                torch._foreach_copy_(stored[k], work[k])
        for p in params:
            self.state[p]['step'] = count + 1

    def _sgd(self, params, grads, work, count):
        # ``count`` is read at capture, never 0 there (a graph is captured
        # after an eager step): the dampening scale is fixed from then on
        hp = self.hp
        if hp['weight_decay'] > 0:
            grads = torch._foreach_add(grads, params,
                                       alpha=hp['weight_decay'])
        if hp['momentum'] <= 0:
            return grads
        buf = work['momentum_buffer']
        scale = 1.0 if count == 0 or hp['dampening'] <= 0 else (
            1.0 - hp['dampening'])
        torch._foreach_mul_(buf, hp['momentum'])
        torch._foreach_add_(buf, grads, alpha=scale)
        if hp['nesterov']:
            return torch._foreach_add(grads, buf, alpha=hp['momentum'])
        return buf

    def _rmsprop(self, params, grads, work, count):
        hp = self.hp
        alpha = hp['alpha']
        if hp['weight_decay'] > 0:
            grads = torch._foreach_add(grads, params,
                                       alpha=hp['weight_decay'])
        nu = work['square_avg']
        torch._foreach_mul_(nu, alpha)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - alpha)
        if hp['centered']:
            mu = work['grad_avg']
            torch._foreach_mul_(mu, alpha)
            torch._foreach_add_(mu, grads, alpha=1.0 - alpha)
            denom = torch._foreach_addcmul(nu, mu, mu, value=-1.0)
            torch._foreach_add_(denom, hp['eps'])
        else:
            denom = torch._foreach_add(nu, hp['eps'])
        torch._foreach_sqrt_(denom)
        update = torch._foreach_div(grads, denom)
        if hp['momentum'] > 0:
            buf = work['momentum_buffer']
            torch._foreach_mul_(buf, hp['momentum'])
            torch._foreach_add_(buf, update)
            return buf
        return update

    def _adam(self, params, grads, work, count):
        hp = self.hp
        b1, b2 = hp['beta1'], hp['beta2']
        if self.rule == 'adam' and hp['weight_decay'] > 0:
            grads = torch._foreach_add(grads, params,
                                       alpha=hp['weight_decay'])
        mu, nu = work['exp_avg'], work['exp_avg_sq']
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        p0 = params[0]
        mu_hat = torch._foreach_div(mu, self.scalar(
            lambda: _bias_correction(b1, self.state[p0]['step'] + 1)))
        nu_hat = torch._foreach_div(nu, self.scalar(
            lambda: _bias_correction(b2, self.state[p0]['step'] + 1)))
        if 'max_exp_avg_sq' in work:
            torch._foreach_maximum_(work['max_exp_avg_sq'], nu_hat)
            nu_hat = work['max_exp_avg_sq']
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, hp['eps'])
        update = torch._foreach_div(mu_hat, denom)
        if self.rule == 'wdadam' and hp['weight_decay'] > 0:
            torch._foreach_add_(update, params, alpha=hp['weight_decay'])
        return update

    _wdadam = _adam


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` (no weight decay, no AMSGrad): the flaw
    detector's and the discriminator's optimizer (JAX
    ``optax.scale_by_adam`` with their own schedules).

    On the card it is torch's capturable step, eager or captured alike:
    the update count lives in a device tensor and the bias corrections are
    computed there, so a CUDA graph replay reads and advances them, and the
    lr may be a 0-d device tensor (``StepScalars``). On the CPU it is
    torch's plain step with the lr a number, the one each group's lr
    function (``lr_fns``, set by the algorithm with the lr) gives: a 0-d
    lr tensor there (a step in tensor mode) would round otherwise.
    """

    def __init__(self, params, lr, betas=(0.9, 0.99), eps=1e-8):
        params = list(params)
        super(Adam, self).__init__(params, lr=lr, betas=betas, eps=eps,
                                   capturable=params[0].is_cuda)
        self.lr_fns = None

    @torch.no_grad()
    def step(self, closure=None):
        if not self.defaults['capturable']:
            for group, fn in zip(self.param_groups, self.lr_fns or ()):
                group['lr'] = fn()
        return super(Adam, self).step(closure)


def _factory(name, args, **hparams):
    lr = _default(args.lr, None)
    if lr is None:
        logger.log_err('{0} optimizer requires --lr'.format(name))
    clip_norm = getattr(args, 'clip_grad_norm', -1)
    bf16_state = getattr(args, 'bf16_opt_state', False)

    def build(param_groups):
        return ChainOptimizer(param_groups, name, lr, clip_norm=clip_norm,
                              bf16_state=bf16_state, **hparams)

    return OptimizerFactory(name, build, lr)


def sgd(args):
    """SGD with momentum, dampening, nesterov and L2 weight decay
    (reference optimizer.py:57-75)."""
    return _factory('sgd', args, momentum=_default(args.momentum, 0.0),
                    dampening=_default(args.dampening, 0.0),
                    weight_decay=_default(args.weight_decay, 0.0),
                    nesterov=bool(args.nesterov))


def rmsprop(args):
    """RMSprop (reference optimizer.py:78-100)."""
    return _factory('rmsprop', args, alpha=_default(args.alpha, 0.99),
                    eps=_default(args.eps, 1e-8),
                    momentum=_default(args.momentum, 0.0),
                    weight_decay=_default(args.weight_decay, 0.0),
                    centered=bool(args.centered))


def adam(args):
    """Adam with L2 (coupled) weight decay (reference
    optimizer.py:103-122)."""
    return _factory('adam', args, beta1=_default(args.beta1, 0.9),
                    beta2=_default(args.beta2, 0.999),
                    eps=_default(args.eps, 1e-8),
                    weight_decay=_default(args.weight_decay, 0.0))


def wdadam(args):
    """Adam with decoupled weight decay and optional AMSGrad (reference
    optimizer.py:151-247)."""
    return _factory('wdadam', args, beta1=_default(args.beta1, 0.9),
                    beta2=_default(args.beta2, 0.999),
                    eps=_default(args.eps, 1e-8),
                    weight_decay=_default(args.weight_decay, 0.0),
                    amsgrad=bool(args.amsgrad))


_REGISTRY = {'sgd': sgd, 'rmsprop': rmsprop, 'adam': adam, 'wdadam': wdadam}


def get(name):
    if name not in _REGISTRY:
        logger.log_err('Unknown optimizer `{0}`. Valid: {1}'.format(
            name, VALID_OPTIMIZER))
    return _REGISTRY[name]
