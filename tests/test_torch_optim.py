"""The port's optimizers and lr schedules against the JAX package's.

Optimizers: the same parameters and the same gradients (drawn with numpy
for five steps, some of them above the clipping norm) go through the JAX
package's optax chain (``OptimizerFactory.make``) and the port's
``ChainOptimizer``, on two groups at ``lr_mult`` 1 and 10. Parameters agree
to rtol 1e-6 and atol 1e-7 after every step (float32, the products and
sums in another order); float32 state to rtol 1e-6 with an atol of 1e-6
of the tensor's largest magnitude (RMSprop's momentum trace sums updates
of about 10, and an element where they cancel keeps their rounding), and
bf16 state within one bf16 ulp, since a last-bit float32 difference can
cross a bf16 rounding boundary.

Schedules: every schedule at every step of 12 epochs of 7 iterations, rtol
1e-5: a few float32 ulps, since the JAX package evaluates ``pow`` and
``cos`` in float32 and the port in double.
"""

import collections
import io
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import pixelssl_tpu
from pixelssl_tpu.nn import lrer as jax_lrer
from pixelssl_tpu.nn import optimizer as jax_optimizer
from pixelssl_tpu.tasks import sseg as jax_sseg

import pixelssl_tpu_torch
from pixelssl_tpu_torch.nn import lrer, optimizer
from pixelssl_tpu_torch.tasks import sseg
from pixelssl_tpu_torch.utils import logger

from test_torch_mt import one_torch_thread  # noqa: F401

LR = 5e-4
SHAPES = {'a': (3, 4, 5), 'b': (7,)}
MULTS = {'a': 1.0, 'b': 10.0}
GRAD_SCALES = (0.05, 0.3, 0.05, 0.3, 0.1)  # global norms ~0.4 to ~2.5
CLIP = 1.0

# (name, flags): each optimizer and its variants
OPTIMIZERS = [
    ('sgd', dict(momentum=0.9, weight_decay=5e-4)),
    ('sgd', dict(momentum=0.9, dampening=0.2, weight_decay=5e-4)),
    ('sgd', dict(momentum=0.9, nesterov=True)),
    ('rmsprop', dict()),
    ('rmsprop', dict(alpha=0.9, centered=True)),
    ('rmsprop', dict(momentum=0.8, weight_decay=1e-2)),
    ('rmsprop', dict(centered=True, momentum=0.9, eps=1e-6)),
    ('adam', dict()),
    ('adam', dict(weight_decay=1e-2, beta1=0.8, beta2=0.99)),
    ('wdadam', dict(weight_decay=1e-2)),
    ('wdadam', dict(weight_decay=1e-2, amsgrad=True)),
]

# the JAX state leaves of one parameter, in tree order, by the port's names
JAX_STATE_ORDER = {
    'sgd': ['momentum_buffer'],
    'rmsprop': ['grad_avg', 'square_avg', 'momentum_buffer'],
    'adam': ['exp_avg', 'exp_avg_sq'],
    'wdadam': ['exp_avg', 'exp_avg_sq', 'max_exp_avg_sq'],
}


def _args(**flags):
    """The optimizer flags at the JAX package's defaults, then ``flags``."""
    base = dict(lr=LR, dampening=-1, nesterov=False, weight_decay=-1,
                momentum=-1, alpha=-1, centered=False, eps=-1, beta1=-1,
                beta2=-1, amsgrad=False, clip_grad_norm=-1,
                bf16_opt_state=False)
    base.update(flags)
    return types.SimpleNamespace(**base)


def _grads(seed):
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in SHAPES.items()} for scale in GRAD_SCALES]


def _jax_state_leaves(opt_state, shape):
    """The float state leaves of one parameter shape, in tree order."""
    return [np.asarray(leaf.astype(jnp.float32)) for leaf in
            jax.tree_util.tree_leaves(opt_state)
            if hasattr(leaf, 'shape') and leaf.shape == shape and
            jnp.issubdtype(leaf.dtype, jnp.floating)]


def _port_optimizer(name, args, params):
    groups = [{'params': [params[k]], 'lr_mult': MULTS[k]} for k in SHAPES]
    opt = optimizer.get(name)(args).make(groups)
    optimizer.set_lr(opt, LR)
    return opt


def _within_bf16_ulp(a, b):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert np.all(np.abs(a - b) <= ulp + 1e-30), np.max(np.abs(a - b) / ulp)


@pytest.mark.parametrize('bf16', [False, True], ids=['f32state', 'bf16state'])
@pytest.mark.parametrize('clip', [False, True], ids=['noclip', 'clip'])
@pytest.mark.parametrize('name,flags', OPTIMIZERS,
                         ids=['{0}-{1}'.format(n, '-'.join(sorted(f)) or
                                               'plain')
                              for n, f in OPTIMIZERS])
def test_optimizer_matches_optax(name, flags, clip, bf16):
    args = _args(clip_grad_norm=CLIP if clip else -1, bf16_opt_state=bf16,
                 **flags)
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}

    tx = jax_optimizer.get(name)(args).make(
        lambda step: LR, lr_mult={k: jnp.float32(m) for k, m in MULTS.items()})
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = _port_optimizer(name, args, params)

    clipped = []
    for s, grads in enumerate(_grads(1)):
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                           for g in grads.values()))
        clipped.append(norm >= CLIP)
        updates, jstate = update({k: jnp.asarray(g) for k, g in grads.items()},
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, g in grads.items():
            params[k].grad = torch.from_numpy(g.copy())
        opt.step()
        for k in SHAPES:
            np.testing.assert_allclose(
                params[k].detach().numpy(), np.asarray(jparams[k]),
                rtol=1e-6, atol=1e-7, err_msg='step {0} {1}'.format(s, k))
    assert any(clipped) and not all(clipped)

    for k in SHAPES:
        st = opt.state[params[k]]
        assert st['step'] == len(GRAD_SCALES)
        keys = [key for key in JAX_STATE_ORDER[name] if key in st]
        assert sorted(keys) == sorted(opt.state_keys())
        theirs = _jax_state_leaves(jstate, SHAPES[k])
        assert len(theirs) == len(keys)
        for key, ref in zip(keys, theirs):
            ours = st[key]
            assert ours.dtype == (torch.bfloat16 if bf16 else torch.float32)
            if bf16:
                _within_bf16_ulp(ours.float().numpy(), ref)
            else:
                np.testing.assert_allclose(
                    ours.numpy(), ref, rtol=1e-6,
                    atol=max(1e-7, 1e-6 * float(np.abs(ref).max())),
                    err_msg=key)


@pytest.mark.parametrize('name,flags', [
    ('sgd', dict(momentum=0.9)), ('rmsprop', dict(centered=True,
                                                  momentum=0.9)),
    ('wdadam', dict(amsgrad=True, weight_decay=1e-2))])
def test_bf16_state_survives_a_state_dict_round_trip(name, flags):
    """``load_state_dict`` of ``torch.optim.Optimizer`` casts floating state
    to the parameters' float32; the port's keeps bf16, and the resumed
    optimizer steps as the original does."""
    args = _args(bf16_opt_state=True, clip_grad_norm=CLIP, **flags)
    grads = _grads(2)
    runs = []
    for _ in range(2):
        params = {k: torch.nn.Parameter(torch.ones(s)) for k, s in
                  SHAPES.items()}
        runs.append((params, _port_optimizer(name, args, params)))
    (p0, opt0), (p1, opt1) = runs
    for g in grads[:2]:
        for k in SHAPES:
            p0[k].grad = torch.from_numpy(g[k].copy())
        opt0.step()
    buf = io.BytesIO()
    torch.save({'params': {k: p.detach() for k, p in p0.items()},
                'opt': opt0.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    with torch.no_grad():
        for k in SHAPES:
            p1[k].copy_(saved['params'][k])
    opt1.load_state_dict(saved['opt'])
    for k in SHAPES:
        ours, theirs = opt1.state[p1[k]], opt0.state[p0[k]]
        assert ours['step'] == theirs['step'] == 2
        for key in opt0.state_keys():
            assert ours[key].dtype == torch.bfloat16, key
            assert torch.equal(ours[key], theirs[key]), key
    for g in grads[2:]:
        for params, opt in runs:
            for k in SHAPES:
                params[k].grad = torch.from_numpy(g[k].copy())
            opt.step()
    for k in SHAPES:
        assert torch.equal(p0[k], p1[k])


def test_unknown_optimizer_is_refused():
    with pytest.raises(logger.FatalError, match='Unknown optimizer `adamw`'):
        optimizer.get('adamw')
    assert optimizer.VALID_OPTIMIZER == jax_optimizer.VALID_OPTIMIZER


EPOCHS, ITERS = 12, 7
SCHEDULES = [
    ('steplr', dict(step_size=3, gamma=0.5)),
    ('steplr', dict(step_size=5)),
    ('multisteplr', dict(milestones=[2, 5, 9], gamma=0.3)),
    ('multisteplr', dict(milestones=[0, 4])),
    ('exponentiallr', dict(gamma=0.8)),
    ('cosineannealinglr', dict()),
    ('cosineannealinglr', dict(T_max=5, eta_min=1e-4)),
    ('polynomiallr', dict()),
    ('polynomiallr', dict(power=2.0)),
]


def _lrer_args(**flags):
    base = dict(last_epoch=-1, step_size=-1, milestones=[], gamma=-1,
                T_max=-1, eta_min=-1, power=-1)
    base.update(flags)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize('name,flags', SCHEDULES,
                         ids=['{0}-{1}'.format(n, '-'.join(sorted(f)) or
                                               'default')
                              for n, f in SCHEDULES])
def test_schedule_matches_jax_at_every_step(name, flags):
    ours_factory = lrer.get(name)(_lrer_args(**flags))
    theirs_factory = jax_lrer.get(name)(_lrer_args(**flags))
    assert ours_factory.kind == theirs_factory.kind
    assert ours_factory.is_epoch_lrer == (name in jax_lrer.EPOCH_LRERS)
    ours = ours_factory.make(0.01, ITERS, EPOCHS)
    theirs = jax.jit(theirs_factory.make(0.01, ITERS, EPOCHS))
    steps = np.arange(EPOCHS * ITERS)
    got = np.array([ours(int(s)) for s in steps])
    want = np.array([float(theirs(jnp.int32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    if ours_factory.is_epoch_lrer:  # constant within an epoch
        assert np.all(got.reshape(EPOCHS, ITERS) ==
                      got.reshape(EPOCHS, ITERS)[:, :1])


def test_lrer_registries_agree():
    assert lrer.EPOCH_LRERS == jax_lrer.EPOCH_LRERS
    assert lrer.ITER_LRERS == jax_lrer.ITER_LRERS
    with pytest.raises(logger.FatalError, match='Unknown lrer `onecycle`'):
        lrer.get('onecycle')
    with pytest.raises(SystemExit, match='Unknown lrer `onecycle`'):
        jax_lrer.get('onecycle')


def _config(out, algorithm, components, lrers, **overrides):
    cfg = collections.OrderedDict([
        ('exp_id', 'lrers'), ('out_path', str(out)),
        ('ssl_algorithm', algorithm),
        ('trainset', {'synthetic_sseg': ['synthetic']}),
        ('valset', {'synthetic_sseg': ['synthetic']}),
        ('synthetic_samples', 8), ('ignore_unlabeled', False),
        ('unlabeledset', {'synthetic_sseg': ['synthetic_u']}),
        ('models', {c: 'deeplabv2' for c in components}),
        ('optimizers', {c: 'sgd' for c in components}),
        ('lrers', dict(zip(components, lrers))),
        ('criterions', {c: 'sseg_criterion' for c in components}),
        ('backbone', 'resnet10'), ('im_size', 32), ('num_classes', 4),
        ('batch_size', 2), ('unlabeled_batch_size', 1), ('epochs', 1),
        ('lr', 1e-4), ('step_size', 1), ('num_workers', 0),
        ('bf16', False), ('cons_scale', 1.0), ('cons_rampup_epochs', 1),
        ('checkpoint_freq', 10),  # no checkpoint: these runs take 1 epoch
    ])
    cfg.update(overrides)
    return cfg


def test_proxy_refuses_mixed_lrer_kinds_as_the_jax_proxy_does(tmp_path):
    """Schedules of both kinds in one run stop both packages' runs with
    the same message, before anything is built."""
    message = 'All lrers must be of the same kind'
    for root, package, module in ((tmp_path / 'jax', pixelssl_tpu, jax_sseg),
                                  (tmp_path / 'port', pixelssl_tpu_torch,
                                   sseg)):
        config = _config(root, 'ssl_gct', ('lmodel', 'rmodel'),
                         ('steplr', 'polynomiallr'))
        kwargs = ({'device': 'cpu', 'cli_override': False}
                  if package is pixelssl_tpu_torch else {})
        with pytest.raises(SystemExit, match=message):
            package.run_script(config, module,
                               module.SemanticSegmentationProxy, **kwargs)


def test_proxy_refuses_an_unknown_lrer(tmp_path):
    with pytest.raises(logger.FatalError, match='Unknown lrer `warmuplr`'):
        pixelssl_tpu_torch.run_script(
            _config(tmp_path, 'ssl_mt', ('model',), ('warmuplr',)), sseg,
            sseg.SemanticSegmentationProxy, device='cpu', cli_override=False)


@pytest.mark.parametrize('name,expected', [('steplr', True),
                                           ('polynomiallr', False)])
def test_proxy_sets_is_epoch_lrer(tmp_path, name, expected):
    """A run's schedules of one kind train, and ``args.is_epoch_lrer``
    says which kind (JAX proxy.py:256-257)."""
    proxy = pixelssl_tpu_torch.run_script(
        _config(tmp_path, 'ssl_mt', ('model',), (name,),
                synthetic_samples=4),
        sseg, sseg.SemanticSegmentationProxy, device='cpu',
        cli_override=False)
    assert proxy.args.is_epoch_lrer is expected
    assert proxy.ssl_algorithm.state.step == len(proxy.train_loader)
