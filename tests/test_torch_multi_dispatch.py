"""``--steps-per-dispatch`` and ``--eager-ingest`` in the port, on the CPU.

On the card a dispatch of n steps is one CUDA graph of the step replayed n
times; on the CPU the same multi-step loop runs each step eagerly with the
numbers it takes from the host as tensors, the captured step's arithmetic
(``ssl_base.StepScalars``). Here:

* each of the seven algorithms, three steps through ``train_steps``
  against three ``train_step`` calls from the same weights and batch:
  every metric and every parameter and buffer equal, bit for bit (the
  host numbers as tensors round as the Python scalars do);
* ``run_script`` at ``steps_per_dispatch`` 2 over 3 iterations (one
  dispatch and a tail of one) against the same run at 1, SupOnly and
  two-stream MT: the same step count, the logged iterations of the
  multi-step loop, and the same parameters, bit for bit (the JAX
  package's test allows rtol 1e-3, atol 5e-4,
  tests/test_multi_dispatch.py:58-81);
* ``--eager-ingest`` bit-identical at 1 and at 2 steps a dispatch;
* the host numbers a captured step reads (the lr of every schedule, the
  ramp-up, the EMA decay) at every step against the JAX package's own
  schedules, ``sigmoid_rampup`` and decay, rtol 1e-6 (float32; the JAX
  package evaluates ``pow`` and ``cos`` in float32, the port in double and
  rounds once);
* a port run at 2 steps a dispatch against the JAX package's run at 2 on
  the same initial weights (``from_jax``), the limits of
  tests/test_torch_proxy.py;
* the pieces: ``nn.loader.chunked`` and ``ingested``, and the flaw
  detector's and discriminator's ``Adam`` on the CPU against torch's.
"""

import collections
import itertools
import json
import shutil
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import parallel
from pixelssl_tpu import runner as jax_runner
from pixelssl_tpu.nn import func as jax_func
from pixelssl_tpu.nn import lrer as jax_lrer
from pixelssl_tpu.tasks import sseg as jax_sseg
from pixelssl_tpu.utils import cmd as jax_cmd

import pixelssl_tpu_torch
from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.nn import loader as nnloader
from pixelssl_tpu_torch.nn import optimizer as nnoptim
from pixelssl_tpu_torch.tasks import sseg

from test_torch_mt import one_torch_thread  # noqa: F401

N_SAMPLES = 12  # 6 labeled, 6 unlabeled: 3 iterations at batch 2 + 2


def _config(out, sub_path, algo, **overrides):
    cfg = collections.OrderedDict([
        ('exp_id', 'run'), ('out_path', str(out)),
        ('ssl_algorithm', algo),
        ('trainset', {'synthetic_sseg': ['synthetic']}),
        ('valset', {'synthetic_sseg': ['synthetic']}),
        ('synthetic_samples', N_SAMPLES),
        ('models', {'model': 'deeplabv2'}),
        ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),
        ('backbone', 'resnet10'), ('im_size', 64), ('num_classes', 5),
        ('epochs', 1), ('log_freq', 1), ('val_freq', 100),
        ('checkpoint_freq', 100), ('bf16', False),
        ('lr', 1e-5), ('momentum', 0.9), ('weight_decay', 5e-4),
        ('num_workers', 0), ('seed', 7),
    ])
    if algo == 'ssl_null':
        cfg.update([('batch_size', 2), ('unlabeled_batch_size', 0),
                    ('synthetic_samples', 6)])
    else:
        cfg.update([('sublabeled_path', str(sub_path)),
                    ('ignore_unlabeled', False), ('batch_size', 4),
                    ('unlabeled_batch_size', 2), ('cons_for_labeled', False),
                    ('cons_scale', 1.0), ('cons_rampup_epochs', 1),
                    ('ema_decay', 0.99)])
    cfg.update(overrides)
    return cfg


def _sublabeled(tmp_path):
    path = tmp_path / 'sublabeled.txt'
    path.write_text(''.join('synthetic_{0:05d}\n'.format(i)
                            for i in range(0, N_SAMPLES, 2)))
    return path


def _run(tmp_path, name, algo, **overrides):
    config = _config(tmp_path / name, _sublabeled(tmp_path), algo,
                     **overrides)
    proxy = pixelssl_tpu_torch.run_script(
        config, sseg, sseg.SemanticSegmentationProxy, device='cpu',
        cli_override=False)
    with open(tmp_path / name / 'run' / 'metrics.jsonl') as f:
        records = [json.loads(line) for line in f]
    return proxy, [r for r in records if r['phase'] == 'train']


def _params(proxy):
    return {'{0}.{1}'.format(k, n): p.detach().clone()
            for k, m in proxy.ssl_algorithm.modules.items()
            for n, p in m.named_parameters()}


@pytest.mark.parametrize('algo', ['ssl_null', 'ssl_mt'])
def test_multi_dispatch_matches_single_step(tmp_path, algo):
    p1, r1 = _run(tmp_path, 'spd1', algo)
    p2, r2 = _run(tmp_path, 'spd2', algo, steps_per_dispatch=2)
    assert p1.args.iters_per_epoch == 3
    assert p2.ssl_algorithm.steps_per_dispatch == 2
    assert p1.ssl_algorithm.state.step == p2.ssl_algorithm.state.step == 3
    # one dispatch logs its last step (iteration 2), the tail iteration 3
    assert [r['iter'] for r in r1] == [1, 2, 3]
    assert [r['iter'] for r in r2] == [2, 3]
    for a, b in zip(r1[1:], r2):
        for key in a:
            if key.endswith('_loss') or key == 'lr':
                assert a[key] == b[key], key
    ours, theirs = _params(p1), _params(p2)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert torch.equal(ours[key], theirs[key]), key


SMALL = dict(backbone='resnet10', im_size=64, num_classes=5, batch_size=4,
             unlabeled_batch_size=2, ignore_unlabeled=False, bf16=False,
             lr=5e-5, momentum=0.9, weight_decay=5e-4, epochs=2, seed=3)
ALGOS = {
    'ssl_null': dict(unlabeled_batch_size=0),
    'ssl_mt': dict(cons_for_labeled=False, cons_scale=1.0,
                   cons_rampup_epochs=1, ema_decay=0.99,
                   gaussian_noise_std=0.1),
    'ssl_gct': dict(ssl_mode='gct', fc_ssl_scale=1.0, dc_ssl_scale=100.0,
                    dc_threshold=0.6, dc_rampup_epochs=1, fd_lr=1e-4,
                    fd_scale=10.0, mu=0.5, nu=1, im_size=96),
    'ssl_adv': dict(adv_for_labeled=True, labeled_adv_scale=0.01,
                    unlabeled_adv_scale=0.001,
                    unlabeled_for_discriminator=True),
    'ssl_s4l': dict(rotated_sup_scale=0.1, rotation_scale=0.1),
    'ssl_cutmix': dict(cons_scale=20.0, cons_rampup_epochs=1,
                       cons_threshold=0.05, mask_prop_range=(0.5, 0.5),
                       models={'model': 'pspnet'}),
    'ssl_cct': dict(cons_scale=30.0, cons_rampup_epochs=5, ad_lr_scale=10.0,
                    vat_dec_num=1, vat_dec_xi=1e-1, drop_dec_num=1,
                    cut_dec_num=1, context_dec_num=1, object_dec_num=1,
                    fn_dec_num=1, fd_dec_num=1, models={'model': 'pspnet'}),
}


def _update_counts(opt):
    return [float(st['step']) for st in opt.state.values() if st]


@pytest.mark.parametrize('algo_name', sorted(ALGOS))
def test_train_steps_equal_eager_steps(algo_name):
    """Three steps as a dispatch of two and one of one against three eager
    steps: the metrics of every step and the final state equal."""
    args = harness.default_args(algo_name, **dict(SMALL, **ALGOS[algo_name]))
    runs = []
    for multi in (False, True):
        algo = harness.build_algorithm(args, device='cpu', iters_per_epoch=2)
        batch = harness.synthetic_batch(args, device='cpu', seed=1)
        history = []
        if multi:
            algo.train_steps([batch, batch], history)
            algo.train_steps([batch], history)
        else:
            history = [algo.train_step(batch) for _ in range(3)]
        assert algo.state.step == 3
        runs.append((algo, history))
    (eager, eager_rows), (multi, multi_rows) = runs
    for a, b in zip(eager_rows, multi_rows):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key].float().cpu(), b[key].float().cpu()), \
                key
    for key, module in eager.modules.items():
        theirs = multi.modules[key].state_dict()
        for name, value in module.state_dict().items():
            assert torch.equal(value, theirs[name]), (key, name)
    for key, opt in eager.optimizers.items():
        assert _update_counts(opt) == _update_counts(multi.optimizers[key])
        assert [g['lr'] for g in opt.param_groups] == \
            [g['lr'] for g in multi.optimizers[key].param_groups]


@pytest.mark.parametrize('steps_per_dispatch', [1, 2])
def test_eager_ingest_is_bitwise_identical(tmp_path, steps_per_dispatch):
    p1, r1 = _run(tmp_path, 'plain', 'ssl_mt',
                  steps_per_dispatch=steps_per_dispatch)
    p2, r2 = _run(tmp_path, 'eager', 'ssl_mt', eager_ingest=True,
                  steps_per_dispatch=steps_per_dispatch)
    assert p2.train_loader.eager_ingest
    assert p1.ssl_algorithm.state.step == p2.ssl_algorithm.state.step == 3
    assert [{k: v for k, v in r.items() if 'time' not in k} for r in r1] == \
        [{k: v for k, v in r.items() if 'time' not in k} for r in r2]
    ours, theirs = _params(p1), _params(p2)
    for key in ours:
        assert torch.equal(ours[key], theirs[key]), key


SCHEDULES = [
    ('polynomiallr', dict()),
    ('steplr', dict(step_size=2, gamma=0.5)),
    ('multisteplr', dict(milestones=[1, 3], gamma=0.3)),
    ('exponentiallr', dict(gamma=0.8)),
    ('cosineannealinglr', dict(eta_min=1e-4)),
]
EPOCHS, ITERS, RAMPUP_EPOCHS, EMA_DECAY = 5, 3, 2, 0.99


@pytest.mark.parametrize('name,flags', SCHEDULES,
                         ids=[n for n, _ in SCHEDULES])
def test_step_scalars_match_jax_schedules(name, flags):
    """The float32 numbers of a captured step (tensor mode) at every
    step: each group's lr (``lr * lr_mult``), the logged lr, MT's ramp-up
    and the EMA decay and its complement, against the JAX package's."""
    args = harness.default_args(
        'ssl_mt', backbone='resnet10', im_size=32, num_classes=3,
        batch_size=2, unlabeled_batch_size=1, ignore_unlabeled=False,
        bf16=False, lr=0.01, momentum=0.9, epochs=EPOCHS,
        cons_scale=1.0, cons_rampup_epochs=RAMPUP_EPOCHS,
        ema_decay=EMA_DECAY, lrers={'model': name}, **flags)
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS)
    theirs_lr = jax.jit(jax_lrer.get(name)(types.SimpleNamespace(
        **vars(args))).make(0.01, ITERS, EPOCHS))
    mults = [g['lr_mult'] for g in algo.opt.param_groups]
    assert sorted(set(mults)) == [1.0, 10.0]
    for step in range(EPOCHS * ITERS):
        algo.state.step = step
        algo.step_scalars.begin()
        try:
            lr = algo._set_lr(algo.opt, algo.lr_schedule)
            group_lrs = [g['lr'] for g in algo.opt.param_groups]
            rampup = algo._rampup(RAMPUP_EPOCHS, 1.0)
            decay, rest = algo._ema_decay(EMA_DECAY)
        finally:
            algo.step_scalars.end()
        for value in [lr, rampup, decay, rest] + group_lrs:
            assert torch.is_tensor(value) and value.dtype == torch.float32
        want_lr = np.float32(theirs_lr(jnp.int32(step)))
        want_decay = np.float32(jnp.minimum(
            1.0 - 1.0 / (jnp.float32(step) + 1.0), EMA_DECAY))
        want = {
            'lr': want_lr,
            'rampup': np.float32(jax_func.sigmoid_rampup(
                jnp.float32(step), ITERS * RAMPUP_EPOCHS)),
            'decay': want_decay, 'rest': np.float32(1.0) - want_decay}
        got = {'lr': lr, 'rampup': rampup, 'decay': decay, 'rest': rest}
        for key, value in got.items():
            np.testing.assert_allclose(float(value), want[key], rtol=1e-6,
                                       atol=1e-12, err_msg=(key, step))
        for value, mult in zip(group_lrs, mults):
            np.testing.assert_allclose(float(value), want_lr * mult,
                                       rtol=1e-6, err_msg=('group', step))


def test_multi_dispatch_matches_jax_at_two_steps_a_dispatch(tmp_path):
    """The MT run of each package at ``steps_per_dispatch`` 2 (the JAX
    package's ``lax.scan`` over two steps and its tail, the port's loop),
    from the same initial weights: the logged iterations 2 and 3 within
    rtol 2e-3 (``cons_loss`` rtol 2e-2, atol 1e-9) and the parameters
    after them within atol 3e-4 (tests/test_torch_gct.py's)."""
    sub = _sublabeled(tmp_path)
    config = _config(tmp_path / 'jax', sub, 'ssl_mt', steps_per_dispatch=2,
                     lr=5e-5)
    parser = jax_runner.create_parser('ssl_mt')
    jax_sseg.add_parser_arguments(parser)
    jargs = jax_cmd.parse_args(parser, config, cli_override=False)
    jproxy = jax_sseg.SemanticSegmentationProxy(
        jargs, mesh=parallel.make_mesh(1))
    initial = jax.tree.map(np.asarray,
                           jax.device_get(jproxy.ssl_algorithm.state))
    try:
        jproxy.run()
        final = jax.tree.map(np.asarray,
                             jax.device_get(jproxy.ssl_algorithm.state))
        with open(tmp_path / 'jax' / 'run' / 'metrics.jsonl') as f:
            theirs = [r for r in map(json.loads, f) if r['phase'] == 'train']

        config = _config(tmp_path / 'port', sub, 'ssl_mt',
                         steps_per_dispatch=2, lr=5e-5)
        parser = pixelssl_tpu_torch.create_parser('ssl_mt')
        sseg.add_parser_arguments(parser)
        args = pixelssl_tpu_torch.utils.cmd.parse_args(parser, config,
                                                       cli_override=False)
        proxy = sseg.SemanticSegmentationProxy(args, device='cpu')
        for key, module in proxy.ssl_algorithm.modules.items():
            module.load_state_dict(from_jax(initial[key]))
        proxy.run()
        with open(tmp_path / 'port' / 'run' / 'metrics.jsonl') as f:
            ours = [r for r in map(json.loads, f) if r['phase'] == 'train']
    finally:
        shutil.rmtree(tmp_path / 'jax', ignore_errors=True)

    assert [r['iter'] for r in ours] == [r['iter'] for r in theirs] == [2, 3]
    for a, b in zip(ours, theirs):
        for key in ('s_task_loss', 't_task_loss', 'cons_loss', 'lr'):
            rtol, atol = (2e-2, 1e-9) if key == 'cons_loss' else (2e-3, 1e-6)
            assert np.isclose(a[key], b[key], rtol=rtol, atol=atol), (
                a['iter'], key, a[key], b[key])
    assert proxy.ssl_algorithm.state.step == int(final['step']) == 3
    for key in ('model', 'teacher'):
        want = from_jax(final[key])
        got = proxy.ssl_algorithm.modules[key].state_dict()
        for name, value in want.items():
            if name.endswith('num_batches_tracked'):
                continue
            np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                       atol=3e-4, err_msg=(key, name))


@pytest.mark.parametrize('n_batches,n,expected', [
    (7, 3, ['chunk 0 1 2', 'chunk 3 4 5', 'single 6']),
    (4, 2, ['chunk 0 1', 'chunk 2 3']),
    (2, 4, ['single 0', 'single 1']),
])
def test_chunked_groups_dispatches_and_a_tail(n_batches, n, expected):
    """``nn.loader.chunked``, the multi-step loop's grouping: n batches a
    dispatch in order, the tail one at a time."""
    got = []
    for kind, payload in nnloader.chunked(iter(range(n_batches)), n):
        items = payload if kind == 'chunk' else [payload]
        got.append(' '.join([kind] + [str(x) for x in items]))
    assert got == expected


def test_ingested_hands_over_every_item_and_the_threads_error():
    """``nn.loader.ingested`` on the CPU: the items in order, an error of
    the loader thread raised in the consumer, and a loop left early stops
    the thread."""
    batches = [{'inp': (torch.full((2,), float(i)),), 'gt': ()}
               for i in range(5)]
    got = list(nnloader.ingested(iter(batches), 'cpu'))
    assert [float(b['inp'][0][0]) for b in got] == [0, 1, 2, 3, 4]

    def failing():
        yield batches[0]
        raise RuntimeError('decode failed')

    seen = []
    with pytest.raises(RuntimeError, match='decode failed'):
        for item in nnloader.ingested(failing(), 'cpu'):
            seen.append(item)
    assert len(seen) == 1

    before = threading.active_count()
    stream = nnloader.ingested(itertools.count(), 'cpu')
    assert next(stream) == 0
    stream.close()
    assert threading.active_count() == before


def test_adam_on_the_cpu_steps_with_the_lr_of_its_lr_functions():
    """``nn.optimizer.Adam`` on the CPU: torch's plain step (not
    capturable) with the lr its lr function gives, where a step in tensor
    mode left a 0-d float32 lr in the group (torch's step would round that
    one otherwise); equal bit for bit to ``torch.optim.Adam`` stepped with
    the numbers of a poly schedule."""
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn((64, 3, 3, 3), generator=gen),
            torch.randn((64,), generator=gen)]
    grads = [[torch.randn(t.shape, generator=gen) for t in init]
             for _ in range(5)]
    lrs = [1e-4 * (1 - k / 1000.0) ** 0.9 for k in range(5)]
    ours = [torch.nn.Parameter(t.clone()) for t in init]
    theirs = [torch.nn.Parameter(t.clone()) for t in init]
    opt = nnoptim.Adam(ours, lr=lrs[0], betas=(0.9, 0.99), eps=1e-8)
    ref = torch.optim.Adam(theirs, lr=lrs[0], betas=(0.9, 0.99), eps=1e-8)
    assert not opt.defaults['capturable']
    for k in range(5):
        for p, q, g in zip(ours, theirs, grads[k]):
            p.grad, q.grad = g.clone(), g.clone()
        opt.lr_fns = [lambda k=k: lrs[k]]
        opt.param_groups[0]['lr'] = torch.tensor(lrs[k], dtype=torch.float32)
        ref.param_groups[0]['lr'] = lrs[k]
        opt.step()
        ref.step()
    for p, q in zip(ours, theirs):
        assert torch.equal(p, q)
