"""The port's Mean Teacher against the JAX package's: the input noise on
JAX's own draws, the EMA update, and three full train steps on the same
weights (carried across by ``pixelssl_tpu_torch.models.from_jax``) and the
same batch, noise off as in the reference recipe.

The teacher starts as the student and the first EMA decay is 0, so the
teacher equals the student on steps 0 and 1 and the consistency loss is 0
there; step 2 is the first with ``cons_loss > 0``.

The steps run at lr 5e-5, not the recipe's 2.5e-4: at 2.5e-4 this
ResNet-10 toy's loss rises and float32 noise grows about tenfold a step,
so after three steps the two packages' layer4 BN running variances part by
more than the tolerance below although each step agrees;
``test_parity_lr_keeps_toy_steps_stable`` measures that on the port alone.

Tolerances, as tests/test_torch_gct.py states them: rtol 2e-3 on the task
losses and the lr; terminal params atol 3e-4; BN running statistics atol
1e-4 with rtol 1e-4. ``cons_loss`` gets rtol 2e-2 and atol 1e-9: it is the
mean squared difference of two nearly equal predictions, so float32 noise
in either forward is a large share of it, and on steps 0 and 1 the JAX
package's teacher and student forwards (two XLA programs, one fused with
the backward) may differ in the last ulp where the port's are identical.
"""

import ctypes
import ctypes.util
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel
from pixelssl_tpu.nn.module import gaussian_noise as jax_noise
from pixelssl_tpu.ssl_algorithm import ssl_base as jax_base

from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.nn.module.gaussian_noise import (apply_noise,
                                                         gaussian_noise)
from pixelssl_tpu_torch.ssl_algorithm.ssl_base import ema_update

from test_torch_gct import _assert_close, _perturb_stats, _t

IM = 64
BATCH = 4
LBS = 2
NUM_CLASSES = 5
N_STEPS = 3
ITERS_PER_EPOCH = 2

MT_ARGS = dict(
    backbone='resnet10', im_size=IM, num_classes=NUM_CLASSES,
    batch_size=BATCH, unlabeled_batch_size=BATCH - LBS, bf16=False,
    lr=5e-5, momentum=0.9, weight_decay=5e-4, power=0.9, epochs=20,
    cons_scale=1.0, cons_rampup_epochs=3, ema_decay=0.99,
    gaussian_noise_std=None)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread for torch while these tests run: the test
    command runs six workers on the host's cores, and torch's default of a
    thread per core in each of them oversubscribes it (on an 8-core host
    the port's CPU tests took 188 s with six workers, 51 s with one thread
    each).

    The heap is also trimmed before and after the module: JAX's
    compilations leave gigabytes freed but held by the allocator in a
    test worker (one that ran ``tests/test_checkpoint_all.py`` held 9.8
    GiB, 1.9 GiB after ``malloc_trim``), the six workers share the host's
    memory, and the host's out-of-memory killer ends the largest worker
    mid-test when they hold more than it has."""
    _trim_heap()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    _trim_heap()


def _trim_heap():
    """Freed heap pages given back to the host (glibc only)."""
    gc.collect()
    try:
        ctypes.CDLL(ctypes.util.find_library('c')).malloc_trim(0)
    except (OSError, AttributeError, TypeError):
        pass  # not glibc


def test_gaussian_noise_matches_jax_on_its_draws():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 9, 11, 3)).astype(np.float32)
    x[1] *= 5.0
    std = 0.4
    key = jax.random.PRNGKey(7)
    theirs = np.asarray(jax_noise(key, jnp.asarray(x), std))

    k_std, k_noise = jax.random.split(key)
    call_std = float(jax.random.uniform(k_std, (), minval=0.0, maxval=std))
    noise = np.asarray(jax.random.normal(k_noise, x.shape, jnp.float32))
    ours = apply_noise(_t(x.transpose(0, 3, 1, 2)), call_std,
                       _t(noise.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), theirs,
                               atol=1e-5)


def test_gaussian_noise_draws():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 8, 8)).astype(np.float32))
    for std in (None, 0, 0.0, -1.0):
        assert gaussian_noise(x, std, torch.Generator()) is x
    a = gaussian_noise(x, 0.5, torch.Generator().manual_seed(3))
    b = gaussian_noise(x, 0.5, torch.Generator().manual_seed(3))
    c = gaussian_noise(x, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # each sample stays inside its own [min, max]
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    assert bool(((a >= lo - 1e-5) & (a <= hi + 1e-5)).all())


@pytest.mark.parametrize('storage', ['float32', 'bfloat16'])
def test_ema_update_matches_jax(storage):
    """float32: equal to 1e-7 relative (the product and sum may fuse in
    one framework and not the other); bf16: within one bf16 ulp for the
    same reason, since a last-bit float32 difference can cross a bf16
    rounding boundary."""
    rng = np.random.default_rng(2)
    shapes = [(3, 5), (7,), (2, 3, 3, 4)]
    t_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    s_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdtype = jnp.bfloat16 if storage == 'bfloat16' else jnp.float32
    tdtype = getattr(torch, storage)
    for decay in (0.0, 0.5, 0.99):
        theirs = jax_base.ema_update([jnp.asarray(t, jdtype) for t in t_np],
                                     [jnp.asarray(s) for s in s_np],
                                     jnp.float32(decay))
        ours = [torch.from_numpy(t).to(tdtype) for t in t_np]
        ema_update(ours, [torch.from_numpy(s) for s in s_np], decay)
        for a, b in zip(ours, theirs):
            assert a.dtype == tdtype
            a = a.float().numpy()
            b = np.asarray(b.astype(jnp.float32))
            tol = 2.0 ** -8 if storage == 'bfloat16' else 1e-7
            np.testing.assert_allclose(a, b, rtol=tol, atol=1e-7)


def _jax_and_port(algo_name, args_dict, rng):
    """The JAX algorithm and the port's on the same weights (BN statistics,
    where a module has them, perturbed away from their init), and one
    batch in both layouts."""
    images = rng.standard_normal((BATCH, IM, IM, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (BATCH, IM, IM)).astype(np.int32)
    lbs = args_dict['batch_size'] - args_dict['unlabeled_batch_size']
    labels[:lbs, :4, :4] = 255
    labels[lbs:] = -1

    jargs = jax_harness.default_args(algo_name, **args_dict)
    mesh = parallel.make_mesh(1)
    jalgo = jax_harness.build_algorithm(jargs, mesh=mesh,
                                        iters_per_epoch=ITERS_PER_EPOCH)
    state = jax.tree.map(np.asarray, jax.device_get(jalgo.state))
    args = harness.default_args(algo_name, **args_dict)
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS_PER_EPOCH)
    for key, module in algo.modules.items():
        if 'batch_stats' in state[key]:
            state[key]['batch_stats'] = _perturb_stats(
                state[key]['batch_stats'], rng)
        module.load_state_dict(from_jax(state[key]))
    jstate = jax.device_put(state, parallel.replicate_sharding(mesh))
    jbatch = parallel.shard_batch({'inp': (images,), 'gt': (labels,)}, mesh)
    batch = {'inp': (_t(images.transpose(0, 3, 1, 2)),),
             'gt': (_t(labels).long(),)}
    return jalgo, jstate, jbatch, algo, batch


def run_steps(jalgo, jstate, jbatch, algo, batch, keys, tols):
    """``N_STEPS`` steps on both sides; asserts the metrics per step and
    returns the JAX side's final state (numpy) and the port's metrics."""
    history = []
    for s in range(N_STEPS):
        jstate, jmetrics = jalgo._train_step(jstate, jbatch)
        metrics = algo.train_step(batch)
        for k in keys:
            a, b = float(metrics[k]), float(np.asarray(jmetrics[k]))
            rtol, atol = tols.get(k, (2e-3, 1e-6))
            assert np.isclose(a, b, rtol=rtol, atol=atol), (s, k, a, b)
        history.append({k: float(v) for k, v in metrics.items()})
    assert algo.state.step == N_STEPS
    return jax.tree.map(np.asarray, jax.device_get(jstate)), history


@pytest.mark.parametrize('cons_for_labeled', [False, True])
def test_mt_three_steps_match_jax(cons_for_labeled):
    rng = np.random.default_rng(11)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port(
        'ssl_mt', dict(MT_ARGS, cons_for_labeled=cons_for_labeled), rng)
    final, history = run_steps(
        jalgo, jstate, jbatch, algo, batch,
        ('s_task_loss', 't_task_loss', 'cons_loss', 'lr'),
        {'cons_loss': (2e-2, 1e-9)})

    assert history[0]['cons_loss'] == 0.0
    assert history[1]['cons_loss'] == 0.0
    assert history[2]['cons_loss'] > 0.0
    for h in history:
        assert h['s_task_loss'] > 0 and h['t_task_loss'] > 0
    _assert_close(algo.model, final['model'], 3e-4, 1e-4, 'student')
    _assert_close(algo.teacher, final['teacher'], 3e-4, 1e-4, 'teacher')


def test_bf16_ema_teacher():
    """``--bf16-ema``: the teacher's parameters are stored in bf16, its BN
    statistics stay float32 and move with its own forward; after step 0
    (decay 0) the teacher is the student rounded to bf16."""
    args = harness.default_args('ssl_mt', **dict(
        MT_ARGS, im_size=32, cons_for_labeled=False, bf16_ema=True))
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS_PER_EPOCH)
    stats0 = {k: v.clone() for k, v in algo.teacher.named_buffers()}
    algo.train_step(harness.synthetic_batch(args, device='cpu', seed=1))
    for (name, t), s in zip(algo.teacher.named_parameters(),
                            algo.model.parameters()):
        assert t.dtype == torch.bfloat16, name
        assert torch.equal(t, s.detach().to(torch.bfloat16)), name
    for name, buf in algo.teacher.named_buffers():
        if buf.is_floating_point():
            assert buf.dtype == torch.float32, name
        assert not torch.equal(buf, stats0[name]), name


@pytest.mark.parametrize('lr,stable', [(2.5e-4, False), (5e-5, True)])
def test_parity_lr_keeps_toy_steps_stable(lr, stable):
    """Two runs of the port from the same weights, one of them perturbed
    by about one float32 ulp (relative 1e-7): at the recipe's 2.5e-4 the
    toy's loss rises and the runs' largest param gap grows more than
    fivefold in three steps (and tenfold a step after that); at 5e-5, the
    parity tests' lr, the loss falls and the gap stays under twice its
    start."""
    args = harness.default_args('ssl_mt', **dict(
        MT_ARGS, lr=lr, cons_for_labeled=False))
    runs = [harness.build_algorithm(args, device='cpu',
                                    iters_per_epoch=ITERS_PER_EPOCH)
            for _ in range(2)]
    generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in runs[1].model.parameters():
            p.mul_(1.0 + 1e-7 * torch.randn(p.shape, generator=generator))
        runs[1].teacher.load_state_dict(runs[1].model.state_dict())

    def gap():
        return max(float((a - b).abs().max()) for a, b in zip(
            runs[0].model.parameters(), runs[1].model.parameters()))

    with torch.no_grad():
        gap0 = gap()
    batch = harness.synthetic_batch(args, device='cpu', seed=3)
    losses = []
    for _ in range(N_STEPS):
        losses.append(float(runs[0].train_step(batch)['s_task_loss']))
        runs[1].train_step(batch)
    with torch.no_grad():
        growth = gap() / gap0
    if stable:
        assert growth < 2.0 and losses[-1] < losses[0], (growth, losses)
    else:
        assert growth > 5.0 and losses[-1] > losses[0], (growth, losses)
