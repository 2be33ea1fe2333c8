"""The port's GCT against the JAX package's: the pipeline functions on
shared numpy inputs, and two full train steps on the same weights (carried
across by ``pixelssl_tpu_torch.models.from_jax``) and the same batch.

96 px, not 64: at 64 px the flaw detector's conv chain collapses to a 1x1
map, and the min-max normalisation turns last-ulp noise into O(1) mask
flips between the frameworks (tests/test_gct_torch_parity.py:30-41).

Tolerances, as tests/test_gct_torch_parity.py states them: rtol 2e-3 on the
task and FD losses (threshold-free); rtol 2e-2 on fc/dc, which pass hard
thresholds on blurred, normalised flawmaps where a pixel within float32
noise of the threshold can flip; terminal params atol 3e-4 (task models)
and 5e-4 (FD); BN running statistics atol 1e-4, the FD's included, with
rtol 1e-4 beside it: the running variances of the deep layers reach O(3)
here, and the JAX package takes the batch variance as E[x^2] - E[x]^2 in
float32, which cancels, where PyTorch does not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel
from pixelssl_tpu.ssl_algorithm import ssl_gct as jax_gct

from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.ssl_algorithm import ssl_gct

IM = 96
BATCH = 4
LBS = 2
NUM_CLASSES = 5
N_STEPS = 2
ITERS_PER_EPOCH = 10

GCT_ARGS = dict(
    backbone='resnet10', im_size=IM, num_classes=NUM_CLASSES,
    batch_size=BATCH, unlabeled_batch_size=BATCH - LBS,
    ignore_unlabeled=False, bf16=False, lr=2.5e-4, momentum=0.9,
    weight_decay=5e-4, power=0.9, epochs=2, ssl_mode='gct',
    fc_ssl_scale=2.0, dc_ssl_scale=1.5, dc_threshold=0.5,
    dc_rampup_epochs=1, fd_lr=1e-4, fd_scale=10.0, mu=0.5, nu=1)

METRIC_KEYS = ('l_task_loss', 'r_task_loss', 'l_fc_loss', 'r_fc_loss',
               'l_dc_loss', 'r_dc_loss', 'l_fd_loss', 'r_fd_loss', 'lr')


def _smooth_maps(rng, n, c):
    """Maps with spatial structure: upsampled noise."""
    coarse = rng.standard_normal((n, IM // 8, IM // 8, c)).astype(np.float32)
    return np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_flawmap_handler_matches_jax():
    fm = _smooth_maps(np.random.default_rng(0), 3, 1)
    fm[2] *= 0.01  # max <= 0.1: the clip zeroes this map
    ours = ssl_gct.flawmap_handler(_t(fm), IM)
    theirs = jax_gct.flawmap_handler(jnp.asarray(fm), IM)
    assert ours.shape == (3, IM, IM, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def test_dcgt_generator_matches_jax():
    rng = np.random.default_rng(1)
    l_pred = rng.uniform(0, 1, (2, IM, IM, NUM_CLASSES)).astype(np.float32)
    r_pred = rng.uniform(0, 1, (2, IM, IM, NUM_CLASSES)).astype(np.float32)
    l_fm = rng.uniform(0, 1, (2, IM, IM, 1)).astype(np.float32)
    r_fm = rng.uniform(0, 1, (2, IM, IM, 1)).astype(np.float32)
    ours = ssl_gct.dcgt_generator(_t(l_pred), _t(r_pred), _t(l_fm), _t(r_fm),
                                  0.6)
    theirs = jax_gct.dcgt_generator(jnp.asarray(l_pred), jnp.asarray(r_pred),
                                    jnp.asarray(l_fm), jnp.asarray(r_fm), 0.6)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dilate3x3_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 17, 23, 1)).astype(
        np.float32)
    np.testing.assert_array_equal(ssl_gct._dilate3x3(_t(x)).numpy(),
                                  np.asarray(jax_gct._dilate3x3(jnp.asarray(x))))


@pytest.mark.parametrize('nu', [0, 1, 2])
def test_fdgt_generator_matches_jax(nu):
    rng = np.random.default_rng(3 + nu)
    pred = rng.uniform(0, 1, (2, IM, IM, NUM_CLASSES)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (2, IM, IM))
    gt = np.eye(NUM_CLASSES, dtype=np.float32)[labels]
    ours = ssl_gct.fdgt_generator(_t(pred), _t(gt), IM, 0.5, nu)
    theirs = jax_gct.fdgt_generator(jnp.asarray(pred), jnp.asarray(gt), IM,
                                    0.5, nu)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def test_synthetic_batch_matches_jax():
    args = harness.default_args('ssl_gct', **GCT_ARGS)
    jargs = jax_harness.default_args('ssl_gct', **GCT_ARGS)
    ours = harness.synthetic_batch(args, device='cpu', seed=5)
    theirs = jax.device_get(jax_harness.synthetic_batch(
        jargs, parallel.make_mesh(1), seed=5))
    np.testing.assert_array_equal(ours['inp'][0].permute(0, 2, 3, 1).numpy(),
                                  np.asarray(theirs['inp'][0]))
    np.testing.assert_array_equal(ours['gt'][0].numpy(),
                                  np.asarray(theirs['gt'][0]))


def _perturb_stats(stats, rng):
    def leaf(path, x):
        if path[-1].key == 'mean':
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


def _assert_close(module, variables, atol_params, atol_stats, what):
    ours = module.state_dict()
    theirs = from_jax(variables)
    assert set(ours) == set(theirs), what
    for key, value in theirs.items():
        if key.endswith('num_batches_tracked'):
            continue
        stat = 'running_' in key
        np.testing.assert_allclose(ours[key].numpy(), value.numpy(),
                                   atol=atol_stats if stat else atol_params,
                                   rtol=1e-4 if stat else 0,
                                   err_msg=what + ' ' + key)


def test_gct_two_steps_match_jax():
    rng = np.random.default_rng(11)
    images = rng.standard_normal((BATCH, IM, IM, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (BATCH, IM, IM)).astype(np.int32)
    labels[:LBS, :4, :4] = 255
    labels[LBS:] = -1

    jargs = jax_harness.default_args('ssl_gct', **GCT_ARGS)
    mesh = parallel.make_mesh(1)
    jalgo = jax_harness.build_algorithm(jargs, mesh=mesh,
                                        iters_per_epoch=ITERS_PER_EPOCH)
    state = jax.tree.map(np.asarray, jax.device_get(jalgo.state))
    for key in ('l_model', 'r_model', 'fd_model'):
        state[key]['batch_stats'] = _perturb_stats(state[key]['batch_stats'],
                                                   rng)

    args = harness.default_args('ssl_gct', **GCT_ARGS)
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS_PER_EPOCH)
    modules = {'l_model': algo.l_model, 'r_model': algo.r_model,
               'fd_model': algo.fd_model}
    for key, module in modules.items():
        module.load_state_dict(from_jax(state[key]))

    jstate = jax.device_put(state, parallel.replicate_sharding(mesh))
    jbatch = parallel.shard_batch({'inp': (images,), 'gt': (labels,)}, mesh)
    batch = {'inp': (_t(images.transpose(0, 3, 1, 2)),),
             'gt': (_t(labels).long(),)}

    for s in range(N_STEPS):
        jstate, jmetrics = jalgo._train_step(jstate, jbatch)
        metrics = algo.train_step(batch)
        for k in METRIC_KEYS:
            a, b = float(metrics[k]), float(np.asarray(jmetrics[k]))
            tol = 2e-3 if ('task' in k or 'fd' in k or k == 'lr') else 2e-2
            assert np.isclose(a, b, rtol=tol, atol=1e-6), (s, k, a, b)
    assert algo.state.step == N_STEPS

    final = jax.tree.map(np.asarray, jax.device_get(jstate))
    _assert_close(algo.l_model, final['l_model'], 3e-4, 1e-4, 'l_model')
    _assert_close(algo.r_model, final['r_model'], 3e-4, 1e-4, 'r_model')
    _assert_close(algo.fd_model, final['fd_model'], 5e-4, 1e-4, 'fd_model')
