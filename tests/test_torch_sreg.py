"""The port's pixel-regression task (``sreg``) against the JAX package's:
the synthetic samples (bit for bit), ``unet_lite``'s forward, the masked
MSE criterion, the validation metrics over padded pixels, three train
steps of each algorithm that supports REGRESSION, the refusal of the
classification-only ones, and the port's demo script.

The steps run ``unet_lite`` at base 8 and 64 px (GCT at 96 px, below),
float32, batch 2 + 2 (4 + 0 for SupOnly), with SGD at lr 1e-2, momentum
0.9 and the gradients clipped to norm 5; the demo script's Adam is held to
optax in tests/test_torch_optim.py. Adam is not used here: its first
updates are ``lr * sign(g)``, so a gradient that is 0 up to float32 noise
(a conv bias before BN, S4L's rotation head) moves its parameter by
``lr`` one way or the other in each package. GCT runs at 96 px, as
tests/test_torch_gct.py does: at 64 px the flaw detector's map collapses
to a few pixels, and the min-max normalisation turns last-ulp noise into
O(1) flips of its masks (the fc loss of step 0 differs tenfold between
the packages there). The two packages start from the same
weights (``models.convert.from_jax``), BN running statistics perturbed
away from their init, and take the same batch; S4L's angles are the JAX
package's own draws, and MT runs without input noise, whose draws the
packages cannot share (tests/test_torch_mt.py checks the noise on JAX's
draws). Tolerances, as tests/test_torch_gct.py states them: rtol 2e-3 on
the task, D and FD losses and the lr, rtol 2e-2 on GCT's thresholded
fc/dc losses and on MT's ``cons_loss`` (atol 1e-9 there); terminal params
atol 3e-4 (5e-4 for the FD and D), BN running statistics atol 1e-4 with
rtol 1e-4. The forward atol 1e-5 and the criterion rtol 1e-6: a net of
six small convolutions in float32.
"""

import collections
import os
import runpy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel
from pixelssl_tpu.tasks import sreg as jax_sreg

import pixelssl_tpu_torch
from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.tasks import sreg
from pixelssl_tpu_torch.utils import logger

from test_torch_gct import _assert_close, _perturb_stats, _t
from test_torch_mt import one_torch_thread  # noqa: F401
from test_torch_s4l import _jax_angles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IM = 64
BASE = 8
N_STEPS = 3
ITERS_PER_EPOCH = 4

COMMON = dict(task='sreg', base_channels=BASE, im_size=IM, bf16=False,
              batch_size=4, unlabeled_batch_size=2, ignore_unlabeled=False,
              epochs=2, models={'model': 'unet_lite'},
              optimizers={'model': 'sgd'}, lrers={'model': 'polynomiallr'},
              criterions={'model': 'sreg_criterion'}, lr=1e-2, momentum=0.9,
              weight_decay=0.0, clip_grad_norm=5.0)
GCT_IM = 96
ALGOS = {
    'ssl_null': (dict(unlabeled_batch_size=0, ignore_unlabeled=True),
                 ('task_loss', 'lr')),
    'ssl_mt': (dict(cons_scale=1.0, cons_rampup_epochs=1, ema_decay=0.99,
                    cons_for_labeled=True),
               ('s_task_loss', 't_task_loss', 'cons_loss', 'lr')),
    'ssl_adv': (dict(adv_for_labeled=True, labeled_adv_scale=0.01,
                     unlabeled_adv_scale=0.001,
                     unlabeled_for_discriminator=True),
                ('task_loss', 'labeled_adv_loss', 'unlabeled_adv_loss',
                 'fake_d_loss', 'real_d_loss', 'lr')),
    'ssl_gct': (dict(ssl_mode='gct', fc_ssl_scale=1.0, dc_ssl_scale=1.0,
                     dc_threshold=0.4, dc_rampup_epochs=1, mu=0.5, nu=1,
                     fd_scale=1.0),
                ('l_task_loss', 'r_task_loss', 'l_fc_loss', 'r_fc_loss',
                 'l_dc_loss', 'r_dc_loss', 'l_fd_loss', 'r_fd_loss', 'lr')),
    'ssl_s4l': (dict(rotated_sup_scale=0.5, rotation_scale=1.0),
                ('unrotated_task_loss', 'rotated_task_loss', 'rotation_loss',
                 'rotation_acc', 'lr')),
}
LOOSE = {'cons_loss': (2e-2, 1e-9), 'l_fc_loss': (2e-2, 1e-6),
         'r_fc_loss': (2e-2, 1e-6), 'l_dc_loss': (2e-2, 1e-6),
         'r_dc_loss': (2e-2, 1e-6), 'rotation_acc': (0.0, 0.0)}


def _args(package_harness, algo_name, **overrides):
    flags, _ = ALGOS[algo_name]
    return package_harness.default_args(algo_name, **dict(COMMON, **dict(
        flags, **overrides)))


def _dataset_args(root, **overrides):
    import types
    base = dict(trainset={'synthetic_sreg': [root]},
                valset={'synthetic_sreg': [root]}, im_size=24,
                synthetic_samples=6, noise_std=0.05, seed=3)
    base.update(overrides)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize('is_train', [True, False])
@pytest.mark.parametrize('root', ['/tmp', '/tmp/u'])
def test_samples_equal_the_jax_datasets(root, is_train):
    from pixelssl_tpu.tasks.sreg.data import SyntheticSregDataset as Jax
    from pixelssl_tpu_torch.tasks.sreg.data import SyntheticSregDataset

    ours = SyntheticSregDataset(_dataset_args(root), is_train)
    theirs = Jax(_dataset_args(root), is_train)
    ours.set_num_labeled(4)
    theirs.set_num_labeled(4)
    assert ours.sample_list == theirs.sample_list
    for idx in range(6):
        (a_img,), (a_gt,) = ours[(idx, 2)]
        (b_img,), (b_gt,) = theirs[idx]
        assert a_img.dtype == b_img.dtype == np.float32
        assert a_gt.shape == (24, 24, 1)
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_gt, b_gt)
        assert (a_gt == 0).all() == (idx >= 4)


def _model_pair(rng):
    # spatial_train: the JAX model's BN reduces over the batch it sees,
    # outside a mesh
    jargs = jax_harness.default_args('ssl_null', spatial_train=1, **COMMON)
    jmodel = jax_sreg.model.UNetLiteModel(jargs)
    variables = jax.tree.map(np.asarray, jax.device_get(jmodel.module.init(
        jax.random.PRNGKey(1), (jnp.zeros((1, IM, IM, 3)),), train=False)))
    variables['batch_stats'] = _perturb_stats(variables['batch_stats'], rng)
    model = sreg.model.UNetLiteModel(harness.default_args('ssl_null',
                                                          **COMMON))
    model.load_state_dict(from_jax(variables))
    return jmodel, variables, model


@pytest.mark.parametrize('train', [True, False])
def test_unet_lite_forward_matches_jax(train):
    rng = np.random.default_rng(2)
    jmodel, variables, model = _model_pair(rng)
    names = [n for n, _ in model.named_parameters()]
    assert names[:2] == ['net.blocks.0.conv.weight', 'net.blocks.0.bn.weight']
    groups = model.param_groups()
    assert [g['lr_mult'] for g in groups] == [1.0, 10.0]
    assert len(groups[1]['params']) == 2  # the head's weight and bias
    x = rng.standard_normal((3, IM - 2, IM + 6, 3)).astype(np.float32)
    model.train(train)
    with torch.no_grad():
        ours = model((_t(x.transpose(0, 3, 1, 2)),))
    if train:
        theirs, mutated = jmodel.module.apply(
            variables, (jnp.asarray(x),), train=True, mutable=['batch_stats'])
        _assert_close(model, dict(variables, batch_stats=jax.tree.map(
            np.asarray, mutated['batch_stats'])), 0, 1e-5, 'unet_lite')
    else:
        theirs = jmodel.module.apply(variables, (jnp.asarray(x),),
                                     train=False)
    for key in ('pred', 'activated_pred'):
        np.testing.assert_allclose(
            ours[key][0].permute(0, 2, 3, 1).numpy(),
            np.asarray(theirs[key][0]), atol=1e-5, err_msg=key)
    assert ours['ssls4l_rc_inp'].shape == (3, 4 * BASE, 16, 18)
    np.testing.assert_allclose(
        ours['ssls4l_rc_inp'].permute(0, 2, 3, 1).numpy(),
        np.asarray(theirs['ssls4l_rc_inp']), atol=1e-5)


def _pred_and_gt(rng, n=3, size=20):
    pred = rng.standard_normal((n, size, size, 1)).astype(np.float32)
    gt = rng.uniform(0, 1, (n, size, size, 1)).astype(np.float32)
    gt[0, :5] = 255.0
    gt[2] = 255.0  # a padded sample: no valid pixel
    return pred, gt


def test_criterion_and_metrics_match_jax():
    """The masked MSE per sample, and the metrics accumulated over two
    batches with ignored pixels, against the JAX task's."""
    from pixelssl_tpu.utils.logger import AvgMeterSet as JaxMeters
    from pixelssl_tpu_torch.utils.logger import AvgMeterSet

    rng = np.random.default_rng(3)
    args = harness.default_args('ssl_null', **COMMON)
    jargs = jax_harness.default_args('ssl_null', **COMMON)
    crit = sreg.criterion.sreg_criterion()(args)
    jcrit = jax_sreg.criterion.sreg_criterion()(jargs)
    func = sreg.func.task_func()(args)
    jfunc = jax_sreg.func.task_func()(jargs)
    meters, jmeters = AvgMeterSet(), JaxMeters()
    for _ in range(2):
        pred, gt = _pred_and_gt(rng)
        nchw = [_t(a.transpose(0, 3, 1, 2)) for a in (pred, gt)]
        ours = crit((nchw[0],), (nchw[1],), (nchw[0],))
        theirs = jcrit((jnp.asarray(pred),), (jnp.asarray(gt),),
                       (jnp.asarray(pred),))
        assert ours.shape == (3,) and float(ours[2]) == 0.0
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6)
        act = 1.0 / (1.0 + np.exp(-pred))
        func.metrics((_t(act.transpose(0, 3, 1, 2)),), (nchw[1],), None,
                     meters, id_str='m')
        jfunc.metrics((jnp.asarray(act),), (jnp.asarray(gt),), None,
                      jmeters, id_str='m')
    keys = sorted(k for k in jmeters.keys() if 'metric' in k)
    assert keys == sorted(k for k in meters.keys() if 'metric' in k)
    assert len(keys) == 3
    for key in keys:
        np.testing.assert_allclose(meters[key].val, jmeters[key].val,
                                   rtol=1e-5, err_msg=key)
    assert float(meters['m_err_sums'].sum[2]) == 2 * (3 * 400 - 100 - 400)
    assert func.ssls4l_rc_in_channels() == 4 * BASE
    assert func.sslgct_fd_in_channels() == 4
    assert func.ssladv_fcd_in_channels() == 1


def _config(out, algo, **overrides):
    cfg = collections.OrderedDict([
        ('exp_id', 'sreg_' + algo), ('out_path', str(out)),
        ('ssl_algorithm', algo),
        ('trainset', {'synthetic_sreg': ['/tmp']}),
        ('valset', {'synthetic_sreg': ['/tmp']}),
        ('num_workers', 0), ('im_size', 32), ('synthetic_samples', 8),
        ('epochs', 1),
        ('unlabeledset', {'synthetic_sreg': ['/tmp/u']}),
        ('ignore_unlabeled', False),
        ('models', {'model': 'unet_lite'}),
        ('optimizers', {'model': 'adam'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sreg_criterion'}),
        ('base_channels', BASE), ('lr', 1e-3), ('bf16', False),
    ])
    cfg.update(overrides)
    return cfg


def test_validation_padding_never_scores(tmp_path):
    """At 36 px the validation loader pads each sample to 64 with GT 255.0:
    the metrics count exactly 6 x 36 x 36 valid pixels (JAX
    tests/test_task_sreg.py:148)."""
    proxy = pixelssl_tpu_torch.run_script(
        _config(tmp_path, 'ssl_null', validation=True, im_size=36,
                synthetic_samples=6, unlabeled_batch_size=0,
                ignore_unlabeled=True, unlabeledset={}),
        sreg, sreg.PixelRegressionProxy, device='cpu', cli_override=False)
    meters = proxy.ssl_algorithm.meters
    assert float(meters['ssl_null_err_sums'].sum[2]) == 6 * 36 * 36
    scores = {k: meters[k].val for k in meters.keys() if 'metric' in k}
    assert sorted(scores) == ['ssl_null_metric_mae', 'ssl_null_metric_mse',
                              'ssl_null_metric_psnr']
    assert all(np.isfinite(v) for v in scores.values())


def _jax_and_port(algo_name, rng):
    im = GCT_IM if algo_name == 'ssl_gct' else IM
    images = rng.standard_normal((4, im, im, 3)).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (4, im, im, 1)).astype(np.float32)
    jargs = _args(jax_harness, algo_name, im_size=im)
    args = _args(harness, algo_name, im_size=im)
    gt[args.labeled_batch_size:] = 0.0
    mesh = parallel.make_mesh(1)
    jalgo = jax_harness.build_algorithm(jargs, mesh=mesh,
                                        iters_per_epoch=ITERS_PER_EPOCH)
    state = jax.tree.map(np.asarray, jax.device_get(jalgo.state))
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS_PER_EPOCH)
    for key, module in algo.modules.items():
        if 'batch_stats' in state[key]:
            state[key]['batch_stats'] = _perturb_stats(
                state[key]['batch_stats'], rng)
        module.load_state_dict(from_jax(state[key]))
    jstate = jax.device_put(state, parallel.replicate_sharding(mesh))
    jbatch = parallel.shard_batch({'inp': (images,), 'gt': (gt,)}, mesh)
    batch = {'inp': (_t(images.transpose(0, 3, 1, 2)),),
             'gt': (_t(gt.transpose(0, 3, 1, 2)),)}
    return jalgo, jstate, jbatch, algo, batch


@pytest.mark.parametrize('algo_name', sorted(ALGOS))
def test_three_steps_match_jax(algo_name):
    rng = np.random.default_rng(31)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port(algo_name, rng)
    if algo_name == 'ssl_s4l':
        angles = _jax_angles(jalgo, jstate, 4, N_STEPS)
        algo._draw_angles = lambda n: torch.tensor(angles[algo.state.step],
                                                   dtype=torch.long)
    _, keys = ALGOS[algo_name]
    for s in range(N_STEPS):
        jstate, jmetrics = jalgo._train_step(jstate, jbatch)
        metrics = algo.train_step(batch)
        for k in keys:
            a, b = float(metrics[k]), float(np.asarray(jmetrics[k]))
            rtol, atol = LOOSE.get(k, (2e-3, 1e-6))
            assert np.isclose(a, b, rtol=rtol, atol=atol), (s, k, a, b)
            assert np.isfinite(a), (s, k)
    final = jax.tree.map(np.asarray, jax.device_get(jstate))
    for key, module in algo.modules.items():
        atol = 5e-4 if key in ('fd_model', 'd_model') else 3e-4
        _assert_close(module, final[key], atol, 1e-4, key)


@pytest.mark.parametrize('algo_name,flags', [
    ('ssl_cct', dict(cons_scale=1.0, cons_rampup_epochs=1, ad_lr_scale=10.0,
                     vat_dec_num=1, drop_dec_num=1)),
    ('ssl_cutmix', dict(cons_scale=1.0, cons_rampup_epochs=1,
                        cons_threshold=0.1, ema_decay=0.99, batch_size=3,
                        unlabeled_batch_size=2)),
])
def test_classification_only_algorithms_are_refused(tmp_path, algo_name,
                                                    flags):
    with pytest.raises(logger.FatalError,
                       match='{0} supports .*classification.* but the task '
                             'is regression'.format(algo_name)):
        pixelssl_tpu_torch.run_script(
            _config(tmp_path, algo_name, **dict(
                dict(batch_size=2, unlabeled_batch_size=1), **flags)), sreg,
            sreg.PixelRegressionProxy, device='cpu', cli_override=False)


def test_demo_script_trains_and_its_rescore_reproduces(tmp_path):
    """The port's demo script, one short epoch on the CPU (24 samples), then
    ``--rescore`` of its checkpoint: the same val scores."""
    script = os.path.join(REPO, 'pixelssl_tpu_torch', 'scripts',
                          'sreg_synthetic_sslmt.py')
    demo = runpy.run_path(script)
    config = demo['make_config']('ssl_mt', str(tmp_path), 1)
    theirs = runpy.run_path(os.path.join(REPO, 'scripts',
                                         'sreg_synthetic_sslmt.py'))
    assert demo['ALGO_FLAGS'] == theirs['ALGO_FLAGS']
    assert (config['optimizers'], config['clip_grad_norm'],
            config['base_channels']) == ({'model': 'adam'}, 5.0, 32)

    import sys
    from unittest import mock
    with mock.patch.object(sys, 'argv', ['x']):
        proxy = demo['main'](['--cpu', '--epochs', '1', '--out',
                              str(tmp_path)])
    assert proxy.ssl_algorithm.state.step == 64
    trained = {k: proxy.ssl_algorithm.meters[k].val
               for k in proxy.ssl_algorithm.meters.keys() if 'metric' in k}
    assert 0.0 <= trained['student_metric_mse'] <= 1.0
    ckpt = os.path.join(str(tmp_path), 'sreg_demo', 'ckpt',
                        'checkpoint_1.pth')
    rescored = demo['main'](['--cpu', '--epochs', '1', '--out',
                             str(tmp_path), '--rescore', ckpt])
    for key, value in trained.items():
        assert rescored.ssl_algorithm.meters[key].val == value, key
