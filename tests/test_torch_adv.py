"""The port's AdvSSL against the JAX package's: the FC discriminator's
forward and criterion, the sseg hooks that feed it (ignore pixels in the
labels), and three full train steps on the same weights (carried across by
``pixelssl_tpu_torch.models.from_jax``) and the same batch.

The steps run at lr 5e-5 for the reason tests/test_torch_mt.py gives.
Tolerances as there: rtol 2e-3 on the losses and the lr, terminal task
params atol 3e-4, BN running statistics atol 1e-4 with rtol 1e-4. The
discriminator's forward atol 1e-4 (float32 sums over conv windows in
another order, tests/test_torch_models.py), its criterion rtol 1e-6.

D's params are held to atol 6 x ``discriminator_lr``: Adam's update is
about ±lr for every element whatever the size of its gradient, so an
element whose gradient is within float32 noise of zero may step the other
way in the other framework, 2 lr apart at most a step, for three steps.
That bound alone would pass a D that never moved (each element moves
about 3 lr in all), so D's update (after minus before) is also held to
JAX's by share: at least 99.9% of the elements within 0.5 lr of JAX's
(measured 99.94% and 99.97% for the two cases), at least 99% within 0.1 lr
(measured 99.59% and 99.81%), and the port's median move at least 1 lr
(measured 2.7 lr). A D step skipped, of the wrong sign or 10% off in
scale fails these. The D losses are held to rtol 2e-4, about three times
the largest gap measured (6.1e-5, ``real_d_loss`` on step 2; below 4e-7 on
step 0, before D has moved): ``real_d_loss`` reads D alone on the GT, so
it sees every D update, and a 1% error in D's lr moves it by about 2e-3
on step 1. D's lr is held to the JAX package's ``d_lr_schedule``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu.models import discriminator as jax_disc
from pixelssl_tpu.tasks.sseg import func as jax_sseg_func

from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models import discriminator
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.tasks.sseg import func as sseg_func

from test_torch_gct import _assert_close, _t
from test_torch_mt import (MT_ARGS, N_STEPS, _jax_and_port,  # noqa: F401
                           one_torch_thread, run_steps)

NUM_CLASSES = 5
D_LR = 1e-4

# the AdvSSL recipe (scripts/deeplabv2_pascalvoc_1-8_ssladv.py) on the
# toy of tests/test_torch_mt.py
ADV_ARGS = dict(
    {k: v for k, v in MT_ARGS.items()
     if k not in ('cons_scale', 'cons_rampup_epochs', 'ema_decay',
                  'gaussian_noise_std')},
    adv_for_labeled=True, labeled_adv_scale=0.01, unlabeled_adv_scale=0.001,
    discriminator_lr=D_LR)
METRIC_KEYS = ('task_loss', 'labeled_adv_loss', 'unlabeled_adv_loss',
               'fake_d_loss', 'real_d_loss', 'lr')
D_LOSS_TOLS = {'fake_d_loss': (2e-4, 0.0), 'real_d_loss': (2e-4, 0.0)}


def _nchw(x):
    return _t(x.transpose(0, 3, 1, 2))


@pytest.mark.parametrize('size', [64, 33])
def test_discriminator_and_criterion_match_jax(size):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, size, size, NUM_CLASSES)).astype(np.float32)
    jmod = jax_disc.FCDiscriminator()
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1),
                                                   jnp.asarray(x)))
    theirs = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    d = discriminator.FCDiscriminator(NUM_CLASSES)
    d.load_state_dict(from_jax(variables))
    with torch.no_grad():
        ours = d(_nchw(x))
    assert ours.shape == (2, 1, size, size)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), theirs,
                               atol=1e-4)

    target = (rng.uniform(0, 1, theirs.shape) > 0.5).astype(np.float32)
    logits = 4.0 * rng.standard_normal(theirs.shape).astype(np.float32)
    np.testing.assert_allclose(
        discriminator.fc_discriminator_criterion(
            _nchw(logits), _nchw(target)).numpy(),
        np.asarray(jax_disc.fc_discriminator_criterion(
            jnp.asarray(logits), jnp.asarray(target))), rtol=1e-6)


def test_adv_hooks_match_jax():
    rng = np.random.default_rng(2)
    gt = rng.integers(0, NUM_CLASSES, (3, 6, 7))
    gt[0, :2] = 255       # ignore_index
    gt[1, 3] = -1         # out of range: an all-zero one-hot pixel
    gt[2, 4, :3] = 255
    cmap = rng.standard_normal((3, 6, 7, 1)).astype(np.float32)
    kw = dict(num_classes=NUM_CLASSES, ignore_index=255)
    ours = sseg_func.SemanticSegmentationFunc(
        harness.default_args('ssl_adv', **kw))
    theirs = jax_sseg_func.SemanticSegmentationFunc(
        jax_harness.default_args('ssl_adv', **kw))
    assert ours.ssladv_fcd_in_channels() == theirs.ssladv_fcd_in_channels()
    assert ours.ssls4l_rc_in_channels() == theirs.ssls4l_rc_in_channels()

    one_hot = ours.ssladv_convert_task_gt_to_fcd_input(_t(gt).long())
    assert one_hot.shape == (3, NUM_CLASSES, 6, 7)
    np.testing.assert_array_equal(
        one_hot.permute(0, 2, 3, 1).numpy(),
        np.asarray(theirs.ssladv_convert_task_gt_to_fcd_input(
            jnp.asarray(gt, jnp.int32))))
    for labels in (gt, None):
        for is_real in (True, False):
            a = ours.ssladv_preprocess_fcd_criterion(
                _nchw(cmap), None if labels is None else _t(labels).long(),
                is_real)
            b = theirs.ssladv_preprocess_fcd_criterion(
                jnp.asarray(cmap),
                None if labels is None else jnp.asarray(labels, jnp.int32),
                is_real)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.permute(0, 2, 3, 1).numpy(),
                                              np.asarray(y))
    # an ignored pixel counts log 2 in the BCE, as in the JAX package
    masked, target = ours.ssladv_preprocess_fcd_criterion(
        _nchw(cmap), _t(gt).long(), True)
    loss = discriminator.fc_discriminator_criterion(masked[:1, :, :2],
                                                    target[:1, :, :2])
    assert float(loss) == pytest.approx(np.log(2.0), rel=1e-6)


@pytest.mark.parametrize('unlabeled_for_discriminator', [False, True])
def test_adv_three_steps_match_jax(unlabeled_for_discriminator):
    rng = np.random.default_rng(13)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port(
        'ssl_adv', dict(ADV_ARGS, unlabeled_for_discriminator=(
            unlabeled_for_discriminator)), rng)
    d_before = {k: v.clone() for k, v in algo.d_model.state_dict().items()}
    final, history = run_steps(jalgo, jstate, jbatch, algo, batch,
                               METRIC_KEYS, D_LOSS_TOLS)
    for h in history:
        for k in METRIC_KEYS[:-1]:
            assert h[k] > 0, (k, h)
    _assert_close(algo.model, final['model'], 3e-4, 1e-4, 'model')
    _assert_close(algo.d_model, final['d_model'], 6 * D_LR, 0, 'd_model')

    d_after = algo.d_model.state_dict()
    theirs = from_jax(final['d_model'])
    ours_move = torch.cat([(d_after[k] - d_before[k]).flatten()
                           for k in theirs])
    gap = (ours_move - torch.cat([(theirs[k] - d_before[k]).flatten()
                                  for k in theirs])).abs()
    assert float((gap <= 0.5 * D_LR).float().mean()) >= 0.999
    assert float((gap <= 0.1 * D_LR).float().mean()) >= 0.99
    assert float(ours_move.abs().median()) >= D_LR
    assert [g['lr'] for g in algo.d_opt.param_groups] == pytest.approx(
        [float(jalgo.d_lr_schedule(N_STEPS - 1))], rel=1e-6)
