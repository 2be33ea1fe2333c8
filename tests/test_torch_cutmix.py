"""The port's CutMix against the JAX package's: ``box_masks`` rasterised
from the JAX package's own uniform draws, the port's own draw, three full
train steps on the same weights (carried across by
``pixelssl_tpu_torch.models.from_jax``), the same batch and the JAX
package's masks, and the validation of student and teacher after them.

The steps use the PSPNet 1-8 recipe's flags (``cons_scale`` 20,
``cons_rampup_epochs`` 0, ``mask_prop_range`` 0.5) with ``cons_threshold``
0.05, so that the confidence, and with it the consistency term, is not 0
at this toy's random init. They run at lr 5e-5 for the reason
tests/test_torch_mt.py gives, with its tolerances: rtol 2e-3 on the task
loss and the lr; ``cons_loss`` rtol 2e-2 and atol 1e-9 (an MSE of two
near predictions times a thresholded pixel count); terminal params atol
3e-4; BN running statistics atol 1e-4 with rtol 1e-4, the teacher's
included. Validation as tests/test_torch_eval.py holds it: losses rtol
2e-3, scores atol 1e-3. The masks are index comparisons and must be equal.
"""

import numpy as np
import pytest
import torch

import jax

from pixelssl_tpu import parallel
from pixelssl_tpu.ops import boxmask as jax_boxmask

from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.ops import boxmask

from test_torch_adv import ADV_ARGS
from test_torch_eval import _val_batches
from test_torch_gct import _assert_close
from test_torch_mt import (_jax_and_port, one_torch_thread,  # noqa: F401
                           run_steps)

CUTMIX_ARGS = dict(
    {k: v for k, v in ADV_ARGS.items()
     if 'adv' not in k and 'discriminator' not in k},
    cons_scale=20.0, cons_rampup_epochs=0, cons_threshold=0.05,
    ema_decay=0.99, mask_prop_range=(0.5, 0.5))


def _jax_draws(key, n, prop_range):
    """The uniforms ``pixelssl_tpu.ops.boxmask.box_masks`` draws from
    ``key``, in its order."""
    k_prop, k_aspect, k_pos = jax.random.split(key, 3)
    props = jax.random.uniform(k_prop, (n,), minval=prop_range[0],
                               maxval=prop_range[1])
    return tuple(torch.from_numpy(np.array(x)) for x in (
        props, jax.random.uniform(k_aspect, (n,)),
        jax.random.uniform(k_pos, (n, 2))))


@pytest.mark.parametrize('shape,prop_range', [
    ((64, 64), (0.5, 0.5)), ((33, 47), (0.1, 0.9)), ((20, 20), (0.0, 0.0))])
def test_box_masks_match_jax_on_its_draws(shape, prop_range):
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        theirs = np.asarray(jax_boxmask.box_masks(key, 6, shape, prop_range,
                                                  invert=True))
        ours = boxmask.box_masks_from_uniforms(
            *_jax_draws(key, 6, prop_range), shape)
        assert ours.shape == (6, 1) + shape and ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(),
                                      theirs)


def test_box_masks_draw():
    """The port's own draw: one box a mask, inside the bounds, its area
    half the map's within the rounding of its sides; the same generator
    seed gives the same masks."""
    h, w = 40, 56
    masks = boxmask.box_masks(torch.Generator().manual_seed(3), 16, (h, w),
                              (0.5, 0.5))
    again = boxmask.box_masks(torch.Generator().manual_seed(3), 16, (h, w),
                              (0.5, 0.5))
    assert torch.equal(masks, again)
    for m in masks[:, 0]:
        rows = m.amax(dim=1).nonzero()[:, 0]
        cols = m.amax(dim=0).nonzero()[:, 0]
        box = m[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
        assert bool((box == 1).all()) and float(m.sum()) == box.numel()
        assert abs(box.numel() - 0.5 * h * w) <= (h + w) / 2 + 1


def _jax_masks(jstate, n, shape, prop_range, steps):
    """The masks of the JAX step ``s`` for each ``s``, NCHW: its
    ``_step_fn`` draws from ``_step_rng``, the state's key folded with
    ``step * 131`` and then with the device index, 0 on one device."""
    out = []
    for s in range(steps):
        key = jax.random.fold_in(jax.random.fold_in(jstate['rng'], s * 131),
                                 0)
        out.append(torch.from_numpy(np.array(jax_boxmask.box_masks(
            key, n, shape, prop_range, invert=True)).transpose(0, 3, 1, 2)))
    return out


def test_cutmix_three_steps_match_jax():
    rng = np.random.default_rng(15)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port('ssl_cutmix',
                                                       CUTMIX_ARGS, rng)
    im = CUTMIX_ARGS['im_size']
    half = CUTMIX_ARGS['unlabeled_batch_size'] // 2
    masks = _jax_masks(jstate, half, (im, im),
                       CUTMIX_ARGS['mask_prop_range'], 3)
    algo._draw_masks = lambda n, shape: masks[algo.state.step]
    teacher_stats0 = {k: v.clone() for k, v in algo.teacher.named_buffers()}

    final, history = run_steps(jalgo, jstate, jbatch, algo, batch,
                               ('task_loss', 'cons_loss', 'lr'),
                               {'cons_loss': (2e-2, 1e-9)})
    for h in history:
        assert h['task_loss'] > 0 and h['cons_loss'] > 0, h
    _assert_close(algo.model, final['model'], 3e-4, 1e-4, 'student')
    _assert_close(algo.teacher, final['teacher'], 3e-4, 1e-4, 'teacher')
    moved = [k for k, v in algo.teacher.named_buffers()
             if 'running' in k and not torch.equal(v, teacher_stats0[k])]
    assert moved, 'the teacher\'s BN statistics did not move'

    ours_batches, jax_batches = _val_batches(algo.args)
    mesh = parallel.make_mesh(1)
    jalgo.state = jax.device_put(final, parallel.replicate_sharding(mesh))
    ours = algo.validate(ours_batches, epoch=1)
    theirs = jalgo.validate(jax_batches, epoch=1)
    assert set(ours) == set(theirs) == {
        '{0}_metric_{1}'.format(i, m) for i in ('student', 'teacher')
        for m in ('acc', 'acc_class', 'mIoU', 'fwIoU')}
    for key in ours:
        assert ours[key] == pytest.approx(float(theirs[key]), abs=1e-3), key
    for key in ('student_loss', 'teacher_loss'):
        assert algo.meters[key].avg == pytest.approx(
            float(jalgo.meters[key].avg), rel=2e-3), key


def test_cutmix_bf16_ema_teacher():
    """``--bf16-ema``: the teacher's parameters are stored in bf16, its BN
    statistics stay float32 and move with its own forward on the unlabeled
    rows; after step 0 (decay 0) the teacher is the student rounded to
    bf16."""
    args = harness.default_args('ssl_cutmix', **dict(
        CUTMIX_ARGS, im_size=32, bf16_ema=True))
    algo = harness.build_algorithm(args, device='cpu', iters_per_epoch=2)
    stats0 = {k: v.clone() for k, v in algo.teacher.named_buffers()}
    metrics = algo.train_step(harness.synthetic_batch(args, device='cpu',
                                                      seed=1))
    assert float(metrics['cons_loss']) > 0
    for (name, t), s in zip(algo.teacher.named_parameters(),
                            algo.model.parameters()):
        assert t.dtype == torch.bfloat16, name
        assert torch.equal(t, s.detach().to(torch.bfloat16)), name
    for name, buf in algo.teacher.named_buffers():
        if buf.is_floating_point():
            assert buf.dtype == torch.float32, name
        assert not torch.equal(buf, stats0[name]), name
