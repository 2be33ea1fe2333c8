"""The port's S4L against the JAX package's: ``rotate_batch`` on NCHW
images and [N,H,W] labels for every angle, the rotation head's forward,
the wrapped model's weights and lr groups, and three full train steps on
the same weights (carried across by ``pixelssl_tpu_torch.models.from_jax``),
the same batch and the JAX package's own angles.

The rotations are index moves and must be equal. The head's forward atol
1e-4 and its BN running statistics atol 1e-5, as
tests/test_torch_models.py holds the task model's. The steps run at lr
5e-5 for the reason tests/test_torch_mt.py gives, with its tolerances:
rtol 2e-3 on the losses and the lr, terminal params atol 3e-4, BN running
statistics atol 1e-4 with rtol 1e-4. ``rotation_acc`` counts argmax hits
over 8 samples and must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu.models import rotation as jax_rotation
from pixelssl_tpu.ssl_algorithm import ssl_s4l as jax_s4l

from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.models.rotation import RotationClassifier
from pixelssl_tpu_torch.ssl_algorithm import ssl_s4l

from test_torch_adv import ADV_ARGS
from test_torch_gct import _assert_close, _t
from test_torch_mt import (_jax_and_port, one_torch_thread,  # noqa: F401
                           run_steps)

NUM_CLASSES = 5

S4L_ARGS = dict(
    {k: v for k, v in ADV_ARGS.items()
     if 'adv' not in k and 'discriminator' not in k},
    rotated_sup_scale=0.1, rotation_scale=0.1)
METRIC_KEYS = ('unrotated_task_loss', 'rotated_task_loss', 'rotation_loss',
               'rotation_acc', 'lr')


def test_rotate_batch_matches_jax_for_every_angle():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((8, 7, 7, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (8, 7, 7))
    angles = np.array([0, 1, 2, 3, 3, 2, 1, 0])
    theirs_img = np.asarray(jax_s4l.rotate_batch(jnp.asarray(images),
                                                 jnp.asarray(angles)))
    theirs_gt = np.asarray(jax_s4l.rotate_batch(jnp.asarray(labels),
                                                jnp.asarray(angles)))
    ours_img = ssl_s4l.rotate_batch(_t(images.transpose(0, 3, 1, 2)),
                                    _t(angles), (2, 3))
    ours_gt = ssl_s4l.rotate_batch(_t(labels), _t(angles), (1, 2))
    np.testing.assert_array_equal(ours_img.permute(0, 2, 3, 1).numpy(),
                                  theirs_img)
    np.testing.assert_array_equal(ours_gt.numpy(), theirs_gt)
    # angle 1 is a quarter turn clockwise, as torch.rot90 counts it (-1)
    np.testing.assert_array_equal(ours_gt[1].numpy(),
                                  np.rot90(labels[1], k=-1))


@pytest.mark.parametrize('train', [True, False])
def test_rotation_classifier_matches_jax(train):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 16, NUM_CLASSES)).astype(np.float32)
    jmod = jax_rotation.RotationClassifier()
    variables = jax.tree.map(np.asarray, jmod.init(
        jax.random.PRNGKey(2), jnp.asarray(x), train=False))
    variables['batch_stats'] = jax.tree.map(
        lambda v: (v + rng.uniform(0.2, 0.8, v.shape)).astype(np.float32),
        variables['batch_stats'])
    rc = RotationClassifier(NUM_CLASSES)
    rc.load_state_dict(from_jax(variables))
    rc.train(train)
    with torch.no_grad():
        ours = rc(_t(x.transpose(0, 3, 1, 2)))
    assert ours.shape == (4, 4) and ours.dtype == torch.float32
    if train:
        theirs, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                                     mutable=['batch_stats'])
        _assert_close(rc, dict(variables, batch_stats=jax.tree.map(
            np.asarray, mutated['batch_stats'])), 0, 1e-5, 'rc')
    else:
        theirs = jmod.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4)


def _jax_angles(jalgo, jstate, bs, steps):
    """The angles of the JAX step ``s`` for each ``s``: its
    ``_double_batch`` draws from ``_step_rng``, the state's key folded with
    ``step * 131`` and then with the device index, 0 on one device."""
    key = jstate['rng']
    return [np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.fold_in(key, s * 131), 0),
        (bs,), 1, 4)) for s in range(steps)]


def test_s4l_three_steps_match_jax():
    rng = np.random.default_rng(14)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port('ssl_s4l', S4L_ARGS,
                                                       rng)
    bs = S4L_ARGS['batch_size']
    angles = _jax_angles(jalgo, jstate, bs, 3)
    assert {int(a) for a in np.concatenate(angles)} <= {1, 2, 3}
    algo._draw_angles = lambda n: torch.tensor(angles[algo.state.step],
                                               dtype=torch.long)

    names = [n for n, _ in algo.model.named_parameters()]
    assert any(n.startswith('rc.fc.') for n in names)
    groups = {g['lr_mult']: g['params'] for g in algo.opt.param_groups}
    assert sorted(groups) == [1.0, 10.0]
    by_id = dict((id(p), n) for n, p in algo.model.named_parameters())
    assert all(by_id[id(p)].startswith('task.net.classifier')
               for p in groups[10.0])

    final, history = run_steps(jalgo, jstate, jbatch, algo, batch,
                               METRIC_KEYS, {'rotation_acc': (0, 0)})
    for h in history:
        for k in METRIC_KEYS[:3]:
            assert h[k] > 0, (k, h)
    _assert_close(algo.model, final['model'], 3e-4, 1e-4, 'model')
