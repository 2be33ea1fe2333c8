"""The port's validation and checkpoints: the confusion matrix and scores
against ``pixelssl_tpu.ops.confusion``, ``validate`` against the JAX
package's on the same weights and batches, and checkpoints that round-trip,
resume a run exactly and refuse another algorithm's file.

``validate`` tolerances: losses rtol 2e-3, as the train-step tests; the
scores (acc, acc_class, mIoU, fwIoU) atol 1e-3: they count argmax labels,
and a pixel whose two best classes lie within float32 noise of each other
may take another label in the other framework (one pixel of the 16,384
here moves acc by 6e-5).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel
from pixelssl_tpu.ops import confusion as jax_confusion

from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.ops.confusion import (confusion_matrix,
                                              scores_from_confusion)
from pixelssl_tpu_torch.utils import logger

from test_torch_adv import ADV_ARGS
from test_torch_gct import GCT_ARGS, _perturb_stats
from test_torch_mt import MT_ARGS, one_torch_thread  # noqa: F401
from test_torch_s4l import S4L_ARGS

NUM_CLASSES = 5
IM = 64
ITERS_PER_EPOCH = 2

ALGO_ARGS = {
    'ssl_null': dict(MT_ARGS, unlabeled_batch_size=0),
    'ssl_mt': dict(MT_ARGS, cons_for_labeled=False),
    'ssl_gct': dict(GCT_ARGS, epochs=20),
    'ssl_adv': dict(ADV_ARGS, unlabeled_for_discriminator=True),
    'ssl_s4l': S4L_ARGS,
    'ssl_cutmix': dict(MT_ARGS, cons_threshold=0.05),
}


@pytest.mark.parametrize('ignore_index', [255, 3])
def test_confusion_matrix_matches_jax(ignore_index):
    rng = np.random.default_rng(0)
    gt = rng.integers(0, NUM_CLASSES, (3, 17, 19))
    gt[0, :4] = 255
    gt[1, :, :3] = -1
    gt[2, 5:8] = NUM_CLASSES + 2  # out of range
    pred = rng.integers(0, NUM_CLASSES, gt.shape)
    ours = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt),
                            NUM_CLASSES, ignore_index).numpy()
    theirs = np.asarray(jax_confusion.confusion_matrix(
        jnp.asarray(pred), jnp.asarray(gt), NUM_CLASSES, ignore_index))
    np.testing.assert_array_equal(ours, theirs)
    valid = (gt >= 0) & (gt < NUM_CLASSES) & (gt != ignore_index)
    assert ours.sum() == valid.sum()

    cm = ours.copy()
    cm[1, :] = 0
    cm[:, 1] = 0  # class 1 neither in gt nor in pred: left out of the means
    for m in (ours, cm):
        a = scores_from_confusion(m)
        b = jax_confusion.scores_from_confusion(m)
        assert set(a) == set(b) == {'acc', 'acc_class', 'mIoU', 'fwIoU'}
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-12), k


def _val_batches(args):
    """Two eval batches from ``synthetic_val_batches``, a band of each
    label map at ``ignore_index``, the second batch with a ``valid`` mask;
    returned for the port and, NHWC numpy, for the JAX package."""
    ours = harness.synthetic_val_batches(args, 2, device='cpu', seed=4)
    ours[0]['gt'][0][:, :5] = 255
    n = args.labeled_batch_size
    ours[1]['valid'] = torch.tensor([1.0, 0.0] + [1.0] * (n - 2))
    theirs = []
    for b in ours:
        jb = {'inp': (b['inp'][0].permute(0, 2, 3, 1).numpy(),),
              'gt': (b['gt'][0].numpy().astype(np.int32),)}
        if 'valid' in b:
            jb['valid'] = b['valid'].numpy()
        theirs.append(jb)
    return ours, theirs


@pytest.mark.parametrize('algo_name', ['ssl_null', 'ssl_mt', 'ssl_gct'])
def test_validate_matches_jax(algo_name, tmp_path):
    rng = np.random.default_rng(5)
    args_dict = dict(ALGO_ARGS[algo_name], im_size=IM)
    jargs = jax_harness.default_args(algo_name, **args_dict)
    mesh = parallel.make_mesh(1)
    jalgo = jax_harness.build_algorithm(jargs, mesh=mesh,
                                        iters_per_epoch=ITERS_PER_EPOCH)
    state = jax.tree.map(np.asarray, jax.device_get(jalgo.state))
    if algo_name == 'ssl_mt':  # a teacher that is not the student
        state['teacher']['params'] = jax.tree.map(
            lambda p: p + rng.normal(0.0, 0.02, p.shape).astype(np.float32),
            state['teacher']['params'])

    args = harness.default_args(algo_name, **args_dict)
    args.checkpoint_path = str(tmp_path / 'ckpt')
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS_PER_EPOCH)
    for key, module in algo.modules.items():
        state[key]['batch_stats'] = _perturb_stats(state[key]['batch_stats'],
                                                   rng)
        module.load_state_dict(from_jax(state[key]))
    jalgo.state = jax.device_put(state, parallel.replicate_sharding(mesh))

    ours_batches, jax_batches = _val_batches(args)
    ours = algo.validate(ours_batches, epoch=1)
    theirs = jalgo.validate(jax_batches, epoch=1)

    ids = {'ssl_null': ['ssl_null'], 'ssl_mt': ['student', 'teacher'],
           'ssl_gct': ['l', 'r']}[algo_name]
    assert set(ours) == set(theirs) == {
        '{0}_metric_{1}'.format(i, m) for i in ids
        for m in ('acc', 'acc_class', 'mIoU', 'fwIoU')}
    for key in ours:
        assert ours[key] == pytest.approx(float(theirs[key]), abs=1e-3), key
    for i in ids:
        key = i + '_loss'
        assert algo.meters[key].avg == pytest.approx(
            float(jalgo.meters[key].avg), rel=2e-3), key
    for module in algo.modules.values():
        assert module.training

    record = json.loads((tmp_path / 'metrics.jsonl').read_text())
    assert record['phase'] == 'val' and record['algorithm'] == algo_name
    assert set(ours) < set(record)


def _build(algo_name, seed=0, **overrides):
    args = harness.default_args(algo_name, **dict(
        ALGO_ARGS[algo_name], seed=seed, **overrides))
    return harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS_PER_EPOCH), args


def _assert_same_state(a, b):
    assert (a.state.step, a.state.seed) == (b.state.step, b.state.seed)
    assert set(a.modules) == set(b.modules)
    for key in a.modules:
        sa, sb = a.modules[key].state_dict(), b.modules[key].state_dict()
        for name in sa:
            assert sa[name].dtype == sb[name].dtype, (key, name)
            assert torch.equal(sa[name], sb[name]), (key, name)
    for key in a.optimizers:
        oa, ob = a.optimizers[key].state_dict(), b.optimizers[key].state_dict()
        assert oa['param_groups'] == ob['param_groups'], key
        assert set(oa['state']) == set(ob['state']), key
        for pid, st in oa['state'].items():
            for name, value in st.items():
                assert torch.equal(torch.as_tensor(value),
                                   torch.as_tensor(ob['state'][pid][name])), \
                    (key, pid, name)


@pytest.mark.parametrize('algo_name', ['ssl_null', 'ssl_mt', 'ssl_gct',
                                       'ssl_adv', 'ssl_s4l', 'ssl_cutmix'])
def test_checkpoint_round_trip(algo_name, tmp_path):
    algo, args = _build(algo_name, im_size=IM)
    algo.train_step(harness.synthetic_batch(args, device='cpu', seed=1))
    path = str(tmp_path / 'ckpt.pth')
    algo.save_checkpoint(epoch=0, path=path)  # stale: overwritten below
    algo.train_step(harness.synthetic_batch(args, device='cpu', seed=2))
    assert algo.save_checkpoint(epoch=3, path=path) == path

    fresh, _ = _build(algo_name, seed=1, im_size=IM)
    assert fresh.load_checkpoint(path) == 3
    _assert_same_state(algo, fresh)
    assert fresh.state.step == 2


def test_resume_is_exact(tmp_path):
    """Save after step 1, load into a fresh algorithm, take step 2: the
    same metrics and state as the run that was not interrupted. The input
    noise is on and the fresh algorithm was built with another seed, so
    the noise must follow from the checkpoint's seed and step."""
    kw = dict(im_size=32, gaussian_noise_std=0.1)
    run, args = _build('ssl_mt', **kw)
    batch = harness.synthetic_batch(args, device='cpu', seed=3)
    run.train_step(batch)
    run.train_step(batch)
    path = run.save_checkpoint(epoch=1, path=str(tmp_path / 'c.pth'))
    expected = run.train_step(batch)

    resumed, _ = _build('ssl_mt', seed=7, **kw)
    resumed.load_checkpoint(path)
    got = resumed.train_step(batch)
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in expected.items()}
    _assert_same_state(run, resumed)


@pytest.mark.parametrize('saved_by,loaded_into', [('ssl_mt', 'ssl_null'),
                                                  ('ssl_null', 'ssl_mt'),
                                                  ('ssl_cutmix', 'ssl_mt'),
                                                  ('ssl_adv', 'ssl_s4l')])
def test_checkpoint_name_guard(saved_by, loaded_into, tmp_path):
    algo, _ = _build(saved_by, im_size=32)
    path = algo.save_checkpoint(epoch=0, path=str(tmp_path / 'c.pth'))
    other, _ = _build(loaded_into, im_size=32)
    with pytest.raises(logger.FatalError, match='`{0}`, expected `{1}`'.format(
            saved_by, loaded_into)):
        other.load_checkpoint(path)
