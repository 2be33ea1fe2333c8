"""The port's data path against the JAX package's: the SSL split wrappers
and batch samplers give the same index tuples for a seed, the synthetic
dataset the same samples, the train loader the same batches (any worker
count) and the validation loader the same padded or exact batches. All of
it is exact: no tolerance. Also: the dict-flag parser, the checkpoint
search of ``--auto-resume``, and that no module of the port imports
``yaml`` or ``PIL`` (the card's machine has neither).
"""

import argparse
import os
import shutil
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from pixelssl_tpu import parallel
from pixelssl_tpu.nn import data as jax_nndata
from pixelssl_tpu.nn import loader as jax_loader
from pixelssl_tpu.task_template import proxy as jax_proxy
from pixelssl_tpu.tasks.sseg import data as jax_sseg_data

from pixelssl_tpu_torch.nn import data as nndata
from pixelssl_tpu_torch.nn import loader as nnloader
from pixelssl_tpu_torch.task_template import proxy
from pixelssl_tpu_torch.tasks.sseg import data as sseg_data
from pixelssl_tpu_torch.utils import cmd, logger, tool

from test_torch_mt import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(im_size=64, n=16, num_classes=5, seed=3, root='/data/a'):
    return types.SimpleNamespace(
        synthetic_samples=n, im_size=im_size, num_classes=num_classes,
        seed=seed, trainset={'synthetic_sseg': [root]},
        valset={'synthetic_sseg': [root]})


def _wrapped(data_module, nn_module, args, labeled_every, ignore_unlabeled):
    dataset = data_module.SyntheticSsegDataset(args, True)
    prefixes = ['synthetic_{0:05d}'.format(i)
                for i in range(0, args.synthetic_samples, labeled_every)]
    return nn_module.SplitUnlabeledWrapper(dataset, prefixes,
                                           ignore_unlabeled=ignore_unlabeled)


def _epochs(sampler, n=2):
    return [[tuple(int(i) for i in b) for b in sampler] for _ in range(n)]


@pytest.mark.parametrize('labeled_every,ignore_unlabeled', [
    (2, False), (3, False), (4, True)])
def test_split_unlabeled_wrapper_matches_jax(labeled_every, ignore_unlabeled):
    args = _args(n=20)
    ours = _wrapped(sseg_data, nndata, args, labeled_every, ignore_unlabeled)
    theirs = _wrapped(jax_sseg_data, jax_nndata, args, labeled_every,
                      ignore_unlabeled)
    assert ours.labeled_idxs == theirs.labeled_idxs
    assert ours.unlabeled_idxs == theirs.unlabeled_idxs
    assert ours.dataset.sample_list == theirs.dataset.sample_list
    assert ours.dataset.num_labeled == theirs.dataset.num_labeled
    assert len(ours) == len(theirs)


@pytest.mark.parametrize('n_labeled,n_unlabeled,lbs,ubs,seed', [
    (8, 8, 2, 2, 0),     # equal streams
    (4, 12, 2, 2, 1),    # the unlabeled stream is walked once
    (12, 5, 3, 1, 2),    # the labeled stream is walked once
    (7, 9, 2, 3, 5),     # ragged tails
])
def test_two_stream_sampler_matches_jax(n_labeled, n_unlabeled, lbs, ubs,
                                        seed):
    labeled = list(range(n_labeled))
    unlabeled = list(range(n_labeled, n_labeled + n_unlabeled))
    ours = nndata.TwoStreamBatchSampler(labeled, unlabeled, lbs, ubs,
                                        seed=seed)
    theirs = jax_nndata.TwoStreamBatchSampler(labeled, unlabeled, lbs, ubs,
                                              seed=seed)
    assert len(ours) == len(theirs)
    got, want = _epochs(ours), _epochs(theirs)
    assert got == want
    for epoch in got:
        assert len(epoch) == len(ours)
        for batch in epoch:  # labeled first
            assert all(i < n_labeled for i in batch[:lbs])
            assert all(i >= n_labeled for i in batch[lbs:])


@pytest.mark.parametrize('n,batch_size,drop_last,seed', [
    (10, 3, True, 0), (10, 3, False, 4), (8, 4, True, 7)])
def test_one_stream_sampler_matches_jax(n, batch_size, drop_last, seed):
    idxs = list(range(n))
    ours = nndata.OneStreamBatchSampler(idxs, batch_size, seed=seed,
                                        drop_last=drop_last)
    theirs = jax_nndata.OneStreamBatchSampler(idxs, batch_size, seed=seed,
                                              drop_last=drop_last)
    assert len(ours) == len(theirs)
    assert _epochs(ours) == _epochs(theirs)


def test_joint_datasets_wrapper_matches_jax():
    sets = {}
    for name, data_module, nn_module in (('ours', sseg_data, nndata),
                                         ('theirs', jax_sseg_data,
                                          jax_nndata)):
        labeled = [data_module.SyntheticSsegDataset(_args(n=n, root=r), True)
                   for n, r in ((3, '/a'), (4, '/b'))]
        unlabeled = [data_module.SyntheticSsegDataset(_args(n=5, root='/u'),
                                                      True)]
        sets[name] = nn_module.JointDatasetsWrapper(labeled, unlabeled)
    ours, theirs = sets['ours'], sets['theirs']
    assert (ours.labeled_idxs, ours.unlabeled_idxs, len(ours)) == (
        theirs.labeled_idxs, theirs.unlabeled_idxs, len(theirs))
    for i in range(len(ours)):
        for a, b in zip(ours[i][0] + ours[i][1], theirs[i][0] + theirs[i][1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('im_size', [32, 64])
def test_synthetic_sseg_matches_jax(im_size):
    args = _args(im_size=im_size, n=6)
    ours = sseg_data.SyntheticSsegDataset(args, True)
    theirs = jax_sseg_data.SyntheticSsegDataset(args, True)
    ours.set_num_labeled(4)
    theirs.set_num_labeled(4)
    assert ours.sample_list == theirs.sample_list
    for i in range(6):
        (img, ), (gt, ) = ours[i]
        (jimg, ), (jgt, ) = theirs[i]
        assert img.dtype == jimg.dtype and gt.dtype == jgt.dtype
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(gt, jgt)
    assert (ours[5][1][0] == -1).all()


def test_synthetic_sseg_label_covers_an_image_off_the_block_grid():
    """At 321 px the JAX package's label is 320 x 320 (np.kron of 40 x 40
    blocks of 8); the port's is 321 x 321, equal to it on those 320 rows
    and columns, its last row and column those of the last block."""
    args = _args(im_size=321, n=1, num_classes=21)
    (img, ), (gt, ) = sseg_data.SyntheticSsegDataset(args, True)[0]
    (jimg, ), (jgt, ) = jax_sseg_data.SyntheticSsegDataset(args, True)[0]
    assert img.shape == (321, 321, 3) and gt.shape == (321, 321)
    assert jgt.shape == (320, 320)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(gt[:320, :320], jgt)
    np.testing.assert_array_equal(gt[320, :320], jgt[319])
    np.testing.assert_array_equal(gt[:320, 320], jgt[:, 319])


@pytest.mark.parametrize('num_workers', [0, 2])
def test_train_loader_matches_jax_batches(num_workers):
    """Two epochs of a two-stream loader over a sublabeled synthetic set:
    each batch equals the JAX loader's, images permuted back to NHWC."""
    args = _args(im_size=24, n=18)
    batches = {}
    for name, data_module, nn_module in (('ours', sseg_data, nndata),
                                         ('theirs', jax_sseg_data,
                                          jax_nndata)):
        wrapped = _wrapped(data_module, nn_module, args, 3, False)
        sampler = nn_module.TwoStreamBatchSampler(
            wrapped.labeled_idxs, wrapped.unlabeled_idxs, 2, 2, seed=9)
        if name == 'ours':
            loader = nnloader.DataLoader(wrapped, sampler, 'cpu',
                                         num_workers=num_workers)
        else:
            loader = jax_loader.DataLoader(wrapped, sampler, num_workers=2)
        batches[name] = [list(loader) for _ in range(2)]
    assert [len(e) for e in batches['ours']] == [6, 6]
    for ours_epoch, theirs_epoch in zip(batches['ours'], batches['theirs']):
        assert len(ours_epoch) == len(theirs_epoch)
        for ours, (jinp, jgt) in zip(ours_epoch, theirs_epoch):
            img, gt = ours['inp'][0], ours['gt'][0]
            assert img.dtype == torch.float32 and gt.dtype == torch.int64
            assert tuple(img.shape) == (4, 3, 24, 24)
            assert img.is_contiguous()
            np.testing.assert_array_equal(img.permute(0, 2, 3, 1).numpy(),
                                          jinp[0])
            np.testing.assert_array_equal(gt.numpy(), jgt[0])
            assert (gt[2:] == -1).all() and (gt[:2] >= 0).all()


def test_train_loader_after_an_abandoned_epoch():
    """An epoch left after one batch, then a whole one: the whole epoch is
    the sampler's next walk, and its workers are the first epoch's."""
    args = _args(im_size=16, n=12)
    wrapped = _wrapped(sseg_data, nndata, args, 2, False)
    sampler = nndata.TwoStreamBatchSampler(
        wrapped.labeled_idxs, wrapped.unlabeled_idxs, 2, 1, seed=4)
    twin = nndata.TwoStreamBatchSampler(
        wrapped.labeled_idxs, wrapped.unlabeled_idxs, 2, 1, seed=4)
    loader = nnloader.DataLoader(wrapped, sampler, 'cpu', num_workers=2)
    first = next(iter(loader))
    list(twin)
    expected = list(twin)
    got = list(loader)
    assert len(got) == len(expected) == 6
    for batch, idxs in zip(got, expected):
        want = nnloader.stack_samples([wrapped[i] for i in idxs])
        assert torch.equal(batch['inp'][0], want[0][0].permute(0, 3, 1, 2))
        assert torch.equal(batch['gt'][0], want[1][0].long())
    assert first['inp'][0].shape == (3, 3, 16, 16)


@pytest.mark.parametrize('exact', [False, True])
def test_val_loader_matches_jax(exact):
    """Bucketed: each 40 px sample padded to 64 (inputs 0, labels
    ignore_index) with a valid mask of 1; exact: unpadded, no mask."""
    args = _args(im_size=40, n=3)
    ours_set = sseg_data.SyntheticSsegDataset(args, False)
    theirs_set = jax_sseg_data.SyntheticSsegDataset(args, False)
    ours = list(proxy._ValLoader(ours_set, torch.device('cpu'), 255,
                                 exact=exact))
    theirs = list(jax_proxy._ValLoader(theirs_set, 1, parallel.make_mesh(1),
                                       255, exact=exact))
    assert len(ours) == len(theirs) == 3
    size = 40 if exact else 64
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        img, gt = a['inp'][0], a['gt'][0]
        assert tuple(img.shape) == (1, 3, size, size)
        assert tuple(gt.shape) == (1, size, size) and gt.dtype == torch.int64
        np.testing.assert_array_equal(img.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(b['inp'][0]))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(b['gt'][0]))
        if not exact:
            np.testing.assert_array_equal(a['valid'].numpy(),
                                          np.asarray(b['valid']))
            assert (gt[:, 40:] == 255).all() and (gt[:, :, 40:] == 255).all()
            assert float(img[..., 40:, :].abs().max()) == 0.0


def test_strdict_and_parse_args():
    assert cmd.strdict("{'synthetic_sseg': ['/tmp']}") == {
        'synthetic_sseg': ['/tmp']}
    assert cmd.strdict({'a': 1}) == {'a': 1}
    # YAML flow style, as the JAX package reads dict flags
    assert cmd.strdict('{model: deeplabv2}') == {'model': 'deeplabv2'}
    for bad in ("['a']", '{model: [a}', 'model: deeplabv2'):
        with pytest.raises(argparse.ArgumentTypeError):
            cmd.strdict(bad)
    parser = argparse.ArgumentParser()
    parser.add_argument('--models', type=cmd.strdict, default={})
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--milestones', type=cmd.str2intlist, default=[])
    args = cmd.parse_args(parser, {'models': {'model': 'deeplabv2'},
                                   'batch_size': 4, 'milestones': [3, 5],
                                   'not_a_flag': 1},
                          cli_override=False)
    assert args.models == {'model': 'deeplabv2'}
    assert args.batch_size == 4 and args.milestones == [3, 5]
    assert cmd.str2floatlist('[0.5, 2]') == [0.5, 2.0]
    assert tool.dict_value({'a': 1}, 'a') == 1
    assert tool.dict_value({'a': None}, 'a', default=3) == 3
    with pytest.raises(logger.FatalError):
        tool.dict_value({}, 'a')


def test_latest_checkpoint_parses_pth_names(tmp_path):
    assert proxy._latest_checkpoint(str(tmp_path)) is None
    assert proxy._latest_checkpoint(str(tmp_path / 'missing')) is None
    for name in ('checkpoint_2.pth', 'checkpoint_10.pth',
                 'checkpoint_11.pth.tmp', 'checkpoint_12', 'other_13.pth'):
        (tmp_path / name).write_bytes(b'')
    assert proxy._latest_checkpoint(str(tmp_path)) == str(
        tmp_path / 'checkpoint_10.pth')


_NO_YAML_NO_PIL = textwrap.dedent('''
    import collections, importlib, importlib.abc, os, pkgutil, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split('.')[0] in ('yaml', 'PIL', 'jax', 'pixelssl_tpu'):
                raise ImportError('refused import of ' + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    import pixelssl_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        pixelssl_tpu_torch.__path__, 'pixelssl_tpu_torch.')]
    for name in names:
        importlib.import_module(name)
    from pixelssl_tpu_torch.tasks import sseg
    out = {out!r}
    with open(os.path.join(out, 'sub.txt'), 'w') as f:
        f.write('synthetic_00000\\nsynthetic_00002\\n')
    config = collections.OrderedDict([
        ('exp_id', 'e'), ('out_path', out), ('ssl_algorithm', 'ssl_mt'),
        ('trainset', {{'synthetic_sseg': ['s']}}),
        ('valset', {{'synthetic_sseg': ['s']}}), ('synthetic_samples', 4),
        ('sublabeled_path', os.path.join(out, 'sub.txt')),
        ('ignore_unlabeled', False), ('models', {{'model': 'deeplabv2'}}),
        ('optimizers', {{'model': 'sgd'}}),
        ('lrers', {{'model': 'polynomiallr'}}),
        ('criterions', {{'model': 'sseg_criterion'}}),
        ('backbone', 'resnet10'), ('im_size', 32), ('num_classes', 3),
        ('batch_size', 2), ('unlabeled_batch_size', 1), ('bf16', False),
        ('lr', 5e-5), ('cons_scale', 1.0), ('cons_rampup_epochs', 1),
        ('num_workers', 1), ('log_freq', 1)])
    pixelssl_tpu_torch.run_script(config, sseg,
                                  sseg.SemanticSegmentationProxy,
                                  device='cpu', cli_override=False)
    loaded = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('yaml', 'PIL'))
    assert not loaded, loaded
    print('imported', len(names), 'modules')
''')


def test_port_imports_no_yaml_no_pil_no_jax(tmp_path):
    """Every module of the port imports, and a ``run_script`` MT epoch runs
    through the script path, in a process where importing ``yaml``,
    ``PIL``, ``jax`` or the JAX package fails."""
    code = _NO_YAML_NO_PIL.format(repo=REPO, out=str(tmp_path))
    env = dict(os.environ, OMP_NUM_THREADS='1')
    try:
        res = subprocess.run([sys.executable, '-c', code],
                             capture_output=True, text=True, timeout=240,
                             env=env, cwd=str(tmp_path))
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        assert 'imported' in res.stdout
        assert (tmp_path / 'e' / 'ckpt' / 'checkpoint_1.pth').exists()
    finally:  # the checkpoint takes about 200 MB
        shutil.rmtree(tmp_path / 'e', ignore_errors=True)
