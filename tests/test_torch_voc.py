"""The PASCAL VOC input path of the port against the JAX package's.

The same samples, keyed ``(seed, idx, k)``, from the JAX datasets (Pillow)
and the port's (``nn/imageio.py`` and ``csrc/augment.cpp``, no Pillow), on
the committed fixture tree ``tests/data/voc_fixture/VOC2012``: the default
path, ``--decoded-cache``, ``--u8-transfer`` and ``--native-augment``; the
loader's access keys with 0 and 2 worker processes; the port's C++ library
against the JAX package's ``native/augment.cpp`` (compiled into a temporary
directory); ``device_prep``; and a 1-8 script through ``run_script`` on the
tree.

Tolerances: the port's JPEG decoder and resizes use libjpeg's and PIL's
integer arithmetic, so images and labels are held equal to Pillow's. The
normalised images are then equal too: the same float32 expression. The
native path differs from the default path by design (point-sampled
bilinear against PIL's antialiased filter); it is held to the JAX
library's output, equal, on the same decoded pixels.

The fixture tree is generated data: ``make_voc_fixture`` writes it with
Pillow, and a test rebuilds it and compares it with the committed files.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pixelssl_tpu.nn import data as jax_nndata
from pixelssl_tpu.nn import native as jax_native
from pixelssl_tpu.tasks.sseg import data as jax_data

from pixelssl_tpu_torch.nn import data as nndata
from pixelssl_tpu_torch.nn import imageio, native
from pixelssl_tpu_torch.nn import loader as nnloader
from pixelssl_tpu_torch.tasks.sseg import data as sseg_data
from pixelssl_tpu_torch.tasks.sseg import func as sseg_func

from test_torch_mt import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'data', 'voc_fixture', 'VOC2012')
PREFIXES = os.path.join(REPO, 'dataset', 'PascalVOC', 'sublabeled_prefix',
                        '1-8', '0.txt')

# VOC's image sizes (h, w): long side 500, short side 281-500
_TRAIN_SIZES = [(375, 500), (500, 375), (333, 500), (500, 333), (281, 500),
                (500, 500), (366, 500), (500, 400), (300, 500), (500, 281)]
_VAL_SIZES = [(375, 500), (500, 366), (281, 500), (500, 500)]


def _fixture_names():
    """10 train names from the 1-8 prefix list, 10 that match no prefix,
    and 4 val names."""
    with open(PREFIXES) as f:
        prefixes = [l.strip() for l in f if l.strip()]
    labeled = prefixes[:10]
    unlabeled = ['2011_9{0:05d}'.format(i) for i in range(10)]
    assert not any(n.startswith(tuple(prefixes)) for n in unlabeled)
    val = ['2007_9{0:05d}'.format(i) for i in range(4)]
    return labeled, unlabeled, val


def _sample_arrays(rng, h, w):
    """A smooth image whose colour follows a blocky 21-class label, with
    255 (void) on the blocks' borders."""
    bh, bw = int(rng.integers(40, 90)), int(rng.integers(40, 90))
    classes = rng.integers(0, 21, (h // bh + 1, w // bw + 1))
    yy, xx = np.mgrid[0:h, 0:w]
    label = classes[yy // bh, xx // bw].astype(np.uint8)
    border = (yy % bh < 2) | (xx % bw < 2)
    palette = rng.uniform(30, 225, (21, 3))
    phase = rng.uniform(0, 2 * np.pi, 3)
    waves = np.stack([30 * np.sin(xx / 37.0 + phase[c]) *
                      np.cos(yy / 53.0 - phase[c]) for c in range(3)], -1)
    image = np.clip(palette[label] + waves, 0, 255).astype(np.uint8)
    label[border] = 255
    return image, label


def make_voc_fixture(root):
    """Write the VOC-format fixture tree under ``root`` (Pillow's JPEG at
    quality 75 and 4:2:0, 8-bit gray PNG labels); returns its names."""
    from PIL import Image

    labeled, unlabeled, val = _fixture_names()
    dirs = {d: os.path.join(root, d) for d in (
        'JPEGImages', 'SegmentationClassAug',
        os.path.join('ImageSets', 'Segmentation'))}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(2012)
    train = labeled + unlabeled
    sizes = _TRAIN_SIZES * 2 + _VAL_SIZES
    for name, (h, w) in zip(train + val, sizes):
        image, label = _sample_arrays(rng, h, w)
        Image.fromarray(image).save(
            os.path.join(dirs['JPEGImages'], name + '.jpg'), quality=75)
        Image.fromarray(label, mode='L').save(
            os.path.join(dirs['SegmentationClassAug'], name + '.png'))
    sets = dirs[os.path.join('ImageSets', 'Segmentation')]
    for fname, names in (('train_aug.txt', train), ('train.txt', train[::2]),
                         ('val.txt', val)):
        with open(os.path.join(sets, fname), 'w') as f:
            f.write('\n'.join(names) + '\n')
    return train, val


def _tree_files(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_fixture_tree_is_what_the_generator_writes(tmp_path):
    make_voc_fixture(str(tmp_path))
    ours, committed = _tree_files(str(tmp_path)), _tree_files(FIXTURE)
    assert sorted(ours) == sorted(committed)
    for name in ours:
        assert ours[name] == committed[name], name
    assert sum(len(v) for v in committed.values()) < 1.5 * 2 ** 20


# ---------------------------------------------------------------------------
# datasets: the port's samples against the JAX dataset's
# ---------------------------------------------------------------------------

def _args(is_train=True, im_size=64, base=96, seed=5, num_classes=21,
          **flags):
    root = {'pascal_voc_aug': [FIXTURE]}
    return argparse.Namespace(
        im_size=im_size, train_base_size=base, seed=seed,
        num_classes=num_classes, ignore_index=255,
        trainset=root if is_train else {}, valset={} if is_train else root,
        val_rescaling=flags.pop('val_rescaling', False),
        native_augment=flags.pop('native_augment', False),
        decoded_cache=flags.pop('decoded_cache', False),
        u8_transfer=flags.pop('u8_transfer', False), **flags)


def _split(data_module, nn_module, args):
    """The 1-8 split of the fixture's train set, as the proxy wraps it."""
    with open(PREFIXES) as f:
        prefixes = [l.strip() for l in f if l.strip()]
    ds = data_module.pascal_voc_aug()(args, True)
    return nn_module.SplitUnlabeledWrapper(ds, prefixes)


def _assert_samples_equal(ours, theirs):
    for a, b in zip(ours[0] + ours[1], theirs[0] + theirs[1]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('base,crop,seed', [(96, 64, 5), (400, 64, 1),
                                            (64, 96, 2)])
def test_random_scale_crop_matches_jax(base, crop, seed):
    """PIL's resize, pad and crop against the port's windowed resize, on
    the fixture's images (upsampled at base 400, downsampled at 96, padded
    at a crop above the scaled size)."""
    from PIL import Image

    names = sorted(os.listdir(os.path.join(FIXTURE, 'JPEGImages')))[:6]
    for i, name in enumerate(names):
        jpg = os.path.join(FIXTURE, 'JPEGImages', name)
        png = os.path.join(FIXTURE, 'SegmentationClassAug',
                           name[:-4] + '.png')
        rng_a = np.random.default_rng((seed, i))
        rng_b = np.random.default_rng((seed, i))
        img, lbl = jax_data.random_scale_crop(
            rng_a, Image.open(jpg).convert('RGB'), Image.open(png), base,
            crop)
        ours = sseg_data.random_scale_crop(
            rng_b, imageio.read_rgb(jpg), imageio.read_label(png), base, crop)
        np.testing.assert_array_equal(ours[0], np.asarray(img))
        np.testing.assert_array_equal(ours[1], np.asarray(lbl))
        assert rng_a.random() == rng_b.random()  # the same draws consumed


@pytest.mark.parametrize('mode', ['default', 'decoded_cache', 'u8',
                                  'u8_int16'])
def test_train_samples_match_jax(mode):
    """Each train sample (labeled and unlabeled) of the first two accesses,
    ``(seed, idx, k)`` for k = 0, 1: labels and images equal."""
    flags = {'default': {}, 'decoded_cache': {'decoded_cache': True},
             'u8': {'u8_transfer': True},
             'u8_int16': {'u8_transfer': True, 'num_classes': 300}}[mode]
    theirs = _split(jax_data, jax_nndata, _args(**flags))
    ours = _split(sseg_data, nndata, _args(**flags))
    assert ours.dataset.sample_list == theirs.dataset.sample_list
    assert len(ours.labeled_idxs) == 10 and len(ours.unlabeled_idxs) == 10
    for idx in range(len(ours)):
        for k in range(2):  # the JAX dataset counts its accesses of idx
            mine = ours[(idx, k)]
            _assert_samples_equal(mine, theirs[idx])
            label = mine[1][0]
            if idx >= 10:  # unlabeled: -1, or 255 on the uint8 wire
                assert (label == {'u8': 255}.get(mode, -1)).all()
    if mode == 'u8':
        assert mine[0][0].dtype == np.uint8 and mine[1][0].dtype == np.uint8


@pytest.mark.parametrize('val_rescaling', [False, True])
def test_val_samples_match_jax(val_rescaling):
    """Val images keep their own sizes, or their short side goes to
    ``im_size``; equal to the JAX dataset's."""
    args = dict(is_train=False, val_rescaling=val_rescaling)
    theirs = jax_data.pascal_voc_aug()(_args(**args), False)
    ours = sseg_data.pascal_voc_aug()(_args(**args), False)
    sizes = set()
    for idx in range(len(ours)):
        mine = ours[idx]
        _assert_samples_equal(mine, theirs[idx])
        sizes.add(mine[0][0].shape[:2])
    assert len(sizes) == 4
    if val_rescaling:
        assert {min(s) for s in sizes} == {64}


@pytest.fixture(scope='module')
def jax_library(tmp_path_factory):
    """The JAX package's ``native/augment.cpp``, compiled into a temporary
    directory with its libjpeg and libpng, loaded through ``native.lib``."""
    def found(header):
        proc = subprocess.run(['g++', '-E', '-x', 'c++', '-'],
                              input='#include <{0}>\n'.format(header),
                              capture_output=True, text=True)
        return proc.returncode == 0
    if shutil.which('g++') is None or not (found('jpeglib.h') and
                                           found('png.h')):
        pytest.skip('needs g++, jpeglib.h and png.h')
    out = tmp_path_factory.mktemp('jax_native')
    so = str(out / 'libpixelssl_augment_jax.so')
    proc = subprocess.run(
        ['g++', '-O3', '-std=c++17', '-fPIC', '-pthread', '-shared', '-o', so,
         os.path.join(REPO, 'pixelssl_tpu', 'native', 'augment.cpp'),
         '-ljpeg', '-lpng'], capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip('the JAX library does not build here: ' + proc.stderr)
    return native.lib(so)


def _geometries(rng, h, w, crop, n):
    out = []
    for _ in range(n):
        rh, rw = int(rng.integers(crop // 2, 2 * h)), int(rng.integers(
            crop // 2, 2 * w))
        out.append(((rh, rw), (int(rng.integers(-8, max(rh - crop, 1))),
                               int(rng.integers(-8, max(rw - crop, 1)))),
                    bool(rng.integers(2))))
    return out


def test_port_library_matches_jax_library(jax_library):
    """``csrc/augment.cpp`` against ``pixelssl_tpu/native/augment.cpp`` on
    the fixture files: header sizes, decode + augment of one sample
    (float32 and uint8 forms, with and without a label), and the batch
    augment of decoded arrays; all equal."""
    ours = native.lib()
    rng = np.random.default_rng(0)
    names = sorted(os.listdir(os.path.join(FIXTURE, 'JPEGImages')))[:8]
    for name in names:
        jpg = os.path.join(FIXTURE, 'JPEGImages', name)
        png = os.path.join(FIXTURE, 'SegmentationClassAug',
                           name[:-4] + '.png')
        h, w = native.jpeg_dims(jpg, ours)
        assert native.jpeg_dims(jpg, jax_library) == (h, w)
        for resize, crop_yx, flip in _geometries(rng, h, w, 48, 3):
            for label, fill in ((png, 0), (None, -1)):
                for fn in (native.decode_augment_sample,
                           native.decode_augment_sample_raw):
                    a = fn(jpg, label, resize, crop_yx, flip, fill, 48, ours)
                    b = fn(jpg, label, resize, crop_yx, flip, fill, 48,
                           jax_library)
                    np.testing.assert_array_equal(a[0], b[0])
                    np.testing.assert_array_equal(a[1], b[1])
        img = imageio.read_rgb(jpg)
        lbl = imageio.read_label(png).astype(np.int32)
        geo = list(zip(*_geometries(rng, h, w, 48, 2)))
        args = ([img, img], [lbl, None], geo[0], geo[1], geo[2], [0, -1], 48)
        for fn in (native.augment_batch, native.augment_batch_raw):
            a, b = fn(*args, library=ours), fn(*args, library=jax_library)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize('flags', [
    {'native_augment': True},
    {'native_augment': True, 'decoded_cache': True},
    {'native_augment': True, 'u8_transfer': True},
    {'native_augment': True, 'decoded_cache': True, 'u8_transfer': True},
], ids=['native', 'native_cache', 'native_u8', 'native_cache_u8'])
def test_native_samples_match_jax(flags, jax_library, monkeypatch):
    """``--native-augment`` (and with it ``--decoded-cache`` and
    ``--u8-transfer``): the port's dataset against the JAX dataset running
    its own library, sample by sample, equal; the same crops as the default
    path draws."""
    monkeypatch.setattr(jax_native, 'lib', lambda: jax_library)
    theirs = _split(jax_data, jax_nndata, _args(**flags))
    assert theirs.dataset._use_native
    ours = _split(sseg_data, nndata, _args(**flags))
    for idx in range(len(ours)):
        for k in range(2):  # the JAX dataset counts its accesses of idx
            _assert_samples_equal(ours[(idx, k)], theirs[idx])


# ---------------------------------------------------------------------------
# the loader: access keys from the main process; the batches on the device
# ---------------------------------------------------------------------------

def _loader(num_workers, **flags):
    args = _args(**flags)
    ds = _split(sseg_data, nndata, args)
    sampler = nndata.TwoStreamBatchSampler(ds.labeled_idxs, ds.unlabeled_idxs,
                                           2, 2, seed=args.seed)
    return nnloader.DataLoader(ds, sampler, 'cpu', num_workers=num_workers)


def _epochs(loader, n=2):
    out = []
    for _ in range(n):
        out.append([(b['inp'][0].clone(), b['gt'][0].clone())
                    for b in loader])
    return out


def test_loader_streams_equal_for_0_and_2_workers_and_match_jax():
    """Two epochs of train batches: equal with no worker process and with
    two, and equal to the JAX dataset's samples taken in the loader's order
    (its per-index counter gives the same k as the loader's keys)."""
    single = _loader(0)
    streams = [_epochs(single), _epochs(_loader(2))]
    for a, b in zip(*streams):
        for (ia, ga), (ib, gb) in zip(a, b):
            assert torch.equal(ia, ib) and torch.equal(ga, gb)

    theirs = _split(jax_data, jax_nndata, _args())
    sampler = nndata.TwoStreamBatchSampler(
        theirs.labeled_idxs, theirs.unlabeled_idxs, 2, 2, seed=5)
    for epoch in streams[0]:
        batches = list(sampler)  # an epoch walks the whole sampler
        assert len(batches) == len(epoch) == 5
        for (img, gt), batch in zip(epoch, batches):
            for row, idx in enumerate(batch):
                (x,), (y,) = theirs[int(idx)]
                np.testing.assert_array_equal(
                    img[row].permute(1, 2, 0).numpy(), x)
                np.testing.assert_array_equal(gt[row].numpy(), y)
    assert single._accesses == {i: 2 for i in range(20)}


def test_u8_batches_normalised_on_the_device_match_the_float_path():
    """``--u8-transfer`` batches reach the device as uint8 NCHW images and
    uint8 labels; ``device_prep`` normalises and widens them. Default path:
    equal to the float batches within float32 rounding; native path: within
    half a grey level (its uint8 is the rounded float sample), 0.5/255/std."""
    func = sseg_func.SemanticSegmentationFunc(_args())
    std = torch.tensor(sseg_data.VOC_STD)[None, :, None, None]
    for flags, atol in (({}, 1e-6), ({'native_augment': True}, None)):
        u8 = next(iter(_loader(0, u8_transfer=True, **flags)))
        assert u8['inp'][0].dtype == torch.uint8
        assert u8['inp'][0].shape == (4, 3, 64, 64)
        assert u8['gt'][0].dtype == torch.uint8
        prepped = func.device_prep(u8)
        ref = next(iter(_loader(0, **flags)))
        assert prepped['gt'][0].dtype == torch.int64
        gt = ref['gt'][0].clone()
        gt[gt == -1] = 255
        assert torch.equal(prepped['gt'][0], gt)
        diff = (prepped['inp'][0] - ref['inp'][0]).abs()
        if atol is None:
            assert bool((diff <= 0.5 / 255 / std + 1e-6).all())
        else:
            assert float(diff.max()) <= atol
    assert func.device_prep(ref) is ref  # float batches pass through


# ---------------------------------------------------------------------------
# a 1-8 script on the fixture tree
# ---------------------------------------------------------------------------

_RUN_SCRIPT = '''
import importlib.abc, os, runpy, sys

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
from pixelssl_tpu_torch.tasks import sseg
config = runpy.run_path(os.path.join(
    {repo!r}, 'pixelssl_tpu_torch', 'scripts', {script!r}))['config']
config.update({overrides!r})
pixelssl_tpu_torch.run_script(config, sseg, sseg.SemanticSegmentationProxy,
                              device='cpu', cli_override=False)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('yaml', 'PIL', 'jax'))
assert not loaded, loaded
'''


@pytest.mark.parametrize('script,flags', [
    ('deeplabv2_pascalvoc_1-8_sslmt.py', {}),
    ('deeplabv2_pascalvoc_1-8_sslgct.py',
     {'native_augment': True, 'decoded_cache': True, 'u8_transfer': True}),
], ids=['mt_default', 'gct_native_cache_u8'])
def test_voc_script_trains_and_validates_on_the_fixture(script, flags,
                                                        tmp_path):
    """The 1-8 script as written, its data keys on the fixture tree in
    YAML flow style, ResNet-10 at 64 px, trained from scratch: 1 epoch of 5
    iterations (10 labeled, 10 unlabeled, 2 + 2 a batch) from two forked
    workers, then validation on the 4 val images; in a process where
    importing ``yaml``, ``PIL``, ``jax`` or the JAX package fails."""
    overrides = dict(
        trainset='{{pascal_voc_aug: [{0}]}}'.format(FIXTURE),
        valset='{{pascal_voc_aug: [{0}]}}'.format(FIXTURE),
        validation=False, resume='', out_path=str(tmp_path), epochs=1,
        backbone='resnet10', im_size=64, train_base_size=64, bf16=False,
        log_freq=1, checkpoint_freq=10, **flags)
    code = _RUN_SCRIPT.format(repo=REPO, script=script, overrides=overrides)
    env = dict(os.environ, OMP_NUM_THREADS='1')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    exp = script.split('.')[0]
    with open(tmp_path / exp / 'metrics.jsonl') as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r['phase'] == 'train']
    val = [r for r in records if r['phase'] == 'val']
    assert len(train) == 5 and len(val) == 1
    for r in train:
        assert all(np.isfinite(v) for k, v in r.items() if k.endswith('_loss'))
    scores = [v for k, v in val[0].items() if 'metric' in k]
    assert scores and all(0.0 <= v <= 1.0 for v in scores)


def test_native_path_shares_the_default_paths_geometry():
    """``--native-augment`` against the default path on the same draws at
    the DeepLab-v2 recipe's crop and base (321, 400), uint8 on both: labels
    equal on at least 97% of every sample's pixels (the C++ nearest index
    is float32 arithmetic, PIL's double, so a position that falls on a
    source pixel's edge may round the other way), and where the image is
    enlarged every pixel within one grey level (PIL's triangle filter is
    bilinear interpolation there, rounded after each pass). Shrunk images
    differ by design: PIL's filter is antialiased. ``chip_smoke.py`` phase
    21 makes the same check on the card's host."""
    flags = dict(im_size=321, base=400, u8_transfer=True)
    default = _split(sseg_data, nndata, _args(**flags))
    cpp = _split(sseg_data, nndata, _args(native_augment=True, **flags))
    enlarged = 0
    for idx in range(len(default)):
        h, w = native.jpeg_dims(default.dataset._paths(idx)[0])
        for k in range(3):
            (oh, _), _, _ = default.dataset._geometry(
                np.random.default_rng((5, idx, k)), h, w)
            (a,), (la,) = default[(idx, k)]
            (b,), (lb,) = cpp[(idx, k)]
            assert (la == lb).mean() >= 0.97
            if oh >= h:
                enlarged += 1
                assert np.abs(a.astype(np.int32) - b).max() <= 1
    assert enlarged >= 20
