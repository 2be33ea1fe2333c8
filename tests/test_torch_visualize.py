"""``--visualize`` in the port against the JAX package: the PNG writer, the
sseg and sreg ``visualize``/``visualize_pseudo_gt`` hooks, ``save_gray_map``,
AdvSSL's and GCT's ``_debug_visualize``, and the file names a
``run_script`` writes.

The JAX package writes its PNGs with Pillow, the port with its own zlib
writer (``nn.imageio.write_png``): the pixels must be equal, the bytes may
differ. The hooks take the same arrays (NCHW for the port, NHWC for JAX)
and must give equal pixels, with one exception: the JAX sseg ``visualize``
writes the GT of a [1,H,W] label batch as a 1 x H image of its first
column (ROADMAP F12), where the port writes the [H,W] map; the port's
first column is held to the JAX image's one row. The debug maps come from
forwards of the two packages on the same weights (``from_jax``): their
gray levels within 1 (float32 noise can cross a truncation step), the
coloured pseudo-GT's pixels equal on at least 99% of the pixels (its
per-pixel pick between the models flips where their flawmaps tie). GCT
runs at 96 px, where its flaw detector's map does not collapse
(``tests/test_torch_gct.py``).
"""

import collections
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from PIL import Image

import pixelssl_tpu
from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel as jax_parallel
from pixelssl_tpu.ssl_algorithm import ssl_base as jax_base
from pixelssl_tpu.tasks import sseg as jax_sseg
from pixelssl_tpu.tasks.sreg import func as jax_sreg_func
from pixelssl_tpu.tasks.sseg import func as jax_sseg_func
from pixelssl_tpu.utils import cmd as jax_cmd

import pixelssl_tpu_torch
from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.nn import imageio
from pixelssl_tpu_torch.ssl_algorithm import ssl_base
from pixelssl_tpu_torch.tasks import sseg
from pixelssl_tpu_torch.tasks.sreg import func as sreg_func
from pixelssl_tpu_torch.tasks.sseg import func as sseg_func

from test_torch_mt import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pil(path):
    return np.asarray(Image.open(path))


# ---------------------------------------------------------------------------
# the PNG writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(7, 11), (1, 5), (32, 1), (7, 11, 3),
                                   (5, 1, 3), (64, 48, 3)])
def test_png_writer_round_trips(shape, tmp_path):
    """Gray and RGB through ``write_png``: the port's reader and Pillow read
    the same pixels back."""
    a = np.random.default_rng(len(shape) * 100 + shape[0]).integers(
        0, 256, shape).astype(np.uint8)
    path = str(tmp_path / 'x.png')
    imageio.write_png(path, a)
    ours = imageio.read_png(path)
    theirs = _pil(path)
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, a)
    np.testing.assert_array_equal(theirs, a)
    im = Image.open(path)
    assert im.mode == ('L' if len(shape) == 2 else 'RGB')
    assert im.size == (shape[1], shape[0])


@pytest.mark.parametrize('rgb', [False, True])
def test_png_reader_takes_pillow_filters(rgb, tmp_path):
    """Pillow's PNGs choose a filter a row (sub, up, average, Paeth on a
    smooth image): the port's reader undoes each, a pixel's bytes apart."""
    y, x = np.mgrid[0:40, 0:53]
    a = ((y * 3 + x * 5 + (x * y) // 7) % 256).astype(np.uint8)
    if rgb:
        a = np.stack([a, 255 - a, (a // 2 + y).astype(np.uint8)], axis=-1)
    path = str(tmp_path / 'p.png')
    Image.fromarray(a).save(path)
    np.testing.assert_array_equal(imageio.read_png(path), a)


def test_png_writer_refuses_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((2, 4, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            imageio.write_png(str(tmp_path / 'x.png'), bad)


def test_port_imports_no_pil():
    """No module of the port imports Pillow, and the hooks write their PNGs
    in a process where it cannot be imported."""
    root = os.path.join(REPO, 'pixelssl_tpu_torch')
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith('.py'):
                with open(os.path.join(dirpath, name)) as f:
                    for line in f:
                        words = line.split()
                        assert not (words[:2] == ['import', 'PIL'] or
                                    words[:2] == ['from', 'PIL']), (
                            name, line)
    code = '\n'.join([
        'import sys, tempfile, os',
        "sys.modules['PIL'] = None",
        'import numpy as np, torch',
        'from pixelssl_tpu_torch import harness',
        'from pixelssl_tpu_torch.ssl_algorithm.ssl_base import '
        'save_gray_map',
        'from pixelssl_tpu_torch.tasks.sseg.func import '
        'SemanticSegmentationFunc',
        "args = harness.default_args('ssl_mt', num_classes=4)",
        'f = SemanticSegmentationFunc(args)',
        'd = tempfile.mkdtemp()',
        "f.visualize(os.path.join(d, 'v'), 'm', inp=(torch.zeros(1, 3, 4, "
        '4),), pred=(torch.zeros(1, 4, 4, 4),), gt=(torch.zeros(1, 4, 4, '
        'dtype=torch.long),))',
        "save_gray_map(np.zeros((4, 4)), os.path.join(d, 'g.png'))",
        "assert sorted(os.listdir(d)) == ['g.png', 'v_m1-inp.png', "
        "'v_m2-pred.png', 'v_m3-gt.png'], os.listdir(d)",
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


# ---------------------------------------------------------------------------
# the task hooks on the same arrays
# ---------------------------------------------------------------------------

def test_voc_colorize_matches_jax():
    gray = np.random.default_rng(0).integers(0, 23, (9, 13))
    gray[0, :4] = 255
    for n in (5, 22):
        np.testing.assert_array_equal(sseg_func.VOCColorize(n)(gray),
                                      jax_sseg_func.VOCColorize(n)(gray))
    np.testing.assert_array_equal(sseg_func.color_map(256),
                                  jax_sseg_func.color_map(256))


def _sseg_arrays(rng, u8):
    h, w, c = 12, 17, 5
    if u8:
        inp = rng.integers(0, 256, (1, h, w, 3)).astype(np.uint8)
    else:
        inp = (rng.standard_normal((1, h, w, 3)) * 1.5).astype(np.float32)
    pred = rng.random((1, h, w, c)).astype(np.float32)
    gt = rng.integers(0, c, (1, h, w)).astype(np.int32)
    gt[0, :3, :3] = 255
    return inp, pred, gt


@pytest.mark.parametrize('u8', [False, True])
def test_sseg_visualize_matches_jax(u8, tmp_path):
    """Input (float and ``--u8-transfer`` uint8), prediction and GT of the
    first sample: the input and prediction pixels equal; the GT map is the
    coloured labels, and its first column the JAX image's one row (F12)."""
    inp, pred, gt = _sseg_arrays(np.random.default_rng(int(u8)), u8)
    args = harness.default_args('ssl_mt', num_classes=5)
    jax_sseg_func.SemanticSegmentationFunc(args).visualize(
        str(tmp_path / 'j'), 'm', inp=(inp,), pred=(pred,), gt=(gt,))
    sseg_func.SemanticSegmentationFunc(args).visualize(
        str(tmp_path / 'p'), 'm',
        inp=(torch.from_numpy(inp).permute(0, 3, 1, 2),),
        pred=(torch.from_numpy(pred).permute(0, 3, 1, 2),),
        gt=(torch.from_numpy(gt).long(),))
    for panel in ('1-inp', '2-pred'):
        ours = imageio.read_png(str(tmp_path / 'p_m{0}.png'.format(panel)))
        theirs = _pil(str(tmp_path / 'j_m{0}.png'.format(panel)))
        np.testing.assert_array_equal(ours, theirs, err_msg=panel)
    ours = imageio.read_png(str(tmp_path / 'p_m3-gt.png'))
    theirs = _pil(str(tmp_path / 'j_m3-gt.png'))
    np.testing.assert_array_equal(ours,
                                  jax_sseg_func.VOCColorize(6)(gt[0]))
    assert theirs.shape == (1, gt.shape[1], 3)
    np.testing.assert_array_equal(ours[:, 0], theirs[0])


def test_sseg_visualize_pseudo_gt_matches_jax(tmp_path):
    pseudo = np.random.default_rng(4).random((1, 10, 14, 5)).astype(
        np.float32)
    args = harness.default_args('ssl_gct', num_classes=5)
    jax_sseg_func.SemanticSegmentationFunc(args).visualize_pseudo_gt(
        pseudo, str(tmp_path / 'j'), id_str='l')
    sseg_func.SemanticSegmentationFunc(args).visualize_pseudo_gt(
        torch.from_numpy(pseudo), str(tmp_path / 'p'), id_str='l')
    np.testing.assert_array_equal(
        imageio.read_png(str(tmp_path / 'p_l-pseudo-gt.png')),
        _pil(str(tmp_path / 'j_l-pseudo-gt.png')))


def test_sreg_visualize_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    inp = (rng.random((1, 9, 12, 3)) * 1.4 - 0.2).astype(np.float32)
    pred = (rng.random((1, 9, 12, 1)) * 1.4 - 0.2).astype(np.float32)
    gt = rng.random((1, 9, 12, 1)).astype(np.float32)
    pseudo = (rng.random((1, 9, 12, 1)) * 1.2).astype(np.float32)
    args = harness.default_args('ssl_gct', task='sreg')
    jfunc = jax_sreg_func.PixelRegressionFunc(args)
    func = sreg_func.PixelRegressionFunc(args)
    jfunc.visualize(str(tmp_path / 'j'), 'm', inp=(inp,), pred=(pred,),
                    gt=(gt,))
    jfunc.visualize_pseudo_gt(pseudo, str(tmp_path / 'j'), id_str='r')

    def nchw(x):
        return torch.from_numpy(x).permute(0, 3, 1, 2)

    func.visualize(str(tmp_path / 'p'), 'm', inp=(nchw(inp),),
                   pred=(nchw(pred),), gt=(nchw(gt),))
    func.visualize_pseudo_gt(torch.from_numpy(pseudo), str(tmp_path / 'p'),
                             id_str='r')
    for name in ('_m1-inp', '_m2-pred', '_m3-gt', '_r-pseudo-gt'):
        np.testing.assert_array_equal(
            imageio.read_png(str(tmp_path / ('p' + name + '.png'))),
            _pil(str(tmp_path / ('j' + name + '.png'))), err_msg=name)


@pytest.mark.parametrize('layout', ['nhwc', 'nchw', 'hw'])
def test_save_gray_map_matches_jax(layout, tmp_path):
    m = (np.random.default_rng(6).random((1, 11, 8, 1)) * 1.3 - 0.1).astype(
        np.float32)
    jax_base.save_gray_map(m, str(tmp_path / 'j.png'))
    ours = {'nhwc': torch.from_numpy(m),
            'nchw': torch.from_numpy(m).permute(0, 3, 1, 2),
            'hw': m[0, :, :, 0]}[layout]
    ssl_base.save_gray_map(ours, str(tmp_path / 'p.png'))
    np.testing.assert_array_equal(imageio.read_png(str(tmp_path / 'p.png')),
                                  _pil(str(tmp_path / 'j.png')))


# ---------------------------------------------------------------------------
# the algorithms' debug maps on the same weights
# ---------------------------------------------------------------------------

# AdvSSL at 64 px: D's five stride-2 convs leave one logit of a 32 px
# image, and its map would be flat
DEBUG_CASES = {
    'ssl_adv': dict(im_size=64, adv_for_labeled=True, labeled_adv_scale=0.01,
                    unlabeled_adv_scale=0.001, discriminator_lr=1e-4),
    'ssl_gct': dict(im_size=96, ssl_mode='gct', fc_ssl_scale=1.0,
                    dc_ssl_scale=1.0, dc_threshold=0.5, dc_rampup_epochs=1,
                    mu=0.5, nu=1),
}


def _debug_maps(algo_name, tmp_path):
    """Both packages' ``_debug_visualize`` of one batch on the same
    weights; returns {file suffix: (port pixels, JAX pixels)}."""
    extra = DEBUG_CASES[algo_name]
    im = extra['im_size']
    args_dict = dict(backbone='resnet10', num_classes=5, batch_size=4,
                     unlabeled_batch_size=2, ignore_unlabeled=False,
                     bf16=False, lr=5e-5, momentum=0.9, epochs=2, **extra)
    rng = np.random.default_rng(9)
    images = rng.standard_normal((4, im, im, 3)).astype(np.float32)
    labels = rng.integers(0, 5, (4, im, im)).astype(np.int32)
    labels[:2, :4, :4] = 255
    labels[2:] = -1

    mesh = jax_parallel.make_mesh(1)
    jalgo = jax_harness.build_algorithm(
        jax_harness.default_args(algo_name, **args_dict), mesh=mesh)
    state = jax.tree.map(np.asarray, jax.device_get(jalgo.state))
    if 'd_model' in state:
        # D at its init maps every pixel within a gray level of 127: its
        # five layers' weights tripled, its maps span some gray levels
        state['d_model'] = jax.tree.map(lambda x: x * 3.0,
                                        state['d_model'])
        jalgo.state = jax.device_put(
            state, jax_parallel.replicate_sharding(mesh))
    algo = harness.build_algorithm(
        harness.default_args(algo_name, **args_dict), device='cpu')
    for key, module in algo.modules.items():
        module.load_state_dict(from_jax(state[key]))
    jalgo._debug_visualize(
        jax_parallel.shard_batch({'inp': (images,), 'gt': (labels,)}, mesh),
        str(tmp_path / 'j'))
    with algo._evaluating():
        algo._debug_visualize(harness._to_batch(images, labels, 'cpu'),
                              str(tmp_path / 'p'))
    names = sorted(n[1:] for n in os.listdir(tmp_path) if n[0] == 'j')
    assert names == sorted(n[1:] for n in os.listdir(tmp_path)
                           if n[0] == 'p')
    return {name: (imageio.read_png(str(tmp_path / ('p' + name))),
                   _pil(str(tmp_path / ('j' + name)))) for name in names}


def test_adv_debug_visualize_matches_jax(tmp_path):
    maps = _debug_maps('ssl_adv', tmp_path)
    assert sorted(maps) == ['_labeled-cmap.png', '_unlabeled-cmap.png']
    for name, (ours, theirs) in maps.items():
        assert ours.shape == theirs.shape == (64, 64), name
        assert int(np.abs(ours.astype(int) - theirs).max()) <= 1, name
        assert ours.std() > 0, name


def test_gct_debug_visualize_matches_jax(tmp_path):
    maps = _debug_maps('ssl_gct', tmp_path)
    assert sorted(maps) == ['_l-fmap-gt.png', '_l-fmap.png',
                            '_l-pseudo-gt.png', '_r-fmap-gt.png',
                            '_r-fmap.png', '_r-pseudo-gt.png']
    for name, (ours, theirs) in maps.items():
        assert ours.shape == theirs.shape, name
        if 'pseudo' in name:
            # coloured argmax of a per-pixel pick between the two models
            # by their thresholded flawmaps: where two flawmaps tie within
            # float32 noise the pick, and so the colour, may flip (0.23%
            # of the pixels measured)
            same = (ours == theirs).all(axis=-1).mean()
            assert same >= 0.99, (name, same)
        else:
            assert int(np.abs(ours.astype(int) - theirs).max()) <= 1, name
            assert ours.std() > 0, name


# ---------------------------------------------------------------------------
# run_script's file names
# ---------------------------------------------------------------------------

def _viz_config(out, sub_path, steps_per_dispatch):
    """tests/test_visualization.py's config (MT, ResNet-10 @32, 16
    synthetic samples, batch 2 + 1, ``visual_freq`` 1), float32, no
    workers."""
    return collections.OrderedDict([
        ('exp_id', 'viz'),
        ('out_path', str(out)),
        ('ssl_algorithm', 'ssl_mt'),
        ('trainset', {'synthetic_sseg': ['/tmp']}),
        ('valset', {'synthetic_sseg': ['/tmp']}),
        ('num_workers', 0),
        ('im_size', 32),
        ('synthetic_samples', 16),
        ('sublabeled_path', str(sub_path)),
        ('ignore_unlabeled', False),
        ('epochs', 1),
        ('batch_size', 2),
        ('unlabeled_batch_size', 1),
        ('models', {'model': 'deeplabv2'}),
        ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),
        ('lr', 0.001),
        ('momentum', 0.9),
        ('backbone', 'resnet10'),
        ('num_classes', 4),
        ('log_freq', 1),
        ('cons_scale', 1.0),
        ('cons_rampup_epochs', 1),
        ('ema_decay', 0.99),
        ('bf16', False),
        ('visualize', True),
        ('visual_freq', 1),
        ('val_freq', 1),
        ('checkpoint_freq', 10),  # none: the names are what is compared
        ('steps_per_dispatch', steps_per_dispatch),
    ])


def _pngs(root):
    out = {}
    for sub in ('debug', 'train', 'val'):
        d = os.path.join(str(root), 'viz', 'visualization', sub)
        out[sub] = sorted(os.listdir(d))
    return out


@pytest.mark.parametrize('steps_per_dispatch', [1, 2])
def test_run_script_writes_the_jax_file_names(steps_per_dispatch, tmp_path):
    """The same config through both packages' ``run_script`` path (the JAX
    proxy on a one-device mesh): the same folders and PNG names, the
    train PNGs at the input's size, and the port's pixels as its reader
    reads them."""
    sub = tmp_path / 'sublabeled.txt'
    sub.write_text(''.join('synthetic_{0:05d}\n'.format(i)
                           for i in range(0, 16, 2)))
    jconfig = _viz_config(tmp_path / 'jax', sub, steps_per_dispatch)
    parser = pixelssl_tpu.create_parser('ssl_mt')
    jax_sseg.add_parser_arguments(parser)
    jargs = jax_cmd.parse_args(parser, jconfig, cli_override=False)
    jax_sseg.SemanticSegmentationProxy(
        jargs, mesh=jax_parallel.make_mesh(1)).run()

    pixelssl_tpu_torch.run_script(
        _viz_config(tmp_path / 'port', sub, steps_per_dispatch), sseg,
        sseg.SemanticSegmentationProxy, device='cpu', cli_override=False)
    ours, theirs = _pngs(tmp_path / 'port'), _pngs(tmp_path / 'jax')
    assert ours == theirs
    assert ours['train'] and ours['val'] and not ours['debug']
    names = ' '.join(ours['train'])
    for token in ('student', 'teacher', '1-inp', '2-pred', '3-gt'):
        assert token in names, token
    for name in ours['train'] + ours['val']:
        px = imageio.read_png(os.path.join(
            str(tmp_path / 'port'), 'viz', 'visualization',
            'train' if name in ours['train'] else 'val', name))
        assert px.shape == (32, 32, 3), name
