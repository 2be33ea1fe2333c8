"""The port's ``scripts/rescore.py`` against the JAX package's
``scripts/rescore.py`` on the same reference-layout torch checkpoint and
the same miniature VOC tree (the helpers of tests/test_rescore.py), at
ResNet-10 / 65 px: their mIoU agree within 1e-3 (measured: equal to
float32 rounding, both validate 3 images with the exact protocol from the
same converted weights), and ``pretrained/<exp_id>.pth``, which the port's
rescore writes, loads back into the port's script, whose default config
rescores it, with the same mIoU.
"""

import os
import sys

import pytest

from pixelssl_tpu import parallel

import pixelssl_tpu_torch
from pixelssl_tpu_torch.scripts import rescore as port_rescore
from pixelssl_tpu_torch.tasks import sseg

from test_rescore import _make_voc_fixture, _reference_style_ckpt
from test_torch_mt import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))

SCRIPT = 'deeplabv2_pascalvoc_1-8_suponly'


def test_rescore_matches_jax_and_reloads(tmp_path, monkeypatch):
    import rescore as jax_rescore

    voc = _make_voc_fixture(str(tmp_path / 'VOC2012'))
    ckpt = str(tmp_path / (SCRIPT + '.ckpt'))
    _reference_style_ckpt(ckpt)
    monkeypatch.chdir(tmp_path)  # pretrained/ and result/ land here
    overrides = {'backbone': 'resnet10', 'im_size': 65, 'num_workers': 0}

    # one device: validation takes batch 1 with the exact protocol
    theirs = jax_rescore.rescore(
        'scripts/{0}.py'.format(SCRIPT), ckpt, voc_root=voc, save=False,
        mesh=parallel.make_mesh(1),
        overrides=dict(overrides, out_path=str(tmp_path / 'jax')))
    ours = port_rescore.rescore(
        'pixelssl_tpu_torch/scripts/{0}.py'.format(SCRIPT), ckpt,
        voc_root=voc, device='cpu',
        overrides=dict(overrides, out_path=str(tmp_path / 'port')))
    assert sorted(ours) == sorted(theirs) == ['ssl_null_metric_mIoU']
    key = 'ssl_null_metric_mIoU'
    assert 0.0 <= ours[key] <= 1.0
    assert abs(ours[key] - theirs[key]) <= 1e-3, (ours, theirs)

    pretrained = tmp_path / 'pretrained' / (SCRIPT + '.pth')
    assert pretrained.exists()
    config = dict(port_rescore.runpy.run_path(os.path.join(
        port_rescore._SCRIPTS, SCRIPT + '.py'))['config'])
    assert config['resume'] == 'pretrained/{0}.pth'.format(SCRIPT)
    assert config['validation'] is True
    config.update(overrides, out_path=str(tmp_path / 'again'),
                  trainset={'pascal_voc_aug': [voc]},
                  valset={'pascal_voc_aug': [voc]})
    proxy = pixelssl_tpu_torch.run_script(
        config, sseg, sseg.SemanticSegmentationProxy, device='cpu',
        cli_override=False)
    again = {k: float(m.avg) for k, m in
             proxy.ssl_algorithm.meters.items() if 'mIoU' in k}
    assert again == pytest.approx(ours, abs=1e-6)
