"""The port's experiment path, ``run_script`` -> task proxy -> two-stream
loader -> epoch loop -> validation -> checkpoint, against the JAX
package's on the same config: a Mean Teacher run of one epoch (4
iterations) on a half-labeled synthetic set, ResNet-10 at 64 px, float32,
lr 5e-5 (tests/test_torch_mt.py: the toy diverges at 2.5e-4), no input
noise. The JAX package runs through its proxy on a one-device mesh; the
port on the CPU, from the JAX package's initial weights (carried across by
``models.convert.from_jax`` before ``run()``), with two loader workers.

Tolerances, as tests/test_torch_mt.py and tests/test_torch_eval.py state
them: each iteration's train record, rtol 2e-3 on the task losses and the
lr, rtol 2e-2 with atol 1e-9 on ``cons_loss``; the val losses rtol 2e-3,
the scores (acc, acc_class, mIoU, fwIoU) atol 1e-3. The rescore of the
port's own checkpoint reproduces its val metrics exactly.
"""

import collections
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from pixelssl_tpu import parallel
from pixelssl_tpu import runner as jax_runner
from pixelssl_tpu.tasks import sseg as jax_sseg
from pixelssl_tpu.utils import cmd as jax_cmd

import pixelssl_tpu_torch
from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.tasks import sseg
from pixelssl_tpu_torch.utils import logger

from test_torch_mt import one_torch_thread  # noqa: F401

N_SAMPLES = 16
TRAIN_KEYS = ('s_task_loss', 't_task_loss', 'cons_loss', 'lr')
TRAIN_TOLS = {'cons_loss': (2e-2, 1e-9)}


def _config(out, sub_path, **overrides):
    cfg = collections.OrderedDict([
        ('exp_id', 'mt'),
        ('out_path', str(out)),
        ('ssl_algorithm', 'ssl_mt'),
        ('trainset', {'synthetic_sseg': ['synthetic']}),
        ('valset', {'synthetic_sseg': ['synthetic']}),
        ('synthetic_samples', N_SAMPLES),
        ('sublabeled_path', str(sub_path)),
        ('ignore_unlabeled', False),
        ('models', {'model': 'deeplabv2'}),
        ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),
        ('backbone', 'resnet10'),
        ('im_size', 64),
        ('num_classes', 5),
        ('batch_size', 4),
        ('unlabeled_batch_size', 2),
        ('epochs', 1),
        ('log_freq', 1),
        ('bf16', False),
        ('lr', 5e-5), ('momentum', 0.9), ('weight_decay', 5e-4),
        ('cons_for_labeled', False), ('cons_scale', 1.0),
        ('cons_rampup_epochs', 3), ('ema_decay', 0.99),
        ('num_workers', 2),
        ('seed', 5),
    ])
    cfg.update(overrides)
    return cfg


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _port_proxy(config):
    """The port's proxy built (not run) from ``config`` on the CPU."""
    parser = pixelssl_tpu_torch.create_parser(config['ssl_algorithm'])
    sseg.add_parser_arguments(parser)
    args = pixelssl_tpu_torch.utils.cmd.parse_args(parser, config,
                                                   cli_override=False)
    return sseg.SemanticSegmentationProxy(args, device='cpu')


def _run_both(root):
    """One MT run of each package from the same initial weights; returns
    their ``metrics.jsonl`` records, the port's proxy and its config."""
    sub_path = root / 'sublabeled.txt'
    sub_path.write_text(''.join('synthetic_{0:05d}\n'.format(i)
                                for i in range(0, N_SAMPLES, 2)))

    jconfig = _config(root / 'jax', sub_path, num_workers=0)
    parser = jax_runner.create_parser('ssl_mt')
    jax_sseg.add_parser_arguments(parser)
    jargs = jax_cmd.parse_args(parser, jconfig, cli_override=False)
    jproxy = jax_sseg.SemanticSegmentationProxy(
        jargs, mesh=parallel.make_mesh(1))
    initial = jax.tree.map(np.asarray,
                           jax.device_get(jproxy.ssl_algorithm.state))
    jproxy.run()

    config = _config(root / 'port', sub_path)
    proxy = _port_proxy(config)
    for key, module in proxy.ssl_algorithm.modules.items():
        module.load_state_dict(from_jax(initial[key]))
    proxy.run()
    return (_records(root / 'jax' / 'mt' / 'metrics.jsonl'),
            _records(root / 'port' / 'mt' / 'metrics.jsonl'), proxy, config)


def _check_train_records(ours_all, theirs_all):
    ours = [r for r in ours_all if r['phase'] == 'train']
    theirs = [r for r in theirs_all if r['phase'] == 'train']
    assert [r['iter'] for r in ours] == [r['iter'] for r in theirs] == [
        1, 2, 3, 4]
    for a, b in zip(ours, theirs):
        for key in TRAIN_KEYS:
            rtol, atol = TRAIN_TOLS.get(key, (2e-3, 1e-6))
            assert np.isclose(a[key], b[key], rtol=rtol, atol=atol), (
                a['iter'], key, a[key], b[key])
    assert ours[0]['cons_loss'] == 0.0 and ours[2]['cons_loss'] > 0.0
    summary = [r for r in ours_all if r['phase'] == 'epoch_summary']
    assert len(summary) == 1 and summary[0]['iters'] == 4
    assert summary[0]['n_chips'] == 1 and summary[0]['samples_per_sec'] > 0


def _check_val_scores(ours_all, theirs_all):
    (ours, ) = [r for r in ours_all if r['phase'] == 'val']
    (theirs, ) = [r for r in theirs_all if r['phase'] == 'val']
    keys = sorted(k for k in theirs if 'metric' in k or k.endswith('_loss'))
    assert keys == sorted(k for k in ours if 'metric' in k or
                          k.endswith('_loss'))
    assert any(k.startswith('teacher_metric_mIoU') for k in keys)
    for key in keys:
        if key.endswith('_loss'):
            assert np.isclose(ours[key], theirs[key], rtol=2e-3), key
        else:
            assert abs(ours[key] - theirs[key]) <= 1e-3, key


def _check_checkpoint_and_lr_schedule(proxy, ours_all):
    """``checkpoint_1.pth`` saved after the 4 steps, and a schedule that
    counts the proxy's 4 iterations an epoch: the lr of each iteration is
    the poly schedule of its step over 4 steps."""
    algo = proxy.ssl_algorithm
    assert proxy.args.iters_per_epoch == len(proxy.train_loader) == 4
    assert algo.ctx.iters_per_epoch == 4 and algo.state.step == 4
    lrs = [r['lr'] for r in ours_all if r['phase'] == 'train']
    np.testing.assert_allclose(
        lrs, [5e-5 * (1 - s / 4) ** 0.9 for s in range(4)], rtol=1e-6)
    ckpt = torch.load(proxy.args.checkpoint_path + '/checkpoint_1.pth',
                      weights_only=True)
    assert ckpt['epoch'] == 1 and ckpt['step'] == 4


def _check_rescore(config, ckpt_dir, ours_all, how):
    """Validation only, from ``checkpoint_1.pth`` named by ``--resume`` or
    found by ``--auto-resume``: every val metric equal to the training
    run's."""
    config = collections.OrderedDict(config)
    config['validation'] = True
    if how == 'resume':
        config['resume'] = ckpt_dir + '/checkpoint_1.pth'
    else:
        config['auto_resume'] = True
    proxy = pixelssl_tpu_torch.run_script(
        config, sseg, sseg.SemanticSegmentationProxy, device='cpu',
        cli_override=False)
    assert proxy.args.resume == ckpt_dir + '/checkpoint_1.pth'
    (trained, ) = [r for r in ours_all if r['phase'] == 'val']
    rescored = _records(ckpt_dir + '/../metrics.jsonl')[-1]
    assert rescored['phase'] == 'val' and rescored['epoch'] == 1
    for key, value in trained.items():
        if 'metric' in key or key.endswith('_loss'):
            assert rescored[key] == value, (how, key)


def test_run_script_mt_matches_jax_and_rescores(tmp_path):
    """The MT runs of both packages (one test, so that the JAX run is
    built once whatever the worker count): train records and val scores
    within the stated tolerances, the checkpoint and the lr schedule, then
    the port's rescore by ``--resume`` and by ``--auto-resume``. The
    checkpoints (about 200 MB each) are removed at the end."""
    try:
        theirs, ours, proxy, config = _run_both(tmp_path)
        _check_train_records(ours, theirs)
        _check_val_scores(ours, theirs)
        _check_checkpoint_and_lr_schedule(proxy, ours)
        for how in ('resume', 'auto_resume'):
            _check_rescore(config, proxy.args.checkpoint_path, ours, how)
    finally:
        shutil.rmtree(tmp_path / 'jax', ignore_errors=True)
        shutil.rmtree(tmp_path / 'port', ignore_errors=True)


def test_proxy_and_harness_build_the_same_algorithm(tmp_path):
    """One builder behind both: a harness-built SupOnly with the proxy's
    iters_per_epoch, fed the proxy loader's batches, takes the proxy-built
    one's steps exactly."""
    sub = tmp_path / 'sub.txt'
    sub.write_text('')
    config = _config(tmp_path, sub, ssl_algorithm='ssl_null',
                     sublabeled_path='', ignore_unlabeled=True,
                     unlabeled_batch_size=0, synthetic_samples=8,
                     im_size=32, num_workers=0, out_path='')
    proxy = _port_proxy(config)
    algo = harness.build_algorithm(proxy.args, device='cpu',
                                   iters_per_epoch=len(proxy.train_loader))
    for key, module in proxy.ssl_algorithm.modules.items():
        for a, b in zip(module.state_dict().values(),
                        algo.modules[key].state_dict().values()):
            assert torch.equal(a, b)
    for batch in proxy.train_loader:
        ours = proxy.ssl_algorithm.train_step(batch)
        theirs = algo.train_step(batch)
        for key in ours:
            assert float(ours[key]) == float(theirs[key]), key


def test_unported_flags_parse_at_their_defaults_without_a_warning(
        monkeypatch):
    """The optimizer and sseg model flags, once refused, parse at the JAX
    package's defaults (no "Unknown argument" warning) and give them."""
    from pixelssl_tpu_torch.utils import cmd

    warnings = []
    monkeypatch.setattr(cmd.logger, 'log_warn',
                        lambda *msgs: warnings.append(msgs))
    defaults = {'alpha': -1, 'centered': False, 'eps': -1, 'beta1': -1,
                'beta2': -1, 'amsgrad': False, 'clip_grad_norm': -1,
                'bf16_opt_state': False, 'freeze_bn': False,
                'pretrained_path': '', 'remat': False}
    parser = pixelssl_tpu_torch.create_parser('ssl_mt')
    sseg.add_parser_arguments(parser)
    args = cmd.parse_args(parser, defaults, cli_override=False)
    assert warnings == []
    for name, value in defaults.items():
        assert getattr(args, name) == value, name


def _script_dict_values():
    """``str()`` of every dict value of the port's 17 experiment scripts."""
    import runpy

    here = os.path.join(os.path.dirname(os.path.abspath(
        pixelssl_tpu_torch.__file__)), 'scripts')
    values = set()
    for name in sorted(os.listdir(here)):
        if name.endswith('.py') and 'pascalvoc' in name:
            config = runpy.run_path(os.path.join(here, name))['config']
            values.update(str(v) for v in config.values()
                          if isinstance(v, dict))
    return sorted(values)


YAML_FLOW = [
    '{model: pspnet}',
    '{pascal_voc_aug: [dataset/PascalVOC/VOCdevkit/VOC2012]}',
    '{model: sgd, d_model: adam}',
    "{a: 1e-3, b: 1.5, c: 1.0e+3, d: .5, e: 010, f: 0x1F, g: 1_000}",
    '{h: 1:30, i: -.inf, j: yes, k: Off, l: ~, m: null, n: , o: TRUE}',
    "{p: 'it''s', q: \"a\\tb\\u00e9\", r: [1, [2, {s: t}]], u v: w x}",
    '{model: {x: [a, b,], y: {}}, z: []}',
    '{a}', '{a: b:c, d: http://x.y/z}', '{ a : 1 , b : [ 2 , 3 ] }',
    '{1: 2, 2.5: x, -0: 0b101}', "{'model': 'deeplabv2'}",
]


@pytest.mark.parametrize('text', YAML_FLOW + _script_dict_values())
def test_strdict_reads_what_yaml_full_load_reads(text):
    """The dict flags (F7): ``cmd.strdict`` against ``yaml.full_load``,
    which the JAX package applies to them, on YAML flow mappings (PyYAML's
    YAML 1.1 scalars: ``1e-3`` a string, ``010`` octal, ``yes`` true) and on
    the scripts' own values."""
    import yaml

    from pixelssl_tpu_torch.utils import cmd

    assert repr(cmd.strdict(text)) == repr(yaml.full_load(text))


def test_run_script_help_lists_every_flag(monkeypatch, capsys):
    monkeypatch.setattr(sys, 'argv', ['script', '--help'])
    with pytest.raises(SystemExit) as err:
        pixelssl_tpu_torch.run_script({'ssl_algorithm': 'ssl_mt'}, sseg,
                                      sseg.SemanticSegmentationProxy)
    assert err.value.code == 0
    out = capsys.readouterr().out
    for flag in ('--exact-val', '--auto-resume', '--cons-scale',
                 '--synthetic-samples', '--u8-transfer', '--num-classes'):
        assert flag in out, flag


_NO_VOC_TREE = ('Cannot find prefix file: dataset/PascalVOC/VOCdevkit/'
                'VOC2012/ImageSets/Segmentation/')


@pytest.mark.parametrize('script', ['deeplabv2_pascalvoc_1-8_ssladv.py',
                                    'deeplabv2_pascalvoc_1-8_ssls4l.py'])
def test_adv_and_s4l_scripts_stop_at_the_voc_input_path(script, tmp_path,
                                                        monkeypatch):
    """As written, the 1-8 AdvSSL and S4L scripts parse every key (the
    AdvSSL recipe's vestigial ``milestones``/``gamma`` included, with no
    "Unknown argument" warning) and stop at the VOC tree, which the
    repository does not hold. Their output goes under ``tmp_path``."""
    import runpy

    from pixelssl_tpu_torch.utils import cmd

    config = runpy.run_path(os.path.join(
        os.path.dirname(os.path.abspath(pixelssl_tpu_torch.__file__)),
        'scripts', script))['config']
    config['out_path'] = str(tmp_path)
    warnings = []
    monkeypatch.setattr(cmd.logger, 'log_warn',
                        lambda *msgs: warnings.append(msgs))
    parser = pixelssl_tpu_torch.create_parser(config['ssl_algorithm'])
    sseg.add_parser_arguments(parser)
    args = cmd.parse_args(parser, config, cli_override=False)
    assert warnings == []
    if 'milestones' in config:
        assert args.milestones == [10, 20] and args.gamma == 0.1
    with pytest.raises(logger.FatalError) as err:
        pixelssl_tpu_torch.run_script(config, sseg,
                                      sseg.SemanticSegmentationProxy,
                                      device='cpu', cli_override=False)
    assert _NO_VOC_TREE in str(err.value)


NEW_SCRIPTS = ['pspnet_pascalvoc_1-8_suponly.py', 'pspnet_pascalvoc_1-8_sslmt.py',
               'pspnet_pascalvoc_1-8_ssladv.py', 'pspnet_pascalvoc_1-8_ssls4l.py',
               'pspnet_pascalvoc_1-8_sslgct.py', 'pspnet_pascalvoc_1-8_sslcct.py',
               'pspnet_pascalvoc_1-8_sslcutmix.py',
               'pspnet_pascalvoc_1-16_suponly.py',
               'pspnet_pascalvoc_1-4_suponly.py',
               'pspnet_pascalvoc_1-2_suponly.py',
               'pspnet_pascalvoc_full_suponly.py',
               'deeplabv2_pascalvoc_full_suponly.py']


@pytest.mark.parametrize('script', NEW_SCRIPTS)
def test_pspnet_and_full_scripts_stop_at_the_voc_input_path(script, tmp_path,
                                                            monkeypatch):
    """As written, each port copy of the PSPNet scripts and of the full
    DeepLab-v2 SupOnly script parses every key with no "Unknown argument"
    warning, holds the JAX script's config (its pretrained checkpoint a
    ``.pth`` file), and stops at the VOC datasets
    (its tree, which the repository does not hold). Their output goes
    under ``tmp_path``."""
    import runpy

    from pixelssl_tpu_torch.utils import cmd

    here = os.path.dirname(os.path.abspath(pixelssl_tpu_torch.__file__))
    config = runpy.run_path(os.path.join(here, 'scripts', script))['config']
    jax_config = runpy.run_path(os.path.join(here, '..', 'scripts',
                                             script))['config']
    if jax_config['resume']:  # the port's checkpoints are .pth files
        jax_config['resume'] = jax_config['resume'].replace('.ckpt', '.pth')
    assert config == jax_config
    assert config['im_size'] == (513 if script.startswith('pspnet') else 321)
    config['out_path'] = str(tmp_path)
    warnings = []
    monkeypatch.setattr(cmd.logger, 'log_warn',
                        lambda *msgs: warnings.append(msgs))
    parser = pixelssl_tpu_torch.create_parser(config['ssl_algorithm'])
    sseg.add_parser_arguments(parser)
    cmd.parse_args(parser, config, cli_override=False)
    assert warnings == []
    with pytest.raises(logger.FatalError) as err:
        pixelssl_tpu_torch.run_script(config, sseg,
                                      sseg.SemanticSegmentationProxy,
                                      device='cpu', cli_override=False)
    assert _NO_VOC_TREE in str(err.value)


def test_run_script_pspnet_cct_matches_jax_and_rescores(tmp_path):
    """A tiny PSPNet CCT run of each package through ``run_script``'s
    proxy (ResNet-10, 64 px, 8 synthetic samples, one epoch of 2
    iterations, one decoder of each family) from the same initial weights:
    the first iteration's ``task_loss`` and lr within rtol 2e-3 (the
    weights and the batch are the same; later iterations follow from
    decoder draws that the packages cannot share, ROADMAP F3), every
    ``cons_loss`` finite and > 0, and the port's rescore from its
    ``checkpoint_1.pth`` equal to its training run's validation."""
    sub_path = tmp_path / 'sublabeled.txt'
    sub_path.write_text(''.join('synthetic_{0:05d}\n'.format(i)
                                for i in range(0, 8, 2)))
    cct = dict(
        exp_id='cct', ssl_algorithm='ssl_cct', synthetic_samples=8,
        models={'model': 'pspnet'}, cons_scale=30.0, cons_rampup_epochs=1,
        ad_lr_scale=10.0, vat_dec_num=1, drop_dec_num=1, cut_dec_num=1,
        context_dec_num=1, object_dec_num=1, fn_dec_num=1, fd_dec_num=1)
    for key in ('cons_for_labeled', 'ema_decay'):
        cct[key] = None
    try:
        jconfig = _config(tmp_path / 'jax', sub_path, num_workers=0, **cct)
        jconfig = collections.OrderedDict(
            (k, v) for k, v in jconfig.items() if v is not None)
        parser = jax_runner.create_parser('ssl_cct')
        jax_sseg.add_parser_arguments(parser)
        jargs = jax_cmd.parse_args(parser, jconfig, cli_override=False)
        jproxy = jax_sseg.SemanticSegmentationProxy(
            jargs, mesh=parallel.make_mesh(1))
        initial = jax.tree.map(np.asarray,
                               jax.device_get(jproxy.ssl_algorithm.state))
        jproxy.run()
        theirs = _records(tmp_path / 'jax' / 'cct' / 'metrics.jsonl')

        config = collections.OrderedDict(
            (k, v) for k, v in _config(tmp_path / 'port', sub_path,
                                       **cct).items() if v is not None)
        proxy = _port_proxy(config)
        proxy.ssl_algorithm.modules['model'].load_state_dict(
            from_jax(initial['model']))
        proxy.run()
        ours = _records(tmp_path / 'port' / 'cct' / 'metrics.jsonl')

        train = [r for r in ours if r['phase'] == 'train']
        jtrain = [r for r in theirs if r['phase'] == 'train']
        assert [r['iter'] for r in train] == [r['iter'] for r in jtrain] == [
            1, 2]
        for key in ('task_loss', 'lr'):
            assert np.isclose(train[0][key], jtrain[0][key], rtol=2e-3,
                              atol=1e-6), key
        for r in train:
            assert np.isfinite(r['cons_loss']) and r['cons_loss'] > 0, r
        _check_rescore(config, proxy.args.checkpoint_path, ours, 'resume')
    finally:
        shutil.rmtree(tmp_path / 'jax', ignore_errors=True)
        shutil.rmtree(tmp_path / 'port', ignore_errors=True)
