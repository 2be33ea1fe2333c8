"""The sseg model flags of the port against the JAX package's:
``--freeze-bn`` and ``--remat`` through three Mean Teacher steps,
``--pretrained-path`` through the torch-checkpoint loaders,
``SyncBatchNorm(sample_weight)``, and the quickstart script's config.

Tolerances, as tests/test_torch_mt.py states them: rtol 2e-3 on the task
losses and the lr, rtol 2e-2 with atol 1e-9 on ``cons_loss``; terminal
params atol 3e-4; BN running statistics atol 1e-4 with rtol 1e-4. The
remat run of the port equals its run without remat: the same forward, and
a recompute that leaves the running statistics alone. A loaded checkpoint
equals, tensor for tensor, what the JAX package's converters make of it.
"""

import collections
import os
import runpy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pixelssl_tpu
from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu.models import layers as jax_layers
from pixelssl_tpu.tasks.sseg import model as jax_sseg_model

import pixelssl_tpu_torch
from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models import layers
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.models.deeplab_v2 import DeepLabV2
from pixelssl_tpu_torch.models.pspnet import PSPNet
from pixelssl_tpu_torch.tasks.sseg import model as sseg_model

from test_torch_gct import _assert_close
from test_torch_mt import MT_ARGS, _jax_and_port, one_torch_thread  # noqa: F401
from test_torch_mt import run_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MT_KEYS = ('s_task_loss', 't_task_loss', 'cons_loss', 'lr')
MT_TOLS = {'cons_loss': (2e-2, 1e-9)}


def _stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if 'running_' in k or 'num_batches' in k}


@pytest.mark.parametrize('flag', ['freeze_bn', 'remat'])
def test_mt_three_steps_match_jax_with_the_flag(flag):
    rng = np.random.default_rng(21)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port(
        'ssl_mt', dict(MT_ARGS, cons_for_labeled=False, **{flag: True}), rng)
    before = _stats(algo.model)
    final, history = run_steps(jalgo, jstate, jbatch, algo, batch, MT_KEYS,
                               MT_TOLS)
    assert history[2]['cons_loss'] > 0.0
    _assert_close(algo.model, final['model'], 3e-4, 1e-4, 'student')
    _assert_close(algo.teacher, final['teacher'], 3e-4, 1e-4, 'teacher')
    after = _stats(algo.model)
    if flag == 'freeze_bn':
        # in eval mode whatever the algorithm asks: the statistics stay
        assert not algo.model.net.training and algo.model.training
        for key in before:
            assert torch.equal(before[key], after[key]), key
    else:
        assert any(not torch.equal(before[k], after[k]) for k in before)


def test_remat_equals_the_run_without_it():
    """Three MT steps from the same weights and batch with and without
    ``--remat``: the same losses, the same running statistics (each moved
    once a forward) and the same parameters."""
    args = {remat: harness.default_args('ssl_mt', **dict(
        MT_ARGS, cons_for_labeled=False, remat=remat))
        for remat in (False, True)}
    algos = {remat: harness.build_algorithm(a, device='cpu',
                                            iters_per_epoch=2)
             for remat, a in args.items()}
    algos[True].model.load_state_dict(algos[False].model.state_dict())
    algos[True].teacher.load_state_dict(algos[False].teacher.state_dict())
    batch = harness.synthetic_batch(args[False], device='cpu', seed=4)
    for _ in range(3):
        plain = algos[False].train_step(batch)
        remat = algos[True].train_step(batch)
        for key in plain:
            assert float(plain[key]) == float(remat[key]), key
    for module in ('model', 'teacher'):
        ours = algos[True].modules[module].state_dict()
        for key, value in algos[False].modules[module].state_dict().items():
            if 'running_' in key or 'num_batches' in key:
                assert torch.equal(ours[key], value), (module, key)
            else:
                np.testing.assert_allclose(ours[key].numpy(), value.numpy(),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=module + ' ' + key)
    assert int(ours['net.backbone.bn1.num_batches_tracked']) == 3


# --pretrained-path ---------------------------------------------------------

def _randomised(module, seed):
    """``module``'s state dict with every float tensor redrawn (so that a
    copied tensor shows), running variances positive."""
    generator = torch.Generator().manual_seed(seed)
    out = collections.OrderedDict()
    for key, value in module.state_dict().items():
        if value.is_floating_point():
            value = torch.randn(value.shape, generator=generator)
            if key.endswith('running_var'):
                value = value.abs() + 0.5
        else:
            value = value + 7  # num_batches_tracked: never copied
        out[key] = value
    return out


def _reference_pspnet_key(key):
    """The port's PSPNet name -> the reference's (task/sseg/module/
    _pspnet.py layout)."""
    for ours, theirs in (('psp.bottleneck_conv.', 'psp.bottleneck.0.'),
                         ('psp.bottleneck_bn.', 'psp.bottleneck.1.'),
                         ('decoder.conv1x1.', 'decoder.0.')):
        key = key.replace(ours, theirs)
    parts = key.split('.')
    if parts[:2] == ['psp', 'stages']:
        parts[3] = {'conv': '1', 'bn': '2'}[parts[3]]
    if parts[:2] == ['decoder', 'shuffle']:
        parts[1:3] = [str(int(parts[2]) + 1)]
    return '.'.join(parts)


def _checkpoint(kind, path):
    """A torch checkpoint of the reference's layout, written from a
    randomised port module: ``backbone`` a bare ResNet-10 with a torchvision
    ``fc``, ``deeplabv2``/``pspnet`` a full model under ``state_dict`` with
    ``module.model.`` prefixes, ``deeplabv2_21`` a full DeepLab-v2 whose
    21-class head does not fit a 5-class model."""
    if kind == 'backbone':
        state = _randomised(DeepLabV2('resnet10', num_classes=5).backbone, 1)
        state['fc.weight'] = torch.randn(1000, 2048)
        state['fc.bias'] = torch.randn(1000)
    else:
        net_class = PSPNet if kind == 'pspnet' else DeepLabV2
        classes = 21 if kind == 'deeplabv2_21' else 5
        net = _randomised(net_class('resnet10', num_classes=classes), 2)
        if kind == 'pspnet':
            net = {_reference_pspnet_key(k): v for k, v in net.items()}
        state = {'state_dict': {'module.model.' + k: v
                                for k, v in net.items()},
                 'epoch': 3}
    torch.save(state, path)


def _model_pair(kind):
    arch = 'pspnet' if kind == 'pspnet' else 'deeplabv2'
    flags = dict(backbone='resnet10', num_classes=5, im_size=64, bf16=False)
    jargs = jax_harness.default_args('ssl_null', **flags)
    jmodel = {'pspnet': jax_sseg_model.PSPNetModel,
              'deeplabv2': jax_sseg_model.DeepLabV2Model}[arch](jargs)
    variables = jax.tree.map(np.asarray, jax.device_get(jax.jit(
        lambda key: jmodel.module.init(key, (jnp.zeros((1, 64, 64, 3)),),
                                       train=False))(jax.random.PRNGKey(3))))
    args = harness.default_args('ssl_null', **flags)
    model = {'pspnet': sseg_model.PSPNetModel,
             'deeplabv2': sseg_model.DeepLabV2Model}[arch](args)
    model.load_state_dict(from_jax(variables))
    return jmodel, variables, model


@pytest.mark.parametrize('kind', ['backbone', 'deeplabv2', 'deeplabv2_21',
                                  'pspnet'])
def test_pretrained_checkpoint_loads_as_in_jax(kind, tmp_path):
    path = str(tmp_path / (kind + '.pth'))
    _checkpoint(kind, path)
    jmodel, variables, model = _model_pair(kind)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    copied = model.load_pretrained(path)
    theirs = from_jax(jmodel.load_pretrained(variables, path))
    ours = model.state_dict()
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        assert torch.equal(ours[key], value), key
    changed = [k for k in ours if not torch.equal(ours[k], before[k])]
    assert len(changed) == copied
    backbone = [k for k in ours if k.startswith('net.backbone.') and
                not k.endswith('num_batches_tracked')]
    if kind == 'backbone':
        assert sorted(changed) == sorted(backbone)
    elif kind == 'deeplabv2_21':  # the head is skipped, the backbone copied
        assert sorted(changed) == sorted(backbone)
    else:
        assert sorted(changed) == sorted(
            k for k in ours if not k.endswith('num_batches_tracked'))
    os.remove(path)


def test_pretrained_path_loads_after_the_initialisation(tmp_path):
    """``--pretrained-path`` through the algorithm build: the backbone is
    the file's, the classifier the generator's."""
    path = str(tmp_path / 'backbone.pth')
    _checkpoint('backbone', path)
    flags = dict(backbone='resnet10', num_classes=5, im_size=64, bf16=False,
                 lr=1e-3)
    plain = harness.build_algorithm(harness.default_args('ssl_null', **flags),
                                    device='cpu')
    loaded = harness.build_algorithm(harness.default_args(
        'ssl_null', pretrained_path=path, **flags), device='cpu')
    file_state = torch.load(path, weights_only=True)
    ours = loaded.model.state_dict()
    for key, value in plain.model.state_dict().items():
        name = key[len('net.backbone.'):]
        if name in file_state and not name.endswith('num_batches_tracked'):
            assert torch.equal(ours[key], file_state[name]), key
        else:
            assert torch.equal(ours[key], value), key
    os.remove(path)


# SyncBatchNorm(sample_weight) ----------------------------------------------

def test_sync_batchnorm_sample_weight_matches_jax():
    """Rows of weight 0 stay out of the statistics (JAX
    tests/test_models.py:98-110): the padded batch's real rows, its running
    statistics and the JAX layer's agree; ``update_stats`` off leaves the
    running statistics alone."""
    rng = np.random.default_rng(0)
    x_real = rng.normal(0.5, 2.0, (4, 4, 4, 3)).astype(np.float32)
    x_pad = np.concatenate([x_real, np.full((2, 4, 4, 3), 9.0, np.float32)])
    w = np.asarray([1, 1, 1, 1, 0, 0], np.float32)
    jbn = jax_layers.SyncBatchNorm(axis_name=None)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x_real),
                         train=False)
    jout, mutated = jbn.apply(variables, jnp.asarray(x_pad), train=True,
                              sample_weight=jnp.asarray(w),
                              mutable=['batch_stats'])

    def nchw(x):
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))

    bn = layers.SyncBatchNorm(3).train()
    out = bn(nchw(x_pad), sample_weight=torch.from_numpy(w))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy()[:4],
                               np.asarray(jout)[:4], rtol=1e-5, atol=1e-5)
    stats = jax.tree.map(np.asarray, mutated['batch_stats'])
    np.testing.assert_allclose(bn.running_mean.numpy(), stats['mean'],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats['var'],
                               rtol=1e-5, atol=1e-6)
    ref = layers.SyncBatchNorm(3).train()
    np.testing.assert_allclose(out.detach().numpy()[:4],
                               ref(nchw(x_real)).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               ref.running_var.numpy(), rtol=1e-5)

    frozen = layers.SyncBatchNorm(3).train()
    frozen.update_stats = False
    y = frozen(nchw(x_real))
    assert torch.equal(y, layers.SyncBatchNorm(3).train()(nchw(x_real)))
    assert torch.equal(frozen.running_mean, torch.zeros(3))
    assert torch.equal(frozen.running_var, torch.ones(3))
    assert int(frozen.num_batches_tracked) == 0


# the quickstart --------------------------------------------------------------

def _captured_config(script, module_name, argv, monkeypatch):
    captured = {}

    def fake_run_script(config, *args, **kwargs):
        captured.update(config)

    package = pixelssl_tpu_torch if 'torch' in module_name else pixelssl_tpu
    monkeypatch.setattr(package, 'run_script', fake_run_script)
    monkeypatch.setattr('sys.argv', [script] + argv)
    runpy.run_path(script, run_name='__main__')
    return captured


def test_quickstart_config_is_the_jax_one(monkeypatch, tmp_path):
    """The port's quickstart, key for key the JAX quickstart's config
    (``freeze_bn`` True included); only ``sublabeled_path`` differs, a
    temporary file in the port (its script says why), with the same
    labeled half of the samples."""
    theirs = _captured_config(
        os.path.join(REPO, 'scripts', 'quickstart_synthetic.py'),
        'pixelssl_tpu', ['--out', str(tmp_path)], monkeypatch)
    ours = _captured_config(
        os.path.join(REPO, 'pixelssl_tpu_torch', 'scripts',
                     'quickstart_synthetic.py'),
        'pixelssl_tpu_torch', ['--cpu'], monkeypatch)
    from pixelssl_tpu.utils import cmd as jax_cmd
    theirs = {k: jax_cmd.strdict(v) if isinstance(v, str) and
              v.startswith('{') else v for k, v in theirs.items()}
    theirs['out_path'] = 'result'
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        if key != 'sublabeled_path':
            assert ours[key] == value, key
    assert ours['freeze_bn'] is True and 'bf16' not in ours
