"""The port's PSPNet against the JAX package's: the new layer functions,
BatchNorm on one value per channel, the PSPNet forward and the gradients
of a loss on the same weights (carried across by
``pixelssl_tpu_torch.models.from_jax``), its lr groups and full-width
keys, and one SupOnly and one CutMix step on PSPNet.

Tolerances: the resizes, pools and the shuffle move values or average them
in float32 the way the JAX functions do: nearest resize and shuffle equal,
the pool atol 1e-6. BatchNorm atol 1e-5, and 1e-4 on one value per
channel: the port's output there is the bias exactly, the JAX layer's
``x * inv + shift`` with ``inv = scale / sqrt(eps)`` about 300 x the scale
rounds at that magnitude (float32 ulp of |x| * 300 * |scale|, up to about
6e-5 here). The PSPNet forwards atol 1e-4 and BN running statistics atol
1e-5, as tests/test_torch_models.py holds DeepLab-v2 (in train mode on two
rows 5e-4, and 1e-4 to the float64 port: the test says why); the
gradients rtol 1e-3 with atol 1e-4 of each tensor's largest value
(float32 sums over conv windows, backwards, in another order). The train steps as
tests/test_torch_mt.py and tests/test_torch_cutmix.py state them: losses
and lr rtol 2e-3, ``cons_loss`` rtol 2e-2 (atol 1e-9), params atol 3e-4,
BN running statistics atol 1e-4 with rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu.models import layers as jax_layers
from pixelssl_tpu.models.pspnet import PSPNet as JaxPSPNet
from pixelssl_tpu.tasks.sseg import model as jax_sseg_model

from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models import layers
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.models.pspnet import PSPNet
from pixelssl_tpu_torch.tasks.sseg import model as sseg_model

from test_torch_cutmix import CUTMIX_ARGS, _jax_masks
from test_torch_gct import _assert_close
from test_torch_models import _nchw, _nhwc, _perturb_stats, _to_numpy
from test_torch_mt import (MT_ARGS, _jax_and_port,  # noqa: F401
                           one_torch_thread)

NUM_CLASSES = 5
# every component dict: the JAX harness fills them only when ``models`` is
# not given
PSP = {'models': {'model': 'pspnet'}, 'optimizers': {'model': 'sgd'},
       'lrers': {'model': 'polynomiallr'},
       'criterions': {'model': 'sseg_criterion'}}


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize('in_size,out_size', [
    ((513, 513), (33, 33)), ((33, 33), (513, 513)), ((65, 97), (33, 17)),
    ((5, 7), (33, 64)), ((264, 264), (513, 513)), ((3, 3), (3, 3)),
    ((39, 77), (33, 33)), ((69, 24), (513, 321))])
def test_resize_nearest_matches_jax(in_size, out_size):
    x = _rand((2,) + in_size + (3,))
    ours = layers.resize_nearest(_nchw(x), out_size)
    theirs = np.asarray(jax_layers.resize_nearest(jnp.asarray(x), out_size))
    np.testing.assert_array_equal(_nhwc(ours), theirs)


@pytest.mark.parametrize('n_in,n_out', [(513, 33), (39, 33), (69, 513),
                                         (78, 33), (87, 81)])
def test_resize_nearest_index_is_integer(n_in, n_out):
    """Row ``i * in // out`` in integers. At 39 -> 33, 69 -> 513, 78 -> 33
    and 87 -> 81 ``F.interpolate(mode='nearest')``'s floating-point index
    ``floor(i * (in / out))`` takes another row at some ``i`` (this host's
    PyTorch)."""
    x = torch.arange(float(n_in)).reshape(1, 1, n_in, 1)
    rows = layers.resize_nearest(x, (n_out, 1))[0, 0, :, 0].long()
    assert rows.tolist() == [i * n_in // n_out for i in range(n_out)]


@pytest.mark.parametrize('in_size,bins', [
    ((33, 33), 1), ((33, 33), 2), ((33, 33), 3), ((33, 33), 6),
    ((5, 5), 6), ((2, 3), 6), ((4, 7), (3, 2)), ((6, 6), 6)])
def test_adaptive_avg_pool_matches_jax(in_size, bins):
    x = _rand((2,) + in_size + (4,), seed=1)
    ours = layers.adaptive_avg_pool(_nchw(x), bins)
    theirs = np.asarray(jax_layers.adaptive_avg_pool(jnp.asarray(x), bins))
    np.testing.assert_allclose(_nhwc(ours), theirs, atol=1e-6)


@pytest.mark.parametrize('scale', [2, 3])
def test_pixel_shuffle_matches_jax(scale):
    x = _rand((2, 5, 7, 3 * scale * scale), seed=2)
    ours = layers.pixel_shuffle(_nchw(x), scale)
    theirs = np.asarray(jax_layers.pixel_shuffle(jnp.asarray(x), scale))
    np.testing.assert_array_equal(_nhwc(ours), theirs)


def test_icnr_init_matches_jax_layout():
    """The JAX ICNR kernel (HWIO) carried to OIHW repeats each sub-kernel
    along O as the port's does, and the port's initial conv + shuffle is a
    nearest x2 upsampling of its first sub-kernels' conv, as the JAX
    one's is."""
    r, c_in, c = 2, 6, 5
    jk = np.asarray(jax_layers.icnr_init(jax.random.PRNGKey(0),
                                         (1, 1, c_in, c * r * r), scale=r))
    theirs = torch.from_numpy(jk.transpose(3, 2, 0, 1).copy())
    ours = layers.icnr_init_(torch.empty(c * r * r, c_in, 1, 1), r,
                             torch.Generator().manual_seed(0))
    for w in (theirs, ours):
        sub = w[::r * r]
        assert torch.equal(w, sub.repeat_interleave(r * r, dim=0))
        x = torch.from_numpy(_rand((1, c_in, 4, 6), seed=3))
        up = layers.pixel_shuffle(torch.nn.functional.conv2d(x, w), r)
        base = torch.nn.functional.conv2d(x, sub)
        torch.testing.assert_close(
            up, base.repeat_interleave(r, 2).repeat_interleave(r, 3))
    # the port's sub-kernels: kaiming-normal scale, truncated at 2 sigma
    big = layers.icnr_init_(torch.empty(4 * 64, 512, 1, 1), r,
                            torch.Generator().manual_seed(1))[::4]
    std = np.sqrt(2.0 / 512)
    assert abs(float(big.std()) / std - 1.0) < 0.05
    assert float(big.abs().max()) <= 2.0 * std / .87962566103423978 + 1e-6


@pytest.mark.parametrize('shape', [(1, 1, 1, 8), (2, 1, 1, 8), (1, 2, 2, 8),
                                   (2, 6, 6, 8)])
def test_sync_batchnorm_matches_jax_on_few_values(shape):
    """Train mode on one value per channel (PSPNet's 1x1 bin of one row)
    normalises with variance 0 and moves the running variance by 0 x n /
    max(n - 1, 1), as the JAX layer does; PyTorch's BatchNorm raises there.
    More values per channel (PSPNet's 2x2 and 6x6 bins) as before. The
    output, its gradients and the running statistics against JAX."""
    x = _rand(shape, seed=4)
    g = _rand(shape, seed=5)
    jbn = jax_layers.SyncBatchNorm()
    variables = _to_numpy(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   train=False))
    rng = np.random.default_rng(6)
    variables['params'] = {k: rng.normal(1.0, 0.5, v.shape).astype(np.float32)
                           for k, v in variables['params'].items()}
    variables['batch_stats'] = _perturb_stats(variables['batch_stats'], 7)

    def loss(params, x):
        y, mutated = jbn.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            x, train=True, mutable=['batch_stats'])
        return jnp.sum(y * g), (y, mutated)
    (_, (jy, mutated)), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables['params'],
                                            jnp.asarray(x))

    bn = layers.SyncBatchNorm(shape[-1])
    bn.load_state_dict(from_jax(variables))
    bn.train()
    xt = _nchw(x).requires_grad_()
    y = bn(xt)
    (y * _nchw(g)).sum().backward()
    one_value = np.prod(shape[:3]) == 1
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy),
                               atol=1e-4 if one_value else 1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgx), atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(jgp['scale']), atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(jgp['bias']), atol=1e-5)
    stats = from_jax({'params': variables['params'],
                      'batch_stats': _to_numpy(mutated['batch_stats'])})
    for key in ('running_mean', 'running_var'):
        np.testing.assert_allclose(getattr(bn, key).numpy(),
                                   stats[key].numpy(), atol=1e-6, err_msg=key)
    if one_value:
        np.testing.assert_array_equal(_nhwc(y)[0, 0, 0],
                                      bn.bias.detach().numpy())
        assert float(xt.grad.abs().max()) == 0.0


def _psp_pair(seed):
    """The JAX PSPNet (ResNet-10), its variables from ``seed`` (the init
    jitted: a third of its eager time here) with BN statistics perturbed,
    and the port's PSPNet on them."""
    jmod = JaxPSPNet(backbone='resnet10', output_stride=16,
                     num_classes=NUM_CLASSES, bn_axis_name=None,
                     dtype=jnp.float32)
    variables = _to_numpy(jax.jit(lambda key: jmod.init(
        key, jnp.zeros((1, 65, 65, 3)), train=False))(
            jax.random.PRNGKey(seed)))
    variables['batch_stats'] = _perturb_stats(variables['batch_stats'],
                                              seed + 1)
    net = PSPNet(backbone='resnet10', output_stride=16,
                 num_classes=NUM_CLASSES, bf16=False)
    net.load_state_dict(from_jax(variables))
    return jmod, variables, net


@pytest.mark.parametrize('train,batch', [(True, 2), (False, 2), (True, 1)])
def test_pspnet_matches_jax(train, batch):
    """65 px: a 5 x 5 latent at output stride 16, so the 6 x 6 bin is
    larger than its input; batch 1 in train mode gives the 1 x 1 bin's BN
    one value per channel.

    In train mode on 2 rows the 1 x 1 bin's BN takes the variance of 2
    values a channel, and the JAX layer's E[x^2] - E[x]^2 cancels there:
    its latent is 2.8e-4 from the same module in float64 where the port's
    is 4.5e-5. So in train mode the port is held to the float64 port at
    atol 1e-4 and to JAX at atol 5e-4."""
    x = _rand((batch, 65, 65, 3), seed=8)
    jmod, variables, net = _psp_pair(9)
    net.train(train)
    with torch.no_grad():
        logits, latent = net(_nchw(x))
    atol = 1e-4
    if train:
        (jlogits, jlatent), mutated = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=['batch_stats']))(variables,
                                                        jnp.asarray(x))
        _assert_close(net, {'params': variables['params'],
                            'batch_stats': _to_numpy(mutated['batch_stats'])},
                      0.0, 1e-5, 'pspnet')
        net64 = _psp_pair(9)[2].double().train()
        with torch.no_grad():
            exact = net64(_nchw(x).double())
        for ours, ref in zip((logits, latent), exact):
            np.testing.assert_allclose(ours.double().numpy(), ref.numpy(),
                                       atol=1e-4)
        atol = 5e-4
    else:
        jlogits, jlatent = jax.jit(lambda v, x: jmod.apply(
            v, x, train=False))(variables, jnp.asarray(x))
    assert logits.shape == (batch, NUM_CLASSES, 65, 65)
    assert latent.shape == (batch, 512, 5, 5)
    np.testing.assert_allclose(_nhwc(latent), np.asarray(jlatent), atol=atol)
    np.testing.assert_allclose(_nhwc(logits), np.asarray(jlogits), atol=atol)


def test_pspnet_gradients_match_jax():
    """The gradients of ``sum(logits * a) + sum(latent * b)`` for every
    parameter, BN on its running statistics. In train mode on 2 rows the
    1 x 1 bin's BN normalises 2 values a channel and the gradient is
    ill-conditioned: float32 rounding alone moves layer4's gradients by up
    to 10% of their largest value (the port in float32 against float64),
    JAX's cancelling variance by up to 29%. Train-mode backwards are held
    by the train-step tests below, through the parameters they update."""
    x = _rand((2, 65, 65, 3), seed=10)
    a = _rand((2, 65, 65, NUM_CLASSES), seed=11)
    b = _rand((2, 5, 5, 512), seed=12)
    jmod, variables, net = _psp_pair(13)

    def loss(params):
        logits, latent = jmod.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(x), train=False)
        return jnp.sum(logits * a) + jnp.sum(latent * b)
    jgrads = from_jax({'params': _to_numpy(
        jax.jit(jax.grad(loss))(variables['params']))})

    net.eval()
    logits, latent = net(_nchw(x))
    ((logits * _nchw(a)).sum() + (latent * _nchw(b)).sum()).backward()
    grads = dict(net.named_parameters())
    assert set(grads) == set(jgrads)
    for key, theirs in jgrads.items():
        theirs = theirs.numpy()
        np.testing.assert_allclose(
            grads[key].grad.numpy(), theirs, rtol=1e-3,
            atol=1e-4 * max(1.0, float(np.abs(theirs).max())), err_msg=key)


def test_pspnet_task_model_covers_full_width_and_lr_groups():
    """Every key and shape of the full-width PSPNet task model from the JAX
    model's variable tree (shapes only), and three lr groups: the backbone
    at 1x, the PSP module and the decoder at 10x."""
    kw = dict(PSP, backbone='resnet101', im_size=513, num_classes=21)
    jmodel = jax_sseg_model.PSPNetModel(jax_harness.default_args(
        'ssl_null', **kw))
    shapes = jax.eval_shape(lambda: jmodel.module.init(
        jax.random.PRNGKey(0), (jnp.zeros((1, 513, 513, 3)),), train=False))
    converted = from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    model = sseg_model.pspnet()(harness.default_args('ssl_null', **kw))
    ours = model.state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    groups = model.param_groups()
    assert [g['lr_mult'] for g in groups] == [1.0, 10.0, 10.0]
    names = {id(p): n for n, p in model.named_parameters()}
    for group, part in zip(groups, ('backbone', 'psp', 'decoder')):
        assert all(part in names[id(p)] for p in group['params']), part


def test_pspnet_suponly_step_matches_jax():
    rng = np.random.default_rng(14)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port(
        'ssl_null', dict(MT_ARGS, unlabeled_batch_size=0, **PSP), rng)
    jstate, jmetrics = jalgo._train_step(jstate, jbatch)
    metrics = algo.train_step(batch)
    for k in ('task_loss', 'lr'):
        assert np.isclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-3,
                          atol=1e-6), k
    final = jax.tree.map(np.asarray, jax.device_get(jstate))
    _assert_close(algo.model, final['model'], 3e-4, 1e-4, 'model')


def test_pspnet_cutmix_step_matches_jax():
    rng = np.random.default_rng(15)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port(
        'ssl_cutmix', dict(CUTMIX_ARGS, **PSP), rng)
    im = CUTMIX_ARGS['im_size']
    masks = _jax_masks(jstate, CUTMIX_ARGS['unlabeled_batch_size'] // 2,
                       (im, im), CUTMIX_ARGS['mask_prop_range'], 1)
    algo._draw_masks = lambda n, shape: masks[algo.state.step]
    jstate, jmetrics = jalgo._train_step(jstate, jbatch)
    metrics = algo.train_step(batch)
    for k, (rtol, atol) in (('task_loss', (2e-3, 1e-6)), ('lr', (2e-3, 1e-6)),
                            ('cons_loss', (2e-2, 1e-9))):
        assert np.isclose(float(metrics[k]), float(jmetrics[k]), rtol=rtol,
                          atol=atol), k
    assert float(metrics['cons_loss']) > 0
    final = jax.tree.map(np.asarray, jax.device_get(jstate))
    _assert_close(algo.model, final['model'], 3e-4, 1e-4, 'student')
    _assert_close(algo.teacher, final['teacher'], 3e-4, 1e-4, 'teacher')
