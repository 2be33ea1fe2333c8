"""The port's models and layers against the JAX package's, on the same
weights (carried across by ``pixelssl_tpu_torch.models.from_jax``) and the
same inputs made with numpy.

The JAX side runs in float32 (``bf16=False``), as the port does on the CPU.
Tolerance atol 1e-4 on the forwards: float32 sums over conv windows taken
in another order; BN running statistics atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelssl_tpu.models import layers as jax_layers
from pixelssl_tpu.models.deeplab_v2 import DeepLabV2 as JaxDeepLabV2
from pixelssl_tpu.models.flaw_detector import FlawDetector as JaxFlawDetector
from pixelssl_tpu.tasks.sseg import criterion as jax_criterion
from pixelssl_tpu.tasks.sseg import model as jax_sseg_model
from pixelssl_tpu.tasks.sseg import func as jax_sseg_func
from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu.nn import func as jax_nnfunc
from pixelssl_tpu.nn import lrer as jax_lrer

from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models import layers
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.models.deeplab_v2 import DeepLabV2
from pixelssl_tpu_torch.models.flaw_detector import FlawDetector
from pixelssl_tpu_torch.nn import func as nnfunc
from pixelssl_tpu_torch.nn import lrer
from pixelssl_tpu_torch.tasks.sseg import criterion
from pixelssl_tpu_torch.tasks.sseg import func as sseg_func
from pixelssl_tpu_torch.tasks.sseg import model as sseg_model

NUM_CLASSES = 5


def _to_numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _perturb_stats(stats, seed):
    """Running statistics away from their (0, 1) init, so eval mode reads
    them."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == 'mean':
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_state_close(module, variables, atol):
    ours = module.state_dict()
    theirs = from_jax(variables)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        if key.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(ours[key].detach().numpy(), value.numpy(),
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize('train', [True, False])
def test_deeplab_v2_matches_jax(train):
    im = 65
    x = np.random.default_rng(0).standard_normal((2, im, im, 3)).astype(
        np.float32)
    jmod = JaxDeepLabV2(backbone='resnet10', num_classes=NUM_CLASSES,
                        bn_axis_name=None, dtype=jnp.float32)
    variables = _to_numpy(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                    train=False))
    variables['batch_stats'] = _perturb_stats(variables['batch_stats'], 2)

    net = DeepLabV2(backbone='resnet10', num_classes=NUM_CLASSES, bf16=False)
    net.load_state_dict(from_jax(variables))
    net.train(train)
    with torch.no_grad():
        logits, feat = net(_nchw(x))

    if train:
        (jlogits, jfeat), mutated = jmod.apply(
            variables, jnp.asarray(x), train=True, mutable=['batch_stats'])
        new_vars = {'params': variables['params'],
                    'batch_stats': _to_numpy(mutated['batch_stats'])}
        _assert_state_close(net, new_vars, atol=1e-5)
    else:
        jlogits, jfeat = jmod.apply(variables, jnp.asarray(x), train=False)
    assert logits.shape == (2, NUM_CLASSES, im, im)
    np.testing.assert_allclose(_nhwc(logits), np.asarray(jlogits), atol=1e-4)
    np.testing.assert_allclose(_nhwc(feat), np.asarray(jfeat), atol=1e-4)


@pytest.mark.parametrize('train', [True, False])
def test_flaw_detector_matches_jax(train):
    im = 96
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, im, im, 3)).astype(np.float32)
    pred = rng.uniform(0, 1, (2, im, im, NUM_CLASSES)).astype(np.float32)
    jmod = JaxFlawDetector(axis_name=None, dtype=jnp.float32)
    variables = _to_numpy(jmod.init(jax.random.PRNGKey(4), (jnp.asarray(x),),
                                    jnp.asarray(pred), train=False))
    variables['batch_stats'] = _perturb_stats(variables['batch_stats'], 5)

    fd = FlawDetector(3 + NUM_CLASSES, bf16=False)
    fd.load_state_dict(from_jax(variables))
    fd.train(train)
    with torch.no_grad():
        out = fd((_nchw(x),), _nchw(pred))

    if train:
        jout, mutated = jmod.apply(variables, (jnp.asarray(x),),
                                   jnp.asarray(pred), train=True,
                                   mutable=['batch_stats'])
        new_vars = {'params': variables['params'],
                    'batch_stats': _to_numpy(mutated['batch_stats'])}
        _assert_state_close(fd, new_vars, atol=1e-5)
    else:
        jout = jmod.apply(variables, (jnp.asarray(x),), jnp.asarray(pred),
                          train=False)
    assert out.shape == (2, 1, im, im)
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), atol=1e-4)


def test_from_jax_covers_resnet101_task_model():
    """Every key and shape of the full-width task model, from the JAX task
    model's variable tree (shapes only: nothing is computed)."""
    jax_args = jax_harness.default_args(
        'ssl_gct', backbone='resnet101', im_size=321, num_classes=21)
    jmodel = jax_sseg_model.DeepLabV2Model(jax_args)
    shapes = jax.eval_shape(
        lambda: jmodel.module.init(jax.random.PRNGKey(0),
                                   (jnp.zeros((1, 321, 321, 3)),),
                                   train=False))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    args = harness.default_args('ssl_gct', backbone='resnet101', im_size=321,
                                num_classes=21)
    model = sseg_model.DeepLabV2Model(args)
    converted = from_jax(variables)
    ours = model.state_dict()
    assert set(converted) == set(ours)
    for key, value in ours.items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    groups = model.param_groups()
    assert [g['lr_mult'] for g in groups] == [1.0, 10.0]
    assert all('classifier' in n for n, p in model.named_parameters()
               if any(p is q for q in groups[1]['params']))


@pytest.mark.parametrize('size,align', [((33, 47), True), ((33, 47), False),
                                        ((7, 5), True), ((7, 5), False),
                                        ((1, 1), True), ((1, 1), False)])
def test_resize_bilinear_matches_jax(size, align):
    x = np.random.default_rng(6).standard_normal((2, 13, 17, 3)).astype(
        np.float32)
    ours = layers.resize_bilinear(_nchw(x), size, align_corners=align)
    theirs = jax_layers.resize_bilinear(jnp.asarray(x), size,
                                        align_corners=align)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(theirs), atol=1e-5)


def test_sync_batchnorm_matches_jax():
    x = np.random.default_rng(7).normal(1.0, 2.0, (4, 5, 6, 3)).astype(
        np.float32)
    jbn = jax_layers.SyncBatchNorm(axis_name=None)
    variables = _to_numpy(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   train=False))
    jout, mutated = jbn.apply(variables, jnp.asarray(x), train=True,
                              mutable=['batch_stats'])
    bn = layers.SyncBatchNorm(3)
    bn.train()
    out = bn(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), atol=1e-5)
    stats = _to_numpy(mutated['batch_stats'])
    np.testing.assert_allclose(bn.running_mean.numpy(), stats['mean'],
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats['var'],
                               atol=1e-6)


def test_cross_entropy_per_sample_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 9, 10, NUM_CLASSES)).astype(np.float32)
    gt = rng.integers(0, NUM_CLASSES, (3, 9, 10)).astype(np.int32)
    gt[0, :2] = 255   # ignore_index
    gt[1, 3] = 7      # out of range
    gt[2] = -1        # unlabeled row
    ours = criterion.cross_entropy_per_sample(
        _nchw(logits), torch.from_numpy(gt).long(), 255)
    theirs = jax_criterion.cross_entropy_per_sample(
        jnp.asarray(logits), jnp.asarray(gt), 255)
    assert ours.shape == (3,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6,
                               atol=1e-6)
    assert float(ours[2]) == 0.0


def test_prepare_task_gt_for_fdgt_matches_jax():
    gt = np.random.default_rng(9).integers(0, NUM_CLASSES, (2, 6, 7))
    gt[0, 0] = 255
    gt[1, 2] = -1
    kw = dict(num_classes=NUM_CLASSES, ignore_index=255)
    ours = sseg_func.SemanticSegmentationFunc(
        harness.default_args('ssl_gct', **kw)).sslgct_prepare_task_gt_for_fdgt(
            torch.from_numpy(gt).long())
    theirs = jax_sseg_func.SemanticSegmentationFunc(
        jax_harness.default_args('ssl_gct', **kw)
    ).sslgct_prepare_task_gt_for_fdgt(jnp.asarray(gt, jnp.int32))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_polynomial_lr_and_rampup_match_jax():
    kw = dict(lr=2.5e-4, power=0.9)
    ours = lrer.polynomiallr(harness.default_args('ssl_gct', **kw)).make(
        2.5e-4, 10, 2)
    theirs = jax_lrer.polynomiallr(jax_harness.default_args('ssl_gct', **kw)
                                   ).make(2.5e-4, 10, 2)
    for step in (0, 1, 7, 19, 20, 25):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6)
        np.testing.assert_allclose(nnfunc.sigmoid_rampup(step, 10.0),
                                   float(jax_nnfunc.sigmoid_rampup(
                                       jnp.asarray(step), 10.0)), rtol=1e-6)
    assert nnfunc.sigmoid_rampup(3, 0) == 1.0


def test_from_jax_transposes_dense_kernels():
    """A flax ``Dense`` kernel is [in, out]; the torch ``Linear`` weight
    [out, in]."""
    import flax.linen as flax_nn

    x = np.random.default_rng(10).standard_normal((3, 6)).astype(np.float32)
    dense = flax_nn.Dense(4, name='fc')
    variables = _to_numpy(dense.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    linear = torch.nn.Linear(6, 4)
    linear.load_state_dict(from_jax(variables))
    np.testing.assert_allclose(
        linear(torch.from_numpy(x)).detach().numpy(),
        np.asarray(dense.apply(variables, jnp.asarray(x))), atol=1e-6)


def test_from_jax_covers_full_width_aux_modules():
    """Every key and shape of the discriminator and the rotation head at
    21 classes and 321 px, from the JAX modules' variable trees (shapes
    only)."""
    from pixelssl_tpu.models.discriminator import (
        FCDiscriminator as JaxFCDiscriminator)
    from pixelssl_tpu.models.rotation import (
        RotationClassifier as JaxRotationClassifier)
    from pixelssl_tpu_torch.models.discriminator import FCDiscriminator
    from pixelssl_tpu_torch.models.rotation import RotationClassifier

    for jmod, kwargs, module in (
            (JaxFCDiscriminator(), {}, FCDiscriminator(21)),
            (JaxRotationClassifier(), {'train': False},
             RotationClassifier(21))):
        shapes = jax.eval_shape(lambda: jmod.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 321, 321, 21)), **kwargs))
        converted = from_jax(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
        ours = module.state_dict()
        assert set(converted) == set(ours)
        for key, value in ours.items():
            assert tuple(converted[key].shape) == tuple(value.shape), key
