"""The port's bf16 path against the JAX package's bf16 path (``--bf16``,
the default of every recipe), on the same weights (``models.convert.
from_jax``) and the same inputs made with numpy from a seed. The JAX side
runs under ``jax.jit``, as the package runs it.

* Layers, bit for bit (``assert_array_equal`` on the bf16 outputs):
  ``SyncBatchNorm`` in training, in eval, with ``update_stats`` off, with
  ``sample_weight`` and on a one-rank spatial grid (``x * bf16(inv) +
  bf16(shift)``); each biased convolution and dense site under bf16
  autocast (ASPP, the flaw detector's 4x4 convolutions at stride 2 and 1,
  the discriminator's, the rotation head's convolution and ``fc``,
  PSPNet's shuffle convolution, the row-sharded ``Conv2d``): the product
  rounded to bf16, then the bias added in bf16. A convolution may sum its
  window in another order than XLA's, which moves a bf16 output by one
  ulp now and then: at most ``CONV_FLIP_SHARE`` of a convolution's
  elements may differ, each by one ulp (measured: 0 at every site but the
  flaw detector's stride-1 convolution, 6e-5 there; the float32 bias
  fused inside the accumulation gave 22-29% at every site). LeakyReLU(0.2)
  forward and backward, and the rotation head's mean, bit for bit.
* BatchNorm's input gradient: bit for bit with the statistics held (eval);
  in training the gradient through the batch statistics differs, because
  XLA on the CPU sums the per-channel reductions of the backward in bf16
  (the gradient of ``bf16(inv)``: -38.0 where the float32 sum is -36.68
  and PyTorch's bf16 sum -36.75). At most ``BN_GRAD_SHARE`` of the
  elements differ there, by at most ``BN_GRAD_ULPS`` ulp of the
  gradient's largest element (measured 37% and 0.75 ulp).
* Model forwards in bf16, train and eval, at ResNet-10 @65 (DeepLab-v2,
  PSPNet), the flaw detector @96, the discriminator @65, the rotation head
  and ``unet_lite`` @64. The tolerance is JAX against itself: its jitted
  forward against the op-by-op one (``jax.disable_jit``), which rounds to
  bf16 at other places (XLA keeps fused elementwise chains in float32).
  The statistic is the mean of |diff| over the output (its largest
  element is one flipped rounding away from any other value): the port's
  gap to the jitted JAX forward must lie within ``SPREAD_FACTOR`` times
  JAX's own spread. Before the port applied BatchNorm and the biases as
  the JAX package does, DeepLab-v2's train-mode gap was 1.47x JAX's
  spread (0.0608 against 0.0412). Second: the port's bf16-vs-float32
  departure (mean |diff|) must lie within ``DEPARTURE_SHARE`` of JAX's,
  the signature of the same rounding policy (DeepLab-v2 train: 0.0553
  against 0.0555; the port's old policy 0.0410).
* The first train step in bf16 of SupOnly and MT (64 px), MT with its
  teacher stored in bf16 (``--bf16-ema``) and GCT (96 px) against the JAX
  package's (``harness`` with ``bf16=True``): the losses, and the
  parameters and BN statistics after the step. The tolerance is the JAX
  step against itself on the same batch with 1% of the image's elements
  one bf16 ulp away (a jitted step against an op-by-op one takes minutes
  here), times ``STEP_FACTOR`` (the losses ``SPREAD_FACTOR``). Later
  steps part chaotically (ROADMAP F13).
* ``--remat`` in bf16: two MT steps equal to the run without it (the
  recompute runs BatchNorm with its statistics left alone).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel as jax_parallel
from pixelssl_tpu.models import layers as jax_layers
from pixelssl_tpu.models.deeplab_v2 import ASPPClassifier as JaxASPP
from pixelssl_tpu.models.deeplab_v2 import DeepLabV2 as JaxDeepLabV2
from pixelssl_tpu.models.discriminator import FCDiscriminator as JaxD
from pixelssl_tpu.models.flaw_detector import FlawDetector as JaxFD
from pixelssl_tpu.models.pspnet import PixelShuffleBlock as JaxShuffle
from pixelssl_tpu.models.pspnet import PSPNet as JaxPSPNet
from pixelssl_tpu.models.rotation import RotationClassifier as JaxRC
from pixelssl_tpu.tasks import sreg as jax_sreg

from pixelssl_tpu_torch import harness, parallel
from pixelssl_tpu_torch.models import layers
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.models.deeplab_v2 import ASPPClassifier, DeepLabV2
from pixelssl_tpu_torch.models.discriminator import FCDiscriminator
from pixelssl_tpu_torch.models.flaw_detector import FlawDetector
from pixelssl_tpu_torch.models.pspnet import PixelShuffleBlock, PSPNet
from pixelssl_tpu_torch.models.rotation import RotationClassifier
from pixelssl_tpu_torch.parallel import spatial
from pixelssl_tpu_torch.tasks import sreg

from test_torch_mt import one_torch_thread  # noqa: F401

BF16 = jnp.bfloat16
NUM_CLASSES = 5
CONV_FLIP_SHARE = 1e-3
BN_GRAD_SHARE = 0.45
BN_GRAD_ULPS = 1
SPREAD_FACTOR = 1.25
# the first step's parameters and BN statistics, which part by the same
# share on every draw of the nudge (the losses do not)
STEP_FACTOR = 1.1
# the discriminator has no normalisation: a convolution's flipped
# roundings do not grow through it (measured 0.20; the old policy 0.95)
SPREAD_FACTOR_D = 0.5
DEPARTURE_SHARE = 0.15


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _f32(a):
    """A port tensor (NCHW) or a JAX array (NHWC) as float32 NHWC numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().float()
        return (a.permute(0, 2, 3, 1) if a.dim() == 4 else a).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp(x):
    """The bf16 ulp at ``x``."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _ulps(ours, theirs):
    """|ours - theirs| in bf16 ulps of ``theirs`` (both bf16 values)."""
    return np.abs(ours - theirs) / _ulp(theirs)


def _perturb(stats, rng):
    """Running statistics away from their (0, 1) init, so that eval reads
    them."""
    def leaf(path, x):
        if path[-1].key == 'mean':
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


def _with_biases(variables, rng):
    """Every bias drawn away from its zero init, so that adding it
    rounds."""
    def leaf(path, x):
        if path[-1].key == 'bias':
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        return x
    return dict(variables, params=jax.tree_util.tree_map_with_path(
        leaf, variables['params']))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _bn_pair(rng, c=64):
    jbn = jax_layers.SyncBatchNorm()
    variables = _np(jbn.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 3, 3, c), BF16), train=False))
    variables = dict(
        params={'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
                'bias': rng.normal(0.0, 0.5, c).astype(np.float32)},
        batch_stats=_perturb(variables['batch_stats'], rng))
    bn = layers.SyncBatchNorm(c)
    bn.load_state_dict({'weight': torch.from_numpy(variables['params']['scale']),
                        'bias': torch.from_numpy(variables['params']['bias']),
                        'running_mean': torch.from_numpy(
                            variables['batch_stats']['mean']),
                        'running_var': torch.from_numpy(
                            variables['batch_stats']['var']),
                        'num_batches_tracked': torch.zeros((), dtype=torch.long)})
    return jbn, variables, bn


@pytest.mark.parametrize('mode', ['train', 'eval', 'update_stats_off',
                                  'sample_weight', 'one_rank_grid'])
def test_batchnorm_bf16_matches_jax_bit_for_bit(mode):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 17, 17, 64)) * 2.0 + 0.5).astype(np.float32)
    weight = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    jbn, variables, bn = _bn_pair(rng)
    train = mode != 'eval'
    sw = weight if mode == 'sample_weight' else None
    theirs, mutated = jax.jit(lambda v, xx, s: jbn.apply(
        v, xx, train=train, sample_weight=s, mutable=['batch_stats']))(
            variables, jnp.asarray(x).astype(BF16), sw)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    bn.train(train)
    bn.update_stats = mode != 'update_stats_off'
    xt = _nchw(x).bfloat16()
    with torch.no_grad():
        if mode == 'one_rank_grid':
            mesh = parallel.make_mesh_2d(1)
            bn.sync = mesh
            with spatial.sharded(mesh, 17):
                ours = bn(xt)
        else:
            ours = bn(xt, None if sw is None else torch.from_numpy(sw))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(ours), _f32(theirs))
    if mode in ('eval', 'update_stats_off'):
        for k, v in bn.state_dict().items():
            assert torch.equal(v, before[k]), k
    else:
        for ours_k, theirs_k in (('running_mean', 'mean'),
                                 ('running_var', 'var')):
            np.testing.assert_allclose(
                getattr(bn, ours_k).numpy(),
                np.asarray(mutated['batch_stats'][theirs_k]),
                rtol=1e-5, atol=1e-6, err_msg=ours_k)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_batchnorm_bf16_input_gradient_matches_jax(train):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 17, 17, 64)) * 2.0 + 0.5).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jbn, variables, bn = _bn_pair(rng)
    xj = jnp.asarray(x).astype(BF16)
    theirs_y, vjp = jax.vjp(lambda xx: jbn.apply(
        variables, xx, train=train, mutable=['batch_stats'])[0], xj)
    theirs = jax.jit(lambda gg: vjp(gg)[0])(jnp.asarray(g).astype(BF16))
    bn.train(train)
    xt = _nchw(x).bfloat16().requires_grad_(True)
    ours_y = bn(xt)
    ours_y.backward(_nchw(g).bfloat16())
    np.testing.assert_array_equal(_f32(ours_y), _f32(theirs_y))
    a, b = _f32(xt.grad), _f32(theirs)
    if not train:
        np.testing.assert_array_equal(a, b)
        return
    share = float(np.mean(a != b))
    assert share <= BN_GRAD_SHARE, share
    # in ulps of the gradient's largest element: near the elements where
    # the direct and the statistics' terms cancel, any ulp of theirs is
    # small
    scale = np.abs(b).max()
    assert np.abs(a - b).max() <= BN_GRAD_ULPS * _ulp(scale)


def _conv_site(rng, cin, cout, k, stride, pad, dilation=1, im=17):
    """A flax ``nn.Conv(dtype=bf16)`` with a drawn bias and the port's
    ``Conv2d`` on its weights."""
    jconv = fnn.Conv(cout, (k, k), strides=(stride, stride),
                     kernel_dilation=(dilation, dilation),
                     padding=[(pad, pad)] * 2, dtype=BF16)
    x = rng.standard_normal((4, im, im, cin)).astype(np.float32)
    variables = _with_biases(_np(jconv.init(jax.random.PRNGKey(1),
                                            jnp.asarray(x))), rng)
    conv = layers.Conv2d(cin, cout, k, stride=stride, padding=pad,
                         dilation=dilation)
    conv.load_state_dict({'weight': torch.from_numpy(
        variables['params']['kernel'].transpose(3, 2, 0, 1).copy()),
        'bias': torch.from_numpy(variables['params']['bias'])})
    return jconv, variables, conv, x


def _site(name, rng):
    """(JAX apply on numpy NHWC input, the port's forward on an NCHW
    tensor, the input) of one biased bf16 site."""
    if name == 'aspp':
        x = rng.standard_normal((2, 9, 9, 64)).astype(np.float32)
        jmod = JaxASPP(num_classes=NUM_CLASSES, dtype=BF16)
        variables = _with_biases(_np(jmod.init(jax.random.PRNGKey(1),
                                               jnp.asarray(x))), rng)
        mod = ASPPClassifier(64, NUM_CLASSES)
        mod.load_state_dict(from_jax(variables))
        # as DeepLab-v2 takes it: cast to float32, its last add unrounded
        return (lambda xx: jmod.apply(variables, xx).astype(jnp.float32)), \
            mod, x
    if name == 'pspnet_shuffle':
        x = rng.standard_normal((2, 9, 9, 8)).astype(np.float32)
        jmod = JaxShuffle(channels=8, dtype=BF16)
        variables = _with_biases(_np(jmod.init(jax.random.PRNGKey(1),
                                               jnp.asarray(x))), rng)
        mod = PixelShuffleBlock(8)
        mod.load_state_dict(from_jax(variables))
        return (lambda xx: jmod.apply(variables, xx)), mod, x
    if name == 'rotation_fc':
        # the head's logits, cast to float32: the last add unrounded
        x = rng.standard_normal((8, 128)).astype(np.float32)
        jmod = fnn.Dense(4, dtype=BF16)
        variables = _with_biases(_np(jmod.init(jax.random.PRNGKey(1),
                                               jnp.asarray(x))), rng)
        mod = layers.Linear(128, 4, float32_out=True)
        mod.load_state_dict(from_jax(variables))
        return (lambda xx: jmod.apply(variables, xx).astype(jnp.float32)), \
            mod, x
    spec = {'flaw_detector_s2': (8, 64, 4, 2, 1, 1, 33),
            'flaw_detector_s1': (64, 64, 4, 1, 1, 1, 9),
            'discriminator': (NUM_CLASSES, 64, 4, 2, 1, 1, 33),
            'rotation_conv': (NUM_CLASSES, NUM_CLASSES, 4, 2, 1, 1, 17),
            'classifier': (64, 1, 4, 2, 1, 1, 9),
            'row_sharded': (16, 16, 3, 1, 2, 2, 17)}[name]
    jconv, variables, conv, x = _conv_site(rng, *spec[:6], im=spec[6])
    if name == 'classifier':
        # D's and the flaw detector's last convolution, cast to float32
        conv.float32_out = True
        return (lambda xx: jconv.apply(variables, xx).astype(jnp.float32)), \
            conv, x
    if name == 'row_sharded':
        def forward(xt):
            with spatial.sharded(parallel.make_mesh_2d(1), xt.shape[2]):
                return conv(xt, xt.shape[2])
        return (lambda xx: jconv.apply(variables, xx)), forward, x
    return (lambda xx: jconv.apply(variables, xx)), conv, x


# the sites whose output the JAX package casts to float32 at once
FLOAT32_OUT = ('aspp', 'classifier', 'rotation_fc')


@pytest.mark.parametrize('name', [
    'aspp', 'flaw_detector_s2', 'flaw_detector_s1', 'discriminator',
    'classifier', 'rotation_conv', 'rotation_fc', 'pspnet_shuffle',
    'row_sharded'])
def test_biased_site_bf16_adds_the_bias_after_the_product(name):
    rng = np.random.default_rng(2)
    japply, forward, x = _site(name, rng)
    theirs = _f32(jax.jit(japply)(jnp.asarray(x)))
    xt = torch.from_numpy(x) if x.ndim == 2 else _nchw(x)
    with torch.no_grad(), layers.bf16_autocast(xt):
        ours = forward(xt)
    assert ours.dtype == (torch.float32 if name in FLOAT32_OUT else
                          torch.bfloat16)
    ours = _f32(ours)
    share = float(np.mean(ours != theirs))
    assert share <= CONV_FLIP_SHARE, share
    assert _ulps(ours, theirs).max() <= 1.0
    # the same site with the float32 bias fused into the accumulation
    # differs in a fifth or more of the elements: the check can tell
    if name != 'pspnet_shuffle':
        with torch.no_grad():
            fused = forward(xt.bfloat16().float()).bfloat16()
        assert float(np.mean(_f32(fused) != theirs)) > 0.05


def test_leaky_relu_bf16_matches_jax_forward_and_backward():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 1000)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    xj = jnp.asarray(x).astype(BF16)
    theirs, vjp = jax.vjp(jax.jit(jax_layers.leaky_relu_02), xj)
    dtheirs = jax.jit(lambda gg: vjp(gg)[0])(jnp.asarray(g).astype(BF16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    ours = layers.leaky_relu_02(xt)
    ours.backward(torch.from_numpy(g).bfloat16())
    np.testing.assert_array_equal(_f32(ours), _f32(theirs))
    np.testing.assert_array_equal(_f32(xt.grad), _f32(dtheirs))


def test_rotation_mean_bf16_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 5, 5, 128)).astype(np.float32)
    theirs = jax.jit(lambda xx: jnp.mean(xx, axis=(1, 2)))(
        jnp.asarray(x).astype(BF16))
    ours = spatial.channel_mean(_nchw(x).bfloat16(), None)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(ours), _f32(theirs))


# ---------------------------------------------------------------------------
# model forwards
# ---------------------------------------------------------------------------

def _model(name, bf16, rng):
    """(the JAX module at ``bf16``, a function that makes the port's
    module, the inputs (NHWC), whether it takes ``train``, the part of its
    output compared)."""
    dtype = BF16 if bf16 else jnp.float32
    if name == 'deeplab_v2':
        x = rng.standard_normal((4, 65, 65, 3)).astype(np.float32)
        return (JaxDeepLabV2(backbone='resnet10', num_classes=NUM_CLASSES,
                             bn_axis_name=None, dtype=dtype),
                lambda: DeepLabV2(backbone='resnet10',
                                  num_classes=NUM_CLASSES, bf16=bf16),
                (x,), True, lambda out: out[0])
    if name == 'pspnet':
        x = rng.standard_normal((4, 65, 65, 3)).astype(np.float32)
        return (JaxPSPNet(backbone='resnet10', output_stride=16,
                          num_classes=NUM_CLASSES, bn_axis_name=None,
                          dtype=dtype),
                lambda: PSPNet(backbone='resnet10', output_stride=16,
                               num_classes=NUM_CLASSES, bf16=bf16),
                (x,), True, lambda out: out[0])
    if name == 'flaw_detector':
        x = rng.standard_normal((8, 96, 96, 3)).astype(np.float32)
        p = rng.uniform(0.0, 1.0, (8, 96, 96, NUM_CLASSES)).astype(np.float32)
        return (JaxFD(axis_name=None, dtype=dtype),
                lambda: FlawDetector(3 + NUM_CLASSES, bf16=bf16),
                ((x,), p), True, lambda out: out)
    if name == 'discriminator':
        p = rng.uniform(0.0, 1.0, (4, 65, 65, NUM_CLASSES)).astype(np.float32)
        return (JaxD(dtype=dtype),
                lambda: FCDiscriminator(NUM_CLASSES, bf16=bf16),
                (p,), False, lambda out: out)
    if name == 'rotation':
        x = rng.standard_normal((8, 16, 16, 64)).astype(np.float32)
        return (JaxRC(dtype=dtype),
                lambda: RotationClassifier(64, bf16=bf16),
                (x,), True, lambda out: out)
    assert name == 'unet_lite'
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    kw = dict(spatial_train=1, base_channels=8, bf16=bf16, im_size=64)
    jmodel = jax_sreg.model.UNetLiteModel(
        jax_harness.default_args('ssl_null', **kw))
    return (jmodel.module,
            lambda: sreg.model.UNetLiteModel(harness.default_args(
                'ssl_null', **kw)),
            ((x,),), True, lambda out: out['pred'][0])


def _port_input(a):
    if isinstance(a, tuple):
        return tuple(_port_input(b) for b in a)
    return _nchw(a)


def _nudged(inputs, rng, share=0.01):
    """``inputs`` rounded to bf16 (as the first convolution takes them),
    ``share`` of each array's elements moved up by one bf16 ulp."""
    if isinstance(inputs, tuple):
        return tuple(_nudged(a, rng, share) for a in inputs)
    b = np.asarray(jnp.asarray(inputs).astype(BF16).astype(jnp.float32))
    return np.where(rng.uniform(size=b.shape) < share, b + _ulp(b),
                    b).astype(np.float32)


def _stat(a, b):
    return float(np.mean(np.abs(a - b)))


MODELS = ['deeplab_v2', 'pspnet', 'flaw_detector', 'discriminator',
          'rotation', 'unet_lite']


def _forward_gaps(name, train):
    """(the port's mean |diff| to the jitted JAX forward, JAX's jitted
    against its op-by-op forward, the port's bf16-vs-float32 departure,
    JAX's) of model ``name`` in bf16."""
    rng = np.random.default_rng(5)
    jmod32, build32, inputs, has_train, pick = _model(name, False, rng)
    jmod16, build16 = _model(name, True, rng)[:2]
    jinputs = jax.tree.map(jnp.asarray, inputs)
    kw = {'train': train} if has_train else {}
    variables = _np(jax.jit(lambda key: jmod32.init(key, *jinputs, **kw))(
        jax.random.PRNGKey(6)))
    variables = _with_biases(variables, rng)
    if 'batch_stats' in variables:
        variables['batch_stats'] = _perturb(variables['batch_stats'], rng)
    mutable = ['batch_stats'] if train and has_train else False

    def forward(module):
        def f(v, *xs):
            out = module.apply(v, *xs, mutable=mutable, **kw)
            return pick(out[0] if mutable else out)
        return f

    def japply(f, xs, jit):
        if jit:
            return _f32(f(variables, *xs))
        with jax.disable_jit():
            return _f32(f(variables, *xs))

    def port(build):
        net = build()
        net.load_state_dict(from_jax(variables))
        net.train(train)
        with torch.no_grad():
            return _f32(pick(net(*_port_input(inputs))))

    # one compiled bf16 forward for the input and its nudged copy
    f16 = forward(jmod16)
    jit16 = jax.jit(f16)
    jb, je = japply(jit16, jinputs, True), japply(f16, jinputs, False)
    jf = japply(jax.jit(forward(jmod32)), jinputs, True)
    jn = japply(jit16, jax.tree.map(jnp.asarray, _nudged(inputs, rng)), True)
    pb, pf = port(build16), port(build32)
    assert np.isfinite(pb).all() and pb.shape == jb.shape
    return (_stat(pb, jb), max(_stat(jb, je), _stat(jb, jn)),
            _stat(pb, pf), (_stat(jb, jf), _stat(je, jf), _stat(jn, jf)))


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('name', MODELS)
def test_model_bf16_forward_within_jax_spread(name, train):
    gap, spread, ours, theirs = _forward_gaps(name, train)
    factor = SPREAD_FACTOR_D if name == 'discriminator' else SPREAD_FACTOR
    assert gap <= factor * spread, (gap, spread)
    assert (min(theirs) / (1.0 + DEPARTURE_SHARE) <= ours <=
            max(theirs) * (1.0 + DEPARTURE_SHARE)), (ours, theirs)


# ---------------------------------------------------------------------------
# the first train step
# ---------------------------------------------------------------------------

STEP_COMMON = dict(backbone='resnet10', num_classes=NUM_CLASSES,
                   batch_size=4, unlabeled_batch_size=2, bf16=True,
                   lr=5e-5, momentum=0.9, weight_decay=5e-4, power=0.9,
                   epochs=20)
MT_STEP = dict(ignore_unlabeled=False, cons_for_labeled=True, cons_scale=1.0,
               cons_rampup_epochs=3, ema_decay=0.99, gaussian_noise_std=None)
# id: (algorithm, image size, its arguments)
STEP_RUNS = {
    'ssl_null': ('ssl_null', 64, dict(unlabeled_batch_size=0)),
    'ssl_mt': ('ssl_mt', 64, MT_STEP),
    # the teacher stored in bf16 and run on float32 copies of its weights
    'ssl_mt_bf16_ema': ('ssl_mt', 64, dict(MT_STEP, bf16_ema=True)),
    'ssl_gct': ('ssl_gct', 96, dict(ignore_unlabeled=False, ssl_mode='gct',
                                    fc_ssl_scale=2.0, dc_ssl_scale=1.5,
                                    dc_threshold=0.5, dc_rampup_epochs=1,
                                    fd_lr=1e-4, fd_scale=10.0, mu=0.5,
                                    nu=1)),
}
NUDGES = 2


def _step_pair(name):
    """The JAX algorithm and its mesh, and the port's algorithm, in bf16 on
    the same weights (BN statistics perturbed); the JAX state on the host,
    the batch's arrays and the port's batch."""
    algorithm, im, extra = STEP_RUNS[name]
    args_dict = dict(STEP_COMMON, im_size=im, **extra)
    rng = np.random.default_rng(7)
    n = args_dict['batch_size']
    lbs = n - args_dict['unlabeled_batch_size']
    images = rng.standard_normal((n, im, im, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (n, im, im)).astype(np.int32)
    labels[:lbs, :4, :4] = 255
    labels[lbs:] = -1
    mesh = jax_parallel.make_mesh(1)
    jalgo = jax_harness.build_algorithm(
        jax_harness.default_args(algorithm, **args_dict), mesh=mesh,
        iters_per_epoch=2)
    state = _np(jalgo.state)
    algo = harness.build_algorithm(
        harness.default_args(algorithm, **args_dict), device='cpu',
        iters_per_epoch=2)
    for key, module in algo.modules.items():
        if 'batch_stats' in state[key]:
            state[key]['batch_stats'] = _perturb(state[key]['batch_stats'],
                                                 rng)
        module.load_state_dict(from_jax(state[key]))
    batch = {'inp': (_nchw(images),), 'gt': (torch.from_numpy(labels).long(),)}
    return jalgo, mesh, state, images, labels, algo, batch


def _state_gaps(ours, theirs):
    """Mean |diff| over every parameter and over every BN running
    statistic of the modules' states (``from_jax`` layout)."""
    gaps = {}
    for kind in ('params', 'stats'):
        diffs = [(ours[key][k].float() - theirs[key][k].float()).abs()
                 .reshape(-1) for key in theirs for k in theirs[key]
                 if not k.endswith('num_batches_tracked') and
                 ('running_' in k) == (kind == 'stats')]
        gaps[kind] = float(torch.cat(diffs).mean())
    return gaps


@pytest.mark.parametrize('name', sorted(STEP_RUNS))
def test_first_bf16_train_step_within_jax_spread(name):
    """JAX's spread: its step on the same batch with ``NUDGES`` draws of
    1% of the image's elements moved by one bf16 ulp (an op-by-op step
    takes minutes here). Parameters and BN statistics after the step:
    the mean |diff| within ``STEP_FACTOR`` times the mean of JAX's
    spreads. Measured, SupOnly / MT / MT bf16-EMA / GCT: the port's
    parameters 0.95 / 0.95 / 0.95 / 1.03 of it and its statistics 0.90 /
    0.90 / 0.90 / 0.75; the old rounding policy (native BatchNorm, the
    bias fused; for bf16-EMA, native BatchNorm alone) 1.22 / 1.19 / 1.19
    / 1.13 and 1.34 / 1.34 / 1.34 / 1.37. On six single draws the
    statistics read at most 0.95 for the port and at least 1.32 for the
    old policy; the parameters overlap at GCT alone (0.93-1.03 against
    1.03-1.14), where the statistics tell the two apart. Losses, single
    numbers that the first step's
    chaos moves most: the mean over the loss keys of the relative gap
    within ``SPREAD_FACTOR`` times JAX's largest (the port 0.78 / 0.87 /
    0.87 / 0.60, the old policy 4.3 / 0.94 / 0.94 / 1.9: a check of
    scale, which does not tell MT's policies apart)."""
    jalgo, mesh, state, images, labels, algo, batch = _step_pair(name)

    def jax_step(img):
        jstate = jax.device_put(state, jax_parallel.replicate_sharding(mesh))
        jbatch = jax_parallel.shard_batch({'inp': (img,), 'gt': (labels,)},
                                          mesh)
        new, metrics = jalgo._train_step(jstate, jbatch)
        return ({k: from_jax(v) for k, v in _np(new).items()
                 if k in algo.modules},
                {k: float(np.asarray(v)) for k, v in metrics.items()
                 if k.endswith('_loss')})

    ref_state, ref_losses = jax_step(images)
    rng = np.random.default_rng(8)
    nudged = [jax_step(_nudged(images, rng)) for _ in range(NUDGES)]
    losses = {k: float(v) for k, v in algo.train_step(batch).items()
              if k.endswith('_loss')}
    ours = {k: m.state_dict() for k, m in algo.modules.items()}
    assert set(losses) == set(ref_losses)

    def rel(got):
        return np.mean([abs(got[k] - v) / max(abs(v), 1e-6)
                        for k, v in ref_losses.items()])
    assert rel(losses) <= SPREAD_FACTOR * max(rel(l) for _, l in nudged), \
        (losses, ref_losses)
    gaps = _state_gaps(ours, ref_state)
    spreads = [_state_gaps(st, ref_state) for st, _ in nudged]
    for kind in ('params', 'stats'):
        spread = np.mean([sp[kind] for sp in spreads])
        assert gaps[kind] <= STEP_FACTOR * spread, (kind, gaps, spread)


def test_remat_bf16_equals_the_run_without_it():
    """``--remat`` in bf16: two MT steps from the same weights and batch
    with and without it give the same losses, running statistics and
    parameters. The recompute runs BatchNorm with its statistics left
    alone, and must save for the backward what the forward saved."""
    kw = dict(STEP_COMMON, im_size=33, **MT_STEP)
    args = {remat: harness.default_args('ssl_mt', remat=remat, **kw)
            for remat in (False, True)}
    algos = {remat: harness.build_algorithm(a, device='cpu',
                                            iters_per_epoch=2)
             for remat, a in args.items()}
    for key in ('model', 'teacher'):
        algos[True].modules[key].load_state_dict(
            algos[False].modules[key].state_dict())
    batch = harness.synthetic_batch(args[False], device='cpu', seed=4)
    for _ in range(2):
        plain = algos[False].train_step(batch)
        remat = algos[True].train_step(batch)
        for key in plain:
            assert float(plain[key]) == float(remat[key]), key
    for key in ('model', 'teacher'):
        ours = algos[True].modules[key].state_dict()
        for name, value in algos[False].modules[key].state_dict().items():
            if 'running_' in name or 'num_batches' in name:
                assert torch.equal(ours[name], value), (key, name)
            else:
                np.testing.assert_allclose(ours[name].numpy(),
                                           value.numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=key + name)
