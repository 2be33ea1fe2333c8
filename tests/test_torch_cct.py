"""The port's CCT against the JAX package's: connected components, each
perturbation family on the JAX package's own draws, the auxiliary
decoder, three full CCT steps on PSPNet and one on DeepLab-v2 on the same
weights (carried across by ``pixelssl_tpu_torch.models.from_jax``) with
the JAX draws handed over, the validation, and the checkpoint's name
guard.

Tolerances: component labels, top-k masks, cutout and masking masks, the
dropouts and the feature noise are index or exact elementwise operations
and must be equal (the dropouts' scaling atol 1e-6). The decoder forward
atol 1e-5. VAT at ``xi`` 1e-1 rtol 1e-3, atol 1e-4 of its largest value,
its per-sample norm ``eps`` rtol 1e-5: there its inner gradient is well
conditioned. At the recipe's ``xi`` 1e-6 ``latent + xi * d`` lies below
float32's resolution wherever the latent is O(1), and the KL's gradient
at the unperturbed latent vanishes to first order: the inner gradient,
about 1e-11 an element, falls below the 1e-8 that the normalisation adds
to its norm, in both packages, so the perturbation's norm is about 1.3e-3
and not ``eps``, and its direction is rounding. There the port's norms
are held to JAX's within 10% and to be finite. The train steps run with
``xi`` 1e-1 for that reason, at lr 5e-5 for the reason tests/test_torch_mt.py gives, and with
its tolerances: losses and lr rtol 2e-3; ``cons_loss`` rtol 2e-2, atol
1e-9; params, the decoders' included, atol 3e-4; BN running statistics
atol 1e-4 with rtol 1e-4 on DeepLab-v2, rtol 2e-4 after the three PSPNet
steps: each step's unlabeled forward is a BN batch of 2 rows, 32 values a
channel in layer4 at 64 px, where the JAX layer's float32 E[x^2] - E[x]^2
cancels on running variances of 3-6 (measured: 5 of 512 variances of one
layer4 BN 1.0e-4 to 1.3e-4 apart relatively, every parameter and loss
within its limit). Validation as tests/test_torch_eval.py holds it:
losses rtol 2e-3, scores atol 1e-3.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import parallel
from pixelssl_tpu.models import cct_decoders as jax_cct
from pixelssl_tpu.models.pspnet import UpsampleDecoder as JaxUpsampleDecoder
from pixelssl_tpu.ops import components as jax_components

from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.models import cct_decoders as cct
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.models.pspnet import UpsampleDecoder
from pixelssl_tpu_torch.ops import components
from pixelssl_tpu_torch.ssl_algorithm import ssl_cct
from pixelssl_tpu_torch.utils import logger

from test_torch_eval import _val_batches
from test_torch_gct import _assert_close
from test_torch_models import _nchw, _nhwc, _to_numpy
from test_torch_mt import (MT_ARGS, _jax_and_port,  # noqa: F401
                           one_torch_thread, run_steps)
from test_torch_pspnet import PSP

NUM_CLASSES = 5
CCT_ARGS = dict(
    {k: v for k, v in MT_ARGS.items() if 'ema' not in k and 'noise' not in k
     and 'cons' not in k},
    cons_scale=30.0, cons_rampup_epochs=1, ad_lr_scale=10.0, vat_dec_num=1,
    vat_dec_xi=1e-1, drop_dec_num=2, cut_dec_num=2, context_dec_num=1,
    object_dec_num=1, fn_dec_num=2, fd_dec_num=2)


def _blobs(seed, b=3, h=40, w=50, thresh=0.6):
    """Blobs: upsampled noise, thresholded."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (b, h // 5 + 1, w // 5 + 1))
    fine = np.repeat(np.repeat(coarse, 5, axis=1), 5, axis=2)[:, :h, :w]
    return fine > thresh


def _tie():
    """Three 8 x 8 squares (equal areas, 64 > 50) and a 10 x 10 one."""
    m = np.zeros((1, 40, 40), bool)
    m[0, 30:38, 2:10] = m[0, 2:10, 20:28] = m[0, 20:28, 30:38] = True
    m[0, 14:24, 4:14] = True
    return m


def _spiral(n=41):
    """A square spiral one pixel wide, its rings a pixel apart: one
    component with more turns than six sweeps follow, so it splits into
    several labels, in both packages alike."""
    m = np.zeros((n, n), bool)
    r = c = 0
    m[r, c] = True
    lengths = [n - 1] * 3 + [k for k in range(n - 3, 0, -2) for _ in (0, 1)]
    for i, length in enumerate(lengths):
        dr, dc = ((0, 1), (1, 0), (0, -1), (-1, 0))[i % 4]
        for _ in range(length):
            r, c = r + dr, c + dc
            m[r, c] = True
    return m[None]


@pytest.mark.parametrize('name,mask', [
    ('blobs', _blobs(0)), ('sparse', _blobs(1, thresh=0.85)),
    ('tie', _tie()), ('spiral', _spiral()),
    ('empty', np.zeros((2, 9, 11), bool)), ('full', np.ones((1, 7, 5), bool))])
def test_components_equal_jax(name, mask):
    labels = components.label_components(torch.from_numpy(mask))
    theirs = np.asarray(jax_components.label_components(jnp.asarray(mask)))
    np.testing.assert_array_equal(labels.numpy(), theirs)
    for k, min_size in ((2, 50), (3, 0), (1, 10)):
        masks, sizes = components.top_k_components(labels, k, min_size)
        jmasks, jsizes = jax_components.top_k_components(jnp.asarray(theirs),
                                                         k, min_size)
        np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
        np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))
    if name == 'tie':  # the two lowest labels of the three equal squares
        masks, sizes = components.top_k_components(labels, 3, 50)
        assert sizes.tolist() == [[100, 64, 64]]
        assert bool(masks[0, 1, 2, 20]) and bool(masks[0, 2, 20, 30])
    if name == 'spiral':
        assert len(np.unique(theirs[mask])) > 1


def _latent(seed, shape=(2, 6, 7, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _main_pred(seed, b=2, h=48, w=56):
    """Logits with objects: class scores upsampled from a coarse grid."""
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((b, h // 8, w // 8, NUM_CLASSES))
    coarse[..., 0] += 0.8  # background wins about half of the cells
    return np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.mark.parametrize('spatial', [True, False])
def test_dropouts_match_jax_on_its_draws(spatial):
    x = _latent(0)
    key = jax.random.PRNGKey(1)
    rate = 0.5
    if spatial:
        theirs = jax_cct.spatial_dropout(jnp.asarray(x), key, rate)
        keep = jax.random.bernoulli(key, 1 - rate, (2, 1, 1, x.shape[-1]))
        ours = cct.spatial_dropout(_nchw(x), _t(keep).permute(0, 3, 1, 2),
                                   rate)
    else:
        theirs = jax_cct.element_dropout(jnp.asarray(x), key, rate)
        keep = jax.random.bernoulli(key, 1 - rate, x.shape)
        ours = cct.element_dropout(_nchw(x), _nchw(np.asarray(keep)), rate)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(theirs), atol=1e-6)
    draw = cct.draw_keep(torch.Generator().manual_seed(0), (64, 32, 1, 1),
                         rate, 'cpu')
    assert draw.dtype == torch.bool and abs(float(draw.float().mean()) -
                                            0.5) < 0.05


@pytest.mark.parametrize('n_components', [2, 0, 3])
def test_guided_cutout_mask_equals_jax_on_its_draws(n_components):
    pred = _main_pred(2)
    resize = (6, 7)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        theirs = jax_cct.guided_cutout_mask(jnp.asarray(pred), key, 0.4,
                                            resize, n_components=n_components)
        k1, k2 = jax.random.split(key)
        k = max(n_components, 1)
        u_h, u_w = (_t(jax.random.uniform(kk, (2, k))) for kk in (k1, k2))
        ours = cct.guided_cutout_mask(_nchw(pred), u_h, u_w, 0.4, resize,
                                      n_components=n_components)
        assert ours.shape == (2, 1) + resize
        np.testing.assert_array_equal(_nhwc(ours), np.asarray(theirs))
        # at the prediction's size the box is erased too
        full = cct.guided_cutout_mask(_nchw(pred), u_h, u_w, 0.4, (48, 56),
                                      n_components=n_components)
        assert 0.0 < float(full.mean()) < 1.0


@pytest.mark.parametrize('context', [True, False])
def test_guided_masking_equals_jax(context):
    x, pred = _latent(3), _main_pred(4)
    theirs = jax_cct.guided_masking(jnp.asarray(x), jnp.asarray(pred), context)
    ours = cct.guided_masking(_nchw(x), _nchw(pred), context)
    np.testing.assert_array_equal(_nhwc(ours), np.asarray(theirs))


def test_feature_dropout_and_noise_match_jax_on_their_draws():
    x = _latent(5)
    key = jax.random.PRNGKey(6)
    u = jax.random.uniform(key, (2, 1, 1, 1), minval=0.7, maxval=0.9)
    ours = cct.feature_dropout(_nchw(x), _t(u))
    theirs = jax_cct.feature_dropout(jnp.asarray(x), key)
    np.testing.assert_array_equal(_nhwc(ours), np.asarray(theirs))
    assert 0 < float((ours == 0).float().mean()) < 1

    noise = jax.random.uniform(key, x.shape[1:], minval=-0.3, maxval=0.3)
    ours = cct.feature_noise(_nchw(x), _t(noise).permute(2, 0, 1))
    theirs = jax_cct.feature_noise(jnp.asarray(x), key, 0.3)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(theirs), atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    n = cct.draw_feature_noise(gen, (16, 6, 7), 0.3, 'cpu')
    f = cct.draw_feature_drop(gen, 256, 'cpu')
    assert n.shape == (16, 6, 7) and float(n.abs().max()) <= 0.3
    assert 0.7 <= float(f.min()) and float(f.max()) < 0.9


def _decoder_pair(seed, c_in=16):
    jdec = JaxUpsampleDecoder(out_channels=NUM_CLASSES, upscale=8)
    variables = _to_numpy(jdec.init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 6, 7, c_in))))
    dec = UpsampleDecoder(c_in, NUM_CLASSES, 8)
    dec.load_state_dict(from_jax(variables))
    return jdec, variables, dec


def test_upsample_decoder_matches_jax():
    x = _latent(7)
    jdec, variables, dec = _decoder_pair(8)
    variables['params'] = jax.tree.map(  # biases away from their zero init
        lambda p: p + 0.05 * np.random.default_rng(9).standard_normal(
            p.shape).astype(np.float32), variables['params'])
    dec.load_state_dict(from_jax(variables))
    ours = dec(_nchw(x))
    assert ours.shape == (2, NUM_CLASSES, 48, 56)
    np.testing.assert_allclose(
        _nhwc(ours), np.asarray(jdec.apply(variables, jnp.asarray(x))),
        atol=1e-5)


@pytest.mark.parametrize('xi', [1e-1, 1e-6])
def test_vat_perturbation(xi):
    """Against JAX at ``xi`` 1e-1 on its draw; at the recipe's 1e-6 its
    norm only (module docstring). Either way the decoder's parameters
    gather no gradient."""
    x = _latent(10)
    jdec, variables, dec = _decoder_pair(11)
    key = jax.random.PRNGKey(12)
    eps = 2.0
    d0 = jax.random.uniform(key, x.shape, dtype=jnp.float32) - 0.5
    ours = cct.vat_perturbation(dec, _nchw(x).requires_grad_(),
                                _nchw(np.asarray(d0)), xi, eps)
    assert all(p.grad is None for p in dec.parameters())
    assert not ours.requires_grad and bool(torch.isfinite(ours).all())
    theirs = np.asarray(jax_cct.vat_perturbation(
        lambda z: jdec.apply(variables, z), jnp.asarray(x), key, xi, eps))
    norms = ours.flatten(1).norm(dim=1).numpy()
    if xi >= 1e-1:
        np.testing.assert_allclose(norms, [eps, eps], rtol=1e-5)
        np.testing.assert_allclose(_nhwc(ours), theirs, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(theirs).max()))
    else:
        their_norms = np.linalg.norm(theirs.reshape(2, -1), axis=1)
        assert (their_norms < 1e-2 * eps).all()
        np.testing.assert_allclose(norms, their_norms, rtol=0.1)


def _jax_decoder_draws(jstate, specs, latent_nhwc, steps):
    """The draws of each decoder of the JAX step ``s`` for each ``s``, as
    the port's ``_draw_decoder_noise`` returns them (NCHW): the step's key
    is the state's folded with ``s * 131`` and then with the device index,
    0 on one device, split into one key a decoder (JAX ssl_cct.py:228)."""
    b = latent_nhwc[0]
    out = []
    for s in range(steps):
        rng = jax.random.fold_in(jax.random.fold_in(jstate['rng'], s * 131),
                                 0)
        draws = []
        for (family, cfg), key in zip(specs, jax.random.split(rng,
                                                              len(specs))):
            if family == 'vat':
                d = jax.random.uniform(key, latent_nhwc) - 0.5
                draws.append(_t(d).permute(0, 3, 1, 2))
            elif family == 'drop':
                shape = ((b, 1, 1, latent_nhwc[-1]) if cfg['spatial']
                         else latent_nhwc)
                keep = jax.random.bernoulli(key, 1.0 - cfg['rate'], shape)
                draws.append(_t(keep).permute(0, 3, 1, 2))
            elif family == 'cut':
                k1, k2 = jax.random.split(key)
                k = max(cfg['components'], 1)
                draws.append(tuple(_t(jax.random.uniform(kk, (b, k)))
                                   for kk in (k1, k2)))
            elif family == 'fdrop':
                draws.append(_t(jax.random.uniform(
                    key, (b, 1, 1, 1), minval=0.7, maxval=0.9)))
            elif family == 'fnoise':
                draws.append(_t(jax.random.uniform(
                    key, latent_nhwc[1:], minval=-cfg['uniform'],
                    maxval=cfg['uniform'])).permute(2, 0, 1))
            else:
                draws.append(None)
        out.append(draws)
    return out


def _cct_pair(args_dict, seed, steps):
    rng = np.random.default_rng(seed)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port('ssl_cct', args_dict,
                                                       rng)
    algo.model.eval()  # the latent's shape, BN statistics unmoved
    with torch.no_grad():
        latent = algo.model(tuple(t[:1] for t in batch['inp']))[
            'sslcct_ad_inp']
    algo.model.train()
    ubs = args_dict['unlabeled_batch_size']
    shape = (ubs,) + tuple(latent.shape[2:]) + (latent.shape[1],)
    draws = _jax_decoder_draws(jstate, algo.specs, shape, steps)
    algo._draw_decoder_noise = lambda step, latent_shape: draws[step]
    return jalgo, jstate, jbatch, algo, batch


def test_cct_three_steps_on_pspnet_match_jax():
    args_dict = dict(CCT_ARGS, **PSP)
    jalgo, jstate, jbatch, algo, batch = _cct_pair(args_dict, 16, 3)
    assert [f for f, _ in algo.specs] == (
        ['vat'] + ['drop'] * 2 + ['cut'] * 2 + ['context', 'object'] +
        ['fdrop'] * 2 + ['fnoise'] * 2)
    assert [g['lr_mult'] for g in algo.opt.param_groups] == [1.0, 10.0, 10.0,
                                                            10.0]
    final, history = run_steps(jalgo, jstate, jbatch, algo, batch,
                               ('task_loss', 'cons_loss', 'lr'),
                               {'cons_loss': (2e-2, 1e-9)})
    for h in history:
        assert h['task_loss'] > 0 and h['cons_loss'] > 0, h
    ours, theirs = algo.model.state_dict(), from_jax(final['model'])
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        if not key.endswith('num_batches_tracked'):
            stat = 'running_' in key
            np.testing.assert_allclose(
                ours[key].numpy(), value.numpy(), atol=1e-4 if stat else 3e-4,
                rtol=2e-4 if stat else 0, err_msg=key)
    assert all(p.grad is not None for p in algo.model.ads.parameters())

    ours_batches, jax_batches = _val_batches(algo.args)
    mesh = parallel.make_mesh(1)
    jalgo.state = jax.device_put(final, parallel.replicate_sharding(mesh))
    ours = algo.validate(ours_batches, epoch=1)
    theirs = jalgo.validate(jax_batches, epoch=1)
    assert set(ours) == set(theirs) == {
        'ssl_cct_metric_{0}'.format(m)
        for m in ('acc', 'acc_class', 'mIoU', 'fwIoU')}
    for key in ours:
        assert ours[key] == pytest.approx(float(theirs[key]), abs=1e-3), key
    assert algo.meters['ssl_cct_loss'].avg == pytest.approx(
        float(jalgo.meters['ssl_cct_loss'].avg), rel=2e-3)


def test_cct_step_on_deeplabv2_matches_jax():
    """One step with one decoder of each family on DeepLab-v2, whose
    latent is the backbone's 2048 channels."""
    args_dict = dict(CCT_ARGS, drop_dec_num=1, cut_dec_num=1, fn_dec_num=1,
                     fd_dec_num=1)
    jalgo, jstate, jbatch, algo, batch = _cct_pair(args_dict, 17, 1)
    assert algo.model.ads['ad_0'].conv1x1.in_channels == 2048
    jstate, jmetrics = jalgo._train_step(jstate, jbatch)
    metrics = algo.train_step(batch)
    for k, (rtol, atol) in (('task_loss', (2e-3, 1e-6)),
                            ('lr', (2e-3, 1e-6)),
                            ('cons_loss', (2e-2, 1e-9))):
        assert np.isclose(float(metrics[k]), float(jmetrics[k]), rtol=rtol,
                          atol=atol), (k, float(metrics[k]),
                                       float(jmetrics[k]))
    _assert_close(algo.model, jax.tree.map(np.asarray, jax.device_get(
        jstate['model'])), 3e-4, 1e-4, 'model')


def test_cct_flags_and_no_unlabeled_data():
    """With unlabeled data the flags are checked; without, the task model
    trains alone and the decoders' group is absent."""
    base = dict(CCT_ARGS, **PSP)
    for bad in (dict(vat_dec_num=0, drop_dec_num=0, cut_dec_num=0,
                     context_dec_num=0, object_dec_num=0, fn_dec_num=0,
                     fd_dec_num=0), dict(cons_scale=-1),
                dict(cons_rampup_epochs=-1), dict(ad_lr_scale=-1)):
        with pytest.raises(logger.FatalError):
            harness.build_algorithm(harness.default_args(
                'ssl_cct', **dict(base, im_size=32, **bad)), device='cpu')
    args = harness.default_args('ssl_cct', **dict(
        base, im_size=32, unlabeled_batch_size=0, vat_dec_num=0,
        drop_dec_num=0, cut_dec_num=0, context_dec_num=0, object_dec_num=0,
        fn_dec_num=0, fd_dec_num=0, cons_scale=-1))
    algo = harness.build_algorithm(args, device='cpu')
    assert [g['lr_mult'] for g in algo.opt.param_groups] == [1.0, 10.0, 10.0]
    metrics = algo.train_step(harness.synthetic_batch(args, device='cpu'))
    assert float(metrics['cons_loss']) == 0 and float(
        metrics['task_loss']) > 0


@pytest.mark.parametrize('saved_by,loaded_into', [('ssl_cct', 'ssl_null'),
                                                  ('ssl_cutmix', 'ssl_cct')])
def test_cct_checkpoint_round_trip_and_name_guard(saved_by, loaded_into,
                                                  tmp_path):
    """A CCT checkpoint carries the decoders and the optimizer's momentum
    and loads back equal; another algorithm's is refused either way."""
    kw = dict(CCT_ARGS, im_size=32, **PSP)
    cutmix_kw = dict(MT_ARGS, im_size=32, cons_threshold=0.05, **PSP)
    args = {'ssl_cct': kw, 'ssl_null': dict(kw, unlabeled_batch_size=0),
            'ssl_cutmix': cutmix_kw}

    def build(name, seed):
        a = harness.default_args(name, **dict(args[name], seed=seed))
        return harness.build_algorithm(a, device='cpu'), a

    algo, a = build(saved_by, 0)
    algo.train_step(harness.synthetic_batch(a, device='cpu', seed=1))
    path = algo.save_checkpoint(epoch=2, path=str(tmp_path / 'c.pth'))
    try:
        if saved_by == 'ssl_cct':
            fresh, _ = build('ssl_cct', 1)
            assert fresh.load_checkpoint(path) == 2
            ours, theirs = algo.model.state_dict(), fresh.model.state_dict()
            assert any(k.startswith('ads.ad_10.') for k in ours)
            for k in ours:
                assert torch.equal(ours[k], theirs[k]), k
            for pid, st in algo.opt.state_dict()['state'].items():
                assert torch.equal(st['momentum_buffer'],
                                   fresh.opt.state_dict()['state'][pid][
                                       'momentum_buffer'])
        other, _ = build(loaded_into, 2)
        with pytest.raises(logger.FatalError,
                           match='`{0}`, expected `{1}`'.format(
                               saved_by, loaded_into)):
            other.load_checkpoint(path)
    finally:  # 300-460 MB: not left in pytest's temporary directories
        os.remove(path)


def test_decoder_specs_follow_the_jax_order():
    args = harness.default_args('ssl_cct', **dict(
        CCT_ARGS, vat_dec_num=2, fn_dec_num=1, fd_dec_num=3))
    assert [f for f, _ in ssl_cct.decoder_specs(args)] == (
        ['vat'] * 2 + ['drop'] * 2 + ['cut'] * 2 + ['context', 'object'] +
        ['fdrop'] * 3 + ['fnoise'])
