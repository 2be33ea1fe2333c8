"""The port's spatial partitioning (``pixelssl_tpu_torch.parallel.spatial``,
``--spatial-train``, ``--spatial-val``) against one process and against the
JAX package's GSPMD meshes.

Ranks run over gloo as processes of ``tests/_torch_spatial_worker.py``
(each with a timeout of ``TIMEOUT`` s; a failing rank fails the test), H
split by ``row_range``, uneven at the odd heights used here.

* Layers, two ranks against one process (the worker's own cases): the
  convolutions of the models (3x3 at stride 1 and 2 and dilation 2, the
  dilation 24 of ASPP on maps of 33, 65 and 21 rows, shorter than its
  halo, the strided 1x1, the 7x7 stem, the flaw detector's 4x4 at stride 2
  and 1), the 3x3/2 max pool, the align-corners resize up and down,
  ``SyncBatchNorm`` and ``IBNorm`` in training, the blur's strip path at
  k = 5, 21 and 81 (> H), GCT's 3x3 dilation, AdvSSL's discriminator (its
  4x4/2 chain and the resize back, at 33 and 65 rows), S4L's rotation head
  (convolutions, BN and the spatial group's channel mean), the gather of a
  whole map and the rotation of a row-sharded square map: output, input
  gradient, parameter gradients summed over the ranks and BN statistics,
  atol and rtol 1e-5 (the loss map scaled so that gradients are about
  1).
* DeepLab-v2 / ResNet-10 in eval mode over two ranks: equal to one process
  (atol 1e-5) at 65 and 64 rows, and at 64 to the JAX package's
  ``spatial_forward`` on a 2-device mesh (``tests/test_spatial.py``'s
  1e-4).
* Two train steps from the JAX package's initial weights (``from_jax``)
  under ``--spatial-train 2`` on two ranks: SupOnly at 33 px, MT at 33 px
  with its Gaussian input noise on, GCT at 96 px (``tests/test_torch_
  parallel.py`` says why 96), AdvSSL at 33 px with ``--adv-for-labeled``,
  S4L at 33 px, CutMix at 33 px with 4 unlabeled samples; SupOnly and
  CutMix (its pairs those of the global unlabeled block) at 33 px on a 2
  data x 2 spatial grid of four ranks. Each equals the port in one process
  on the global batch with ``tests/test_torch_parallel.py``'s limits
  (losses rtol 1e-4 atol 1e-5, the consistencies and GCT's thresholded
  fc/dc rtol 2e-2, parameters and BN statistics atol 1e-5 rtol 1e-4, the
  Adam-trained flaw detector's and D's atol ``FD_ATOL``). SupOnly and
  AdvSSL at 32 px also equal the JAX package's step on
  ``make_mesh_2d(2, devices=jax.devices()[:2])`` (rtol 2e-3 on the loss,
  parameters atol 3e-4, statistics atol 1e-4). GCT calls the blur 6 times
  a step on each rank, each on its strip of rows.
* ``run_script`` with ``--distributed --spatial-train 2`` on two ranks
  trains like one process (``tests/test_torch_parallel.py``'s script
  limits) and its validation (whole samples) equals one process's on the
  trained weights (rtol 1e-6); ``--validation --spatial-val`` on two ranks
  scores like one process on the same padded images (rtol 1e-6) and like
  the JAX package's ``--spatial-val`` on a 2-device mesh (losses rtol
  2e-3, scores atol 1e-3, ``tests/test_torch_proxy.py``'s).
* ``--visualize``: GCT at 96 px and AdvSSL under ``--distributed
  --spatial-train 2``, and ``--validation --spatial-val`` on two ranks,
  write one process's PNG names and sizes, the input and GT byte for
  byte, the model's maps within ``COLOUR_SAME`` / ``GRAY_LEVELS``; a
  visualized GCT step blurs 6 times on each rank's strips.
* Every refusal: the two flags together, an N that does not divide the
  ranks, and ``--spatial-train`` without ``--distributed`` stop as the JAX
  package stops (PSPNet, CCT and ``sreg`` run:
  ``tests/test_torch_spatial_models.py``).
* ``pixelssl_tpu_torch/tools/spatial_spread.py`` runs and reports its
  gaps.
"""

import collections
import fcntl
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel as jax_parallel
from pixelssl_tpu import runner as jax_runner
from pixelssl_tpu.models.deeplab_v2 import DeepLabV2 as JaxDeepLabV2
from pixelssl_tpu.parallel import spatial as jax_spatial
from pixelssl_tpu.tasks import sseg as jax_sseg
from pixelssl_tpu.utils import cmd as jax_cmd

import pixelssl_tpu_torch
from pixelssl_tpu_torch import harness, parallel
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.models.deeplab_v2 import DeepLabV2
from pixelssl_tpu_torch.nn import imageio
from pixelssl_tpu_torch.parallel import spatial
from pixelssl_tpu_torch.tasks import sseg
from pixelssl_tpu_torch.utils import logger

import _torch_spatial_worker as worker
from test_torch_mt import _trim_heap, one_torch_thread  # noqa: F401

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '_torch_spatial_worker.py')
TIMEOUT = 240
NUM_CLASSES = 5
STEPS = 2
ITERS_PER_EPOCH = 10
FD_ATOL = 1e-3
# BN running statistics against one process: atol 1e-4 (the JAX column of
# tests/test_torch_parallel.py) and rtol 1e-3. On this file's weights the
# two ranks' running variances after two steps sat up to 4.0e-4 (1.9e-4
# relative) from one process's at one torch thread: float32 sums in
# another order, through step 1's update, which a deeper net magnifies
# further (``python -m pixelssl_tpu_torch.tools.spatial_spread``)
STATS_TOL = (1e-4, 1e-3)
# GCT's parameters: the JAX column (3e-4). Its step 2 thresholds flawmaps
# that the strip blur rounds otherwise than the whole-map one:
# ``spatial_spread --algorithm ssl_gct --im-size 96`` measures two ranks'
# step-2 thresholded losses 5.8e-3 from one process's (step 1's 1.4e-6) and
# the weights after it 3.9e-4 apart (the flaw detector's included; one
# process on 4 threads 3.8e-4)
PARAM_ATOL = {'ssl_gct': 3e-4}
# scores of a random-weight net against one process: a pixel whose two
# best logits tie to float32 noise may take the other class in the
# row-sharded forward (measured: mIoU 0.0534741 against 0.0534737 on 8
# images of 48 x 48); one pixel of them moves a score by about 1e-5
SCORE_ATOL = 1e-4
LAYER_TOL = 1e-5
ONE_PROCESS_TOLS = {'cons_loss': 2e-2, 'l_fc_loss': 2e-2, 'r_fc_loss': 2e-2,
                    'l_dc_loss': 2e-2, 'r_dc_loss': 2e-2}


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawn(job, tmp_path, world, timeout=TIMEOUT):
    """Run ``job`` on ``world`` worker processes; returns each rank's
    output. A rank that fails or outlives ``timeout`` s fails the test."""
    return _finish(_start(job, tmp_path, world), timeout)


def _start(job, tmp_path, world):
    """Start ``job`` on ``world`` worker processes, each writing its log to
    a file (a pipe left unread would stall it); ``_finish`` waits."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    job_path = str(tmp_path / 'job.pt')
    torch.save(dict(job, world=world, port=_free_port()), job_path)
    env = dict(os.environ, OMP_NUM_THREADS='1')
    outs = [str(tmp_path / 'out{0}.pt'.format(r)) for r in range(world)]
    logs = [str(tmp_path / 'log{0}.txt'.format(r)) for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], 'wb') as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, job_path, str(r), outs[r]],
                stdout=log, stderr=subprocess.STDOUT, env=env))
    return procs, job_path, outs, logs, time.time()


def _finish(started, timeout=TIMEOUT):
    """Each rank's output of a ``_start``; a rank that fails or outlives
    ``timeout`` s from its start fails the test."""
    procs, job_path, outs, logs, t0 = started
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, t0 + timeout - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        with open(log, 'rb') as f:
            text = f.read().decode(errors='replace')
        assert proc.returncode == 0, 'rank {0} failed:\n{1}'.format(
            rank, text[-4000:])
    results = [torch.load(path, weights_only=False) for path in outs]
    for path in [job_path] + outs + logs:  # weights: tens of MB a run
        os.remove(path)
    return results


# ---------------------------------------------------------------------------
# host helpers and one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('h,n', [(33, 2), (21, 2), (65, 4), (3, 4), (64, 8)])
def test_row_range_splits_the_map(h, n):
    blocks = [parallel.row_range(h, n, r) for r in range(n)]
    assert blocks[0][0] == 0 and blocks[-1][1] == h
    for (a, b), (c, _) in zip(blocks, blocks[1:]):
        assert b == c
    sizes = [b - a for a, b in blocks]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


@pytest.mark.parametrize('h,multiple', [(33, 2), (64, 4), (97, 8)])
def test_pad_height_matches_jax(h, multiple):
    x = np.random.default_rng(h).standard_normal((2, h, 5, 3))
    ours, h0 = parallel.pad_height_to(None, x, multiple=multiple)
    theirs, h1 = jax_spatial.pad_height_to(None, x, multiple=multiple)
    assert h0 == h1 == h
    np.testing.assert_array_equal(ours, theirs)


def test_grid_axes_and_refusal_match_jax():
    """The device order and the data axis of the grid are the JAX
    ``make_mesh_2d``'s; an N that does not divide the ranks raises."""
    devices = jax.devices()[:8]
    jmesh = jax_spatial.make_mesh_2d(2, devices=devices)
    order = np.vectorize(lambda d: devices.index(d))(jmesh.devices)
    for rank in range(8):
        mesh = spatial.grid_position(2, rank, 8)
        assert order[mesh.data_rank, mesh.spatial_rank] == rank
        assert parallel.data_axis_size(mesh) == \
            jax_spatial.data_axis_size(jmesh) == 4
    with pytest.raises(ValueError) as ours:
        parallel.make_mesh_2d(2)
    with pytest.raises(ValueError) as theirs:
        jax_spatial.make_mesh_2d(2, devices=devices[:1])
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize('fill', [spatial.ZERO, spatial.NEG_INF,
                                  spatial.REFLECT])
def test_fetch_rows_on_one_rank_pads_and_folds(fill):
    """One rank: rows [-9, 14) of a 5-row map are its rows, a fill, or
    their reflection folded over and over (``ops.blur._blur_matrix``'s
    rule); the gradient sums back onto the rows read."""
    mesh = parallel.make_mesh_2d(1)
    x = torch.arange(10.0).reshape(1, 1, 5, 2).requires_grad_(True)
    out = spatial.fetch_rows(x, 5, [(-9, 14)], mesh, fill)
    rows = list(range(-9, 14))
    for i, j in enumerate(rows):
        got = out[0, 0, i]
        if 0 <= j < 5:
            assert torch.equal(got, x[0, 0, j])
        elif fill == spatial.ZERO:
            assert torch.equal(got, torch.zeros(2))
        elif fill == spatial.NEG_INF:
            assert bool(torch.isinf(got).all()) and bool((got < 0).all())
        else:
            k = j
            while k < 0 or k >= 5:
                k = -k if k < 0 else 8 - k
            assert torch.equal(got, x[0, 0, k])
    out[torch.isfinite(out)].sum().backward()
    counts = [sum(1 for j in rows if j == r) for r in range(5)]
    if fill == spatial.REFLECT:
        counts = [0] * 5
        for j in rows:
            k = j
            while k < 0 or k >= 5:
                k = -k if k < 0 else 8 - k
            counts[k] += 1
    np.testing.assert_array_equal(x.grad[0, 0, :, 0].numpy(), counts)


def test_one_rank_grid_is_the_plain_forward():
    """Inside ``sharded`` on a grid of one rank every layer is the plain
    one: DeepLab-v2 and its eval loss equal outside the context."""
    torch.manual_seed(0)
    net = DeepLabV2(backbone='resnet10', output_stride=16, num_classes=5)
    net.init_weights(torch.Generator().manual_seed(0))
    net.eval()
    x = torch.from_numpy(worker.model_input(33, 40)).permute(0, 3, 1, 2)
    with torch.no_grad():
        plain = net(x)[0]
        with spatial.sharded(parallel.make_mesh_2d(1), 33):
            rows = net(x)[0]
    np.testing.assert_allclose(rows.numpy(), plain.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# layers and the model over two ranks
# ---------------------------------------------------------------------------

def _jax_deeplab(h, w):
    net = JaxDeepLabV2(backbone='resnet10', output_stride=16,
                       num_classes=NUM_CLASSES)
    x = worker.model_input(h, w, seed=1)
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    mesh = jax_parallel.make_mesh(2)
    fwd = jax_spatial.spatial_forward(
        lambda v, img: net.apply(v, img, train=False)[0], mesh)
    out = fwd(variables, jax.device_put(
        x, jax_spatial.spatial_image_sharding(mesh)))
    return jax.tree.map(np.asarray, variables), np.asarray(out), x


def _layer_runs(root):
    """One run of two ranks: every layer case, and the model forwards with
    their one-process and JAX references."""
    variables, jax_out, x64 = _jax_deeplab(64, 48)
    state = from_jax(variables)
    inputs = [worker.model_input(65, 40), x64]
    job = dict(kind='layers', cases=worker.layer_cases(),
               model=dict(num_classes=NUM_CLASSES, state=state,
                          inputs=inputs))
    ranks = _spawn(job, root, 2)
    net = DeepLabV2(backbone='resnet10', output_stride=16,
                    num_classes=NUM_CLASSES)
    net.load_state_dict(state)
    net.eval()
    with torch.no_grad():
        refs = [net(torch.from_numpy(x).permute(0, 3, 1, 2))[0]
                for x in inputs]
    models = [(torch.cat([r['model'][i] for r in ranks], 2), refs[i])
              for i in range(len(inputs))]
    return {'layers': [r['layers'] for r in ranks], 'models': models,
            'jax': jax_out}


@pytest.fixture(scope='module')
def layer_runs(tmp_path_factory):
    return _shared(tmp_path_factory, 'spatial_layers', _layer_runs)


@pytest.mark.parametrize('case', worker.layer_cases(),
                         ids=['{0}-{1}'.format(*c) for c in
                              worker.layer_cases()])
def test_layer_on_two_ranks_matches_one_process(case, layer_runs):
    ref = worker.run_layer(*case)
    parts = [r[case] for r in layer_runs['layers']]
    for key, dim in (('out', ref['out_dim']), ('grad', ref['h_dim'])):
        # an output every rank gives whole (the rotation head's logits,
        # a gathered map) equals the reference on each rank
        for got in ([p[key] for p in parts] if dim is None else
                    [torch.cat([p[key] for p in parts], dim)]):
            np.testing.assert_allclose(got.numpy(), ref[key].numpy(),
                                       atol=LAYER_TOL, rtol=LAYER_TOL,
                                       err_msg=key)
    for name, value in ref['params'].items():
        got = sum(p['params'][name] for p in parts)
        np.testing.assert_allclose(got.numpy(), value.numpy(),
                                   atol=LAYER_TOL, rtol=LAYER_TOL,
                                   err_msg=name)
    for name, value in ref['buffers'].items():
        for p in parts:
            np.testing.assert_allclose(
                p['buffers'][name].float().numpy(), value.float().numpy(),
                atol=LAYER_TOL, rtol=LAYER_TOL, err_msg=name)
    if case[0] == 'conv3_d24' and case[1] < 48:  # a halo wider than a shard
        assert all(p['out'].shape[2] < 24 for p in parts)


@pytest.mark.parametrize('which', [0, 1], ids=['65x40', '64x48-jax'])
def test_deeplab_on_two_ranks_matches_one_process_and_jax(which, layer_runs):
    got, ref = layer_runs['models'][which]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    if which == 1:
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   layer_runs['jax'], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

ADV_ARGS = dict(batch_size=4, unlabeled_batch_size=2, ignore_unlabeled=False,
                adv_for_labeled=True, labeled_adv_scale=0.01,
                unlabeled_adv_scale=0.001, unlabeled_for_discriminator=True)
CUTMIX_THRESHOLD = 0.35
STEP_RUNS = {
    'ssl_null': ('ssl_null', 33, dict(batch_size=4, unlabeled_batch_size=0)),
    'ssl_null_jax': ('ssl_null', 32, dict(batch_size=4,
                                          unlabeled_batch_size=0)),
    'ssl_mt': ('ssl_mt', 33, dict(batch_size=4, unlabeled_batch_size=2,
                                  ignore_unlabeled=False,
                                  cons_for_labeled=True, cons_scale=1.0,
                                  cons_rampup_epochs=1, ema_decay=0.99,
                                  gaussian_noise_std=0.1)),
    'ssl_gct': ('ssl_gct', 96, dict(batch_size=4, unlabeled_batch_size=2,
                                    ignore_unlabeled=False, ssl_mode='gct',
                                    fc_ssl_scale=2.0, dc_ssl_scale=1.5,
                                    dc_threshold=0.5, dc_rampup_epochs=1,
                                    fd_lr=1e-4, fd_scale=10.0, mu=0.5,
                                    nu=1)),
    'ssl_adv': ('ssl_adv', 33, ADV_ARGS),
    'ssl_adv_jax': ('ssl_adv', 32, ADV_ARGS),
    'ssl_s4l': ('ssl_s4l', 33, dict(batch_size=4, unlabeled_batch_size=2,
                                    ignore_unlabeled=False,
                                    rotated_sup_scale=0.1,
                                    rotation_scale=0.1)),
    # 4 unlabeled samples: two pairs, one a data coordinate on a 2 x 2 grid;
    # the threshold leaves the confidence a fraction of the pixels
    'ssl_cutmix': ('ssl_cutmix', 33, dict(batch_size=6,
                                          unlabeled_batch_size=4,
                                          ignore_unlabeled=False,
                                          cons_scale=20.0,
                                          cons_rampup_epochs=0,
                                          cons_threshold=CUTMIX_THRESHOLD,
                                          mask_prop_range=(0.5, 0.5))),
}
# the runs on a 2 data x 2 spatial grid of four ranks
GRID_RUNS = ('ssl_null', 'ssl_cutmix')
# the runs against the JAX package's GSPMD step
JAX_RUNS = ('ssl_null_jax', 'ssl_adv_jax')


def _step_args(name):
    algorithm, im, extra = STEP_RUNS[name]
    return algorithm, dict(backbone='resnet10', im_size=im,
                           num_classes=NUM_CLASSES, bf16=False, lr=5e-5,
                           momentum=0.9, weight_decay=5e-4, power=0.9,
                           epochs=20, seed=3, **extra)


def _global_batch(args_dict, seed):
    rng = np.random.default_rng(seed)
    n, im = args_dict['batch_size'], args_dict['im_size']
    lbs = n - args_dict['unlabeled_batch_size']
    images = rng.standard_normal((n, im, im, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (n, im, im)).astype(np.int32)
    labels[:lbs, :4, :4] = 255
    labels[lbs:] = -1
    return images, labels


def _run(name):
    """The run's JAX initial weights (as the port's states), its global
    batch, and the port's steps in one process on it."""
    algorithm, args_dict = _step_args(name)
    jargs = jax_harness.default_args(algorithm, **args_dict)
    jalgo = jax_harness.build_algorithm(jargs, mesh=jax_parallel.make_mesh(1),
                                        iters_per_epoch=ITERS_PER_EPOCH)
    initial = jax.tree.map(np.asarray, jax.device_get(jalgo.state))
    images, labels = _global_batch(args_dict, len(name))
    args = harness.default_args(algorithm, **args_dict)
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS_PER_EPOCH)
    states = {key: from_jax(initial[key]) for key in algo.modules}
    for key, module in algo.modules.items():
        module.load_state_dict(states[key])
    batch = harness._to_batch(images, labels, 'cpu')
    one = [{k: float(v) for k, v in algo.train_step(batch).items()}
           for _ in range(STEPS)]
    final = {k: m.state_dict() for k, m in algo.modules.items()}
    return dict(algorithm=algorithm, args=args_dict, states=states,
                images=images, labels=labels), one, final


def _close_states(ours, theirs, what, atol_params, stats_tol, rtol,
                  counts=True):
    """``counts``: ``num_batches_tracked`` equal too (the JAX package does
    not count)."""
    assert set(ours) == set(theirs), what
    for key, value in theirs.items():
        if key.endswith('num_batches_tracked'):
            if counts:
                assert torch.equal(ours[key], value), what + ' ' + key
            continue
        stat = 'running_' in key
        atol = stats_tol[0] if stat else atol_params
        rtol_k = stats_tol[1] if stat else rtol
        a, b = ours[key].float(), value.float()
        # numpy's test (and its message) only where torch's finds a gap:
        # the same |a - b| <= atol + rtol |b|, faster on 40M parameters
        if not bool(torch.isclose(a, b, rtol=rtol_k, atol=atol).all()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol,
                                       rtol=rtol_k, err_msg=what + ' ' + key)


def _check_against_one_process(ranks, name, one, final, grid, spec=None):
    """The ranks' run ``name`` against one process; ``grid`` (data, spatial)
    sizes; ``spec`` the run's (algorithm, height, arguments), by default
    ``STEP_RUNS[name]``."""
    data, n = grid
    algorithm, h, args = spec or STEP_RUNS[name]
    lbs = args['batch_size'] - args['unlabeled_batch_size']
    for rank, result in enumerate(ranks):
        out = result[name]
        assert out['grid'] == (rank // n, rank % n, data, n)
        assert (out['lbs'], out['n_dev']) == (lbs // data, data)
        assert tuple(out['rows']) == parallel.row_range(h, n, rank % n)
        for s in range(STEPS):
            assert set(out['metrics'][s]) == set(one[s])
            for k, v in one[s].items():
                a = out['metrics'][s][k]
                assert np.isclose(a, v, rtol=ONE_PROCESS_TOLS.get(k, 1e-4),
                                  atol=1e-5), (name, rank, s, k, a, v)
        for key, state in final.items():
            # the flaw detector and D: Adam, whose first update moves each
            # weight whose gradient is 0 up to float32 noise by the lr
            fd = key in ('fd_model', 'd_model')
            _close_states(out['states'][key], state,
                          '{0} {1} rank {2}'.format(name, key, rank),
                          FD_ATOL if fd else PARAM_ATOL.get(algorithm, 1e-5),
                          (FD_ATOL, 1e-4) if fd else STATS_TOL, 1e-4)
    for key in ranks[0][name]['states']:  # the ranks end equal
        for pname, value in ranks[0][name]['states'][key].items():
            for other in ranks[1:]:
                assert torch.equal(value, other[name]['states'][key][pname])


def _check_against_jax(ranks, run, name):
    """The run ``name`` against the JAX package's GSPMD step on a (1 x 2)
    mesh of two devices, run as ``tests/test_spatial_train.py`` runs it:
    every module's state (AdvSSL's D too, whose two Adam updates move a
    weight by at most 2e-4 more where its gradient is float32 noise)."""
    mesh = jax_spatial.make_mesh_2d(2, devices=jax.devices()[:2])
    jargs = jax_harness.default_args(run['algorithm'], **dict(
        run['args'], spatial_train=2))
    jalgo = jax_harness.build_algorithm(jargs, mesh=mesh,
                                        iters_per_epoch=ITERS_PER_EPOCH)
    batch = jax_spatial.shard_train_batch(
        {'inp': (run['images'],), 'gt': (run['labels'],)}, mesh)
    state, history = jalgo.state, []
    for _ in range(STEPS):
        state, metrics = jalgo._train_step(state, batch)
        history.append({k: float(np.asarray(v)) for k, v in metrics.items()})
    final = jax.tree.map(np.asarray, jax.device_get(state))
    for rank, result in enumerate(ranks):
        out = result[name]
        for s in range(STEPS):
            for k, v in history[s].items():
                assert np.isclose(out['metrics'][s][k], v, rtol=2e-3,
                                  atol=1e-6), (name, rank, s, k)
        for key in out['states']:
            _close_states(out['states'][key], from_jax(final[key]),
                          '{0} {1} jax rank {2}'.format(name, key, rank),
                          3e-4, STATS_TOL, 0.0, counts=False)


def _check_gct_blurs(ranks, name='ssl_gct'):
    """Six blurs a step on each rank of the GCT run ``name``, each on the
    rank's strip of rows [r0 - R, r1 + R)."""
    h = ranks[0][name]['height']
    ks = {int(h / 16) | 1, int(h / 8) | 1, int(h / 4) | 1}
    for rank, result in enumerate(ranks):
        lo, hi = parallel.row_range(h, 2, rank)
        for calls in result[name]['blurs']:
            assert len(calls) == 6
            assert {k for _, k in calls} == ks
            for shape, k in calls:
                assert shape[1] == hi - lo + 2 * (k // 2), (shape, k)


def _failures(check, *args):
    """[] where ``check(*args)`` holds, else its message."""
    try:
        check(*args)
    except AssertionError as exc:
        return [str(exc)[:4000]]
    return []


def _release_jax():
    """The JAX programs compiled so far dropped and the heap trimmed: the
    step job builds eight JAX algorithms in one test worker before it
    starts its ranks, and the host's memory is shared with five other
    workers."""
    jax.clear_caches()
    _trim_heap()


def _step_verdicts(root):
    """Every run on a 1 x 2 grid and ``GRID_RUNS`` on a 2 x 2 grid, each
    against one process; ``JAX_RUNS`` against JAX; GCT's blurs."""
    runs, one, final = {}, {}, {}
    for name in STEP_RUNS:
        runs[name], one[name], final[name] = _run(name)
    _release_jax()
    job = dict(kind='steps', n_spatial=2, runs=runs, steps=STEPS,
               iters_per_epoch=ITERS_PER_EPOCH)
    two = _spawn(job, root / 'two', 2)
    four = _spawn(dict(job, runs={name: runs[name] for name in GRID_RUNS}),
                  root / 'four', 4)
    verdicts = {'1x2 ' + name: _failures(
        _check_against_one_process, two, name, one[name], final[name],
        (1, 2)) for name in STEP_RUNS}
    for name in GRID_RUNS:
        verdicts['2x2 ' + name] = _failures(
            _check_against_one_process, four, name, one[name], final[name],
            (2, 2))
    for name in JAX_RUNS:
        verdicts['jax ' + name] = _failures(_check_against_jax, two,
                                            runs[name], name)
    verdicts['gct blurs'] = _failures(_check_gct_blurs, two)
    return verdicts


def _shared(tmp_path_factory, name, make):
    """``make(directory)`` computed once for every pytest-xdist worker of
    the session (under a file lock in the directory they share) and kept
    there with ``torch.save``."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        base = base.parent  # the session's, above each worker's
    path = base / (name + '.pt')
    with open(str(base / (name + '.lock')), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            torch.save(make(tmp_path_factory.mktemp(name)), str(path))
    return torch.load(str(path), weights_only=False)


@pytest.fixture(scope='module')
def step_verdicts(tmp_path_factory):
    return _shared(tmp_path_factory, 'spatial_steps', _step_verdicts)


@pytest.mark.parametrize('name', sorted(STEP_RUNS))
def test_spatial_train_on_two_ranks_matches_one_process(name,
                                                        step_verdicts):
    assert not step_verdicts['1x2 ' + name], step_verdicts['1x2 ' + name]


def test_spatial_train_on_a_2x2_grid_matches_one_process(step_verdicts):
    assert not step_verdicts['2x2 ssl_null'], step_verdicts['2x2 ssl_null']


def test_spatial_train_cutmix_on_a_2x2_grid_matches_one_process(
        step_verdicts):
    """Each data coordinate holds its share of each half of the
    unlabeled block, so that its pairs are the global block's (sample i
    with sample i + U/2), as in one process."""
    assert not step_verdicts['2x2 ssl_cutmix'], \
        step_verdicts['2x2 ssl_cutmix']


def test_spatial_train_suponly_matches_jax_gspmd(step_verdicts):
    assert not step_verdicts['jax ssl_null_jax'], \
        step_verdicts['jax ssl_null_jax']


def test_spatial_train_adv_matches_jax_gspmd(step_verdicts):
    assert not step_verdicts['jax ssl_adv_jax'], \
        step_verdicts['jax ssl_adv_jax']


def test_gct_blurs_six_strips_a_step_on_each_rank(step_verdicts):
    assert not step_verdicts['gct blurs'], step_verdicts['gct blurs']


# ---------------------------------------------------------------------------
# the proxy
# ---------------------------------------------------------------------------

def _script_config(out, sub_path, **overrides):
    cfg = collections.OrderedDict([
        ('exp_id', 'spatial'),
        ('out_path', str(out)),
        ('ssl_algorithm', 'ssl_mt'),
        ('trainset', {'synthetic_sseg': ['synthetic']}),
        ('valset', {'synthetic_sseg': ['synthetic']}),
        ('synthetic_samples', 8),
        ('sublabeled_path', str(sub_path)),
        ('ignore_unlabeled', False),
        ('models', {'model': 'deeplabv2'}),
        ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),
        ('backbone', 'resnet10'),
        ('im_size', 40),
        ('num_classes', NUM_CLASSES),
        ('batch_size', 2),
        ('unlabeled_batch_size', 1),
        ('epochs', 1),
        ('log_freq', 1),
        ('bf16', False),
        ('lr', 5e-5), ('momentum', 0.9), ('weight_decay', 5e-4),
        ('cons_for_labeled', False), ('cons_scale', 1.0),
        ('cons_rampup_epochs', 3), ('ema_decay', 0.99),
        ('gaussian_noise_std', 0.1),
        ('num_workers', 0),
        ('seed', 5),
    ])
    cfg.update(overrides)
    return cfg


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_records(two, one):
    """Every ``metrics.jsonl`` record of a run on two ranks against one
    process's: the consistency rtol 2e-2, the other losses and the lr
    2e-3, the scores atol 1e-3."""
    assert [r['phase'] for r in two] == [r['phase'] for r in one]
    for ours, theirs in zip(two, one):
        for key, value in theirs.items():
            if key == 'cons_loss':
                rtol, atol = 2e-2, 1e-9
            elif 'loss' in key or key == 'lr':
                rtol, atol = 2e-3, 1e-6
            elif 'metric' in key:
                rtol, atol = 0.0, 1e-3
            else:
                continue
            assert np.isclose(ours[key], value, rtol=rtol, atol=atol), (
                ours['phase'], key, ours[key], value)


def _sub(tmp_path):
    sub = tmp_path / 'sub.txt'
    sub.write_text(''.join('synthetic_{0:05d}\n'.format(i)
                           for i in range(0, 8, 2)))
    return sub


def test_spatial_train_script_trains_and_validates_like_one_process(
        tmp_path):
    """``run_script`` at batch 1+1 on two spatial ranks (data axis 1: no
    scaling) against one process at the same config, MT with its input
    noise on: every train record, and the validation of whole samples;
    then each rank's validation of the trained weights equals one
    process's validation of them."""
    sub = _sub(tmp_path)
    one = pixelssl_tpu_torch.run_script(
        _script_config(tmp_path / 'one', sub), sseg,
        sseg.SemanticSegmentationProxy, device='cpu', cli_override=False)
    one_records = _records(tmp_path / 'one' / 'spatial' / 'metrics.jsonl')
    config = _script_config(tmp_path / 'two', sub, distributed=True,
                            spatial_train=2)
    ranks = _spawn(dict(kind='script', config=config), tmp_path / 'run', 2)
    _check_records(_records(tmp_path / 'two' / 'spatial' / 'metrics.jsonl'),
                   one_records)
    for out in ranks:
        assert out['n_devices'] == 1 and out['batch_size'] == 2
        assert (out['lbs'], out['ubs']) == (1, 1)
        assert np.isclose(out['lr'], 5e-5)
        assert out['val_len'] == 8 and out['step'] == len(one.train_loader)
    # the trained weights scored in one process: the ranks' validation
    algo = one.ssl_algorithm
    for key, module in algo.modules.items():
        module.load_state_dict(ranks[0]['states'][key])
    algo.validate(one.val_loader, 0)
    for key, meter in algo.meters.items():
        if 'metric' in key or key.endswith('_loss'):
            for out in ranks:
                assert np.isclose(out['meters'][key], meter.avg,
                                  rtol=1e-6), key
    for run in ('one', 'two'):
        shutil.rmtree(str(tmp_path / run))


def _jax_spatial_val(root, sub):
    """The JAX package's ``--validation --spatial-val`` of SupOnly on a
    2-device mesh from its initial weights: (its val record, the weights
    as the port's state dict)."""
    jconfig = _script_config(root / 'jax', sub, ssl_algorithm='ssl_null',
                             unlabeled_batch_size=0, ignore_unlabeled=True,
                             sublabeled_path='', validation=True,
                             spatial_val=True, im_size=48)
    parser = jax_runner.create_parser('ssl_null')
    jax_sseg.add_parser_arguments(parser)
    jargs = jax_cmd.parse_args(parser, jconfig, cli_override=False)
    jproxy = jax_sseg.SemanticSegmentationProxy(
        jargs, mesh=jax_parallel.make_mesh(2))
    initial = jax.tree.map(np.asarray,
                           jax.device_get(jproxy.ssl_algorithm.state))
    jproxy.run()
    (record, ) = _records(root / 'jax' / 'spatial' / 'metrics.jsonl')
    return record, from_jax(initial['model'])


def test_spatial_val_matches_one_process_and_jax(tmp_path):
    sub = _sub(tmp_path)
    theirs, state = _jax_spatial_val(tmp_path, sub)
    config = _script_config(tmp_path / 'port', sub, ssl_algorithm='ssl_null',
                            unlabeled_batch_size=0, ignore_unlabeled=True,
                            sublabeled_path='', validation=True, im_size=48)
    args = harness.default_args('ssl_null', **{
        k: v for k, v in config.items() if k != 'ssl_algorithm'})
    algo = harness.build_algorithm(args, device='cpu')
    algo.modules['model'].load_state_dict(state)
    ckpt = algo.save_checkpoint(0, path=str(tmp_path / 'from_jax.pth'))
    config['resume'] = ckpt
    one = pixelssl_tpu_torch.run_script(
        dict(config, out_path=str(tmp_path / 'one')), sseg,
        sseg.SemanticSegmentationProxy, device='cpu', cli_override=False)
    one_scores = {k: m.avg for k, m in one.ssl_algorithm.meters.items()
                  if 'metric' in k or k.endswith('_loss')}
    ranks = _spawn(dict(kind='script', config=dict(
        config, spatial_val=True, distributed=True)), tmp_path / 'run', 2)
    assert set(one_scores) == set(k for k in theirs if 'metric' in k or
                                  k.endswith('_loss'))
    for out in ranks:
        assert out['val_len'] == 8 and out['n_devices'] == 2
        assert set(out['meters']) == set(one_scores)
        for key, value in one_scores.items():
            if key.endswith('_loss'):
                assert np.isclose(out['meters'][key], value, rtol=1e-6), key
            else:
                assert abs(out['meters'][key] - value) <= SCORE_ATOL, key
            if key.endswith('_loss'):
                assert np.isclose(out['meters'][key], theirs[key],
                                  rtol=2e-3), key
            else:
                assert abs(out['meters'][key] - theirs[key]) <= 1e-3, key
    shutil.rmtree(str(tmp_path / 'jax'), ignore_errors=True)


# ``--visualize`` under the two flags: the algorithm's own keys on top of
# ``_script_config``; GCT at 96 px (at 64 px and less its flawmap is flat)
VISUAL_RUNS = {
    'ssl_gct': dict(ssl_algorithm='ssl_gct', im_size=96, ssl_mode='gct',
                    fc_ssl_scale=1.0, dc_ssl_scale=1.0, dc_threshold=0.5,
                    dc_rampup_epochs=1, fd_lr=1e-4, fd_scale=10.0, mu=0.5,
                    nu=1),
    'ssl_adv': dict(ssl_algorithm='ssl_adv', adv_for_labeled=True,
                    labeled_adv_scale=0.01, unlabeled_adv_scale=0.001),
}
VISUAL_VAL = dict(ssl_algorithm='ssl_null', unlabeled_batch_size=0,
                  ignore_unlabeled=True, sublabeled_path='', validation=True,
                  im_size=48, spatial_val=True, visual_freq=2)
# the model's maps of two ranks against one process's, after a step (the
# train folder) or a run (val): a prediction or pseudo-GT pixel whose two
# best classes tie to float32 noise may take the other colour, as in
# ``tests/test_torch_visualize.py`` (under 1% of the pixels there); a
# gray map (flawmap, its ground truth, D's confidence) within a level
COLOUR_SAME = 0.99
GRAY_LEVELS = 1


def _visual_pngs(root, exp_id='spatial'):
    """{folder/name: (file bytes, pixels)} of the PNGs a run of ``exp_id``
    wrote under ``root``."""
    base = os.path.join(str(root), exp_id, 'visualization')
    out = {}
    for sub in ('debug', 'train', 'val'):
        for name in sorted(os.listdir(os.path.join(base, sub))):
            path = os.path.join(base, sub, name)
            with open(path, 'rb') as f:
                out[sub + '/' + name] = (f.read(), imageio.read_png(path))
    return out


def _visual_runs(root):
    """``--visualize`` in one process and on two ranks, on 4 synthetic
    samples (2 labeled): GCT and AdvSSL under ``--spatial-train 2`` (2
    iterations, the first visualized, then the validation's first batch),
    SupOnly's ``--validation --spatial-val``; the PNGs of each and the
    blur calls of each rank's visualizations."""
    sub = root / 'sub.txt'
    sub.write_text('synthetic_00000\nsynthetic_00002\n')
    out = {}
    for name, extra in list(VISUAL_RUNS.items()) + [('val', VISUAL_VAL)]:
        config = _script_config(root / name / 'one', sub, **dict(
            dict(visualize=True, visual_freq=100, synthetic_samples=4),
            **extra))
        pixelssl_tpu_torch.run_script(
            config, sseg, sseg.SemanticSegmentationProxy, device='cpu',
            cli_override=False)
        flags = dict(distributed=True) if name == 'val' else dict(
            distributed=True, spatial_train=2)
        ranks = _spawn(dict(kind='script', config=dict(
            config, out_path=str(root / name / 'two'), **flags)),
            root / name / 'run', 2)
        out[name] = {'one': _visual_pngs(root / name / 'one'),
                     'two': _visual_pngs(root / name / 'two'),
                     'blurs': [r['visual_blurs'] for r in ranks]}
        shutil.rmtree(str(root / name))
    return out


@pytest.fixture(scope='module')
def visual_runs(tmp_path_factory):
    return _shared(tmp_path_factory, 'spatial_visual', _visual_runs)


def _check_pngs(two, one):
    """Two ranks' PNGs against one process's: the same names and sizes,
    the input and GT byte for byte, the model's maps within
    ``COLOUR_SAME`` / ``GRAY_LEVELS``."""
    assert sorted(two) == sorted(one)
    for name, (data, px) in one.items():
        got_data, got = two[name]
        assert got.shape == px.shape, name
        if name.endswith(('1-inp.png', '3-gt.png')):
            assert got_data == data, name
        elif px.ndim == 3:
            same = float((got == px).all(axis=-1).mean())
            assert same >= COLOUR_SAME, (name, same)
        else:
            gap = int(np.abs(got.astype(int) - px).max())
            assert gap <= GRAY_LEVELS, (name, gap)


@pytest.mark.parametrize('name', sorted(VISUAL_RUNS))
def test_spatial_train_visualize_writes_one_process_pngs(name, visual_runs):
    """``--distributed --spatial-train 2 --visualize``: rank 0 writes the
    PNGs that one process writes, from the rows its spatial group
    gathers, the debug maps (GCT's flawmaps and pseudo-GT, D's
    confidence) among them."""
    run = visual_runs[name]
    _check_pngs(run['two'], run['one'])
    names = ' '.join(run['one'])
    for token in ('train/0_0_', 'val/0_0_', '1-inp', '2-pred', '3-gt',
                  'pseudo-gt' if name == 'ssl_gct' else 'labeled-cmap'):
        assert token in names, token


def test_spatial_train_gct_visualize_blurs_six_strips_on_each_rank(
        visual_runs):
    """A visualized GCT step blurs 6 times on each rank, each on its strip
    of the 96-row maps ([r0 - R, r1 + R) rows)."""
    h = VISUAL_RUNS['ssl_gct']['im_size']
    ks = {int(h / 16) | 1, int(h / 8) | 1, int(h / 4) | 1}
    for rank, visualized in enumerate(visual_runs['ssl_gct']['blurs']):
        lo, hi = parallel.row_range(h, 2, rank)
        assert len(visualized) == 1
        for calls in visualized:
            assert len(calls) == 6 and {k for _, k in calls} == ks
            for shape, k in calls:
                assert shape[1] == hi - lo + 2 * (k // 2), (shape, k)


def test_spatial_val_visualize_writes_one_process_pngs(visual_runs):
    """``--validation --spatial-val --visualize`` on two ranks: rank 0
    writes one process's PNGs of the padded sample (48 px padded to the
    64-px bucket), its rows gathered from both ranks."""
    run = visual_runs['val']
    _check_pngs(run['two'], run['one'])
    assert sorted(run['one']) and all(n.startswith('val/')
                                      for n in run['one'])
    for name, (_, px) in run['one'].items():
        assert px.shape[:2] == (64, 64), name


REFUSALS = [
    (dict(spatial_train=2, spatial_val=True, distributed=True),
     'mutually exclusive'),
    (dict(spatial_train=2), 'launch with torchrun'),
]


@pytest.mark.parametrize('overrides,message', REFUSALS,
                         ids=['both', 'no-distributed'])
def test_spatial_refusals(overrides, message, tmp_path):
    config = _script_config(tmp_path, _sub(tmp_path), **overrides)
    with pytest.raises(logger.FatalError) as err:
        pixelssl_tpu_torch.run_script(config, sseg,
                                      sseg.SemanticSegmentationProxy,
                                      device='cpu', cli_override=False)
    assert message in str(err.value)
    assert not torch.distributed.is_initialized()


def test_spatial_train_refusals_of_the_harness_and_the_ranks():
    """``harness.build_algorithm`` refuses an N that does not divide the
    ranks as the JAX package does."""
    args = harness.default_args('ssl_null', backbone='resnet10', im_size=32,
                                num_classes=NUM_CLASSES, spatial_train=2,
                                lr=1e-3)
    with pytest.raises(ValueError) as err:
        harness.build_algorithm(args, device='cpu')
    assert 'must divide the device count 1' in str(err.value)


def test_spatial_spread_tool_reports_the_gaps(capsys):
    """``tools/spatial_spread.py`` at a small size: two spatial ranks'
    first step within float32 noise of one process's."""
    from pixelssl_tpu_torch.tools import spatial_spread
    spatial_spread.main(['--algorithm', 'ssl_null', '--im-size', '33',
                         '--steps', '1', '--threads', '1'])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['against'] == 'one process, 1 threads'
    gaps = out['gaps']['2 spatial ranks']
    assert len(gaps['steps']) == 1
    assert gaps['steps'][0]['loss'] < 1e-5 and gaps['param'] < 1e-5
    assert gaps['stat'] < 1e-4
