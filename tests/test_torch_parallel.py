"""The port's data parallelism over processes (``pixelssl_tpu_torch.parallel``,
``--distributed``) against one process and against the JAX package's
mesh.

The numpy helpers (``reorder_two_stream``, ``process_batch_indices``,
``ProcessShardedSampler``) equal the JAX functions on the same inputs.
``initialize`` is a no-op without ``--distributed`` and stops at once with
it and no ``torchrun`` environment.

Two ranks over gloo run as two processes of ``tests/_torch_dist_worker.py``
(each with a timeout of ``TIMEOUT`` s; a failing rank fails the test),
each on its labeled-first half of a global batch. SupOnly, MT and GCT take
two steps from the JAX package's initial weights (``from_jax``; no draws
in these configs: MT without input noise), and their losses and updated
parameters must equal

* the port on one process with the global batch (and GCT's ``--fd-lr``
  times two: the reference scales the flaw detector's lr by the GPU
  count, ssl_gct.py:107): rtol 1e-4, atol 1e-5 on the losses, the
  parameters and the BN running statistics (the ranks sum the same
  numbers in another order, and the synced BN takes the batch variance as
  E[x^2] - E[x]^2 where one process's BatchNorm does not); GCT's fc/dc
  and MT's ``cons_loss`` rtol 2e-2, as against JAX, for the same
  thresholds;
* the JAX package on ``parallel.make_mesh(2)`` with the same global batch,
  run as ``tests/test_mesh_invariance.py`` runs it, with the tolerances of
  the one-device parity tests (``tests/test_torch_mt.py``,
  ``tests/test_torch_gct.py``): rtol 2e-3 on task/FD losses and the lr,
  2e-2 on GCT's thresholded fc/dc and MT's ``cons_loss``; parameters atol
  3e-4, BN statistics atol 1e-4 with rtol 1e-4. The flaw detector's
  parameters and statistics take atol 1e-3 against both (``FD_ATOL``: its
  Adam moves a bias whose gradient is 0 up to noise by the lr either
  way, and the BN means after it move with it).

GCT runs at 96 px, not 32: below that the flaw detector's map collapses
and its min-max normalisation turns last-ulp noise into mask flips
(``tests/test_torch_gct.py``). Validation on two ranks equals one
process's (scores and losses rtol 1e-6), with and without a padded tail;
and ``run_script`` with ``--distributed`` trains like one process on the
global batch, writes its checkpoint from rank 0 alone, and every rank
resumes from it.
"""

import collections
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

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel as jax_parallel
from pixelssl_tpu.parallel import multihost as jax_multihost

import pixelssl_tpu_torch
from pixelssl_tpu_torch import harness, parallel
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.parallel import multihost
from pixelssl_tpu_torch.task_template.proxy import _ValLoader
from pixelssl_tpu_torch.tasks import sseg
from pixelssl_tpu_torch.utils import logger

from test_torch_mt import one_torch_thread  # noqa: F401

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '_torch_dist_worker.py')
TIMEOUT = 120
WORLD = 2
NUM_CLASSES = 5
STEPS = 2
ITERS_PER_EPOCH = 10


# ---------------------------------------------------------------------------
# the numpy helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('lbs,ubs,n_dev', [(4, 4, 2), (6, 2, 2), (8, 4, 4),
                                           (3, 0, 3)])
def test_reorder_two_stream_matches_jax(lbs, ubs, n_dev):
    rng = np.random.default_rng(lbs * 10 + ubs)
    arr = rng.standard_normal((lbs + ubs, 3, 2)).astype(np.float32)
    steps = rng.standard_normal((3, lbs + ubs, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        parallel.reorder_two_stream(arr, lbs, ubs, n_dev),
        jax_parallel.reorder_two_stream(arr, lbs, ubs, n_dev))
    np.testing.assert_array_equal(
        parallel.reorder_two_stream_steps(steps, lbs, ubs, n_dev),
        jax_parallel.reorder_two_stream_steps(steps, lbs, ubs, n_dev))


def test_process_batch_indices_and_sampler_match_jax():
    class Sampler(object):
        def __init__(self):
            self.batches = [list(range(b * 12, b * 12 + 12))
                            for b in range(3)]

        def __len__(self):
            return len(self.batches)

        def __iter__(self):
            return iter(self.batches)

    lbs, ubs, n_dev = 8, 4, 4
    for positions in ([0], [3], [1, 2], [0, 1, 2, 3]):
        for batch in Sampler():
            assert multihost.process_batch_indices(
                batch, lbs, ubs, positions, n_dev) == \
                jax_multihost.process_batch_indices(
                    batch, lbs, ubs, positions, n_dev)
        ours = multihost.ProcessShardedSampler(Sampler(), lbs, ubs,
                                               positions, n_dev)
        theirs = jax_multihost.ProcessShardedSampler(Sampler(), lbs, ubs,
                                                     positions, n_dev)
        assert len(ours) == len(theirs) == 3
        assert list(ours) == list(theirs)
    # one rank's slice of the two streams is its block of the reorder
    batch = np.arange(lbs + ubs)
    blocks = parallel.reorder_two_stream(batch, lbs, ubs, n_dev).reshape(
        n_dev, -1)
    mesh = parallel.Mesh(rank=2, world_size=n_dev)
    assert multihost.process_batch_indices(
        list(batch), lbs, ubs, multihost.local_device_positions(mesh),
        n_dev) == list(blocks[2])


def test_initialize_is_a_noop_without_distributed(monkeypatch):
    for name in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    args = harness.default_args('ssl_null')
    assert not args.distributed
    assert multihost.initialize(args, 'cpu') == torch.device('cpu')
    assert multihost.initialize(None, 'cpu') == torch.device('cpu')
    assert not torch.distributed.is_initialized()
    mesh = parallel.make_mesh('cpu')
    assert (mesh.rank, mesh.world_size, mesh.distributed) == (0, 1, False)
    assert not multihost.is_multihost()


def test_initialize_fails_fast_without_environment(monkeypatch, tmp_path):
    for name in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    args = harness.default_args('ssl_null', distributed=True)
    with pytest.raises(logger.FatalError) as err:
        multihost.initialize(args, 'cpu')
    assert 'torchrun' in str(err.value) and 'RANK' in str(err.value)
    assert not torch.distributed.is_initialized()
    # through the script path too: before any dataset or model is built
    sub = tmp_path / 'sub.txt'
    sub.write_text('synthetic_00000\n')
    with pytest.raises(logger.FatalError) as err:
        pixelssl_tpu_torch.run_script(
            _script_config(tmp_path, sub, distributed=True), sseg,
            sseg.SemanticSegmentationProxy, device='cpu', cli_override=False)
    assert 'torchrun' in str(err.value)


# ---------------------------------------------------------------------------
# two ranks over gloo
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawn(job, tmp_path):
    """Run ``job`` on ``WORLD`` worker processes; returns each rank's
    output. A rank that fails or outlives ``TIMEOUT`` fails the test."""
    job_path = str(tmp_path / 'job.pt')
    torch.save(dict(job, world=WORLD, port=_free_port()), job_path)
    env = dict(os.environ, OMP_NUM_THREADS='1')
    outs = [str(tmp_path / 'out{0}.pt'.format(r)) for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, job_path, str(r),
                               outs[r]], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    deadline = time.time() + TIMEOUT
    logs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(
                timeout=max(1.0, deadline - time.time()))
            logs.append(out.decode(errors='replace'))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, 'rank {0} failed:\n{1}'.format(
            rank, log[-4000:])
    results = [torch.load(path, weights_only=False) for path in outs]
    for path in [job_path] + outs:  # weights: hundreds of MB a test
        os.remove(path)
    return results


STEP_CASES = {
    'ssl_null': (32, dict(batch_size=4, unlabeled_batch_size=0)),
    'ssl_mt': (32, dict(batch_size=4, unlabeled_batch_size=2,
                        ignore_unlabeled=False, cons_for_labeled=True,
                        cons_scale=1.0, cons_rampup_epochs=1,
                        ema_decay=0.99, gaussian_noise_std=None)),
    'ssl_gct': (96, dict(batch_size=4, unlabeled_batch_size=2,
                         ignore_unlabeled=False, ssl_mode='gct',
                         fc_ssl_scale=2.0, dc_ssl_scale=1.5,
                         dc_threshold=0.5, dc_rampup_epochs=1, fd_lr=1e-4,
                         fd_scale=10.0, mu=0.5, nu=1)),
}
# Adam's first updates are lr * sign(g): the flaw detector's conv biases
# before its norms have a gradient of 0 up to float32 noise and move by the
# lr, 2e-4 here, either way on each of the two steps; its BN running means
# move with them
FD_ATOL = 1e-3
JAX_TOLS = {'cons_loss': 2e-2, 'l_fc_loss': 2e-2, 'r_fc_loss': 2e-2,
            'l_dc_loss': 2e-2, 'r_dc_loss': 2e-2}


def _step_args(algo_name):
    im, extra = STEP_CASES[algo_name]
    return dict(backbone='resnet10', im_size=im, num_classes=NUM_CLASSES,
                bf16=False, lr=5e-5, momentum=0.9, weight_decay=5e-4,
                power=0.9, epochs=20, **extra)


def _global_batch(args_dict, rng):
    n, im = args_dict['batch_size'], args_dict['im_size']
    lbs = n - args_dict['unlabeled_batch_size']
    images = rng.standard_normal((n, im, im, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (n, im, im)).astype(np.int32)
    labels[:lbs, :4, :4] = 255
    labels[lbs:] = -1
    return images, labels, lbs


def _jax_steps(algo_name, args_dict, images, labels, lbs):
    """The JAX package on a 2-device mesh: its initial state (numpy), each
    step's metrics and the final state."""
    ubs = args_dict['unlabeled_batch_size']
    mesh = jax_parallel.make_mesh(WORLD)
    jargs = jax_harness.default_args(algo_name, **args_dict)
    jalgo = jax_harness.build_algorithm(jargs, mesh=mesh,
                                        iters_per_epoch=ITERS_PER_EPOCH)
    initial = jax.tree.map(np.asarray, jax.device_get(jalgo.state))
    img, gt = images, labels
    if ubs > 0:
        img = jax_parallel.reorder_two_stream(img, lbs, ubs, WORLD)
        gt = jax_parallel.reorder_two_stream(gt, lbs, ubs, WORLD)
    jbatch = jax_parallel.shard_batch({'inp': (img,), 'gt': (gt,)}, mesh)
    jstate, history = jalgo.state, []
    for _ in range(STEPS):
        jstate, metrics = jalgo._train_step(jstate, jbatch)
        history.append({k: float(np.asarray(v)) for k, v in metrics.items()})
    return initial, history, jax.tree.map(np.asarray,
                                          jax.device_get(jstate))


def _close_states(ours, theirs, what, atol_params, atol_stats, rtol_params):
    assert set(ours) == set(theirs), what
    for key, value in theirs.items():
        if key.endswith('num_batches_tracked'):
            continue
        stat = 'running_' in key
        np.testing.assert_allclose(
            ours[key].float().numpy(), value.float().numpy(),
            atol=atol_stats if stat else atol_params,
            rtol=1e-4 if stat else rtol_params, err_msg=what + ' ' + key)


@pytest.mark.parametrize('algo_name', sorted(STEP_CASES))
def test_two_ranks_match_one_process_and_jax(algo_name, tmp_path):
    args_dict = _step_args(algo_name)
    images, labels, lbs = _global_batch(args_dict, np.random.default_rng(7))
    initial, jax_history, jax_final = _jax_steps(algo_name, args_dict,
                                                 images, labels, lbs)

    # the flaw detector's lr is ``--fd-lr`` times the ranks (reference
    # ssl_gct.py:107), which one process with the global batch must be
    # given by hand
    one_dict = dict(args_dict)
    if 'fd_lr' in one_dict:
        one_dict['fd_lr'] = one_dict['fd_lr'] * WORLD
    args = harness.default_args(algo_name, **one_dict)
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS_PER_EPOCH)
    states = {key: from_jax(initial[key]) for key in algo.modules}
    for key, module in algo.modules.items():
        module.load_state_dict(states[key])
    batch = harness._to_batch(images, labels, 'cpu')
    one = [{k: float(v) for k, v in algo.train_step(batch).items()}
           for _ in range(STEPS)]

    ranks = _spawn(dict(kind='steps', algorithm=algo_name, args=args_dict,
                        states=states, images=images, labels=labels,
                        lbs=lbs, ubs=args_dict['unlabeled_batch_size'],
                        steps=STEPS, iters_per_epoch=ITERS_PER_EPOCH),
                   tmp_path)
    ubs = args_dict['unlabeled_batch_size']
    for rank, out in enumerate(ranks):
        assert (out['lbs'], out['ubs'], out['n_dev']) == (
            lbs // WORLD, ubs // WORLD, WORLD)
        for s in range(STEPS):
            assert set(out['metrics'][s]) == set(one[s])
            for k, v in one[s].items():
                a = out['metrics'][s][k]
                rtol = JAX_TOLS.get(k, 1e-4)
                assert np.isclose(a, v, rtol=rtol, atol=1e-5), (
                    'rank', rank, 'step', s, k, a, v)
                b = jax_history[s][k]
                rtol = JAX_TOLS.get(k, 2e-3)
                assert np.isclose(a, b, rtol=rtol, atol=1e-6), (
                    'jax', rank, s, k, a, b)
        for key, module in algo.modules.items():
            fd = key == 'fd_model'
            _close_states(out['states'][key], module.state_dict(),
                          '{0} rank {1}'.format(key, rank),
                          FD_ATOL if fd else 1e-5, FD_ATOL if fd else 1e-5,
                          1e-4)
            _close_states(out['states'][key], from_jax(jax_final[key]),
                          'jax {0} rank {1}'.format(key, rank),
                          FD_ATOL if fd else 3e-4, FD_ATOL if fd else 1e-4,
                          0.0)
    # the ranks end equal
    for key in ranks[0]['states']:
        for name, value in ranks[0]['states'][key].items():
            assert torch.equal(value, ranks[1]['states'][key][name]), name


class _List(object):
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


@pytest.mark.parametrize('n_samples', [4, 5])
def test_distributed_validation_matches_one_process(n_samples, tmp_path):
    """Two ranks score samples b*2 + r; with 5 samples rank 1's third
    batch is an all-ignore copy with ``valid`` 0. The scores equal one
    process's; the loss is the mean over batches of each 2-sample batch's
    valid mean (the JAX package's arithmetic), which for 4 samples is one
    process's mean. ``exact`` is replicated: each rank scores every sample
    and equals one process."""
    args_dict = dict(_step_args('ssl_mt'), im_size=40)
    rng = np.random.default_rng(3)
    samples = []
    for i in range(n_samples):
        samples.append(((rng.standard_normal((40, 40, 3)).astype(
            np.float32),), (rng.integers(0, NUM_CLASSES, (40, 40)).astype(
                np.int32),)))
    args = harness.default_args('ssl_mt', **args_dict)
    algo = harness.build_algorithm(args, device='cpu')
    states = {k: m.state_dict() for k, m in algo.modules.items()}
    one = {}
    for exact in (False, True):
        results = algo.validate(_ValLoader(_List(samples), 'cpu',
                                           exact=exact), 0)
        losses = {k: m.avg for k, m in algo.meters.items()
                  if k.endswith('_loss')}
        one['exact' if exact else 'bucketed'] = dict(results, **losses)

    ranks = _spawn(dict(kind='validate', algorithm='ssl_mt',
                        args=args_dict, states=states, samples=samples),
                   tmp_path)
    for out in ranks:
        for mode in ('bucketed', 'exact'):
            assert set(out[mode]) == set(one[mode])
            for key, value in one[mode].items():
                if mode == 'bucketed' and key.endswith('_loss') and \
                        n_samples % WORLD:
                    continue
                assert np.isclose(out[mode][key], value, rtol=1e-6,
                                  atol=1e-7), (mode, key)
    if n_samples % WORLD:
        # the per-batch arithmetic by hand from one process's per-sample
        # losses
        for model_id in ('student', 'teacher'):
            key = model_id + '_loss'
            losses = _per_sample_losses(algo, samples, model_id)
            batches = [losses[b:b + WORLD]
                       for b in range(0, n_samples, WORLD)]
            expected = np.mean([np.mean(b) for b in batches])
            for out in ranks:
                assert np.isclose(out['bucketed'][key], expected,
                                  rtol=1e-6), key


def _per_sample_losses(algo, samples, model_id):
    """``model_id``'s val loss of each sample alone (one process)."""
    losses = []
    for sample in samples:
        algo.validate(_ValLoader(_List([sample]), 'cpu'), 0)
        losses.append(algo.meters[model_id + '_loss'].avg)
    return losses


def _script_config(out, sub_path, **overrides):
    cfg = collections.OrderedDict([
        ('exp_id', 'dist'),
        ('out_path', str(out)),
        ('ssl_algorithm', 'ssl_mt'),
        ('trainset', {'synthetic_sseg': ['synthetic']}),
        ('valset', {'synthetic_sseg': ['synthetic']}),
        ('synthetic_samples', 16),
        ('sublabeled_path', str(sub_path)),
        ('ignore_unlabeled', False),
        ('models', {'model': 'deeplabv2'}),
        ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),
        ('backbone', 'resnet10'),
        ('im_size', 32),
        ('num_classes', NUM_CLASSES),
        ('batch_size', 4),
        ('unlabeled_batch_size', 2),
        ('epochs', 1),
        ('log_freq', 1),
        ('bf16', False),
        ('lr', 5e-5), ('momentum', 0.9), ('weight_decay', 5e-4),
        ('cons_for_labeled', False), ('cons_scale', 1.0),
        ('cons_rampup_epochs', 3), ('ema_decay', 0.99),
        ('gaussian_noise_std', -1.0),
        ('num_workers', 0),
        ('seed', 5),
    ])
    cfg.update(overrides)
    return cfg


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_distributed_script_checkpoints_on_rank0_and_resumes(tmp_path):
    """``run_script`` with ``--distributed`` on two ranks at batch 1+1 a
    rank against one process at 2+2 and twice the lr: every train record
    and the validation within the tolerances of
    ``tests/test_torch_proxy.py`` (rtol 2e-3 on the losses and the lr, 2e-2
    with atol 1e-9 on ``cons_loss``, atol 1e-3 on the scores: over four
    steps the toy's loss rises and float32 noise grows with it); the batch
    and lr scaled by the ranks; rank 0 alone saves the checkpoint; both
    ranks resume from it to the same weights and step."""
    sub = tmp_path / 'sub.txt'
    sub.write_text(''.join('synthetic_{0:05d}\n'.format(i)
                           for i in range(0, 16, 2)))
    one = pixelssl_tpu_torch.run_script(
        _script_config(tmp_path / 'one', sub, lr=1e-4), sseg,
        sseg.SemanticSegmentationProxy, device='cpu', cli_override=False)
    one_records = _records(tmp_path / 'one' / 'dist' / 'metrics.jsonl')

    config = _script_config(tmp_path / 'two', sub, distributed=True,
                            batch_size=2, unlabeled_batch_size=1)
    ranks = _spawn(dict(kind='script', config=config), tmp_path)
    records = _records(tmp_path / 'two' / 'dist' / 'metrics.jsonl')
    # the first run's records, then the resumed validation's
    assert [r['phase'] for r in records] == \
        [r['phase'] for r in one_records] + ['val']
    for ours, theirs in zip(records, one_records):
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
    # the resumed validation scores the saved weights as the run did
    for key, value in records[-2].items():
        if 'metric' in key or key.endswith('_loss'):
            assert np.isclose(records[-1][key], value, rtol=1e-6), key

    assert [os.path.basename(p) for p in ranks[0]['saves']] == \
        ['checkpoint_1.pth.tmp']
    assert ranks[1]['saves'] == []
    for out in ranks:
        assert out['n_devices'] == WORLD
        assert out['batch_size'] == 4 and (out['lbs'], out['ubs']) == (1, 1)
        assert np.isclose(out['lr'], 1e-4)
        assert out['val_len'] == 8  # 16 samples, 8 a rank
        assert out['step'] == out['resumed_step'] == len(one.train_loader)
        # every tensor of every module: the file's, the trained run's and
        # the resumed run's equal
        assert out['resumed_equal'] == {'saved': True, 'trained': True}
    for run in ('one', 'two'):  # checkpoints: hundreds of MB
        shutil.rmtree(str(tmp_path / run))
