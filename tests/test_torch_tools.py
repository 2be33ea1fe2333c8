"""The port's serving and benchmark entry points on the CPU, tiny:

* ``tools/export_serving.py``: a SupOnly DeepLab-v2 (ResNet-10, 65 px)
  with the JAX package's initial weights (``from_jax``) through a port
  checkpoint, exported in float32 (``--bf16 0``), saved as ``.pt2``; the
  tool's own round trip holds (atol 5e-3, rtol 2e-2), and the loaded
  artifact's output matches the JAX package's eval forward of the same
  weights within atol 1e-4 (float32, sums in another order);
* ``tools/infer_bench.py --cpu``: its JSON line with the JAX tool's keys;
* ``bench.py --cpu --steps 2 --calls 1``: the step-counter guard, a
  finite loss, and every key of its JSON line (no ``mfu_bf16`` on a card
  outside its peak table, the CPU here); its ``snapshot``/``restore`` in
  place and its reading of ``nvidia-smi``'s clock samples.
"""

import contextlib
import io
import json
import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel

from pixelssl_tpu_torch import bench, harness
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.tools import export_serving, infer_bench

from test_torch_mt import one_torch_thread  # noqa: F401

SMALL = dict(backbone='resnet10', im_size=65, num_classes=5, batch_size=2,
             unlabeled_batch_size=0, ignore_unlabeled=True, lr=0.01,
             momentum=0.9, epochs=1, bf16=False, seed=3)


def _json_line(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_export_serving_round_trip_matches_jax(tmp_path):
    jalgo = jax_harness.build_algorithm(
        jax_harness.default_args('ssl_null', **SMALL),
        mesh=parallel.make_mesh(1))
    variables = jax.tree.map(np.asarray, jax.device_get(
        {k: jalgo.state['model'][k] for k in ('params', 'batch_stats')}))
    algo = harness.build_algorithm(
        harness.default_args('ssl_null', **SMALL), device='cpu')
    algo.model.load_state_dict(from_jax(dict(variables)))
    ckpt = algo.save_checkpoint(0, path=str(tmp_path / 'null.pth'))

    out = str(tmp_path / 'model.pt2')
    assert export_serving.main([
        '--ckpt', ckpt, '--algo', 'ssl_null', '--backbone', 'resnet10',
        '--im-size', '65', '--num-classes', '5', '--batch', '2',
        '--bf16', '0', '--out', out, '--cpu']) == 0

    x = np.random.default_rng(0).standard_normal(
        (2, 3, 65, 65)).astype(np.float32)
    with torch.no_grad():
        ours = torch.export.load(out).module()(torch.from_numpy(x)).numpy()
    resulter, _ = jalgo.model.apply(
        variables, (jnp.asarray(x.transpose(0, 2, 3, 1)),), train=False)
    theirs = np.asarray(resulter['activated_pred'][0]).transpose(0, 3, 1, 2)
    assert ours.shape == (2, 5, 65, 65)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


def test_infer_bench_cpu_prints_its_keys():
    record = _json_line(infer_bench.main, [
        '--cpu', '--backbone', 'resnet10', '--im-size', '64', '--batch', '2',
        '--num-classes', '5', '--scan', '2', '--calls', '1'])
    for key in ('model', 'backbone', 'im_size', 'batch_per_chip',
                'output_stride', 'bf16', 'images_per_sec_per_chip',
                'latency_ms_per_batch', 'compile_plus_first_dispatch_s'):
        assert key in record, key
    assert record['device'] == 'cpu'
    assert record['images_per_sec_per_chip'] > 0
    assert math.isclose(record['latency_ms_per_batch'],
                        1000.0 * 2 / record['images_per_sec_per_chip'])


def test_bench_cpu_guards_and_keys(monkeypatch):
    seen = {}
    original = bench.measure

    def measure(algo, batch, loss_key, opts, timer, what, clocks=None):
        first = algo.state.step
        out = original(algo, batch, loss_key, opts, timer, what, clocks)
        seen[what] = (algo.state.step - first, out[0])
        return out

    monkeypatch.setattr(bench, 'measure', measure)
    record = _json_line(bench.main, [
        '--cpu', '--backbone', 'resnet10', '--im-size', '64', '--steps', '2',
        '--calls', '1'])
    # a warm-up dispatch and one timed one, 2 steps each
    assert {k: v[0] for k, v in seen.items()} == {'MT': 4, 'GCT': 4}
    keys = ['metric', 'value', 'unit', 'steps_per_dispatch',
            'timed_dispatches', 'tflop_per_step', 'peak_gib', 'device',
            'power_limit_w', 'gct_metric', 'mt_loss', 'mt_eager_loss',
            'gct_loss', 'clocks', 'cudnn_benchmark']
    for base in ('samples_per_sec_per_chip', 'eager_samples_per_sec_per_chip',
                 'gct_steps_per_sec_per_chip',
                 'gct_samples_per_sec_per_chip'):
        keys += [base, base + '_min', base + '_max']
    assert sorted(record) == sorted(keys)
    assert record['metric'] == (
        'ssl_mt_deeplabv2_r10_64_b8+4_train_samples_per_sec_per_chip')
    assert record['device'] == 'cpu' and record['power_limit_w'] is None
    assert record['value'] == record['samples_per_sec_per_chip'] > 0
    assert record['tflop_per_step'] > 0
    assert 'mfu_bf16' not in record
    assert record['clocks'] == {'mt': None, 'gct': None}
    assert all(math.isfinite(record[k])
               for k in ('mt_loss', 'mt_eager_loss', 'gct_loss'))


def test_bench_refuses_a_loss_that_is_not_finite():
    class Algo(object):
        def __init__(self):
            self.state = type('S', (), {'step': 0})()
            self.modules, self.optimizers = {}, {}

        def train_steps(self, batches):
            self.state.step += len(batches)
            return {'loss': torch.tensor(float('nan'))}

    opts = type('O', (), {'steps': 2, 'calls': 1})()
    try:
        bench.measure(Algo(), None, 'loss', opts, bench._Timer('cpu'), 'X')
    except RuntimeError as exc:
        assert 'loss = nan' in str(exc)
    else:
        raise AssertionError('a NaN loss passed the guard')


def test_bench_restore_puts_the_state_back_in_place():
    """``bench.snapshot``/``restore``, which time every dispatch from one
    state: after more steps, the modules' and the optimizer's tensors hold
    the snapshot's values again in the same storage (a captured graph reads
    those tensors), and the step count is the one given."""
    args = harness.default_args('ssl_null', **dict(SMALL, im_size=32))
    algo = harness.build_algorithm(args, device='cpu', iters_per_epoch=4)
    batch = harness.synthetic_batch(args, device='cpu', seed=1)
    algo.train_step(batch)
    snap = bench.snapshot(algo)
    opt = algo.optimizers['opt']

    def storages():
        return ({k: {n: v.data_ptr() for n, v in m.state_dict().items()}
                 for k, m in algo.modules.items()},
                sorted(t.data_ptr() for st in opt.state.values()
                       for t in st.values() if torch.is_tensor(t)))

    before = storages()
    algo.train_step(batch)
    algo.train_step(batch)
    bench.restore(algo, snap, 1)
    assert algo.state.step == 1 and storages() == before
    for key, module in algo.modules.items():
        for name, value in module.state_dict().items():
            assert torch.equal(value, snap[0][key][name]), (key, name)
    params = [p for g in opt.param_groups for p in g['params']]
    for i, state in snap[1]['opt']['state'].items():
        assert state, i
        for name, value in state.items():
            got = opt.state[params[i]][name]
            assert (torch.equal(got, value) if torch.is_tensor(value)
                    else got == value), (i, name)


def test_bench_clock_samples_are_read_from_nvidia_smi(monkeypatch):
    """``bench._Clocks``: ``nvidia-smi``'s CSV rows (SM MHz, W, C) to their
    extremes, unreadable rows skipped, the process stopped; off the card
    nothing is started and nothing is read."""
    class Proc(object):
        def __init__(self, argv, **kwargs):
            Proc.argv, Proc.stopped = argv, False

        def terminate(self):
            Proc.stopped = True

        def communicate(self, timeout=None):
            return ('1980, 350.52, 44\n[N/A], [N/A], 45\n'
                    '1755, 391.07, 47\n', '')

    monkeypatch.setattr(bench.subprocess, 'Popen', Proc)
    clocks = bench._Clocks(True)
    clocks.start()
    assert Proc.argv[:2] == ['nvidia-smi', '--query-gpu=' +
                             bench._Clocks.QUERY]
    assert clocks.stop() == {'samples': 2, 'sm_mhz_min': 1755.0,
                             'sm_mhz_max': 1980.0, 'power_w_max': 391.07,
                             'temperature_c_max': 47.0}
    assert Proc.stopped and clocks.stop() is None
    off = bench._Clocks(False)
    off.start()
    assert off.stop() is None
