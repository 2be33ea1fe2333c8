"""Benchmark of the port: SSL train samples/s on one card (counterpart of
``bench.py``, the JAX package's, which stays as it is).

    python -m pixelssl_tpu_torch.bench [--steps 32] [--calls 5] [--seed 0]
        [--cudnn-benchmark]
    python -m pixelssl_tpu_torch.bench --cpu --backbone resnet10 \\
        --im-size 64 --steps 2 --calls 1        # tiny, on the CPU

The workload is the JAX bench's: Mean Teacher on DeepLab-v2/ResNet-101,
output stride 16, 321 px, 21 classes, batch 8 + 4 (8 samples a step, 4 of
them unlabeled), SGD lr 2.5e-4, momentum 0.9, weight decay 5e-4, 20 epochs
of 100 iterations for the poly schedule (``bench.py:112-120``),
``cons_scale`` 1.0, ``cons_rampup_epochs`` 3, ``ema_decay`` 0.99
(``bench.py:178-180``), bf16 autocast, random weights from ``--seed`` and a
synthetic batch on the card. GCT at the same batch with the recipe's
scales (``bench.py:192-196``) gives the second number; its failure fails
the run.

Both go through the trainer's own multi-step path, ``train_steps``: K
(``--steps``, 32 as ``SCAN_STEPS``) steps a dispatch, one CUDA graph of
the step replayed K times. One warm-up dispatch (an eager step, the
capture, K - 1 replays), then ``--calls`` (at least 5 on the card) timed
dispatches, each between CUDA events and each from the state the warm-up
left (``restore``, in place), so that every dispatch does the same work
whatever its place in the run. Guards: ``state.step`` advanced by exactly
the steps run, and the loss finite. The same count of eager steps
(``train_step``) from that state, timed the same way, gives the eager rate
beside it, and its loss after them beside the replayed one's. On the card
``nvidia-smi`` samples the SM clock, the power draw and the temperature
every 100 ms while the timed dispatches run (``clocks``).

cuDNN chooses its algorithms as the trainer lets it, by its heuristics,
so that the rate is the trainer's; ``--cudnn-benchmark`` lets it time its
candidates for each shape instead (``torch.backends.cudnn.benchmark``;
``cudnn_benchmark`` in the line), as ``chip_smoke.py`` runs.

``tflop_per_step`` counts one eager MT step, forward and backward, with
``torch.utils.flop_counter.FlopCounterMode`` (the convolutions' and
matrix products' multiply-adds, twice); ``mfu_bf16`` divides the achieved
rate by the card's published dense bf16 peak, keyed by its name
(``PEAK_BF16``): a card not in the table gets no ``mfu_bf16``.

Progress goes to stderr; stdout gets one JSON line.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

SCAN_STEPS = 32
BATCH, UNLABELED = 8, 4
MT_FLAGS = dict(cons_scale=1.0, cons_rampup_epochs=3, ema_decay=0.99)
GCT_FLAGS = dict(ssl_mode='gct', fc_ssl_scale=1.0, dc_ssl_scale=100.0,
                 dc_threshold=0.6, fd_lr=1e-4, fd_scale=10.0, mu=0.5, nu=1,
                 dc_rampup_epochs=3)
# dense bf16 peaks of the SXM parts (NVIDIA's data sheets)
PEAK_BF16 = {'NVIDIA H100 80GB HBM3': 989e12, 'NVIDIA H200': 989e12}


def _log(*parts):
    print('bench:', *parts, file=sys.stderr, flush=True)


def card():
    """(name, power limit in W) of the card as ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader,nounits'],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = [x.strip() for x in out.splitlines()[0].split(',')]
    return name, float(limit)


def build(algo_name, opts, device, **flags):
    from pixelssl_tpu_torch import harness

    args = harness.default_args(
        algo_name, backbone=opts.backbone, im_size=opts.im_size,
        num_classes=21, batch_size=BATCH, unlabeled_batch_size=UNLABELED,
        ignore_unlabeled=False, lr=2.5e-4, momentum=0.9, weight_decay=5e-4,
        epochs=20, steps_per_dispatch=opts.steps, seed=opts.seed, **flags)
    algo = harness.build_algorithm(args, device=device, iters_per_epoch=100)
    return algo, harness.synthetic_batch(args, device=device, seed=opts.seed)


class _Timer(object):
    """Seconds of a piece of work: CUDA events on the card, the host clock
    after it on the CPU."""

    def __init__(self, device):
        import torch
        self.cuda = device == 'cuda'
        self.torch = torch

    def __call__(self, fn):
        if self.cuda:
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0


def snapshot(algo):
    """Copies of the modules' and optimizers' state of ``algo``."""
    import copy
    return ({k: copy.deepcopy(m.state_dict())
             for k, m in algo.modules.items()},
            {k: copy.deepcopy(o.state_dict())
             for k, o in algo.optimizers.items()})


def restore(algo, snap, step):
    """The state of ``snapshot`` back in ``algo``, and ``state.step``.
    Tensors are copied in place where the optimizer has state (a captured
    graph holds those tensors); an empty snapshot empties it."""
    import torch
    modules, optimizers = snap
    for k, m in algo.modules.items():
        m.load_state_dict(modules[k])
    for k, o in algo.optimizers.items():
        saved = optimizers[k]
        if not saved['state']:
            o.load_state_dict(saved)
            continue
        for i, p in enumerate(p for g in o.param_groups for p in g['params']):
            for name, value in saved['state'][i].items():
                if torch.is_tensor(value):
                    o.state[p][name].copy_(value)
                else:
                    o.state[p][name] = value
    algo.state.step = step


class _Clocks(object):
    """``nvidia-smi`` sampling the SM clock (MHz), the power draw (W) and
    the temperature (C) every 100 ms between ``start`` and ``stop``;
    ``stop`` returns their extremes, or None without samples."""

    QUERY = 'clocks.sm,power.draw,temperature.gpu'

    def __init__(self, on):
        self.on = on
        self.proc = None

    def start(self):
        if self.on:
            self.proc = subprocess.Popen(
                ['nvidia-smi', '--query-gpu=' + self.QUERY,
                 '--format=csv,noheader,nounits', '-lms', '100'],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True)

    def stop(self):
        if self.proc is None:
            return None
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        self.proc = None
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(',')])
            except ValueError:
                continue
        if not rows:
            return None
        sm, power, temp = zip(*rows)
        return {'samples': len(rows), 'sm_mhz_min': min(sm),
                'sm_mhz_max': max(sm), 'power_w_max': max(power),
                'temperature_c_max': max(temp)}


def measure(algo, batch, loss_key, opts, timer, what, clocks=None):
    """Steps/s and the last step's loss of each timed dispatch of
    ``opts.steps`` steps, each from the state after one warm-up dispatch;
    the guards of the module docstring. Returns (rates, losses, the
    state's snapshot, its step)."""
    k = opts.steps
    t0 = time.perf_counter()
    _log('{0}: warm-up dispatch of {1} steps...'.format(what, k))
    timer(lambda: algo.train_steps([batch] * k))
    _log('{0}: warm-up done in {1:.1f} s'.format(what,
                                                time.perf_counter() - t0))
    start = algo.state.step
    snap = snapshot(algo)
    rates, losses = [], []
    if clocks is not None:
        clocks.start()
    for _ in range(opts.calls):
        restore(algo, snap, start)
        metrics, seconds = timer(lambda: algo.train_steps([batch] * k))
        if algo.state.step != start + k:
            raise RuntimeError('{0}: state.step {1} after {2} steps from {3}'
                               .format(what, algo.state.step, k, start))
        loss = float(metrics[loss_key])
        if not math.isfinite(loss):
            raise RuntimeError('{0}: {1} = {2}'.format(what, loss_key, loss))
        rates.append(k / seconds)
        losses.append(loss)
    _log('{0}: {1} dispatches of {2} steps from step {3}, {4} after them '
         '{5}, steps/s {6}'.format(
             what, opts.calls, k, start, loss_key,
             ' '.join('{0:.5f}'.format(v) for v in losses),
             ' '.join('{0:.2f}'.format(r) for r in rates)))
    return rates, losses, snap, start


def eager_rates(algo, batch, loss_key, opts, timer, snap, start):
    """Steps/s of ``opts.calls`` runs of ``opts.steps`` eager steps, each
    from ``snap`` at step ``start``, and the loss after each."""
    def run():
        for _ in range(opts.steps):
            metrics = algo.train_step(batch)
        return metrics

    rates, losses = [], []
    for _ in range(opts.calls):
        restore(algo, snap, start)
        metrics, seconds = timer(run)
        rates.append(opts.steps / seconds)
        losses.append(float(metrics[loss_key]))
    return rates, losses


def step_flops(algo, batch):
    """Floating-point operations of one eager train step."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        algo.train_step(batch)
    return counter.get_total_flops()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--steps', type=int, default=SCAN_STEPS,
                        help='train steps a dispatch')
    parser.add_argument('--calls', type=int, default=5,
                        help='timed dispatches after the warm-up one')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--backbone', default='resnet101')
    parser.add_argument('--im-size', type=int, default=321)
    parser.add_argument('--cudnn-benchmark', action='store_true',
                        help='let cuDNN autotune its algorithms')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU (tests); no device metric')
    opts = parser.parse_args(argv)

    import torch

    device = 'cpu' if opts.cpu else 'cuda'
    if opts.cudnn_benchmark:
        torch.backends.cudnn.benchmark = True
    if device == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('bench: no CUDA device (pass --cpu for the CPU)')
        name, power_limit = card()
        torch.cuda.reset_peak_memory_stats()
    else:
        name, power_limit = 'cpu', None
    timer = _Timer(device)
    # the JAX bench's notation: b<samples a step>+<unlabeled among them>
    cell = 'deeplabv2_{0}_{1}_b{2}+{3}'.format(
        opts.backbone.replace('resnet', 'r'), opts.im_size, BATCH,
        UNLABELED)

    _log('building MT on DeepLab-v2/{0} @{1}, batch {2}+{3}, on {4}'.format(
        opts.backbone, opts.im_size, BATCH - UNLABELED, UNLABELED, name))
    clocks = _Clocks(device == 'cuda')
    algo, batch = build('ssl_mt', opts, device, **MT_FLAGS)
    mt, mt_losses, snap, start = measure(algo, batch, 's_task_loss', opts,
                                         timer, 'MT', clocks)
    mt_clocks = clocks.stop()
    eager, eager_losses = eager_rates(algo, batch, 's_task_loss', opts,
                                      timer, snap, start)
    flops = step_flops(algo, batch)
    _log('MT eager from the same state: steps/s {0}, s_task_loss after '
         'them {1}; {2:.4f} TFLOP a step; clocks while replaying {3}'.format(
             ' '.join('{0:.2f}'.format(r) for r in eager),
             ' '.join('{0:.5f}'.format(v) for v in eager_losses),
             flops / 1e12, mt_clocks))
    del algo, batch, snap

    _log('building GCT at the same batch')
    algo, batch = build('ssl_gct', opts, device, **GCT_FLAGS)
    gct, gct_losses, _, _ = measure(algo, batch, 'l_task_loss', opts, timer,
                                    'GCT', clocks)
    gct_clocks = clocks.stop()
    del algo, batch

    def spread(rates, scale, key):
        return {key: statistics.median(rates) * scale,
                key + '_min': min(rates) * scale,
                key + '_max': max(rates) * scale}

    record = {
        'metric': 'ssl_mt_' + cell + '_train_samples_per_sec_per_chip',
        'value': statistics.median(mt) * BATCH,
        'unit': 'samples/s/chip',
        'steps_per_dispatch': opts.steps,
        'timed_dispatches': opts.calls,
    }
    record.update(spread(mt, BATCH, 'samples_per_sec_per_chip'))
    record.update(spread(eager, BATCH, 'eager_samples_per_sec_per_chip'))
    record.update(spread(gct, 1, 'gct_steps_per_sec_per_chip'))
    record.update(spread(gct, BATCH, 'gct_samples_per_sec_per_chip'))
    record['gct_metric'] = 'ssl_gct_' + cell + '_train_steps_per_sec_per_chip'
    record['mt_loss'] = statistics.median(mt_losses)
    record['mt_eager_loss'] = statistics.median(eager_losses)
    record['gct_loss'] = statistics.median(gct_losses)
    record['clocks'] = {'mt': mt_clocks, 'gct': gct_clocks}
    record['tflop_per_step'] = flops / 1e12
    peak = PEAK_BF16.get(name)
    if peak is not None:
        record['mfu_bf16'] = statistics.median(mt) * flops / peak
    record['peak_gib'] = (torch.cuda.max_memory_allocated() / 2 ** 30
                          if device == 'cuda' else None)
    record['cudnn_benchmark'] = bool(torch.backends.cudnn.benchmark)
    record['device'] = name
    record['power_limit_w'] = power_limit
    print(json.dumps(record))
    return 0


if __name__ == '__main__':
    sys.exit(main())
