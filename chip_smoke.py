#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing a line as it ends:

1. the card: its name and power limit as ``nvidia-smi`` gives them;
2. builds ``pixelssl_tpu_torch/csrc/blur.cu`` with ``nvcc`` for sm_90a;
3. holds the blur kernel against its plain PyTorch version in float32 at
   the three shapes of the GCT step at 321 px, a non-square map, a map
   smaller than half the kernel (repeated reflection), the 513 px recipe's
   widest blur and a map one past the kernel's tiles: max abs error
   <= 1e-5; times the kernel, the plain version and one cuBLAS form of the
   same product (``library_ms``, a yardstick the port never calls) with
   CUDA events around 50 calls from Python (``ms``, host overhead
   included), and the kernel and the cuBLAS form again as device time
   (``device_ms``, ``library_device_ms``): 20 calls captured in one CUDA
   graph, its replay timed between events, beside the same graph's time
   for one one-element ``torch.add`` (the launch floor);
4. one GCT step of the port at a small size (ResNet-10, 96 px, float32)
   on the card and on the CPU from the same weights and batch: the losses
   must agree (rtol 2e-3 on task/FD losses, 2e-2 on the thresholded fc/dc);
5. the GCT path: GCT on DeepLab-v2/ResNet-101, output stride 16, 321 px,
   21 classes, batch 4 labeled + 4 unlabeled, through
   ``harness.default_args`` -> ``harness.build_algorithm`` ->
   ``SSLGCT.train_step``, random weights from ``--seed``, a synthetic batch
   from numpy; every metric finite, the four task/FD losses > 0,
   ``state.step == 3``, and the blur kernel launched 6 times a step;
6. three MT steps and three SupOnly steps at the small size on the card
   and on the CPU from the same weights and batch (losses rtol 2e-3,
   cons_loss rtol 2e-2), and one MT step with input noise on the card;
7. the MT path at full width (the recipe of
   ``scripts/deeplabv2_pascalvoc_1-8_sslmt.py``, batch 4 + 4): three steps
   timed with CUDA events, every metric finite, both task losses > 0,
   ``cons_loss > 0`` on step 2, no blur launch; then one step under
   ``torch.profiler`` and its ten CUDA kernels with the most device time;
8. the SupOnly path at full width, batch 4 + 0: three steps, task loss > 0;
9. ``validate`` of MT's student and teacher on two synthetic batches of 4
   at 321 px (mIoU in [0, 1], losses finite), and a checkpoint saved into
   a temporary directory, loaded into a fresh MT (equal parameters,
   teacher included) and refused by SupOnly.

Phases 5, 7 and 8 print their step times and peak memory.
Then one JSON line with the kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero and prints no
result; so does a host without CUDA or a directory without the port. It
writes nothing but the kernel build under ``pixelssl_tpu_torch/build/`` and
the checkpoint in a temporary directory that it removes.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
KERNEL_TOL = 1e-5
BLUR_LAUNCHES_PER_STEP = 6
STEPS = 3
ITERS_PER_EPOCH = 100

# (N, H, W, k): the GCT step's calls at 321 px (ssl_gct.py flawmap_handler
# k=odd(321/16), fdgt_generator k=odd(321/8) and odd(321/4)), then a
# non-square map, a map with k//2 >= H, the widest blur at 513 px
# (k=odd(513/4)) and a map one row and one column past the kernel's tiles
MAIN_PATH_CASES = [(8, 321, 321, 21), (4, 321, 321, 41), (4, 321, 321, 81)]
EXTRA_CASES = [(3, 200, 321, 41), (2, 20, 24, 81), (2, 513, 513, 129),
               (1, 65, 33, 21)]
GRAPH_CALLS = 20


def say(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=GRAPH_CALLS, replays=10):
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, its replay timed between events. The host's Python,
    ctypes and dispatch run once, at capture, and not in the timed
    replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def blur_bound_terms_ms(n, h, w, k):
    """The two terms of one call's least time: each map read and written
    once over the memory rate, and the band form's 2k multiply-adds per
    output pixel over the float32 rate."""
    t_bytes = 2 * n * h * w * 4 / H100_BYTES_PER_S * 1e3
    t_ops = 2 * n * h * w * 2 * k / H100_FP32_FLOP_PER_S * 1e3
    return t_bytes, t_ops


def bound(t_bytes, t_ops):
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def phase_device():
    import torch
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError('nvidia-smi failed: ' + smi.stderr)
    card = smi.stdout.strip()
    say('[1/9] device: {0} x{1}; torch {2}, CUDA {3}'.format(
        torch.cuda.get_device_name(0), torch.cuda.device_count(),
        torch.__version__, torch.version.cuda))
    return card


def phase_build():
    from pixelssl_tpu_torch.ops import blur
    t0 = time.perf_counter()
    blur.build()
    say('[2/9] built csrc/blur.cu for sm_90a in {0:.1f} s'.format(
        time.perf_counter() - t0))


def phase_kernel(seed):
    import numpy as np
    import torch
    from pixelssl_tpu_torch.ops import blur

    one = torch.ones(1, device='cuda')
    floor_ms = graph_ms(lambda: torch.add(one, one))
    say('[3/9] launch floor: {0:.5f} ms a call (one one-element torch.add, '
        '{1} calls in one CUDA graph)'.format(floor_ms, GRAPH_CALLS))
    rng = np.random.default_rng(seed)
    rows = []
    for n, h, w, k in MAIN_PATH_CASES + EXTRA_CASES:
        x = torch.from_numpy(rng.standard_normal((n, h, w)).astype(
            np.float32)).cuda()
        out = blur.blur_kernel(x, k)
        ref = blur.blur_plain(x, k)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        bh = torch.from_numpy(blur._blur_matrix(h, k)).cuda()
        bw = torch.from_numpy(blur._blur_matrix(w, k)).cuda()
        row = {
            'shape': [n, h, w], 'k': k, 'max_abs_err': err,
            'ms': time_ms(lambda: blur.blur_kernel(x, k)),
            'plain_ms': time_ms(lambda: blur.blur_plain(x, k)),
            'library_ms': time_ms(
                lambda: torch.matmul(torch.matmul(bh, x), bw.t())),
            'device_ms': graph_ms(lambda: blur.blur_kernel(x, k)),
            'library_device_ms': graph_ms(
                lambda: torch.matmul(torch.matmul(bh, x), bw.t())),
        }
        row['bound_ms'], row['bound_by'] = bound(
            *blur_bound_terms_ms(n, h, w, k))
        say('[3/9] blur [{0},{1},{2}] k={3}: max_abs_err {4:.3g}  '
            'kernel_ms {5:.4f}  plain_ms {6:.4f}  library_ms {7:.4f}  '
            'device_ms {8:.5f}  library_device_ms {9:.5f}  '
            'bound_ms {10:.5f} ({11})'.format(
                n, h, w, k, err, row['ms'], row['plain_ms'],
                row['library_ms'], row['device_ms'],
                row['library_device_ms'], row['bound_ms'], row['bound_by']))
        if not err <= KERNEL_TOL:
            raise AssertionError('blur kernel disagrees with its plain '
                                 'version at {0}: {1} > {2}'.format(
                                     (n, h, w, k), err, KERNEL_TOL))
        rows.append(row)
    return rows, floor_ms


GCT_CONFIG = dict(
    ssl_mode='gct', fc_ssl_scale=1.0, dc_ssl_scale=100.0, dc_threshold=0.6,
    dc_rampup_epochs=3, fd_lr=1e-4, fd_scale=10.0, mu=0.5, nu=1,
    lr=2.5e-4, momentum=0.9, weight_decay=5e-4, ignore_unlabeled=False)


def phase_small_reference(seed):
    """One float32 GCT step at ResNet-10 / 96 px on the card and on the
    CPU from the same weights and batch."""
    from pixelssl_tpu_torch import harness

    args = harness.default_args(
        'ssl_gct', backbone='resnet10', im_size=96, num_classes=5,
        batch_size=4, unlabeled_batch_size=2, epochs=2, bf16=False,
        seed=seed, **dict(GCT_CONFIG, dc_rampup_epochs=1))
    rows = {}
    for device in ('cpu', 'cuda'):
        algo = harness.build_algorithm(args, device=device)
        batch = harness.synthetic_batch(args, device=device, seed=seed)
        metrics = algo.train_step(batch)
        rows[device] = {k: float(v) for k, v in metrics.items()}
    for key, ref in rows['cpu'].items():
        got = rows['cuda'][key]
        tol = 2e-2 if ('_fc_' in key or '_dc_' in key) else 2e-3
        if not math.isclose(got, ref, rel_tol=tol, abs_tol=1e-6):
            raise AssertionError('small GCT step: {0} on the card {1} vs '
                                 'CPU {2}'.format(key, got, ref))
    say('[4/9] small GCT step (ResNet-10, 96 px) card vs CPU agree: ' +
        '  '.join('{0} {1:.5f}/{2:.5f}'.format(k, rows['cuda'][k],
                                                rows['cpu'][k])
                  for k in sorted(rows['cpu'])))


def timed_steps(algo, batch, steps, tag, what, positive):
    """``steps`` train steps, each between CUDA events, with the blur
    launches counted from 0 and the peak memory from a reset; every metric
    must be finite and the ``positive`` ones > 0. Prints the step times and
    the peak memory on one line; returns the metrics of each step, the step
    times and the blur launches."""
    import torch
    from pixelssl_tpu_torch.ops import blur

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blur.launches = 0
    history, step_ms = [], []
    for s in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = algo.train_step(batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        values = {k: float(v) for k, v in metrics.items()}
        history.append(values)
        say('{0} step {1}: {2:.1f} ms  {3}'.format(
            tag, s, step_ms[-1], '  '.join(
                '{0} {1:.6g}'.format(k, v) for k, v in sorted(values.items()))))
        bad = [k for k, v in values.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError('non-finite metrics at step {0}: {1}'
                                 .format(s, bad))
        for k in positive:
            if not values[k] > 0:
                raise AssertionError('{0} = {1} at step {2}'.format(
                    k, values[k], s))
    launches = blur.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if algo.state.step != steps:
        raise AssertionError('state.step {0} != {1}'.format(
            algo.state.step, steps))
    say('{0} {1} {2} steps, state.step {3}, blur launches {4}, step ms {5}, '
        'peak memory {6:.2f} GiB'.format(
            tag, what, steps, algo.state.step, launches,
            ' '.join('{0:.1f}'.format(t) for t in step_ms), peak_gib))
    return history, step_ms, launches


def full_width_args(algo_name, seed, **config):
    """DeepLab-v2/ResNet-101, output stride 16, 321 px, 21 classes, bf16
    autocast, 20 epochs of the poly schedule."""
    from pixelssl_tpu_torch import harness
    return harness.default_args(
        algo_name, backbone='resnet101', output_stride=16, im_size=321,
        num_classes=21, epochs=20, bf16=True, seed=seed, **config)


def build_full_width(args, tag, what):
    import torch
    from pixelssl_tpu_torch import harness

    t0 = time.perf_counter()
    algo = harness.build_algorithm(args, iters_per_epoch=ITERS_PER_EPOCH)
    batch = harness.synthetic_batch(args, seed=args.seed)
    torch.cuda.synchronize()
    say('{0} built {1} on DeepLab-v2/ResNet-101 @321 (batch {2}+{3}) in '
        '{4:.1f} s'.format(tag, what, args.labeled_batch_size,
                           args.unlabeled_batch_size,
                           time.perf_counter() - t0))
    return algo, batch


def phase_main_path(seed, steps):
    import torch

    args = full_width_args('ssl_gct', seed, batch_size=8,
                           unlabeled_batch_size=4, **GCT_CONFIG)
    algo, batch = build_full_width(args, '[5/9]', 'GCT')
    _, _, launches = timed_steps(
        algo, batch, steps, '[5/9]', 'GCT',
        ('l_task_loss', 'r_task_loss', 'l_fd_loss', 'r_fd_loss'))
    if launches != BLUR_LAUNCHES_PER_STEP * steps:
        raise AssertionError('blur kernel launched {0} times in {1} steps, '
                             'expected {2}'.format(
                                 launches, steps,
                                 BLUR_LAUNCHES_PER_STEP * steps))

    algo.l_model.eval()
    with torch.no_grad():
        pred = algo.l_model(batch['inp'])['activated_pred'][0]
    if tuple(pred.shape) != (8, 21, 321, 321) or not bool(
            torch.isfinite(pred).all()):
        raise AssertionError('eval prediction {0} not finite or of the wrong '
                             'shape'.format(tuple(pred.shape)))
    return launches


# the MT recipe, scripts/deeplabv2_pascalvoc_1-8_sslmt.py:13-14, without
# input noise (--gaussian-noise-std is off by default)
MT_CONFIG = dict(
    cons_for_labeled=False, cons_scale=1.0, cons_rampup_epochs=3,
    ema_decay=0.99, gaussian_noise_std=None, lr=2.5e-4, momentum=0.9,
    weight_decay=5e-4)
NULL_CONFIG = dict(lr=2.5e-4, momentum=0.9, weight_decay=5e-4)


def phase_small_mt_null(seed, steps):
    """MT and SupOnly at ResNet-10 / 96 px in float32, ``steps`` steps
    each on the card and on the CPU from the same weights and batch; the
    losses must agree (rtol 2e-3; cons_loss rtol 2e-2, atol 1e-6: a mean
    squared difference of two nearly equal predictions, 0 on steps 0 and
    1). lr 5e-5: at 2.5e-4 this toy diverges and amplifies float32 noise
    tenfold a step (tests/test_torch_mt.py). Then one MT step with input
    noise, on the card only: its metrics must be finite."""
    from pixelssl_tpu_torch import harness

    small = dict(backbone='resnet10', im_size=96, num_classes=5, epochs=20,
                 bf16=False, seed=seed)
    cases = (
        ('ssl_mt', dict(MT_CONFIG, lr=5e-5, batch_size=4,
                        unlabeled_batch_size=2, **small)),
        ('ssl_null', dict(NULL_CONFIG, lr=5e-5, batch_size=4,
                          unlabeled_batch_size=0, **small)))
    for algo_name, config in cases:
        args = harness.default_args(algo_name, **config)
        rows = {}
        for device in ('cpu', 'cuda'):
            algo = harness.build_algorithm(
                args, device=device, iters_per_epoch=2)
            batch = harness.synthetic_batch(args, device=device, seed=seed)
            rows[device] = [{k: float(v) for k, v in
                             algo.train_step(batch).items()}
                            for _ in range(steps)]
        for s, (ref_row, got_row) in enumerate(zip(rows['cpu'],
                                                   rows['cuda'])):
            for key, ref in ref_row.items():
                rtol, atol = (2e-2, 1e-6) if key == 'cons_loss' else (2e-3,
                                                                      1e-6)
                if not math.isclose(got_row[key], ref, rel_tol=rtol,
                                    abs_tol=atol):
                    raise AssertionError(
                        'small {0} step {1}: {2} on the card {3} vs CPU '
                        '{4}'.format(algo_name, s, key, got_row[key], ref))
        say('[6/9] small {0} ({1} steps, ResNet-10, 96 px) card vs CPU agree; '
            'last step: {2}'.format(algo_name, steps, '  '.join(
                '{0} {1:.6g}/{2:.6g}'.format(k, rows['cuda'][-1][k],
                                             rows['cpu'][-1][k])
                for k in sorted(rows['cpu'][-1]))))
    args = harness.default_args('ssl_mt', **dict(
        cases[0][1], gaussian_noise_std=0.1))
    algo = harness.build_algorithm(args, iters_per_epoch=2)
    values = {k: float(v) for k, v in algo.train_step(
        harness.synthetic_batch(args, seed=seed)).items()}
    if not all(math.isfinite(v) for v in values.values()):
        raise AssertionError('noisy MT step: {0}'.format(values))
    say('[6/9] small MT step with gaussian_noise_std 0.1 on the card: ' +
        '  '.join('{0} {1:.6g}'.format(k, v) for k, v in sorted(values.items())))


def profile_step(algo, batch, step_ms, top=10):
    """One train step under ``torch.profiler``: the device time of each
    CUDA kernel summed by name, the ``top`` largest printed, and the
    kernels' total beside the median of the timed steps after the first
    (the device's busy share of a step)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        algo.train_step(batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and
              not getattr(e, 'is_user_annotation', False)]
    total_us = sum(e.self_device_time_total for e in events)
    if not events or total_us <= 0:
        say('[7/9] MT step profile: the profiler recorded no device time')
        return
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    steady_ms = statistics.median(step_ms[1:])
    say('[7/9] MT step profile: {0:.3f} ms of device time in {1} kernel '
        'launches ({2} distinct kernels), {3:.1f}% of a {4:.1f} ms step '
        '(median of the timed steps after the first); top {5}:'.format(
            total_us / 1e3, sum(e.count for e in events), len(events),
            100.0 * total_us / 1e3 / steady_ms, steady_ms, top))
    for e in events[:top]:
        say('[7/9]   {0:8.3f} ms {1:5.1f}% x{2:<4} {3}'.format(
            e.self_device_time_total / 1e3,
            100.0 * e.self_device_time_total / total_us, e.count,
            e.key[:150]))


def phase_mt(seed, steps):
    """MT at full width: ``steps`` timed steps, then one profiled step."""
    args = full_width_args('ssl_mt', seed, batch_size=8,
                           unlabeled_batch_size=4, **MT_CONFIG)
    algo, batch = build_full_width(args, '[7/9]', 'MT')
    history, step_ms, launches = timed_steps(
        algo, batch, steps, '[7/9]', 'MT', ('s_task_loss', 't_task_loss'))
    if not history[2]['cons_loss'] > 0:
        raise AssertionError('cons_loss {0} on step 2'.format(
            history[2]['cons_loss']))
    if launches != 0:
        raise AssertionError('MT launched the blur kernel {0} times'.format(
            launches))
    profile_step(algo, batch, step_ms)
    return algo


def phase_null(seed, steps):
    """SupOnly at full width, batch 4 + 0."""
    args = full_width_args('ssl_null', seed, batch_size=4,
                           unlabeled_batch_size=0, **NULL_CONFIG)
    algo, batch = build_full_width(args, '[8/9]', 'SupOnly')
    _, _, launches = timed_steps(algo, batch, steps, '[8/9]', 'SupOnly',
                                 ('task_loss',))
    if launches != 0:
        raise AssertionError('SupOnly launched the blur kernel {0} '
                             'times'.format(launches))
    return algo


def phase_validate_checkpoint(mt_algo, null_algo, seed):
    """``validate`` of MT's student and teacher on two synthetic batches of
    4 at 321 px; a checkpoint saved, loaded into a fresh MT (equal
    parameters, teacher included) and refused by SupOnly."""
    import tempfile

    import torch
    from pixelssl_tpu_torch import harness
    from pixelssl_tpu_torch.utils import logger

    args = mt_algo.args
    scores = mt_algo.validate(harness.synthetic_val_batches(args, 2,
                                                            seed=seed + 1),
                              epoch=0)
    for model_id in ('student', 'teacher'):
        miou = scores.get(model_id + '_metric_mIoU')
        if miou is None or not 0.0 <= miou <= 1.0:
            raise AssertionError('{0} mIoU {1}'.format(model_id, miou))
    losses = {k: m.avg for k, m in mt_algo.meters.items()
              if k.endswith('_loss')}
    if sorted(losses) != ['student_loss', 'teacher_loss'] or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError('validation losses {0}'.format(losses))
    say('[9/9] MT validate (2 batches of 4 @321): ' + '  '.join(
        '{0} {1:.5f}'.format(k, float(v))
        for k, v in sorted(dict(scores, **losses).items())))

    with tempfile.TemporaryDirectory() as tmp:
        path = mt_algo.save_checkpoint(epoch=0,
                                       path=os.path.join(tmp, 'mt.pth'))
        size_mib = os.path.getsize(path) / 2 ** 20
        fresh = harness.build_algorithm(
            full_width_args('ssl_mt', seed + 1, batch_size=8,
                            unlabeled_batch_size=4, **MT_CONFIG),
            iters_per_epoch=ITERS_PER_EPOCH)
        fresh.load_checkpoint(path)
        for key in ('model', 'teacher'):
            theirs = mt_algo.modules[key].state_dict()
            for name, value in fresh.modules[key].state_dict().items():
                if not torch.equal(value, theirs[name]):
                    raise AssertionError('loaded {0}.{1} differs'.format(
                        key, name))
        if fresh.state.step != mt_algo.state.step:
            raise AssertionError('loaded step {0} != {1}'.format(
                fresh.state.step, mt_algo.state.step))
        try:
            null_algo.load_checkpoint(path)
        except logger.FatalError:
            pass
        else:
            raise AssertionError('SupOnly loaded a checkpoint of ssl_mt')
    say('[9/9] checkpoint of {0:.0f} MiB saved, loaded into a fresh MT '
        '(student and teacher equal, step {1}), refused by SupOnly'.format(
            size_mib, fresh.state.step))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    opts = parser.parse_args(argv)

    try:
        import torch
    except ImportError:
        print('chip_smoke: PyTorch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available on this host',
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import pixelssl_tpu_torch  # noqa: F401
    except ImportError as exc:
        print('chip_smoke: the port is not beside this script: {0}'.format(
            exc), file=sys.stderr)
        return 2

    # float32 stays float32 (the blur's plain version and yardstick are
    # float32 matmuls); the convolutions run in bf16 under autocast
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    try:
        card = phase_device()
        phase_build()
        rows, floor_ms = phase_kernel(opts.seed)
        phase_small_reference(opts.seed)
        launches = phase_main_path(opts.seed, STEPS)
        phase_small_mt_null(opts.seed, STEPS)
        mt_algo = phase_mt(opts.seed, STEPS)
        null_algo = phase_null(opts.seed, STEPS)
        phase_validate_checkpoint(mt_algo, null_algo, opts.seed)
    except Exception:  # report which phase failed, print no result
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1

    # the kernel's line covers one GCT step: two calls at each main-path
    # shape; its bound is that of the six calls' bytes and operations
    main_rows = rows[:len(MAIN_PATH_CASES)]
    per_step = {key: 2 * sum(r[key] for r in main_rows)
                for key in ('ms', 'plain_ms', 'library_ms', 'device_ms',
                            'library_device_ms')}
    terms = [blur_bound_terms_ms(*case) for case in MAIN_PATH_CASES]
    bound_ms, bound_by = bound(2 * sum(t[0] for t in terms),
                               2 * sum(t[1] for t in terms))
    kernel = {
        'name': 'blur_band',
        'route': 'cuda',
        'source': 'pixelssl_tpu_torch/csrc/blur.cu',
        'replaces': 'pixelssl_tpu/ops/blur_pallas.py:49',
        'launches': launches,
        'max_abs_err': max(r['max_abs_err'] for r in rows),
        'ms': per_step['ms'],
        'plain_ms': per_step['plain_ms'],
        'bound_ms': bound_ms,
        'bound_by': bound_by,
        'library_ms': per_step['library_ms'],
        'device_ms': per_step['device_ms'],
        'library_device_ms': per_step['library_device_ms'],
        'launch_floor_ms': floor_ms,
        'per': 'one GCT step at 321 px: 2x each of the calls in calls',
        'calls': rows,
    }
    say(card)
    say(json.dumps({'kernels': [kernel]}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
