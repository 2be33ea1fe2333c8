"""Inference throughput of the eval forward: images/s on one card
(counterpart of ``tools/infer_bench.py``).

    python -m pixelssl_tpu_torch.tools.infer_bench --model deeplabv2 \\
        --backbone resnet101 --im-size 321 --batch 8 [--scan 32] \\
        [--calls 2] [--bf16 1] [--extra '{"output_stride": 8}'] \\
        [--trace-dir DIR] [--cpu]

It measures the deployment path: ``activated_pred`` of the task model in
eval mode, the forward that ``tools/export_serving.py`` ships, at a fixed
batch and size, bf16 autocast by default. K (``--scan``) forwards run in
one CUDA graph, each fed the last one's output through a tiny term
(``x + 1e-12 * mean(y)``, the JAX tool's, so that every forward depends on
the one before), and ``--calls`` replays are timed between CUDA events.
``compile_plus_first_dispatch_s`` is the capture plus the first replay
(after one eager forward that autotunes cuDNN). ``--trace-dir`` writes a
``torch.profiler`` trace of one timed replay. With ``--cpu`` the K
forwards run eagerly on the CPU (tests); no device metric then. One JSON
line on stdout.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', default='deeplabv2',
                    choices=['deeplabv2', 'pspnet'])
    ap.add_argument('--backbone', default='resnet101')
    ap.add_argument('--im-size', type=int, default=321)
    ap.add_argument('--batch', type=int, default=8, help='per card')
    ap.add_argument('--num-classes', type=int, default=21)
    ap.add_argument('--scan', type=int, default=32,
                    help='forwards a dispatch')
    ap.add_argument('--calls', type=int, default=2)
    ap.add_argument('--bf16', type=int, default=1)
    ap.add_argument('--extra', type=json.loads, default={},
                    help='extra default_args overrides, e.g. '
                         '\'{"output_stride": 8}\'')
    ap.add_argument('--trace-dir', default='',
                    help='write a torch.profiler trace of one timed replay')
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (tests); no device metric')
    opts = ap.parse_args(argv)

    import numpy as np
    import torch

    from pixelssl_tpu_torch import harness
    from pixelssl_tpu_torch.utils import profiler

    device = 'cpu' if opts.cpu else 'cuda'
    cfg = dict(
        backbone=opts.backbone, im_size=opts.im_size,
        num_classes=opts.num_classes, batch_size=opts.batch,
        unlabeled_batch_size=0, ignore_unlabeled=True, lr=0.01, momentum=0.9,
        epochs=1, bf16=bool(opts.bf16), models={'model': opts.model},
        optimizers={'model': 'sgd'}, lrers={'model': 'polynomiallr'},
        criterions={'model': 'sseg_criterion'})
    cfg.update(opts.extra)
    args = harness.default_args('ssl_null', **cfg)
    model = harness.build_algorithm(args, device=device).model.eval()

    def forward(x):
        return model((x,))['activated_pred'][0]

    def multi_infer(x):
        means = []
        carry = x
        for _ in range(opts.scan):
            y = forward(carry)
            carry = carry + 1e-12 * y.mean().to(carry.dtype)
            means.append(y.mean())
        return torch.stack(means)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (opts.batch, 3, opts.im_size, opts.im_size)).astype(
            np.float32)).to(device)

    with torch.no_grad():
        if device == 'cuda':
            forward(x)  # cuDNN's autotuning, outside the capture
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph):
                ys = multi_infer(x)
            graph.replay()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            dispatch = graph.replay
        else:
            t0 = time.perf_counter()
            ys = multi_infer(x)
            first_s = time.perf_counter() - t0

            def dispatch():
                ys.copy_(multi_infer(x))
        if not bool(torch.isfinite(ys).all()):
            raise RuntimeError('non-finite predictions')

        if opts.trace_dir:
            with profiler.trace(opts.trace_dir, device=device):
                dispatch()
        if device == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(opts.calls):
                dispatch()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(opts.calls):
                dispatch()
            dt = time.perf_counter() - t0

    ips = opts.calls * opts.scan * opts.batch / dt
    record = {
        'model': opts.model, 'backbone': opts.backbone,
        'im_size': opts.im_size, 'batch_per_chip': opts.batch,
        'output_stride': getattr(args, 'output_stride', None),
        'bf16': bool(opts.bf16),
        'images_per_sec_per_chip': ips,
        'latency_ms_per_batch': 1000.0 * opts.batch / ips,
        'compile_plus_first_dispatch_s': first_s,
        'device': (torch.cuda.get_device_name(0) if device == 'cuda'
                   else 'cpu'),
    }
    if opts.trace_dir:
        record['trace_dir'] = os.path.abspath(opts.trace_dir)
    print(json.dumps(record))
    return 0


if __name__ == '__main__':
    sys.exit(main())
