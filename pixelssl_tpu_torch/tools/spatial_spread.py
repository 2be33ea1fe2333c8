"""How far ``--spatial-train`` parts from one process, beside how far one
process parts from itself: the float32 spread that the spatial tests' and
``chip_smoke.py``'s tolerances are set against.

    python -m pixelssl_tpu_torch.tools.spatial_spread --algorithm ssl_null \\
        --backbone resnet10 --im-size 33 [--lr 5e-5] [--steps 2] \\
        [--threads 1 4] [--ranks 2]

On the CPU, from one seed and one synthetic batch: the algorithm's steps
in one process at each torch thread count of ``--threads`` (the same
arithmetic, summed in another order), then over ``--ranks`` gloo ranks
under ``--spatial-train`` (each rank on one thread), each against the
first one-process run: per step the largest relative loss gap (the
thresholded losses of GCT and MT's consistency apart), and after the last
step the largest parameter and BN-statistic gaps. One JSON line on
stdout. It measures numerics, not time.
"""

import argparse
import json
import os
import socket
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LOOSE = ('cons_loss', 'l_fc_loss', 'r_fc_loss', 'l_dc_loss', 'r_dc_loss')
FLAGS = {
    'ssl_null': dict(unlabeled_batch_size=0),
    'ssl_mt': dict(unlabeled_batch_size=2, ignore_unlabeled=False,
                   cons_for_labeled=True, cons_scale=1.0,
                   cons_rampup_epochs=1, ema_decay=0.99,
                   gaussian_noise_std=0.1),
    'ssl_gct': dict(unlabeled_batch_size=2, ignore_unlabeled=False,
                    ssl_mode='gct', fc_ssl_scale=2.0, dc_ssl_scale=1.5,
                    dc_threshold=0.5, dc_rampup_epochs=1, fd_lr=1e-4,
                    fd_scale=10.0, mu=0.5, nu=1),
}


def _args(opts, spatial_train=0):
    from pixelssl_tpu_torch import harness
    return harness.default_args(
        opts.algorithm, backbone=opts.backbone, im_size=opts.im_size,
        num_classes=5, batch_size=4, bf16=False, lr=opts.lr, momentum=0.9,
        weight_decay=5e-4, epochs=20, seed=opts.seed,
        spatial_train=spatial_train, **FLAGS[opts.algorithm])


def _run(opts, spatial_train=0):
    """The steps' losses and the final float32 state of every module."""
    from pixelssl_tpu_torch import harness
    args = _args(opts, spatial_train)
    algo = harness.build_algorithm(args, device='cpu', iters_per_epoch=10)
    batch = harness.synthetic_batch(args, device='cpu', seed=opts.seed)
    losses = [{k: float(v) for k, v in algo.train_step(batch).items()
               if k.endswith('_loss')} for _ in range(opts.steps)]
    state = {k: {n: t.detach().float().clone()
                 for n, t in m.state_dict().items()
                 if not n.endswith('num_batches_tracked')}
             for k, m in algo.modules.items()}
    return losses, state


def _rank(rank, opts, port, out):
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method='tcp://127.0.0.1:{0}'
                            .format(port), rank=rank, world_size=opts.ranks)
    result = _run(opts, spatial_train=opts.ranks)
    if rank == 0:
        torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


def _gaps(run, ref):
    (losses, state), (ref_losses, ref_state) = run, ref
    steps = []
    for a, b in zip(losses, ref_losses):
        gap = {'loss': 0.0, 'loose': 0.0}
        for k, v in b.items():
            key = 'loose' if k in LOOSE else 'loss'
            gap[key] = max(gap[key], abs(a[k] - v) / max(abs(v), 1e-12))
        steps.append(gap)
    param = stat = 0.0
    for key, tensors in ref_state.items():
        for name, value in tensors.items():
            d = float((state[key][name] - value).abs().max())
            if 'running_' in name:
                stat = max(stat, d)
            else:
                param = max(param, d)
    return {'steps': steps, 'param': param, 'stat': stat}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--algorithm', default='ssl_null', choices=sorted(FLAGS))
    ap.add_argument('--backbone', default='resnet10')
    ap.add_argument('--im-size', type=int, default=33)
    ap.add_argument('--lr', type=float, default=5e-5)
    ap.add_argument('--steps', type=int, default=2)
    ap.add_argument('--seed', type=int, default=3)
    ap.add_argument('--threads', type=int, nargs='+', default=[1, 4])
    ap.add_argument('--ranks', type=int, default=2)
    opts = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

    runs = {}
    for threads in opts.threads:
        torch.set_num_threads(threads)
        runs['one process, {0} threads'.format(threads)] = _run(opts)
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'rank0.pt')
        mp.spawn(_rank, args=(opts, port, out), nprocs=opts.ranks)
        runs['{0} spatial ranks'.format(opts.ranks)] = torch.load(
            out, weights_only=False)
    names = list(runs)
    ref = runs[names[0]]
    print(json.dumps({'config': vars(opts), 'against': names[0],
                      'gaps': {n: _gaps(runs[n], ref) for n in names[1:]}}))


if __name__ == '__main__':
    main()
