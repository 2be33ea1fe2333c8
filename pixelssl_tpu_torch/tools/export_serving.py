"""Export a trained model's eval forward for serving (counterpart of
``tools/export_serving.py``, which writes a StableHLO artifact).

    python -m pixelssl_tpu_torch.tools.export_serving \\
        --ckpt result/<exp>/ckpt/checkpoint_N.pth --algo ssl_mt \\
        --backbone resnet101 --im-size 321 [--num-classes 21] \\
        [--model-key model] [--batch 1] [--bf16 1] [--out model.pt2] [--cpu]

The eval forward (the activated prediction of one model of the algorithm,
at a fixed input shape) goes through ``torch.export`` and is saved with
``torch.export.save`` as a ``.pt2`` archive: the graph and the weights in
one file, loaded by ``torch.export.load`` without the port's model code.
The model's bf16 autocast regions stay in the program as PyTorch's
``wrap_with_autocast`` operator, so the artifact computes what the live
forward computes: convolutions in bf16, statistics, resizes and softmax in
float32. The program holds tensors of the device it was exported on (the
card, or the CPU with ``--cpu``); the JAX tool's ``--platform`` has no
counterpart. ``--bf16 0`` exports the float32 forward.

The round trip is built in: the artifact is loaded, run, and compared
with the live forward at the JAX tool's limits (atol 5e-3, rtol 2e-2: bf16
convolutions in two separately traced programs agree to bf16 rounding).
Without ``--ckpt`` the weights are random (``--seed``).
"""

import argparse
import os
import sys

import torch.nn as nn

# flags that every algorithm's checks accept when only its models are
# built (no unlabeled data, nothing trained)
_BUILD_FLAGS = dict(cons_scale=0.0, cons_rampup_epochs=0,
                    rotation_scale=0.0, rotated_sup_scale=0.0)


def export(opts):
    """Build, export, save and check; returns (path, max abs difference)."""
    import numpy as np
    import torch

    from pixelssl_tpu_torch import harness

    device = 'cpu' if opts.cpu else 'cuda'
    args = harness.default_args(
        opts.algo, backbone=opts.backbone, im_size=opts.im_size,
        num_classes=opts.num_classes, batch_size=2, unlabeled_batch_size=0,
        ignore_unlabeled=True, lr=0.01, momentum=0.9, epochs=1,
        bf16=bool(opts.bf16), seed=opts.seed, **_BUILD_FLAGS)
    algo = harness.build_algorithm(args, device=device)
    if opts.ckpt:
        algo.load_checkpoint(opts.ckpt)
    if opts.model_key not in algo.modules:
        raise SystemExit('{0} has no model `{1}`; it has {2}'.format(
            opts.algo, opts.model_key, sorted(algo.modules)))
    forward = EvalForward(algo.modules[opts.model_key]).eval()

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (opts.batch, 3, opts.im_size, opts.im_size)).astype(
            np.float32)).to(device)
    with torch.no_grad():
        program = torch.export.export(forward, (x,))
        torch.export.save(program, opts.out)
        got = torch.export.load(opts.out).module()(x)
        want = forward(x)
    diff = float((got.float() - want.float()).abs().max())
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=5e-3, rtol=2e-2)
    return opts.out, diff


class EvalForward(nn.Module):
    """``model((x,))['activated_pred'][0]``: the served output."""

    def __init__(self, model):
        super(EvalForward, self).__init__()
        self.model = model

    def forward(self, x):
        return self.model((x,))['activated_pred'][0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--ckpt', default='',
                    help='a checkpoint of the port (omit for random '
                         'weights: smoke runs and tests)')
    ap.add_argument('--algo', default='ssl_mt')
    ap.add_argument('--model-key', default='model',
                    help='which model of the algorithm to export (e.g. '
                         'model / teacher / l_model)')
    ap.add_argument('--backbone', default='resnet101')
    ap.add_argument('--im-size', type=int, default=321)
    ap.add_argument('--num-classes', type=int, default=21)
    ap.add_argument('--batch', type=int, default=1)
    ap.add_argument('--bf16', type=int, default=1,
                    help='bf16 autocast in the exported forward (0: float32)')
    ap.add_argument('--out', default='model.pt2')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--cpu', action='store_true',
                    help='export a CPU program (tests)')
    opts = ap.parse_args(argv)
    path, diff = export(opts)
    print('exported {0} ({1:.1f} MB), round-trip max|diff| = {2:.2e}'.format(
        path, os.path.getsize(path) / 1e6, diff))
    return 0


if __name__ == '__main__':
    sys.exit(main())
