#!/usr/bin/env python3
"""Time the port's loader workers started by ``spawn`` and by ``fork`` on
one card, through the script path.

    python3 tools/torch_loader_ab.py [--order spawn,fork,fork,spawn]

Each run is ``chip_smoke.py``'s phase 10 without its extra steps: the
port's ``deeplabv2_pascalvoc_1-8_sslmt.py`` config with its data keys
swapped for the synthetic dataset, DeepLab-v2/ResNet-101 @321, batch
2 + 2, 2 epochs of 5 iterations from two persistent loader workers,
validation and a checkpoint after each epoch, with
``pixelssl_tpu_torch.nn.loader.START_METHOD`` set to the run's method.
Runs go in the given order, in one process. One line per run: its wall
time, the first iteration's wait for the loader (the workers' start and
first batch), each epoch's ms an iteration and samples/s, and each
iteration's wait; then one JSON line with every run. Every run must
leave no worker process and finite losses. It needs a CUDA card and
imports no JAX.
"""

import argparse
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--order', default='spawn,fork,fork,spawn')
    opts = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.nn import loader
    from pixelssl_tpu_torch.tasks import sseg

    if not torch.cuda.is_available():
        print('torch_loader_ab: CUDA is not available', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    runs = []
    for method in opts.order.split(','):
        loader.START_METHOD = method
        with tempfile.TemporaryDirectory() as out:
            config = chip_smoke.script_config(chip_smoke.SCRIPT_MT, out,
                                              'ssl_mt')
            t0 = time.perf_counter()
            proxy = pixelssl_tpu_torch.run_script(
                config, sseg, sseg.SemanticSegmentationProxy, device='cuda',
                cli_override=False)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            records = chip_smoke.read_records(config)
            del proxy
        chip_smoke.no_workers_left('[{0}]'.format(method))
        train = [r for r in records if r['phase'] == 'train']
        for r in train:
            if not all(math.isfinite(v) for k, v in r.items()
                       if k.endswith('_loss')):
                raise AssertionError('non-finite loss: {0}'.format(r))
        epochs = [r for r in records if r['phase'] == 'epoch_summary']
        run = {
            'method': method, 'wall_s': wall_s,
            'first_wait_ms': 1e3 * train[0]['data_time'],
            'epoch_ms_per_iter': [1e3 * r['wall_s'] / r['iters']
                                  for r in epochs],
            'samples_per_sec': [r['samples_per_sec'] for r in epochs],
            'wait_ms': [[1e3 * t['data_time'] for t in train
                         if t['epoch'] == r['epoch']] for r in epochs],
        }
        runs.append(run)
        print('[{0}] run_script {1:.1f} s; first wait {2:.1f} ms; epochs: '
              '{3}; waits ms: {4}'.format(
                  method, wall_s, run['first_wait_ms'], '  '.join(
                      '{0:.1f} ms an iteration, {1:.2f} samples/s'.format(
                          t, s) for t, s in zip(run['epoch_ms_per_iter'],
                                                run['samples_per_sec'])),
                  ' | '.join(' '.join('{0:.1f}'.format(w) for w in ws)
                             for ws in run['wait_ms'])), flush=True)
    print(json.dumps({'loader_ab': runs}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
