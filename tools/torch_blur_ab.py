#!/usr/bin/env python3
"""Time sources of the port's blur kernel against each other on one card.

    python3 tools/torch_blur_ab.py SRC.cu [SRC.cu ...] [--v2 SRC.cu ...]

Each source is built like ``pixelssl_tpu_torch/csrc/blur.cu``
(``ops.blur.compile_source``) and called through its C entry
``pixelssl_blur_band``; a source given with ``--v2`` has the entry of kernel
v2 (no scratch map), e.g. ``git show ae12e6b:pixelssl_tpu_torch/csrc/blur.cu``.
At each of ``chip_smoke.py``'s blur shapes the sources are timed in turns,
in order and then in reverse order, as device time per call
(``chip_smoke.graph_ms``: calls captured in one CUDA graph, its replay timed
between events), and held against ``blur_plain``. One line per shape and
source: max abs error and both times; then one JSON line with every row.
It needs a CUDA card and nvcc, imports no JAX, and builds into the port's
``build/`` directory.
"""

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('sources', nargs='*', help='sources with a scratch map')
    parser.add_argument('--v2', action='append', default=[],
                        help='sources with kernel v2\'s entry (no scratch)')
    opts = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke
    from pixelssl_tpu_torch.ops import blur

    if not torch.cuda.is_available():
        print('torch_blur_ab: CUDA is not available', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    entries = []
    for src, scratch in ([(s, True) for s in opts.sources] +
                         [(s, False) for s in opts.v2]):
        lib = ctypes.CDLL(blur.compile_source(os.path.abspath(src)))
        fn = lib.pixelssl_blur_band
        fn.argtypes = ([ctypes.c_void_p] * (4 if scratch else 3) +
                       [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries.append((src, scratch, fn))

    def call(fn, scratch, x, k):
        taps = blur._device_taps(k, x.device)
        out = torch.empty_like(x)
        ptrs = [x.data_ptr(), out.data_ptr()]
        if scratch:
            v = torch.empty_like(x)
            ptrs.append(v.data_ptr())
        code = fn(*ptrs, taps.data_ptr(), *x.shape, k,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError('launch failed with CUDA error {0}'.format(code))
        return out

    rng = np.random.default_rng(0)
    print(chip_smoke.phase_device(), flush=True)
    rows = []
    for n, h, w, k in chip_smoke.MAIN_PATH_CASES + chip_smoke.EXTRA_CASES:
        x = torch.from_numpy(rng.standard_normal((n, h, w)).astype(
            np.float32)).cuda()
        ref = blur.blur_plain(x, k)
        times = {src: [] for src, _, _ in entries}
        for order in (entries, entries[::-1]):
            for src, scratch, fn in order:
                times[src].append(chip_smoke.graph_ms(
                    lambda: call(fn, scratch, x, k)))
        for src, scratch, fn in entries:
            err = float((call(fn, scratch, x, k) - ref).abs().max())
            row = {'shape': [n, h, w], 'k': k, 'source': src,
                   'max_abs_err': err, 'device_ms': times[src]}
            rows.append(row)
            print('[{0},{1},{2}] k={3} {4}: max_abs_err {5:.3g}  device_ms '
                  '{6}'.format(n, h, w, k, src, err, ' '.join(
                      '{0:.5f}'.format(t) for t in times[src])), flush=True)
    print(json.dumps({'rows': rows}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
