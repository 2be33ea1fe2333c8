"""Fused separable Gaussian blur (counterpart of
``pixelssl_tpu/ops/blur_pallas.py``).

``gaussian_blur_fused`` blurs [N,H,W,1] maps with the reference's taps and
the reflect boundary, ``out[n] = Bh @ X[n] @ Bw^T``, computed in float32:

* on a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/blur.cu`` (the port of the TPU kernel ``_blur_kernel``), built by
  ``nvcc`` for ``sm_90a`` into the package's ``build/`` directory the first
  time it is needed, and bound through ctypes. One call runs two passes of
  one-dimensional reflected convolutions, each computing its outputs once
  from a shared-memory strip that holds the halo: down the columns into a
  scratch map V (it stays in the card's L2), then along the rows of V into
  the output. A call's least time is a microsecond or two at the GCT
  shapes (each map read and written once, 2k multiply-adds per pixel);
  the kernel's time goes mostly to copying the strips and to its two
  launches, not to the arithmetic;
* on a CPU tensor it runs the plain version ``blur_plain``: the two dense
  banded products from ``_blur_matrix``, as the JAX einsum branch does.

Inside a ``parallel.spatial.sharded`` block (``--spatial-train``) the map
is this rank's rows [r0, r1) of the context's height: the call fetches the
strip of global rows [r0 - R, r1 + R), R = k // 2, a row outside the map
reflected as ``_blur_matrix`` folds it (``spatial.REFLECT``), blurs the
strip with the same kernel (or ``blur_plain``) and keeps its middle rows;
the reflection at the strip's own edges reaches only the rows it drops.
That costs 2R rows a shard, and one launch a call as before.

The kernel takes every odd kernel size, as the JAX function does: its
shared-memory strip is sized from k at launch, and a k past 512 taps runs
in chunks of them. Nothing falls back: a CUDA tensor that meets a failed
build or launch raises. ``launches`` counts the kernel's launches (one
call, two passes). A call made while a CUDA graph captures launches
nothing: it counts in ``captured`` instead, and the graph's owner adds the
calls it captured to ``launches`` on every replay
(``ssl_algorithm.ssl_base.CapturedStep``), so that the count stays one a
launch on every path.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..nn.module.gaussian_blur import gaussian_kernel_1d
from ..parallel import spatial

_MAX_GRID_Z = 65535

launches = 0
captured = 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, 'csrc', 'blur.cu')
_BUILD_DIR = os.path.join(_PKG_DIR, 'build')
_lib = None


@functools.lru_cache(maxsize=None)
def _blur_matrix(size, kernel_size):
    """[size, size] matrix equal to reflect padding + the 1-D blur.

    The boundary is ``jnp.pad(mode='reflect')``'s, where the edge is not
    repeated (-1 -> 1, size -> size-2), applied again until the index is
    inside the map; the taps' own folding (``_reflect_idx``) repeats the
    edge instead. The two conventions meet in this one function."""
    g = gaussian_kernel_1d(kernel_size)
    k = kernel_size
    half = k // 2
    m = np.zeros((size, size), dtype=np.float32)
    for i in range(size):
        for t in range(k):
            j = i - half + t
            while j < 0 or j >= size:
                if j < 0:
                    j = -j
                if j >= size:
                    j = 2 * (size - 1) - j
            m[i, j] += g[t]
    return m


def blur_plain(x, kernel_size):
    """Plain PyTorch version of the kernel on [N,H,W] float32:
    ``Bh @ X @ Bw^T`` with the dense banded matrices."""
    _, h, w = x.shape
    k = int(kernel_size)
    bh = torch.from_numpy(_blur_matrix(h, k)).to(x.device)
    bw = torch.from_numpy(_blur_matrix(w, k)).to(x.device)
    return torch.matmul(torch.matmul(bh, x), bw.t())


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                           'to build csrc/blur.cu')
    return found


def compile_source(src=_SRC):
    """Compile a blur source for sm_90a into ``build/`` (once per source
    content); returns the path of the shared library."""
    with open(src, 'rb') as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, 'libpixelssl_blur_{0}.so'.format(digest))
    if not os.path.exists(so):
        nvcc = _nvcc()
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                 '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                 '-o', tmp, src], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed to build {0}:\n{1}{2}'.format(
                    src, proc.stdout, proc.stderr))
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def build():
    """Compile ``csrc/blur.cu`` and load it; returns the ctypes library."""
    global _lib
    if _lib is not None:
        return _lib
    so = compile_source()
    lib = ctypes.CDLL(so)
    lib.pixelssl_blur_band.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.pixelssl_blur_band.restype = ctypes.c_int
    lib.pixelssl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pixelssl_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


@functools.lru_cache(maxsize=None)
def _device_taps(kernel_size, device):
    return torch.from_numpy(gaussian_kernel_1d(kernel_size)).to(device)


def blur_kernel(x, kernel_size):
    """Launch ``csrc/blur.cu`` on a contiguous [N,H,W] float32 CUDA tensor,
    on the current stream; returns a new [N,H,W] tensor."""
    global launches, captured
    k = int(kernel_size)
    if not x.is_cuda:
        raise ValueError('blur_kernel needs a CUDA tensor')
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError('blur_kernel needs a contiguous [N,H,W] float32 '
                         'tensor, got {0} {1}'.format(x.dtype, tuple(x.shape)))
    n, h, w = x.shape
    if k % 2 != 1 or k < 1:
        raise ValueError('kernel_size must be odd and positive, got {0}'
                         .format(k))
    if h < 2 or w < 2 or n > _MAX_GRID_Z:
        raise ValueError('blur_kernel needs H, W >= 2 and N <= {0}, got {1}'
                         .format(_MAX_GRID_Z, tuple(x.shape)))
    lib = build()
    taps = _device_taps(k, x.device)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.pixelssl_blur_band(x.data_ptr(), out.data_ptr(),
                                  scratch.data_ptr(), taps.data_ptr(), n, h,
                                  w, k, stream)
    if code != 0:
        raise RuntimeError('blur kernel launch failed: {0}'.format(
            lib.pixelssl_cuda_error_string(code).decode()))
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


def gaussian_blur_fused(x, kernel_size):
    """Blur [N,H,W,1] maps with the reference's taps; returns x's dtype,
    computed in float32. CUDA tensors go through the kernel, CPU tensors
    through ``blur_plain``."""
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError('fused blur is specialized for single-channel maps')
    rows = spatial.active()
    if rows is not None:
        return _blur_rows(x, int(kernel_size), rows)
    return _blur_local(x, kernel_size)


def _blur_local(x, kernel_size):
    xf = x[..., 0].float().contiguous()
    if xf.is_cuda:
        out = blur_kernel(xf, kernel_size)
    elif xf.device.type == 'cpu':
        out = blur_plain(xf, kernel_size)
    else:
        raise ValueError('gaussian_blur_fused: unsupported device {0}'
                         .format(xf.device))
    return out[..., None].to(x.dtype)


def strip_rows(h, n, kernel_size):
    """For each of ``n`` spatial ranks, the global rows [r0 - R, r1 + R)
    of the strip it blurs, R = k // 2."""
    half = int(kernel_size) // 2
    rows = []
    for q in range(n):
        r0, r1 = spatial.row_range(h, n, q)
        rows.append((r0 - half, r1 + half) if r1 > r0 else (r0, r0))
    return rows


def _blur_rows(x, kernel_size, rows):
    """``gaussian_blur_fused`` of this rank's rows of [N,H,W,1] maps of the
    context's height, through the strip."""
    mesh, h = rows.mesh, rows.height
    strip = spatial.fetch_rows(x, h, strip_rows(h, mesh.n_spatial,
                                                kernel_size),
                               mesh, spatial.REFLECT, dim=1)
    if x.shape[1] == 0:
        return x
    half = kernel_size // 2
    return _blur_local(strip, kernel_size)[:, half:half + x.shape[1]]
