"""The port's Gaussian blur against the JAX package's.

``pixelssl_tpu_torch.ops.blur.gaussian_blur_fused`` runs its plain version
(``Bh @ X @ Bw^T``) on CPU tensors; it is held against the JAX einsum branch
(``use_pallas=False``), the way tests/test_ops.py runs the JAX function on
the CPU (tests/test_torch_blur_kernel.py holds the CUDA kernel against the
plain version). Tolerance: atol 1e-5, float32 sums of at most 129 products
of O(1) values.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pixelssl_tpu.ops import blur_pallas as jax_blur
from pixelssl_tpu_torch.ops import blur as torch_blur

# the packages' __init__ re-export the function under the module's name
jax_gb = importlib.import_module('pixelssl_tpu.nn.module.gaussian_blur')
torch_gb = importlib.import_module('pixelssl_tpu_torch.nn.module.gaussian_blur')

# (N, H, W, k): k//2 >= H in the fourth and fifth cases and at 2x2, where
# the reflect boundary is applied more than once. After the first four come
# the shapes that tests/test_torch_blur_kernel.py and chip_smoke.py hold the
# CUDA kernel to (the GCT step's at 321 px, the edges of the kernel's tiles,
# the 513 px recipe's widest blur, k = 1), so the JAX package backs each
SHAPES = [(2, 33, 33, 5), (2, 33, 33, 9), (2, 48, 64, 17), (3, 20, 20, 41),
          (2, 20, 24, 81), (8, 321, 321, 21), (4, 321, 321, 41),
          (4, 321, 321, 81), (3, 200, 321, 41), (2, 2, 2, 5),
          (1, 65, 33, 21), (1, 33, 65, 9), (2, 20, 70, 11), (3, 97, 40, 15),
          (2, 513, 513, 129), (2, 33, 33, 1)]


def _maps(n, h, w, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, 1)).astype(np.float32)


@pytest.mark.parametrize('k', [3, 5, 9, 21, 41, 81, 129])
def test_gaussian_kernel_1d_equal(k):
    np.testing.assert_array_equal(torch_gb.gaussian_kernel_1d(k),
                                  jax_gb.gaussian_kernel_1d(k))


@pytest.mark.parametrize('size,k', [(33, 5), (20, 41), (7, 129), (64, 17)])
def test_blur_matrix_equal(size, k):
    np.testing.assert_array_equal(torch_blur._blur_matrix(size, k),
                                  jax_blur._blur_matrix(size, k))


@pytest.mark.parametrize('n,h,w,k', SHAPES)
def test_fused_blur_matches_jax(n, h, w, k):
    x = _maps(n, h, w, seed=h * 1000 + k)
    ours = torch_blur.gaussian_blur_fused(torch.from_numpy(x), k).numpy()
    theirs = np.asarray(jax_blur.gaussian_blur_fused(jnp.asarray(x), k,
                                                     use_pallas=False))
    assert ours.shape == (n, h, w, 1) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=1e-5)


@pytest.mark.parametrize('n,h,w,k', [s for s in SHAPES if s[3] // 2 < s[1]])
def test_conv_blur_matches_jax_and_fused(n, h, w, k):
    """The conv form exists only where reflect padding reaches (k//2 < H)."""
    x = _maps(n, h, w, seed=k)
    ours = torch_gb.gaussian_blur(torch.from_numpy(x), k).numpy()
    theirs = np.asarray(jax_gb.gaussian_blur(jnp.asarray(x), k))
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    fused = torch_blur.gaussian_blur_fused(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(ours, fused, atol=1e-5)


# kernel sizes past the kernel's former 129-tap limit (fault F9): GCT's
# dilation blur at 640 px (k=odd(640/4)), and a map far smaller than half
# the kernel, whose window folds over it several times
@pytest.mark.parametrize('n,h,w,k', [(2, 40, 48, 129), (1, 12, 10, 161),
                                     (2, 640, 640, 161)])
def test_fused_blur_matches_jax_past_129_taps(n, h, w, k):
    x = _maps(n, h, w, seed=k)
    ref = np.asarray(jax_blur.gaussian_blur_fused(jnp.asarray(x), k,
                                                  use_pallas=False))
    out = torch_blur.gaussian_blur_fused(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, to follow the
    dispatch of a CUDA call on a host without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize('k', [161, 257, 1025])
def test_cuda_call_past_129_taps_reaches_the_kernel(k, monkeypatch):
    """A CUDA tensor goes to ``blur_kernel`` whatever k is, never to the
    plain version (F9: the kernel takes every odd k)."""
    calls = []

    def kernel(x, kernel_size):
        calls.append((tuple(x.shape), kernel_size))
        return torch.zeros(x.shape)

    def plain(x, kernel_size):
        raise AssertionError('the plain version got a CUDA tensor')

    monkeypatch.setattr(torch_blur, 'blur_kernel', kernel)
    monkeypatch.setattr(torch_blur, 'blur_plain', plain)
    x = torch.zeros(2, 64, 64, 1).as_subclass(_CudaTyped)
    out = torch_blur.gaussian_blur_fused(x, k)
    assert calls == [((2, 64, 64), k)] and out.shape == (2, 64, 64, 1)
