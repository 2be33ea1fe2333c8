"""The blur kernel's wrapper, and the CUDA kernel against its plain version.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a host with a card and ``nvcc``:

    python -m pytest --noconftest tests/test_torch_blur_kernel.py -q

Without a card the kernel tests skip. Tolerance: atol 1e-5, float32 sums of
Gaussian-weighted O(1) values (weights summing to 1), in another order
than cuBLAS's.
"""

import numpy as np
import pytest
import torch

from pixelssl_tpu_torch.ops import blur as torch_blur

# (N, H, W, k): small maps, one with k//2 >= H (repeated reflection), and
# the GCT step's shapes at 321 px; then the edges of the kernel's tiles
# (pass V: 32 columns by 64 rows, pass H: 32 rows by 64 columns): the
# smallest map, N = 1 with one row and one column past a tile, maps wider
# and taller than square, the 513 px recipe's widest blur, and k = 1; then
# k past 129 taps: GCT's dilation blur at 640 px, k = 257 at 1025 px, a
# map folded over several times, 513 taps (a strip above 48 KB of shared
# memory) and 1025 (three chunks of taps)
SHAPES = [(2, 33, 33, 5), (2, 48, 64, 17), (3, 20, 20, 41), (2, 20, 24, 81),
          (8, 321, 321, 21), (4, 321, 321, 41), (4, 321, 321, 81),
          (2, 2, 2, 5), (1, 65, 33, 21), (1, 33, 65, 9), (2, 20, 70, 11),
          (3, 97, 40, 15), (2, 513, 513, 129), (2, 33, 33, 1),
          (2, 640, 640, 161), (1, 1025, 1025, 257), (2, 40, 48, 129),
          (1, 1025, 1025, 513), (1, 1025, 1025, 1025)]


def _maps(n, h, w, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, 1)).astype(np.float32)


def test_fused_blur_keeps_dtype():
    x = torch.from_numpy(_maps(1, 16, 16, 0)).to(torch.float64)
    assert torch_blur.gaussian_blur_fused(x, 5).dtype == torch.float64


def test_fused_blur_cpu_does_not_count_launches():
    before = torch_blur.launches
    torch_blur.gaussian_blur_fused(torch.from_numpy(_maps(1, 16, 16, 1)), 5)
    assert torch_blur.launches == before


def test_blur_kernel_rejects_cpu_tensor():
    with pytest.raises(ValueError):
        torch_blur.blur_kernel(torch.zeros(1, 8, 8), 5)


@pytest.mark.parametrize('n,h,w,k', SHAPES)
def test_blur_kernel_matches_plain_on_card(n, h, w, k):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card and nvcc (csrc/blur.cu)')
    x = torch.from_numpy(_maps(n, h, w, seed=k)[..., 0]).cuda()
    before = torch_blur.launches
    out = torch_blur.blur_kernel(x, k)
    torch.cuda.synchronize()
    assert torch_blur.launches == before + 1
    ref = torch_blur.blur_plain(x, k)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_fused_blur_on_card_matches_cpu():
    """The public [N,H,W,1] entry point: CUDA tensors through the kernel,
    CPU tensors through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card and nvcc (csrc/blur.cu)')
    x = torch.from_numpy(_maps(4, 96, 96, seed=7))
    before = torch_blur.launches
    on_card = torch_blur.gaussian_blur_fused(x.cuda(), 13)
    assert torch_blur.launches == before + 1
    assert on_card.shape == (4, 96, 96, 1) and on_card.dtype == torch.float32
    torch.testing.assert_close(on_card.cpu(),
                               torch_blur.gaussian_blur_fused(x, 13),
                               atol=1e-5, rtol=0)
