"""Fixed-kernel Gaussian blur as a plain function (counterpart of
``pixelssl_tpu/nn/module/gaussian_blur.py``).

The taps are the reference's recipe (sigma = 0.3*((k-1)*0.5-1)+0.8, the
response of scipy's truncated Gaussian filter to an impulse at the centre of
a length-k window, scipy's reflect boundary folded in; reference
pixelssl/nn/module/gaussian_blur.py:56-64), computed in float64 and cast to
float32 as the JAX package does. ``gaussian_blur`` is the reflect-pad
separable convolution form, kept as a second plain reference for the banded
form in ``ops/blur.py``.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _reflect_idx(i, n):
    """scipy 'reflect' boundary, where the edge repeats:
    (d c b a | a b c d | d c b a), so -1 -> 0."""
    while i < 0 or i >= n:
        if i < 0:
            i = -i - 1
        if i >= n:
            i = 2 * n - i - 1
    return i


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(kernel_size, truncate=4.0):
    """[k] float32 taps: scipy.ndimage.gaussian_filter's response to an
    impulse at the centre of a length-k window, with scipy's reflect
    folding (for small k the truncated Gaussian is wider than the window
    and the reflected tails matter)."""
    if kernel_size % 2 != 1:
        raise ValueError('kernel_size must be odd, got {0}'.format(kernel_size))
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    center = kernel_size // 2
    w = np.zeros(kernel_size, dtype=np.float64)
    for i in range(kernel_size):
        for d in range(-radius, radius + 1):
            if _reflect_idx(i + d, kernel_size) == center:
                w[i] += g[d + radius]
    return w.astype(np.float32)


def gaussian_blur(x, kernel_size):
    """Blur a [N,H,W,C] tensor per channel: reflect padding (the edge is not
    repeated, as ``nn.ReflectionPad2d``), then a 1-D depthwise convolution
    along H and one along W, in float32. Needs ``kernel_size // 2`` < H, W:
    reflect padding cannot reach further than that."""
    if x.dim() != 4:
        raise ValueError('gaussian_blur requires a 4D NHWC tensor')
    k = int(kernel_size)
    half = k // 2
    dtype = x.dtype
    c = x.shape[-1]
    taps = torch.from_numpy(gaussian_kernel_1d(k)).to(x.device)
    y = x.permute(0, 3, 1, 2).float()
    y = F.conv2d(F.pad(y, (0, 0, half, half), mode='reflect'),
                 taps.view(1, 1, k, 1).repeat(c, 1, 1, 1), groups=c)
    y = F.conv2d(F.pad(y, (half, half, 0, 0), mode='reflect'),
                 taps.view(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)
    return y.permute(0, 2, 3, 1).to(dtype)
