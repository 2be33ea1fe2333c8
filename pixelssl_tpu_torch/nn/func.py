"""Shared tensor utilities (counterpart of ``pixelssl_tpu/nn/func.py``;
reference pixelssl/nn/func.py:12-62)."""

import math


def sigmoid_rampup(current, rampup_length):
    """Exponential ramp-up e^{-5(1-t)^2} (reference nn/func.py:12-21), on
    Python numbers; 1.0 when ``rampup_length`` is 0."""
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), float(rampup_length))
    phase = 1.0 - current / rampup_length
    return float(math.exp(-5.0 * phase * phase))


def split_tensor_tuple(ttuple, start, end):
    """Slice each tensor of a tuple along the batch dim (nn/func.py:24-51):
    splits the labeled-first two-stream batch."""
    return tuple(t[start:end] for t in ttuple)


def count_params(module):
    return sum(p.numel() for p in module.parameters())
