"""Input-perturbation Gaussian noise of Mean Teacher (counterpart of
``pixelssl_tpu/nn/module/gaussian_noise.py``; reference
pixelssl/nn/module/gaussian_noise.py:7-40).

Per call, one noise std is drawn uniformly from [0, std]; each sample is
min-max normalised to [0, 1] over all its non-batch axes, noised, clipped
to [0, 1] and denormalised. The randomness comes from an explicit
``torch.Generator`` on the tensor's device; ``apply_noise`` is the
deterministic rest, so a test can feed it draws made elsewhere. Inside a
``parallel.spatial.sharded`` block (``--spatial-train``) a sample's rows
lie on several ranks: its minimum and maximum are taken over all of them,
and the draw is made at the global batch's shape (``global_draw``).
"""

import torch

from ...parallel import spatial


def apply_noise(x, call_std, noise):
    """Perturb ``x`` with ``call_std * noise`` in its per-sample [0, 1]
    range; ``noise`` is a standard normal draw of ``x``'s shape."""
    imax = spatial.sample_max(x)
    imin = spatial.sample_min(x)
    scale = imax - imin + 1e-9
    y = (x - imin) / scale
    y = torch.clamp(y + (call_std * noise).to(x.dtype), 0.0, 1.0)
    return y * scale + imin


def gaussian_noise(x, std, generator, global_draw=None):
    """MT-style Gaussian noise on a batch; identity for ``std`` None or
    <= 0 (reference gaussian_noise.py:15-19). ``global_draw(x, draw)``
    (``SSLBase._global_draw``) makes the noise where ``x`` is a part of
    the batch that ``draw(shape)`` draws for."""
    if std is None or std <= 0:
        return x
    call_std = torch.rand((), generator=generator, device=x.device) * std

    def draw(shape):
        return torch.randn(shape, generator=generator, device=x.device,
                           dtype=torch.float32)

    noise = draw(x.shape) if global_draw is None else global_draw(x, draw)
    return apply_noise(x, call_std, noise)
