"""CutMix box masks on the device (counterpart of
``pixelssl_tpu/ops/boxmask.py``; reference
pixelssl/ssl_algorithm/ssl_cutmix.py:470-547, adapted upstream from
Britefury/cutmix-semisup-seg).

The one configuration the reference uses: one box per mask, its area a
proportion drawn from ``prop_range``, a random aspect ratio from a
log-uniform split (``y = p ** u``, ``x = p / y``), the box inside the
bounds, and the mask inverted (1 inside the box). ``box_uniforms`` draws
the uniforms with a ``torch.Generator`` and ``box_masks_from_uniforms``
rasterises them with ``arange`` comparisons, both on the generator's
device; ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

import torch


def box_uniforms(generator, n, prop_range):
    """The draws of ``n`` masks: area proportions [n] in ``prop_range``,
    aspect uniforms [n] and position uniforms [n, 2] in [0, 1)."""
    device = generator.device
    p0, p1 = float(prop_range[0]), float(prop_range[1])
    props = p0 + (p1 - p0) * torch.rand(n, generator=generator,
                                        device=device)
    aspect = torch.rand(n, generator=generator, device=device)
    pos = torch.rand(n, 2, generator=generator, device=device)
    return props, aspect, pos


def box_masks_from_uniforms(props, aspect, pos, shape):
    """Rasterise the boxes of ``box_uniforms``'s draws at spatial ``shape``
    (h, w): [n, 1, h, w] float32, 1 inside the box and 0 outside."""
    h, w = shape
    safe = props.clamp(min=1e-12)
    y_props = torch.exp(aspect * torch.log(safe))
    x_props = safe / y_props
    zero = props == 0.0
    y_props = torch.where(zero, torch.zeros_like(y_props), y_props)
    x_props = torch.where(zero, torch.zeros_like(x_props), x_props)

    sizes_y = torch.round(y_props * h)
    sizes_x = torch.round(x_props * w)
    y0 = torch.round((h - sizes_y) * pos[:, 0])
    x0 = torch.round((w - sizes_x) * pos[:, 1])
    y1, x1 = y0 + sizes_y, x0 + sizes_x

    rows = torch.arange(h, dtype=torch.float32, device=props.device)
    cols = torch.arange(w, dtype=torch.float32, device=props.device)
    in_rows = (rows >= y0[:, None]) & (rows < y1[:, None])    # [n, h]
    in_cols = (cols >= x0[:, None]) & (cols < x1[:, None])    # [n, w]
    return (in_rows[:, :, None] & in_cols[:, None, :]).float()[:, None]


def box_masks(generator, n, shape, prop_range):
    """``n`` box masks of spatial ``shape``: [n, 1, H, W] float32, 1 inside
    the box."""
    return box_masks_from_uniforms(*box_uniforms(generator, n, prop_range),
                                   shape)
