"""Image files and the PIL image operations of the VOC input path, in numpy
(the port's stand-in for the Pillow calls of ``pixelssl_tpu/tasks/sseg/
data.py``, which the port does not import).

Images are uint8 [H,W,3] arrays, label maps uint8 [H,W] arrays; sizes are
given as PIL gives them, ``(width, height)``.

* ``read_rgb``: a JPEG through the decoder of ``csrc/augment.cpp``
  (``nn/native.py``), whose arithmetic is libjpeg's, so the pixels equal
  ``Image.open(path).convert('RGB')``'s;
* ``read_label``: an 8-bit gray or palette PNG, the raw values (the
  palette index, as ``np.asarray(Image.open(png))`` gives them), read with
  ``zlib``; ``read_png`` also reads 8-bit RGB;
* ``write_png``: an 8-bit gray or RGB PNG (``--visualize``; the JAX
  package saves through ``Image.fromarray(...).save``): one IDAT of rows
  with filter 0, ``zlib`` and ``zlib.crc32``. The pixels are Pillow's; the
  bytes may differ, since the compression differs;
* ``resize_bilinear`` and ``resize_nearest``: ``Image.resize`` with
  ``BILINEAR`` and ``NEAREST``. PIL's bilinear resize is antialiased (the
  triangle filter's support widens by the scale factor when it shrinks)
  and separable: a horizontal pass into uint8, then a vertical one, each
  with 22-bit fixed-point coefficients. Both are computed here with PIL's
  coefficients and integer sums, so the results are equal;
* ``pad`` (``ImageOps.expand`` right and bottom, with a fill), ``crop``
  and ``hflip``.

``window`` restricts a resize to a box of its output: the values there
are those of the whole resize, at a fraction of its cost.
"""

import struct
import zlib

import numpy as np

from . import native

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_PRECISION_BITS = 32 - 8 - 2  # PIL Resample.c, 8 bits a channel


def read_rgb(path):
    """uint8 [H,W,3] RGB of a JPEG file."""
    return native.decode_jpeg_rgb(path)


def read_label(path):
    """uint8 [H,W] raw values of an 8-bit gray or palette PNG that is not
    interlaced (VOC ``SegmentationClassAug``); any other PNG raises."""
    return _read_png(path, (0, 3), 'gray or palette PNG label maps')


def read_png(path):
    """uint8 [H,W] (gray or palette) or [H,W,3] (RGB) of an 8-bit PNG that
    is not interlaced, as ``write_png`` and Pillow write them; any other
    PNG raises."""
    return _read_png(path, (0, 2, 3), 'gray, RGB or palette PNGs')


_CHANNELS = {0: 1, 2: 3, 3: 1}


def _read_png(path, colors, what):
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError('not a PNG file: {0}'.format(path))
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError('truncated PNG chunk in {0}'.format(path))
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body[:13])
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
        pos += 12 + length
    if header is None:
        raise ValueError('PNG without IHDR: {0}'.format(path))
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in colors or interlace != 0:
        raise ValueError(
            'only 8-bit {0} that are not interlaced are supported (bit '
            'depth {1}, color type {2}, interlace {3}): {4}'.format(
                what, depth, color, interlace, path))
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError('bad PNG image data in {0}'.format(path))
    out = _unfilter(raw.reshape(h, w * bpp + 1), path, bpp)
    return out.reshape(h, w, 3) if bpp == 3 else out


def write_png(path, img):
    """``img``, uint8 [H,W] (gray, color type 0) or [H,W,3] (RGB, color
    type 2), as an 8-bit PNG at ``path``."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError('write_png takes uint8 [H,W] or [H,W,3], got {0} '
                         '{1}'.format(img.dtype, img.shape))
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)  # filter 0 a row
    rows[:, 1:] = img.reshape(h, -1)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))

    header = struct.pack('>IIBBBBB', w, h, 8, 0 if img.ndim == 2 else 2,
                         0, 0, 0)
    with open(path, 'wb') as f:
        f.write(_PNG_SIGNATURE + chunk(b'IHDR', header) +
                chunk(b'IDAT', zlib.compress(rows.tobytes())) +
                chunk(b'IEND', b''))


def _unfilter(rows, path, bpp=1):
    """PNG's per-row filters undone, ``bpp`` bytes a pixel. Runs of rows
    with the same filter go at once where the filter allows: none, sub (a
    running sum along the row, a pixel's bytes apart) and up (a running sum
    down the rows), modulo 256; average and Paeth need each byte's left
    neighbour, byte by byte."""
    h, n = rows.shape[0], rows.shape[1] - 1
    kinds, data = rows[:, 0], rows[:, 1:]
    out = np.zeros((h, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    y = 0
    while y < h:
        kind = kinds[y]
        end = y + 1
        while end < h and kinds[end] == kind and kind in (0, 1, 2):
            end += 1
        if kind == 0:
            out[y:end] = data[y:end]
        elif kind == 1:
            out[y:end] = np.add.accumulate(
                data[y:end].reshape(end - y, n // bpp, bpp), axis=1,
                dtype=np.uint8).reshape(end - y, n)
        elif kind == 2:
            out[y:end] = np.add.accumulate(
                np.vstack([prev[None], data[y:end]]), axis=0,
                dtype=np.uint8)[1:]
        elif kind in (3, 4):
            up_row, vals = prev.tolist(), data[y].tolist()
            for x in range(n):
                left = vals[x - bpp] if x >= bpp else 0
                up = up_row[x]
                up_left = up_row[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
                    pred = left if pa <= pb and pa <= pc else (
                        up if pb <= pc else up_left)
                vals[x] = (vals[x] + pred) & 0xFF
            out[y] = vals
        else:
            raise ValueError('bad PNG filter type {0} in {1}'.format(
                kind, path))
        prev = out[end - 1]
        y = end
    return out


def _bilinear_coeffs(in_size, out_size, start, stop):
    """PIL's ``precompute_coeffs`` for the triangle filter (support 1) and
    ``normalize_coeffs_8bpc``, for outputs ``start`` to ``stop``, in PIL's
    order of float operations: input indices and int64 fixed-point weights,
    both [n, taps]."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(start, stop) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    inside = x[None] < xmax[:, None]
    w = np.maximum(1.0 - np.abs(
        (x[None] + xmin[:, None] - center[:, None] + 0.5) * ss), 0.0)
    w = np.where(inside, w, 0.0)
    total = np.zeros(len(center))
    for t in range(ksize):  # summed tap by tap, as PIL does
        total += w[:, t]
    w = np.where(total[:, None] != 0.0,
                 w / np.where(total != 0.0, total, 1.0)[:, None], w)
    fixed = np.trunc(w * (1 << _PRECISION_BITS) +
                     np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    # taps past the filter's end read its first input, with weight 0
    idx = np.where(inside, x[None] + xmin[:, None], xmin[:, None])
    return idx, fixed


def _resample(img, axis, idx, fixed):
    """One of PIL's two passes along ``axis`` (0 rows, 1 columns) of a
    uint8 array: each output the sum of its taps' uint8 values times their
    22-bit weights, rounded and clamped to uint8. The sums are exact in
    int32: the weights of an output add up to about 2**22, times 255."""
    shape = [1] * img.ndim
    shape[axis] = len(fixed)
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(fixed.shape[1]):
        acc = acc + np.take(img, idx[:, t], axis=axis) * \
            fixed[:, t].astype(np.int32).reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img, size, window=None):
    """``Image.resize(size, Image.BILINEAR)`` of a uint8 [H,W] or [H,W,C]
    array; ``size = (ow, oh)``. ``window = (x0, y0, x1, y1)`` computes only
    that box of the output (clipped to it)."""
    ow, oh = size
    h, w = img.shape[:2]
    x0, y0, x1, y1 = window if window is not None else (0, 0, ow, oh)
    x1, y1 = min(x1, ow), min(y1, oh)
    # PIL skips a pass whose size does not change; the horizontal pass
    # covers only the source rows that the vertical one reads
    rows = _bilinear_coeffs(h, oh, y0, y1) if oh != h else None
    r0, r1 = ((int(rows[0].min()), int(rows[0].max()) + 1) if rows else
              (y0, y1))
    img = img[r0:r1]
    if ow != w:
        img = _resample(img, 1, *_bilinear_coeffs(w, ow, x0, x1))
    else:
        img = img[:, x0:x1]
    if rows is None:
        return np.ascontiguousarray(img)
    return _resample(img, 0, rows[0] - r0, rows[1])


def _nearest_index(in_size, out_size):
    """PIL's ``ImagingScaleAffine`` source index of each output: the
    position ``scale / 2 + i * scale`` accumulated by repeated addition in
    double precision, truncated."""
    scale = in_size / out_size
    steps = np.full(out_size, scale)
    steps[0] = scale * 0.5
    return np.minimum(np.cumsum(steps).astype(np.int64), in_size - 1)


def resize_nearest(img, size, window=None):
    """``Image.resize(size, Image.NEAREST)`` of an [H,W] or [H,W,C] array;
    ``window`` as for ``resize_bilinear``."""
    ow, oh = size
    h, w = img.shape[:2]
    x0, y0, x1, y1 = window if window is not None else (0, 0, ow, oh)
    x1, y1 = min(x1, ow), min(y1, oh)
    rows = _nearest_index(h, oh)[y0:y1]
    cols = _nearest_index(w, ow)[x0:x1]
    return np.ascontiguousarray(img[rows[:, None], cols[None, :]])


def pad(img, right, bottom, fill=0):
    """``ImageOps.expand(img, border=(0, 0, right, bottom), fill=fill)``."""
    if not right and not bottom:
        return img
    pads = [(0, bottom), (0, right)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pads, mode='constant', constant_values=fill)


def crop(img, box):
    """``img.crop((x0, y0, x1, y1))`` inside the image."""
    x0, y0, x1, y1 = box
    return img[y0:y1, x0:x1]


def hflip(img):
    """``img.transpose(Image.FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(img[:, ::-1])
