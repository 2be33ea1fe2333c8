"""``nn/imageio.py`` and the decoders of ``csrc/augment.cpp`` against
Pillow, which the JAX package's VOC path calls.

Every comparison is exact: the JPEG decoder follows libjpeg's integer
arithmetic (the accurate IDCT, fancy chroma upsampling, the fixed-point
YCbCr->RGB), which Pillow's libjpeg-turbo computes too, and the resizes
use PIL's own coefficients and integer sums.
"""

import os
import zlib

import numpy as np
import pytest

from PIL import Image

from pixelssl_tpu_torch.nn import imageio, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'data', 'voc_fixture', 'VOC2012')


def _smooth(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize('save', [
    dict(), dict(quality=95), dict(quality=30), dict(subsampling=0),
    dict(subsampling=1), dict(optimize=True), dict(restart_marker_blocks=5),
    dict(restart_marker_rows=1), 'gray',
], ids=['q75_420', 'q95', 'q30', '444', '422', 'optimized_tables',
        'restart_blocks', 'restart_rows', 'gray'])
def test_jpeg_decode_equals_pillow(save, tmp_path):
    """Sizes that are not multiples of the MCU (and 1-3 px maps), each way
    Pillow writes a baseline JPEG: the port's RGB equals
    ``Image.open(path).convert('RGB')``."""
    rng = np.random.default_rng(0)
    for h, w in ((37, 53), (281, 500), (500, 333), (17, 9), (2, 3), (1, 1)):
        img = _smooth(rng, h, w)
        path = str(tmp_path / 'x.jpg')
        if save == 'gray':
            Image.fromarray(img[..., 0]).save(path)
        else:
            Image.fromarray(img).save(path, **save)
        ref = np.asarray(Image.open(path).convert('RGB'))
        assert native.jpeg_dims(path) == (h, w)
        np.testing.assert_array_equal(imageio.read_rgb(path), ref)


def test_jpeg_decode_equals_pillow_on_the_fixture():
    names = sorted(os.listdir(os.path.join(FIXTURE, 'JPEGImages')))
    for name in names:
        path = os.path.join(FIXTURE, 'JPEGImages', name)
        np.testing.assert_array_equal(
            imageio.read_rgb(path), np.asarray(Image.open(path).convert('RGB')))


def test_unsupported_jpeg_and_bad_files_raise(tmp_path):
    path = str(tmp_path / 'p.jpg')
    Image.fromarray(_smooth(np.random.default_rng(1), 16, 16)).save(
        path, progressive=True)
    with pytest.raises(IOError, match='progressive'):
        imageio.read_rgb(path)
    bad = tmp_path / 'bad.jpg'
    bad.write_bytes(b'not a jpeg')
    with pytest.raises(IOError, match='not a JPEG'):
        imageio.read_rgb(str(bad))
    with pytest.raises(IOError, match='cannot open'):
        imageio.read_rgb(str(tmp_path / 'missing.jpg'))


def _png_labels(rng, h, w):
    lb = np.kron(rng.integers(0, 21, (h // 8 + 1, w // 8 + 1)),
                 np.ones((8, 8))).astype(np.uint8)[:h, :w]
    lb[rng.random((h, w)) < 0.05] = 255
    return lb


@pytest.mark.parametrize('mode', ['L', 'P'])
def test_png_label_equals_pillow(mode, tmp_path):
    """Gray and palette labels: the raw values, as ``np.asarray(
    Image.open(png))`` gives them, from the zlib reader and from the C++
    decoder of the native path."""
    rng = np.random.default_rng(2)
    for h, w in ((1, 1), (37, 53), (375, 500), (200, 7)):
        im = Image.fromarray(_png_labels(rng, h, w), mode='L')
        if mode == 'P':
            im = im.convert('P')
            im.putpalette([(i * 7) % 256 for i in range(768)])
        path = str(tmp_path / 'l.png')
        im.save(path)
        ref = np.asarray(Image.open(path))
        ours = imageio.read_label(path)
        assert ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)


def _png(w, h, rows, filters, interlace=0):
    """An 8-bit gray PNG with the given filter type on each row."""
    def chunk(kind, body):
        return (len(body).to_bytes(4, 'big') + kind + body +
                zlib.crc32(kind + body).to_bytes(4, 'big'))
    raw = b''.join(bytes([f]) + bytes(r) for f, r in zip(filters, rows))
    ihdr = w.to_bytes(4, 'big') + h.to_bytes(4, 'big') + bytes([8, 0, 0, 0, interlace])
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr) +
            chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))


def test_png_reader_undoes_every_filter(tmp_path):
    """Rows filtered with each of PNG's five filters (written here, since
    Pillow chooses its own): the reader gives Pillow's values."""
    rng = np.random.default_rng(3)
    h, w = 10, 23
    rows = rng.integers(0, 256, (h, w)).tolist()
    path = tmp_path / 'f.png'
    path.write_bytes(_png(w, h, rows, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]))
    np.testing.assert_array_equal(imageio.read_label(str(path)),
                                  np.asarray(Image.open(str(path))))


@pytest.mark.parametrize('what', ['rgb', 'sixteen_bit', 'interlaced'])
def test_other_pngs_raise(what, tmp_path):
    path = str(tmp_path / 'x.png')
    if what == 'rgb':
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    elif what == 'sixteen_bit':
        Image.fromarray(np.zeros((4, 4), np.uint16)).save(path)
    else:  # Pillow does not write interlaced PNGs
        with open(path, 'wb') as f:
            f.write(_png(4, 4, [[0] * 4] * 4, [0] * 4, interlace=1))
    with pytest.raises(ValueError, match='8-bit gray or palette'):
        imageio.read_label(path)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_resizes_equal_pillow(seed):
    """``resize_bilinear`` (antialiased on shrink) and ``resize_nearest``
    at random sizes up and down, whole and in a window of the output."""
    rng = np.random.default_rng(seed)
    for trial in range(40):
        h, w = (int(v) for v in rng.integers(2, 120, 2))
        if trial % 3 == 0:
            oh, ow = (int(v * rng.uniform(0.15, 0.6)) + 1 for v in (h, w))
        else:
            oh, ow = (int(v) for v in rng.integers(1, 260, 2))
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        lbl = rng.integers(0, 21, (h, w)).astype(np.uint8)
        ref = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                     Image.BILINEAR))
        ref_n = np.asarray(Image.fromarray(lbl, 'L').resize((ow, oh),
                                                            Image.NEAREST))
        np.testing.assert_array_equal(imageio.resize_bilinear(img, (ow, oh)),
                                      ref)
        np.testing.assert_array_equal(imageio.resize_nearest(lbl, (ow, oh)),
                                      ref_n)
        x0, y0 = int(rng.integers(0, ow)), int(rng.integers(0, oh))
        box = (x0, y0, x0 + int(rng.integers(1, 50)),
               y0 + int(rng.integers(1, 50)))
        np.testing.assert_array_equal(
            imageio.resize_bilinear(img, (ow, oh), box),
            ref[box[1]:box[3], box[0]:box[2]])
        np.testing.assert_array_equal(
            imageio.resize_nearest(lbl, (ow, oh), box),
            ref_n[box[1]:box[3], box[0]:box[2]])


def test_pad_crop_flip_equal_pillow():
    from PIL import ImageOps

    img = np.random.default_rng(4).integers(0, 256, (13, 17, 3), np.uint8)
    pil = Image.fromarray(img)
    np.testing.assert_array_equal(
        imageio.pad(img, 5, 3, 0),
        np.asarray(ImageOps.expand(pil, border=(0, 0, 5, 3), fill=0)))
    lbl = img[..., 0]
    np.testing.assert_array_equal(
        imageio.pad(lbl, 0, 4, 255),
        np.asarray(ImageOps.expand(Image.fromarray(lbl), border=(0, 0, 0, 4),
                                   fill=255)))
    np.testing.assert_array_equal(imageio.crop(img, (2, 3, 12, 9)),
                                  np.asarray(pil.crop((2, 3, 12, 9))))
    np.testing.assert_array_equal(
        imageio.hflip(img), np.asarray(pil.transpose(Image.FLIP_LEFT_RIGHT)))


def test_library_builds_once_into_the_package_build_dir():
    so = native.compile_source()
    assert os.path.dirname(so) == os.path.join(
        REPO, 'pixelssl_tpu_torch', 'build')
    assert native.compile_source() == so and native.lib() is native.lib(so)
