"""ctypes binding of the host decode and augmentation library (counterpart
of ``pixelssl_tpu/nn/native.py``).

``csrc/augment.cpp`` is compiled with ``g++`` (and zlib) the first time a
function here needs it, into the package's ``build/`` directory, under a
name keyed by the source's hash; nothing is built when the module is
imported. ``lib(path)`` loads another build of the same interface, such as
the JAX package's ``native/augment.cpp``, for a test to compare.

Every function raises on a failure, with the library's reason: there is no
fallback to another decoder.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, 'csrc', 'augment.cpp')
_BUILD_DIR = os.path.join(_PKG_DIR, 'build')

_libs = {}

_p = ctypes.POINTER
_c_int, _c_i32, _c_u8 = ctypes.c_int, ctypes.c_int32, ctypes.c_uint8
_SAMPLE_ARGS = [ctypes.c_char_p, ctypes.c_char_p] + [_c_int] * 7
_BATCH_ARGS = [_p(_p(_c_u8)), _p(_p(_c_i32))] + [_p(_c_i32)] * 8 + \
    [_c_int, _c_int]
# name -> argtypes; every function returns int, 0 on success
_SIGNATURES = {
    'jpeg_dims': [ctypes.c_char_p, _p(_c_i32), _p(_c_i32)],
    'decode_jpeg_rgb': [ctypes.c_char_p, _p(_c_u8), _c_int, _c_int],
    'decode_augment_sample': _SAMPLE_ARGS + [_p(ctypes.c_float), _p(_c_i32)],
    'decode_augment_sample_raw': _SAMPLE_ARGS + [_p(_c_u8),
                                                 _p(ctypes.c_int16)],
    'augment_batch': _BATCH_ARGS + [_p(ctypes.c_float), _p(_c_i32), _c_int],
    'augment_batch_raw': _BATCH_ARGS + [_p(_c_u8), _p(ctypes.c_int16)],
}


def compile_source(src=SOURCE, out_dir=_BUILD_DIR):
    """Compile ``src`` with g++ into ``out_dir`` (once per source content);
    returns the shared library's path."""
    with open(src, 'rb') as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, 'libpixelssl_augment_{0}.so'.format(digest))
    if os.path.exists(so):
        return so
    cxx = shutil.which(os.environ.get('CXX', 'g++'))
    if cxx is None:
        raise RuntimeError('g++ not found: it builds {0}'.format(src))
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, '-O3', '-std=c++17', '-fPIC', '-pthread', '-shared', '-o',
             tmp, src, '-lz'], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('g++ failed to build {0}:\n{1}{2}'.format(
                src, proc.stdout, proc.stderr))
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def lib(path=None):
    """The loaded library: ``csrc/augment.cpp`` built on first use, or the
    shared library at ``path``. Loaded once per path and process."""
    if path is None:
        path = compile_source()
    loaded = _libs.get(path)
    if loaded is None:
        loaded = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            if hasattr(loaded, name):
                fn = getattr(loaded, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        if hasattr(loaded, 'pixelssl_augment_error'):
            loaded.pixelssl_augment_error.restype = ctypes.c_char_p
        _libs[path] = loaded
    return loaded


def _check(library, code, what):
    if code != 0:
        reason = (library.pixelssl_augment_error().decode()
                  if hasattr(library, 'pixelssl_augment_error') else
                  'error {0}'.format(code))
        raise IOError('{0}: {1}'.format(what, reason))


def _ptr(arr, ctype):
    return arr.ctypes.data_as(_p(ctype))


def jpeg_dims(path, library=None):
    """(h, w) from the JPEG's frame header, without decoding it."""
    library = library or lib()
    h, w = _c_i32(), _c_i32()
    _check(library, library.jpeg_dims(path.encode(), ctypes.byref(h),
                                      ctypes.byref(w)), 'jpeg_dims')
    return int(h.value), int(w.value)


def decode_jpeg_rgb(path, library=None):
    """uint8 [h, w, 3] RGB of a JPEG file."""
    library = library or lib()
    h, w = jpeg_dims(path, library)
    out = np.empty((h, w, 3), np.uint8)
    _check(library, library.decode_jpeg_rgb(path.encode(), _ptr(out, _c_u8),
                                            h, w), 'decode_jpeg_rgb')
    return out


def _sample(fn_name, image_dtype, label_dtype, image_path, label_path,
            resize_hw, crop_yx, flip, label_fill, crop_size, library):
    library = library or lib()
    out_image = np.empty((crop_size, crop_size, 3), image_dtype)
    out_label = np.empty((crop_size, crop_size), label_dtype)
    code = getattr(library, fn_name)(
        image_path.encode(),
        label_path.encode() if label_path is not None else None,
        resize_hw[0], resize_hw[1], crop_yx[0], crop_yx[1],
        1 if flip else 0, label_fill, crop_size,
        _ptr(out_image, np.ctypeslib.as_ctypes_type(image_dtype)),
        _ptr(out_label, np.ctypeslib.as_ctypes_type(label_dtype)))
    _check(library, code, '{0} of {1}'.format(fn_name, image_path))
    return out_image, out_label


def decode_augment_sample(image_path, label_path, resize_hw, crop_yx, flip,
                          label_fill, crop_size, library=None):
    """Decode (JPEG image, PNG label or None) and scale-crop-flip-normalise
    one sample in one native call: (float32 [crop, crop, 3], int32
    [crop, crop])."""
    return _sample('decode_augment_sample', np.float32, np.int32,
                   image_path, label_path, resize_hw, crop_yx, flip,
                   label_fill, crop_size, library)


def decode_augment_sample_raw(image_path, label_path, resize_hw, crop_yx,
                              flip, label_fill, crop_size, library=None):
    """The uint8 form of ``decode_augment_sample``: (uint8 RGB, int16
    labels); the task's ``device_prep`` normalises on the card."""
    return _sample('decode_augment_sample_raw', np.uint8, np.int16,
                   image_path, label_path, resize_hw, crop_yx, flip,
                   label_fill, crop_size, library)


def _batch_args(images, labels, resize_hw, crop_yx, flips, label_fills):
    images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    labels = [None if lb is None else np.ascontiguousarray(lb, np.int32)
              for lb in labels]
    n = len(images)
    img_ptrs = (_p(_c_u8) * n)(*[_ptr(im, _c_u8) for im in images])
    lbl_ptrs = (_p(_c_i32) * n)(*[
        _ptr(lb, _c_i32) if lb is not None else _p(_c_i32)()
        for lb in labels])
    ints = [np.ascontiguousarray(v, np.int32) for v in (
        [im.shape[0] for im in images], [im.shape[1] for im in images],
        [r[0] for r in resize_hw], [r[1] for r in resize_hw],
        [c[0] for c in crop_yx], [c[1] for c in crop_yx],
        [1 if f else 0 for f in flips], label_fills)]
    # the arrays stay referenced by the returned tuple during the call
    return (images, labels, ints,
            [img_ptrs, lbl_ptrs] + [_ptr(a, _c_i32) for a in ints])


def augment_batch(images, labels, resize_hw, crop_yx, flips, label_fills,
                  crop_size, n_threads=1, library=None):
    """Scale-crop-flip-normalise decoded uint8 [h, w, 3] images and int32
    [h, w] labels (or None): (float32 [n, crop, crop, 3], int32
    [n, crop, crop]). ``crop_yx`` may be negative (padding)."""
    library = library or lib()
    keep = _batch_args(images, labels, resize_hw, crop_yx, flips,
                       label_fills)
    n = len(images)
    out_images = np.empty((n, crop_size, crop_size, 3), np.float32)
    out_labels = np.empty((n, crop_size, crop_size), np.int32)
    _check(library, library.augment_batch(
        *keep[3], n, crop_size, _ptr(out_images, ctypes.c_float),
        _ptr(out_labels, _c_i32), n_threads), 'augment_batch')
    return out_images, out_labels


def augment_batch_raw(images, labels, resize_hw, crop_yx, flips,
                      label_fills, crop_size, library=None):
    """The uint8 form of ``augment_batch``: (uint8 [n, crop, crop, 3],
    int16 [n, crop, crop])."""
    library = library or lib()
    keep = _batch_args(images, labels, resize_hw, crop_yx, flips,
                       label_fills)
    n = len(images)
    out_images = np.empty((n, crop_size, crop_size, 3), np.uint8)
    out_labels = np.empty((n, crop_size, crop_size), np.int16)
    _check(library, library.augment_batch_raw(
        *keep[3], n, crop_size, _ptr(out_images, _c_u8),
        _ptr(out_labels, ctypes.c_int16)), 'augment_batch_raw')
    return out_images, out_labels
