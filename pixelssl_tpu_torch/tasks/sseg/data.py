"""Semantic-segmentation datasets (counterpart of
``pixelssl_tpu/tasks/sseg/data.py``; reference task/sseg/data.py:18-294).

PASCAL VOC (SBD-augmented, ``pascal_voc_aug``, or the original split,
``pascal_voc_ori``) from a VOC-format tree: ``JPEGImages/*.jpg``,
``SegmentationClassAug/*.png`` and ``ImageSets/Segmentation/*.txt``. Train
samples: the short edge scaled to U[0.5, 2] x ``--train-base-size``, padded
with zeros to the crop, a random ``--im-size`` crop, a horizontal flip at
p 0.5, ImageNet normalisation (data.py:223-256,187,99); unlabeled samples
get an all ``-1`` label (data.py:104-105). Val samples keep their own size,
or with ``--val-rescaling`` their short edge is scaled to ``--im-size``
(data.py:259-294). The synthetic dataset needs no files.

Files are read and images resized by ``nn/imageio.py`` (PIL's arithmetic,
without Pillow). ``--native-augment`` runs the decode and a point-sampled
scale-crop-flip in one call of ``csrc/augment.cpp`` (``nn/native.py``), as
the JAX package's C++ path does: the same crops, other pixels (PIL's
resize is antialiased). ``--decoded-cache`` keeps each decoded image and
label in the worker's memory (3 + 1 bytes a pixel), so that later epochs
skip the decode; the augmentation still runs each time. ``--u8-transfer``
gives uint8 RGB and uint8 labels (void 255, and ``-1`` wrapped to 255;
int16 where the classes or the ignore index do not fit), and the task's
``device_prep`` normalises them on the card.

The k-th access of train sample ``idx`` draws its augmentation from
``np.random.default_rng((seed, idx, k))``, as the JAX dataset does. Here
the loader hands the dataset the key ``(idx, k)``, counted in the main
process (``nn/loader.py``), so that the draws do not depend on which
worker process loads a sample; a plain ``idx`` means ``k = 0``.

Samples are NHWC numpy: image float32 [H,W,3], label int32 [H,W].
"""

import os

import numpy as np

from ...nn import imageio, native
from ...task_template import data_template
from ...utils import cmd, logger

VOC_MEAN = (0.485, 0.456, 0.406)
VOC_STD = (0.229, 0.224, 0.225)


def add_parser_arguments(parser):
    data_template.add_parser_arguments(parser)
    parser.add_argument('--val-rescaling', type=cmd.str2bool, default=False,
                        help='sseg - rescale the short edge of val images '
                             'to im_size')
    parser.add_argument('--train-base-size', type=int, default=400,
                        help='sseg - base size of the random scale-crop')
    parser.add_argument('--synthetic-samples', type=int, default=64,
                        help='sseg - sample count of the synthetic dataset')
    parser.add_argument('--native-augment', type=cmd.str2bool, default=False,
                        help='sseg - decode and scale-crop-flip in one call '
                             'of csrc/augment.cpp (point-sampled bilinear '
                             "instead of PIL's antialiased resize)")
    parser.add_argument('--decoded-cache', type=cmd.str2bool, default=False,
                        help='sseg - keep decoded train images in the loader '
                             "workers' memory (3 + 1 bytes a pixel each)")
    parser.add_argument('--u8-transfer', type=cmd.str2bool, default=False,
                        help='sseg - uint8 train batches, normalised on the '
                             'device')


def pascal_voc_aug():
    return PascalVocAugDataset


def pascal_voc_ori():
    return PascalVocOriDataset


def synthetic_sseg():
    return SyntheticSsegDataset


# ---------------------------------------------------------------------------
# transforms (numpy, PIL's arithmetic)
# ---------------------------------------------------------------------------

def normalize_image(img):
    img = np.asarray(img, dtype=np.float32) / 255.0
    img = (img - np.asarray(VOC_MEAN, np.float32)) / np.asarray(VOC_STD,
                                                                 np.float32)
    return img


def _scaled_size(h, w, short_size):
    """(oh, ow) with the short edge at ``short_size`` (data.py:228-233)."""
    if h > w:
        ow = short_size
        return int(1.0 * h * ow / w), ow
    oh = short_size
    return oh, int(1.0 * w * oh / h)


def random_scale_crop(rng, img, mask, base_size, crop_size, fill=0):
    """The JAX ``random_scale_crop`` on uint8 arrays (``mask`` may be None):
    the same draws in the same order (short size, then x1 before y1), the
    same pixels. Only the crop's window of the resized image is computed."""
    short_size = int(rng.integers(int(base_size * 0.5),
                                  int(base_size * 2.0) + 1))
    oh, ow = _scaled_size(img.shape[0], img.shape[1], short_size)
    ph, pw = max(oh, crop_size), max(ow, crop_size)
    x1 = int(rng.integers(0, pw - crop_size + 1))
    y1 = int(rng.integers(0, ph - crop_size + 1))
    window = (x1, y1, x1 + crop_size, y1 + crop_size)

    def cut(resized, pad_fill):
        return imageio.pad(resized, x1 + crop_size - min(x1 + crop_size, ow),
                           y1 + crop_size - min(y1 + crop_size, oh), pad_fill)

    img = cut(imageio.resize_bilinear(img, (ow, oh), window), 0)
    if mask is not None:
        mask = cut(imageio.resize_nearest(mask, (ow, oh), window), fill)
    return img, mask


def fixed_scale_resize(img, mask, size):
    """Short edge -> ``size``, zero-padded to at least ``size`` (JAX
    data.py:110-127)."""
    h, w = img.shape[:2]
    if w <= h:
        ow = size
        oh = int(h * ow / w)
    else:
        oh = size
        ow = int(w * oh / h)
    img = imageio.resize_bilinear(img, (ow, oh))
    mask = imageio.resize_nearest(mask, (ow, oh))
    pad_w, pad_h = max(size - ow, 0), max(size - oh, 0)
    return imageio.pad(img, pad_w, pad_h, 0), imageio.pad(mask, pad_w, pad_h,
                                                          0)


# ---------------------------------------------------------------------------
# PASCAL VOC
# ---------------------------------------------------------------------------

class PascalVocDataset(data_template.TaskDataset):
    def __init__(self, args, is_train, train_prefix_path, val_prefix_path):
        super(PascalVocDataset, self).__init__(args, is_train)
        self.im_size = args.im_size
        self.root_dir = (list(args.trainset.values())[0] if is_train
                         else list(args.valset.values())[0])
        if isinstance(self.root_dir, (list, tuple)):
            self.root_dir = self.root_dir[0]

        prefix_path = os.path.join(
            self.root_dir, train_prefix_path if is_train else val_prefix_path)
        self.image_dir = os.path.join(self.root_dir, 'JPEGImages')
        self.label_dir = os.path.join(self.root_dir, 'SegmentationClassAug')
        if not os.path.exists(prefix_path):
            logger.log_err('Cannot find prefix file: {0}'.format(prefix_path))
        with open(prefix_path) as f:
            lines = [l.strip() for l in f.read().splitlines() if l.strip()]
        for line in lines:
            if not os.path.isfile(os.path.join(self.image_dir, line + '.jpg')):
                logger.log_err('Cannot find image: {0}.jpg'.format(line))
            self.sample_list.append(line)
        self.idxs = list(range(len(self.sample_list)))

        self._seed = getattr(args, 'seed', 0) or 0
        self._use_native = bool(is_train and args.native_augment)
        self._dims = {}  # idx -> (h, w) from the JPEG header (native path)
        # idx -> (uint8 [h,w,3] image, uint8 [h,w] label or None)
        self._decoded_cache = {} if is_train and args.decoded_cache else None
        self._u8 = bool(is_train and args.u8_transfer)
        # uint8 labels where every value fits: classes <= 254 and void 255;
        # -1 (unlabeled) wraps to 255, which every consumer ignores as it
        # does -1 (JAX data.py:177-189)
        self._u8_lbl = (self._u8 and
                        getattr(args, 'ignore_index', 255) == 255 and
                        getattr(args, 'num_classes', 256) <= 254)

    def _paths(self, idx):
        name = self.sample_list[idx]
        return (os.path.join(self.image_dir, name + '.jpg'),
                os.path.join(self.label_dir, name + '.png'))

    def _geometry(self, rng, h, w):
        """``random_scale_crop``'s draws and the flip's, in that order, as
        (resize (h, w), crop origin (y, x), flip)."""
        base, crop = self.args.train_base_size, self.im_size
        short_size = int(rng.integers(int(base * 0.5), int(base * 2.0) + 1))
        oh, ow = _scaled_size(h, w, short_size)
        ph, pw = max(oh, crop), max(ow, crop)
        x1 = int(rng.integers(0, pw - crop + 1))
        y1 = int(rng.integers(0, ph - crop + 1))
        flip = bool(rng.random() < 0.5)
        return (oh, ow), (y1, x1), flip

    def _decoded(self, idx, label_path):
        """(uint8 image, uint8 label or None), from the cache when
        ``--decoded-cache`` is on."""
        if self._decoded_cache is not None and idx in self._decoded_cache:
            return self._decoded_cache[idx]
        img_path, _ = self._paths(idx)
        ent = (imageio.read_rgb(img_path),
               imageio.read_label(label_path) if label_path else None)
        if self._decoded_cache is not None:
            self._decoded_cache[idx] = ent
        return ent

    def _native_train_item(self, rng, idx, label_path):
        """The C++ path: decode and a point-sampled scale-crop-flip in one
        call, or, with ``--decoded-cache``, the augmentation of the cached
        arrays; the geometry is drawn as the default path draws it."""
        fill = 0 if label_path is not None else -1
        if self._decoded_cache is not None:
            img, lbl = self._decoded(idx, label_path)
            resize_hw, crop_yx, flip = self._geometry(rng, *img.shape[:2])
            lbl = None if lbl is None else lbl.astype(np.int32)
            if self._u8:
                out_im, out_lb = native.augment_batch_raw(
                    [img], [lbl], [resize_hw], [crop_yx], [flip], [fill],
                    self.im_size)
            else:
                out_im, out_lb = native.augment_batch(
                    [img], [lbl], [resize_hw], [crop_yx], [flip], [fill],
                    self.im_size)
            image, label = out_im[0], out_lb[0]
        else:
            img_path, _ = self._paths(idx)
            if idx not in self._dims:
                self._dims[idx] = native.jpeg_dims(img_path)
            resize_hw, crop_yx, flip = self._geometry(rng, *self._dims[idx])
            decode = (native.decode_augment_sample_raw if self._u8 else
                      native.decode_augment_sample)
            image, label = decode(img_path, label_path, resize_hw, crop_yx,
                                  flip, fill, self.im_size)
        if self._u8_lbl:
            label = label.astype(np.uint8)  # -1 wraps to 255 (void)
        return (image,), (label,)

    def __getitem__(self, key):
        idx, k = data_template.split_key(key)
        img_path, label_path = self._paths(idx)
        label_exists = os.path.exists(label_path)
        has_label = label_exists and not self.is_unlabeled(idx)

        if not self.is_train:
            if not label_exists:
                logger.log_err('Val sample must have a label: {0}'.format(
                    label_path))
            image, label = self._decoded(idx, label_path)
            if self.args.val_rescaling:
                image, label = fixed_scale_resize(image, label, self.im_size)
            return (normalize_image(image),), (label.astype(np.int32),)

        rng = np.random.default_rng((self._seed, idx, k))
        if self._use_native:
            return self._native_train_item(
                rng, idx, label_path if has_label else None)
        image, label = self._decoded(idx, label_path if has_label else None)
        image, label = random_scale_crop(rng, image, label,
                                         self.args.train_base_size,
                                         self.im_size)
        if rng.random() < 0.5:
            image = imageio.hflip(image)
            label = imageio.hflip(label) if label is not None else None
        if label is None:  # unlabeled (reference data.py:104-105)
            label = np.full(image.shape[:2], -1, np.int32)
        if self._u8:
            ldt = np.uint8 if self._u8_lbl else np.int16
            return (image,), (label.astype(np.int16).astype(ldt),)
        return (normalize_image(image),), (label.astype(np.int32),)


class PascalVocAugDataset(PascalVocDataset):
    def __init__(self, args, is_train):
        super(PascalVocAugDataset, self).__init__(
            args, is_train,
            'ImageSets/Segmentation/train_aug.txt',
            'ImageSets/Segmentation/val.txt')


class PascalVocOriDataset(PascalVocDataset):
    def __init__(self, args, is_train):
        super(PascalVocOriDataset, self).__init__(
            args, is_train,
            'ImageSets/Segmentation/train.txt',
            'ImageSets/Segmentation/val.txt')


# ---------------------------------------------------------------------------
# Synthetic dataset (tests / benchmarks — no VOC download needed)
# ---------------------------------------------------------------------------

class SyntheticSsegDataset(data_template.TaskDataset):
    """Random images and blocky labels (8x8 blocks) at ``im_size``, drawn
    as the JAX package draws them."""

    def __init__(self, args, is_train):
        super(SyntheticSsegDataset, self).__init__(args, is_train)
        n = args.synthetic_samples
        self.sample_list = ['synthetic_{0:05d}'.format(i) for i in range(n)]
        self.idxs = list(range(n))
        self.im_size = args.im_size or 64
        self.num_classes = args.num_classes
        self._seed = getattr(args, 'seed', 0) or 0
        # distinct roots (a labeled trainset and an --unlabeledset) give
        # distinct samples
        self._root_key = data_template.dataset_root_key(args, is_train)

    def __getitem__(self, key):
        idx, _ = data_template.split_key(key)
        rng = np.random.default_rng((self._seed, 7919, self._root_key, idx))
        s = self.im_size
        img = rng.standard_normal((s, s, 3)).astype(np.float32)
        coarse = rng.integers(0, self.num_classes, (max(1, s // 8),) * 2)
        # each pixel takes its 8x8 block's class; where s is not a multiple
        # of 8 the last block row and column stretch to the edge, so that
        # the label is s x s (the JAX package's np.kron gives 8*(s//8))
        block = np.minimum(np.arange(s) // 8, coarse.shape[0] - 1)
        gt = coarse[block][:, block].astype(np.int32)
        if self.is_unlabeled(idx):
            gt = np.full_like(gt, -1)
        return (img,), (gt,)
