"""Pixel-wise regression dataset (counterpart of
``pixelssl_tpu/tasks/sreg/data.py``): synthetic, no files.

A miniature matting analog: the input is ``fg*alpha + bg*(1-alpha) +
noise`` and the GT the dense ``alpha`` map in [0, 1], three Gaussian bumps
clipped to 1. Sample ``idx`` draws from ``np.random.default_rng((seed,
stream, root_key, idx))`` with the JAX dataset's draws in its order, so
that the two packages give the same samples bit for bit; validation draws
from another stream, and the root paths' hash keeps a labeled trainset and
an ``--unlabeledset`` apart.

Samples are NHWC numpy: image float32 [H,W,3], GT float32 [H,W,1] (zeros
for a sample that ``set_num_labeled`` marks unlabeled).
"""

import numpy as np

from ...task_template import data_template


def add_parser_arguments(parser):
    data_template.add_parser_arguments(parser)
    parser.add_argument('--synthetic-samples', type=int, default=64,
                        help='sreg - sample count of the synthetic dataset')
    parser.add_argument('--noise-std', type=float, default=0.05,
                        help='sreg - additive input noise std')


def synthetic_sreg():
    return SyntheticSregDataset


class SyntheticSregDataset(data_template.TaskDataset):
    """Random Gaussian-bump alpha maps composited over random colours."""

    def __init__(self, args, is_train):
        super(SyntheticSregDataset, self).__init__(args, is_train)
        n = args.synthetic_samples
        self.sample_list = ['synthetic_{0:05d}'.format(i) for i in range(n)]
        self.idxs = list(range(n))
        self.im_size = args.im_size or 64
        self.noise_std = getattr(args, 'noise_std', 0.05)
        self._seed = getattr(args, 'seed', 0) or 0
        self._stream = 104729 if is_train else 1299709
        self._root_key = data_template.dataset_root_key(args, is_train)

    def __getitem__(self, key):
        idx, _ = data_template.split_key(key)
        rng = np.random.default_rng(
            (self._seed, self._stream, self._root_key, idx))
        s = self.im_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s

        alpha = np.zeros((s, s), np.float32)
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            sig = rng.uniform(0.08, 0.25)
            amp = rng.uniform(0.5, 1.0)
            alpha += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                  / (2 * sig ** 2))
        alpha = np.clip(alpha, 0.0, 1.0).astype(np.float32)

        # a bright foreground over a dark background
        fg = rng.uniform(0.7, 1.0, 3).astype(np.float32)
        bg = rng.uniform(0.0, 0.3, 3).astype(np.float32)
        img = (fg * alpha[..., None] + bg * (1.0 - alpha[..., None]))
        img = img + self.noise_std * rng.standard_normal((s, s, 3))
        img = img.astype(np.float32)

        gt = alpha[..., None]
        if self.is_unlabeled(idx):
            gt = np.zeros_like(gt)
        return (img,), (gt,)
