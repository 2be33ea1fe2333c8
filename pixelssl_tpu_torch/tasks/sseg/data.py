"""Semantic-segmentation datasets (counterpart of
``pixelssl_tpu/tasks/sseg/data.py``; reference task/sseg/data.py:18-294).

Every flag of the JAX module parses here, so that its configs do. Ported:
the synthetic dataset, with the JAX package's numpy draws. Not ported yet
(ROADMAP A2b), and refused with an error rather than ignored: the PASCAL
VOC datasets, ``--native-augment``, ``--decoded-cache`` and
``--u8-transfer``.

Samples are NHWC numpy: image float32 [H,W,3], label int32 [H,W], -1 on
unlabeled samples (reference data.py:104-105).
"""

import numpy as np

from ...task_template import data_template
from ...utils import cmd, logger

_A2B = 'is not ported to pixelssl_tpu_torch yet (ROADMAP A2b)'

# flag -> its default; any other value is refused (ROADMAP A2b)
_UNPORTED_FLAGS = (('native_augment', False), ('decoded_cache', False),
                   ('u8_transfer', False))


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
                        help='sseg - fused C++ augmentation (ROADMAP A2b)')
    parser.add_argument('--decoded-cache', type=cmd.str2bool, default=False,
                        help='sseg - cache decoded images in RAM '
                             '(ROADMAP A2b)')
    parser.add_argument('--u8-transfer', type=cmd.str2bool, default=False,
                        help='sseg - uint8 train batches, normalised on the '
                             'device (ROADMAP A2b)')


def refuse_unported(args):
    """Stop on a data flag that is set but not ported yet."""
    for name, default in _UNPORTED_FLAGS:
        if getattr(args, name) != default:
            logger.log_err('--{0} {1}'.format(name.replace('_', '-'), _A2B))


def pascal_voc_aug():
    logger.log_err('The PASCAL VOC dataset `pascal_voc_aug` ' + _A2B +
                   '; use `synthetic_sseg`')


def pascal_voc_ori():
    logger.log_err('The PASCAL VOC dataset `pascal_voc_ori` ' + _A2B +
                   '; use `synthetic_sseg`')


def synthetic_sseg():
    return SyntheticSsegDataset


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

    def __getitem__(self, idx):
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
