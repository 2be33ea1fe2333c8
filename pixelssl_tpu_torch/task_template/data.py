"""Task dataset contract (counterpart of
``pixelssl_tpu/task_template/data.py``; reference
pixelssl/task_template/data.py:22-98).

A task dataset is any object with:

* ``sample_list``, the sample names (the SSL split wrappers reorder it,
  nn/data.py);
* ``__len__`` and ``__getitem__(idx) -> (inp_tuple, gt_tuple)`` of numpy
  arrays, NHWC: loader workers never touch torch or the card;
* optionally ``set_num_labeled(n)``, which ``SplitUnlabeledWrapper`` calls
  so that the dataset can give unlabeled samples an all-ignore label.

The Pillow image reader of the JAX package waits for the VOC datasets
(ROADMAP A2b).
"""

import zlib


def add_parser_arguments(parser):
    pass


def dataset_root_key(args, is_train):
    """A stable hash of the dataset root paths, which a synthetic dataset
    folds into its draws so that two roots give different samples."""
    roots = (getattr(args, 'trainset', None) if is_train
             else getattr(args, 'valset', None)) or {}
    flat = []
    for v in roots.values():
        flat.extend(v if isinstance(v, (list, tuple)) else [v])
    return zlib.crc32('|'.join(sorted(str(p) for p in flat)).encode('utf8'))


class TaskDataset(object):
    def __init__(self, args=None, is_train=True):
        self.args = args
        self.is_train = is_train
        self.sample_list = []
        self.idxs = []
        self.num_labeled = None  # None: fully labeled

    def set_num_labeled(self, n):
        self.num_labeled = n

    def is_unlabeled(self, idx):
        return self.num_labeled is not None and idx >= self.num_labeled

    def __len__(self):
        return len(self.sample_list)

    def __getitem__(self, idx):
        raise NotImplementedError
