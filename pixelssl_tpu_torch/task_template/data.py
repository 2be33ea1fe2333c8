"""Task dataset contract (counterpart of
``pixelssl_tpu/task_template/data.py``; reference
pixelssl/task_template/data.py:22-98).

A task dataset is any object with:

* ``sample_list``, the sample names (the SSL split wrappers reorder it,
  nn/data.py);
* ``__len__`` and ``__getitem__(key) -> (inp_tuple, gt_tuple)`` of numpy
  arrays, NHWC: loader workers never touch torch or the card. The key is
  an index, or ``(idx, k)`` for the k-th access of a train sample, which
  the dataset folds into its augmentation draws (``split_key``);
* optionally ``set_num_labeled(n)``, which ``SplitUnlabeledWrapper`` calls
  so that the dataset can give unlabeled samples an all-ignore label.
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


def split_key(key):
    """``(idx, k)`` of a dataset key: an ``(idx, k)`` pair as the train
    loader gives it, or a plain index (validation, a direct access), k 0."""
    if isinstance(key, tuple):
        return int(key[0]), int(key[1])
    return int(key), 0


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
