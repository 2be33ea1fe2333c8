"""SSL dataset wrappers and the two-stream labeled/unlabeled batch sampler
(counterpart of ``pixelssl_tpu/nn/data.py``; reference
pixelssl/nn/data.py:13-177).

A dataset is any object with ``sample_list``/``__len__``/``__getitem__``
returning numpy ``(inp_tuple, gt_tuple)``; a sampler yields index batches.
The sampling draws come from ``np.random.default_rng(seed)`` exactly as in
the JAX package, so both walk the same index sequence for a seed. Every
batch is ``labeled + unlabeled`` with the labeled indices first: the train
steps slice ``[:lbs]``/``[lbs:]``.

An epoch walks the stream with more batches once; the other stream is
reshuffled for as long as it is needed (reference data.py:148-163).
"""

import itertools

import numpy as np

from ..task_template import data as data_template


class _SSLDatasetWrapper(object):
    """Superclass holding labeled/unlabeled index partitions
    (reference data.py:13-21)."""

    def __init__(self):
        self.labeled_idxs = []
        self.unlabeled_idxs = []

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


class SplitUnlabeledWrapper(_SSLDatasetWrapper):
    """Split a fully-labeled dataset by a sublabeled filename-prefix list
    (reference data.py:24-77).

    Samples whose name starts with any prefix are labeled; the rest become
    unlabeled. The wrapped dataset's ``sample_list`` is reordered as
    labeled ++ unlabeled so index < labeled_size ⇔ labeled.
    """

    def __init__(self, dataset, sublabeled_prefix, ignore_unlabeled=False):
        super(SplitUnlabeledWrapper, self).__init__()
        self.dataset = dataset
        self.sublabeled_prefix = sublabeled_prefix
        self.ignore_unlabeled = ignore_unlabeled
        self._split_labeled()

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx]

    def _split_labeled(self):
        prefixes = tuple(self.sublabeled_prefix)
        labeled_list, unlabeled_list = [], []
        for name in self.dataset.sample_list:
            if name.startswith(prefixes):
                labeled_list.append(name)
            else:
                unlabeled_list.append(name)
        assert len(labeled_list) + len(unlabeled_list) == len(self.dataset.sample_list)

        if self.ignore_unlabeled:
            self.dataset.sample_list = labeled_list
            self.dataset.idxs = list(range(len(labeled_list)))
            self.labeled_idxs = list(self.dataset.idxs)
            self.unlabeled_idxs = []
        else:
            self.dataset.sample_list = labeled_list + unlabeled_list
            self.dataset.idxs = list(range(len(self.dataset.sample_list)))
            self.labeled_idxs = list(range(len(labeled_list)))
            self.unlabeled_idxs = [len(labeled_list) + i
                                   for i in range(len(unlabeled_list))]
        # let the dataset know where the labeled/unlabeled boundary is so it
        # can substitute ignore-labels for unlabeled samples
        if hasattr(self.dataset, 'set_num_labeled'):
            self.dataset.set_num_labeled(len(labeled_list))


class JointDatasetsWrapper(_SSLDatasetWrapper):
    """Concatenate labeled datasets then unlabeled datasets with offset
    indexing (reference data.py:80-123)."""

    def __init__(self, labeled_datasets, unlabeled_datasets, ignore_unlabeled=False):
        super(JointDatasetsWrapper, self).__init__()
        self.labeled_datasets = list(labeled_datasets)
        self.unlabeled_datasets = list(unlabeled_datasets)
        self.ignore_unlabeled = ignore_unlabeled

        self.labeled_size = sum(len(d) for d in self.labeled_datasets)
        self.labeled_idxs = list(range(self.labeled_size))
        self.unlabeled_size = 0
        if not ignore_unlabeled:
            self.unlabeled_size = sum(len(d) for d in self.unlabeled_datasets)
            self.unlabeled_idxs = [self.labeled_size + i
                                   for i in range(self.unlabeled_size)]

        # prefix-sum tables for O(log n) index resolution
        self._labeled_bounds = np.cumsum([len(d) for d in self.labeled_datasets])
        self._unlabeled_bounds = np.cumsum([len(d) for d in self.unlabeled_datasets])

    def __len__(self):
        return int(self.labeled_size + self.unlabeled_size)

    def __getitem__(self, key):
        idx, k = data_template.split_key(key)
        assert 0 <= idx < len(self)
        if idx >= self.labeled_size:
            idx -= self.labeled_size
            datasets, bounds = self.unlabeled_datasets, self._unlabeled_bounds
        else:
            datasets, bounds = self.labeled_datasets, self._labeled_bounds
        ddx = int(np.searchsorted(bounds, idx, side='right'))
        base = 0 if ddx == 0 else int(bounds[ddx - 1])
        return datasets[ddx][(idx - base, k)]


class TwoStreamBatchSampler(object):
    """Yield batches of ``labeled_batch + unlabeled_batch`` index tuples
    (reference data.py:126-177).

    An epoch walks the stream with more batches exactly once; the other
    stream is reshuffled forever. Labeled indices always come first in each
    batch — downstream train steps slice labeled/unlabeled statically.
    """

    def __init__(self, labeled_idxs, unlabeled_idxs,
                 labeled_batch_size, unlabeled_batch_size, seed=0):
        self.labeled_idxs = list(labeled_idxs)
        self.unlabeled_idxs = list(unlabeled_idxs)
        self.labeled_batch_size = labeled_batch_size
        self.unlabeled_batch_size = unlabeled_batch_size
        self._rng = np.random.default_rng(seed)

        if not len(self.labeled_idxs) >= self.labeled_batch_size > 0:
            from ..utils import logger
            logger.log_err('TwoStreamBatchSampler requires 0 < '
                           'labeled_batch_size ({0}) <= labeled samples ({1})'
                           .format(self.labeled_batch_size, len(self.labeled_idxs)))
        if not len(self.unlabeled_idxs) >= self.unlabeled_batch_size > 0:
            from ..utils import logger
            logger.log_err('TwoStreamBatchSampler requires 0 < '
                           'unlabeled_batch_size ({0}) <= unlabeled samples ({1})'
                           .format(self.unlabeled_batch_size, len(self.unlabeled_idxs)))

        self.labeled_batchs = len(self.labeled_idxs) // self.labeled_batch_size
        self.unlabeled_batchs = len(self.unlabeled_idxs) // self.unlabeled_batch_size

    def __len__(self):
        return max(self.unlabeled_batchs, self.labeled_batchs)

    def _once(self, idxs):
        return iter(self._rng.permutation(idxs))

    def _eternally(self, idxs):
        def shuffles():
            while True:
                yield self._rng.permutation(idxs)
        return itertools.chain.from_iterable(shuffles())

    @staticmethod
    def _grouper(iterable, n):
        its = [iter(iterable)] * n
        return zip(*its)

    def __iter__(self):
        if self.unlabeled_batchs >= self.labeled_batchs:
            unlabeled_iter = self._once(self.unlabeled_idxs)
            labeled_iter = self._eternally(self.labeled_idxs)
        else:
            unlabeled_iter = self._eternally(self.unlabeled_idxs)
            labeled_iter = self._once(self.labeled_idxs)

        return (tuple(lb) + tuple(ub) for lb, ub in zip(
            self._grouper(labeled_iter, self.labeled_batch_size),
            self._grouper(unlabeled_iter, self.unlabeled_batch_size)))


class OneStreamBatchSampler(object):
    """Plain shuffled batching over a single index set (used when no
    unlabeled data exists, mirroring the proxy's shuffle=True DataLoader
    fallback, reference proxy.py:377-380)."""

    def __init__(self, idxs, batch_size, seed=0, drop_last=True):
        self.idxs = list(idxs)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        assert len(self.idxs) >= batch_size > 0

    def __len__(self):
        if self.drop_last:
            return len(self.idxs) // self.batch_size
        return (len(self.idxs) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        perm = self._rng.permutation(self.idxs)
        for i in range(len(self)):
            yield tuple(perm[i * self.batch_size:(i + 1) * self.batch_size])
