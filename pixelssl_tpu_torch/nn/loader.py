"""Host batch loader (counterpart of ``pixelssl_tpu/nn/loader.py``).

PyTorch's own idiom, the reference's loader (reference
pixelssl/task_template/proxy.py:374-380):
``torch.utils.data.DataLoader`` over the task dataset, with
``num_workers`` worker processes that live as long as the loader. They are
forked once, on the loader's first epoch: a worker never touches CUDA, so
the parent's CUDA context does not matter to it. Workers return numpy
samples and ``stack_samples`` stacks them into CPU tensors (pinned by the
loader when the batches go to the card).

The batch sampler runs in the main process, so that the index sequence is
the sampler's whatever the worker count. So does the count of each
sample's accesses: an epoch's batches reach the workers as keys
``(idx, k)``, the k-th access of sample ``idx`` since the loader was made,
from which the dataset draws its augmentation (JAX ``tasks/sseg/data.py``
counts them in the dataset, which its loader threads share; a worker
process would count only its own). Under ``--distributed`` the batch
sampler is a ``parallel.multihost.ProcessShardedSampler``: each rank
counts the accesses of the whole global batch, then loads its own slice
(``shard``), so that a sample's draw is the one-process run's. Under
``--spatial-train`` (``rows_of``, the grid) the slice is the samples of the
rank's data coordinate, and the rank keeps its rows of them on the host
before the copy; the batch carries the global height (``'height'``).
``to_device`` then makes a batch what
the algorithms take: NCHW images and int64 labels on the device, copied
with ``non_blocking`` from pinned memory on the current stream and
permuted there. uint8 images and labels (``--u8-transfer``) stay uint8
for the copy, and the task's ``device_prep`` normalises and widens them.

With ``--steps-per-dispatch`` n > 1 the trainer groups an epoch's batches
with ``chunked``: ``('chunk', [n batches])`` for each dispatch and
``('single', batch)`` for each batch of the tail (JAX ``nn/loader.py``'s
chunk mode). With ``eager_ingest`` (``--eager-ingest``) a thread of the
loader takes the batches from the workers and copies them to the card on a
side stream, recording an event after each; the consumer's stream waits on
it. The copy of the next batch then overlaps the current step, and only
its timing changes: the batches are the same.
"""

import queue
import threading

import numpy as np
import torch
import torch.utils.data

from ..parallel import spatial

# how the worker processes start: forked, the first batch of a run waits
# 0.4 s on an H100 host; spawned, 8 s, each worker importing torch and the
# port first (``tools/torch_loader_ab.py`` times both)
START_METHOD = 'fork'


def stack_samples(samples):
    """``[(inp_tuple, gt_tuple), ...]`` of numpy arrays -> ``(inp_tuple,
    gt_tuple)`` of batched CPU tensors."""
    n_inp, n_gt = len(samples[0][0]), len(samples[0][1])
    inp = tuple(torch.from_numpy(np.stack([s[0][i] for s in samples]))
                for i in range(n_inp))
    gt = tuple(torch.from_numpy(np.stack([s[1][i] for s in samples]))
               for i in range(n_gt))
    return inp, gt


_NARROW = (torch.uint8, torch.int8, torch.int16)


def to_device(inp, gt, device, valid=None):
    """A batch on ``device``: images [N,H,W,C] -> [N,C,H,W], float32 or
    uint8; integer labels -> int64, uint8/int8/int16 ones as they are;
    float maps [N,H,W,C] (the regression task's GT) -> [N,C,H,W];
    ``valid`` -> float32."""
    def image(x):
        x = x.to(device, non_blocking=True)
        if x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        if x.dtype != torch.uint8:
            x = x.float()
        return x.contiguous()

    def label(x):
        x = x.to(device, non_blocking=True)
        if x.is_floating_point():
            return x.permute(0, 3, 1, 2).contiguous() if x.dim() == 4 else x
        if x.dtype in _NARROW:
            return x
        return x.long()

    batch = {'inp': tuple(image(x) for x in inp),
             'gt': tuple(label(x) for x in gt)}
    if valid is not None:
        batch['valid'] = valid.to(device, non_blocking=True).float()
    return batch


class _EpochBatches(object):
    """The batch sampler that PyTorch's loader sees: the index batches of
    the current epoch, drawn before it starts. PyTorch may call ``iter`` on
    its batch sampler more than once an epoch (twice on the first), and
    the two-stream sampler draws its permutations when it is iterated."""

    def __init__(self):
        self.batches = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def chunked(batches, n):
    """``('chunk', [n batches])`` for each n batches of ``batches``, then
    ``('single', batch)`` for each batch left over."""
    chunk = []
    for batch in batches:
        chunk.append(batch)
        if len(chunk) == n:
            yield 'chunk', chunk
            chunk = []
    for batch in chunk:
        yield 'single', batch


def _tensors(item):
    """The tensors of a batch."""
    if torch.is_tensor(item):
        yield item
    elif isinstance(item, dict):
        for value in item.values():
            yield from _tensors(value)
    elif isinstance(item, (list, tuple)):
        for value in item:
            yield from _tensors(value)


_END = object()


def ingested(items, device, depth=2):
    """``items`` taken by a thread, each on a side stream of ``device``
    (the card) with an event recorded after it; yielded once the current
    stream waits on that event, every tensor marked as used on that stream
    (``record_stream``). Up to ``depth`` items wait ahead. An error of the
    thread is raised here; leaving the loop early stops the thread."""
    device = torch.device(device)
    cuda = device.type == 'cuda'
    out = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(entry):
        while not stop.is_set():
            try:
                out.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        side = torch.cuda.Stream(device) if cuda else None
        try:
            it = iter(items)
            while not stop.is_set():
                if cuda:
                    with torch.cuda.stream(side):
                        item = next(it, _END)
                        event = torch.cuda.Event()
                        event.record(side)
                else:
                    item, event = next(it, _END), None
                if not put((item, event, None)) or item is _END:
                    return
        except Exception as exc:  # handed to the consumer, raised there
            put((_END, None, exc))

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item, event, exc = out.get()
            if exc is not None:
                raise exc
            if item is _END:
                return
            if cuda:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for tensor in _tensors(item):
                    if tensor.is_cuda:
                        tensor.record_stream(stream)
            yield item
    finally:
        stop.set()
        thread.join(timeout=60)


class DataLoader(object):
    """Train batches on ``device`` from ``dataset`` and ``batch_sampler``,
    loaded by ``num_workers`` worker processes (none: in the main
    process). Each epoch walks ``batch_sampler`` once; ``eager_ingest``
    as the module docstring says."""

    def __init__(self, dataset, batch_sampler, device, num_workers=0,
                 eager_ingest=False, rows_of=None):
        self.batch_sampler = batch_sampler
        self.rows_of = rows_of
        self.device = torch.device(device)
        self.eager_ingest = bool(eager_ingest)
        self._epoch = _EpochBatches()
        self._accesses = {}  # idx -> accesses handed out so far
        workers = dict(multiprocessing_context=START_METHOD,
                       persistent_workers=True) if num_workers > 0 else {}
        self.loader = torch.utils.data.DataLoader(
            dataset, batch_sampler=self._epoch, num_workers=num_workers,
            collate_fn=stack_samples,
            pin_memory=self.device.type == 'cuda', **workers)

    def __len__(self):
        return len(self.batch_sampler)

    def _keys(self, batch):
        keys = []
        for idx in batch:
            idx = int(idx)
            k = self._accesses.get(idx, 0)
            self._accesses[idx] = k + 1
            keys.append((idx, k))
        return keys

    def _batches(self):
        for inp, gt in self.loader:
            if self.rows_of is None:
                yield to_device(inp, gt, self.device)
                continue
            height = int(inp[0].shape[1])
            batch = to_device(spatial.host_rows(inp, self.rows_of),
                              spatial.host_rows(gt, self.rows_of),
                              self.device)
            batch['height'] = height
            yield batch

    def __iter__(self):
        # the epoch's keys are counted when it starts, over the global
        # batches where the sampler gives each rank its slice
        sampler = self.batch_sampler
        shard = getattr(sampler, 'shard', None)
        if shard is None:
            self._epoch.batches = [self._keys(b) for b in sampler]
        else:
            self._epoch.batches = [shard(self._keys(b))
                                   for b in sampler.sampler]
        items = self._batches()
        if self.eager_ingest:
            items = ingested(items, self.device)
        return iter(items)
