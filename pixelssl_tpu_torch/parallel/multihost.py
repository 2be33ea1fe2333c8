"""Runs over several processes (counterpart of
``pixelssl_tpu/parallel/multihost.py``).

The JAX package forms one mesh over every chip of a pod, one process a
host, with ``jax.distributed.initialize()``. The port runs one process a
card under ``torchrun`` (``python -m torch.distributed.run``), which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; ``--distributed`` makes the proxy form the process group
from them (``initialize``): NCCL on the card, the communicator formed
eagerly on ``cuda:<LOCAL_RANK>``, gloo on the CPU.

Every rank seeds the same sampler, walks the same global index sequence
and loads only its own slice of each batch (``ProcessShardedSampler``,
``process_batch_indices``), labeled first: no coordination in the input
path. The JAX ``put_local_batch`` assembled a global array from each
host's rows; here each rank's loader copies its slice to its own card
(``nn.loader.to_device``), and the step's collectives join the ranks.

    torchrun --nproc-per-node 2 <script> --distributed true       # CPU, gloo
    python3 -m torch.distributed.run --standalone --nproc-per-node 1 \\
        <script> --distributed true                               # the card
"""

import os

import torch
import torch.distributed as dist

from ..utils import logger

_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')


def initialize(args=None, device='cuda'):
    """Form the process group of a ``--distributed`` run; returns the
    device this process runs on: ``cuda:<LOCAL_RANK>`` for a card,
    ``device`` otherwise. A no-op, ``device`` returned as it is, without
    ``--distributed``, and where the group exists already (a launcher or a
    test formed it). Runs before any CUDA work of the run. With
    ``--distributed`` and no ``torchrun`` environment it fails at once:
    an independent copy of the run on every process is not what was
    asked for."""
    device = torch.device(device)
    if args is None or not getattr(args, 'distributed', False):
        return device
    if not dist.is_available():
        logger.log_err('--distributed was set but this PyTorch has no '
                       'torch.distributed')
    local_rank = int(os.environ.get('LOCAL_RANK', 0))
    if device.type == 'cuda':
        device = torch.device('cuda', local_rank)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    missing = [name for name in _ENV if name not in os.environ]
    if missing:
        logger.log_err(
            '--distributed was set but the environment lacks {0}.\n  '
            'Launch the script with torchrun (python -m '
            'torch.distributed.run --nproc-per-node N <script> '
            '--distributed true).'.format(', '.join(missing)))
    kwargs = dict(backend='nccl' if device.type == 'cuda' else 'gloo',
                  init_method='env://',
                  rank=int(os.environ['RANK']),
                  world_size=int(os.environ['WORLD_SIZE']))
    if device.type == 'cuda':
        kwargs['device_id'] = device  # the communicator forms now
    dist.init_process_group(**kwargs)
    return device


def is_multihost():
    """More than one process in the run."""
    return (dist.is_available() and dist.is_initialized() and
            dist.get_world_size() > 1)


def local_device_positions(mesh):
    """Mesh positions of this process's devices along the data axis: its
    data coordinate (its rank on a data-parallel mesh), one card a
    process."""
    return [mesh.data_rank]


def process_batch_indices(idx_batch, lbs, ubs, positions, n_dev):
    """Slice a global two-stream index batch down to one process.

    ``idx_batch`` is the sampler's global batch: ``lbs`` labeled entries
    followed by ``ubs`` unlabeled (the two-stream sampler's order). Rank
    ``d`` owns labeled chunk ``d`` and unlabeled chunk ``d``, the blocks
    ``mesh.reorder_two_stream`` makes on one host. The result is the
    concatenation of [labeled_chunk_d ++ unlabeled_chunk_d] for
    ``positions``: this process's batch, labeled first.
    """
    idx_batch = list(idx_batch)
    assert len(idx_batch) == lbs + ubs, (len(idx_batch), lbs, ubs)
    assert lbs % n_dev == 0 and ubs % n_dev == 0, (
        'labeled/unlabeled batch sizes must divide the mesh size '
        '(lbs={0}, ubs={1}, n_dev={2})'.format(lbs, ubs, n_dev))
    lbs_l, ubs_l = lbs // n_dev, ubs // n_dev
    out = []
    for d in positions:
        out.extend(idx_batch[d * lbs_l:(d + 1) * lbs_l])
        out.extend(idx_batch[lbs + d * ubs_l:lbs + (d + 1) * ubs_l])
    return out


class ProcessShardedSampler(object):
    """Wrap a (two-stream) batch sampler so each process yields only its
    own slice of every batch. len() is unchanged: every process sees the
    same number of (smaller) batches. ``shard`` slices one global batch;
    the loader counts each sample's accesses over the global batch
    (``sampler``) before it slices, so that a sample's augmentation draw
    is the one-process run's."""

    def __init__(self, sampler, lbs, ubs, positions, n_dev):
        self.sampler = sampler
        self.lbs, self.ubs = lbs, ubs
        self.positions = positions
        self.n_dev = n_dev

    def __len__(self):
        return len(self.sampler)

    def shard(self, batch):
        return process_batch_indices(batch, self.lbs, self.ubs,
                                     self.positions, self.n_dev)

    def __iter__(self):
        for idx_batch in self.sampler:
            yield self.shard(idx_batch)

