"""Data parallelism over processes, one card a process (counterpart of
``pixelssl_tpu/parallel``): ``mesh`` (the collectives of a step) and
``multihost`` (the process group and each rank's slice of the input).
``parallel/spatial.py`` (``--spatial-train``, ``--spatial-val``) is not
ported yet (ROADMAP A4c)."""

from .mesh import (Mesh, make_mesh, all_sum, psum_if_parallel,
                   pmean_if_parallel, fold_rng, all_reduce_grads,
                   broadcast_module, barrier, reorder_two_stream,
                   reorder_two_stream_steps)
from . import multihost
