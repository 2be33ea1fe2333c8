"""Runs over several processes, one card a process (counterpart of
``pixelssl_tpu/parallel``): ``mesh`` (the ranks, their data x spatial grid
and the collectives of a step), ``multihost`` (the process group and each
rank's slice of the input) and ``spatial`` (``--spatial-train``,
``--spatial-val``: rows of each image over ranks, with hand-written halo
exchanges; every algorithm and model of the JAX package, and
``--visualize``)."""

from .mesh import (Mesh, make_mesh, all_sum, psum_if_parallel, fold_rng,
                   all_reduce_grads, broadcast_module, barrier,
                   reorder_two_stream, reorder_two_stream_steps)
from .spatial import (make_mesh_2d, is_spatial_mesh, data_axis_size,
                      pad_height_to, row_range, fetch_rows)
from . import multihost
from . import spatial
