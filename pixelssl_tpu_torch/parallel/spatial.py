"""Spatial (height-axis) partitioning over ranks (counterpart of
``pixelssl_tpu/parallel/spatial.py``): ``--spatial-train N`` and
``--spatial-val``.

The JAX package annotates the image's H axis with a mesh axis and lets
GSPMD insert every halo exchange and every reduction over H. Torch has no
partitioner, so the port does it by hand:

* the ranks form a (data x spatial) grid (``make_mesh_2d``); the ranks of
  one data coordinate hold the rows of the same samples, each its block of
  ``row_range(H, N, spatial_rank)``: a deterministic split of the global
  height H, the first ``H % N`` blocks one row longer;
* a step or an eval forward runs inside ``sharded(mesh, height)``, which
  tells the layers the global height of the step's inputs (``active()``).
  A shard does not know its global height, so the models thread it from
  their input down (``models/layers.Conv2d.forward(x, h)``);
* every windowed op fetches the global rows its output rows read
  (``fetch_rows``): from the rank itself, from any other rank of its
  spatial group (a halo may be wider than a shard: ASPP's dilation 24 on a
  21-row map), or a fill where the row lies outside the map (0 for a
  convolution, -inf for max pooling, or the blur's reflection). Its
  backward sends each gradient row back to the rank that owns the row and
  adds it there;
* per-sample reductions over H become shares (``sample_mean``: the local
  sum over the global count), whose sum over the spatial group is the
  sample's value; per-sample extrema reduce over the spatial group
  (``sample_max``, ``sample_min``); a per-sample channel mean whose value
  every rank of the group needs (S4L's rotation head) is summed over the
  group (``channel_mean``), and a vector every rank of the group holds
  whole counts once, on spatial rank 0 (``whole_share``);
* a whole map, where rows must become columns (S4L's rotations), where a
  scan runs along H (CCT's connected components) or where it is written
  (``--visualize``, on spatial rank 0), is every rank's rows fetched
  (``whole_rows``); a map every rank holds whole gives each its own rows
  (``own_rows``);
* a sum whose parts lie on the ranks of a spatial group (PSP's pooled
  bins, a per-sample norm, ``sreg``'s valid-pixel counts) is summed over
  the group (``group_sum``); a BatchNorm over a map that every rank of the
  group holds whole counts it on spatial rank 0 only (``whole_weight``).

Transport: with NCCL a ``batch_isend_irecv`` of the rows on the card (a
CUDA graph captures it); with gloo, whose send and receive take CPU tensors
only, the rows are staged through the host.

``--spatial-train``: the step sees the samples of its data coordinate and
its rows of them; one step over the grid is the step one process takes on
the global batch (``SSLBase``). ``--spatial-val``: batch 1, each image
padded to the 32-px bucket and its H to a multiple of the rank count, H
sharded over every rank (``task_template.proxy._ValLoader``).
"""

import contextlib
import functools

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_lib
from . import multihost

# the algorithms that pair unlabeled sample i with sample i + U/2 of the
# step's unlabeled block (CutMix's mixing, JAX ssl_cutmix.py:115-133, whose
# GSPMD step sees the global block): under ``--spatial-train`` each data
# coordinate holds its share of each half (``local_samples``)
PAIRED = ('ssl_cutmix',)


def pairs_unlabeled(args):
    """Whether ``args``'s algorithm pairs its unlabeled samples across
    the halves of the block (``PAIRED``)."""
    return getattr(args, 'ssl_algorithm', None) in PAIRED


def make_mesh_2d(n_spatial, mesh=None):
    """The (data x spatial) grid of ``mesh`` (by default this process's,
    ``mesh.make_mesh``): world / ``n_spatial`` x ``n_spatial`` ranks.
    Every rank forms every group of the grid, in the same order
    (``dist.new_group``): first the spatial groups by data coordinate, then
    the data groups by spatial coordinate."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    n, world = int(n_spatial), mesh.world_size
    if n < 1 or world % n != 0:
        raise ValueError('spatial axis size {0} must divide the device count '
                         '{1}'.format(n, world))
    data_group = spatial_group = None
    if mesh.distributed:
        data_rank, spatial_rank = divmod(mesh.rank, n)
        for d in range(world // n):
            group = dist.new_group(list(range(d * n, (d + 1) * n)))
            if d == data_rank:
                spatial_group = group
        for s in range(n):
            group = dist.new_group(list(range(s, world, n)))
            if s == spatial_rank:
                data_group = group
    return mesh_lib.Mesh(mesh.rank, world, mesh.device, mesh.group,
                         n_spatial=n, data_group=data_group,
                         spatial_group=spatial_group, spatial=True)


def is_spatial_mesh(mesh):
    return bool(getattr(mesh, 'spatial', False))


def data_axis_size(mesh):
    """Ranks along the data axis: the batch-scaling factor (the proxy's
    batch and lr, ``--fd-lr``'s and ``--discriminator-lr``'s rank
    scaling). Spatial ranks split each image's work, not the batch."""
    return mesh.data_size if is_spatial_mesh(mesh) else mesh.world_size


def pad_height_to(mesh, x, multiple=None, fill=0):
    """Pad axis 1 (H) of an [N,H,...] numpy array to a multiple of
    ``multiple``, by default the rank count, with ``fill``; returns
    (padded, original H)."""
    n = multiple or mesh.world_size
    x = np.asarray(x)
    h = x.shape[1]
    pad = (-h) % n
    if pad == 0:
        return x, h
    widths = [(0, 0)] * x.ndim
    widths[1] = (0, pad)
    return np.pad(x, widths, constant_values=fill), h


def row_range(h, n, r):
    """Global rows [start, stop) of spatial rank ``r`` of ``n`` in a map of
    ``h`` rows: blocks of ``h // n``, the first ``h % n`` one row longer."""
    base, extra = divmod(int(h), int(n))
    start = r * base + min(r, extra)
    return start, start + base + (1 if r < extra else 0)


def local_rows(h, mesh):
    return row_range(h, mesh.n_spatial, mesh.spatial_rank)


def window_rows(h_out, n, stride, padding, extent):
    """For each spatial rank, the input rows [a, b) that its output rows of
    a window op read: ``extent`` rows (``dilation * (k - 1) + 1``) from
    ``o * stride - padding`` on, for each of its output rows ``o``."""
    rows = []
    for q in range(n):
        o0, o1 = row_range(h_out, n, q)
        a = o0 * stride - padding
        rows.append((a, (o1 - 1) * stride - padding + extent if o1 > o0
                     else a))
    return tuple(rows)


def conv_out(h, kernel, stride=1, padding=0, dilation=1):
    """Output height of a convolution or pooling window over ``h`` rows."""
    return (h + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


# ---------------------------------------------------------------------------
# the spatial context of a step or an eval forward
# ---------------------------------------------------------------------------

class Rows(object):
    """``mesh`` (a grid of ``make_mesh_2d``) and ``height``, the global
    height of the inputs of the step or forward in progress."""

    def __init__(self, mesh, height):
        self.mesh = mesh
        self.height = int(height)


# one per process: the models read it where the step's inputs enter them,
# and the checkpointed recompute of ``--remat`` reads it from the autograd
# thread, which a thread-local would not reach
_active = None


@contextlib.contextmanager
def sharded(mesh, height):
    """Row-sharded forms of the layers inside the block, the inputs being
    ``height`` rows high (a shard each rank of ``mesh``'s spatial
    group)."""
    global _active
    previous, _active = _active, Rows(mesh, height)
    try:
        yield _active
    finally:
        _active = previous


def active():
    """The ``Rows`` of the step in progress, or None outside one."""
    return _active


def global_height(x, dim=2):
    """The global height of a map at the step's input resolution: the
    context's, or ``x``'s own outside one."""
    return _active.height if _active is not None else x.shape[dim]


def sample_mean(x, h_dim=2):
    """Per-sample mean over every axis but the first, [N]; inside a
    context this rank's share of it, the local sum over the global count,
    for a map whose axis ``h_dim`` is at the step's input height."""
    dims = tuple(range(1, x.dim()))
    if _active is None:
        return x.mean(dim=dims)
    count = x[0].numel() // max(x.shape[h_dim], 1) * _active.height
    return x.sum(dim=dims) / count


def group_sum(x):
    """``x`` summed over the ranks of the spatial group inside a context
    (``all_sum``: differentiable, the gradient of each rank's part the
    group's summed gradient); ``x`` itself outside one."""
    if _active is None:
        return x
    mesh = _active.mesh
    if not mesh.distributed or mesh.n_spatial == 1:
        return x
    return mesh_lib.all_sum(x, mesh, mesh.spatial_group)


def channel_mean(x, h):
    """Per-sample, per-channel mean over H x W of a [N,C,H,W] map, [N,C];
    inside a context that of the map ``h`` rows high whose rows the spatial
    group holds, the same on every rank of it: the local sums in float32
    summed over the group (``group_sum``, so that each rank's rows get the
    whole gradient)."""
    if _active is None:
        return x.mean(dim=(2, 3))
    total = group_sum(x.float().sum(dim=(2, 3)))
    return (total / (int(h) * x.shape[3])).to(x.dtype)


def whole_share(vec):
    """A per-sample vector that every rank of a spatial group holds whole
    (S4L's rotation logits give one) as shares whose sum over the group is
    the vector: itself on spatial rank 0, zeros in the graph on the others
    (their backward joins every exchange). Itself outside a context."""
    if _active is None or _active.mesh.spatial_rank == 0:
        return vec
    return vec * 0.0


def pixel_mean(x, mesh):
    """The mean of every element of ``x`` over the ranks of ``mesh``, each
    element counted once (uneven row blocks weigh by their rows, not by
    rank), no gradient; ``x.mean()`` in one process."""
    x = x.detach().float()
    if mesh is None or not mesh.distributed:
        return x.mean()
    sums = torch.stack([x.sum(), torch.full((), float(x.numel()),
                                            device=x.device)])
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
    return sums[0] / sums[1]


def _sample_extremum(x, op):
    dims = tuple(range(1, x.dim()))
    local = x.amax(dim=dims, keepdim=True) if op == dist.ReduceOp.MAX \
        else x.amin(dim=dims, keepdim=True)
    if _active is None or not _active.mesh.distributed or \
            _active.mesh.n_spatial == 1:
        return local
    local = local.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(local, op=op, group=_active.mesh.spatial_group)
    return local


def whole_weight(x):
    """The ``sample_weight`` of a BatchNorm in training over a map that
    every rank of the spatial group holds whole (PSP's pooled bins): 1 a
    sample on spatial rank 0 and 0 on the others, so that the grid's
    ``(sum, ssum, count)`` count each sample once, as one process counts
    it (the unbiased running variance with them). Every rank still
    normalises its copy, and the gradients that the statistics pass back
    reach the copy of rank 0 alone, which makes their sum over the group
    one process's. None outside a context."""
    if _active is None or _active.mesh.n_spatial == 1:
        return None
    return torch.full((x.shape[0],), 1.0 if _active.mesh.spatial_rank == 0
                      else 0.0, dtype=torch.float32, device=x.device)


def own_rows(x, h, dim=2):
    """This rank's rows along ``dim`` of a map ``h`` rows high that every
    rank of the spatial group holds whole; ``x`` itself outside a
    context."""
    if _active is None:
        return x
    r0, r1 = local_rows(h, _active.mesh)
    return x.narrow(dim, r0, r1 - r0)


def sample_max(x):
    """Per-sample maximum over every axis but the first (keepdim), over
    the sample's rows on every rank of the spatial group inside a context;
    without gradient there."""
    return _sample_extremum(x, dist.ReduceOp.MAX)


def sample_min(x):
    return _sample_extremum(x, dist.ReduceOp.MIN)


# ---------------------------------------------------------------------------
# fetch_rows
# ---------------------------------------------------------------------------

ZERO = 'zero'
NEG_INF = 'neg_inf'
REFLECT = 'reflect'


def _source(j, h, fill):
    """The global row that row ``j`` of the padded map reads, or None for a
    fill. ``REFLECT`` folds as ``jnp.pad(mode='reflect')`` applied again
    until the row is inside (the edge not repeated: -1 -> 1, h -> h-2),
    ``ops.blur._blur_matrix``'s rule."""
    if 0 <= j < h:
        return j
    if fill != REFLECT:
        return None
    if h == 1:
        return 0
    while j < 0 or j >= h:
        if j < 0:
            j = -j
        if j >= h:
            j = 2 * (h - 1) - j
    return j


class _Plan(object):
    """What rank ``r`` sends and receives to assemble its rows of a
    ``fetch_rows``, the same computation on every rank."""

    def __init__(self, h, n, r, rows, fill):
        owners = [row_range(h, n, q) for q in range(n)]

        def owner(g):
            for q, (lo, hi) in enumerate(owners):
                if lo <= g < hi:
                    return q
            raise AssertionError(g)

        needs = []  # needs[q][p]: sorted global rows q reads from p
        sources = []
        for q, (a, b) in enumerate(rows):
            src = [_source(j, h, fill) for j in range(a, b)]
            need = {}
            for g in sorted(set(s for s in src if s is not None)):
                need.setdefault(owner(g), []).append(g)
            needs.append(need)
            sources.append(src)
        lo, hi = owners[r]
        self.local = hi - lo
        # local indices of the rows each other rank reads from this one
        self.send = {q: tuple(g - lo for g in needs[q][r])
                     for q in range(n) if q != r and r in needs[q]}
        # global rows this rank reads from each other rank
        self.recv = {p: tuple(rows_p) for p, rows_p in needs[r].items()
                     if p != r}
        position, offset = {}, self.local
        for p in sorted(self.recv):
            for i, g in enumerate(self.recv[p]):
                position[g] = offset + i
            offset += len(self.recv[p])
        self.has_fill = any(s is None for s in sources[r])
        self.src_rows = offset + (1 if self.has_fill else 0)
        self.index = tuple(offset if s is None else
                           (s - lo if lo <= s < hi else position[s])
                           for s in sources[r])


@functools.lru_cache(maxsize=4096)
def _plan(h, n, r, rows, fill):
    return _Plan(h, n, r, rows, fill)


@functools.lru_cache(maxsize=4096)
def _index(values, device):
    """An index tensor on ``device``, made once: a captured step copies
    nothing from the host."""
    return torch.tensor(values, dtype=torch.long, device=device)


def _narrow_shape(x, dim, rows):
    shape = list(x.shape)
    shape[dim] = rows
    return shape


def _exchange(mesh, outgoing, incoming, like, dim):
    """Send ``outgoing[q]`` to spatial rank q and receive ``incoming[p]``
    rows (along ``dim``, else ``like``'s shape) from spatial rank p; returns
    ``{p: tensor on like's device}``. NCCL: one ``batch_isend_irecv`` on
    the card. gloo: through the host, as bytes (its send and receive take
    CPU tensors)."""
    if not outgoing and not incoming:
        return {}
    peers = mesh.spatial_ranks
    shapes = {p: _narrow_shape(like, dim, n) for p, n in incoming.items()}
    if dist.get_backend(mesh.group) == 'nccl':
        bufs = {p: like.new_empty(shape) for p, shape in shapes.items()}
        ops = [dist.P2POp(dist.isend, t.contiguous(), peers[q], mesh.group)
               for q, t in sorted(outgoing.items())]
        ops += [dist.P2POp(dist.irecv, bufs[p], peers[p], mesh.group)
                for p in sorted(bufs)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return bufs
    sends = {q: t.detach().contiguous().cpu() for q, t in outgoing.items()}
    bufs = {p: torch.empty(shape, dtype=like.dtype)
            for p, shape in shapes.items()}
    reqs = [dist.isend(_bytes(t), peers[q], group=mesh.group)
            for q, t in sorted(sends.items())]
    reqs += [dist.irecv(_bytes(bufs[p]), peers[p], group=mesh.group)
             for p in sorted(bufs)]
    for req in reqs:
        req.wait()
    return {p: b.to(like.device) for p, b in bufs.items()}


def _bytes(t):
    """A contiguous CPU tensor's bytes, a view (gloo moves bytes whatever
    the dtype)."""
    return t.reshape(-1).view(torch.uint8)


class _FetchRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, plan, mesh, dim, fill_value):
        ctx.plan, ctx.mesh, ctx.dim = plan, mesh, dim
        device = x.device
        outgoing = {q: x.index_select(dim, _index(idx, device))
                    for q, idx in plan.send.items()}
        received = _exchange(mesh, outgoing,
                             {p: len(g) for p, g in plan.recv.items()}, x,
                             dim)
        parts = [x] + [received[p] for p in sorted(received)]
        if plan.has_fill:
            parts.append(torch.full(_narrow_shape(x, dim, 1), fill_value,
                                    dtype=x.dtype, device=device))
        src = torch.cat(parts, dim) if len(parts) > 1 else x
        return src.index_select(dim, _index(plan.index, device))

    @staticmethod
    def backward(ctx, grad):
        plan, mesh, dim = ctx.plan, ctx.mesh, ctx.dim
        device = grad.device
        g_src = grad.new_zeros(_narrow_shape(grad, dim, plan.src_rows))
        g_src.index_add_(dim, _index(plan.index, device), grad)
        outgoing, offset = {}, plan.local
        for p in sorted(plan.recv):
            n = len(plan.recv[p])
            outgoing[p] = g_src.narrow(dim, offset, n)
            offset += n
        back = _exchange(mesh, outgoing,
                         {q: len(idx) for q, idx in plan.send.items()},
                         grad, dim)
        g_local = g_src.narrow(dim, 0, plan.local).contiguous()
        for q, idx in sorted(plan.send.items()):
            g_local.index_add_(dim, _index(idx, device), back[q])
        return g_local, None, None, None, None


_FILL_VALUES = {ZERO: 0.0, NEG_INF: float('-inf'), REFLECT: 0.0}


def fetch_rows(x, h, rows, mesh, fill=ZERO, dim=2):
    """Global rows ``rows[spatial_rank]`` = [a, b) of a map of ``h`` rows
    sharded along ``dim`` over the spatial group of ``mesh`` (``x``: this
    rank's ``local_rows(h, mesh)``). ``rows`` holds the request of every
    rank of the group, which each rank serves from the rows it owns; a row
    outside [0, h) is a fill (``ZERO``, ``NEG_INF``) or its reflection
    (``REFLECT``). Every rank of the group calls it together, as it would a
    collective. Differentiable: the gradient of a fetched row is sent to
    its owner and added there."""
    n, r = mesh.n_spatial, mesh.spatial_rank
    lo, hi = row_range(h, n, r)
    if x.shape[dim] != hi - lo:
        raise ValueError('fetch_rows: rank {0} holds {1} rows of {2}, not '
                         'the {3} of its block'.format(
                             r, x.shape[dim], h, hi - lo))
    plan = _plan(int(h), n, r, tuple((int(a), int(b)) for a, b in rows),
                 fill)
    return _FetchRows.apply(x, plan, mesh, dim, _FILL_VALUES[fill])


def whole_rows(x, dim=2, to=None):
    """Every row of a map of which ``x`` holds this rank's rows along
    ``dim`` at the context's height, on every rank of the spatial group (a
    ``fetch_rows`` of [0, H) for each), or on spatial rank ``to`` alone
    (the others get no rows); ``x`` itself outside a context."""
    if _active is None:
        return x
    h = _active.height
    rows = tuple((0, h) if to is None or q == to else (0, 0)
                 for q in range(_active.mesh.n_spatial))
    return fetch_rows(x, h, rows, _active.mesh, ZERO, dim)


# ---------------------------------------------------------------------------
# batches on the host
# ---------------------------------------------------------------------------

def local_samples(lbs, ubs, mesh, paired=False):
    """The blocks [a, b) of the global labeled-first batch (``lbs`` +
    ``ubs``) that the ranks of this data coordinate hold: its labeled and
    its unlabeled chunk (``parallel.reorder_two_stream``'s block); with
    ``paired`` (``pairs_unlabeled``) its chunk of each half of the
    unlabeled block instead, so that its unlabeled sample i + U/2D is the
    partner of its sample i, as sample i + U/2 is of sample i in the
    global block."""
    n, d = mesh.data_size, mesh.data_rank
    lbs_l, ubs_l = lbs // n, ubs // n
    labeled = (d * lbs_l, (d + 1) * lbs_l)
    if not paired:
        return (labeled, (lbs + d * ubs_l, lbs + (d + 1) * ubs_l))
    half, h = ubs // 2, ubs_l // 2
    return (labeled, (lbs + d * h, lbs + (d + 1) * h),
            (lbs + half + d * h, lbs + half + (d + 1) * h))


def grid_position(n_spatial, rank=None, world_size=None):
    """A group-less ``Mesh`` of this process's place in a grid of
    ``n_spatial`` columns (the current process group's rank and size by
    default): enough to cut its part of a batch on the host."""
    if rank is None:
        initialized = dist.is_available() and dist.is_initialized()
        rank = dist.get_rank() if initialized else 0
        world_size = dist.get_world_size() if initialized else 1
    return mesh_lib.Mesh(rank, world_size, n_spatial=n_spatial,
                         spatial=True)


def shard_train_batch(arrays, lbs, ubs, mesh, paired=False):
    """This rank's part of global labeled-first NHWC/[N,H,W] host arrays:
    the samples of its data coordinate (``local_samples``) and its rows;
    returns (arrays, global height)."""
    out = []
    for a in arrays:
        a = np.concatenate([a[s:e] for s, e in local_samples(
            lbs, ubs, mesh, paired)])
        lo, hi = local_rows(a.shape[1], mesh)
        out.append(np.ascontiguousarray(a[:, lo:hi]))
    return tuple(out), int(arrays[0].shape[1])


def host_rows(tensors, mesh):
    """This rank's rows (axis 1) of each host tensor, NHWC images or
    [N,H,W] labels, contiguous."""
    out = []
    for t in tensors:
        lo, hi = local_rows(t.shape[1], mesh)
        out.append(t.narrow(1, lo, hi - lo).contiguous())
    return tuple(out)


class GridSampler(multihost.ProcessShardedSampler):
    """``ProcessShardedSampler`` on a grid: each rank cuts every global
    batch to the samples of its data coordinate (``local_samples``, their
    pairs kept with ``paired``)."""

    def __init__(self, sampler, lbs, ubs, mesh, paired=False):
        super(GridSampler, self).__init__(sampler, lbs, ubs,
                                          [mesh.data_rank], mesh.data_size)
        self.blocks = local_samples(lbs, ubs, mesh, paired)

    def shard(self, batch):
        batch = list(batch)
        return [batch[i] for a, b in self.blocks for i in range(a, b)]
