"""Layouts and collectives of local tensors: a leaf module.

The kernel wrappers (``kernels/ops``), the activation context
(``distributed/context``) and the sharding rules (``distributed/sharding``)
all import this module; it imports nothing of the port, so the kernel
layer does not depend on the model package.

On a mesh every op of the models runs on a **local** tensor: this rank's
block, split as the port chooses (``distributed/context``).  DTensor is
the container a step is handed and hands back (``sharding.distribute``);
its placements describe how a local tensor is laid out, and nothing here
asks DTensor to propagate an op.

* :func:`axis_sizes` and :func:`placements`: a mesh's axis sizes by name,
  and a per-dimension spec tuple (``None``, one mesh axis name, or a tuple
  of names, as the reference's ``PartitionSpec``) as DTensor placements;
  :func:`shard_start` and :func:`block_start`: where this rank's shard of
  a split dimension begins.
* :class:`Block`: a weight as this rank holds it (its local tensor, the
  mesh and the DTensor's placements): what a model uses on a mesh.
* The collectives, each an autograd function with its gradient stated:
  :func:`all_reduce_local`, :func:`gather_local`, :func:`scatter_sum_local`,
  :func:`split_local` (a slice, its gradient gathered) and
  :func:`pending_local` (the input of work split over ranks: the identity,
  its gradient all-reduced); :class:`KeySlice`, a rank's slice of a
  cache's sequence.  A collective over mesh dimensions that all have one
  rank is no call at all.  The all-gather is the blocking
  ``dist.all_gather_into_tensor`` (gloo's functional all-gather of CUDA
  tensors fails on torch 2.11); the all-reduce and the reduce-scatter
  are functional collectives.
* :class:`SeqPair`: the two ranks that hold the halves of the same
  sequences (a step whose batch does not divide its data ranks splits each
  sequence over a ``pod`` axis of two, ``sharding.split_sequences``), and
  the collectives they run on local tensors: half 0's tail handed to half
  1 (:meth:`SeqPair.shift`, differentiable; :meth:`SeqPair.hand_over`,
  not) and the halves gathered (:meth:`SeqPair.gather`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard


def axis_sizes(mesh) -> dict:
    """Mesh axis name -> its size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh, spec) -> tuple:
    """A per-dimension spec tuple -> DTensor placements over ``mesh``: one
    entry per mesh dimension, ``Shard(d)`` where tensor dimension ``d``
    names that mesh axis, else ``Replicate()``.  A dimension over
    ``("pod", "data")`` is ``Shard(d)`` on both mesh dimensions; DTensor
    splits it over the mesh dimensions in their order, pod major, as JAX
    orders the tuple."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        for a in ((part,) if isinstance(part, str) else part):
            out[mesh.mesh_dim_names.index(a)] = Shard(dim)
    return tuple(out)


def live(mesh, dims) -> list:
    """The mesh dimensions of ``dims`` that have more than one rank."""
    return [i for i in dims if mesh.size(i) > 1]


def rank_index(mesh, dims) -> tuple:
    """(this rank's index among the ranks of mesh dimensions ``dims``, the
    first major; their number)."""
    coord, index, n = mesh.get_coordinate(), 0, 1
    for i in dims:
        index = index * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    return index, n


def block_start(mesh, placements, dim: int, size: int) -> int:
    """The first index of this rank's block of dimension ``dim`` (of global
    length ``size``) laid out by ``placements`` over ``mesh``: split evenly
    over the mesh dimensions that shard it, the first of them major; an
    uneven split raises."""
    index, n = rank_index(mesh, [i for i, p in enumerate(placements)
                                 if p.is_shard(dim)])
    if size % n:
        raise ValueError(f"dimension {dim} of {size} split unevenly over "
                         f"{n} ranks")
    return index * (size // n)


def shard_start(x, dim: int) -> int:
    """The first index of this rank's shard of DTensor (or :class:`Block`)
    ``x``'s dimension ``dim``."""
    mesh = x.device_mesh if isinstance(x, DTensor) else x.mesh
    return block_start(mesh, x.placements, dim % len(x.shape), x.shape[dim])


# ---------------------------------------------------------------------------
# Weights as this rank holds them.
# ---------------------------------------------------------------------------

class Block:
    """A weight as this rank holds it: ``local``, its block, laid out over
    ``mesh`` by ``placements`` (the DTensor's it came from, whose global
    shape is ``shape``).  The local tensor's gradient is laid out the same
    way: each use gathers what it needs through the collectives below,
    whose gradients come back to ``local`` as its own block's."""

    __slots__ = ("local", "mesh", "placements", "shape")

    def __init__(self, local, mesh, placements, shape):
        self.local, self.mesh = local, mesh
        self.placements, self.shape = tuple(placements), torch.Size(shape)

    @classmethod
    def of(cls, x):
        """DTensor ``x`` as a Block (its gradient laid out as ``x``); a
        plain tensor as it is."""
        if not isinstance(x, DTensor):
            return x
        return cls(x.to_local(), x.device_mesh, x.placements, x.shape)

    def __repr__(self):
        return (f"Block({tuple(self.shape)}, local "
                f"{tuple(self.local.shape)}, {self.placements})")

    @property
    def dtype(self):
        return self.local.dtype

    def dim(self) -> int:
        return len(self.shape)

    def split(self, dim: int) -> list:
        """The mesh dimensions of more than one rank that split ``dim``."""
        dim %= self.dim()
        return [i for i, p in enumerate(self.placements)
                if p.is_shard(dim) and self.mesh.size(i) > 1]

    def __getitem__(self, i: int) -> "Block":
        """The block of index ``i`` of a leading dimension that no mesh
        dimension splits (a stacked layer's weights)."""
        if self.split(0):
            raise ValueError("a block of a split leading dimension")
        return Block(self.local[i], self.mesh, tuple(
            Shard(p.dim - 1) if p.is_shard() and p.dim > 0 else
            Replicate() if p.is_shard() else p for p in self.placements),
            self.shape[1:])

    def to(self, dtype) -> "Block":
        if self.dtype == dtype:
            return self
        return Block(self.local.to(dtype), self.mesh, self.placements,
                     self.shape)

    @property
    def T(self) -> "Block":
        swap = {0: 1, 1: 0}
        return Block(self.local.T, self.mesh, tuple(
            Shard(swap[p.dim]) if p.is_shard() else p
            for p in self.placements), tuple(reversed(self.shape)))


def whole_block(w, partial_dims=(), keep=()):
    """:class:`Block` ``w`` made whole on this rank, as a local tensor (a
    plain tensor as it is), but over the mesh dimensions ``keep``, where
    it stays this rank's block.  Its gradient is a pending sum over the
    mesh dimensions ``partial_dims`` (each rank's use of it is a part of
    the work), summed to ``w``'s layout: reduce-scattered where ``w`` is
    split, all-reduced where it is whole; over any other mesh dimension
    each rank takes its own block of it."""
    if not isinstance(w, Block):
        return w
    mesh = w.mesh
    # The pending sum over the dimensions where w is whole reduces its
    # own block, after the gathers' reduce-scatters in the backward.
    x = pending_local(w.local, mesh, [
        i for i in partial_dims
        if i not in keep and not w.placements[i].is_shard()])
    by_dim: dict = {}
    for i, p in enumerate(w.placements):
        if p.is_shard() and mesh.size(i) > 1 and i not in keep:
            by_dim.setdefault(p.dim, []).append(i)
    for dim, dims in by_dim.items():
        part = [i for i in dims if i in partial_dims]
        if part and len(part) < len(dims):
            raise ValueError(f"dimension {dim} split over {dims}, a part of "
                             f"the work over {part} only")
        x = gather_local(x, mesh, dims, dim, partial_grad=bool(part))
    return x


# ---------------------------------------------------------------------------
# Collectives on local tensors.
# ---------------------------------------------------------------------------

def _wait(x):
    """A functional collective's result, waited for."""
    return torch.ops._c10d_functional.wait_tensor(x)


def _group(mesh, i):
    return mesh.get_group(i)


def _reduce(x, op: str, group):
    return _wait(torch.ops._c10d_functional.all_reduce(
        x.contiguous(), op, group.group_name))


def _gather(x, dim: int, group):
    """All ranks' ``x`` joined along ``dim`` in rank order (the blocking
    all-gather of the leading dimension; along another one its pieces
    joined, as the functional all-gather joins them)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, x, group=group)
    return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)


def _scatter(x, dim: int, group):
    """The sum over the ranks of ``x``, this rank's slice of ``dim``."""
    n = dist.get_world_size(group)
    if dim != 0:
        x = torch.cat(x.chunk(n, dim=dim))
    return _wait(torch.ops._c10d_functional.reduce_scatter_tensor(
        x.contiguous(), "sum", n, group.group_name))


def _slice(x, dim: int, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, op, partial_grad):
        ctx.mesh, ctx.dims, ctx.partial = mesh, dims, partial_grad
        for i in dims:
            x = _reduce(x, op, _group(mesh, i))
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            for i in ctx.dims:
                g = _reduce(g, "sum", _group(ctx.mesh, i))
        return g, None, None, None, None


def all_reduce_local(x, mesh, dims, op: str = "sum",
                     partial_grad: bool = False):
    """Local ``x`` all-reduced (``op`` "sum" or "max") over the mesh
    dimensions ``dims``.  The result's gradient is the same on every rank
    (each rank holds the whole of it), so that of ``x`` is that gradient;
    with ``partial_grad`` it is a pending sum over ``dims`` (each rank's
    use of the result is a part of the work), all-reduced."""
    dims = live(mesh, dims)
    if not dims:
        return x
    return _AllReduce.apply(x, mesh, tuple(dims), op, partial_grad)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, dim, partial_grad):
        ctx.mesh, ctx.dims, ctx.dim, ctx.partial = mesh, dims, dim, \
            partial_grad
        for i in reversed(dims):
            x = _gather(x, dim, _group(mesh, i))
        return x

    @staticmethod
    def backward(ctx, g):
        for i in ctx.dims:
            g = (_scatter if ctx.partial else _slice)(
                g, ctx.dim, _group(ctx.mesh, i))
        return g, None, None, None, None


def gather_local(x, mesh, dims, dim: int, partial_grad: bool = True):
    """Local ``x``, this rank's slice of dimension ``dim`` split over the
    mesh dimensions ``dims``, gathered whole: one all-gather a mesh
    dimension, the last of ``dims`` first (so the first is the major
    one).  With ``partial_grad`` the whole tensor's gradient is a pending
    sum over ``dims`` (each rank's use of it is a part of the work) and
    its slice is reduced to each rank (a reduce-scatter); else it is the
    same on every rank, of which each takes its slice."""
    dims = live(mesh, dims)
    if not dims:
        return x
    return _Gather.apply(x, mesh, tuple(dims), dim % x.dim(), partial_grad)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, dim):
        ctx.mesh, ctx.dims, ctx.dim = mesh, dims, dim
        for i in dims:
            x = _scatter(x, dim, _group(mesh, i))
        return x

    @staticmethod
    def backward(ctx, g):
        for i in reversed(ctx.dims):
            g = _gather(g, ctx.dim, _group(ctx.mesh, i))
        return g, None, None, None


def scatter_sum_local(x, mesh, dims, dim: int):
    """Local ``x``, a pending sum over the mesh dimensions ``dims``, summed
    and split along ``dim``: this rank's slice (one reduce-scatter a mesh
    dimension, the first of ``dims`` first, so that it is the major one,
    as :func:`gather_local` joins them).  Its gradient is gathered."""
    dims = live(mesh, dims)
    if not dims:
        return x
    return _Scatter.apply(x, mesh, tuple(dims), dim % x.dim())


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, dim):
        ctx.mesh, ctx.dims, ctx.dim = mesh, dims, dim
        for i in dims:
            x = _slice(x, dim, _group(mesh, i))
        return x

    @staticmethod
    def backward(ctx, g):
        for i in reversed(ctx.dims):
            g = _gather(g, ctx.dim, _group(ctx.mesh, i))
        return g, None, None, None


def split_local(x, mesh, dims, dim: int):
    """Local ``x``, whole on every rank of ``dims``, as this rank's slice of
    ``dim`` split over them (the first major): no collective; the whole
    tensor's gradient, the same on every rank, is gathered from the
    slices'."""
    dims = live(mesh, dims)
    if not dims:
        return x
    return _Split.apply(x, mesh, tuple(dims), dim % x.dim())


class _Pending(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for i in ctx.dims:
            g = _reduce(g, "sum", _group(ctx.mesh, i))
        return g, None, None


def pending_local(x, mesh, dims):
    """Local ``x`` as the input of work that the ranks of ``dims`` share,
    each a part: the same tensor, whose gradient, a pending sum over
    ``dims``, is all-reduced."""
    dims = live(mesh, dims)
    if not dims or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Pending.apply(x, mesh, tuple(dims))


class KeySlice:
    """This rank's slice of a cache split along its sequence over the mesh
    dimensions ``dims``: its keys from position ``offset`` on.  A read of
    the cache merges the ranks' softmax terms by :meth:`reduce`."""

    __slots__ = ("offset", "mesh", "dims")

    def __init__(self, offset: int, mesh, dims):
        self.offset, self.mesh, self.dims = offset, mesh, tuple(dims)

    def reduce(self, x, op: str):
        """Local ``x`` all-reduced (``op`` "max" or "sum") over the ranks
        that hold the other slices."""
        return all_reduce_local(x, self.mesh, self.dims, op)


def stride_of(shape) -> tuple:
    """The contiguous strides of ``shape``."""
    out, n = [], 1
    for size in reversed(tuple(shape)):
        out.append(n)
        n *= size
    return tuple(reversed(out))


def wrap(x, mesh, placements, shape=None):
    """Local ``x`` laid out by ``placements`` as a DTensor (of global
    ``shape``, where the split is not even)."""
    if shape is None:
        shape = list(x.shape)
        for i, p in enumerate(placements):
            if p.is_shard():
                shape[p.dim] *= mesh.size(i)
    return DTensor.from_local(x, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=stride_of(shape))


# ---------------------------------------------------------------------------
# The ranks that share sequences.
# ---------------------------------------------------------------------------

class SeqPair:
    """The two ranks that hold the two halves of the same sequences, this
    rank holding half ``index``; ``group`` is their process group (a
    mesh's ``pod`` group), whose ranks are in half order.

    A train or prefill step whose global batch does not divide its data
    ranks splits each sequence in halves over a ``pod`` axis of two
    (``sharding.split_sequences``).  The blocks then run on each rank's
    half and exchange what crosses the halves' edge over ``group``:
    the token shift's and the causal conv's tails (:meth:`shift`), the
    recurrences' states (:meth:`hand_over`, ``kernels/ops.wkv`` and
    ``models/ssm``), and attention's keys and values (:meth:`gather`).
    Both ranks issue the same collectives in the same order, forward and
    backward, whatever their half."""

    size = 2

    def __init__(self, index: int, group):
        if index not in (0, 1):
            raise ValueError(f"half {index} of a sequence")
        if dist.get_world_size(group) != 2:
            raise ValueError(f"a pair over a group of "
                             f"{dist.get_world_size(group)} ranks")
        self.index, self.group = index, group

    @classmethod
    def over(cls, mesh, axis: str = "pod"):
        """The pair of ``mesh``'s ``axis``, which must have two ranks: this
        rank's coordinate there is its half."""
        i = mesh.mesh_dim_names.index(axis)
        if mesh.size(i) != 2:
            raise ValueError(f"sequences split over a {axis} axis of "
                             f"{mesh.size(i)}: only halves over two ranks")
        return cls(mesh.get_coordinate()[i], mesh.get_group(axis))

    def __repr__(self):
        return f"SeqPair(half {self.index})"

    def hand_over(self, x, back: bool = False):
        """Half 0's ``x`` on half 1 (with ``back``, half 1's on half 0):
        an all-reduce to which the receiving half adds zeros, so it passes
        a tensor of the same shape and dtype, whose values it does not
        use.  No gradient."""
        sender = self.index == (1 if back else 0)
        return _reduce(x if sender else torch.zeros_like(x), "sum",
                       self.group)

    def shift(self, send, first=None):
        """On half 1, half 0's ``send``; on half 0, ``first`` (zeros where
        None): a tail handed across the halves' edge, with its gradient
        handed back."""
        return _Shift.apply(self, send,
                            torch.zeros_like(send) if first is None
                            else first)

    def gather(self, x, dim: int):
        """Both halves' ``x`` joined along ``dim``, half 0 first; the
        gradient of each half's own slice is the sum over the pair."""
        return _PairGather.apply(self, x, dim % x.dim())


class _Shift(torch.autograd.Function):
    """:meth:`SeqPair.shift`: half 0's ``send`` handed to half 1, and half
    1's gradient of it handed back (:meth:`SeqPair.hand_over`)."""

    @staticmethod
    def forward(ctx, pair, send, first):
        ctx.pair = pair
        got = pair.hand_over(send)
        return first.clone() if pair.index == 0 else got

    @staticmethod
    def backward(ctx, g):
        pair = ctx.pair
        got = pair.hand_over(g, back=True)
        if pair.index == 0:
            return None, got, g
        return None, torch.zeros_like(g), None


class _PairGather(torch.autograd.Function):
    """:meth:`SeqPair.gather`: an all-gather forward, a reduce-scatter of
    the gradient backward."""

    @staticmethod
    def forward(ctx, pair, x, dim):
        ctx.pair, ctx.dim = pair, dim
        return _gather(x, dim, pair.group)

    @staticmethod
    def backward(ctx, g):
        return None, _scatter(g, ctx.dim, ctx.pair.group), None

