"""DTensor layout helpers that need no model: a leaf module.

The kernel wrappers (``kernels/ops``), the activation context
(``distributed/context``) and the sharding rules (``distributed/sharding``)
all import this module; it imports nothing of the port, so the kernel
layer does not depend on the model package.

* :func:`axis_sizes` and :func:`placements`: a mesh's axis sizes by name,
  and a per-dimension spec tuple (``None``, one mesh axis name, or a tuple
  of names, as the reference's ``PartitionSpec``) as DTensor placements.
* :func:`shard_start`: where this rank's shard of a split dimension
  begins; :func:`all_reduce_local`: a local tensor all-reduced over some
  mesh dimensions, by DTensor; :func:`local_part`: a local shard whose
  gradient is a pending sum over the ranks that each use a part of it.
* :func:`replicate_plain_tensors`: inside the block a plain tensor that
  meets a DTensor counts as replicated.
* :class:`SeqPair`: the two ranks that hold the halves of the same
  sequences (a step whose batch does not divide its data ranks splits each
  sequence over a ``pod`` axis of two, ``sharding.split_sequences``), and
  the collectives they run on local tensors: half 0's tail handed to half
  1 (:meth:`SeqPair.shift`, differentiable; :meth:`SeqPair.hand_over`,
  not) and the halves gathered (:meth:`SeqPair.gather`).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication


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


def shard_start(x, dim: int) -> int:
    """The first index of this rank's shard of DTensor ``x``'s dimension
    ``dim``, split evenly over the mesh dimensions that shard it (the
    first of them major, as DTensor lays such a dimension out); an uneven
    split raises."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    index, n = 0, 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= mesh.size(i)
            index = index * mesh.size(i) + coord[i]
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {x.shape[dim]} split unevenly "
                         f"over {n} ranks")
    return index * (x.shape[dim] // n)


def all_reduce_local(x, mesh, dims, placements, op: str):
    """Local tensor ``x`` all-reduced (``op`` "sum" or "max") over the mesh
    dimensions ``dims``: wrapped as a pending ``op`` there and laid out
    whole, so that DTensor issues the collective (and its gradient, for a
    sum).  ``placements`` are ``x``'s on the other mesh dimensions."""
    pending = [Partial(op) if i in dims else p
               for i, p in enumerate(placements)]
    whole = [Replicate() if i in dims else p for i, p in enumerate(placements)]
    return DTensor.from_local(x, mesh, pending, run_check=False).redistribute(
        mesh, whole).to_local()


def gather_local(x, mesh, dims, dim: int, placements,
                 partial_grad: bool = True):
    """Local ``x``, this rank's slice of dimension ``dim`` split over the
    mesh dimensions ``dims``, gathered whole: one all-gather a mesh
    dimension, the last of ``dims`` first (so the first is the major
    one).  ``placements`` are ``x``'s on the other mesh dimensions.  With
    ``partial_grad`` the whole tensor's gradient is taken as a pending sum
    over ``dims`` (each rank's use of it is a part of the work) and its
    slice is reduced to each rank (a reduce-scatter); else as the same on
    every rank, of which each takes its slice."""
    dim %= x.dim()
    for i in reversed(list(dims)):
        split = [Shard(dim) if j == i else p for j, p in enumerate(placements)]
        whole = [Replicate() if j == i else p for j, p in enumerate(placements)]
        grad = [Partial() if j == i and partial_grad else p
                for j, p in enumerate(whole)]
        x = DTensor.from_local(x, mesh, split, run_check=False).redistribute(
            mesh, whole).to_local(grad_placements=grad)
    return x


def scatter_sum_local(x, mesh, dims, dim: int, placements):
    """Local ``x``, a pending sum over the mesh dimensions ``dims``, summed
    and split along ``dim``: this rank's slice (one reduce-scatter a mesh
    dimension, the first of ``dims`` first, so that it is the major one,
    as :func:`gather_local` joins them).  ``placements`` are ``x``'s on
    the other mesh dimensions."""
    dim %= x.dim()
    for i in dims:
        pending = [Partial() if j == i else p for j, p in enumerate(placements)]
        split = [Shard(dim) if j == i else p for j, p in enumerate(placements)]
        x = DTensor.from_local(x, mesh, pending, run_check=False).redistribute(
            mesh, split).to_local()
    return x


def local_part(x, partial_dims=()):
    """DTensor ``x``'s local shard, for work that each rank of the mesh
    dimensions ``partial_dims`` does on its own part of it (its heads, its
    block of a buffer): the gradient that reaches ``x`` is then a pending
    sum over those dimensions, reduced to ``x``'s layout."""
    if not partial_dims:
        return x.to_local()
    mesh, fwd = x.device_mesh, tuple(x.placements)
    if x.requires_grad:
        x = x.view_as(x)
        x.register_hook(lambda g: g if tuple(g.placements) == fwd else
                        g.redistribute(mesh, fwd))
    return x.to_local(grad_placements=[
        Partial() if i in partial_dims else p for i, p in enumerate(fwd)])


_LOCK = threading.Lock()
_DEPTH = [0]
_OUTER = [None]


@contextlib.contextmanager
def replicate_plain_tensors():
    """Inside the block a plain tensor that meets a DTensor counts as
    replicated: DTensor's ``implicit_replication``, made nestable.  That
    mode is one switch for the process, which it turns off on leaving, so
    only the outermost of nested blocks enters and leaves it."""
    with _LOCK:
        _DEPTH[0] += 1
        if _DEPTH[0] == 1:
            _OUTER[0] = implicit_replication()
            _OUTER[0].__enter__()
    try:
        yield
    finally:
        with _LOCK:
            _DEPTH[0] -= 1
            if _DEPTH[0] == 0:
                outer, _OUTER[0] = _OUTER[0], None
                outer.__exit__(None, None, None)


# ---------------------------------------------------------------------------
# The ranks that share sequences.
# ---------------------------------------------------------------------------

def _wait(x):
    """A functional collective's result, waited for."""
    return torch.ops._c10d_functional.wait_tensor(x)


class SeqPair:
    """The two ranks that hold the two halves of the same sequences, this
    rank holding half ``index``; ``group`` is their process group (a
    mesh's ``pod`` group), whose ranks are in half order.

    A train or prefill step whose global batch does not divide its data
    ranks splits each sequence in halves over a ``pod`` axis of two
    (``sharding.split_sequences``).  The blocks then run on each rank's
    half and exchange what crosses the halves' edge over ``group``, by
    functional collectives on local tensors (DTensor never sees the split,
    so its strategy search stays on the folded two-dimensional mesh):
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
        return _wait(torch.ops._c10d_functional.all_reduce(
            (x if sender else torch.zeros_like(x)).contiguous(), "sum",
            self.group.group_name))

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
        return _Gather.apply(self, x, dim % x.dim())


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


class _Gather(torch.autograd.Function):
    """:meth:`SeqPair.gather`: an all-gather forward, a reduce-scatter of
    the gradient backward."""

    @staticmethod
    def forward(ctx, pair, x, dim):
        ctx.pair, ctx.dim = pair, dim
        gather = getattr(funcol, "all_gather_single", None) or \
            funcol.all_gather_tensor
        out = gather(x.contiguous(), dim, pair.group)
        return out.wait() if hasattr(out, "wait") else out

    @staticmethod
    def backward(ctx, g):
        pair, dim = ctx.pair, ctx.dim
        part = _wait(torch.ops._c10d_functional.reduce_scatter_tensor(
            g.movedim(dim, 0).contiguous(), "sum", pair.size,
            pair.group.group_name))
        return None, part.movedim(0, dim), None
