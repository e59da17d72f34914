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
"""

from __future__ import annotations

import contextlib
import threading

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
