"""DTensor layout helpers that need no model: a leaf module.

The kernel wrappers (``kernels/ops``), the activation context
(``distributed/context``) and the sharding rules (``distributed/sharding``)
all import this module; it imports nothing of the port, so the kernel
layer does not depend on the model package.

* :func:`axis_sizes` and :func:`placements`: a mesh's axis sizes by name,
  and a per-dimension spec tuple (``None``, one mesh axis name, or a tuple
  of names, as the reference's ``PartitionSpec``) as DTensor placements.
* :func:`replicate_plain_tensors`: inside the block a plain tensor that
  meets a DTensor counts as replicated.
"""

from __future__ import annotations

import contextlib
import threading

from torch.distributed.tensor import Replicate, Shard
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
