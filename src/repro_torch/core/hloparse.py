"""Per-rank cost meter of eager PyTorch: FLOPs, bytes and collective bytes.

The port's counterpart of ``repro/core/hloparse.py`` (the name kept, so
that a reader finds it).  The reference parses XLA's compiled HLO text;
the port has no HLO, so :class:`Meter` is a ``TorchDispatchMode`` that
sees every ATen op a region runs and keeps the reference's :class:`Cost`:

  * ``flops``: 2 * prod(output dims) * prod(contracted dims) for every
    ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / convolution (einsums and
    ``@`` decompose into these);
  * ``bytes``: the op-boundary proxy, operand plus output bytes of every op
    that moves data (views, allocations and waits move none);
  * ``bytes_hbm``: the same over the ops whose boundary traffic survives
    fusion (products, gathers and scatters, copies, sorts, reductions and
    collectives), the reference's fused proxy;
  * ``coll``: the output bytes a rank receives from each collective, under
    the reference's names (:data:`COLLECTIVES`), from both the functional
    ``_c10d_functional`` ops that DTensor issues and the in-place ``c10d``
    ops of ``torch.distributed``'s own calls.

Everything is counted on **local shards**, so a cost is per rank, as the
reference's per-partition SPMD module is: on a mesh the models run on
each rank's local tensors (``distributed/context``), and the few DTensor
ops of a step (the optimizer's pointwise update of DTensor parameters)
are passed through to DTensor's dispatch, whose local ops the meter then
counts.  An op on fake tensors (a tensor subclass's shape inference, as
DTensor's propagation runs) is no work of the program and is not
counted.  Eager PyTorch runs every layer, so there is no loop to scale by
its trip count, and the reference's ``while`` and ``conditional`` rules
have no counterpart.
Backward ops are counted as autograd runs them.  A hand kernel's
stand-in on ``meta`` shards runs no op and reports its cost by
:func:`charge` (``kernels/ops.decode_attn`` and ``wkv``).
"""

from __future__ import annotations

import dataclasses
import math
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: op name (namespace.op, overload dropped) -> collective; the rule says
#: which arguments or results are the rank's received output.
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "result"),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", "result"),
    "_c10d_functional.all_gather_into_tensor_coalesced":
        ("all-gather", "result"),
    "_c10d_functional.all_reduce": ("all-reduce", "result"),
    "_c10d_functional.all_reduce_": ("all-reduce", "result"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "result"),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", "result"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "result"),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", "result"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "result"),
    "_dtensor.shard_dim_alltoall": ("all-to-all", "result"),
    "c10d.allgather_": ("all-gather", "arg0"),
    "c10d._allgather_base_": ("all-gather", "arg0"),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", "arg0"),
    "c10d.allreduce_": ("all-reduce", "arg0"),
    "c10d.allreduce_coalesced_": ("all-reduce", "arg0"),
    "c10d.reduce_scatter_": ("reduce-scatter", "arg0"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg0"),
    "c10d.alltoall_": ("all-to-all", "arg0"),
    "c10d.alltoall_base_": ("all-to-all", "arg0"),
    "c10d.send": ("collective-permute", "arg0"),
    "c10d.recv_": ("collective-permute", "arg0"),
}

_DOTS = {"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
         "aten.convolution", "aten.convolution_backward"}

#: Ops that move no data: views, allocations, waits, metadata.
_FREE = {"aten.empty", "aten.empty_strided", "aten.empty_like",
         "aten.new_empty", "aten.new_empty_strided", "aten.lift_fresh",
         "aten.detach", "aten.alias", "aten._local_scalar_dense",
         "prim.device", "aten.sym_size", "aten.sym_stride",
         "aten.sym_numel", "aten.sym_storage_offset", "aten.is_same_size",
         "_c10d_functional.wait_tensor"}

#: Ops whose boundary traffic survives fusion (the reference's _HBM_OPS).
_HBM = _DOTS | {
    "aten.embedding", "aten.embedding_dense_backward", "aten.gather",
    "aten.scatter", "aten.scatter_add", "aten.scatter_add_",
    "aten.index", "aten.index_put", "aten.index_put_", "aten.index_add",
    "aten.index_add_", "aten.index_select", "aten.sort", "aten.topk",
    "aten.copy_", "aten._to_copy", "aten.clone", "aten.sum", "aten.mean",
    "aten.amax", "aten.max", "aten.logsumexp", "aten.cumsum"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0          # all-op boundary traffic (unfused bound)
    bytes_hbm: float = 0.0      # dot/data-movement boundary (fused proxy)
    coll: dict = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for item in x:
            yield from _tensors(item)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _dot_flops(name: str, args, out) -> float:
    if name == "aten.convolution":
        w = args[1]
        # 2 * output elements * (input channels a group * kernel size).
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    if name == "aten.convolution_backward":
        grad_out, _, w = args[:3]
        per = 2.0 * grad_out.numel() * math.prod(w.shape[1:])
        mask = args[-1]
        return per * (bool(mask[0]) + bool(mask[1]))
    a = args[1] if name in ("aten.addmm", "aten.baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


_STATE = threading.local()


def charge(flops: float, nbytes: float) -> None:
    """Add the cost of work that runs no ATen op (a hand kernel's stand-in
    on ``meta`` shards: ``kernels/ops``) to every active meter."""
    for meter in getattr(_STATE, "meters", ()):
        meter.cost.flops += flops
        meter.cost.bytes += nbytes
        meter.cost.bytes_hbm += nbytes


class Meter(TorchDispatchMode):
    """``with Meter() as m: ...`` -> ``m.cost``: the :class:`Cost` of the
    region on this rank; ``m.ops`` counts the ATen ops by name."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.ops: dict = {}

    def __enter__(self):
        _STATE.meters = getattr(_STATE, "meters", ()) + (self,)
        return super().__enter__()

    def __exit__(self, *exc):
        _STATE.meters = tuple(m for m in _STATE.meters if m is not self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor dispatches to its local shards, which come back here.
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors(out)) or any(
                isinstance(t, FakeTensor) for t in _tensors(args)):
            return out
        ns = func.namespace
        name = f"{ns}.{func._schema.name.split('::')[-1]}"
        self.ops[name] = self.ops.get(name, 0) + 1
        self._count(name, func, args, out)
        return out

    def _count(self, name, func, args, out):
        cost = self.cost
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            kind, which = coll
            if which == "result":
                moved, sent = _nbytes(out), _nbytes(args)
            else:
                moved, sent = _nbytes(args[0]), _nbytes(args[1:])
            cost.coll[kind] += moved
            cost.bytes += moved + sent
            cost.bytes_hbm += moved + sent
            return
        if name in _FREE or func.is_view:
            return
        moved = _nbytes(out) + _nbytes(args)
        cost.bytes += moved
        if name in _DOTS:
            cost.flops += _dot_flops(name, args, out if name !=
                                     "aten.convolution_backward" else None)
        if name in _HBM:
            cost.bytes_hbm += moved
