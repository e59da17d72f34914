"""Logical-axis -> mesh sharding rules (MaxText-style), per arch x shape.

Port of ``repro/distributed/sharding.py``, with the reference's rules
dicts unchanged.  Parameters and activations carry *logical* axis names
(``models/layers.Spec``); this module maps them onto the mesh:

  * ``data`` mesh axis (plus ``pod`` when multi-pod): FSDP -- parameters
    are sharded along their ``embed`` dimension; batch dims of activations
    are data-parallel over the same axes;
  * ``model`` mesh axis: tensor parallelism over heads / mlp / vocab /
    experts, and the *sequence* axis of decode KV caches (the channelized
    layout: each rank holds 1/N of the context).

A dimension that does not divide by its axes' size is replicated.

Where the reference builds ``NamedSharding(mesh, PartitionSpec(...))``,
the port builds :class:`Sharding` ``(mesh, spec)``: ``spec`` is the same
per-dimension tuple (``None``, one mesh axis name, or a tuple of names),
and :attr:`Sharding.placements` turns it into DTensor placements for a
``torch.distributed.device_mesh.DeviceMesh`` (``distributed/layout``'s
:func:`placements`: pod major, as JAX orders a tuple of axes).

The functions read only ``mesh.mesh_dim_names`` and ``mesh.shape``, so
any object with those two attributes stands in for a mesh (the tests'
full-size meshes of 256 and 512 ranks).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.layout import axis_sizes, placements
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def fsdp_axes(mesh):
    """The mesh axes used for data/FSDP sharding ('pod' folds into it)."""
    if "pod" in mesh.mesh_dim_names:
        return ("pod", "data")
    return ("data",)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


class Sharding(NamedTuple):
    """A spec tuple on a mesh: the port's ``NamedSharding``."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


#: logical name -> mesh axes, training rules.  None = replicated.
def train_rules(mesh, cfg: ModelConfig) -> dict:
    fsdp = fsdp_axes(mesh)
    rules = {
        "embed": fsdp,             # FSDP: shard params along d_model
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),     # EP
        "layers": None,
        "experts_router": None,
        "ssm_inner": None,
        "conv": None,
        "rank": None,
        "mix": None,
        "frontend": None,
    }
    if cfg.family == "moe":
        # EP owns the model axis; per-expert mats replicated across it.
        rules["mlp"] = None
    return rules


def decode_rules(mesh, cfg: ModelConfig) -> dict:
    """Serving rules: weights TP-sharded; FSDP gathering at every decode
    step would be latency-poison, so ``embed`` stays replicated and the
    batch axis carries data parallelism."""
    return dict(train_rules(mesh, cfg), embed=None)


def spec_for(shape, axes, rules, mesh) -> tuple:
    parts = []
    for dim, name in zip(shape, axes):
        mesh_axes = rules.get(name)
        if mesh_axes is None:
            parts.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        if dim % axis_size(mesh, mesh_axes) != 0:
            parts.append(None)          # undivisible -> replicate
        else:
            parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    return tuple(parts)


def param_shardings(model, mesh, rules: dict):
    """:class:`Sharding` tree matching the model's parameter tree."""
    return L.unflatten_tree(
        (path, Sharding(mesh, spec_for(s.shape, s.axes, rules, mesh)))
        for path, s in L.flatten_tree(model.specs()))


def _batch_part(mesh):
    fsdp = fsdp_axes(mesh)
    return fsdp if len(fsdp) > 1 else fsdp[0]


def batch_shardings(mesh, batch_tree) -> dict:
    """Batch dims shard over (pod+)data; everything else replicated."""
    fa, n = _batch_part(mesh), axis_size(mesh, fsdp_axes(mesh))

    def one(leaf):
        nd = len(leaf.shape)
        if nd == 0 or leaf.shape[0] % n != 0:
            return Sharding(mesh, (None,) * nd)
        return Sharding(mesh, (fa,) + (None,) * (nd - 1))

    return L.map_tree(one, batch_tree)


def sequence_parts(mesh, global_batch: int, seq_len: int) -> int:
    """The parts a train or prefill step splits each sequence into on
    ``mesh``: 1 where the batch divides the data ranks (``pod`` x
    ``data``); else the ``pod`` axis's size P, where P x the batch divides
    them and P divides the sequence (the multi-pod ``prefill_32k`` cells:
    32 sequences on 64 data ranks, two halves each).  Anything else
    raises: a step never replicates its batch over data ranks."""
    n = axis_size(mesh, fsdp_axes(mesh))
    if global_batch % n == 0:
        return 1
    pod = axis_sizes(mesh).get("pod", 1)
    if pod > 1 and (pod * global_batch) % n == 0 and seq_len % pod == 0:
        return pod
    raise ValueError(f"a batch of {global_batch} x {seq_len} does not "
                     f"divide the {n} data ranks of {axis_sizes(mesh)}, nor "
                     f"do its sequences split over its pod axis")


def split_sequences(mesh, batch: dict, parts: int) -> dict:
    """A batch of whole sequences (every leaf (B, S, ...)) re-indexed as
    the parts of its sequences: (P B, S / P, ...), row p B + b holding
    part p (positions p S / P on) of sequence b.  Sharded over the folded
    (pod x data) axis, pod major, rank p D + d then holds part p of the
    sequences of data rank d.  ``parts`` must be ``mesh``'s ``pod`` size
    and divide S, else this raises."""
    pod = axis_sizes(mesh).get("pod", 1)
    if parts != pod:
        raise ValueError(f"{parts} parts a sequence over a pod axis of "
                         f"{pod}")

    def one(x):
        b, s = x.shape[:2]
        if s % parts:
            raise ValueError(f"a sequence of {s} does not split into "
                             f"{parts} parts")
        rest = tuple(x.shape[2:])
        return x.reshape((b, parts, s // parts) + rest).swapaxes(0, 1) \
            .reshape((parts * b, s // parts) + rest)
    return L.map_tree(one, batch)


def cache_shardings(cfg: ModelConfig, mesh, cache_tree,
                    kv_channels: bool = True) -> dict:
    """Decode-cache shardings.

    KV tensors (layers/groups, B, S, Hk, hd): batch over (pod+)data and --
    when ``kv_channels`` -- sequence over ``model``: the channelized layout
    where each rank owns 1/N of the context and streams only its local
    memory.  SSM states (small, per-sequence) shard over batch only.  The
    port's ``len`` is a host int: it has no sharding and keeps none.
    """
    fa = _batch_part(mesh)
    data_n = axis_size(mesh, fsdp_axes(mesh))
    model_n = axis_sizes(mesh).get("model", 1)

    def one(name, leaf):
        if not torch.is_tensor(leaf):
            return None
        nd = len(leaf.shape)
        if nd <= 1:
            return Sharding(mesh, (None,) * nd)
        batch_ok = leaf.shape[1] % data_n == 0
        if name in ("k", "v"):
            seq_ok = kv_channels and leaf.shape[2] % model_n == 0
            return Sharding(mesh, (None, fa if batch_ok else None,
                                   "model" if seq_ok else None, None, None))
        # ssm_state / conv / shift states: (L, B, ...)
        return Sharding(mesh, (None, fa if batch_ok else None) +
                        (None,) * (nd - 2))

    return {name: one(name, leaf) for name, leaf in cache_tree.items()}


def replicated(mesh, tree):
    return L.map_tree(lambda leaf: Sharding(mesh, (None,) * leaf.dim()),
                      tree)


def distribute(tree, shardings):
    """Each tensor of ``tree`` as a DTensor laid out by its
    :class:`Sharding` (a ``None`` sharding keeps the leaf as it is: the
    cache's host-int length)."""
    def one(x, sh):
        if sh is None:
            return x
        return distribute_tensor(x, sh.mesh, sh.placements)
    return L.map_tree(one, tree, shardings)
