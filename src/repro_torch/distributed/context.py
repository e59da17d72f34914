"""Activation-sharding context: constraint injection without config plumbing.

Port of ``repro/distributed/context.py``.  Model code calls
``constrain(x, ("batch", "seq", "embed"))`` at layer boundaries and
``use_params(p, spec_map)`` where a layer uses its weights; by default
both return their input.  A launcher (``launch/dryrun``, ``chip_smoke``,
the tests) activates rules while it runs the model:

    with activation_rules(mesh, {"batch": ("data",), "seq": "model"}):
        loss, _ = model.loss(params, batch)

Where the reference pins GSPMD's layout with
``with_sharding_constraint``, the port redistributes a DTensor to the
rule's placements (``DTensor.redistribute``): the same collectives, issued
eagerly.  A plain tensor passes through unchanged.  While rules are
active, a plain tensor that meets a DTensor in an op (the RoPE tables,
masks, positions and ``arange``s the model builds itself) counts as
replicated over the mesh (:func:`replicate_plain_tensors`), so a model fed
DTensors runs its own code unchanged.

``use_params`` gathers a layer's FSDP-sharded weights at their use site
(embed dimension replicated, TP dimensions kept on ``model``).  The
reference does so only when the rules set ``fsdp_gather`` and otherwise
leaves the choice to GSPMD; the port gathers under any active rules,
because DTensor left to itself contracts over the sharded embed dimension
and picks layouts for the partial sums that it cannot always take back
(the multi-pod ``prefill_32k`` cell, whose batch of 32 does not divide its
64 data ranks, fails in the backward without the gather).  So the port
has no ``fsdp_gather`` rule.  ``gather_params`` lays out any named weights
as asked (an embedding table whose vocabulary is not split, before its
lookup).  A table or head whose vocabulary is split over ``model`` is used
in place, vocab-parallel (``models/layers.embed_apply`` and
``chunked_ce_loss``): DTensor's own masked lookup leaves a partial sum
that its later reduction mis-shapes.

Nothing here changes a value: with no active rules every path is
numerically exactly what it is without this module.
"""

from __future__ import annotations

import contextlib
import threading

from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.layout import (axis_sizes, placements,
                                            replicate_plain_tensors)

_STATE = threading.local()


@contextlib.contextmanager
def activation_rules(mesh, rules: dict):
    """Enable logical->mesh activation constraints inside the block."""
    old = getattr(_STATE, "value", None)
    _STATE.value = (mesh, rules)
    try:
        with replicate_plain_tensors():
            yield
    finally:
        _STATE.value = old


def active():
    """(mesh, rules) of the enclosing ``activation_rules``, or None."""
    return getattr(_STATE, "value", None)


def flag(name: str) -> bool:
    state = active()
    return bool(state and state[1].get(name))


def _fit(x, parts, sizes) -> tuple:
    """``parts`` with every axis that does not divide its dim dropped."""
    fixed = []
    for dim, part in zip(x.shape, parts):
        axes = (part,) if isinstance(part, str) else (part or ())
        n = 1
        for a in axes:
            n *= sizes[a]
        fixed.append(part if axes and dim % n == 0 else None)
    return tuple(fixed)


def _redistribute(x, parts):
    """``x`` laid out as ``parts``; so is its gradient, as JAX binds a
    sharding constraint's cotangent to the same sharding."""
    mesh = x.device_mesh
    want = placements(mesh, _fit(x, parts, axis_sizes(mesh)))

    def laid_out(t):
        # A mesh dimension of one rank holds the whole tensor whatever it
        # says, unless a reduction is pending there.
        return all(p == w or (mesh.size(i) == 1 and not p.is_partial())
                   for i, (p, w) in enumerate(zip(t.placements, want)))

    if not laid_out(x):
        x = x.redistribute(mesh, want)
    elif x.requires_grad:
        x = x.view_as(x)
    if x.requires_grad:
        x.register_hook(lambda g: g if laid_out(g) else
                        g.redistribute(mesh, want))
    return x


def whole_heads(x, n_heads: int, dim: int = -1):
    """``x`` laid out so that each shard of dimension ``dim`` (``n_heads``
    heads, or groups, of equal width) holds whole heads: a mesh dimension
    that splits it otherwise is gathered (replicated).  A plain tensor, or
    one whose shards hold whole heads, is returned as it is.  (GSPMD
    splits a head across devices; DTensor cannot take such a shard apart
    into heads.)"""
    if not isinstance(x, DTensor):
        return x
    mesh, dim = x.device_mesh, dim % x.dim()
    split = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            split *= mesh.size(i)
    if n_heads % split == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p
                                 for p in x.placements])


def gather_params(tree: dict, spec_map: dict) -> dict:
    """Each DTensor ``tree[name]`` laid out as ``spec_map[name]``: the
    per-dimension mesh axis or None (replicated)."""
    out = dict(tree)
    for name, parts in spec_map.items():
        x = out.get(name)
        if isinstance(x, DTensor):
            out[name] = _redistribute(x, parts)
    return out


def use_params(tree: dict, spec_map: dict) -> dict:
    """Gather parameter *use* sites to their FSDP-unsharded layout
    (embed dim replicated, TP dims kept on ``model``) under any active
    rules (module note); no-op without."""
    if active() is None:
        return tree
    return gather_params(tree, spec_map)


def constrain(x, logical_axes: tuple):
    """Lay a DTensor ``x`` out by the active rules (no-op by default and
    for plain tensors)."""
    state = active()
    if state is None or not isinstance(x, DTensor):
        return x
    _, rules = state
    return _redistribute(x, [rules.get(name) for name in logical_axes])
