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

A step whose batch rows are the parts of split sequences
(``sharding.split_sequences``) runs under a ``seq_pair`` rule, the
:class:`~repro_torch.distributed.layout.SeqPair` of the ranks that hold
the parts of the same sequences (:func:`seq_pair`): the blocks hand
what crosses a part's edge over it (the token shift's and the conv's
tails, the recurrences' states, attention's keys and values).

Nothing here changes a value: with no active rules every path is
numerically exactly what it is without this module.
"""

from __future__ import annotations

import contextlib
import types

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.layout import (axis_sizes, local_part,
                                            placements,
                                            replicate_plain_tensors)

# Process-wide, not a thread's own: autograd runs a CUDA backward, and the
# recompute of a remat layer inside it, on a device thread of its own,
# where the model's hooks must see the same rules as in the forward.
_STATE = types.SimpleNamespace(value=None)


@contextlib.contextmanager
def activation_rules(mesh, rules: dict):
    """Enable logical->mesh activation constraints inside the block."""
    old = _STATE.value
    _STATE.value = (mesh, rules)
    try:
        with replicate_plain_tensors():
            yield
    finally:
        _STATE.value = old


def active():
    """(mesh, rules) of the enclosing ``activation_rules``, or None."""
    return _STATE.value


def flag(name: str) -> bool:
    state = active()
    return bool(state and state[1].get(name))


def seq_pair():
    """The active rules' ``seq_pair`` (a ``layout.SeqPair``: each
    sequence of the batch split into parts over the ``pod`` axis,
    ``sharding.split_sequences``), or None."""
    state = active()
    return state[1].get("seq_pair") if state else None


def pair_shift(send, first=None):
    """:meth:`SeqPair.shift <repro_torch.distributed.layout.SeqPair.shift>`
    of the active ``seq_pair`` on the local shards of a DTensor ``send``
    (``first`` laid out as ``send``; a plain tensor counts as
    replicated): the rows' tails handed to the next part of each
    sequence."""
    pair = seq_pair()
    if not isinstance(send, DTensor):
        return pair.shift(send, first)
    mesh = send.device_mesh
    want = [Replicate() if p.is_partial() else p for p in send.placements]
    if tuple(want) != tuple(send.placements):
        send = send.redistribute(mesh, want)
    if first is not None:
        if not isinstance(first, DTensor):
            first = DTensor.from_local(first, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
        if tuple(first.placements) != tuple(want):
            first = first.redistribute(mesh, want)
        first = first.to_local()
    return DTensor.from_local(pair.shift(send.to_local(), first), mesh,
                              want, run_check=False)


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


def grouped_heads(x, n_heads: int, n_kv_heads: int, dim: int = -1):
    """``x`` (``n_heads`` query heads along ``dim``) laid out so that each
    shard holds whole KV groups or lies inside one group: a mesh
    dimension that splits it otherwise is gathered (replicated).  Unlike
    :func:`whole_heads` over the KV heads, this keeps starcoder2-3b's 24
    query heads (2 groups of 12) split 3 a rank over 8 ranks, as GSPMD
    splits the reference's; each rank then attends with its group's KV
    head alone."""
    if not isinstance(x, DTensor):
        return x
    mesh, dim = x.device_mesh, dim % x.dim()
    split = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            split *= mesh.size(i)
    group = n_heads // n_kv_heads
    if n_heads % split == 0 and (n_kv_heads % split == 0 or
                                 group % (n_heads // split) == 0):
        return x
    return whole_heads(x, n_kv_heads, dim)


def _batch_dims(x) -> list:
    """The mesh dimensions of the active rules' batch axes."""
    state = active()
    if state is None or not isinstance(x, DTensor):
        return []
    axes = state[1].get("batch") or ()
    axes = (axes,) if isinstance(axes, str) else axes
    return [x.device_mesh.mesh_dim_names.index(a) for a in axes]


def batch_rows(x):
    """A DTensor ``x`` laid out on the active rules' batch axes as the
    batch rule says: its rows split where they divide, else whole (what
    :func:`idle_features` split made whole again); a plain tensor as it
    is."""
    dims = _batch_dims(x)
    if not dims:
        return x
    want = [Shard(0) if p.is_shard(0) else Replicate() if i in dims else p
            for i, p in enumerate(x.placements)]
    return x if tuple(want) == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def idle_columns(w, x):
    """A DTensor weight ``w`` (in, out) with its output columns split over
    the active rules' batch axes on which the activations ``x`` are not
    split by rows (batch 1) where they divide, as :func:`idle_features`
    splits the features of ``x`` there: a product ``h @ w`` then writes
    each rank's part of the features (a slice of ``w``, no collective)."""
    dims = [i for i in _batch_dims(x) if not x.placements[i].is_shard(0)]
    if not dims or not isinstance(w, DTensor):
        return w
    mesh, want, split = w.device_mesh, list(w.placements), 1
    for i in dims:
        if w.placements[i].is_replicate() and mesh.size(i) > 1 and \
                w.shape[-1] % (split * mesh.size(i)) == 0:
            want[i] = Shard(w.dim() - 1)
            split *= mesh.size(i)
    return w if split == 1 else w.redistribute(mesh, want)


def idle_features(x):
    """A DTensor ``x`` (B, S, D) with its features split over the mesh
    dimensions of the active rules' batch axes that hold it whole (the
    batch does not divide them: batch 1) where their size divides D; a
    plain tensor, or one whose batch they split, as it is.  The products
    that read it then contract each rank's part of the features, as GSPMD
    lays the reference's out at batch 1; DTensor left to itself picks
    that layout in one torch version and runs every product whole on
    every data rank in another."""
    dims = _batch_dims(x)
    if not dims:
        return x
    mesh = x.device_mesh
    want, split = list(x.placements), 1
    for i, p in enumerate(x.placements):
        if i in dims and p.is_replicate() and mesh.size(i) > 1 and \
                x.shape[-1] % (split * mesh.size(i)) == 0:
            want[i] = Shard(x.dim() - 1)
            split *= mesh.size(i)
    return x if split == 1 else x.redistribute(mesh, want)


def model_dim(x, n: int):
    """The mesh dimension named ``model`` when it has more than one rank
    and divides ``n``, else None: where a block splits ``n`` heads (or
    experts) over ranks itself."""
    if not isinstance(x, DTensor) or "model" not in (
            x.device_mesh.mesh_dim_names or ()):
        return None
    i = x.device_mesh.mesh_dim_names.index("model")
    size = x.device_mesh.size(i)
    return i if size > 1 and n % size == 0 else None


def whole_local(x, partial_dims=()):
    """DTensor ``x`` made whole on every rank, as a local tensor
    (:func:`local_part`); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    rep = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == rep:
        return local_part(x, partial_dims)
    # The gather's own backward takes the pending sum to x's layout (a
    # reduce-scatter where x is split).
    return x.redistribute(x.device_mesh, rep).to_local(grad_placements=[
        Partial() if i in partial_dims else Replicate()
        for i in range(len(rep))])


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
