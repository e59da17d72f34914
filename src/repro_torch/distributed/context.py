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

Where DTensor would choose a product's layout itself, the port splits it
on local tensors with explicit collectives (:class:`Ranks`,
:func:`column_product`, :func:`row_product`, ``models/rwkv``'s blocks):
DTensor's cost model breaks ties between equally cheap strategies
differently in different torch versions (2.11 and 2.13 split the same
products otherwise), and the dry run's counts must not depend on the
version.  What DTensor still propagates here is elementwise work, norms
and reductions over tensors laid out alike, and the explicit
redistributions of this module.

Nothing here changes a value: with no active rules every path is
numerically exactly what it is without this module.
"""

from __future__ import annotations

import contextlib
import types

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.layout import (all_reduce_local, axis_sizes,
                                            gather_local, local_part,
                                            placements,
                                            replicate_plain_tensors,
                                            scatter_sum_local)

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


class Ranks:
    """How the ranks of the mesh of DTensor activations ``x`` (rows first)
    share a block that runs on local tensors with explicit collectives
    (``models/rwkv``, :func:`column_product`, :func:`row_product`): the
    split is the port's own, so it does not depend on how a torch
    version's DTensor would propagate the block.

    * ``rows``: the mesh dimensions of the rules' batch axes where the
      batch divides them (each rank holds its rows), else none;
    * ``model``: the mesh dimension ``model`` (given: a dimension of more
      than one rank that splits the block's heads or columns) or None;
    * ``idle``: the batch axes' dimensions that the batch does not divide
      (batch 1), whose ranks each take a part of their model rank's block
      where every count in ``widths`` (the widths split by the model
      rank) divides, else repeat their model rank's work.

    ``share`` lists the ranks that share the work, the model rank's block
    major.  Inside a block every local tensor's gradient is a pending sum
    over them; the rows' ranks each hold their own rows."""

    def __init__(self, x, model, widths=()):
        self.mesh = mesh = x.device_mesh
        names = mesh.mesh_dim_names
        state = active()
        axes = (state[1].get("batch") or ()) if state else ()
        axes = (axes,) if isinstance(axes, str) else axes
        batch = [names.index(a) for a in axes
                 if mesh.size(names.index(a)) > 1]
        n = 1
        for i in batch:
            n *= mesh.size(i)
        split = x.shape[0] % n == 0
        self.rows = batch if split else []
        self.model = model
        m = 1 if model is None else mesh.size(model)
        idle = [] if split else batch
        k = 1
        for i in idle:
            k *= mesh.size(i)
        self.idle = idle if all(w % (m * k) == 0 for w in widths) else []
        self.share = ([] if model is None else [model]) + self.idle
        self.placements = [Shard(0) if i in self.rows else Replicate()
                           for i in range(mesh.ndim)]

    def index(self, dims) -> tuple:
        """(this rank's index among the ranks of ``dims``, the first
        major; their number)."""
        coord, index, n = self.mesh.get_coordinate(), 0, 1
        for i in dims:
            index = index * self.mesh.size(i) + coord[i]
            n *= self.mesh.size(i)
        return index, n

    def part(self, n: int) -> tuple:
        """(the dims, this rank's slice) of ``n`` split over the sharing
        ranks where they divide it, else over the model dimension alone
        where it does, else whole."""
        for dims in (self.share, [] if self.model is None else [self.model]):
            index, k = self.index(dims)
            if n % k == 0:
                return dims, slice(index * (n // k), (index + 1) * (n // k))
        return [], slice(0, n)

    def local(self, t):
        """``t`` laid out as the rows, this rank's local tensor (a plain
        tensor counts as replicated); its gradient a pending sum over the
        sharing ranks."""
        mesh = self.mesh
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(t.placements) != tuple(self.placements):
            t = t.redistribute(mesh, self.placements)
        return t.to_local(grad_placements=[
            Partial() if i in self.share else p
            for i, p in enumerate(self.placements)])

    def whole(self, w):
        """A weight whole on every rank, as a local tensor; each rank's use
        of it a part of the work."""
        return whole_local(w, self.rows + self.share)

    def block(self, w, dim: int):
        """The model rank's block of weight ``w``'s dimension ``dim``,
        whole elsewhere: its own shard where ``w`` is split so over the
        model dimension alone, else a slice of the whole."""
        dim %= w.dim()
        if self.model is not None and all(
                p == Shard(dim) if i == self.model else p.is_replicate()
                for i, p in enumerate(w.placements)):
            return local_part(w, self.rows + self.idle)
        whole = self.whole(w)
        index, k = self.index([] if self.model is None else [self.model])
        n = whole.shape[dim] // k
        return whole.narrow(dim, index * n, n)

    def sub(self, n: int) -> slice:
        """This idle rank's slice of a model rank's block of ``n``."""
        index, k = self.index(self.idle)
        return slice(index * (n // k), (index + 1) * (n // k))

    def gather(self, t, dims, partial_grad: bool = True):
        """Local ``t``'s last dimension, split over ``dims``, gathered
        (``layout.gather_local``)."""
        return gather_local(t, self.mesh, dims, -1, self.placements,
                            partial_grad)

    def scatter(self, t, dims):
        """A pending sum over ``dims``, summed into this rank's slice of the
        last dimension (``layout.scatter_sum_local``)."""
        return scatter_sum_local(t, self.mesh, dims, -1, self.placements)

    def sum(self, t, dims):
        """A pending sum over ``dims``, all-reduced."""
        return all_reduce_local(t, self.mesh, dims, self.placements,
                                "sum") if dims else t

    def wrap(self, t, placements=None):
        """A local result laid out as the rows (or as ``placements``), as a
        DTensor."""
        return DTensor.from_local(t, self.mesh, placements or
                                  self.placements, run_check=False)


def _split_dim(w, dim: int):
    """The ``model`` mesh dimension where it has more than one rank and
    splits DTensor ``w``'s dimension ``dim``, else None (a weight split
    over the data ranks, FSDP's, is gathered whole)."""
    names = w.device_mesh.mesh_dim_names or ()
    if "model" not in names:
        return None
    i = names.index("model")
    return i if w.placements[i].is_shard(dim % w.dim()) and \
        w.device_mesh.size(i) > 1 else None


def column_product(x, w):
    """``x @ w`` (x (..., D) with its rows first, w (D, N)); on a mesh, on
    local tensors: each rank multiplies its rows by the columns of ``w``
    its rank of the dimension that splits them holds (the ``model`` rank's
    block), an idle rank (batch 1: :class:`Ranks`) by a part of that
    block, gathered over the idle ranks; no collective else.  The result
    keeps ``w``'s column split."""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return x @ w
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    model = _split_dim(w, -1)
    rk = Ranks(x, model, (w.shape[-1],))
    block = rk.block(w, -1)
    cols = rk.sub(block.shape[-1])
    out = rk.gather(rk.local(x) @ block[:, cols], rk.idle,
                    partial_grad=False)
    return rk.wrap(out, [Shard(x.dim() - 1) if i == model else p
                         for i, p in enumerate(rk.placements)])


def row_product(y, w):
    """``y @ w`` (y (..., N) with its rows first, w (N, D)); on a mesh, on
    local tensors: each rank multiplies its rank's block of the features
    (the ``model`` rank's rows of ``w``; an idle rank's part of them) and
    the ranks' pending sums are all-reduced.  The result is laid out as
    the rows, whole elsewhere: the residual stream's layout."""
    if not isinstance(y, DTensor) and not isinstance(w, DTensor):
        return y @ w
    mesh = (y if isinstance(y, DTensor) else w).device_mesh
    if not isinstance(y, DTensor):
        y = DTensor.from_local(y, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    model = _split_dim(w, 0)
    rk = Ranks(y, model, (w.shape[0],))
    last = y.dim() - 1
    want = [Shard(last) if i == model else p
            for i, p in enumerate(rk.placements)]
    if tuple(y.placements) != tuple(want):
        y = y.redistribute(mesh, want)
    yl = y.to_local(grad_placements=[
        Partial() if i in rk.idle else p for i, p in enumerate(want)])
    block = rk.block(w, 0)
    rows = rk.sub(block.shape[0])
    return rk.wrap(rk.sum(yl[..., rows] @ block[rows], rk.share))


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
