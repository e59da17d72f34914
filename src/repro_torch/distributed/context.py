"""Activation-sharding context: constraint injection without config plumbing.

Port of ``repro/distributed/context.py``.  A launcher (``launch/dryrun``,
``chip_smoke``, the tests) activates rules while it runs the model:

    with activation_rules(mesh, {"batch": ("data",)}):
        loss, _ = model.loss(params, batch)

Without active rules every hook here returns its input, and a pass is
numerically exactly what it is without this module.

With them the model runs on **local tensors** from end to end.  A step's
entry point (``models/model``) hands its DTensor containers to
:func:`enter`, which sets the step's :class:`Frame` and returns this
rank's blocks: the batch and the cache as local tensors, each weight as a
``layout.Block`` (its local tensor and its placements).  The step's
results go back through :func:`leave` and :func:`leave_cache` as
DTensors.  In between no op reaches DTensor's sharding propagation: the
split of every product is the port's own (:class:`Ranks`,
:func:`column_products`, :func:`row_product`, ``models/rwkv``'s blocks),
and every collective is one of ``distributed/layout``'s, each with its
gradient stated.  (DTensor's cost model breaks ties between equally cheap
strategies differently in different torch versions, so a dry run's counts
once depended on the version.)

The residual stream is laid out one way between layers: its rows over
the rules' batch axes where the step's batch divides them, whole
elsewhere (:attr:`Frame.placements`).  Its gradient is then the same on
every rank that holds the same rows.  A block whose ranks share its work
takes the stream through ``Ranks.enter`` (the identity, its gradient a
pending sum over the sharing ranks, all-reduced) and gives it back
through ``Ranks.sum`` (an all-reduce of the ranks' pending sums).  Where
the batch does not divide the data ranks (batch 1) they hold the rows
whole and take parts of the work (``Ranks.idle``).

A weight is gathered at its use (``Ranks.whole``, ``Ranks.block``,
:func:`whole`): the FSDP split of its ``embed`` dimension always, so the
port has no ``fsdp_gather`` rule, and a model rank's own block kept where
the rules split it over ``model``.  A table or head whose vocabulary is
split over ``model`` is used in place, vocab-parallel
(``models/layers.embed_apply`` and ``chunked_ce_loss``).

A step whose batch rows are the parts of split sequences
(``sharding.split_sequences``) runs under a ``seq_pair`` rule, the
:class:`~repro_torch.distributed.layout.SeqPair` of the ranks that hold
the parts of the same sequences (:func:`seq_pair`): the blocks hand
what crosses a part's edge over it (the token shift's and the conv's
tails, the recurrences' states, attention's keys and values).

A layout the local code cannot split raises: nothing is handed back to
DTensor.
"""

from __future__ import annotations

import contextlib
import math
import types

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.layout import (Block, KeySlice,
                                            all_reduce_local, block_start,
                                            gather_local,
                                            live, pending_local, rank_index,
                                            scatter_sum_local, split_local,
                                            whole_block, wrap)

# Process-wide, not a thread's own: autograd runs a CUDA backward, and the
# recompute of a remat layer inside it, on a device thread of its own,
# where the model's hooks must see the same rules and the same frame as in
# the forward.
_STATE = types.SimpleNamespace(value=None, frame=None)


@contextlib.contextmanager
def activation_rules(mesh, rules: dict):
    """Enable logical->mesh activation constraints inside the block."""
    if rules.get("seq"):
        raise ValueError("the residual stream's sequence split over a mesh "
                         "axis is not built on local tensors")
    old = (_STATE.value, _STATE.frame)
    _STATE.value, _STATE.frame = (mesh, rules), None
    try:
        yield
    finally:
        _STATE.value, _STATE.frame = old


def active():
    """(mesh, rules) of the enclosing ``activation_rules``, or None."""
    return _STATE.value


def seq_pair():
    """The active rules' ``seq_pair`` (a ``layout.SeqPair``: each
    sequence of the batch split into parts over the ``pod`` axis,
    ``sharding.split_sequences``), or None."""
    state = active()
    return state[1].get("seq_pair") if state else None


def frame():
    """The :class:`Frame` of the step that runs, or None (no active rules,
    or no step entered)."""
    return _STATE.frame


# ---------------------------------------------------------------------------
# A step's frame: how its ranks hold the residual stream and the cache.
# ---------------------------------------------------------------------------

def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class Frame:
    """How the ranks of ``mesh`` hold a step of global batch ``batch``:

    * ``rows``: the mesh dimensions of the rules' batch axes (of more than
      one rank) where the batch divides them, each rank holding its rows;
      else none;
    * ``idle``: those dimensions where the batch does not divide them
      (batch 1): their ranks hold the rows whole;
    * ``model``: the mesh dimension ``model`` where it has more than one
      rank, else None;
    * ``placements``: the residual stream's (rows over ``rows``, whole
      elsewhere);
    * ``cache``: each cache leaf's placements, as :func:`enter` found them
      or a block re-laid them (:func:`cache_heads`)."""

    def __init__(self, mesh, rules: dict, batch: int):
        names = mesh.mesh_dim_names
        axes = rules.get("batch") or ()
        axes = (axes,) if isinstance(axes, str) else axes
        dims = live(mesh, [names.index(a) for a in axes])
        n = math.prod(mesh.size(i) for i in dims)
        self.mesh = mesh
        self.rows = dims if batch % n == 0 else []
        self.idle = [] if self.rows else dims
        m = names.index("model") if "model" in names else None
        self.model = m if m is not None and mesh.size(m) > 1 else None
        self.placements = tuple(Shard(0) if i in self.rows else Replicate()
                                for i in range(mesh.ndim))
        self.cache: dict = {}
        self._views: dict = {}

    def rows_of(self, x, dim: int = 0):
        """``x`` (its dimension ``dim`` the batch) as this rank's local
        tensor laid out as the stream's rows: a DTensor's local shard where
        it is so laid out, else a plain tensor's (or a whole DTensor's)
        slice of the rows."""
        if isinstance(x, DTensor):
            want = [Shard(dim) if p.is_shard(0) else p
                    for p in self.placements]
            got = [p if self.mesh.size(i) > 1 else w
                   for i, (p, w) in enumerate(zip(x.placements, want))]
            if got == want:
                return x.to_local()
            if any(p.is_shard() or p.is_partial() for p in got):
                raise ValueError(f"a step's tensor laid out {x.placements}, "
                                 f"not as its rows {tuple(want)}")
            x = x.to_local()
        if not self.rows:
            return x
        index, n = rank_index(self.mesh, self.rows)
        size = x.shape[dim] // n
        return x.narrow(dim, index * size, size)


def enter(params=None, batch=None, cache=None):
    """A step's containers as this rank's blocks, under active rules: each
    DTensor weight of ``params`` a ``layout.Block``, ``batch`` and
    ``cache`` as local tensors (the cache's local views, which the step
    writes in place); sets the step's :class:`Frame` (from the batch's
    global rows).  Without active rules everything is returned as it
    is."""
    state = active()
    if state is None:
        return params, batch, cache
    mesh, rules = state
    lead = next(t for t in (batch or {}).values() if torch.is_tensor(t))
    f = _STATE.frame = Frame(mesh, rules, lead.shape[0])
    if params is not None:
        params = _map(Block.of, params)
    if batch is not None:
        batch = {k: f.rows_of(v) for k, v in batch.items()}
    if cache is not None:
        cache = {k: _cache_in(f, k, v) for k, v in cache.items()}
    return params, batch, cache


def _cache_in(f: Frame, name, x):
    if not torch.is_tensor(x):
        return x                                    # the host-int length
    if isinstance(x, DTensor):
        local = x.to_local()
        f.cache[name] = tuple(x.placements)
        f._views[name] = (local, x)
        return local
    f.cache[name] = f.placements if x.dim() < 2 else tuple(
        Shard(1) if p.is_shard() else p for p in f.placements)
    return f.rows_of(x, dim=1)


def leave(x, placements=None):
    """A step's local result as a DTensor laid out by ``placements``
    (default: whole on every rank); ``x`` itself without a frame."""
    f = frame()
    if f is None:
        return x
    return wrap(x, f.mesh, placements or (Replicate(),) * f.mesh.ndim)


def leave_cache(cache: dict) -> dict:
    """A step's new cache as DTensors: a leaf written in place as the
    container it came in, a re-laid one (:func:`cache_heads`) as a new
    DTensor of its new placements."""
    f = frame()
    if f is None:
        return cache
    out = {}
    for name, t in cache.items():
        view = f._views.get(name)
        if view is not None and view[0] is t:
            out[name] = view[1]
        elif torch.is_tensor(t):
            out[name] = wrap(t, f.mesh, f.cache[name])
        else:
            out[name] = t
    return out


def cache_heads(name: str, t, n_heads: int, dim: int = 2):
    """The cache leaf ``name`` (local ``t``) with its ``n_heads`` heads, of
    tensor dimension ``dim``, split over ``model`` where a block splits
    them so (:func:`model_dim`): this rank's heads, a local slice (no
    collective), so that each layer writes its new state in place with no
    gather; anything else as it is."""
    f = frame()
    m = model_dim(n_heads)
    if f is None or m is None or name not in f.cache:
        return t
    pl = list(f.cache[name])
    if pl[m].is_shard(dim):
        return t
    if not pl[m].is_replicate():
        raise ValueError(f"cache {name} laid out {tuple(pl)}")
    index, k = rank_index(f.mesh, [m])
    size = t.shape[dim] // k
    pl[m] = Shard(dim)
    f.cache[name] = tuple(pl)
    return t.narrow(dim, index * size, size).contiguous()


def cache_slice(name: str):
    """(the placements of a layer's slice of the cache leaf ``name``, its
    leading layer dimension dropped), or None without a frame."""
    f = frame()
    if f is None or name not in f.cache:
        return None
    return tuple(Shard(p.dim - 1) if p.is_shard() else p
                 for p in f.cache[name])


# ---------------------------------------------------------------------------
# Blocks of work on local tensors.
# ---------------------------------------------------------------------------

def model_dim(n: int):
    """The frame's ``model`` mesh dimension where it has more than one rank
    and divides ``n``, else None: where a block splits ``n`` heads (or
    experts) over ranks itself."""
    f = frame()
    if f is None or f.model is None:
        return None
    return f.model if n % f.mesh.size(f.model) == 0 else None


def model_split(w, dim: int):
    """The ``model`` mesh dimension where it splits ``layout.Block`` ``w``'s
    dimension ``dim``, else None (a weight split over the data ranks,
    FSDP's, is gathered whole)."""
    f = frame()
    if f is None or f.model is None or not isinstance(w, Block):
        return None
    return f.model if w.placements[f.model].is_shard(dim % w.dim()) \
        else None


def whole(w):
    """Weight ``w`` whole on this rank, as a local tensor, for work that
    every rank does for its own rows (a norm's scale): its gradient a
    pending sum over the rows' ranks."""
    f = frame()
    return w if f is None else whole_block(w, f.rows)


class Ranks:
    """How the ranks of the step's mesh share a block that runs on local
    tensors with explicit collectives (``models/rwkv``,
    :func:`column_products`, :func:`row_product`):

    * ``rows``: the frame's row dimensions (each rank holds its rows);
    * ``model``: the mesh dimension ``model`` (given: a dimension of more
      than one rank that splits the block's heads or columns) or None;
    * ``idle``: the frame's idle dimensions (batch 1), whose ranks each
      take a part of their model rank's block where every count in
      ``widths`` (the widths split by the model rank) divides, else
      repeat their model rank's work.

    ``share`` lists the ranks that share the work, the model rank's block
    major.  Inside a block every local tensor's gradient is a pending sum
    over them (:meth:`enter`); the rows' ranks each hold their own rows."""

    def __init__(self, model, widths=()):
        f = frame()
        self.mesh, self.rows = f.mesh, f.rows
        self.model = model
        m = 1 if model is None else self.mesh.size(model)
        k = math.prod(self.mesh.size(i) for i in f.idle)
        self.idle = f.idle if all(w % (m * k) == 0 for w in widths) else []
        self.share = ([] if model is None else [model]) + self.idle

    def index(self, dims) -> tuple:
        """(this rank's index among the ranks of ``dims``, the first
        major; their number)."""
        return rank_index(self.mesh, dims)

    def part(self, n: int) -> tuple:
        """(the dims, this rank's slice) of ``n`` split over the sharing
        ranks where they divide it, else over the model dimension alone
        where it does, else whole."""
        for dims in (self.share, [] if self.model is None else [self.model]):
            index, k = self.index(dims)
            if n % k == 0:
                return dims, slice(index * (n // k), (index + 1) * (n // k))
        return [], slice(0, n)

    def enter(self, t):
        """Local ``t``, the input of the block's shared work: its gradient
        a pending sum over the sharing ranks."""
        return pending_local(t, self.mesh, self.share)

    def whole(self, w):
        """A weight whole on every rank, as a local tensor; each rank's use
        of it a part of the work."""
        return whole_block(w, self.rows + self.share)

    def block(self, w, dim: int):
        """The model rank's block of weight ``w``'s dimension ``dim``,
        whole elsewhere: its own block where ``w`` is split so over the
        model dimension, else a slice of the whole."""
        dim %= w.dim()
        if self.model is not None and isinstance(w, Block) and \
                w.placements[self.model].is_shard(dim):
            return whole_block(w, self.rows + self.idle, keep=[self.model])
        whole_w = self.whole(w)
        index, k = self.index([] if self.model is None else [self.model])
        n = whole_w.shape[dim] // k
        return whole_w.narrow(dim, index * n, n)

    def sub(self, n: int) -> slice:
        """This idle rank's slice of a model rank's block of ``n``."""
        index, k = self.index(self.idle)
        return slice(index * (n // k), (index + 1) * (n // k))

    def gather(self, t, dims, partial_grad: bool = True):
        """Local ``t``'s last dimension, split over ``dims``, gathered
        (``layout.gather_local``)."""
        return gather_local(t, self.mesh, dims, -1, partial_grad)

    def scatter(self, t, dims):
        """A pending sum over ``dims``, summed into this rank's slice of the
        last dimension (``layout.scatter_sum_local``)."""
        return scatter_sum_local(t, self.mesh, dims, -1)

    def sum(self, t, dims):
        """A pending sum over ``dims``, all-reduced."""
        return all_reduce_local(t, self.mesh, dims)


def column_products(x, *ws):
    """``x @ w`` for each ``w`` (x (..., D) with its rows first, w (D, N));
    on a mesh, on local tensors: each rank multiplies its rows by the
    columns of ``w`` its model rank holds (where the rules split them over
    ``model``), an idle rank (batch 1: :class:`Ranks`) by a part of that
    block, gathered over the idle ranks; no collective else.  The ranks
    that share the columns take ``x`` through one ``Ranks.enter`` (its
    gradient all-reduced once for the products they share).  Each result
    keeps ``w``'s column split: the model rank's block."""
    if frame() is None:
        return [x @ w for w in ws]
    entered, out = {}, []
    for w in ws:
        rk = Ranks(model_split(w, -1), (w.shape[-1],))
        key = tuple(rk.share)
        if key not in entered:
            entered[key] = rk.enter(x)
        block = rk.block(w, -1)
        cols = rk.sub(block.shape[-1])
        out.append(rk.gather(entered[key] @ block[:, cols], rk.idle,
                             partial_grad=False))
    return out


def column_product(x, w):
    """:func:`column_products` of one weight."""
    return column_products(x, w)[0]


def column_layout(w, ndim: int = 2) -> tuple:
    """The placements of a :func:`column_product` by ``w`` of ``ndim``
    dimensions: rows over the frame's row dimensions, the columns over
    ``model`` where ``w``'s are (None without a frame)."""
    f = frame()
    if f is None:
        return None
    model = model_split(w, -1)
    return tuple(Shard(ndim - 1) if i == model else p
                 for i, p in enumerate(f.placements))


def row_product(y, w, whole_features: bool = False):
    """``y @ w`` (y (..., N) with its rows first, w (N, D)); on a mesh, on
    local tensors: each rank multiplies its block of the features (the
    model rank's rows of ``w``; an idle rank's part of them) and the
    ranks' pending sums are all-reduced.  ``y`` holds the model rank's
    block of the features, or with ``whole_features`` all of them (each
    rank takes its block, the gradient gathered).  The result is laid out
    as the residual stream."""
    f = frame()
    if f is None:
        return y @ w
    rk = Ranks(model_split(w, 0), (w.shape[0],))
    if whole_features and rk.model is not None:
        y = split_local(y, rk.mesh, [rk.model], -1)
    y = pending_local(y, rk.mesh, rk.idle)
    block = rk.block(w, 0)
    rows = rk.sub(block.shape[0])
    return rk.sum(y[..., rows] @ block[rows], rk.share)


def row_split_product(x, w):
    """``x @ w`` (x (B, S, F) with its rows first, w (F, D)) on a mesh with
    the stream's rows shared: each rank of ``model`` (and each idle rank)
    multiplies its share of the local rows by the whole weight, and the
    shares are gathered into the stream's layout.  The frontends' products
    (hubert's frames, qwen2-vl's vision rows), where every model rank
    would else repeat the whole product."""
    f = frame()
    if f is None:
        return x @ w
    rk = Ranks(f.model)
    b, s, feat = x.shape
    dims, rows = rk.part(b * s)
    y = x.reshape(b * s, feat)[rows] @ whole_block(w, rk.rows + dims)
    y = gather_local(y, rk.mesh, dims, 0, partial_grad=False)
    return y.reshape(b, s, -1)


def head_layout(n_heads: int, n_kv_heads: int) -> str:
    """How the model ranks share a grouped-query attention's heads:
    "local" (each rank whole KV groups, or no split), "group" (each rank's
    query heads lie inside one KV group: it attends with that group's KV
    head alone, as GSPMD splits starcoder2-3b's 24 query heads over 2
    groups, 3 a rank over 8), or "whole" (every rank all heads)."""
    f = frame()
    if f is None or f.model is None:
        return "local"
    m = f.mesh.size(f.model)
    if n_heads % m == 0 and n_kv_heads % m == 0:
        return "local"
    if n_heads % m == 0 and (n_heads // n_kv_heads) % (n_heads // m) == 0:
        return "group"
    return "whole"


def group_of(n_heads: int, n_kv_heads: int) -> int:
    """This model rank's KV group under the "group" :func:`head_layout`."""
    f = frame()
    index, m = rank_index(f.mesh, [f.model])
    return index * (n_heads // m) // (n_heads // n_kv_heads)


def whole_columns(t, n: int, partial_grad: bool):
    """Local ``t`` (..., N) whose ``n`` columns a column product split over
    ``model``, gathered whole (as it is where they are whole already):
    with ``partial_grad`` each rank uses a part of the whole."""
    f = frame()
    if f is None or t.shape[-1] == n:
        return t
    return gather_local(t, f.mesh, [f.model], -1, partial_grad)


def whole_heads(t, dim: int, partial_grad: bool = False):
    """Local ``t`` whose dimension ``dim`` a model rank holds its block of
    (its heads), gathered over ``model``."""
    f = frame()
    if f is None or f.model is None:
        return t
    return gather_local(t, f.mesh, [f.model], dim, partial_grad)


def constrain(x, logical_axes: tuple):
    """The reference's layer-boundary constraint: on a mesh the stream is
    already laid out as the rules ask (the module note), so ``x`` as it
    is."""
    return x


def sum_rows(t):
    """A local sum over this rank's rows, summed over the rows' ranks."""
    f = frame()
    return t if f is None else all_reduce_local(t, f.mesh, f.rows)


@contextlib.contextmanager
def block_call(x):
    """A block called by itself with a DTensor ``x`` (batch first) under
    active rules: inside, a :class:`Frame` of ``x``'s rows; yields it.
    The block converts its containers and results itself (``f.rows_of``,
    ``layout.Block.of``, ``layout.wrap``)."""
    mesh, rules = active()
    old = _STATE.frame
    f = _STATE.frame = Frame(mesh, rules, x.shape[0])
    try:
        yield f
    finally:
        _STATE.frame = old


def cache_keys(name: str, length: int, n_kv_heads: int) -> tuple:
    """(the ``layout.KeySlice`` of this rank's slice of the sequence of
    the cache leaf ``name``'s layer slice, ``length`` positions long
    here, or None where the sequence is whole; the idle dimensions, whose
    ranks hold the rows whole, that take shares of its ``n_kv_heads`` KV
    heads)."""
    layout = cache_slice(name)
    if layout is None:
        return None, []
    f = frame()
    seq = [i for i, p in enumerate(layout)
           if p.is_shard(1) and f.mesh.size(i) > 1]
    if not seq:
        return None, []
    n = math.prod(f.mesh.size(i) for i in seq)
    keys = KeySlice(block_start(f.mesh, layout, 1, length * n), f.mesh, seq)
    idle = [i for i in f.idle if layout[i].is_replicate()]
    if n_kv_heads % math.prod(f.mesh.size(i) for i in idle):
        idle = []
    return keys, idle


def model_index() -> int:
    """This rank's index on the frame's ``model`` dimension."""
    f = frame()
    return rank_index(f.mesh, [f.model])[0]


def index_over(dims) -> tuple:
    """(this rank's index among the ranks of ``dims``, their number)."""
    return rank_index(frame().mesh, dims)


def gather_over(t, dims, dim: int):
    """Local ``t``, each rank of ``dims`` holding its slice of ``dim``,
    gathered whole (its gradient the same on every rank)."""
    return gather_local(t, frame().mesh, dims, dim, partial_grad=False)
