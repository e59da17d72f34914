"""Public wrappers for the hand kernels: dispatch by the tensors' device.

Port of ``repro/kernels/ops.py``, whose ``on_tpu()`` / ``_interp()`` chose
between the compiled Pallas kernel and interpret mode.  Here:

* every input on the CPU -> the plain PyTorch version in ``ref.py``;
* every input on the ``meta`` device (shapes without data: the dry run's
  model of the card) -> a stand-in that returns the kernel's outputs'
  shapes and charges the kernel's work to the dry run's cost meter
  (``core/hloparse.charge``);
* every input on CUDA    -> the hand kernel, which counts the launch;
  ``wkv``'s gradient is a kernel too (K3b), through ``torch.autograd``;
* anything else (mixed devices, or a dtype, shape or layout the kernel
  does not take) raises.  Nothing falls back.

On a mesh the models hand these wrappers their local tensors
(``distributed/context``): ``decode_attn`` (K2) and ``wkv`` (K3, and K3b
under autograd) run on this rank's shard as on one device.  A cache whose
sequence is split over ranks (the reference's channelized layout) comes
with its slice's ``layout.KeySlice``: each rank runs K2's partial build
(on the CPU ``ref.decode_attn_partials_ref``, on ``meta`` its stand-in)
over its own keys up to the valid length, and :func:`merge_partials`
combines the ranks' (m, l, acc) by two all-reduces over the slices'
ranks.  Rows that are halves of split sequences (``wkv``'s ``pair``, a
``layout.SeqPair``) run half 1's K3 from the state half 0 hands over, K3b
in the reverse order (:class:`_WkvParts`).

DTensor inputs (a caller outside a model's step) are taken apart into
their local shards on every device (:func:`_per_shard`): batch and head
splits run the kernel on each shard, a sequence split the partial route,
and a split the kernel cannot take (its time axis, say) raises: nothing
is gathered behind the caller's back.  Ranks that hold such a cache whole
take shares of the work: a channelized cache that the data ranks do not
split (batch 1) has its KV heads split over them, and a query whose heads
split inside KV groups runs against its group's KV head
(:func:`_grouped_query`).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.layout import all_reduce_local, shard_start
from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import memsim_scan as _ms
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv_wkv as _wkv
from repro_torch.kernels import stream as _stream


def _all_on_cpu(*tensors, meta: bool = False) -> bool:
    """True for CPU tensors (and with ``meta``, for ``meta`` ones: shapes
    without data, the dry run's), which take the plain version; False for
    CUDA ones."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or (meta and kinds == {"meta"}):
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"inputs on mixed or unsupported devices: "
                     f"{[str(t.device) for t in tensors]}")


def stream_copy(a):
    """o = a, a new tensor."""
    if _all_on_cpu(a):
        return ref.stream_copy_ref(a)
    return _stream.stream_copy(a)


def stream_scale(a, alpha):
    """o = alpha * a, alpha rounded to a's type."""
    if _all_on_cpu(a):
        return ref.stream_scale_ref(a, alpha)
    return _stream.stream_scale(a, alpha)


def stream_add(a, b):
    """o = a + b."""
    if _all_on_cpu(a, b):
        return ref.stream_add_ref(a, b)
    return _stream.stream_add(a, b)


def stream_triad(a, b, alpha):
    """o = a + alpha * b, rounded as the reference."""
    if _all_on_cpu(a, b):
        return ref.stream_triad_ref(a, b, alpha)
    return _stream.stream_triad(a, b, alpha)


def _per_shard(fn, lead, args: dict, out_roles: tuple, what: str,
               written=(), partials=None, shared=(), heads_over=()):
    """Run ``fn`` on the local shards of DTensor ``args`` and wrap what
    it returns as DTensors on their mesh.

    ``args`` maps each argument to ``(tensor or None, {role: dim})``; the
    roles are "batch", "head", "seq" and "whole" (a dimension the kernel
    must see whole: a split one raises).  ``lead`` names the argument whose
    layout decides: each mesh dimension of more than one rank keeps its
    "batch", "head" or "seq" split and is otherwise replicated; every
    argument is laid out to match (a cheap redistribute of the query or
    the state where it differs).
    ``out_roles`` gives each output's {role: dim}; an argument named in
    ``written`` is written in place and must already be laid out so.

    A "seq" split (only where the caller gives ``partials``) runs
    ``partials(offset, reduce, **local)`` in place of ``fn``: ``offset``
    is the first position of this rank's slice of the lead's "seq"
    dimension, and ``reduce(x, op)`` all-reduces a local tensor laid out
    by the first output's roles over the "seq" mesh dimensions ("max" or
    "sum"); the outputs are replicated over those dimensions.

    An argument named in ``shared`` that has no "head" role is whole over
    the lead's head split, and each rank uses its own part of it (a query
    head group's KV head): its gradient is a pending sum there.  So is the
    gradient of an argument with no "batch" role over the lead's batch
    split (``wkv``'s bonus ``u``: each rank's rows use all of it).  The mesh
    dimensions in ``heads_over``, on which the lead is whole, split the
    "head" dimension of every argument and output that has one (each
    rank takes its share of the heads: a slice, no collective)."""
    x, dims = args[lead]
    mesh = x.device_mesh
    role_of = {d: r for r, d in dims.items()}
    split = ("batch", "head", "seq") if partials else ("batch", "head")
    roles = []
    for i, p in enumerate(x.placements):
        role = role_of.get(p.dim) if isinstance(p, Shard) else None
        if mesh.size(i) > 1 and role in ("whole", "seq") and \
                role not in split:
            raise ValueError(
                f"{what}: {lead} is laid out {x.placements} on {mesh}; the "
                f"kernel sees whole rows, and its dimension {p.dim} is split "
                f"over {mesh.size(i)} ranks")
        # Any other layout but a batch, head or sequence split (a pending
        # sum, a split feature axis) is made whole (replicated) first.
        roles.append(role if mesh.size(i) > 1 and role in split else
                     "head" if i in heads_over and p.is_replicate() else
                     None)
    for name in written:
        # What is written in place keeps its layout: a split it lacks is
        # not made.
        t, dim_map = args[name]
        if t is not None:
            roles = [r if r in dim_map and t.placements[i] == Shard(
                dim_map[r]) else None for i, r in enumerate(roles)]

    def layout(dim_map, own=None):
        # A mesh dimension of one rank holds the whole tensor whatever its
        # placement says: an input keeps its own there.
        return tuple(
            own[i] if own and mesh.size(i) == 1 else
            Shard(dim_map[r]) if r in dim_map else Replicate()
            for i, r in enumerate(roles))

    local = {}
    for name, (t, dim_map) in args.items():
        if t is None:
            local[name] = None
            continue
        if not isinstance(t, DTensor):
            # A plain tensor counts as replicated.
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = layout(dim_map, t.placements)
        if tuple(t.placements) != want:
            if name in written:
                raise ValueError(f"{what}: {name} is written in place and "
                                 f"is laid out {t.placements}, not {want}")
            t = t.redistribute(mesh, want)
        parts = [i for i, r in enumerate(roles) if r not in dim_map and (
            r == "batch" or (r == "head" and name in shared))]
        local[name] = t.to_local(grad_placements=[
            Partial() if i in parts else p for i, p in enumerate(t.placements)])
    if "seq" in roles:
        seq = [i for i, r in enumerate(roles) if r == "seq"]
        out = partials(shard_start(x, dims["seq"]), lambda t, op: (
            all_reduce_local(t, mesh, seq, op)), **local)
    else:
        out = fn(**local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(o, mesh, layout(r), run_check=False)
                    for o, r in zip(outs, out_roles))
    return wrapped if isinstance(out, tuple) else wrapped[0]


def merge_partials(m, l, acc, dtype, max_all=None, sum_all=None):
    """The softmax terms of several slices of one cache merged into the
    attention output: with M = max_r m_r and w_r = exp(m_r - M), the
    output is sum_r w_r acc_r / sum_r w_r l_r, cast to ``dtype``.

    ``max_all(m)`` gives M (broadcastable against ``m``); ``sum_all(x)``
    sums ``x`` = (w l, w acc) packed as (..., D + 1) over the slices.  The
    caller chooses them: all-reduces over the ranks that each hold one
    slice (``decode_attn`` on a sequence-split cache), or reductions over
    a leading axis of slices stacked in one process.  By default the
    terms are one slice's own."""
    big = m if max_all is None else max_all(m)
    w = torch.exp(m - big)
    packed = torch.cat([(w * l)[..., None], w[..., None] * acc], dim=-1)
    if sum_all is not None:
        packed = sum_all(packed)
    return (packed[..., 1:] / packed[..., :1]).to(dtype)


def _decode_attn_meta(q, k, v, length: int):
    """decode_attn on ``meta`` tensors (the dry run): its output's shape,
    with K2's work charged to the cost meter: two products of each query
    head with the ``length`` valid keys, 4 B Hq length D FLOP, and each
    input's valid part read once, the output written once."""
    from repro_torch.core import hloparse
    b, hq, d = q.shape
    hk = k.shape[2]
    out = torch.empty_like(q)
    kv = 2 * b * length * hk * d * k.element_size()
    hloparse.charge(4.0 * b * hq * length * d,
                    kv + 2 * q.numel() * q.element_size())
    return out


def _decode_attn_partials_meta(q, k, v, length: int):
    """decode_attn_partials on ``meta`` tensors (the dry run): the float32
    terms' shapes, with the partial build's work charged: 4 B Hq length D
    FLOP over this slice's ``length`` valid keys, their bytes and the
    query read once, the terms written once."""
    from repro_torch.core import hloparse
    b, hq, d = q.shape
    hk = k.shape[2]
    m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    kv = 2 * b * length * hk * d * k.element_size()
    hloparse.charge(4.0 * b * hq * length * d,
                    kv + q.numel() * q.element_size() +
                    4 * (m.numel() + l.numel() + acc.numel()))
    return m, l, acc


def decode_attn_partials(q, k, v, length: int):
    """q: (B, Hq, D); k/v: (B, S, Hk, D); length in [0, S] -> float32
    (m, l, acc) of the keys ``[0, length)`` (``ref.decode_attn_partials_ref``
    says what they are): the partial build of K2 on CUDA, its plain version
    on the CPU, its stand-in on ``meta``."""
    if k.device.type == "meta":
        return _decode_attn_partials_meta(q, k, v, length)
    if _all_on_cpu(q, k, v):
        return ref.decode_attn_partials_ref(q, k, v, length)
    return _da.decode_attn_partials(q, k, v, length)


def _seq_split(k) -> bool:
    """A DTensor cache whose sequence axis is split over more than one
    rank."""
    return any(p.is_shard(1) and k.device_mesh.size(i) > 1
               for i, p in enumerate(k.placements))


def _head_dims(x, dim: int) -> list:
    """The mesh dimensions of more than one rank that split ``dim``."""
    return [i for i, p in enumerate(x.placements)
            if p.is_shard(dim) and x.device_mesh.size(i) > 1]


def _grouped_query(q, k):
    """(the query laid out with its heads split over every mesh dimension
    of more than one rank that holds the cache whole, the first KV head of
    this rank's query heads) when each rank's query heads then lie inside
    one KV group and K2 is built for that group; else None (the query is
    laid out as the cache)."""
    if not isinstance(q, DTensor) or _seq_split(k) or _head_dims(k, 2):
        return None
    mesh = k.device_mesh
    dims = [i for i, p in enumerate(k.placements)
            if p.is_replicate() and mesh.size(i) > 1]
    split = 1
    for i in dims:
        split *= mesh.size(i)
    hq, hk, d = q.shape[1], k.shape[2], q.shape[2]
    if not dims or hq % split or (hq // hk) % (hq // split) or \
            not _da.built(d, hq // split):
        return None
    want = tuple(Shard(1) if i in dims else Shard(0) if p.is_shard(0)
                 else Replicate() for i, p in enumerate(k.placements))
    if tuple(q.placements) != want:
        q = q.redistribute(mesh, want)
    return q, shard_start(q, 1) // (hq // hk)


def decode_attn(q, k, v, length: int, keys=None):
    """q: (B, Hq, D); k/v: (B, S, Hk, D); length: int -> (B, Hq, D).

    ``keys`` (a ``layout.KeySlice``): k/v are this rank's slice of a cache
    split along its sequence, from position ``keys.offset``: K2's partial
    build over the slice's valid keys, the ranks' terms merged
    (:func:`merge_partials`).  DTensor inputs: :func:`_decode_attn_shards`."""
    if isinstance(k, DTensor):
        return _decode_attn_shards(q, k, v, length)
    if keys is not None:
        part = decode_attn_partials(
            q, k, v, min(max(length - keys.offset, 0), k.shape[1]))
        return merge_partials(*part, q.dtype,
                              lambda x: keys.reduce(x, "max"),
                              lambda x: keys.reduce(x, "sum"))
    on_cpu = _all_on_cpu(q, k, v, meta=True)
    if k.device.type == "meta":
        return _decode_attn_meta(q, k, v, length)
    if on_cpu:
        return ref.decode_attn_ref(q, k, v, length)
    return _da.decode_attn(q, k, v, length)


def _decode_attn_shards(q, k, v, length: int):
    """:func:`decode_attn` of DTensors on their local shards.  On a mesh
    whose ranks hold the cache's heads whole (and its sequence), each rank
    runs K2 on its share of the query heads against its group's KV head
    (a copy of that head's cache), G = its query heads, where the shares
    lie inside groups and K2 is built for that G (:func:`_grouped_query`);
    otherwise the query is laid out as the cache, and a cache split along
    its sequence takes the partial route."""
    grouped = _grouped_query(q, k)
    if grouped is not None:
        q, g0 = grouped
        kv = {"batch": 0, "whole": 1}
        head = lambda t: t[:, :, g0:g0 + 1].contiguous()
        return _per_shard(
            lambda q, k, v: decode_attn(q, head(k), head(v), length), "q",
            {"q": (q, {"batch": 0, "head": 1}), "k": (k, kv),
             "v": (v, kv)}, ({"batch": 0, "head": 1},), "decode_attn")
    cache = {"batch": 0, "seq": 1, "head": 2}
    # A channelized cache whole over ranks that do not split its batch
    # (batch 1 over the data ranks): they take shares of its KV heads.
    idle = [i for i, p in enumerate(k.placements)
            if p.is_replicate() and k.device_mesh.size(i) > 1] \
        if _seq_split(k) and not _head_dims(k, 2) else []
    if idle and k.shape[2] % math.prod(k.device_mesh.size(i)
                                       for i in idle):
        idle = []

    def partials(offset, reduce, q, k, v):
        part = decode_attn_partials(
            q, k, v, min(max(length - offset, 0), k.shape[1]))
        return merge_partials(*part, q.dtype,
                              lambda x: reduce(x, "max"),
                              lambda x: reduce(x, "sum"))
    return _per_shard(
        lambda q, k, v: decode_attn(q, k, v, length), "k",
        {"q": (q, {"batch": 0, "head": 1}), "k": (k, cache),
         "v": (v, cache)},
        ({"batch": 0, "head": 1},), "decode_attn", partials=partials,
        heads_over=idle)


def _wkv_meta(r, k, v, w, u, state, state_out=None):
    """wkv on ``meta`` tensors (the dry run): its outputs' shapes, with
    the cost the reference's scan counts charged to the cost meter: two
    products over each (head, D x D) state a step, 4 B T H D^2 FLOP."""
    from repro_torch.core import hloparse
    b, t, h, d = r.shape
    y = torch.empty((b, t, h, d), dtype=torch.float32, device=r.device)
    s = torch.empty_like(state) if state_out is None else state_out
    nbytes = sum(x.numel() * x.element_size() for x in
                 (r, k, v, w, u, state, y, s))
    hloparse.charge(4.0 * b * t * h * d * d, nbytes)
    return y, s


def _wkv_bwd_meta(r, k, v, w, u, state, dy, ds_t):
    """wkv's backward on ``meta`` tensors: the input gradients' shapes,
    and twice the forward's products charged (JAX's transpose of them)."""
    from repro_torch.core import hloparse
    b, t, h, d = r.shape
    grads = (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
             torch.empty_like(w, dtype=torch.float32),
             torch.empty_like(u, dtype=torch.float32),
             torch.empty_like(state, dtype=torch.float32))
    nbytes = sum(x.numel() * x.element_size() for x in
                 (r, k, v, w, u, state, dy, *grads))
    hloparse.charge(8.0 * b * t * h * d * d, nbytes)
    return grads


class _Wkv(torch.autograd.Function):
    """wkv with its gradient: forward K3 and backward K3b on CUDA tensors;
    ``wkv_ref`` and ``wkv_bwd_ref`` on CPU tensors, or with ``plain`` on
    any device (the comparison path)."""

    @staticmethod
    def forward(ctx, plain, r, k, v, w, u, state):
        ctx.meta = r.device.type == "meta"
        ctx.plain = plain or _all_on_cpu(r, k, v, w, u, state, meta=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        if ctx.meta:
            return _wkv_meta(r, k, v, w, u, state)
        if ctx.plain:
            return ref.wkv_ref(r, k, v, w, u, state)
        return _wkv.wkv(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, ds_t):
        r, k, v, w, u, state = ctx.saved_tensors
        dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device) \
            if dy is None else dy.float().contiguous()
        if ds_t is not None:
            ds_t = ds_t.float().contiguous()
        bwd = (_wkv_bwd_meta if ctx.meta else
               ref.wkv_bwd_ref if ctx.plain else _wkv.wkv_bwd)
        return (None, *bwd(r, k, v, w, u, state, dy, ds_t))


class _WkvParts(torch.autograd.Function):
    """wkv over sequences split in halves (``layout.SeqPair``), this rank
    holding half ``pair.index`` of each: half 0 runs from ``state`` and
    hands its final state to half 1, which runs from it; the backward runs
    in the reverse order, half 1's initial-state gradient handed back as
    half 0's final-state gradient.  Both ranks issue the same one
    hand-over of a (B, H, D, D) state each way (float32, or float64 where
    the inputs are) and run their own half once: K3 forward, K3b backward
    (on the CPU and with ``plain`` their plain versions, on ``meta`` their
    stand-ins, each charging this half's T)."""

    @staticmethod
    def forward(ctx, plain, pair, r, k, v, w, u, state):
        ctx.meta = r.device.type == "meta"
        ctx.plain = plain or _all_on_cpu(r, k, v, w, u, state, meta=True)
        ctx.pair = pair
        ctx.set_materialize_grads(False)
        fwd = (_wkv_meta if ctx.meta else ref.wkv_ref if ctx.plain
               else _wkv.wkv)
        # The states' dtype, the same on both ranks: what wkv returns.
        ctx.acc = torch.promote_types(r.dtype, torch.float32)
        first = pair.index == 0
        out = fwd(r, k, v, w, u, state) if first else None
        got = pair.hand_over(out[1] if first else state.to(ctx.acc))
        start = state if first else got
        if not first:
            out = fwd(r, k, v, w, u, start)
        ctx.save_for_backward(r, k, v, w, u, start)
        return out

    @staticmethod
    def backward(ctx, dy, ds_t):
        r, k, v, w, u, start = ctx.saved_tensors
        dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device) \
            if dy is None else dy.float().contiguous()
        ds = None if ds_t is None else ds_t.float().contiguous()
        bwd = (_wkv_bwd_meta if ctx.meta else
               ref.wkv_bwd_ref if ctx.plain else _wkv.wkv_bwd)
        last = ctx.pair.index == 1
        grads = bwd(r, k, v, w, u, start, dy, ds) if last else None
        got = ctx.pair.hand_over(grads[5] if last else start.to(ctx.acc),
                                 back=True)
        if not last:
            grads = bwd(r, k, v, w, u, start, dy,
                        got if ds is None else ds + got)
        # Only half 0 starts from ``state``.
        return (None, None, *grads[:5], None if last else grads[5])


def wkv(r, k, v, w, u, state, state_out=None, plain: bool = False,
        pair=None):
    """r/k/v/w: (B, T, H, D); u: (H, D); state: (B, H, D, D) fp32.

    Returns (y (B, T, H, D) fp32, final state (B, H, D, D) fp32), with a
    gradient (K3b on the card) for every input.  With ``state_out`` the
    final state goes into it (it may be ``state``): the decode cache's
    in-place update, which has no gradient and raises if one is asked for.
    ``plain`` takes the plain versions on any device (path comparison).

    ``pair`` (a ``layout.SeqPair``): each row is this rank's half of a
    sequence split over the pair's ranks (:class:`_WkvParts`); ``state``
    seeds half 0, and the final state returned is this half's (half 1's
    is the sequence's).  DTensor inputs run on their local shards
    (:func:`_per_shard`)."""
    if isinstance(r, DTensor):
        seq = {"batch": 0, "whole": 1, "head": 2}
        st = {"batch": 0, "head": 1}
        return _per_shard(
            lambda r, k, v, w, u, state, state_out: wkv(
                r, k, v, w, u, state, state_out, plain, pair),
            "r", {"r": (r, seq), "k": (k, seq), "v": (v, seq),
                  "w": (w, seq), "u": (u, {"head": 0}),
                  "state": (state, st), "state_out": (state_out, st)},
            (seq, st), "wkv", written=("state_out",))
    if pair is not None:
        if state_out is not None:
            raise ValueError("wkv: an in-place state update of split "
                             "sequences")
        return _WkvParts.apply(plain, pair, r, k, v, w, u, state)
    if state_out is None:
        return _Wkv.apply(plain, r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        raise RuntimeError("wkv: the in-place state update (state_out) has "
                           "no gradient; call it under torch.no_grad()")
    on_cpu = _all_on_cpu(r, k, v, w, u, state, state_out, meta=True)
    if r.device.type == "meta":
        return _wkv_meta(r, k, v, w, u, state, state_out)
    if plain or on_cpu:
        return ref.wkv_ref(r, k, v, w, u, state, state_out)
    return _wkv.wkv(r, k, v, w, u, state, state_out)


def ts_scan(terms, carry, switch_u, arrive_u, jitter, svc, harvest_u,
            rec_lo: int, rec_hi: int, hist):
    """One chunk of memsim's timestep backlog scan: carry and hist updated
    in place (arguments: ``ref.ts_scan_ref``)."""
    extra = () if harvest_u is None else (harvest_u,)
    if _all_on_cpu(terms, carry, switch_u, arrive_u, jitter, svc, hist,
                   *extra):
        return ref.ts_scan_ref(terms, carry, switch_u, arrive_u, jitter, svc,
                               harvest_u, rec_lo, rec_hi, hist)
    return _ms.ts_scan(terms, carry, switch_u, arrive_u, jitter, svc,
                       harvest_u, rec_lo, rec_hi, hist)


def event_scan(terms, W, gaps, svc, rec_time, hist):
    """One chunk of memsim's Lindley scan: W and hist updated in place
    (arguments: ``ref.event_scan_ref``)."""
    if _all_on_cpu(terms, W, gaps, svc, rec_time, hist):
        return ref.event_scan_ref(terms, W, gaps, svc, rec_time, hist)
    return _ms.event_scan(terms, W, gaps, svc, rec_time, hist)
