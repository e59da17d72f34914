"""Top-k routed mixture-of-experts with capacity-based dispatch.

Port of ``repro/models/moe.py``.  Routing uses deterministic
position-in-expert ranks (a cumsum over the flattened token-slot order),
the standard Switch/GShard-style capacity discipline: overflow tokens fall
back to the residual path.  Every expert's ``(capacity, D)`` buffer is
computed, empty slots included, by grouped products (``torch.bmm``), as
the reference's einsums do outside any Pallas kernel.

On a mesh of more than one rank (a step entered under
``distributed/context``'s rules: local activations, ``layout.Block``
weights) the block lays the work out as GSPMD lays out the reference's: the (E, capacity, D) buffer is
split, experts over ``model`` (the rules' ``experts``) and the capacity
over the other ranks, and each rank computes only its own block
(:func:`_moe_sharded`).  The semantics stay global: one capacity for the
whole batch, and each (token, slot)'s rank within its expert counts every
earlier slot of the batch in flat order.  Each data rank routes its own
tokens (a contiguous range of that order) and adds the counts of the
ranks before it (:func:`global_ranks`), which one all-reduce of a (ranks,
E) table exchanges, so its ranks equal one device's exactly.  The buffer's
block is filled by a gather, not a scatter: each of its slots holds one
(token, slot) at most, found by an inverse map over the whole batch, so
the shapes never depend on the routing (the dry run's ``meta`` shards know
no count).  A slot's token may live on another data rank, so the design
all-gathers the routing results (an int code of expert and slot, and the
weights) and every token row of the batch over the data ranks: (T, D) on
each rank in each layer, where its block needs at most (E/M) x (C/Dn)
rows.  A dispatch with static shapes that moves only the block's rows
exists, GShard's all-to-all of fixed-capacity (E, C, D) buffers (each
data rank lays its own (token, slot)s at their global slots, and each
block is summed from its pieces); it is not built yet.  Each rank scatters its block's
outputs into a batch-long partial ``y``, which a reduce-scatter over the
token ranks and an all-reduce over the others lay out as the residual
stream.  The auxiliary losses are global means: local sums, all-reduced.
A DTensor input (the block called by itself) is taken apart and its
results put back together (:func:`_moe_containers`).  Without active
rules, or on a mesh of one rank, :func:`moe_apply` is the one-device code
above, bit for bit.

Where the batch's rows are parts of split sequences (a ``seq_pair``
rule: ``sharding.split_sequences``), the ranks still count slots in the
sequences' own (b, s) order (:func:`global_ranks`' ``parts``), so the
same tokens overflow as in one process.

Two details carry the reference's exact order:
  * ``jax.lax.top_k`` puts the lower index first among equal values, and
    the slot order feeds the cumsum priority.  ``torch.topk`` promises no
    order among ties, so :func:`top_k` takes a stable descending sort.
  * ``jax.nn.gelu`` is the tanh form.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed import context
from repro_torch.distributed.layout import (Block, all_reduce_local,
                                            gather_local, pending_local,
                                            scatter_sum_local, shard_start,
                                            whole_block, wrap)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Spec


def moe_specs(cfg: ModelConfig, layered: bool = True) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    ls, la = ((cfg.n_layers,), ("layers",)) if layered else ((), ())
    specs = {
        "router": Spec(ls + (d, e), la + ("embed", "experts_router")),
        "wi": Spec(ls + (e, d, f), la + ("experts", "embed", "mlp")),
        "wo": Spec(ls + (e, f, d), la + ("experts", "mlp", "embed")),
    }
    if cfg.activation == "swiglu":
        specs["wg"] = Spec(ls + (e, d, f), la + ("experts", "embed", "mlp"))
    return specs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cap, cfg.top_k)


def top_k(x, k: int):
    """(values, indices) of the k largest entries of the last axis, largest
    first and, among equal values, the lower index first (as
    ``jax.lax.top_k``)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(cfg: ModelConfig, router, xf):
    """xf: (T, D) -> (gate logits (T, E) fp32, gates (T, E), top-k weights
    (T, k) renormalised, top-k experts (T, k))."""
    gate_logits = (xf @ router).float()
    gates = torch.softmax(gate_logits, dim=-1)
    topw, topi = top_k(gates, cfg.top_k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return gate_logits, gates, topw, topi


def moe_apply(cfg: ModelConfig, p: dict, x, return_aux: bool = False):
    """x: (B, S, D) -> (B, S, D) [+ aux losses dict]."""
    if isinstance(x, DTensor):
        return _moe_containers(cfg, p, x, return_aux)
    f = context.frame()
    if f is not None and f.mesh.size() > 1:
        return _moe_sharded(cfg, p, x, return_aux)
    if f is not None:
        p = {name: context.whole(w) for name, w in p.items()}
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xf = context.constrain(x.reshape(t, d), ("tokens", "embed"))
    gate_logits, gates, topw, topi = route(cfg, p["router"], xf)

    cap = capacity(cfg, t)
    # Rank each (token, slot) within its expert, in flat priority order
    # (:func:`slot_ranks`).
    eid = topi.reshape(-1)                                   # (T*k,)
    rank_of = slot_ranks(e, eid)[0].reshape(t, k)            # (T, k)
    keep = rank_of < cap
    sid = torch.clamp(rank_of, max=cap - 1).reshape(-1)
    w_disp = (topw * keep).to(x.dtype).reshape(-1)           # (T*k,)

    # Dispatch: scatter token vectors into per-expert capacity buffers.
    # Dropped slots add a zero to (e, cap - 1), beside the kept token there:
    # every sum holds one value and zeros, so it is exact in any order.
    upd = xf.repeat_interleave(k, dim=0) * (w_disp != 0)[:, None]
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.view(e * cap, d).index_add_(0, eid * cap + sid, upd)

    # Expert computation: grouped products over the E axis.
    if cfg.activation == "swiglu":
        h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    else:
        h = F.gelu(torch.bmm(buf, p["wi"]), approximate="tanh")
    out_buf = torch.bmm(h, p["wo"])                          # (E, C, D)

    # Combine: gather each slot back and weight by the router.
    gathered = out_buf[eid, sid]                             # (T*k, D)
    y = (gathered * w_disp[:, None]).reshape(t, k, d).sum(dim=1)
    y = y.reshape(b, s, d)

    if not return_aux:
        return y
    # Switch-style load-balance loss + router z-loss.
    density = F.one_hot(topi[:, 0], e).float().mean(dim=0)
    router_prob = gates.mean(dim=0)
    lb_loss = e * torch.sum(density * router_prob)
    z_loss = torch.logsumexp(gate_logits, dim=-1).square().mean()
    return y, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
               "moe_overflow": 1.0 - keep.float().mean()}


# ---------------------------------------------------------------------------
# The block on a mesh: each rank its own block of the expert buffers.
# ---------------------------------------------------------------------------

def slot_ranks(n_experts: int, eid):
    """eid (N,), the experts of N (token, slot)s in flat order -> (each
    one's rank within its expert among these N, the count of each
    expert's slots (E,)).

    The reference's exclusive cumsum of the one-hot (N, E) over slots,
    read at each slot's own expert.  Laid out (E, N), the cumsum runs
    along the contiguous axis (on an H100, PyTorch's scan down the 65,536
    rows of the (N, E) layout took ~23 ms a layer of olmoe's prefill); at
    the slot's own expert the inclusive count less one is the exclusive
    one."""
    hit = eid[None, :] == torch.arange(n_experts, device=eid.device)[:, None]
    csum = torch.cumsum(hit, dim=1)
    return csum.gather(0, eid[None, :])[0] - 1, csum[:, -1]


def global_ranks(n_experts: int, eid, mesh, tok_dims, parts: int = 1,
                 rows: int = 1):
    """Local (token, slot)s' ranks within their experts over the whole
    batch: the local ranks plus the slots the token shards before this one
    send to each expert.  Each shard fills its own row of a (shards, E)
    table of counts, and one all-reduce over ``tok_dims`` gives every
    shard all of them.

    With ``parts`` > 1 the shard's ``rows`` batch rows are parts of split
    sequences (``sharding.split_sequences``: global row p B + b holds part
    p of sequence b), and the order is still the sequences' own, (b, s),
    as one device ranks them, so that the same tokens overflow: the table
    holds each row's counts, and a row's offset sums those of every row
    of an earlier sequence and of its own sequence's earlier parts."""
    if parts > 1:
        return _part_ranks(n_experts, eid, mesh, tok_dims, parts, rows)
    rank, counts = slot_ranks(n_experts, eid)
    if not tok_dims:
        return rank
    shards, index = _shard_index(mesh, tok_dims)
    table = torch.zeros((shards, n_experts), dtype=counts.dtype,
                        device=counts.device)
    table[index] = counts
    table = all_reduce_local(table, mesh, tok_dims)
    return rank + table[:index].sum(dim=0)[eid]


def _shard_index(mesh, tok_dims):
    """(shards over ``tok_dims``, this rank's index among them, the first
    dimension major)."""
    coord, shards, index = mesh.get_coordinate(), 1, 0
    for i in tok_dims:
        shards *= mesh.size(i)
        index = index * mesh.size(i) + coord[i]
    return shards, index


def _part_ranks(n_experts: int, eid, mesh, tok_dims, parts: int,
                rows: int):
    """:func:`global_ranks` of a shard whose ``rows`` rows are parts of
    split sequences."""
    ids = eid.view(rows, -1)                                  # (rows, n)
    hit = ids[:, None, :] == torch.arange(n_experts,
                                          device=eid.device)[None, :, None]
    csum = torch.cumsum(hit, dim=2)                           # (rows, E, n)
    within = csum.gather(1, ids[:, None, :])[:, 0] - 1
    shards, index = _shard_index(mesh, tok_dims)
    table = torch.zeros((shards * rows, n_experts), dtype=csum.dtype,
                        device=eid.device)
    table[index * rows:(index + 1) * rows] = csum[:, :, -1]
    table = all_reduce_local(table, mesh, tok_dims)
    seqs = shards * rows // parts
    # The rows in the sequences' order: row b parts + p is part p of b.
    ordered = table.view(parts, seqs, n_experts).transpose(0, 1).reshape(
        -1, n_experts)
    before = torch.cumsum(ordered, dim=0) - ordered
    g = index * rows + torch.arange(rows, device=eid.device)
    key = (g % seqs) * parts + g // seqs
    return (within + before[key].gather(1, ids)).reshape(-1)


def _gathered(x, mesh, tok_dims, partial: bool = False):
    """A local tensor split by rows over ``tok_dims`` (whole elsewhere),
    its rows of every shard in order, on every rank; with ``partial`` its
    gradient a pending sum over every mesh dimension (each rank's block
    uses a part of it)."""
    if partial:
        # The pending sum over the other dimensions reduces this rank's
        # rows, after the gather's reduce-scatter in the backward.
        x = pending_local(x, mesh, [i for i in range(mesh.ndim)
                                    if i not in tok_dims])
    return gather_local(x, mesh, tok_dims, 0, partial_grad=partial)


def _moe_containers(cfg: ModelConfig, p: dict, x, return_aux: bool):
    """:func:`moe_apply` of DTensors (the block called by itself under
    active rules) on this rank's local tensors; its results as DTensors."""
    with context.block_call(x) as f:
        out = moe_apply(cfg, {name: Block.of(w) for name, w in p.items()},
                        f.rows_of(x), return_aux)
        y, aux = out if return_aux else (out, None)
        y = wrap(y, f.mesh, f.placements)
        if not return_aux:
            return y
        whole = (Replicate(),) * f.mesh.ndim
        return y, {name: wrap(v, f.mesh, whole) for name, v in aux.items()}


def _moe_sharded(cfg: ModelConfig, p: dict, x, return_aux: bool):
    """:func:`moe_apply` on a mesh: module note."""
    f = context.frame()
    mesh, every = f.mesh, tuple(range(f.mesh.ndim))
    tok_dims = f.rows
    b, s, d = x.shape
    # One capacity for the whole batch: every rank's tokens.
    t = b * s * math.prod(mesh.size(i) for i in tok_dims)
    e, k = cfg.n_experts, cfg.top_k
    x_loc = x.reshape(-1, d)

    # Routing of this shard's tokens.  Every rank off the token axes routes
    # the same tokens alike, and the weights' gradient reaches it reduced,
    # so the router's gradient is a pending sum over the token axes only.
    router = whole_block(p["router"], tok_dims)
    gate_logits, gates, topw, topi = route(cfg, router, x_loc)
    cap = capacity(cfg, t)
    eid = topi.reshape(-1)
    pair = context.seq_pair()
    rank_of = global_ranks(e, eid, mesh, tok_dims,
                           1 if pair is None else pair.size,
                           x_loc.shape[0] // s).reshape(topi.shape)
    keep = rank_of < cap
    w_disp = (topw * keep).to(x.dtype).reshape(-1)

    # This rank's block: experts by the weights' split, the capacity
    # (padded to a multiple of its ranks) over every other axis.
    wi = p["wi"]
    exp_dims = wi.split(0) if isinstance(wi, Block) else []
    cap_dims = [i for i in every if i not in exp_dims and mesh.size(i) > 1]
    blocks, block = 1, 0
    for i in cap_dims:
        blocks *= mesh.size(i)
        block = block * mesh.size(i) + mesh.get_coordinate()[i]
    c_blk = -(-cap // blocks)
    c_pad = c_blk * blocks
    e0 = shard_start(wi, 0) if exp_dims else 0
    e_loc = e // math.prod(mesh.size(i) for i in exp_dims)

    # Which (token, slot) of the batch fills each slot of the buffer: an
    # inverse map over every rank's routing results, gathered.  A dropped
    # slot and an empty one point past the end (t * k).
    code = torch.where(keep.reshape(-1), eid * c_pad + rank_of.reshape(-1),
                       e * c_pad)
    code_all = _gathered(code, mesh, tok_dims)
    w_all = _gathered(w_disp, mesh, tok_dims, partial=True)
    x_all = _gathered(x_loc, mesh, tok_dims, partial=True)
    inv = torch.full((e * c_pad + 1,), t * k, dtype=code_all.dtype,
                     device=code_all.device).scatter_(
        0, code_all, torch.arange(t * k, device=code_all.device))
    slot = inv[:-1].view(e, c_pad)[e0:e0 + e_loc,
                                   block * c_blk:(block + 1) * c_blk]
    slot = slot.reshape(-1)
    held = slot < t * k
    j = torch.where(held, slot, 0)
    w_blk = w_all[j] * held
    # A slot holds its token's row where its weight is not zero, as the
    # one-device dispatch puts it (an exact copy: one value and zeros).
    buf = (x_all[j // k] * (w_blk != 0)[:, None]).view(e_loc, c_blk, d)

    # The rank's experts, whole otherwise; each rank's block of the
    # capacity a part of their gradient.
    wl = {name: whole_block(p[name], cap_dims, keep=exp_dims)
          for name in ("wi", "wg", "wo") if name in p}
    if cfg.activation == "swiglu":
        h = F.silu(torch.bmm(buf, wl["wg"])) * torch.bmm(buf, wl["wi"])
    else:
        h = F.gelu(torch.bmm(buf, wl["wi"]), approximate="tanh")
    out_blk = torch.bmm(h, wl["wo"]).view(-1, d)             # (E_l*C_b, D)

    # Combine: each slot's output, weighted, into its token's row of a
    # batch-long partial sum, summed into the tokens' layout.
    y = torch.zeros((t, d), dtype=out_blk.dtype, device=out_blk.device)
    y = y.index_add(0, j // k, out_blk * w_blk[:, None])
    y = scatter_sum_local(y, mesh, tok_dims, 0)
    y = all_reduce_local(y, mesh, [i for i in every if i not in tok_dims])
    y = y.reshape(b, s, d)
    if not return_aux:
        return y

    def mean(local_sum, n):
        # A global mean: the local sums, all-reduced over the token axes.
        return all_reduce_local(local_sum, mesh, tok_dims) / n
    density = F.one_hot(topi[:, 0], e).float().sum(dim=0)
    router_prob = gates.sum(dim=0)
    lb_loss = e * torch.sum(mean(density, t) * mean(router_prob, t))
    z_loss = mean(torch.logsumexp(gate_logits, dim=-1).square().sum(), t)
    overflow = 1.0 - mean(keep.float().sum(), t * k)
    return y, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
               "moe_overflow": overflow}
