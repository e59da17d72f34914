"""Top-k routed mixture-of-experts with capacity-based dispatch.

Port of ``repro/models/moe.py``.  Routing uses deterministic
position-in-expert ranks (a cumsum over the flattened token-slot order),
the standard Switch/GShard-style capacity discipline: overflow tokens fall
back to the residual path.  Every expert's ``(capacity, D)`` buffer is
computed, empty slots included, by grouped products (``torch.bmm``), as
the reference's einsums do outside any Pallas kernel.  The reference's
sharding hook (``context.use_params``) stands where it has it; on a mesh
the tokens are gathered before routing (``moe_apply``).

Two details carry the reference's exact order:
  * ``jax.lax.top_k`` puts the lower index first among equal values, and
    the slot order feeds the cumsum priority.  ``torch.topk`` promises no
    order among ties, so :func:`top_k` takes a stable descending sort.
  * ``jax.nn.gelu`` is the tanh form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.distributed import context
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
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    p = context.use_params(p, {"router": (None, None),
                               "wi": ("model", None, None),
                               "wg": ("model", None, None),
                               "wo": ("model", None, None)})
    # Routing ranks every token of the batch against every other: on a
    # mesh the tokens are gathered first, so capacity and ranks are the
    # whole batch's, as on one device.
    xf = context.constrain(x.reshape(t, d), ("tokens", "embed"))
    gate_logits, gates, topw, topi = route(cfg, p["router"], xf)

    cap = capacity(cfg, t)
    # Rank each (token, slot) within its expert, in flat priority order:
    # the reference's exclusive cumsum of the one-hot (T*k, E) over slots,
    # read at each slot's own expert.  Laid out (E, T*k), the cumsum runs
    # along the contiguous axis (on an H100, PyTorch's scan down the 65,536
    # rows of the (T*k, E) layout took ~23 ms a layer of olmoe's prefill);
    # at the slot's own expert the inclusive count less one is the
    # exclusive one.
    eid = topi.reshape(-1)                                   # (T*k,)
    hit = eid[None, :] == torch.arange(e, device=x.device)[:, None]
    rank_of = (torch.cumsum(hit, dim=1).gather(0, eid[None, :]) - 1
               ).reshape(t, k)                               # (T, k)
    keep = rank_of < cap
    sid = torch.clamp(rank_of, max=cap - 1).reshape(-1)
    w_disp = (topw * keep).to(x.dtype).reshape(-1)           # (T*k,)

    # Dispatch: scatter token vectors into per-expert capacity buffers.
    # Dropped slots add a zero to (e, cap - 1), beside the kept token there:
    # every sum holds one value and zeros, so it is exact in any order.
    upd = xf.repeat_interleave(k, dim=0) * (w_disp != 0)[:, None]
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    if isinstance(upd, DTensor):
        # DTensor writes no DTensor into a plain buffer in place.
        buf = buf.view(e * cap, d).index_add(0, eid * cap + sid,
                                             upd).view(e, cap, d)
    else:
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
