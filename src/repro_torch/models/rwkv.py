"""RWKV6 ("Finch") blocks: data-dependent-decay linear attention.

Port of ``repro/models/rwkv.py``.  Time-mix: token-shift interpolation
with data-dependent mixing (low-rank ddlerp), per-channel data-dependent
decay w_t = exp(-exp(...)), and the WKV matrix-state recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

carried as an (H, hd, hd) fp32 state per head.  The recurrence is
``kernels.ops.wkv``: the hand ``wkv`` kernel on the card (and K3b, its
backward, under autograd), their plain versions on the CPU;
``plain_kernels=True`` sends it to the plain versions on any device, to
compare the two paths.

Channel-mix: token-shift + squared-ReLU MLP with a sigmoid receptance gate.

Where the rows are parts of split sequences (a ``seq_pair`` rule:
``sharding.split_sequences``), each part's token shift starts from the
part before's last row and its WKV from that part's final state, handed
over the ranks that share the sequences (``ops.wkv``'s ``pair``).

On a mesh (a step entered under ``distributed/context``'s rules) both
blocks run on each rank's local tensors, split as the port chooses
(``context.Ranks``), with explicit collectives, each weight gathered at
its use.  The rows split over the data ranks where the batch divides
them; each ``model`` rank takes its heads (the columns of ``wr``, ``wk``,
``wv``, ``wg`` and of the decay tower's second product, the WKV, the
rows of ``wo``: a pending sum, all-reduced) and, where the batch leaves
the data ranks idle (batch 1), each of those a part of its rank's head
columns, gathered before the WKV.  The low-rank towers split their
columns, and the five mixes their features, over the same ranks and are
gathered (one all-gather of B x S x 5R and of B x S x 5 x D).  The
channel mix splits ``cm_wk``'s columns and ``cm_wv``'s rows (a pending
sum, reduce-scattered to the columns of ``cm_wr`` that the rank took)
and gathers the gated product.  The decode cache keeps its WKV states'
heads over ``model`` (``context.cache_heads``).  Without active rules the
blocks are the one-device code, bit for bit.

Each block returns its new shift and WKV states, as the reference does.
``time_mix`` writes the new WKV state into ``state_out`` when given, which
may be the input state itself: the stack updates its decode cache in place
that way (see ``transformer``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import context
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Spec


def rwkv_specs(cfg: ModelConfig, layered: bool = True) -> dict:
    d, f, r = cfg.d_model, cfg.d_ff, cfg.rwkv_lora_rank
    ls, la = ((cfg.n_layers,), ("layers",)) if layered else ((), ())
    return {
        # time-mix
        "mix_base": Spec(ls + (5, d), la + ("mix", "embed"), init="zeros"),
        "mix_w1": Spec(ls + (d, 5 * r), la + ("embed", "rank")),
        "mix_w2": Spec(ls + (5, r, d), la + ("mix", "rank", "embed")),
        "wr": Spec(ls + (d, d), la + ("embed", "heads")),
        "wk": Spec(ls + (d, d), la + ("embed", "heads")),
        "wv": Spec(ls + (d, d), la + ("embed", "heads")),
        "wg": Spec(ls + (d, d), la + ("embed", "heads")),
        "decay_base": Spec(ls + (d,), la + ("embed",), init="zeros"),
        "decay_w1": Spec(ls + (d, r), la + ("embed", "rank")),
        "decay_w2": Spec(ls + (r, d), la + ("rank", "embed")),
        "bonus_u": Spec(ls + (d,), la + ("embed",), init="zeros"),
        "ln_x": Spec(ls + (d,), la + ("embed",), init="zeros"),
        "wo": Spec(ls + (d, d), la + ("heads", "embed")),
        # channel-mix
        "cm_mix": Spec(ls + (2, d), la + ("mix", "embed"), init="zeros"),
        "cm_wk": Spec(ls + (d, f), la + ("embed", "mlp")),
        "cm_wr": Spec(ls + (d, d), la + ("embed", "heads")),
        "cm_wv": Spec(ls + (f, d), la + ("mlp", "embed")),
    }


def _token_shift(x, prev):
    """Shift right by one: position t sees x_{t-1}; ``prev`` seeds t=0.
    Where the rows are parts of split sequences (a ``seq_pair`` rule),
    a part's t=0 sees the previous part's last row (the first part's,
    ``prev``)."""
    pair = context.seq_pair()
    if pair is not None:
        prev = pair.shift(x[:, -1, :], prev)
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_scan(r, k, v, w, u, state, plain_kernels: bool = False,
              state_out=None):
    """WKV recurrence over time.

    r/k/v: (B, S, H, hd); w: (B, S, H, hd) fp32 decays in (0,1);
    u: (H, hd) fp32 bonus; state: (B, H, hd, hd) fp32 (key x value
    layout).  Returns y (B, S, H, hd) fp32, new_state (``state_out`` when
    given).  Parts of split sequences run in order, each from the state
    the part before hands over (``ops.wkv``'s ``pair``).
    """
    return ops.wkv(r, k, v, w, u, state, state_out, plain=plain_kernels,
                   pair=context.seq_pair())


def time_mix(cfg: ModelConfig, p: dict, x, shift_state, wkv_state,
             plain_kernels: bool = False, state_out=None):
    """x: (B, S, D) -> (y, (new_shift, new_wkv)).  The new WKV state is
    written into ``state_out`` when given (it may be ``wkv_state``)."""
    if context.frame() is not None:
        return _time_mix_sharded(cfg, p, x, shift_state, wkv_state,
                                 plain_kernels, state_out)
    b, s, d = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    xx = _token_shift(x, shift_state)
    delta = xx - x

    # Data-dependent lerp (ddlerp): one shared low-rank tower -> 5 mixes.
    lora = torch.tanh(x @ p["mix_w1"]).reshape(b, s, 5, -1)
    mixes = p["mix_base"][None, None] + torch.einsum(
        "bsmr,mrd->bsmd", lora, p["mix_w2"])     # (B,S,5,D)
    xr, xk, xv, xw, xg = (x + delta * torch.sigmoid(mixes[:, :, i])
                          for i in range(5))

    r = (xr @ p["wr"]).reshape(b, s, h, hd)
    k = (xk @ p["wk"]).reshape(b, s, h, hd)
    v = (xv @ p["wv"]).reshape(b, s, h, hd)
    g = F.silu(xg @ p["wg"])

    # Data-dependent per-channel decay in (0, 1).
    dd = p["decay_base"] + torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    w = torch.exp(-torch.exp(dd.float() - 3.0)).reshape(b, s, h, hd)
    u = p["bonus_u"].reshape(h, hd).float()

    y, new_state = _wkv_scan(r, k, v, w, u, wkv_state, plain_kernels,
                             state_out)
    y = _group_norm(cfg, y.reshape(b, s, d).to(x.dtype), p["ln_x"], h)
    return (y * g) @ p["wo"], (x[:, -1, :], new_state)


def _group_norm(cfg: ModelConfig, y, ln_x, h: int):
    """ln_x: the norm over each of the ``h`` heads of y (B, S, h x hd) in
    float32, scaled by 1 + ln_x, in y's dtype."""
    b, s, _ = y.shape
    yh = y.reshape(b, s, h, -1).float()
    var = yh.square().mean(dim=-1, keepdim=True)
    mu = yh.mean(dim=-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var - mu.square() + cfg.norm_eps)
    return (yh.reshape(b, s, -1) * (1.0 + ln_x.float())).to(y.dtype)


def channel_mix(cfg: ModelConfig, p: dict, x, shift_state):
    if context.frame() is not None:
        return _channel_mix_sharded(cfg, p, x, shift_state)
    xx = _token_shift(x, shift_state)
    delta = xx - x
    xk = x + delta * torch.sigmoid(p["cm_mix"][0])[None, None]
    xr = x + delta * torch.sigmoid(p["cm_mix"][1])[None, None]
    kk = F.relu(xk @ p["cm_wk"]).square()
    rr = torch.sigmoid(xr @ p["cm_wr"])
    return rr * (kk @ p["cm_wv"]), x[:, -1, :]


# ---------------------------------------------------------------------------
# The blocks on a mesh.
# ---------------------------------------------------------------------------

def _time_mix_sharded(cfg, p, x, shift_state, wkv_state, plain_kernels,
                      state_out):
    """:func:`time_mix` on a mesh (module note)."""
    h, hd, rank = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.rwkv_lora_rank
    d = x.shape[-1]
    rk = context.Ranks(context.model_dim(h), (d,))
    xl = rk.enter(x)
    b, s, _ = xl.shape
    delta = _token_shift(xl, rk.enter(shift_state)) - xl

    # The low-rank tower's columns and the mixes' features split over the
    # sharing ranks, each gathered whole.
    dims, cols = rk.part(5 * rank)
    lora = rk.gather(torch.tanh(xl @ rk.whole(p["mix_w1"])[:, cols]), dims)
    dims, feat = rk.part(d)
    mixes = rk.whole(p["mix_base"])[None, None, :, feat] + torch.einsum(
        "bsmr,mrd->bsmd", lora.reshape(b, s, 5, rank),
        rk.whole(p["mix_w2"])[..., feat])
    mix = rk.gather(torch.sigmoid(mixes), dims)
    xr, xk, xv, xw, xg = (xl + delta * mix[:, :, i] for i in range(5))

    # Each model rank's heads; an idle rank's part of their columns.
    width = d if rk.model is None else d // rk.mesh.size(rk.model)
    mine = rk.sub(width)

    def head_cols(t, w, base=None):
        out = t @ rk.block(w, 1)[:, mine]
        if base is not None:
            out = rk.block(base, 0)[mine] + out
        return rk.gather(out, rk.idle)

    hl = width // hd
    r = head_cols(xr, p["wr"]).reshape(b, s, hl, hd)
    k = head_cols(xk, p["wk"]).reshape(b, s, hl, hd)
    v = head_cols(xv, p["wv"]).reshape(b, s, hl, hd)
    g = F.silu(head_cols(xg, p["wg"]))
    dims, cols = rk.part(rank)
    tower = rk.gather(torch.tanh(xw @ rk.whole(p["decay_w1"])[:, cols]), dims)
    dd = head_cols(tower, p["decay_w2"], p["decay_base"])
    w = torch.exp(-torch.exp(dd.float() - 3.0)).reshape(b, s, hl, hd)
    u = rk.block(p["bonus_u"], 0).reshape(hl, hd).float()

    state = _state_local(rk, wkv_state, h)
    out_local = None if state_out is None else (
        state if state_out is wkv_state else _state_local(rk, state_out, h))
    y, new_state = ops.wkv(r, k, v, w, u, state, out_local,
                           plain=plain_kernels, pair=context.seq_pair())
    y = _group_norm(cfg, y.reshape(b, s, width).to(x.dtype),
                    rk.block(p["ln_x"], 0), hl)
    # The rank's rows of wo: a pending sum over the sharing ranks.
    out = rk.sum((y * g)[..., mine] @ rk.block(p["wo"], 0)[mine],
                 rk.share)
    return out, (x[:, -1, :], new_state)


def _state_local(rk, state, h: int):
    """A (B, H, hd, hd) WKV state of ``h`` heads, this rank's rows, as its
    model rank's heads: as it is where it holds them already (a cache's
    slice, which the WKV may write in place: ``context.cache_heads``),
    else their slice of the whole (the zero state of a pass without a
    cache)."""
    if state.shape[1] != h:
        return state
    index, k = rk.index([] if rk.model is None else [rk.model])
    return rk.enter(state)[:, index * (h // k):(index + 1) * (h // k)]


def _channel_mix_sharded(cfg, p, x, shift_state):
    """:func:`channel_mix` on a mesh (module note)."""
    d = x.shape[-1]
    rk = context.Ranks(context.model_dim(cfg.rwkv_heads), (d, cfg.d_ff))
    xl = rk.enter(x)
    delta = _token_shift(xl, rk.enter(shift_state)) - xl
    mix = rk.whole(p["cm_mix"])
    xk = xl + delta * torch.sigmoid(mix[0])[None, None]
    xr = xl + delta * torch.sigmoid(mix[1])[None, None]
    m = 1 if rk.model is None else rk.mesh.size(rk.model)
    hidden, mine = rk.sub(cfg.d_ff // m), rk.sub(d // m)
    kk = F.relu(xk @ rk.block(p["cm_wk"], 1)[:, hidden]).square()
    rr = torch.sigmoid(xr @ rk.block(p["cm_wr"], 1)[:, mine])
    # The rank's rows of cm_wv: a pending sum, summed into the columns of
    # rr that the rank took.
    vv = rk.scatter(kk @ rk.block(p["cm_wv"], 0)[hidden], rk.share)
    out = rk.gather(rr * vv, rk.share, partial_grad=False)
    return out, x[:, -1, :]


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device):
    """(tm_shift, wkv_state, cm_shift) zeros for decode/stream."""
    d, h, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    return (torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, d), dtype=dtype, device=device))
