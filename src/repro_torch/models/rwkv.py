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
compare the two paths.  The reference's ``context.use_params`` sharding
hooks stand where it has them (no-ops without active rules).

Channel-mix: token-shift + squared-ReLU MLP with a sigmoid receptance gate.

Where the rows are parts of split sequences (a ``seq_pair`` rule:
``sharding.split_sequences``), each part's token shift starts from the
part before's last row and its WKV from that part's final state, handed
over the ranks that share the sequences (``ops.wkv``'s ``pair``).

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
    if context.seq_pair() is not None:
        prev = context.pair_shift(x[:, -1, :], prev)
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
    p = context.use_params(p, {"wr": (None, "model"), "wk": (None, "model"),
                               "wv": (None, "model"), "wg": (None, "model"),
                               "wo": ("model", None)})
    b, s, d = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    xx = _token_shift(x, shift_state)
    delta = xx - x

    # Data-dependent lerp (ddlerp): one shared low-rank tower -> 5 mixes.
    # Replicated over the mesh before the reshape splits its last axis
    # (DTensor cannot unflatten a sharded axis into 5 mixes), and pinned so
    # after it: its gradient is laid out so before the reshape's backward
    # flattens it (DTensor 2.11 left the rank axis split there, and cannot
    # flatten a split axis).
    lora = context.constrain(
        context.constrain(torch.tanh(x @ p["mix_w1"]),
                          ("batch", "seq", "rank")).reshape(b, s, 5, -1),
        ("batch", "seq", "mix", "rank"))
    mixes = p["mix_base"][None, None] + torch.einsum(
        "bsmr,mrd->bsmd", lora,
        context.idle_columns(p["mix_w2"], x))   # (B,S,5,D)
    xr, xk, xv, xw, xg = (x + delta * torch.sigmoid(mixes[:, :, i])
                          for i in range(5))

    # (On a mesh, each shard of a channel axis split into heads holds
    # whole heads.)
    heads = lambda t: context.whole_heads(t, h).reshape(b, s, h, hd)
    r = heads(xr @ p["wr"])
    k = heads(xk @ p["wk"])
    v = heads(xv @ p["wv"])
    g = F.silu(xg @ p["wg"])

    # Data-dependent per-channel decay in (0, 1).
    dd = p["decay_base"] + torch.tanh(xw @ p["decay_w1"]) @ \
        context.idle_columns(p["decay_w2"], x)
    w = heads(torch.exp(-torch.exp(dd.float() - 3.0)))       # near 1.0 init
    u = context.whole_heads(p["bonus_u"], h).reshape(h, hd).float()

    y, new_state = _wkv_scan(r, k, v, w, u, wkv_state, plain_kernels,
                             state_out)
    y = y.reshape(b, s, d).to(x.dtype)
    # Group norm over heads (ln_x) then output gate + projection.
    yh = heads(y).float()
    var = yh.square().mean(dim=-1, keepdim=True)
    mu = yh.mean(dim=-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var - mu.square() + cfg.norm_eps)
    y = (yh.reshape(b, s, d) * (1.0 + p["ln_x"].float())).to(x.dtype)
    # The output projection contracts each model rank's heads, whole on
    # the batch axes, into each data rank's part of the features at batch
    # 1 (``context.idle_features``; torch versions differ in what DTensor
    # picks there left to itself).
    out = context.batch_rows(y * g) @ context.idle_columns(p["wo"], x)
    return out, (x[:, -1, :], new_state)


def channel_mix(cfg: ModelConfig, p: dict, x, shift_state):
    p = context.use_params(p, {"cm_wk": (None, "model"),
                               "cm_wr": (None, "model"),
                               "cm_wv": ("model", None)})
    xx = _token_shift(x, shift_state)
    delta = xx - x
    xk = x + delta * torch.sigmoid(p["cm_mix"][0])[None, None]
    xr = x + delta * torch.sigmoid(p["cm_mix"][1])[None, None]
    kk = F.relu(xk @ p["cm_wk"]).square()
    rr = torch.sigmoid(xr @ p["cm_wr"])
    # At batch 1 each data rank writes its part of the features, as in
    # time_mix's output projection.
    return rr * (kk @ context.idle_columns(p["cm_wv"], x)), x[:, -1, :]


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device):
    """(tm_shift, wkv_state, cm_shift) zeros for decode/stream."""
    d, h, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    return (torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, d), dtype=dtype, device=device))
