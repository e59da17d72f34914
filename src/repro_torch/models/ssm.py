"""Mamba2 (SSD) blocks: chunked prefill scan + O(1)-state decode step.

Port of ``repro/models/ssm.py``.  Within a chunk of Q tokens the output is
a masked (C_i . B_j) kernel against the inputs; across chunks an
(H, N, P) state is carried by an exponential-decay recurrence.  The
reference scans the chunks with ``jax.lax.scan``; here a Python loop takes
one step a chunk (16 at 1,024 tokens).  Decode is the plain recurrent
update.  The SSD and the decode step are ``jnp`` code in the reference, not
Pallas, so they stay torch ops; the reference's ``context.use_params``
sharding hook stands where it has it (a no-op without active rules).

Layout conventions: x (B, S, D); inner activations (B, S, H, P) with
H = d_inner / P heads; B/C projections are shared across heads (one group).

Dtypes as in the reference: the projections and the causal conv run in
the model dtype, the SSD and the decode step in float32; ``y`` is cast to
``x.dtype`` before the gate, and the gated RMS norm takes its variance in
float32.  The step sizes go through ``softplus`` as ``logaddexp(x, 0)``,
JAX's own form (``F.softplus`` returns x above 20, 2e-9 away); the
chunk's cumulative sum of the decays adds in XLA's order
(``core/xlamath.cumsum0``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import xlamath
from repro_torch.distributed import context
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Spec

#: Chunk length for the SSD scan.
SSD_CHUNK = 64


def ssm_specs(cfg: ModelConfig, layered: bool = True,
              n_layers: int | None = None) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_heads
    cw = cfg.ssm_conv
    nl = cfg.n_layers if n_layers is None else n_layers
    ls, la = ((nl,), ("layers",)) if layered else ((), ())
    return {
        # x -> [z (di), x_ssm (di), B (n), C (n), dt (h)]
        "in_proj": Spec(ls + (d, 2 * di + 2 * n + h), la + ("embed", "ssm_inner")),
        "conv_w": Spec(ls + (cw, di + 2 * n), la + ("conv", "ssm_inner"),
                       init="normal", scale=1.0),
        "conv_b": Spec(ls + (di + 2 * n,), la + ("ssm_inner",), init="zeros"),
        "a_log": Spec(ls + (h,), la + ("heads",), init="zeros"),
        "dt_bias": Spec(ls + (h,), la + ("heads",), init="zeros"),
        "d_skip": Spec(ls + (h,), la + ("heads",), init="zeros"),
        "out_proj": Spec(ls + (di, d), la + ("ssm_inner", "embed")),
        "gate_norm": Spec(ls + (di,), la + ("ssm_inner",), init="zeros"),
    }


def _split_proj(cfg: ModelConfig, proj):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xc = proj[..., di:2 * di]
    b = proj[..., 2 * di:2 * di + n]
    c = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    if dt.shape[-1] != h:
        raise ValueError(f"in_proj gives {dt.shape[-1]} step sizes, want {h}")
    return z, xc, b, c, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv over (B, S, C) with window len(w)."""
    cw = w.shape[0]
    # Zeros joined on, not F.pad: DTensor 2.11 has no strategy for the pad.
    pad = torch.cat([torch.zeros((x.shape[0], cw - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device), x], dim=1)
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(cw))
    return out + b


def _ssd_chunked(xh, dt, a, bmat, cmat, init_state=None):
    """Chunked SSD.

    xh:   (B, S, H, P) inputs
    dt:   (B, S, H)    softplus'd step sizes
    a:    (H,)         negative decay rates (a < 0)
    bmat: (B, S, N)    input->state projection (shared across heads)
    cmat: (B, S, N)    state->output projection
    init_state: optional (B, H, N, P) carried state (prefill continuation)
    returns y (B, S, H, P) float32, final_state (B, H, N, P) float32

    A prompt whose length is not a multiple of ``SSD_CHUNK`` is one chunk
    of its own length, as in the reference.  The reference's two
    three-operand einsums are contracted pairwise so that no
    (B, nc, Q, H, N, P) product is ever formed (2.7e9 values a layer at
    zamba2's B 8, S 1,024): ``state_in`` scales x by dt * decay_to_end,
    then takes one product over q per chunk; ``y_off`` reads the state out
    through C first, then scales by exp(seg).
    """
    bsz, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = SSD_CHUNK if s % SSD_CHUNK == 0 else s
    nc = s // q

    f32 = torch.float32
    xh = xh.to(f32).reshape(bsz, nc, q, h, p)
    dt = dt.to(f32).reshape(bsz, nc, q, h)
    bm = bmat.to(f32).reshape(bsz, nc, q, n)
    cm = cmat.to(f32).reshape(bsz, nc, q, n)

    da = dt * a                                         # (B,nc,Q,H), <= 0
    # Within-chunk cumsum, in XLA's order of additions: seg reaches ~-1e2
    # over a chunk, where a float32 step is ~1e-5, and exp(seg_i - seg_j)
    # carries that absolute error as a relative one into every term, so
    # torch.cumsum's order alone moves y by ~1e-5 relative a layer.
    seg = xlamath.cumsum0(da.movedim(2, 0)).movedim(0, 2)
    total = seg[:, :, -1, :]                            # (B,nc,H)

    # Within-chunk (diagonal) term.  Above the diagonal exp(seg_i - seg_j)
    # is inf: the mask selects 0 there before anything multiplies it.
    cb = torch.einsum("bcin,bcjn->bcij", cm, bm)         # (B,nc,Q,Q)
    decay = torch.exp(seg[:, :, :, None, :] - seg[:, :, None, :, :])
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = torch.where(mask[None, None, :, :, None], decay, 0.0)
    kern = cb[..., None] * decay * dt[:, :, None, :, :]  # (B,nc,Q,Q,H)
    del decay
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", kern, xh)
    del kern

    # Chunk-boundary states: contribution of chunk c to the carried state.
    decay_to_end = torch.exp(total[:, :, None, :] - seg)   # (B,nc,Q,H)
    xw = (dt * decay_to_end)[..., None] * xh               # (B,nc,Q,H,P)
    state_in = torch.einsum("bcqn,bcqhp->bchnp", bm, xw)   # (B,nc,H,N,P)
    del xw

    state = (torch.zeros((bsz, h, n, p), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    growth = torch.exp(total)                              # (B,nc,H)
    prev = []                                              # state *before* c
    for c in range(nc):
        prev.append(state)
        state = state * growth[:, c, :, None, None] + state_in[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,N,P)

    # Off-diagonal term: prior state read out through C with decay.
    y_off = torch.einsum("bcqn,bchnp->bcqhp", cm, prev_states)
    y_off = y_off * torch.exp(seg)[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, state


def mamba_apply(cfg: ModelConfig, p: dict, x, state=None, conv_state=None):
    """Mamba2 block.

    No state: x (B, S, D) -> (y, (state, conv_state)), the conv padded
    with zeros.  With (state, conv_state): S > 1 continues a prefill (the
    conv window starts from ``conv_state``, the SSD from ``state``), S == 1
    is the recurrent decode step.  Returns new tensors; the caller decides
    where they go.
    """
    bsz, s, _ = x.shape
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    p = context.use_params(p, {"in_proj": (None, None),
                               "out_proj": (None, None)})
    proj = x @ p["in_proj"]
    z, xc, bmat, cmat, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xc, bmat, cmat], dim=-1)          # (B,S,di+2n)
    if state is None:
        conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
        new_conv_state = conv_in[:, -(cfg.ssm_conv - 1):, :]
    else:
        window = torch.cat([conv_state, conv_in], dim=1)
        conv = _causal_conv(window, p["conv_w"], p["conv_b"])[:, -s:, :]
        new_conv_state = window[:, -(cfg.ssm_conv - 1):, :]
    conv = F.silu(conv)
    xc, bmat, cmat = (conv[..., :di], conv[..., di:di + n],
                      conv[..., di + n:])

    xh = xc.reshape(bsz, s, h, pdim)
    dt = dt.float() + p["dt_bias"]
    dt = torch.logaddexp(dt, dt.new_zeros(()))                # softplus
    a = -torch.exp(p["a_log"].float())                        # (H,) < 0

    if state is None:
        y, new_state = _ssd_chunked(xh, dt, a, bmat, cmat)
    elif s > 1:
        # Prefill continuation: chunked path seeded with the carried state.
        y, new_state = _ssd_chunked(xh, dt, a, bmat, cmat, init_state=state)
    else:
        # Recurrent decode step (s == 1).  On a mesh each shard of the
        # state holds whole heads: at batch 1 DTensor would split the heads
        # over ranks that do not divide them, and could not flatten them.
        da = torch.exp(dt[:, 0] * a)                          # (B,H)
        xs = dt[:, 0, :, None] * xh[:, 0].float()             # (B,H,P)
        upd = bmat[:, 0].float()[:, None, :, None] * xs[:, :, None, :]
        new_state = context.whole_heads(
            state * da[..., None, None] + upd, h, dim=1)      # (B,H,N,P)
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(),
                         new_state)[:, None]                  # (B,1,H,P)

    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    # Gated RMS norm (Mamba2's norm-before-out-proj).
    gated = y * F.silu(z)
    g32 = gated.float()
    var = g32.square().mean(dim=-1, keepdim=True)
    gated = (g32 * torch.rsqrt(var + cfg.norm_eps) *
             (1.0 + p["gate_norm"].float())).to(x.dtype)
    out = gated @ p["out_proj"]
    return out, (new_state, new_conv_state)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device):
    """(state, conv_state) zeros for decode: the state in float32, the
    conv window in ``dtype``."""
    state = torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                         cfg.ssm_head_dim), dtype=torch.float32,
                        device=device)
    conv_state = torch.zeros(
        (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
        dtype=dtype, device=device)
    return state, conv_state
