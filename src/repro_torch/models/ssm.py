"""Mamba2 (SSD) blocks: chunked prefill scan + O(1)-state decode step.

Port of ``repro/models/ssm.py``.  Within a chunk of Q tokens the output is
a masked (C_i . B_j) kernel against the inputs; across chunks an
(H, N, P) state is carried by an exponential-decay recurrence.  The
reference scans the chunks with ``jax.lax.scan``; here a Python loop takes
one step a chunk (16 at 1,024 tokens).  Decode is the plain recurrent
update.  The SSD and the decode step are ``jnp`` code in the reference, not
Pallas, so they stay torch ops.

Layout conventions: x (B, S, D); inner activations (B, S, H, P) with
H = d_inner / P heads; B/C projections are shared across heads (one group).

On a mesh whose ``model`` axis has more than one rank and divides the
heads, the block splits the SSM heads over ``model``, as GSPMD splits
the reference's from its ``heads`` rule (:func:`_mamba_sharded`): each
rank takes the z, x and step-size columns of ``in_proj`` for its heads
and the B and C columns whole, runs the conv on those channels and the
SSD (or the decode step) on its heads, and multiplies by its rows of
``out_proj``, a pending sum over ``model``.  The gated RMS norm's mean of
squares over the whole ``d_inner`` becomes a sum of each rank's part, one
all-reduce of B x S floats.  The new state is its heads' part of the
cache, which the hybrid stack lays out so (``context.cache_heads``): no
step gathers another rank's heads.  The new conv window's x channels are
gathered to the cache's layout.  Both paths share the conv, the step
sizes, the scan and the gated output (:func:`_conv_window`,
:func:`_step_sizes`, :func:`_scan`, :func:`_gated_out`).  Everything runs
on local tensors; a DTensor input (the block called by itself) is taken
apart and its results put back together (:func:`_mamba_containers`).
Without active rules, or on a mesh of one rank, :func:`mamba_apply` is
the one-device code, bit for bit.

Where the rows are halves of split sequences (a ``seq_pair`` rule:
``sharding.split_sequences``) the block runs on local tensors in either
case: half 1's conv starts from half 0's last inputs, and its SSD from
half 0's final state (:func:`_from_parts`), both handed over the pair of
ranks that share the sequences.

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
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core import xlamath
from repro_torch.distributed import context
from repro_torch.distributed.layout import (Block, all_reduce_local,
                                            gather_local, pending_local,
                                            whole_block, wrap)
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
    pad = torch.cat([torch.zeros((x.shape[0], cw - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device), x], dim=1)
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(cw))
    return out + b


def _ssd_chunked(xh, dt, a, bmat, cmat, init_state=None, pair=None):
    """Chunked SSD.

    xh:   (B, S, H, P) inputs
    dt:   (B, S, H)    softplus'd step sizes
    a:    (H,)         negative decay rates (a < 0)
    bmat: (B, S, N)    input->state projection (shared across heads)
    cmat: (B, S, N)    state->output projection
    init_state: optional (B, H, N, P) carried state (prefill continuation)
    pair: optional ``layout.SeqPair``: each row is this rank's half of a
          sequence split over the pair's ranks (:func:`_from_parts`)
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
             if init_state is None or pair is not None
             else init_state.to(f32))
    growth = torch.exp(total)                              # (B,nc,H)
    prev = []                                              # state *before* c
    for c in range(nc):
        prev.append(state)
        state = state * growth[:, c, :, None, None] + state_in[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,N,P)

    # Off-diagonal term: prior state read out through C with decay.
    y_off = torch.einsum("bcqn,bchnp->bcqhp", cm, prev_states)
    y_off = y_off * torch.exp(seg)[..., None]
    y = y_diag + y_off
    if pair is not None:
        y, state = _from_parts(pair, y, state, cm, seg, total, init_state)
    return y.reshape(bsz, s, h, p), state


def _from_parts(pair, y, final, cm, seg, total, init_state):
    """The SSD of this rank's half of split sequences (``y`` (B, nc, Q, H,
    P) and ``final`` from a zero state) made the SSD from the state its
    half starts from: the scan is linear in that state, whose read-out
    decays from the half's start, exp(the decays' cumulative sum up to
    each position) times C . state, and whose share of the final state is
    it decayed over the whole half.  Half 0 starts from ``init_state``
    (zeros where None), half 1 from half 0's final state, handed over
    (``SeqPair.shift``).  Both ranks run the same ops and collectives;
    exactly the chunked SSD from that state, summed in another order."""
    into = torch.cumsum(total, dim=1) - total               # (B,nc,H)
    lead = torch.exp(into[:, :, None, :] + seg)             # (B,nc,Q,H)
    over = torch.exp(total.sum(dim=1))[..., None, None]     # (B,H,1,1)
    first = None if init_state is None else init_state.float()
    start = pair.shift(final if first is None else final + over * first,
                       first)
    y = y + torch.einsum("bcqn,bhnp->bcqhp", cm, start) * lead[..., None]
    return y, final + over * start


def _conv_window(conv_in, w, b, conv_state, s: int, cw: int):
    """The causal conv of ``conv_in`` (B, S, C) after ``conv_state`` (None:
    zeros), SiLU'd, and the new window: its last ``cw - 1`` inputs."""
    if conv_state is None:
        conv, window = _causal_conv(conv_in, w, b), conv_in
    else:
        window = torch.cat([conv_state, conv_in], dim=1)
        conv = _causal_conv(window, w, b)[:, -s:, :]
    return F.silu(conv), window[:, -(cw - 1):, :]


def _step_sizes(dt, dt_bias, a_log):
    """(softplus'd step sizes (B, S, H) float32, decay rates (H,) < 0)."""
    dt = dt.float() + dt_bias
    return torch.logaddexp(dt, dt.new_zeros(())), -torch.exp(a_log.float())


def _scan(xh, dt, a, bmat, cmat, state, pair=None):
    """The SSD over a prompt (``state`` None, or a prefill continuation
    seeded with it; each row a half of a split sequence with ``pair``), or
    the recurrent decode step (S == 1).  Returns (y (B, S, H, P) float32,
    new state (B, H, N, P))."""
    if state is None or xh.shape[1] > 1 or pair is not None:
        return _ssd_chunked(xh, dt, a, bmat, cmat, init_state=state,
                            pair=pair)
    da = torch.exp(dt[:, 0] * a)                          # (B,H)
    xs = dt[:, 0, :, None] * xh[:, 0].float()             # (B,H,P)
    upd = bmat[:, 0].float()[:, None, :, None] * xs[:, :, None, :]
    new_state = state * da[..., None, None] + upd         # (B,H,N,P)
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(),
                     new_state)[:, None]                  # (B,1,H,P)
    return y, new_state


def _gated_out(cfg: ModelConfig, y, xh, z, d_skip, gate_norm, out_proj,
               mean_square, dtype):
    """The skip term, Mamba2's gated RMS norm (its mean of squares over
    ``d_inner`` by ``mean_square`` of the float32 gated values) and the
    out-projection."""
    bsz, s = y.shape[:2]
    y = y + xh.float() * d_skip[None, None, :, None]
    y = y.reshape(bsz, s, -1).to(dtype)
    g32 = (y * F.silu(z)).float()
    gated = (g32 * torch.rsqrt(mean_square(g32) + cfg.norm_eps) *
             (1.0 + gate_norm.float())).to(dtype)
    return gated @ out_proj


def mamba_apply(cfg: ModelConfig, p: dict, x, state=None, conv_state=None):
    """Mamba2 block.

    No state: x (B, S, D) -> (y, (state, conv_state)), the conv padded
    with zeros.  With (state, conv_state): S > 1 continues a prefill (the
    conv window starts from ``conv_state``, the SSD from ``state``), S == 1
    is the recurrent decode step.  Returns new tensors; the caller decides
    where they go.
    """
    if isinstance(x, DTensor):
        return _mamba_containers(cfg, p, x, state, conv_state)
    bsz, s, _ = x.shape
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f = context.frame()
    dim = context.model_dim(h)
    if dim is not None or (f is not None and context.seq_pair() is not None):
        return _mamba_sharded(cfg, p, x, state, conv_state, dim)
    if f is not None:
        p = {name: context.whole(t) for name, t in p.items()}
    proj = x @ p["in_proj"]
    z, xc, bmat, cmat, dt = _split_proj(cfg, proj)

    conv, new_conv_state = _conv_window(
        torch.cat([xc, bmat, cmat], dim=-1), p["conv_w"], p["conv_b"],
        None if state is None else conv_state, s, cfg.ssm_conv)
    xc, bmat, cmat = (conv[..., :di], conv[..., di:di + n],
                      conv[..., di + n:])

    xh = xc.reshape(bsz, s, h, pdim)
    dt, a = _step_sizes(dt, p["dt_bias"], p["a_log"])
    y, new_state = _scan(xh, dt, a, bmat, cmat, state)
    out = _gated_out(cfg, y, xh, z, p["d_skip"], p["gate_norm"],
                     p["out_proj"],
                     lambda g: g.square().mean(dim=-1, keepdim=True),
                     x.dtype)
    return out, (new_state, new_conv_state)


def _mamba_containers(cfg: ModelConfig, p: dict, x, state, conv_state):
    """:func:`mamba_apply` of DTensors (the block called by itself under
    active rules) on this rank's local tensors: the weights as
    ``layout.Block``s, ``x`` and the cache as the stream's rows, the
    state as this model rank's heads where the block splits them; the
    results as DTensors (the state's heads over ``model`` where split)."""
    with context.block_call(x) as f:
        p = {name: Block.of(t) for name, t in p.items()}
        dim = context.model_dim(cfg.ssm_heads)
        if state is not None:
            # Its rows, and this model rank's heads where the block's
            # results came split so.
            mine = isinstance(state, DTensor) and dim is not None and \
                state.placements[dim].is_shard(1)
            state = state.to_local() if mine else f.rows_of(state)
            if dim is not None and state.shape[1] == cfg.ssm_heads:
                index, k = context.index_over([dim])
                size = cfg.ssm_heads // k
                state = state[:, index * size:(index + 1) * size]
            conv_state = f.rows_of(conv_state)
        y, (new_state, new_conv) = mamba_apply(cfg, p, f.rows_of(x), state,
                                               conv_state)
        heads = tuple(Shard(1) if i == dim else pl
                      for i, pl in enumerate(f.placements))
        return wrap(y, f.mesh, f.placements), (
            wrap(new_state, f.mesh, heads),
            wrap(new_conv, f.mesh, f.placements))


def _mamba_sharded(cfg: ModelConfig, p: dict, x, state, conv_state,
                   dim):
    """:func:`mamba_apply` with the heads split over mesh dimension
    ``dim`` (module note; None: every head on every rank), on each rank's
    local tensors (``state`` the rank's heads, or all of them).  Where
    the rows are halves of split sequences (a ``seq_pair`` rule) half 1's
    conv starts from half 0's last inputs and its SSD from half 0's final
    state (``SeqPair.shift``, :func:`_from_parts`)."""
    bsz, s, _ = x.shape
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f = context.frame()
    mesh = f.mesh
    pair = context.seq_pair()
    split = [] if dim is None else [dim]
    rank, ranks = context.index_over(split)
    hl = h // ranks
    dl = hl * pdim
    # Each rank's heads take a part of the input's gradient and of every
    # weight's.
    xl = pending_local(x, mesh, split)
    w = {name: whole_block(t, f.rows + split) for name, t in p.items()}

    dev = xl.device
    mine = torch.arange(rank * dl, (rank + 1) * dl, device=dev)
    heads = slice(rank * hl, (rank + 1) * hl)
    bc = torch.arange(2 * di, 2 * di + 2 * n, device=dev)
    cols = torch.cat([mine, di + mine, bc,
                      2 * di + 2 * n + torch.arange(rank * hl,
                                                    (rank + 1) * hl,
                                                    device=dev)])
    proj = xl @ w["in_proj"][:, cols]
    z, xc, bmat, cmat, dt = torch.split(proj, [dl, dl, n, n, hl], dim=-1)

    # The conv's channels: this rank's x channels, then B and C whole.
    chans = torch.cat([mine, di + torch.arange(2 * n, device=dev)])
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    window = None if state is None else conv_state[..., chans]
    if pair is not None:
        window = pair.shift(conv_in[:, -(cfg.ssm_conv - 1):], window)
    conv, new_conv = _conv_window(conv_in, w["conv_w"][:, chans],
                                  w["conv_b"][chans], window, s,
                                  cfg.ssm_conv)
    xc, bmat, cmat = conv[..., :dl], conv[..., dl:dl + n], conv[..., dl + n:]

    xh = xc.reshape(bsz, s, hl, pdim)
    dt, a = _step_sizes(dt, w["dt_bias"][heads], w["a_log"][heads])
    st = None if state is None else (
        state if state.shape[1] == hl else state[:, heads])
    y, new_state = _scan(xh, dt, a, bmat, cmat, st, pair=pair)

    def mean_square(g32):
        # The mean of squares over the whole d_inner: each rank's sum,
        # summed; each rank's heads use it, a part of its gradient.
        return all_reduce_local(g32.square().sum(dim=-1, keepdim=True),
                                mesh, split, partial_grad=True) / di
    out = _gated_out(cfg, y, xh, z, w["d_skip"][heads], w["gate_norm"][mine],
                     w["out_proj"][mine], mean_square, x.dtype)
    out = all_reduce_local(out, mesh, split)
    # The new state: this rank's heads of the cache's (B, H, N, P); the
    # new conv window: the x channels of every rank, then B and C.
    xwin = gather_local(new_conv[..., :dl], mesh, split, -1,
                        partial_grad=False)
    return out, (new_state, torch.cat([xwin, new_conv[..., dl:]], dim=-1))


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
