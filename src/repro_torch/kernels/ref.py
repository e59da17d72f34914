"""Plain PyTorch versions of the hand kernels (the correctness ground truth).

Each ``*_ref`` mirrors the semantics of ``repro/kernels/ref.py`` exactly.
On CPU tensors the dispatch in ``ops.py`` runs these; on the card,
``chip_smoke.py`` and the CUDA tests hold each kernel against them.
"""

from __future__ import annotations

import torch


# --- STREAM (paper §5 workloads: copy/scale/add/triad) ---------------------
# The reference's kernels take alpha as an input of a's type
# (``jnp.asarray([alpha], a.dtype)``), so alpha is rounded to that type
# first.  Its float32 triad rounds a + alpha * b once (as one FMA does); its
# bfloat16 triad rounds alpha * b to bfloat16 before the add.

def round_to(alpha, dtype) -> float:
    """``alpha`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(float(alpha), dtype=dtype).item()


def stream_copy_ref(a):
    return a.clone()


def stream_scale_ref(a, alpha):
    return a * round_to(alpha, a.dtype)


def stream_add_ref(a, b):
    return a + b


def stream_triad_ref(a, b, alpha):
    alpha = round_to(alpha, a.dtype)
    if a.dtype == torch.float32:
        return torch.add(a, b, alpha=alpha)     # one rounding, as an FMA
    return a + b * alpha                        # alpha * b rounded first


# --- GQA flash-decode attention --------------------------------------------

def decode_attn_ref(q, k, v, length):
    """q: (B, Hq, D); k/v: (B, S, Hk, D); length: valid prefix length.

    Returns (B, Hq, D): softmax(q k^T / sqrt(D)) v over the valid prefix,
    with GQA head grouping (Hq = G * Hk), in fp32, cast back to q.dtype.
    """
    b, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.reshape(b, hk, g, d)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k.float()) * (d ** -0.5)
    mask = torch.arange(s, device=q.device)[None, None, None, :] < length
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attn_partials_ref(q, k, v, length):
    """The softmax terms of ``decode_attn_ref``'s valid keys, before they
    are normalized (the partial build's plain version).

    q: (B, Hq, D); k/v: (B, S, Hk, D); length in [0, S].  Returns float32
    m (B, Hq), the largest scaled score of the keys ``[0, length)``, or
    -1e30 if there is none; l (B, Hq), the sum of exp(score - m); acc (B,
    Hq, D), the sum of exp(score - m) v.  ``acc / l`` is
    ``decode_attn_ref``'s output before its cast.
    """
    b, hq, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.reshape(b, hk, g, d)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k.float()) * (d ** -0.5)
    mask = torch.arange(s, device=q.device)[None, None, None, :] < length
    logits = torch.where(mask, logits, -1e30)
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return (m.reshape(b, hq), p.sum(dim=-1).reshape(b, hq),
            acc.reshape(b, hq, d))


# --- RWKV6 WKV recurrence ---------------------------------------------------

def wkv_ref(r, k, v, w, u, state, state_out=None):
    """r/k/v/w: (B, T, H, D); u: (H, D); state: (B, H, D, D) fp32.

    y_t = r_t . (S_{t-1} + u * k_t^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    Returns (y (B, T, H, D) fp32, final state (B, H, D, D) fp32).  The
    final state is copied into ``state_out`` when given (which may be
    ``state`` itself), as the kernel writes it.
    """
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        a = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,H,D,D) outer
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + uu * a))
        s = s * w[:, t, :, :, None] + a
    if state_out is not None:
        s = state_out.copy_(s)
    return torch.stack(ys, dim=1), s


def wkv_bwd_ref(r, k, v, w, u, state, dy, ds_t=None):
    """The backward of ``wkv_ref`` (K3b's plain version), in fp32.

    r/k/v: (B, T, H, D); w, dy: (B, T, H, D) fp32; u: (H, D); state:
    (B, H, D, D) fp32, the forward's initial state; ds_t: the gradient of
    its final state, or None (zero).  The states are recomputed forward and
    kept, then the step's gradients are taken walking back; with dS the
    gradient of the state after step t:
      dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t),  dk_t = dS v_t + u r_t (v_t . dy_t),
      dv_t = k_t dS + dy_t (r_t . u k_t),  dw_t = rowsum(dS * S_{t-1}),
      du += r_t k_t (v_t . dy_t),  dS <- diag(w_t) dS + r_t^T dy_t.
    Returns (dr, dk, dv in r's type, dw fp32, du (H, D) fp32, ds0 fp32).
    """
    dtype = r.dtype
    r, k, v, w, dy = (t.float() for t in (r, k, v, w, dy))
    uu = u.float()
    s = state.float()
    states = []
    for t in range(r.shape[1]):
        states.append(s)
        s = s * w[:, t, :, :, None] + k[:, t, :, :, None] * v[:, t, :, None, :]
    ds = torch.zeros_like(s) if ds_t is None else ds_t.float()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(uu)
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (r, k, v, w, dy))
        vdy = (vt * dyt).sum(-1, keepdim=True)                # (B, H, 1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", states[t], dyt) + \
            uu * kt * vdy
        dk[:, t] = torch.einsum("bhij,bhj->bhi", ds, vt) + uu * rt * vdy
        dv[:, t] = torch.einsum("bhi,bhij->bhj", kt, ds) + \
            dyt * (rt * uu * kt).sum(-1, keepdim=True)
        dw[:, t] = (ds * states[t]).sum(-1)
        du = du + (rt * kt * vdy).sum(0)
        ds = ds * wt[..., None] + rt[..., None] * dyt[..., None, :]
    return dr.to(dtype), dk.to(dtype), dv.to(dtype), dw, du, ds


# --- memsim stage B: the timestep backlog scan and the Lindley scan ---------
# Per-step loops of torch ops in the order of the reference's scan bodies
# (repro/core/memsim.py ``_ts_chunk_core`` and ``_event_chunk_core``):
# correctly-rounded elementwise float32 arithmetic only, so these equal the
# reference's scans bit for bit on the same inputs.  Both bin each recorded
# latency into ``hist`` ((n, n_bins) int32, accumulated in place) as the
# reference's ``_flat_bins``: ``lat * (1 / 4)`` truncated toward zero and
# clipped to [0, n_bins - 1].  XLA converts float32 to int32 with saturation
# (NaN to 0, +-inf and out-of-range values to the nearest int32), where a
# torch cast on the CPU gives INT_MIN for all of those; clipping in float32
# first, with NaN taken to 0, gives XLA's bins for every latency.

MEMSIM_BIN_SCALE = 0.25       # 1 / memsim.BIN_NS


def _bin_into(hist, lat, rec):
    n, n_bins = hist.shape
    scaled = torch.nan_to_num(lat * MEMSIM_BIN_SCALE, nan=0.0)
    bins = torch.clamp(scaled, 0, n_bins - 1).to(torch.int32)
    lane = torch.arange(n, device=hist.device, dtype=torch.int64)
    flat = (lane * n_bins)[None, :] + bins.to(torch.int64)
    counts = torch.bincount(flat[rec], minlength=n * n_bins)
    hist += counts.reshape(n, n_bins).to(torch.int32)


def ts_scan_ref(terms, carry, switch_u, arrive_u, jitter, svc, harvest_u,
                rec_lo, rec_hi, hist):
    """One chunk of the timestep engine's backlog scan, in place.

    terms: (9, n) float32, rows p_leave, p_enter, rate_hi, rate_lo, bound,
    lat0, h_leave, h_enter, h_scale; carry: (3, n) float32 (backlog,
    in_burst, lent), updated; switch_u/arrive_u/jitter/svc: (C, n) float32;
    harvest_u: (C, n) float32, or None for zeros; step k is recorded iff
    rec_lo <= k < rec_hi and its request was admitted; hist: (n, n_bins)
    int32, accumulated.

    The comparisons that do not depend on the carry (switch and arrival
    draws against their thresholds) and ``svc * h_scale`` are taken for
    the whole chunk first; the loop carries the two 0/1 chains and the
    backlog, whose update keeps the reference's rounding:
    ``max((backlog + arrive * s_eff) - 1, 0)`` with an exact 0/1 arrive.
    The latency ``(backlog + lat0) + jitter`` is formed after the loop
    from the backlog of each step."""
    (p_leave, p_enter, rate_hi, rate_lo, bound, lat0, h_leave, h_enter,
     h_scale) = terms.unbind(0)
    backlog = carry[0].clone()
    burst, lent = carry[1] > 0.5, carry[2] > 0.5
    hu = torch.zeros_like(switch_u) if harvest_u is None else harvest_u
    # The reference's 0/1 selects: leaving burst iff sw < p_leave, entering
    # iff sw < p_enter (a NaN threshold compares false either way).
    stay_burst, enter_burst = ~(switch_u < p_leave), switch_u < p_enter
    stay_lent, enter_lent = ~(hu < h_leave), hu < h_enter
    arrive_hi, arrive_lo = arrive_u < rate_hi, arrive_u < rate_lo
    svc_lent = svc * h_scale
    steps = switch_u.shape[0]
    backlogs = torch.empty_like(jitter)
    arrived = torch.empty(jitter.shape, dtype=torch.bool,
                          device=jitter.device)
    for k in range(steps):
        burst = torch.where(burst, stay_burst[k], enter_burst[k])
        lent = torch.where(lent, stay_lent[k], enter_lent[k])
        arrive = torch.where(burst, arrive_hi[k], arrive_lo[k]) & \
            (backlog <= bound)
        backlogs[k] = backlog
        arrived[k] = arrive
        s_eff = torch.where(lent, svc_lent[k], svc[k])
        backlog = torch.clamp(backlog + arrive.float() * s_eff - 1.0,
                              min=0.0)
    carry.copy_(torch.stack([backlog, burst.float(), lent.float()]))
    rec = torch.zeros_like(arrived)
    lo, hi = max(int(rec_lo), 0), min(int(rec_hi), steps)
    if hi > lo:
        rec[lo:hi] = arrived[lo:hi]
    _bin_into(hist, backlogs + lat0 + jitter, rec)


def event_scan_ref(terms, W, gaps, svc, rec_time, hist):
    """One chunk of the event engine's Lindley scan, in place.

    terms: (2, n) float32, rows bound, lat0; W: (n,) float32 wait carry,
    updated; gaps/svc: (C, n) float32; rec_time: (C, n) bool; hist:
    (n, n_bins) int32, accumulated with the admitted, recorded requests'
    latencies ``wait + lat0``.  ``jnp.maximum(d, 0.0)`` is +0 at d = -0
    (XLA keeps the second operand on a tie), where ``torch.clamp`` keeps
    -0: ``d <= 0 ? 0 : d`` is the reference's max for every d, NaN
    included."""
    bound, lat0 = terms.unbind(0)
    wc = W.clone()
    wq = torch.empty_like(gaps)
    for k in range(gaps.shape[0]):
        d = wc - gaps[k]
        wc = torch.where(d <= 0.0, 0.0, d)
        wq[k] = wc
        wc = wc + torch.where(wc <= bound, svc[k], 0.0)
    W.copy_(wc)
    _bin_into(hist, wq + lat0, rec_time & (wq <= bound))
