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
