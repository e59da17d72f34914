"""Attention: GQA projections, the O(S^2) oracle, chunked (flash-style)
uncached attention and cache attention.

Port of ``repro/models/attention.py``.  Tensors keep the reference's
``(B, S, H, D)`` layout.  On a mesh the projections are each rank's
columns (``context.column_products``), laid out by
``context.head_layout``, and a cache whose sequence is split over
``model`` (the channelized cache) is read where it lies:
``decode_attention`` with ``keys`` (a prefill into it) scores each rank's
own keys and merges the ranks' (max, sum, acc) terms with the two
all-reduces of ``kernels/ops.merge_partials``, the channelized read of
the reference.  The one-token decode step on such a cache runs K2's
partial build on each rank's keys and merges the same way
(``kernels/ops.decode_attn``).

``flash_attention`` is the uncached pass over more than 256 tokens (the
training path, hubert's every pass): an online softmax over KV chunks, so
no S x S score tensor forms.  Over sequences split into parts
(``over_parts``) each part's queries attend to every part's keys,
gathered over the ranks that hold them.  ``decode_attention`` is the plain einsum form.  It serves prefill (a block
of new tokens with ``q_start``) and is the plain version of the one-token
decode step, whose hot path is the hand kernel behind
``repro_torch.kernels.ops.decode_attn``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import context
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Spec, apply_rope

NEG_INF = -1e30


def attn_specs(cfg: ModelConfig, layered: bool = True,
               n_layers: Optional[int] = None) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    nl = cfg.n_layers if n_layers is None else n_layers
    ls, la = ((nl,), ("layers",)) if layered else ((), ())
    return {
        "wq": Spec(ls + (d, nq * hd), la + ("embed", "heads")),
        "wk": Spec(ls + (d, nkv * hd), la + ("embed", "kv_heads")),
        "wv": Spec(ls + (d, nkv * hd), la + ("embed", "kv_heads")),
        "wo": Spec(ls + (nq * hd, d), la + ("heads", "embed")),
    }


def qkv_project(cfg: ModelConfig, p: dict, x, positions):
    """x: (B, S, D) -> q (B, S, Hq, hd), k/v (B, S, Hk, hd), roped.  On a
    mesh each rank's heads as ``context.head_layout`` lays them out: its
    own (each rank whole KV groups), its own query heads and every KV head
    ("group": each rank uses its group's), or every head ("whole")."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = context.column_products(x, p["wq"], p["wk"], p["wv"])
    how = context.head_layout(cfg.n_heads, cfg.n_kv_heads)
    if how != "local":
        kv = cfg.n_kv_heads * hd
        if how == "whole":
            q = context.whole_columns(q, cfg.n_heads * hd, False)
        elif context.model_split(p["wk"], -1) is None:
            raise ValueError("grouped heads: KV heads computed whole on "
                             "every model rank are not built")
        # "group": each rank uses its group's KV head, a part of the whole.
        k, v = (context.whole_columns(t, kv, how == "group") for t in (k, v))
    heads = lambda t: t.reshape(b, s, -1, hd)
    q, k = apply_rope(heads(q), heads(k), positions, hd, cfg.rope_theta,
                      cfg.mrope_sections)
    return q, k, heads(v)


def _expand_kv(k, groups: int):
    """(B, S, Hk, D) -> (B, S, Hk*groups, D) by repeating each KV head."""
    return torch.repeat_interleave(k, groups, dim=2)


def reference_attention(q, k, v, causal: bool = True, q_start=None):
    """O(S^2) oracle used by tests and tiny models.  (B,S,H,D) layout.
    Query i sits at key position ``q_start + i`` for the causal mask
    (``q_start`` None: the queries are the last ``Sq`` of the keys)."""
    groups = q.shape[2] // k.shape[2]
    k, v = _expand_kv(k, groups), _expand_kv(v, groups)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(
            diagonal=sk - sq if q_start is None else q_start)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(q, k, v, causal: bool = True, chunk: int = 512,
                    q_start=None):
    """Online-softmax attention over KV chunks.  (B,S,H,D) layout.

    The reference's ``lax.scan`` over ``S / chunk`` KV blocks, as a Python
    loop of torch ops (two steps at 1,024 tokens): the same running max,
    denominator and float32 accumulator, the same roundings (q * scale and
    the probabilities in q's dtype), the same fallback to one chunk when
    ``chunk`` does not divide the keys, and the causal mask offset by
    ``sk - sq`` (or query i at key position ``q_start + i``).  Autograd
    differentiates it, as JAX does the scan.
    """
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    groups = hq // k.shape[2]
    if sk % chunk:
        chunk = sk  # fall back for odd sizes (smoke tests)
    scale = d ** -0.5
    q_scaled = (q * scale).to(q.dtype)
    q_pos = torch.arange(sq, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    for idx in range(sk // chunk):
        kc = _expand_kv(k[:, idx * chunk:(idx + 1) * chunk], groups)
        vc = _expand_kv(v[:, idx * chunk:(idx + 1) * chunk], groups)
        logits = torch.einsum("bqhd,bkhd->bhqk", q_scaled, kc).float()
        if causal:
            k_pos = idx * chunk + torch.arange(chunk, device=q.device)
            mask = q_pos[:, None] + (sk - sq if q_start is None
                                     else q_start) >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        correction = torch.exp(m - m_new)
        denom = denom * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vc.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                 # (B, S, H, D)


def over_parts(attend, pair):
    """``attend`` (:func:`reference_attention` or :func:`flash_attention`)
    for queries that are half ``pair.index`` of sequences split in halves
    over ``pair`` (``layout.SeqPair``): both halves' keys and values
    gathered, in order, and the causal mask at the queries' own positions.
    Each half's rank so computes its queries' share of the whole
    sequence's attention, as one device does for them."""
    def attend_part(q, k, v, causal=True):
        return attend(q, pair.gather(k, 1), pair.gather(v, 1), causal=causal,
                      q_start=pair.index * q.shape[1])
    return attend_part


def decode_attention(q, k_cache, v_cache, cache_len, q_start=None,
                     keys=None):
    """Attention of new tokens against a KV cache (decode or prefill).

    q: (B, Sq, Hq, D); k/v_cache: (B, S_max, Hk, D); cache_len: (B,) valid
    lengths AFTER the new tokens were written (entries at key positions
    >= cache_len are masked out).  ``q_start`` (int) is the absolute
    position of q's first token; when given, causality *within* the new
    block is enforced: query i attends keys at positions <= q_start + i.

    ``keys`` (a ``layout.KeySlice``): the cache is this rank's slice of the
    sequence, from position ``keys.offset``: the rank scores its own keys
    and the ranks' (max, sum, acc) terms are merged by two all-reduces
    (``ops.merge_partials``) instead of one softmax.
    """
    b, sq, hq, d = q.shape
    hk = k_cache.shape[2]
    groups = hq // hk
    scale = d ** -0.5
    # GQA-native grouped einsum: each KV head against its G query heads,
    # no repeated copy of the cache.  Like the reference, q * scale is
    # rounded to q.dtype before the product.
    qg = (q * scale).reshape(b, sq, hk, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache).float()
    offset = 0 if keys is None else keys.offset
    k_pos = offset + torch.arange(k_cache.shape[1], device=q.device)
    mask = k_pos[None, :] < cache_len[:, None]              # (B, Sk)
    mask = mask[:, None, None, None, :]                     # (B,1,1,1,Sk)
    if q_start is not None:
        q_pos = q_start + torch.arange(sq, device=q.device)  # (Sq,)
        causal = k_pos[None, :] <= q_pos[:, None]           # (Sq, Sk)
        mask = mask & causal[None, None, None, :, :]
    logits = torch.where(mask, logits, NEG_INF)
    if keys is None:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        del logits
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache)
        return out.reshape(b, sq, hq, d)                     # (B,Sq,Hq,D)
    # This rank's terms of its keys; a slice wholly past the valid keys
    # adds exp(NEG_INF - max) = 0 of them.
    m = logits.amax(dim=-1)                                 # (B,Hk,G,Sq)
    p = torch.exp(logits - m[..., None])
    del logits
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v_cache.float())
    out = ops.merge_partials(m, p.sum(dim=-1), acc, q.dtype,
                             lambda x: keys.reduce(x, "max"),
                             lambda x: keys.reduce(x, "sum"))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
