"""Stack assembly for the ported families: scan-over-layers + caches.

Port of ``repro/models/transformer.py``.  The reference scans one compiled
layer body over stacked ``(L, ...)`` parameters; here a Python loop walks
the same stacked tensors (``params["layers"][...][i]`` is a view).

Families ported:
  dense -- pre-RMSNorm GQA + MLP decoder with a KV cache
  moe   -- pre-RMSNorm GQA + top-k routed experts (``models/moe.py``),
           with the dense family's KV cache
  ssm   -- RWKV6 time-mix + channel-mix with a recurrent state
The others (hybrid, audio, vlm) are not ported yet.

Caches carry their length as a host int, so the decode loop never waits on
the device for it.
  * dense, moe: ``{"k", "v": (L, B, S_max, Hk, hd), "len"}``.  Unlike the
    reference, which returns a new cache array from
    ``dynamic_update_slice``, the port writes each step's K/V into the
    cache tensors IN PLACE and returns a new dict holding the same tensors
    and the advanced length.
  * ssm: ``{"tm_shift", "cm_shift": (L, B, D) model dtype, "wkv":
    (L, B, H, hd, hd) fp32, "len"}``.  The reference returns new state
    arrays; the port writes each layer's new states into its cache slices
    IN PLACE (the ``wkv`` kernel writes its final state over its input
    state, which is safe because one block owns one (batch, head) state and
    reads all of it before writing it) and returns a new dict holding the
    same tensors and the advanced length.  So the input cache holds the
    new state after the pass: a caller that runs two passes from one state
    clones the cache first.

``plain_kernels=True`` sends every hand kernel on the pass (the dense and
moe decode step's ``decode_attn``, every layer's ``wkv``) to its plain
version; it exists only to compare the two paths.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention, layers, moe, rwkv
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Spec

#: Stub modality-frontend feature width (audio frames / vision patches).
FRONTEND_DIM = 512

PORTED_FAMILIES = ("dense", "moe", "ssm")


def check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to "
            f"repro_torch yet (ported: {', '.join(PORTED_FAMILIES)})")


# ---------------------------------------------------------------------------
# Spec assembly.
# ---------------------------------------------------------------------------

def model_specs(cfg: ModelConfig) -> dict:
    check_ported(cfg)
    d = cfg.d_model
    specs = {
        "embed": layers.embed_specs(cfg),
        "final_norm": Spec((d,), ("embed",), init="zeros"),
        "layers": {
            "ln1": Spec((cfg.n_layers, d), ("layers", "embed"), init="zeros"),
            "ln2": Spec((cfg.n_layers, d), ("layers", "embed"), init="zeros"),
        },
    }
    if cfg.family == "dense":
        specs["layers"]["attn"] = attention.attn_specs(cfg)
        specs["layers"]["mlp"] = layers.mlp_specs(cfg)
    elif cfg.family == "moe":
        specs["layers"]["attn"] = attention.attn_specs(cfg)
        specs["layers"]["moe"] = moe.moe_specs(cfg)
    else:   # ssm
        specs["layers"]["rwkv"] = rwkv.rwkv_specs(cfg)
    return specs


def layer_params(params_layers: dict, i: int) -> dict:
    """Layer i's slice of the stacked per-layer parameter tree."""
    return {name: (layer_params(sub, i) if isinstance(sub, dict) else sub[i])
            for name, sub in params_layers.items()}


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, pl, x, positions, causal, kv_cache,
                plain_kernels: bool = False):
    """kv_cache is None (no cache) or (k_cache, v_cache, cache_len) with
    (B, S_max, Hk, hd) caches that this block writes in place."""
    q, k, v = attention.qkv_project(cfg, pl["attn"], x, positions)
    b, s = x.shape[:2]
    if kv_cache is None:
        if s > 256:
            raise NotImplementedError(
                "uncached attention over more than 256 tokens uses the "
                "reference's flash_attention (training path), not ported")
        o = attention.reference_attention(q, k, v, causal=causal)
    else:
        k_cache, v_cache, cache_len = kv_cache
        k_cache[:, cache_len:cache_len + s] = k
        v_cache[:, cache_len:cache_len + s] = v
        if s == 1 and not plain_kernels:
            # The decode step: the hand kernel on the card.
            o = ops.decode_attn(q[:, 0], k_cache, v_cache,
                                cache_len + 1)[:, None]
        else:
            lens = torch.full((b,), cache_len + s, dtype=torch.int32,
                              device=x.device)
            o = attention.decode_attention(q, k_cache, v_cache, lens,
                                           q_start=cache_len)
    return o.reshape(b, s, -1) @ pl["attn"]["wo"]


def _dense_body(cfg, x, pl, positions, causal, kv_cache,
                plain_kernels: bool = False):
    h = layers.rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + _attn_block(cfg, pl, h, positions, causal, kv_cache,
                        plain_kernels)
    h = layers.rms_norm(x, pl["ln2"], cfg.norm_eps)
    return x + layers.mlp_apply(cfg, pl["mlp"], h)


def _moe_body(cfg, x, pl, positions, causal, kv_cache,
              plain_kernels: bool = False):
    h = layers.rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + _attn_block(cfg, pl, h, positions, causal, kv_cache,
                        plain_kernels)
    h = layers.rms_norm(x, pl["ln2"], cfg.norm_eps)
    return x + moe.moe_apply(cfg, pl["moe"], h)


def _rwkv_body(cfg, x, pl, cache, plain_kernels: bool = False,
               in_place: bool = False):
    """cache is (tm_shift, wkv_state, cm_shift); with ``in_place`` the
    new states are written into those tensors."""
    tm_shift, wkv_state, cm_shift = cache
    h = layers.rms_norm(x, pl["ln1"], cfg.norm_eps)
    y, (new_tm, new_wkv) = rwkv.time_mix(
        cfg, pl["rwkv"], h, tm_shift, wkv_state, plain_kernels,
        state_out=wkv_state if in_place else None)
    x = x + y
    h = layers.rms_norm(x, pl["ln2"], cfg.norm_eps)
    y, new_cm = rwkv.channel_mix(cfg, pl["rwkv"], h, cm_shift)
    x = x + y
    if in_place:
        new_tm, new_cm = tm_shift.copy_(new_tm), cm_shift.copy_(new_cm)
    return x, (new_tm, new_wkv, new_cm)


def forward(cfg: ModelConfig, params, batch, *,
            cache: Optional[dict] = None, plain_kernels: bool = False):
    """Full forward pass -> (hidden (B,S,D), new_cache_or_None).

    ``batch`` keys: tokens (B,S) and positions (B,S), integer tensors on
    the parameters' device.  When ``cache`` is given the pass is an
    incremental decode/prefill continuation that writes the cache in
    place (see the module note).  ``plain_kernels`` sends every hand
    kernel on the pass to its plain version; it exists only to compare the
    two paths.
    """
    check_ported(cfg)
    x = layers.embed_apply(cfg, params["embed"], batch["tokens"])
    if cfg.family == "ssm":
        x, new_cache = _rwkv_stack(cfg, params, x, cache, plain_kernels)
    else:
        x, new_cache = _dense_stack(cfg, params, x, batch["positions"],
                                    cache, plain_kernels)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_cache


def _dense_stack(cfg, params, x, positions, cache, plain_kernels):
    """The dense and moe families: attention with a KV cache, then the
    family's feed-forward body."""
    body = _moe_body if cfg.family == "moe" else _dense_body
    causal = not cfg.encoder_only
    new_cache = None
    if cache is not None:
        cache_len = cache["len"]
        new_cache = dict(k=cache["k"], v=cache["v"],
                         len=cache_len + x.shape[1])
    for i in range(cfg.n_layers):
        pl = layer_params(params["layers"], i)
        kv = None if cache is None else (cache["k"][i], cache["v"][i],
                                         cache_len)
        x = body(cfg, x, pl, positions, causal, kv, plain_kernels)
    return x, new_cache


def _rwkv_stack(cfg, params, x, cache, plain_kernels):
    """Without a cache each layer starts from a zero state (the reference's
    uncached path); with one, from its slice, and writes its new states
    back into that slice."""
    if cache is None:
        zero = rwkv.init_rwkv_cache(cfg, x.shape[0], x.dtype, x.device)
    for i in range(cfg.n_layers):
        pl = layer_params(params["layers"], i)
        cl = zero if cache is None else (
            cache["tm_shift"][i], cache["wkv"][i], cache["cm_shift"][i])
        x, _ = _rwkv_body(cfg, x, pl, cl, plain_kernels,
                          in_place=cache is not None)
    if cache is None:
        return x, None
    return x, dict(cache, len=cache["len"] + x.shape[1])


# ---------------------------------------------------------------------------
# Cache construction.
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> dict:
    """Zeroed decode cache sized for ``max_len`` tokens of context."""
    check_ported(cfg)
    if cfg.family == "ssm":
        tm, wkv, cm = (torch.stack([a] * cfg.n_layers) for a in
                       rwkv.init_rwkv_cache(cfg, batch, dtype, device))
        return dict(tm_shift=tm, wkv=wkv, cm_shift=cm, len=0)
    # dense and moe: a KV cache.
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device), len=0)
