"""Stack assembly, dense family: pre-RMSNorm GQA + MLP decoder with a KV cache.

Port of ``repro/models/transformer.py``.  The reference scans one compiled
layer body over stacked ``(L, ...)`` parameters; here a Python loop walks
the same stacked tensors (``params["layers"][...][i]`` is a view).  The
other families (moe, ssm, hybrid, audio, vlm) are not ported yet.

The cache is ``{"k", "v": (L, B, S_max, Hk, hd), "len": int}``.  Unlike the
reference, which returns a new cache array from ``dynamic_update_slice``,
the port writes each step's K/V into the cache tensors IN PLACE and
returns a new dict holding the same tensors and the advanced length.  The
length is a host int, so the decode loop never waits on the device for it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Spec

#: Stub modality-frontend feature width (audio frames / vision patches).
FRONTEND_DIM = 512

PORTED_FAMILIES = ("dense",)


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
    return {
        "embed": layers.embed_specs(cfg),
        "final_norm": Spec((d,), ("embed",), init="zeros"),
        "layers": {
            "ln1": Spec((cfg.n_layers, d), ("layers", "embed"), init="zeros"),
            "ln2": Spec((cfg.n_layers, d), ("layers", "embed"), init="zeros"),
            "attn": attention.attn_specs(cfg),
            "mlp": layers.mlp_specs(cfg),
        },
    }


def layer_params(params_layers: dict, i: int) -> dict:
    """Layer i's slice of the stacked per-layer parameter tree."""
    return {name: (layer_params(sub, i) if isinstance(sub, dict) else sub[i])
            for name, sub in params_layers.items()}


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, pl, x, positions, causal, kv_cache,
                plain_decode: bool = False):
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
        if s == 1 and not plain_decode:
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
                plain_decode: bool = False):
    h = layers.rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + _attn_block(cfg, pl, h, positions, causal, kv_cache,
                        plain_decode)
    h = layers.rms_norm(x, pl["ln2"], cfg.norm_eps)
    return x + layers.mlp_apply(cfg, pl["mlp"], h)


def forward(cfg: ModelConfig, params, batch, *,
            cache: Optional[dict] = None, plain_decode: bool = False):
    """Full forward pass -> (hidden (B,S,D), new_cache_or_None).

    ``batch`` keys: tokens (B,S) and positions (B,S), integer tensors on
    the parameters' device.  When ``cache`` is given the pass is an
    incremental decode/prefill continuation that writes the cache in
    place.  ``plain_decode`` sends a one-token step through the plain
    ``decode_attention`` instead of the kernel; it exists only to compare
    the two paths.
    """
    check_ported(cfg)
    x = layers.embed_apply(cfg, params["embed"], batch["tokens"])
    positions = batch["positions"]
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
        x = _dense_body(cfg, x, pl, positions, causal, kv, plain_decode)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_cache


# ---------------------------------------------------------------------------
# Cache construction.
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> dict:
    """Zeroed decode cache sized for ``max_len`` tokens of context."""
    check_ported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device), len=0)
