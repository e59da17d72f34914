"""Stack assembly for all six families: scan-over-layers + remat + caches.

Port of ``repro/models/transformer.py``.  The reference scans one compiled
layer body over stacked ``(L, ...)`` parameters; here a Python loop walks
the same stacked tensors (``params["layers"][...][i]`` is a view).

Families ported:
  dense  -- pre-RMSNorm GQA + MLP decoder with a KV cache
  vlm    -- the dense body with M-RoPE ((B, S, 3) positions) and vision
            rows: ``vision_embeds @ frontend.proj`` replaces the token
            embedding where ``vision_mask`` is set (qwen2-vl)
  moe    -- pre-RMSNorm GQA + top-k routed experts (``models/moe.py``),
            with the dense family's KV cache
  hybrid -- groups of ``attn_every`` Mamba2 layers (``models/ssm.py``),
            each group followed by one *shared* attention block: every
            group applies the same weights (``shared_attn``) with its own
            KV slice (zamba2)
  ssm    -- RWKV6 time-mix + channel-mix with a recurrent state
  audio  -- encoder-only pre-LayerNorm attention (bidirectional) + GELU
            MLP over ``frames @ frontend.proj`` (hubert); no decode cache.
            Its float32 frames promote a bf16 pass to float32 activations,
            as in the reference, through the same cast as the vision rows.

Training (``forward(..., training=True)``, no cache) wraps each layer (a
hybrid stack: each Mamba layer and each call of the shared block) in
``_maybe_remat``, the reference's ``jax.checkpoint`` policy on
``cfg.remat``: "full" is ``torch.utils.checkpoint`` (non-reentrant), which
keeps a layer's input and recomputes the layer in the backward; "dots"
keeps the plain matrix products (``aten.mm``, the counterpart of
``dots_with_no_batch_dims_saveable``) and recomputes the rest; "none"
keeps everything.  Remat changes memory, not results.  Uncached attention
over more than 256 tokens is ``attention.flash_attention``, at most 256
``reference_attention``, as in the reference.

Caches carry their length as a host int, so the decode loop never waits on
the device for it.
  * dense, vlm, moe: ``{"k", "v": (L, B, S_max, Hk, hd), "len"}``.  Unlike
    the reference, which returns a new cache array from
    ``dynamic_update_slice``, the port writes each step's K/V into the
    cache tensors IN PLACE and returns a new dict holding the same tensors
    and the advanced length.
  * ssm: ``{"tm_shift", "cm_shift": (L, B, D) model dtype, "wkv":
    (L, B, H, hd, hd) fp32, "len"}``.  The reference returns new state
    arrays; the port writes each layer's new states into its cache slices
    IN PLACE (the ``wkv`` kernel writes its final state over its input
    state, which is safe because one block owns one (batch, head) state and
    reads all of it before writing it) and returns a new dict holding the
    same tensors and the advanced length.
  * hybrid: ``{"ssm_state": (L, B, H, N, P) fp32, "conv": (L, B, cw - 1,
    d_inner + 2N) model dtype, "k", "v": (groups, B, S_max, Hk, hd),
    "len"}``.  Each Mamba layer writes its new state and conv window into
    its slices, and each group's shared block its K/V into the group's
    slice, IN PLACE; the pass returns a new dict holding the same tensors
    and the advanced length.
So the input cache holds the new state after the pass: a caller that runs
two passes from one state clones the cache first.

Vision rows (vlm): the reference's ``vision_embeds`` are float32, so the
projected rows are float32 and ``jnp.where`` promotes the whole pass to
float32 activations, each product meeting its bfloat16 weight upcast; the
K/V cache is still written in the model dtype.  The port does the same
through one cast, ``as_dtype``: a layer whose activations are wider than
its weights takes its weights, and its attention the cache's valid
prefix, cast to the activations' dtype (a one-token pass so runs the
decode kernel's float32 build).  A pass without vision rows stays in the
model dtype and casts nothing.

On a mesh (``distributed/context.activation_rules``, a step entered by
``models/model``) the pass runs on this rank's local tensors, its weights
``layout.Block``s, and the reference's hooks stand where it has them: the
residual stream stays laid out by the rules between layers
(``ACTIVATION_AXES``), each layer gathers its FSDP-sharded weights at
their use, and a cache is written where it lies: each rank writes the new
rows that fall in its own slice of the sequence (:func:`_write_rows`).
The attention's projections, the MLP and the rwkv6 blocks multiply on
each rank's local tensors, split as the port chooses
(``distributed/context.column_products``, ``row_product``,
``models/rwkv``), the frontends' products over each model rank's share of
the rows (``context.row_split_product``), and the rwkv6 and hybrid caches
keep their states' heads over ``model`` (``context.cache_heads``).
Without active rules every hook returns its input and a pass is what it
is without them.

``plain_kernels=True`` sends every hand kernel on the pass (the decode
step's ``decode_attn``, every layer's ``wkv`` and, under autograd, its
backward) to its plain version; it exists only to compare the two paths.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.distributed import context
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attn import built as k2_built
from repro_torch.models import attention, layers, moe, rwkv, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Spec

#: Stub modality-frontend feature width (audio frames / vision patches).
FRONTEND_DIM = 512

#: Logical axes of the residual stream, the layer boundaries' constraint.
ACTIVATION_AXES = ("batch", "seq", "embed")

# ---------------------------------------------------------------------------
# Spec assembly.
# ---------------------------------------------------------------------------

def model_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    specs: dict = {
        "embed": layers.embed_specs(cfg),
        "final_norm": Spec((d,), ("embed",), init="zeros"),
    }
    if cfg.embed_inputs or cfg.family == "vlm":
        specs["frontend"] = {
            "proj": Spec((FRONTEND_DIM, d), ("frontend", "embed"))}
    if cfg.family == "hybrid":
        if cfg.n_layers % cfg.attn_every:
            raise ValueError("hybrid: n_layers must divide by attn_every")
        specs["layers"] = {
            "ln1": Spec((cfg.n_layers, d), ("layers", "embed"), init="zeros"),
            "mamba": ssm.ssm_specs(cfg),
        }
        specs["shared_attn"] = {
            "ln1": Spec((d,), ("embed",), init="zeros"),
            "ln2": Spec((d,), ("embed",), init="zeros"),
            "attn": attention.attn_specs(cfg, layered=False),
            "mlp": layers.mlp_specs(cfg, layered=False),
        }
        return specs
    if cfg.family == "audio":
        norms = ("ln1_w", "ln1_b", "ln2_w", "ln2_b")
    else:
        norms = ("ln1", "ln2")
    specs["layers"] = {
        name: Spec((cfg.n_layers, d), ("layers", "embed"), init="zeros")
        for name in norms}
    if cfg.family in ("dense", "vlm"):
        specs["layers"]["attn"] = attention.attn_specs(cfg)
        specs["layers"]["mlp"] = layers.mlp_specs(cfg)
    elif cfg.family == "moe":
        specs["layers"]["attn"] = attention.attn_specs(cfg)
        specs["layers"]["moe"] = moe.moe_specs(cfg)
    elif cfg.family == "audio":
        specs["layers"]["attn"] = attention.attn_specs(cfg)
        specs["layers"]["mlp"] = layers.mlp_specs(cfg)
    else:   # ssm
        specs["layers"]["rwkv"] = rwkv.rwkv_specs(cfg)
    return specs


def layer_params(params_layers: dict, i: int) -> dict:
    """Layer i's slice of the stacked per-layer parameter tree."""
    return {name: (layer_params(sub, i) if isinstance(sub, dict) else sub[i])
            for name, sub in params_layers.items()}


def as_dtype(t, dtype):
    """``t`` (a tensor or a tree of them) cast to ``dtype``; a tensor
    already of it is returned as it is.  The one cast of the vision rows'
    promotion (module note): weights, the embedding rows and the cache
    meet float32 activations as float32."""
    if isinstance(t, dict):
        return {name: as_dtype(sub, dtype) for name, sub in t.items()}
    return t if t.dtype == dtype else t.to(dtype)


def _as_dtype_of(pl: dict, x):
    """A layer's parameters cast to the activations' dtype when those are
    wider (vision rows, audio frames: module note)."""
    _, leaf = next(layers.flatten_tree(pl, is_leaf=layers.is_weight))
    return pl if leaf.dtype == x.dtype else as_dtype(pl, x.dtype)


# ---------------------------------------------------------------------------
# Remat policy.
# ---------------------------------------------------------------------------

def _save_plain_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the products without batch dimensions
    (``x @ W`` runs as ``aten.mm``), recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ModelConfig, fn, training: bool):
    if not training or cfg.remat == "none":
        return fn
    kwargs = {}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_plain_products)
    return lambda *args: _ckpt.checkpoint(fn, *args, use_reentrant=False,
                                          **kwargs)


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, pl, x, positions, causal, kv_cache,
                plain_kernels: bool = False):
    """kv_cache is None (no cache) or (k_cache, v_cache, cache_len) with
    (B, S_max, Hk, hd) caches that this block writes in place.  On a mesh
    the heads are laid out by ``context.head_layout``: each rank attends
    with its own heads, its group's KV head ("group"), or every head
    ("whole"; the output then whole)."""
    q, k, v = attention.qkv_project(cfg, pl["attn"], x, positions)
    how = context.head_layout(cfg.n_heads, cfg.n_kv_heads)
    b, s = x.shape[:2]
    if kv_cache is None:
        # Over split sequences (a ``seq_pair`` rule) the whole sequence's
        # length picks the form, and each part attends to every part's keys.
        pair = context.seq_pair()
        attend = (attention.reference_attention
                  if s * (pair.size if pair else 1) <= 256 else
                  attention.flash_attention)
        if pair is not None:
            attend = attention.over_parts(attend, pair)
        if how == "group":
            g0 = context.group_of(cfg.n_heads, cfg.n_kv_heads)
            k, v = k[:, :, g0:g0 + 1], v[:, :, g0:g0 + 1]
        o = attend(q, k, v, causal=causal)
    else:
        o, how = _cached_attention(cfg, q, k, v, kv_cache, how,
                                   plain_kernels)
    # Each rank's heads' pending sum all-reduced into the residual stream.
    return context.row_product(o.reshape(b, s, -1), pl["attn"]["wo"],
                               whole_features=how == "whole")


def _cached_attention(cfg, q, k, v, kv_cache, how, plain_kernels):
    """The new rows ``q, k, v`` (laid out by ``how``) written into the
    cache and attended against it -> (output, how its heads are laid out).

    On a mesh the cache is this rank's block: its rows, and its slice of
    the sequence where the cache is channelized (the sequence split over
    ``model``); the new K/V rows go, whole over the heads, into the slice
    that holds their positions.  A channelized cache is read where it
    lies: each rank attends every query head to its own keys and the
    ranks' softmax terms merge (``layout.KeySlice``); ranks that hold the
    rows whole (batch 1) take shares of its KV heads.  A cache whose heads
    are whole on every model rank: the decode step runs K2 on each rank's
    query heads against their group's KV head where they lie inside one
    group and K2 is built for it, else every head on every rank; a block
    of rows attends each rank's heads to their KV heads."""
    k_cache, v_cache, cache_len = kv_cache
    b, s = q.shape[:2]
    keys, idle = context.cache_keys("k", k_cache.shape[1], cfg.n_kv_heads)
    if k.shape[2] != cfg.n_kv_heads:
        # The cache holds every KV head on every model rank.
        k, v = (context.whole_heads(t, 2) for t in (k, v))
    offset = 0 if keys is None else keys.offset
    _write_rows(k_cache, k, cache_len, offset)
    _write_rows(v_cache, v, cache_len, offset)
    if q.dtype != k_cache.dtype:
        # float32 queries (vision rows) meet the model dtype's cache
        # upcast, as the reference's einsum does: its valid prefix.
        valid = max(0, min(k_cache.shape[1], cache_len + s - offset))
        k_cache, v_cache = (as_dtype(c[:, :valid], q.dtype)
                            for c in (k_cache, v_cache))
    group = cfg.n_heads // cfg.n_kv_heads
    mesh_heads = context.model_dim(cfg.n_heads) is not None
    if keys is None and how != "whole" and mesh_heads and (
            s > 1 or plain_kernels or (
                group % q.shape[2] == 0 and k2_built(q.shape[-1],
                                                     q.shape[2]))):
        # This rank's query heads against their KV heads: its group's, or
        # its own whole groups.
        if group % q.shape[2] == 0:
            g0 = context.group_of(cfg.n_heads, cfg.n_kv_heads)
            heads = slice(g0, g0 + 1)
        else:
            mine = q.shape[2] // group
            index = context.model_index()
            heads = slice(index * mine, (index + 1) * mine)
        k_cache, v_cache = (c[:, :, heads] for c in (k_cache, v_cache))
    else:
        if q.shape[2] != cfg.n_heads:
            q = context.whole_heads(q, 2)
        how = "whole"
    if idle:
        # This idle rank's share of the KV heads and their query heads.
        index, n = context.index_over(idle)
        hk = cfg.n_kv_heads // n
        q = q[:, :, index * hk * group:(index + 1) * hk * group]
        k_cache, v_cache = (c[:, :, index * hk:(index + 1) * hk]
                            for c in (k_cache, v_cache))
    if s == 1 and not plain_kernels:
        # The decode step: the hand kernel on the card, which reads a
        # contiguous cache (a copy of a slice of its heads).
        o = ops.decode_attn(q[:, 0], k_cache.contiguous(),
                            v_cache.contiguous(), cache_len + 1,
                            keys)[:, None]
    else:
        lens = torch.full((b,), cache_len + s, dtype=torch.int32,
                          device=q.device)
        o = attention.decode_attention(q, k_cache, v_cache, lens,
                                       q_start=cache_len, keys=keys)
    if idle:
        o = context.gather_over(o, idle, 2)
    return o, how


def _write_rows(cache, new, start: int, offset: int = 0):
    """Write ``new`` (B, s, Hk, hd) into ``cache`` (B, S, Hk, hd), which
    holds the positions from ``offset`` on (this rank's slice of a
    sequence split over ranks), at positions ``start`` on: the rows that
    fall in the slice."""
    lo = max(start, offset)
    hi = min(start + new.shape[1], offset + cache.shape[1])
    if lo < hi:
        cache[:, lo - offset:hi - offset] = \
            new[:, lo - start:hi - start].to(cache.dtype)


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


def _audio_body(cfg, x, pl, positions, causal, kv_cache,
                plain_kernels: bool = False):
    h = layers.layer_norm(x, pl["ln1_w"], pl["ln1_b"], cfg.norm_eps)
    x = x + _attn_block(cfg, pl, h, positions, False, None, plain_kernels)
    h = layers.layer_norm(x, pl["ln2_w"], pl["ln2_b"], cfg.norm_eps)
    return x + layers.mlp_apply(cfg, pl["mlp"], h)


def _mamba_body(cfg, x, pl, cache):
    """cache is None or (state, conv_state); returns (x, (new_state,
    new_conv_state))."""
    state, conv = cache if cache is not None else (None, None)
    h = layers.rms_norm(x, pl["ln1"], cfg.norm_eps)
    y, new = ssm.mamba_apply(cfg, pl["mamba"], h, state, conv)
    return x + y, new


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


def _embed_inputs(cfg: ModelConfig, params, batch):
    # The frontends' products: on a mesh each model rank its share of the
    # rows (context.row_split_product).
    if cfg.family == "audio":
        frames, proj = batch["frames"], params["frontend"]["proj"]
        dtype = torch.promote_types(frames.dtype, proj.dtype)
        return context.row_split_product(as_dtype(frames, dtype),
                                         as_dtype(proj, dtype))
    x = layers.embed_apply(cfg, params["embed"], batch["tokens"])
    if cfg.family == "vlm" and "vision_embeds" in batch:
        rows = batch["vision_embeds"]
        dtype = torch.promote_types(rows.dtype, x.dtype)
        proj = context.row_split_product(
            as_dtype(rows, dtype), as_dtype(params["frontend"]["proj"],
                                            dtype))
        x = torch.where(batch["vision_mask"][..., None], proj,
                        as_dtype(x, dtype))
    return x


def forward(cfg: ModelConfig, params, batch, *, training: bool = False,
            cache: Optional[dict] = None, plain_kernels: bool = False):
    """Full forward pass -> (hidden (B,S,D), new_cache_or_None).

    ``batch`` keys: tokens (B,S) [or, audio, frames (B,S,FRONTEND_DIM)]
    and positions (B,S) [or (B,S,3) for M-RoPE], tensors on the
    parameters' device; for vlm, optionally vision_embeds
    (B,S,FRONTEND_DIM) and vision_mask (B,S) bool.  When ``cache`` is
    given the pass is an incremental decode/prefill continuation that
    writes the cache in place (see the module note).  ``training`` applies
    ``cfg.remat`` to each layer of an uncached pass.  ``plain_kernels``
    sends every hand kernel on the pass to its plain version; it exists
    only to compare the two paths.
    """
    x = _embed_inputs(cfg, params, batch)
    if cfg.family == "ssm":
        x, new_cache = _rwkv_stack(cfg, params, x, cache, plain_kernels,
                                   training)
    elif cfg.family == "hybrid":
        x, new_cache = _hybrid_stack(cfg, params, x, batch["positions"],
                                     cache, plain_kernels, training)
    else:
        x, new_cache = _dense_stack(cfg, params, x, batch["positions"],
                                    cache, plain_kernels, training)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_cache


def _dense_stack(cfg, params, x, positions, cache, plain_kernels,
                 training=False):
    """The dense, vlm, moe and audio families: attention (with a KV cache,
    but for audio), then the family's feed-forward body.  A layer whose
    weights are narrower than the activations (vision rows, audio frames:
    module note) takes them cast, inside its remat region."""
    body = {"moe": _moe_body, "audio": _audio_body}.get(cfg.family,
                                                       _dense_body)
    causal = not cfg.encoder_only
    if cache is None:
        def layer(xx, pl):
            return body(cfg, xx, _as_dtype_of(pl, xx), positions, causal,
                        None, plain_kernels)
        layer = _maybe_remat(cfg, layer, training)
        for i in range(cfg.n_layers):
            x = layer(context.constrain(x, ACTIVATION_AXES),
                      layer_params(params["layers"], i))
        return x, None
    cache_len = cache["len"]
    for i in range(cfg.n_layers):
        pl = _as_dtype_of(layer_params(params["layers"], i), x)
        kv = (cache["k"][i], cache["v"][i], cache_len)
        x = body(cfg, x, pl, positions, causal, kv, plain_kernels)
    return x, dict(k=cache["k"], v=cache["v"], len=cache_len + x.shape[1])


def _hybrid_stack(cfg, params, x, positions, cache, plain_kernels,
                  training=False):
    """Zamba2-style: ``n_layers / attn_every`` groups, each of
    ``attn_every`` Mamba layers followed by the shared attention block
    (the same weights every group; each group its own KV slice).  Without
    a cache the Mamba layers start from no state (the conv padded with
    zeros); with one, each continues from its slices and writes its new
    state and conv window back into them."""
    per = cfg.attn_every
    shared = params["shared_attn"]
    if cache is None:
        mamba = _maybe_remat(
            cfg, lambda xx, pl: _mamba_body(cfg, xx, pl, None)[0], training)
        block = _maybe_remat(cfg, lambda xx, sp: _dense_body(
            cfg, xx, sp, positions, True, None, plain_kernels), training)
        for g in range(cfg.n_layers // per):
            for i in range(g * per, (g + 1) * per):
                x = mamba(context.constrain(x, ACTIVATION_AXES),
                          layer_params(params["layers"], i))
            x = block(x, shared)
        return x, None
    cache_len = cache["len"]
    # On a mesh each layer writes its model rank's heads of the state.
    states = context.cache_heads("ssm_state", cache["ssm_state"],
                                 cfg.ssm_heads)
    for g in range(cfg.n_layers // per):
        for i in range(g * per, (g + 1) * per):
            pl = layer_params(params["layers"], i)
            st = (states[i], cache["conv"][i])
            x, (new_state, new_conv) = _mamba_body(cfg, x, pl, st)
            states[i].copy_(new_state)
            cache["conv"][i].copy_(new_conv)
        kv = (cache["k"][g], cache["v"][g], cache_len)
        x = _dense_body(cfg, x, shared, positions, True, kv, plain_kernels)
    return x, dict(cache, ssm_state=states, len=cache_len + x.shape[1])


def _rwkv_stack(cfg, params, x, cache, plain_kernels, training=False):
    """Without a cache each layer starts from a zero state (the reference's
    uncached path); with one, from its slice, and writes its new states
    back into that slice."""
    if cache is None:
        zero = rwkv.init_rwkv_cache(cfg, x.shape[0], x.dtype, x.device)
        layer = _maybe_remat(cfg, lambda xx, pl: _rwkv_body(
            cfg, xx, pl, zero, plain_kernels)[0], training)
        for i in range(cfg.n_layers):
            x = layer(x, layer_params(params["layers"], i))
        return x, None
    # On a mesh each layer writes its model rank's heads of the WKV state.
    states = context.cache_heads("wkv", cache["wkv"], cfg.rwkv_heads)
    for i in range(cfg.n_layers):
        pl = layer_params(params["layers"], i)
        cl = (cache["tm_shift"][i], states[i], cache["cm_shift"][i])
        x, _ = _rwkv_body(cfg, x, pl, cl, plain_kernels, in_place=True)
    return x, dict(cache, wkv=states, len=cache["len"] + x.shape[1])


# ---------------------------------------------------------------------------
# Cache construction.
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> dict:
    """Zeroed decode cache sized for ``max_len`` tokens of context."""
    if cfg.family == "audio":
        raise ValueError(f"{cfg.family} has no decode cache")
    if cfg.family == "ssm":
        tm, wkv, cm = (torch.stack([a] * cfg.n_layers) for a in
                       rwkv.init_rwkv_cache(cfg, batch, dtype, device))
        return dict(tm_shift=tm, wkv=wkv, cm_shift=cm, len=0)
    # dense, vlm and moe: a KV cache a layer; hybrid: one a group, beside
    # every Mamba layer's state and conv window.
    kv_slices = cfg.n_layers
    states = {}
    if cfg.family == "hybrid":
        kv_slices = cfg.n_layers // cfg.attn_every
        state, conv = ssm.init_ssm_cache(cfg, batch, dtype, device)
        states = dict(ssm_state=torch.stack([state] * cfg.n_layers),
                      conv=torch.stack([conv] * cfg.n_layers))
    shape = (kv_slices, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return dict(**states, k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device), len=0)
