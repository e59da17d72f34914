"""Shared building blocks: param specs, norms, positions, MLPs, embeddings.

Port of ``repro/models/layers.py``.  Parameters are declared as
:class:`Spec` trees (shape + logical axes + init law); ``init_params``
materializes them deterministically on an explicit device: each leaf draws
from its own ``torch.Generator``, seeded from the crc32 of the run's seed
and the leaf's tree path, so adding a module never reshuffles another
module's init.  The draws differ from the reference's threefry streams;
tests carry the reference's parameters across with ``convert.params_from_jax``.

Matrices keep the reference's ``(d_in, d_out)`` layout, applied as ``x @ W``.
The reference's sharding hooks (``distributed/context``) stand where the
reference has them; they return their input unless a launcher activates
rules and the tensors are DTensors.  ``logical_axes`` returns the axes
tree that ``distributed/sharding`` maps onto a mesh.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import context
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Param specs.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple
    axes: tuple                  # logical axis names, len == len(shape)
    init: str = "normal"         # normal | zeros | ones
    scale: float = 1.0           # stddev multiplier on top of fan-in scaling

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def flatten_tree(tree: dict, is_leaf=is_spec, prefix: str = ""):
    """Yield (path, leaf) of a nested dict in key order; paths join keys
    by '/'."""
    for name, sub in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if is_leaf(sub):
            yield path, sub
        else:
            yield from flatten_tree(sub, is_leaf, path)


def unflatten_tree(items) -> dict:
    """Inverse of ``flatten_tree``: (path, leaf) pairs -> nested dict."""
    out: dict = {}
    for path, leaf in items:
        *parents, name = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def map_tree(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` applied leaf by leaf to nested dicts of one structure (the
    first tree's keys), as ``jax.tree_util.tree_map``."""
    return {name: (map_tree(fn, sub, *(r[name] for r in rest))
                   if isinstance(sub, dict) else
                   fn(sub, *(r[name] for r in rest)))
            for name, sub in tree.items()}


def tree_leaves(tree: dict, is_leaf=torch.is_tensor) -> list:
    """The leaves in ``jax.tree_util.tree_leaves``'s order (keys sorted at
    every level; '/' sorts below every character a key uses, so sorted
    paths give that order)."""
    return [leaf for _, leaf in sorted(flatten_tree(tree, is_leaf),
                                       key=lambda item: item[0])]


def _leaf_generator(seed: int, path: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    # The CPU generator keeps only 32 bits of its seed: fold both in there.
    gen.manual_seed(zlib.crc32(f"{seed}/{path}".encode()))
    return gen


def _materialize(spec: Spec, seed: int, path: str, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / max(fan_in, 1) ** 0.5
    x = torch.randn(spec.shape, dtype=torch.float32, device=device,
                    generator=_leaf_generator(seed, path, device))
    return (x * std).to(dtype)


def init_params(spec_tree, seed: int, dtype, device):
    """Materialize a Spec tree into tensors on ``device`` (path-seeded)."""
    return unflatten_tree(
        (path, _materialize(spec, seed, path, dtype, device))
        for path, spec in flatten_tree(spec_tree))


def logical_axes(spec_tree):
    return map_tree(lambda s: s.axes, spec_tree)


def shapes(spec_tree):
    return map_tree(lambda s: s.shape, spec_tree)


def param_count(spec_tree) -> int:
    total = 0
    for _, s in flatten_tree(spec_tree):
        n = 1
        for d in s.shape:
            n *= d
        total += n
    return total


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float):
    """RMSNorm in fp32, scaled by ``1 + w`` (zero-initialized weights)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(dtype)


def layer_norm(x, w, b, eps: float):
    """LayerNorm in fp32 (population variance), scaled by ``1 + w`` and
    shifted by ``b`` (both zero-initialized)."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float()) + b.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary positions.
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / theta ** exps


def _rotate(x, cos, sin):
    """Rotate the two halves of the last axis (not interleaved pairs)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(q, k, positions, head_dim: int, theta: float,
               mrope_sections: Optional[tuple] = None):
    """Rotary embedding.

    q: (B, S, Hq, D), k: (B, S, Hk, D).
    positions: (B, S) integer, or (B, S, 3) for M-RoPE (t, h, w component
    positions per token, qwen2-vl style: the frequency spectrum is split
    into ``mrope_sections`` groups, each rotated by its own position).
    """
    inv = rope_freqs(head_dim, theta, device=q.device)      # (half,)
    if mrope_sections is None:
        angles = positions.float()[..., None] * inv         # (B, S, half)
    else:
        if positions.dim() != 3 or positions.shape[-1] != len(
                mrope_sections):
            raise ValueError(f"M-RoPE wants (B, S, {len(mrope_sections)}) "
                             f"positions, got {tuple(positions.shape)}")
        # The static section -> component table: frequency i turns by
        # the position of component sec[i].
        sec = torch.tensor([i for i, n in enumerate(mrope_sections)
                            for _ in range(n)], device=q.device)
        angles = positions.float()[..., sec] * inv          # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :].to(q.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(q.dtype)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, layered: bool = True) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    ls, la = ((cfg.n_layers,), ("layers",)) if layered else ((), ())
    if cfg.activation == "swiglu":
        return {
            "wi": Spec(ls + (d, f), la + ("embed", "mlp")),
            "wg": Spec(ls + (d, f), la + ("embed", "mlp")),
            "wo": Spec(ls + (f, d), la + ("mlp", "embed")),
        }
    return {
        "wi": Spec(ls + (d, f), la + ("embed", "mlp")),
        "wo": Spec(ls + (f, d), la + ("mlp", "embed")),
    }


MLP_USE_SPECS = {"wi": (None, "model"), "wg": (None, "model"),
                 "wo": ("model", None)}


def mlp_apply(cfg: ModelConfig, p: dict, x):
    p = context.use_params(p, MLP_USE_SPECS)
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif cfg.activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(x @ p["wi"], approximate="tanh")
    elif cfg.activation == "relu2":
        h = F.relu(x @ p["wi"]).square()
    else:
        raise ValueError(cfg.activation)
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding with sequence-chunked cross-entropy.
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    out = {"tokens": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["head"] = Spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return out


def embed_apply(cfg: ModelConfig, p: dict, token_ids):
    # A sharded table is gathered whole first: DTensor's lookup into a
    # vocab-sharded table leaves a masked partial sum that its later
    # reduction mis-shapes.
    p = context.gather_params(p, {"tokens": (None, None)})
    return F.embedding(token_ids, p["tokens"])


def unembed_matrix(cfg: ModelConfig, p: dict):
    if cfg.tie_embeddings:
        return p["tokens"].T
    return p["head"]


def chunked_ce_loss(h, w_head, targets, mask, chunk: int = 1024):
    """Next-token CE over (B, S, D) hidden states, seq-chunked.

    The reference's rule: ``n = max(S // chunk, 1)`` chunks of ``S // n``
    tokens, so at most (B, chunk, V) logits are live at once in the
    forward.  Logits in float32 after the product in the model dtype;
    the loss is the mean over ``mask`` (0/1) positions, in float32.
    """
    b, s, d = h.shape
    n = max(s // chunk, 1)
    chunk = s // n
    h_c = h.reshape(b, n, chunk, d)
    t_c = targets.reshape(b, n, chunk).long()
    m_c = mask.reshape(b, n, chunk)
    nll = cnt = 0.0
    for i in range(n):
        logits = (h_c[:, i] @ w_head).float()                 # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, t_c[:, i, :, None])[..., 0]
        nll = nll + ((lse - tgt) * m_c[:, i]).sum()
        cnt = cnt + m_c[:, i].sum()
    return nll / torch.clamp(cnt, min=1.0)
