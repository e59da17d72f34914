"""Shared building blocks: param specs, norms, positions, MLPs, embeddings.

Port of ``repro/models/layers.py``.  Parameters are declared as
:class:`Spec` trees (shape + logical axes + init law); ``init_params``
materializes them deterministically on an explicit device: each leaf draws
from its own ``torch.Generator``, seeded from the crc32 of the run's seed
and the leaf's tree path, so adding a module never reshuffles another
module's init.  The draws differ from the reference's threefry streams;
tests carry the reference's parameters across with ``convert.params_from_jax``.

Matrices keep the reference's ``(d_in, d_out)`` layout, applied as ``x @ W``.
On a mesh (``distributed/context``'s rules, a step entered) a layer's
weights are ``layout.Block``s, gathered at their use, and its activations
this rank's local tensors; without active rules the hooks return their
input.  ``logical_axes`` returns the axes tree that
``distributed/sharding`` maps onto a mesh.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import context
from repro_torch.distributed.layout import (Block, all_reduce_local,
                                            pending_local, shard_start,
                                            whole_block)
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


def is_weight(x) -> bool:
    """A parameter leaf: a tensor, or on a mesh a ``layout.Block``."""
    return torch.is_tensor(x) or isinstance(x, Block)


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
    w = context.whole(w)
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(dtype)


def layer_norm(x, w, b, eps: float):
    """LayerNorm in fp32 (population variance), scaled by ``1 + w`` and
    shifted by ``b`` (both zero-initialized)."""
    w, b = context.whole(w), context.whole(b)
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


def mlp_apply(cfg: ModelConfig, p: dict, x):
    # On a mesh each rank computes its columns of wi and wg and its rows of
    # wo, whose pending sum is all-reduced into the residual stream's layout
    # (context.column_products, row_product).
    if cfg.activation == "swiglu":
        gate, up = context.column_products(x, p["wg"], p["wi"])
        h = F.silu(gate) * up
    elif cfg.activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(context.column_product(x, p["wi"]), approximate="tanh")
    elif cfg.activation == "relu2":
        h = F.relu(context.column_product(x, p["wi"])).square()
    else:
        raise ValueError(cfg.activation)
    return context.row_product(h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding with sequence-chunked cross-entropy.
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    out = {"tokens": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["head"] = Spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return out


def embed_apply(cfg: ModelConfig, p: dict, token_ids):
    """Token rows of the embedding table.  On a mesh a table whose
    vocabulary is split over ranks (the rules' ``vocab`` over ``model``)
    is looked up in place: each rank takes the rows it holds and zeros
    elsewhere, and one all-reduce over those ranks sums them; the gradient
    reaches each rank's own rows only.  The table is never gathered
    whole."""
    table = p["tokens"]
    f = context.frame()
    if f is None or not isinstance(table, Block):
        return F.embedding(token_ids, table)
    vdims = table.split(0)
    # The table's embed dimension gathered (the FSDP gather at use), its
    # vocabulary kept split; each rank's rows' lookups a part of its
    # gradient.
    rows = whole_block(table, f.rows, keep=vdims)
    if not vdims:
        return F.embedding(token_ids, rows)
    local = token_ids.long() - shard_start(table, 0)
    held = (local >= 0) & (local < rows.shape[0])
    emb = F.embedding(torch.where(held, local, 0), rows)
    return all_reduce_local(emb.masked_fill(~held[..., None], 0), f.mesh,
                            vdims)


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

    On a mesh each rank takes its own rows, and a head whose vocabulary is
    split over ranks (the rules' ``vocab`` over ``model``) is used in
    place: each rank scores each chunk against its own columns, and three
    all-reduces over those ranks give the row max, the sum of
    exponentials and the target logit (from the one rank that holds it);
    the loss is log(sum) + max - target (:func:`vocab_parallel_nll`).
    Autograd gives softmax - one-hot on the local columns.  The head is
    never gathered whole.  The ranks' sums over their rows are summed at
    the end.
    """
    f = context.frame()
    vdims = w_head.split(1) if isinstance(w_head, Block) else []
    if f is not None:
        # Each rank scores its own columns of the head (its gradient of h a
        # part of the whole), its own rows (its gradient of the head's).
        h = pending_local(h, f.mesh, vdims)
        lo = shard_start(w_head, 1) if vdims else 0
        w_head = whole_block(w_head, f.rows, keep=vdims)
    b, s, d = h.shape
    n = max(s // chunk, 1)
    chunk = s // n
    h_c = h.reshape(b, n, chunk, d)
    t_c = targets.reshape(b, n, chunk).long()
    m_c = mask.reshape(b, n, chunk)
    over = lambda op: lambda x: all_reduce_local(x, f.mesh, vdims, op)
    nll = cnt = 0.0
    for i in range(n):
        logits = (h_c[:, i] @ w_head).float()          # (B, c, V / ranks)
        if vdims:
            row_nll = vocab_parallel_nll(logits, t_c[:, i], lo, over("max"),
                                         over("sum"))
        else:
            row_nll = torch.logsumexp(logits, dim=-1) - logits.gather(
                -1, t_c[:, i, :, None])[..., 0]
        nll = nll + (row_nll * m_c[:, i]).sum()
        cnt = cnt + m_c[:, i].sum()
    return context.sum_rows(nll) / torch.clamp(context.sum_rows(cnt),
                                               min=1.0)


def vocab_parallel_nll(logits, targets, lo, max_all, sum_all):
    """-log softmax(logits)[target] of rows whose vocabulary is split into
    slices: ``logits`` (..., V_slice) float32 scores of one slice, whose
    first column is vocabulary entry ``lo``; ``targets`` (...) global
    ids.  ``max_all`` and ``sum_all`` reduce a row's terms over the
    slices (all-reduces over the ranks that hold them, or reductions over
    a leading axis of slices stacked in one process; ``max_all`` may keep
    that axis).  The row max is a constant of the loss (no gradient); the
    target's score comes from the one slice that holds it.  Returns
    log(sum exp(logits - max)) + max - target, whose gradient is softmax -
    one-hot on each slice's columns."""
    big = max_all(logits.detach().amax(dim=-1))
    total = sum_all(torch.exp(logits - big[..., None]).sum(dim=-1))
    t = targets - lo
    held = (t >= 0) & (t < logits.shape[-1])
    tgt = logits.gather(-1, torch.where(held, t, 0)[..., None])[..., 0]
    tgt = sum_all(torch.where(held, tgt, 0.0))
    return torch.log(total) + big - tgt
