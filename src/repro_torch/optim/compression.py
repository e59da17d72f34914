"""Int8 error-feedback gradient compression.

Port of ``repro/optim/compression.py``: each gradient leaf plus its
error-feedback buffer is quantized to int8 with one per-tensor scale
(round half to even, as ``jnp.round``); the quantization error is carried
to the next step.  On one card there is no reduction to make cheaper, so
the step applies compress-then-decompress exactly as the reference's
train step does, with the same codes.

    comp, ef = compress(grads, ef)        # quantize + error feedback
    grads = decompress(comp)
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import flatten_tree, map_tree


def init_error_feedback(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_one(g, ef):
    g = g.float() + ef
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    err = g - q.float() * scale
    return (q, scale), err


def compress(grads, error_feedback):
    """-> (tree of (int8 codes, scale), new error feedback)."""
    pairs = map_tree(_quantize_one, grads, error_feedback)
    comp = map_tree(lambda pair: pair[0], pairs)
    new_ef = map_tree(lambda pair: pair[1], pairs)
    return comp, new_ef


def decompress(comp):
    return map_tree(lambda leaf: leaf[0].float() * leaf[1], comp)


def compressed_bytes(comp) -> int:
    return sum(q.numel() for _, (q, _) in flatten_tree(
        comp, is_leaf=lambda x: isinstance(x, tuple)))
