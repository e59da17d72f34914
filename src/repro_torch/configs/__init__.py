"""Architecture registry: ``get_config(arch_id)`` + the assigned shape grid.

All ten assigned architectures are selectable by id (``--arch <id>``); each
is paired with the four assigned input shapes.  ``cells()`` enumerates the
(arch x shape) grid with per-cell applicability (encoder-only archs have no
decode step; 500k decode requires a sub-quadratic family), exactly as
DESIGN.md §5 documents.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, smoke_variant

_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "starcoder2-3b": "starcoder2_3b",
    "mistral-large-123b": "mistral_large_123b",
    "stablelm-3b": "stablelm_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = (
    Shape("train_4k", 4096, 256, "train"),
    Shape("prefill_32k", 32768, 32, "prefill"),
    Shape("decode_32k", 32768, 128, "decode"),
    Shape("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> Shape:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_status(cfg: ModelConfig, shape: Shape) -> str:
    """'ok' or a skip reason for one (arch x shape) cell."""
    if shape.kind == "decode":
        if not cfg.has_decode:
            return "skip: encoder-only arch has no decode step"
        if shape.seq_len >= 500_000 and not cfg.sub_quadratic:
            return ("skip: 500k decode needs sub-quadratic attention "
                    "(full-attention arch, per assignment)")
    return "ok"


def cells():
    """Yield (arch_id, config, shape, status) for the full 40-cell grid."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            yield arch, cfg, shape, cell_status(cfg, shape)
