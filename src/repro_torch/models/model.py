"""Public model API: init / loss / prefill / decode_step / greedy_generate.

Port of ``repro/models/model.py`` for all six families (the audio
family, encoder-only, has ``loss`` and no decode path).  Every entry point
runs on an explicit device: ``cuda`` unless the caller asks for ``cpu``.
Asking for ``cuda`` where there is no card raises; the model never carries
on on the CPU.

Under ``distributed/context``'s rules an entry point takes DTensor
parameters, batch and cache and runs on this rank's blocks of them
(``context.enter``); it hands back DTensors (``context.leave``,
``leave_cache``): the loss whole on every rank, the logits with their rows
and vocabulary split as the head's, the cache as it came (its states'
heads over ``model`` where the blocks split them).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import context
from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward, init_cache

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "card; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: str | torch.device = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.dtype]

    # -- parameters ---------------------------------------------------------
    def specs(self):
        return transformer.model_specs(self.cfg)

    def init(self, seed: int):
        return layers.init_params(self.specs(), seed, self.dtype,
                                  self.device)

    def logical_axes(self):
        return layers.logical_axes(self.specs())

    def param_count(self) -> int:
        return layers.param_count(self.specs())

    # -- training -----------------------------------------------------------
    def loss(self, params, batch, plain_kernels: bool = False):
        """Mean next-token (or masked-prediction) CE -> (loss, metrics).

        The reference's metrics are ``{"loss": loss}`` (no auxiliary
        loss).  ``batch`` as the pipeline makes it (numpy or tensors);
        ``plain_kernels`` as in ``prefill``, for path comparison."""
        cfg = self.cfg
        params, batch, _ = context.enter(params, self._to_batch(batch))
        h, _ = forward(cfg, params, batch, training=True,
                       plain_kernels=plain_kernels)
        h = context.constrain(h, transformer.ACTIVATION_AXES)
        # On a mesh the head's vocabulary stays split: chunked_ce_loss
        # scores each rank's own columns.
        w_head = transformer.as_dtype(
            layers.unembed_matrix(cfg, params["embed"]), h.dtype)
        loss = context.leave(layers.chunked_ce_loss(
            h, w_head, batch["targets"], batch["loss_mask"].float()))
        return loss, {"loss": loss}

    # -- serving ------------------------------------------------------------
    def _to_batch(self, batch: dict) -> dict:
        """Move a batch of numpy arrays or tensors to this model's device
        (DTensors stay where their mesh put them)."""
        return {k: v if isinstance(v, DTensor) else
                torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def make_cache(self, batch_size: int, max_len: int):
        return init_cache(self.cfg, batch_size, max_len, self.dtype,
                          self.device)

    def _serve(self, params, batch, cache, plain_kernels):
        """(last-position logits, cache) of a pass from ``cache``; on a
        mesh each rank scores its own vocabulary columns."""
        params, batch, cache = context.enter(params, self._to_batch(batch),
                                             cache)
        h, cache = forward(self.cfg, params, batch, cache=cache,
                           plain_kernels=plain_kernels)
        w_head = transformer.as_dtype(
            layers.unembed_matrix(self.cfg, params["embed"]), h.dtype)
        logits = context.column_product(h[:, -1, :], w_head).float()
        return (context.leave(logits, context.column_layout(w_head)),
                context.leave_cache(cache))

    def prefill(self, params, batch, cache, plain_kernels: bool = False):
        """Run a prompt through the model from ``cache``, which is written
        in place (``transformer``'s module note says how).

        Returns (last-position logits (B, V), cache).  ``plain_kernels``
        swaps every hand kernel of the pass for its plain version (path
        comparison only)."""
        return self._serve(params, batch, cache, plain_kernels)

    def decode_step(self, params, step_batch, cache,
                    plain_kernels: bool = False):
        """One-token decode: step_batch holds (B, 1) tokens + positions.

        Returns (logits (B, V), new cache).  ``plain_kernels`` as in
        ``prefill``."""
        return self._serve(params, step_batch, cache, plain_kernels)

    def greedy_generate(self, params, batch, cache, steps: int):
        """Greedy decoding: prefill, then ``steps`` one-token decode steps.

        Returns (tokens (B, steps) int32 on the device, cache)."""
        logits, cache = self.prefill(params, batch, cache)
        tok = logits.argmax(dim=-1).to(torch.int32)
        toks = []
        for _ in range(steps):
            pos = torch.full((tok.shape[0], 1), cache["len"],
                             dtype=torch.int32, device=self.device)
            if self.cfg.mrope_sections:
                pos = pos[..., None].expand(-1, -1, 3)   # (B, 1, 3)
            sb = dict(tokens=tok[:, None], positions=pos)
            logits, cache = self.decode_step(params, sb, cache)
            tok = logits.argmax(dim=-1).to(torch.int32)
            toks.append(tok)
        if not toks:
            return torch.empty((tok.shape[0], 0), dtype=torch.int32,
                               device=self.device), cache
        return torch.stack(toks, dim=1), cache


# ---------------------------------------------------------------------------
# Batch construction helpers (shared by the data pipeline and the dry run).
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """One training batch of this architecture as ``meta`` tensors (shapes
    and dtypes, no storage): the reference's ShapeDtypeStructs."""
    i32 = torch.int32
    specs = {}
    if cfg.family == "audio":
        specs["frames"] = _meta((batch, seq, transformer.FRONTEND_DIM),
                                DTYPES[cfg.dtype])
    else:
        specs["tokens"] = _meta((batch, seq), i32)
    if cfg.mrope_sections:
        specs["positions"] = _meta((batch, seq, 3), i32)
    else:
        specs["positions"] = _meta((batch, seq), i32)
    if cfg.family == "vlm":
        specs["vision_embeds"] = _meta(
            (batch, seq, transformer.FRONTEND_DIM), DTYPES[cfg.dtype])
        specs["vision_mask"] = _meta((batch, seq), torch.bool)
    specs["targets"] = _meta((batch, seq), i32)
    specs["loss_mask"] = _meta((batch, seq), i32)
    return specs


def decode_batch_spec(cfg: ModelConfig, batch: int) -> dict:
    """A one-token decode step's batch as ``meta`` tensors."""
    i32 = torch.int32
    specs = {"tokens": _meta((batch, 1), i32)}
    if cfg.mrope_sections:
        specs["positions"] = _meta((batch, 1, 3), i32)
    else:
        specs["positions"] = _meta((batch, 1), i32)
    return specs
