"""Train and serve step factories.

Port of ``repro/distributed/step.py``: ``make_train_step`` wires the loss
and its gradients (``torch.autograd``) -> optional int8 error-feedback
gradient compression -> AdamW, with gradient accumulation over
``microbatch`` slices of the batch in float32, as the reference's.
``make_serve_step`` is the one-token decode step the ``decode_*`` /
``long_*`` dry-run cells run, and ``make_prefill`` the prompt pass.  The
reference compiles them under ``pjit`` with shardings from the rules; the
port's steps are plain functions that take whatever their caller hands
them: tensors on one card, or DTensors laid out by
``distributed/sharding`` on a mesh (``launch/dryrun``, ``chip_smoke.py``).
On a mesh the model runs on each rank's local blocks
(``distributed/context``) and the gradients come back as DTensors laid
out as their parameters; AdamW updates them there, pointwise work on
equal layouts.

The step writes the new parameters and optimizer state into the tensors
of the state it is given (``optim/adamw``'s note) and returns the state.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.layout import wrap
from repro_torch.models.layers import (flatten_tree, map_tree,
                                       unflatten_tree)
from repro_torch.models.model import DTYPES, Model
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import AdamWConfig


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = AdamWConfig()
    compress_grads: bool = False
    param_dtype: str = "bfloat16"
    #: gradient-accumulation microbatches per step (1 = off); divides the
    #: activation working set by the same factor.
    microbatch: int = 1


def init_train_state(model: Model, seed: int, step_cfg: TrainStepConfig):
    params = model.init(seed)
    state = dict(params=params, opt=adamw.init(params),
                 step=torch.zeros((), dtype=torch.int32, device=model.device))
    if step_cfg.compress_grads:
        state["ef"] = compression.init_error_feedback(params)
    return state


def train_state_specs(model: Model, step_cfg: TrainStepConfig):
    """The train state's shapes and dtypes, allocating nothing: a tree of
    tensors on the ``meta`` device (a ``ckpt.restore`` template)."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device="meta")
    specs = model.specs()
    leaf = lambda x: not isinstance(x, dict)
    tree = lambda dtype: unflatten_tree(
        (path, meta(spec.shape, dtype))
        for path, spec in flatten_tree(specs, leaf))
    state = dict(params=tree(model.dtype),
                 opt=dict(master=tree(torch.float32),
                          mu=tree(torch.float32), nu=tree(torch.float32)),
                 step=meta((), torch.int32))
    if step_cfg.compress_grads:
        state["ef"] = tree(torch.float32)
    return state


def _zeros_like(p):
    """Zeros laid out as ``p`` (a DTensor's built from its local shard)."""
    if isinstance(p, DTensor):
        return wrap(torch.zeros_like(p.to_local()), p.device_mesh,
                    p.placements, p.shape)
    return torch.zeros_like(p)


def _grads(loss, params):
    """d loss / d params as a tree; a leaf the loss does not reach (hubert's
    token embedding) gets zeros, as JAX's gradient does.  A loss whole on
    every rank of a mesh (a DTensor) is differentiated from its local
    value, which every rank holds."""
    paths, leaves = zip(*flatten_tree(params, torch.is_tensor))
    if isinstance(loss, DTensor):
        loss = loss.to_local()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return unflatten_tree(
        (path, _zeros_like(p) if g is None else g)
        for path, p, g in zip(paths, leaves, grads))


def make_train_step(model: Model, step_cfg: TrainStepConfig):
    """-> train_step(state, batch) -> (state, metrics).  ``batch`` as the
    pipeline makes it; ``metrics`` (loss, grad_norm, lr) are 0-dim tensors
    on the device."""
    param_dtype = DTYPES[step_cfg.param_dtype]

    def train_step(state, batch):
        params = state["params"]
        for _, p in flatten_tree(params, torch.is_tensor):
            p.requires_grad_(True)
        if step_cfg.microbatch > 1:
            m = step_cfg.microbatch
            rows = len(next(iter(batch.values()))) // m
            grads = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses = []
            for i in range(m):
                mb = {k: x[i * rows:(i + 1) * rows] for k, x in batch.items()}
                loss, _ = model.loss(params, mb)
                grads = map_tree(lambda a, g: a + g.float() / m, grads,
                                 _grads(loss, params))
                losses.append(loss.detach())
            metrics = {"loss": torch.stack(losses).mean()}
        else:
            loss, metrics = model.loss(params, batch)
            grads = _grads(loss, params)
            metrics = {"loss": loss.detach()}
        if step_cfg.compress_grads:
            # Quantize (with error feedback) as the reference does before
            # its data-parallel reduction.
            comp, new_ef = compression.compress(grads, state["ef"])
            grads = compression.decompress(comp)
        del loss
        params, opt, opt_metrics = adamw.update(
            step_cfg.opt, grads, state["opt"], state["step"], params,
            param_dtype=param_dtype)
        for _, p in flatten_tree(params, torch.is_tensor):
            p.requires_grad_(False)
        new_state = dict(params=params, opt=opt, step=state["step"] + 1)
        if step_cfg.compress_grads:
            new_state["ef"] = new_ef
        return new_state, {**metrics, **opt_metrics}

    return train_step


def make_serve_step(model: Model):
    def serve_step(params, step_batch, cache):
        return model.decode_step(params, step_batch, cache)

    return serve_step


def make_prefill(model: Model):
    def prefill(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill
