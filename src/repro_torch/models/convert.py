"""Carry the reference's parameters into the port.

``params_from_jax`` takes the parameter pytree of ``repro``'s
``Model.init`` as numpy arrays (nested dicts, stacked ``layers/*`` leaves
included) and returns the port's parameter tree: the same keys, shapes and
``(d_in, d_out)`` layouts (a moe layer's experts as ``(E, d_in, d_out)``),
as tensors on ``device``, for every ported family.  Tests use it to run
both packages on identical weights.  ``train_state_from_jax`` carries the
reference's train state (``distributed/step.init_train_state``: params,
``opt.{master,mu,nu}``, ``step`` and, with compression, ``ef``) the same
way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DTYPES, resolve_device


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda",
                    dtype=None) -> dict:
    """The parameter tree as tensors of ``dtype`` (default the model's)."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype] if dtype is None else dtype
    specs = dict(layers.flatten_tree(transformer.model_specs(cfg)))
    leaves = dict(layers.flatten_tree(
        tree, is_leaf=lambda x: not isinstance(x, dict)))
    if leaves.keys() != specs.keys():
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {sorted(specs.keys() - leaves.keys())}, "
                         f"unexpected {sorted(leaves.keys() - specs.keys())}")
    out = []
    for path, arr in leaves.items():
        arr = np.array(arr, dtype=np.float32)
        if arr.shape != specs[path].shape:
            raise ValueError(f"{path}: shape {arr.shape}, want "
                             f"{specs[path].shape}")
        out.append((path, torch.from_numpy(arr).to(device=device,
                                                    dtype=dtype)))
    return layers.unflatten_tree(out)


def train_state_from_jax(cfg: ModelConfig, state: dict, device="cuda") -> dict:
    """The reference's train state (numpy leaves) as the port's: params in
    the model dtype, the optimizer's trees and ``ef`` in float32, ``step``
    a 0-dim int32 tensor."""
    f32 = lambda tree: params_from_jax(cfg, tree, device, torch.float32)
    out = dict(params=params_from_jax(cfg, state["params"], device),
               opt={name: f32(state["opt"][name])
                    for name in ("master", "mu", "nu")},
               step=torch.tensor(int(state["step"]), dtype=torch.int32,
                                 device=resolve_device(device)))
    if "ef" in state:
        out["ef"] = f32(state["ef"])
    return out
