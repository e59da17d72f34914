"""AdamW with fp32 master weights, global-norm clipping and LR schedules.

Port of ``repro/optim/adamw.py``.  The optimizer state mirrors the
parameter tree: an fp32 master copy and the first and second moments.
The update keeps the reference's arithmetic: clip by the global norm of
the gradients, moments with bias corrections from ``step + 1``, weight
decay added to the update *before* the learning rate multiplies it, and
the parameters rounded from the master copy.  It is not
``torch.optim.AdamW`` (which decays the weights apart from the update).

Unlike the reference, which returns new trees, ``update`` writes the new
master, moments and parameters into the tensors of ``state`` and
``params`` and returns those same trees: one copy of the train state
lives on the card (26 GB for rwkv6-1.6b), not two.  Every operation is
elementwise, so the values are the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.layout import all_reduce_local
from repro_torch.models.layers import map_tree, tree_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to min_lr_ratio (float32, as the
    reference); ``step`` an integer tensor or int."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params):
    """Optimizer state: fp32 master copy + first/second moments."""
    f32 = lambda p: p.detach().to(torch.float32, copy=True)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return dict(master=map_tree(f32, params), mu=map_tree(zeros, params),
                nu=map_tree(zeros, params))


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in the reference's order.  Leaves that are DTensors (gradients
    on a mesh) are summed on their local shards, and the sums of the
    leaves split over the same mesh dimensions are all-reduced over those
    at once (``distributed/layout``): the norm, whole on every rank, as a
    plain tensor."""
    leaves = tree_leaves(tree)
    if not any(isinstance(l, DTensor) for l in leaves):
        return torch.sqrt(sum(l.float().square().sum() for l in leaves))
    mesh, by_split = leaves[0].device_mesh, {}
    for l in leaves:
        dims = tuple(i for i, p in enumerate(l.placements)
                     if p.is_shard() and mesh.size(i) > 1)
        part = l.to_local().float().square().sum()
        by_split[dims] = by_split[dims] + part if dims in by_split else part
    return torch.sqrt(sum(all_reduce_local(part, mesh, dims)
                          for dims, part in by_split.items()))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, step, params,
           param_dtype=torch.bfloat16):
    """One AdamW step -> (params, state, metrics).  ``step`` is the 0-dim
    integer step tensor of the train state.  The state's tensors and
    ``params`` (rounded from the master copy to ``param_dtype``) are
    written in place (module note)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = torch.as_tensor(step).float() + 1.0
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def one(g, m, mu, nu):
        g = g.float() * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g.square())
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * m
        m.copy_(m - lr * upd)

    map_tree(one, grads, state["master"], state["mu"], state["nu"])
    map_tree(lambda p, m: p.copy_(m.to(param_dtype)), params,
             state["master"])
    return params, state, dict(grad_norm=gnorm, lr=lr)
