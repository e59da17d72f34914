"""Production mesh construction for H100 clusters.

Port of ``repro/launch/mesh.py``.  Defined as functions (never
module-level constants), so that importing this module touches no
process group: a mesh needs ``torch.distributed`` initialised first, by a
launcher with a real world (NCCL over the cards, gloo on the CPU) or by
``launch/dryrun`` with a fake one.

Mesh shapes (the reference's chip counts):
  single pod:  (32, 8)    axes ("data", "model")         -- 256 GPUs
  multi pod:   (2, 32, 8) axes ("pod", "data", "model")  -- 512 GPUs

``model`` is one HGX H100 board: 8 GPUs joined all to all by NVLink 4
(900 GB/s a GPU in both directions together, data sheet), the largest group in which every pair talks at NVLink
rate.  Tensor and expert parallelism and the channelized KV sequence
exchange activations or softmax partials at every layer, so they stay on
it.  ``data`` (x ``pod``) crosses the network between boards (one 400
Gb/s InfiniBand NDR port a GPU, 50 GB/s a direction) and carries only batch and FSDP traffic: gradient
reduce-scatters and per-layer parameter all-gathers, which overlap with
compute and tolerate the higher latency.  The reference's TPU mesh is 16
x 16 because a TPU slice's torus is one interconnect domain; an H100
cluster's fast domain is 8 wide, so the same 256 chips are 32 x 8 here.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

PRODUCTION_SHAPE = (32, 8)
MULTI_POD_SHAPE = (2, 32, 8)


def make_production_mesh(*, multi_pod: bool = False):
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """A ("data", "model") mesh over the process group's whole world
    (``model_axis`` ranks a model group, 1 when it does not divide)."""
    n = dist.get_world_size()
    if n % model_axis:
        model_axis = 1
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
