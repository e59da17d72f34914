"""The multi-device layer on local tensors (``distributed/context``,
``distributed/layout``), on the CPU.

On a mesh every op of the models runs on a rank's local tensors; DTensor
is only the container a step is handed and hands back.  So DTensor's op
dispatcher, where its sharding propagation runs, must see no op of a
model:

* the 4-rank gloo world of ``tests/torch_mesh_worker.py`` (its
  ``local_layout_job``) runs each of the six families at smoke width on a
  (2, 2) mesh: ``Model.loss`` and its backward under ``train_rules``, and
  a prefill and one decode step under ``decode_rules`` with a channelized
  cache, with DTensor's dispatcher watched; no op reaches it but the
  accumulation of a parameter's gradients laid out alike;
* two dry-run cells on the production (32, 8) mesh of a fake world, their
  depth cut (zamba2-2.7b ``train_4k`` at one group of six Mamba layers and
  its shared block, qwen2-vl-72b ``train_4k`` at two layers): the cost
  meter, which marks nothing of DTensor's, counts the FLOPs and the
  collective bytes a chip pinned below, the same on any torch version.
  (zamba2's shared block once took nine more all-reduces of the stream in
  its backward on torch 2.13 than on 2.11, and qwen2-vl's vision rows
  another split, where DTensor propagated them.)
"""

import dataclasses

import pytest
import torch.distributed as dist

import torch_mesh_worker
from repro_torch.configs import get_config, get_shape
from repro_torch.core import hloparse
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

FAMILIES = ["stablelm-1.6b", "olmoe-1b-7b", "rwkv6-1.6b", "zamba2-2.7b",
            "qwen2-vl-72b", "hubert-xlarge"]
CASES = [(arch, phase) for arch in FAMILIES for phase in ("train", "decode")
         if phase == "train" or get_config(arch).has_decode]


@pytest.fixture(scope="module")
def world():
    return torch_mesh_worker.run_world("local_layout", 4,
                                       {"archs": FAMILIES})


@pytest.mark.parametrize("arch,phase", CASES)
def test_no_model_op_reaches_dtensor_propagation(world, arch, phase):
    got = world[arch, phase]
    assert got["finite"]
    assert got["ops"] == []


#: (arch, layers) -> the cell's (FLOPs, collective bytes by kind) a chip
#: on the (32, 8) mesh, ``train_4k``, as the meter reads them on torch 2.13
#: (the CPU) and 2.11 (the card's host).
PINS = {
    ("zamba2-2.7b", 6): (13763759570944.0, {
        "all-gather": 1051454080.0, "all-reduce": 3206121856.0,
        "reduce-scatter": 17046280.0}),
    ("qwen2-vl-72b", 2): (88630945120256.0, {
        "all-gather": 2045919232.0, "all-reduce": 6443106324.0,
        "reduce-scatter": 33442304.0}),
}


@pytest.fixture
def no_world_left():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,layers", sorted(PINS))
def test_cut_cells_count_their_pins(no_world_left, arch, layers):
    flops, coll = PINS[arch, layers]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    dryrun.fake_world(256)
    res = dryrun.CellResult(arch=arch, shape="train_4k", mesh="32x8",
                            status="ok")
    dryrun.run_step(cfg, get_shape("train_4k"), make_production_mesh(), res)
    assert res.flops_per_chip == flops
    assert {k: v for k, v in res.collectives.items()
            if k in hloparse.COLLECTIVES and v} == coll
