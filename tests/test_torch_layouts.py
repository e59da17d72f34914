"""The layouts that split a block's work over a mesh as GSPMD splits the
reference's (``models/moe``, ``models/ssm``, ``distributed/context``,
``kernels/ops``), on the CPU in one process; the 4-rank world's checks of
the same blocks against the reference are in ``test_torch_sharding.py``.

* One device's ranks of each (token, slot) within its expert
  (``moe.slot_ranks``) equal the reference's exclusive cumsum, and a
  token shard's ranks plus the shards before it give the whole batch's.
* On a mesh of one rank, and on plain tensors, the MoE and Mamba2 blocks
  compute the same thing bit for bit (their one-device code).
* Which query layouts keep their split (``context.head_layout``), and
  where K2 takes each rank's group (``ops._grouped_query``): only for a
  group it is built for (``decode_attn.built``, which matches the CUDA
  source's instantiations).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import get_config
from repro_torch.distributed import context
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import moe, smoke_variant, ssm

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("e,n", [(4, 64), (64, 1000), (16, 7)])
def test_slot_ranks_are_the_exclusive_cumsum(e, n):
    eid = np.random.default_rng(e + n).integers(0, e, n)
    flat = np.eye(e, dtype=np.int64)[eid]
    want = ((np.cumsum(flat, 0) - flat) * flat).sum(-1)
    rank, counts = moe.slot_ranks(e, torch.from_numpy(eid))
    np.testing.assert_array_equal(rank.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), flat.sum(0))
    # Two token shards: the second's ranks offset by the first's counts.
    cut = n // 2
    first, c0 = moe.slot_ranks(e, torch.from_numpy(eid[:cut]))
    second, _ = moe.slot_ranks(e, torch.from_numpy(eid[cut:]))
    np.testing.assert_array_equal(
        np.concatenate([first.numpy(),
                        (second + c0[torch.from_numpy(eid[cut:])]).numpy()]),
        want)


def _one_rank_mesh():
    dryrun.fake_world(1)
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def _rep(mesh, t):
    return DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                              run_check=False)


def test_moe_on_a_one_rank_mesh_is_the_one_device_code_bit_for_bit():
    cfg = smoke_variant(get_config("olmoe-1b-7b"), capacity_factor=0.5)
    rng = np.random.default_rng(0)
    p = {name: torch.from_numpy(rng.standard_normal(spec.shape).astype(
        np.float32) * 0.2) for name, spec in
        moe.moe_specs(cfg, layered=False).items()}
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32))
    y, aux = moe.moe_apply(cfg, p, x, return_aux=True)
    mesh = _one_rank_mesh()
    with context.activation_rules(mesh, {"batch": ("data",)}):
        yd, auxd = moe.moe_apply(cfg, {k: _rep(mesh, v) for k, v in
                                       p.items()}, _rep(mesh, x),
                                 return_aux=True)
    assert torch.equal(yd.to_local(), y)
    for key, value in aux.items():
        got = auxd[key]
        assert torch.equal(got.to_local() if isinstance(got, DTensor)
                           else got, value), key


def test_mamba_on_a_one_rank_mesh_is_the_one_device_code_bit_for_bit():
    cfg = smoke_variant(get_config("zamba2-2.7b"))
    rng = np.random.default_rng(1)
    p = {name: torch.from_numpy(rng.standard_normal(spec.shape).astype(
        np.float32) * 0.2) for name, spec in
        ssm.ssm_specs(cfg, layered=False).items()}
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32))
    y, (state, conv) = ssm.mamba_apply(cfg, p, x)
    mesh = _one_rank_mesh()
    with context.activation_rules(mesh, {"batch": ("data",)}):
        yd, (sd, cd) = ssm.mamba_apply(
            cfg, {k: _rep(mesh, v) for k, v in p.items()}, _rep(mesh, x))
    for got, want in ((yd, y), (sd, state), (cd, conv)):
        assert torch.equal(got.to_local(), want)


def _mesh(shape):
    dryrun.fake_world(int(np.prod(shape)))
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _meta(mesh, shape, placements):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


@pytest.mark.parametrize("hq,hk,model,kept", [
    (24, 2, 8, True),     # starcoder2-3b: 3 heads a rank inside a group
    (24, 2, 2, True),     # whole groups
    (32, 32, 8, True),    # whole heads
    (32, 8, 16, True),    # 2 heads a rank inside a group of 4
    (24, 6, 8, False),    # 3 heads a rank across groups of 4
    (12, 3, 4, False),    # 3 heads a rank across groups of 4
])
def test_grouped_heads_keeps_a_split_inside_groups(hq, hk, model, kept):
    """Each model rank keeps its query heads where they hold whole KV
    groups ("local") or lie inside one ("group"); else every rank takes
    every head ("whole")."""
    mesh = _mesh((1, model))
    with context.activation_rules(mesh, {"batch": ("data",)}):
        context.enter(batch={"tokens": torch.empty((4, 8), device="meta")})
        got = context.head_layout(hq, hk)
    assert (got != "whole") == kept
    assert got == ("local" if hk % model == 0 else "group" if kept
                   else "whole")


@pytest.mark.parametrize("hq,hk,d,model,group", [
    (24, 2, 128, 2, 12),    # starcoder2-3b on 2 ranks: G 12, built
    (24, 2, 128, 8, None),  # 3 query heads a rank: G 3 is not built
    (8, 2, 16, 4, 2),       # the world's test config: G 2
    (32, 32, 64, 8, None),  # 4 whole KV heads a rank: laid out as today
])
def test_k2_takes_each_ranks_group_only_where_built(hq, hk, d, model,
                                                     group):
    mesh = _mesh((1, model))
    q = _meta(mesh, (4, hq, d), [Replicate(), Shard(1)])
    k = _meta(mesh, (4, 64, hk, d), [Replicate(), Replicate()])
    got = ops._grouped_query(q, k)
    if group is None:
        assert got is None
        return
    q, g0 = got
    assert q.to_local().shape[1] == group == hq // model
    assert g0 == 0      # rank 0's query heads lie in the first group
    # A cache whose sequence is split over model takes the partial route.
    k = _meta(mesh, (4, 64, hk, d), [Replicate(), Shard(1)])
    assert ops._grouped_query(q, k) is None


def test_built_matches_the_cuda_sources_instantiations():
    src = (ROOT / "src/repro_torch/kernels/csrc/decode_attn.cu").read_text()

    def cases(fn):
        body = src[src.index(f"int {fn}("):]
        body = body[:body.index("default:")]
        return tuple(int(c) for c in re.findall(r"case (\d+):", body))
    assert cases("switch_g") == da.GROUPS
    assert cases("switch_d") == da.HEAD_DIMS
    assert da.built(128, 12) and not da.built(128, 3) and not da.built(96, 1)
