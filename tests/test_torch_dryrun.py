"""The port's dry run (``launch/dryrun``) and its cost meter
(``core/hloparse``), on the CPU.

* The meter's FLOPs of the smoke stablelm's train step and decode step on
  one device against the reference's ``hloparse.analyze`` of the same
  steps jitted (remat off): within 2% (measured: equal).
* A data-parallel world's FLOPs a rank are one device's over N.
* Every family's smoke config, train and decode, on a fake 8-rank (2, 4)
  world; stablelm-1.6b's ``decode_32k`` cell on the production mesh with
  the channelized cache (the default: K2's partial build on each rank's
  slice, merged over ``model``), its FLOPs a chip within 1% of the
  reference's ``run_cell`` (in a process of its own), and with the whole
  cache on every ``model`` rank (``--no-kv-channels``); zamba2-2.7b's
  ``long_500k`` on both meshes; a prefill step whose batch does not
  divide its data ranks, each sequence split over ``pod`` (half the
  FLOPs a rank of the single-pod step); the decode step's K2 stand-in;
  the int8 collective proof; the CLI's records.

A fake process group (every collective returns at once) stands in for
the world, and the tensors are shards on the ``meta`` device.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import get_config as jget_config
from repro.core import hloparse as jhloparse
from repro.data.pipeline import SyntheticDataset as JSyntheticDataset
from repro.distributed import step as jstep
from repro.models import Model as JModel
from repro.models.config import smoke_variant as jsmoke
from repro_torch.configs import Shape, get_config
from repro_torch.core import hloparse
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.distributed import layout
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import step as pstep
from repro_torch.launch import dryrun
from repro_torch.models import Model, smoke_variant

FAMILIES = ["stablelm-1.6b", "olmoe-1b-7b", "rwkv6-1.6b", "zamba2-2.7b",
            "qwen2-vl-72b", "hubert-xlarge"]
FLOPS_RTOL = 0.02
B, S = 8, 64
#: The fake worlds' smoke steps: DTensor's dispatch in Python costs per op.
WORLD_S = 32
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_world_left():
    """Each test leaves no process group behind."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _pair(arch):
    cfg = smoke_variant(get_config(arch), remat="none")
    jcfg = jsmoke(jget_config(arch), remat="none")
    return Model(cfg, device="cpu"), JModel(jcfg)


def test_meter_flops_equal_reference_train_step():
    m, jm = _pair("stablelm-1.6b")
    step_cfg = pstep.TrainStepConfig(param_dtype="float32")
    state = pstep.init_train_state(m, 0, step_cfg)
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticDataset(m.cfg, B, S).batch_at(0).items()}
    with hloparse.Meter() as meter:
        pstep.make_train_step(m, step_cfg)(state, batch)
    jcfg = jstep.TrainStepConfig(param_dtype="float32")
    jstate = jstep.init_train_state(jm, jax.random.PRNGKey(0), jcfg)
    text = jax.jit(jstep.make_train_step(jm, jcfg)).lower(
        jstate, JSyntheticDataset(jm.cfg, B, S).batch_at(0)).compile(
    ).as_text()
    want = jhloparse.analyze(text).flops
    np.testing.assert_allclose(meter.cost.flops, want, rtol=FLOPS_RTOL)
    assert meter.cost.bytes > meter.cost.bytes_hbm > 0
    assert meter.ops["aten.mm"] > 0 and meter.cost.coll_total == 0


def test_meter_flops_equal_reference_decode_step():
    m, jm = _pair("stablelm-1.6b")
    cache = m.make_cache(B, S)
    cache["len"] = S - 1
    sb = {"tokens": torch.zeros((B, 1), dtype=torch.int32),
          "positions": torch.full((B, 1), S - 1, dtype=torch.int32)}
    with hloparse.Meter() as meter:
        pstep.make_serve_step(m)(m.init(0), sb, cache)
    jcache = jm.make_cache(B, S)
    jcache["len"] = jax.numpy.int32(S - 1)
    text = jax.jit(jstep.make_serve_step(jm)).lower(
        jm.init(jax.random.PRNGKey(0)),
        {k: v.numpy() for k, v in sb.items()}, jcache).compile().as_text()
    np.testing.assert_allclose(meter.cost.flops,
                               jhloparse.analyze(text).flops,
                               rtol=FLOPS_RTOL)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_meter_on_meta_shards_within_2pct_of_reference(arch):
    """A train step on a one-rank fake world's meta shards, the dry run's
    way: rwkv6's recurrence is charged by its stand-in (4 B T H D^2 FLOP
    forward, twice that backward), zamba2's SSD runs its torch ops.
    Measured: 1.012 and 0.988 of the reference's HLO count."""
    dryrun.fake_world(1)
    res = _step(arch, (1, 1), "train", seq=S)
    _, jm = _pair(arch)
    jcfg = jstep.TrainStepConfig()
    jstate = jstep.init_train_state(jm, jax.random.PRNGKey(0), jcfg)
    text = jax.jit(jstep.make_train_step(jm, jcfg)).lower(
        jstate, JSyntheticDataset(jm.cfg, B, S).batch_at(0)).compile(
    ).as_text()
    np.testing.assert_allclose(res.flops_per_chip,
                               jhloparse.analyze(text).flops,
                               rtol=FLOPS_RTOL)


def _step(arch, mesh_shape, kind, seq=WORLD_S):
    cfg = smoke_variant(get_config(arch), remat="none")
    mesh = init_device_mesh("cuda", mesh_shape,
                            mesh_dim_names=("data", "model"))
    res = dryrun.CellResult(arch, kind, str(mesh_shape), "ok")
    return dryrun.run_step(cfg, Shape("smoke", seq, B, kind), mesh, res)


def test_split_sequences_halve_the_flops_a_rank_and_refuse_other_splits(
        monkeypatch):
    """A prefill step of 2 sequences on a fake (pod 2, data 2, model 2)
    world: the batch does not divide the 4 data ranks, so each sequence
    splits into halves over ``pod`` and each rank's FLOPs are half of the
    same step's on the (2, 2) single-pod mesh, where each rank holds a
    whole sequence (attention: each half's queries against all keys),
    the same for either half's rank (the dry run runs rank 0's half 0;
    half 1 is run here as a pair of index 1).  A split other than the
    pod's size, or a sequence it does not divide, raises."""
    cfg = smoke_variant(get_config("stablelm-1.6b"), remat="none")
    shape = Shape("smoke", WORLD_S, 2, "prefill")
    dryrun.fake_world(4)
    single = dryrun.run_step(cfg, shape, init_device_mesh(
        "cuda", (2, 2), mesh_dim_names=("data", "model")),
        dryrun.CellResult("stablelm", "smoke", "2x2", "ok"))
    dryrun.fake_world(8)
    mesh = init_device_mesh("cuda", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    halves = []
    for index in (0, 1):
        monkeypatch.setattr(layout.SeqPair, "over", classmethod(
            lambda cls, m, axis="pod", index=index: cls(
                index, m.get_group(axis))))
        halves.append(dryrun.run_step(cfg, shape, mesh, dryrun.CellResult(
            "stablelm", "smoke", "2x2x2", "ok")))
    monkeypatch.undo()
    assert single.seq_parts == 1
    assert all(half.seq_parts == 2 for half in halves)
    assert [half.flops_per_chip for half in halves] == \
        [single.flops_per_chip / 2] * 2
    batch = {"tokens": torch.empty((2, WORLD_S), device="meta")}
    with pytest.raises(ValueError, match="parts a sequence over a pod"):
        shd.split_sequences(mesh, batch, 4)
    with pytest.raises(ValueError, match="does not split"):
        shd.split_sequences(mesh, {"tokens": batch["tokens"][:, 1:]}, 2)
    with pytest.raises(ValueError, match="does not divide"):
        dryrun.run_step(cfg, Shape("smoke", WORLD_S - 1, 2, "prefill"),
                        mesh, dryrun.CellResult("stablelm", "s", "m", "ok"))


def test_data_parallel_flops_per_rank_are_one_device_over_n():
    m, _ = _pair("stablelm-1.6b")
    step_cfg = pstep.TrainStepConfig(param_dtype="float32")
    state = pstep.init_train_state(m, 0, step_cfg)
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticDataset(m.cfg, B, WORLD_S).batch_at(0).items()}
    with hloparse.Meter() as meter:
        pstep.make_train_step(m, step_cfg)(state, batch)
    dryrun.fake_world(8)
    res = _step("stablelm-1.6b", (8, 1), "train")
    assert res.flops_per_chip == meter.cost.flops / 8
    assert res.collectives["total"] > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_cells_on_a_fake_8_rank_world(arch):
    dryrun.fake_world(8)
    kinds = ("train", "decode") if get_config(arch).has_decode else (
        "train",)
    for kind in kinds:
        res = _step(arch, (2, 4), kind)
        assert res.flops_per_chip > 0, kind
        assert res.memory["argument_bytes"] > 0, kind
        assert set(res.collectives) == set(hloparse.COLLECTIVES) | {"total"}


#: stablelm-1.6b's decode cache: 24 layers x K and V x (128, 32768, 32, 64)
#: bf16, and its weights (1,644,267,520 parameters) in bf16.
DECODE_CACHE = 24 * 2 * 128 * 32768 * 32 * 64 * 2
DECODE_WEIGHTS = 2 * 1_644_267_520


def _cell(tmp_path, arch, shape, *flags):
    mesh = "2x32x8" if "--multi-pod" in flags else "32x8"
    code = dryrun.main(["--arch", arch, "--shape", shape, "--out",
                        str(tmp_path), *flags])
    res = json.loads((tmp_path / f"{arch}__{shape}__{mesh}__baseline.json")
                     .read_text())
    return code, res


def test_stablelm_decode_32k_on_the_production_mesh(tmp_path):
    """The channelized cache, the default: each rank holds 1/32 of the
    batch and 1/8 of the context (3 GiB) beside the weights split over 8
    (0.38 GiB); the embedding is looked up in place, so the collectives
    are the small all-reduces of a step, not a table's gather."""
    code, res = _cell(tmp_path, "stablelm-1.6b", "decode_32k")
    assert code == 0 and res["status"] == "ok" and res["chips"] == 256
    args = res["memory"]["argument_bytes"]
    assert DECODE_CACHE / 256 < args <= 3.5 * 2**30
    assert args < (DECODE_CACHE / 256 + DECODE_WEIGHTS / 8) * 1.01
    assert 0 < res["collectives"]["total"] < 5e7


def test_no_kv_channels_lays_the_whole_cache_on_every_model_rank(tmp_path):
    """``--no-kv-channels`` (the reference's flag): each rank holds 1/32
    of the batch and the whole context, and K2 reads all of it, 8x the
    channelized cell's attention."""
    code, res = _cell(tmp_path, "stablelm-1.6b", "decode_32k",
                      "--no-kv-channels")
    assert code == 0 and res["status"] == "ok"
    cache = DECODE_CACHE / 32
    assert cache < res["memory"]["argument_bytes"] < cache * 1.2
    _, channels = _cell(tmp_path, "stablelm-1.6b", "decode_32k")
    # K2's work a chip: 4 B Hq L D FLOP a layer over 24 layers.
    k2 = 4 * 4 * 32 * 32767 * 64 * 24
    np.testing.assert_allclose(
        res["flops_per_chip"] - channels["flops_per_chip"], k2 * 7 / 8,
        rtol=1e-3)


def test_decode_32k_flops_equal_the_references_run_cell():
    """The port's channelized cell on (32, 8) against the reference's
    ``repro.launch.dryrun.run_cell`` on its (16, 16), in a process of its
    own (it fakes 512 host devices when imported): the FLOPs a chip do not
    depend on the mesh's shape where nothing is replicated."""
    spec = importlib.util.spec_from_file_location(
        "dryrun_vs_reference", ROOT / "tools" / "dryrun_vs_reference.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    want = tool.reference_cell("stablelm-1.6b", "decode_32k", timeout=600)
    got = dryrun.run_cell("stablelm-1.6b", "decode_32k")
    assert got.status == want["status"] == "ok"
    np.testing.assert_allclose(got.flops_per_chip, want["flops_per_chip"],
                               rtol=0.01)


@pytest.mark.parametrize("flags", [(), ("--multi-pod",)])
def test_zamba2_long_500k_runs_with_whole_ssm_heads(tmp_path, flags):
    """Batch 1 does not split over the data ranks; the Mamba2 decode state
    keeps whole heads (80 do not split over 32 or 64 ranks)."""
    code, res = _cell(tmp_path, "zamba2-2.7b", "long_500k", *flags)
    assert code == 0 and res["status"] == "ok", res["error"]
    assert res["flops_per_chip"] > 0


def test_meta_decode_charges_k2_where_the_cpu_runs_the_plain_math(
        monkeypatch):
    """On a one-rank fake world's meta shards the decode step's attention
    is K2's stand-in, once a layer; its charge (4 B Hq length D FLOP, the
    cache full) equals the plain version's two einsums over the whole
    cache, so the step's FLOPs equal one CPU device's exactly."""
    from repro_torch.kernels import ops
    m, _ = _pair("stablelm-1.6b")
    cache = m.make_cache(B, WORLD_S)
    cache["len"] = WORLD_S - 1
    sb = {"tokens": torch.zeros((B, 1), dtype=torch.int32),
          "positions": torch.full((B, 1), WORLD_S - 1, dtype=torch.int32)}
    with hloparse.Meter() as meter:
        pstep.make_serve_step(m)(m.init(0), sb, cache)
    calls = []
    stand_in = ops._decode_attn_meta
    monkeypatch.setattr(ops, "_decode_attn_meta",
                        lambda *a: calls.append(1) or stand_in(*a))
    dryrun.fake_world(1)
    res = _step("stablelm-1.6b", (1, 1), "decode")
    assert len(calls) == m.cfg.n_layers
    assert res.flops_per_chip == meter.cost.flops


def test_collective_proof_int8_moves_half_the_metric_bytes(tmp_path):
    out = dryrun.collective_proof(out_dir=str(tmp_path))
    assert set(out["f32"]["by_op"]) == {"all-reduce"}
    assert set(out["int8"]["by_op"]) == {"all-to-all", "all-gather"}
    np.testing.assert_allclose(out["reduction_factor"], 2.0, rtol=0.01)
    assert (tmp_path / "int8_proof.json").exists()


def test_cli_records_skips_and_errors(tmp_path, monkeypatch):
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "hubert-xlarge__decode_32k__32x8__baseline"
                      ".json").read_text())
    assert res["status"].startswith("skip")

    def broken(*args, **kwargs):
        raise RuntimeError("no strategy")
    monkeypatch.setattr(dryrun, "run_step", broken)
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 1
    res = json.loads((tmp_path / "stablelm-1.6b__train_4k__32x8__baseline"
                      ".json").read_text())
    assert res["status"] == "error" and "no strategy" in res["error"]


@pytest.mark.parametrize("batch,seq", [(256, 4096), (128, 1)])
def test_moe_expert_flops_a_chip_are_the_closed_forms_share(batch, seq):
    """olmoe-1b-7b's MoE block on meta shards of the production (32, 8)
    mesh: each rank routes its own tokens and computes its block of the
    expert buffer, 1/(data x model) of the three expert products over the
    whole capacity, padded to a multiple of the 32 data ranks (train_4k's
    163,840 slots an expert divide; decode_32k's 20 pad to 32).  The
    meter's FLOPs a chip are that share plus the router over the rank's
    own tokens, exactly."""
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe
    cfg = get_config("olmoe-1b-7b")
    dryrun.fake_world(256)
    mesh = make_production_mesh()
    rules = shd.train_rules(mesh, cfg)
    p = {name: dryrun.sharded_empty(spec.shape, torch.bfloat16, shd.Sharding(
        mesh, shd.spec_for(spec.shape, spec.axes, rules, mesh)))
        for name, spec in moe.moe_specs(cfg, layered=False).items()}
    x = dryrun.sharded_empty((batch, seq, cfg.d_model), torch.bfloat16,
                             shd.Sharding(mesh, ("data", None, None)))
    with context.activation_rules(mesh, {"batch": ("data",)}), \
            hloparse.Meter() as meter:
        y = moe.moe_apply(cfg, p, x)
    assert y.shape == x.shape
    t, e, d, f = batch * seq, cfg.n_experts, cfg.d_model, cfg.d_ff
    cap = moe.capacity(cfg, t)
    padded = -(-cap // 32) * 32
    experts = 3 * 2.0 * e * padded * d * f / 256
    router = 2.0 * (t // 32) * d * e
    assert meter.cost.flops == experts + router
