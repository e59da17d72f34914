"""The port's channel planner (``core/planner``) against the JAX reference,
on the CPU, and the card's NVLink fields (``core/hw.GpuSpec``).

* Every planner function runs on a port ``GpuSpec`` built here from the
  reference's ``TPU_V5E`` fields (peak flops, HBM rate and size, link
  bandwidth, links, hop latency): both packages do the same scalar Python
  float arithmetic, so every ``StepCost`` field, the chosen channel or
  shard count and the speedup must be equal (``==``).
* The cases of ``tests/test_planner.py`` (the reference's own planner
  tests) run again on ``H100_SXM``, parametrised; its hypothesis property
  runs where ``hypothesis`` is installed.
"""

import dataclasses
import math

import pytest

from repro.core import planner as jplanner
from repro.core.hw import TPU_V5E
from repro_torch.core import hw, planner
from repro_torch.launch import coaxial_study

#: The reference's spec in the port's type.
V5E = hw.GpuSpec(part="tpu-v5e", hbm_bw=TPU_V5E.hbm_bw,
                 peak_bf16_flops=TPU_V5E.peak_flops,
                 peak_fp32_flops=TPU_V5E.peak_flops,
                 hbm_bytes=TPU_V5E.hbm_bytes, l2_bytes=0,
                 nvlink_bw_per_link=TPU_V5E.ici_bw_per_link,
                 nvlink_links=TPU_V5E.ici_links,
                 nvlink_hop_s=TPU_V5E.ici_hop_s)
PARTS = (hw.H100_SXM, hw.H100_PCIE, hw.H100_NVL)


def _cost_equal(got: planner.StepCost, want) -> None:
    assert (got.name, got.compute_s, got.hbm_s, got.link_s, got.hop_lat_s) \
        == (want.name, want.compute_s, want.hbm_s, want.ici_s,
            want.hop_lat_s)
    assert got.total_s == want.total_s and got.dominant == want.dominant


# --- hw.GpuSpec's links -----------------------------------------------------

@pytest.mark.parametrize("spec", PARTS, ids=lambda s: s.part)
def test_link_bw_is_links_times_per_link(spec):
    assert spec.link_bw == spec.nvlink_links * spec.nvlink_bw_per_link
    # The data sheets' totals count both directions: 900 GB/s (SXM),
    # 600 GB/s (PCIe, NVL); the planner reads one direction.
    total = {"SXM": 900e9, "PCIe": 600e9, "NVL": 600e9}[spec.part]
    assert 2 * spec.link_bw == total
    assert spec.link_bw < spec.hbm_bw
    assert 0 < spec.nvlink_hop_s != TPU_V5E.ici_hop_s


def test_v5e_spec_carries_the_reference_numbers():
    assert V5E.link_bw == TPU_V5E.ici_bw


# --- every function on the reference's numbers -------------------------------

@pytest.mark.parametrize("rho", [-0.5, 0.0, 0.3, 0.6, 0.9, 0.97, 0.99, 2.0])
@pytest.mark.parametrize("kappa", [None, 1.0, 2.5])
def test_contention_factor_equals_reference(rho, kappa):
    kw = {} if kappa is None else {"kappa": kappa}
    assert planner.contention_factor(rho, **kw) == \
        jplanner.contention_factor(rho, **kw)
    assert planner.DMA_KAPPA == jplanner.DMA_KAPPA


@pytest.mark.parametrize("rho", [0.0, 0.5, 0.95])
def test_effective_hbm_time_equals_reference(rho):
    for nbytes in (0.0, 1e6, 3.3e9, 9.45e10):
        assert planner.effective_hbm_time(nbytes, V5E, rho) == \
            jplanner.effective_hbm_time(nbytes, TPU_V5E, rho)


DECODE_CASES = [
    dict(kv_bytes=50e9, qkv_flops=1e11, combine_bytes=1e6),
    dict(kv_bytes=5e5, qkv_flops=1e6, combine_bytes=1e6),
    dict(kv_bytes=1e8, qkv_flops=1e9, combine_bytes=1e5),
    dict(kv_bytes=1e11, qkv_flops=1e12, combine_bytes=1e5),
    dict(kv_bytes=1e9, qkv_flops=1e12, combine_bytes=1e8,
         background_rho=0.7),
    # examples/coaxial_study.py's mistral-large 32k decode.
    dict(kv_bytes=8 * 32768 * 8 * 128 * 2 * 2 * 88,
         qkv_flops=4 * 88 * 8 * 32768 * 96 * 128,
         combine_bytes=88 * 8 * 96 * 130 * 4),
    dict(kv_bytes=1e10, qkv_flops=1e10, combine_bytes=1e6, max_channels=5),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plan_equals_reference(case):
    got = planner.plan_decode_kv(**case, spec=V5E)
    want = jplanner.plan_decode_kv(**case, spec=TPU_V5E)
    assert got.n_channels == want.n_channels
    assert got.speedup == want.speedup
    _cost_equal(got.cost, want.cost)
    _cost_equal(got.baseline, want.baseline)
    kw = {k: v for k, v in case.items() if k != "max_channels"}
    for n in (1, 2, 3, 4, 8, 16, 32):
        _cost_equal(planner.decode_step_cost(**kw, n=n, spec=V5E),
                    jplanner.decode_step_cost(**kw, n=n, spec=TPU_V5E))


PARAM_CASES = [
    dict(param_bytes=1e9, step_flops_per_chip=1e12, layers=32),
    dict(param_bytes=10e9, step_flops_per_chip=1e12, layers=32),
    dict(param_bytes=1e6, step_flops_per_chip=1e15, layers=8),
    dict(param_bytes=1e12, step_flops_per_chip=1e12, layers=88),
    dict(param_bytes=4e9, step_flops_per_chip=1e13, layers=16,
         shard_candidates=(1, 3, 6), state_bytes_factor=3.0,
         hbm_budget_bytes=1e10),
]


@pytest.mark.parametrize("case", PARAM_CASES)
def test_param_plan_equals_reference(case):
    got = planner.plan_param_channels(**case, spec=V5E)
    want = jplanner.plan_param_channels(**case, spec=TPU_V5E)
    assert got.shards == want.shards and got.speedup == want.speedup
    _cost_equal(got.cost, want.cost)
    _cost_equal(got.baseline, want.baseline)


@pytest.mark.parametrize("rw", [(2e9, 1e9), (0.0, 0.0), (0.0, 5e8),
                                (3e9, 0.0), (0.5, 0.25)])
def test_asym_schedule_equals_reference(rw):
    got = planner.asym_schedule(*rw)
    want = jplanner.asym_schedule(*rw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.rw_ratio == want.rw_ratio


# --- the reference's planner tests, on the H100 ------------------------------

def test_contention_grows_with_load():
    f = [planner.contention_factor(r) for r in (0.0, 0.3, 0.6, 0.9)]
    assert f[0] == 1.0
    assert all(a < b for a, b in zip(f, f[1:]))


@pytest.mark.parametrize("spec", PARTS, ids=lambda s: s.part)
def test_big_kv_wants_channels(spec):
    """32k-context 123B-class decode: memory-bound -> spread the KV."""
    plan = planner.plan_decode_kv(kv_bytes=50e9, qkv_flops=1e11,
                                  combine_bytes=1e6, spec=spec)
    assert plan.n_channels > 1
    assert plan.speedup > 2.0


@pytest.mark.parametrize("spec", PARTS, ids=lambda s: s.part)
def test_tiny_state_stays_local(spec):
    """RWKV-like tiny state: the premium outweighs queuing -> 1 channel."""
    plan = planner.plan_decode_kv(kv_bytes=5e5, qkv_flops=1e6,
                                  combine_bytes=1e6, spec=spec)
    assert plan.n_channels == 1


def test_more_load_more_channels():
    small = planner.plan_decode_kv(kv_bytes=1e8, qkv_flops=1e9,
                                   combine_bytes=1e5)
    big = planner.plan_decode_kv(kv_bytes=1e11, qkv_flops=1e12,
                                 combine_bytes=1e5)
    assert big.n_channels >= small.n_channels


@pytest.mark.parametrize("kv_gb", [0.001, 0.01, 0.1, 0.5, 1.0, 3.0, 10.0,
                                   30.0, 100.0])
def test_chosen_plan_is_optimal(kv_gb):
    kv = kv_gb * 1e9
    plan = planner.plan_decode_kv(kv_bytes=kv, qkv_flops=kv / 2,
                                  combine_bytes=1e6)
    for n in (1, 2, 4, 8, 16):
        alt = planner.decode_step_cost(kv_bytes=kv, qkv_flops=kv / 2,
                                       combine_bytes=1e6, n=n)
        assert plan.cost.total_s <= alt.total_s + 1e-12


def test_chosen_plan_is_optimal_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(kv_gb=st.floats(0.001, 100.0))
    def prop(kv_gb):
        test_chosen_plan_is_optimal(kv_gb)

    prop()


def test_replication_wins_on_time_when_it_fits():
    """NVLink < HBM bandwidth: broadcast-consumed params prefer locality."""
    plan = planner.plan_param_channels(
        param_bytes=1e9, step_flops_per_chip=1e12, layers=32)
    assert plan.shards == 1


def test_capacity_forces_fsdp():
    """Params + optimizer state over the HBM budget -> must shard: 80 GB
    resident (10 GB x 8) against 0.8 x 80 GB; 2 shards fit."""
    plan = planner.plan_param_channels(
        param_bytes=10e9, step_flops_per_chip=1e12, layers=32)
    assert plan.shards == 2
    plan = planner.plan_param_channels(
        param_bytes=100e9, step_flops_per_chip=1e12, layers=32)
    assert plan.shards == 16     # 800 GB / 64 GB: 13 cards, 16 the next


def test_compute_bound_model_indifferent():
    plan = planner.plan_param_channels(
        param_bytes=1e6, step_flops_per_chip=1e15, layers=8)
    assert plan.speedup == pytest.approx(1.0, abs=0.05)


def test_rw_ratio_drives_split():
    s = planner.asym_schedule(read_bytes=2e9, write_bytes=1e9)
    assert s.read_fraction == pytest.approx(2 / 3)
    assert s.rw_ratio == pytest.approx(2.0)
    assert planner.asym_schedule(0.0, 0.0).read_fraction == 0.5


def test_h100_decode_plan_of_the_study():
    """The study's mistral-large 32k line on the SXM part: 16 channels,
    the memory term 1/16 of one card's plus four merge stages."""
    case = DECODE_CASES[5]
    plan = planner.plan_decode_kv(**case)
    assert plan.n_channels == 16
    assert plan.baseline.dominant == "memory"
    hbm1 = case["kv_bytes"] / hw.H100_SXM.hbm_bw
    assert plan.baseline.hbm_s == hbm1
    assert plan.cost.total_s == pytest.approx(
        hbm1 / 16 + 4 * hw.H100_SXM.nvlink_hop_s, rel=1e-12)
    assert math.isclose(plan.speedup, plan.baseline.total_s /
                        plan.cost.total_s)


def test_study_plans_with_the_reference_counts():
    """The study twin's decode-plan line: the reference's own byte and
    flop expressions (examples/coaxial_study.py), on the spec it is given;
    on the reference's numbers, the reference's plan."""
    assert coaxial_study.DECODE_PLAN == DECODE_CASES[5]
    got = coaxial_study.decode_plan(V5E)
    want = jplanner.plan_decode_kv(**DECODE_CASES[5])
    assert (got.n_channels, got.speedup) == (want.n_channels, want.speedup)
    for spec in PARTS:
        plan = coaxial_study.decode_plan(spec)
        assert plan == planner.plan_decode_kv(**DECODE_CASES[5], spec=spec)
