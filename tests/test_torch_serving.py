"""The port's serving package (``serving/{demand,traffic,capacity,plan}``)
and ``core/planner.roofline_terms`` against the JAX reference, on the CPU.

* ``decode_demand`` and ``llm_workload`` are Python float arithmetic in
  both packages: every field of all ten configs within 1e-6 relative
  (measured: equal).
* Traces and the CSV loader are numpy: equal epochs, and the same
  ``ValueError`` for each malformed file.
* ``plan_capacity`` at the reference's own test sizes (8,000 DES steps):
  with ``p99_source="des"`` every cell's access p99 equal to the
  reference's (the DES is bit for bit) and the same verdicts; with
  ``p99_source="lut"`` (one reference-built LUT, loaded into the port)
  token p99s within 1e-5 and the same ``PICK``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.core import coaxial as jco
from repro.core import planner as jplanner
from repro.core import queuelut as jq
from repro.serving import capacity as jcap
from repro.serving import demand as jdemand
from repro.serving import plan as jplan
from repro.serving import traffic as jtraffic
from repro_torch.core import coaxial, cpu_model, memsim, planner, queuelut
from repro_torch.core import shardsim, workloads
from repro_torch.serving import capacity, demand, plan, traffic

RTOL = 1e-5
DEMAND_RTOL = 1e-6
LUT_STEPS = 8_000
#: The reference's plan test: stablelm-1.6b at batch 32 / context 2048,
#: two diurnal epochs, the 2- and 4-channel CXL grid at 30 ns, pure and
#: 50/50 tiered, the measured devices, 60% peak load.
PLAN = dict(slo_p99_ms=10_000.0, batch=32, context=2048, channels=(2, 4),
            premium_ns=(30.0,), tier_splits=(0.0, 0.5),
            include_registry=False, include_measured=True, peak_util=0.6,
            steps=LUT_STEPS, engine="event")


@pytest.fixture(scope="module")
def ref_lut():
    return jq.build_queue_lut(steps=LUT_STEPS, reps=1)


@pytest.fixture(scope="module")
def lut(ref_lut):
    return queuelut.QueueLUT(*(None if x is None else
                               torch.from_numpy(np.array(x)) for x in ref_lut))


# --- planner.roofline_terms and demand ---------------------------------------

def test_roofline_terms_equal_reference():
    kw = dict(hlo_flops=3.1e12, hlo_bytes=7.7e9, collective_bytes=2.5e8,
              chips=4)
    ref_spec = jplanner.TPU_V5E                 # the reference's default
    got = planner.roofline_terms(**kw, spec=planner.RooflineSpec(
        peak_flops=ref_spec.peak_flops, hbm_bw=ref_spec.hbm_bw,
        link_bw=ref_spec.ici_bw_per_link))
    assert got == jplanner.roofline_terms(**kw)
    base = demand.BASELINE_SPEC
    assert (base.peak_flops, base.hbm_bw) == (
        jdemand.BASELINE_SPEC.peak_flops, jdemand.BASELINE_SPEC.hbm_bw)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_demand_equals_reference(arch):
    for kw in ({}, dict(batch=32, context=2048), dict(batch=8,
                                                      context=65536)):
        got = dataclasses.asdict(demand.decode_demand(arch, **kw))
        want = dataclasses.asdict(jdemand.decode_demand(arch, **kw))
        assert got.keys() == want.keys()
        for k, w in want.items():
            if isinstance(w, float):
                assert got[k] == pytest.approx(w, rel=DEMAND_RTOL, abs=0), k
            else:
                assert got[k] == w, k
        g, w = (demand.llm_workload(arch, **kw),
                jdemand.llm_workload(arch, **kw))
        for k, v in dataclasses.asdict(w).items():
            assert getattr(g, k) == pytest.approx(v, rel=DEMAND_RTOL), k
    d = demand.decode_demand(arch)
    assert all(math.isfinite(v) and v > 0 for v in
               (d.read_bytes, d.flops_per_token, d.mpki, d.ipc, d.ws_mb))


def test_decode_demand_rejects_bad_operating_point():
    with pytest.raises(ValueError, match="batch and context"):
        demand.decode_demand("stablelm-1.6b", batch=0)


def test_llm_workload_round_trip_through_solve_spec():
    n0 = len(workloads.all_workloads())
    with coaxial.scoped_registry():
        wls = demand.register_llm_workloads(("stablelm-1.6b",))
        w = workloads.by_name("llm-stablelm-1.6b")
        assert w is wls[0] and w.suite == demand.LLM_SUITE
        assert demand.register_llm_workloads(("stablelm-1.6b",)) == wls
        assert len(workloads.all_workloads()) == n0 + 1
        spec = coaxial.sweep_spec(design=coaxial.all_designs())
        before = cpu_model.solve_trace_count()
        sw = coaxial.solve_spec(spec, workloads=workloads.all_workloads(),
                                device="cpu")
        assert cpu_model.solve_trace_count() == before + 1
        i = sw.names.index("llm-stablelm-1.6b")
        got = float(sw.comparison(coaxial.COAXIAL_4X).speedup[i])
        ref_w = jdemand.llm_workload("stablelm-1.6b")
        want = jco.sweep((jco.DDR_BASELINE, jco.COAXIAL_4X),
                         workloads=(ref_w,)).comparison(
                             jco.COAXIAL_4X).speedup[0]
        assert got == pytest.approx(float(want), rel=RTOL)
        demand.unregister_llm_workloads(("stablelm-1.6b",))
        assert len(workloads.all_workloads()) == n0
        demand.unregister_llm_workloads(("stablelm-1.6b",))   # no-op
    assert all(not w.name.startswith("llm-")
               for w in workloads.all_workloads())


# --- traffic -----------------------------------------------------------------

def _epochs(trace):
    return [dataclasses.astuple(e) for e in trace.epochs]


@pytest.mark.parametrize("make", [
    lambda t: t.synthetic_diurnal(),
    lambda t: t.synthetic_diurnal(n_epochs=6, peak_rps=2.0,
                                  trough_frac=0.25),
    lambda t: t.poisson_burst(seed=7),
    lambda t: t.poisson_burst(seed=8, n_epochs=20),
    lambda t: t.synthetic_diurnal().scaled(3.0),
    lambda t: t.synthetic_diurnal().with_harvest(0.5),
    lambda t: t.get_trace("poisson-burst"),
], ids=["diurnal", "diurnal6", "burst7", "burst8", "scaled", "harvest",
        "by_name"])
def test_traces_equal_reference(make):
    got, want = make(traffic), make(jtraffic)
    assert got.name == want.name
    assert _epochs(got) == _epochs(want)
    assert (got.peak_rps, got.duration_s) == (want.peak_rps,
                                              want.duration_s)


def test_csv_round_trip(tmp_path):
    for t in (traffic.synthetic_diurnal(n_epochs=4),
              traffic.poisson_burst().with_harvest(0.4)):
        path = str(tmp_path / f"{t.name}.csv")
        t.to_csv(path)
        got, want = traffic.load_csv(path), jtraffic.load_csv(path)
        assert _epochs(got) == _epochs(want) and got.name == want.name
        for e0, e1 in zip(t.epochs, got.epochs):
            assert e1.rps == pytest.approx(e0.rps, rel=1e-5)
            assert e1.harvest_duty == pytest.approx(e0.harvest_duty,
                                                    abs=1e-5)
        assert traffic.get_trace(path).epochs == got.epochs
    with pytest.raises(KeyError, match="unknown trace"):
        traffic.get_trace("no-such-trace")


BAD_CSV = {
    "nonmonotone": ("t_s,rps\n0,1.0\n120,1.5\n60,2.0\n", "precedes"),
    "duplicate": ("t_s,rps\n0,1.0\n60,1.5\n60,2.0\n", "duplicates"),
    "negative_rps": ("t_s,rps\n0,1.0\n60,-0.5\n", "negative rps"),
    "sub_floor_kappa": ("0,1.0,1.2\n60,1.0,0.5\n", "floor"),
    "garbage_t": ("t_s,rps\n0,1.0\nsixty,2.0\n", "non-numeric t_s"),
    "garbage_rps": ("t_s,rps\n0,1.0\n60,fast\n", "could not convert"),
    "short_row": ("t_s,rps\n0,1.0\n60\n", "expected t_s"),
    "bad_duty": ("0,1.0,1.2,1.5\n", "harvest_duty"),
    "empty": ("# nothing\nt_s,rps\n", "no data rows"),
}


@pytest.mark.parametrize("case", sorted(BAD_CSV))
def test_bad_csv_refused_as_reference(tmp_path, case):
    body, match = BAD_CSV[case]
    path = tmp_path / "trace.csv"
    path.write_text(body)
    with pytest.raises(ValueError, match=match) as got:
        traffic.load_csv(str(path))
    with pytest.raises(ValueError) as want:
        jtraffic.load_csv(str(path))
    assert str(got.value) == str(want.value)


def test_csv_comments_and_header(tmp_path):
    path = tmp_path / "trace.csv"
    path.write_text("# measured trace\nt_s,rps,kappa\n0,1.0,1.3\n\n"
                    "# gap comment\n60,2.0,1.8\n")
    t = traffic.load_csv(str(path))
    assert _epochs(t) == _epochs(jtraffic.load_csv(str(path)))
    assert len(t.epochs) == 2 and t.epochs[1].kappa == 1.8


# --- capacity ----------------------------------------------------------------

def test_candidates_and_variants_equal_reference():
    kw = dict(channels=(2, 4, 8), premium_ns=(30.0, 50.0))
    got = capacity.candidate_designs(**kw)
    want = jcap.candidate_designs(**kw)
    assert [dataclasses.asdict(d) for d in got] == \
        [dataclasses.asdict(d) for d in want]
    gv = capacity._variants(got, (0.0, 0.5))
    wv = jcap._variants(want, (0.0, 0.5))
    assert [(v.name, v.lanes, v.rel_area, v.rel_pins, v.capacity_gbps)
            for v in gv] == [(v.name, v.lanes, v.rel_area, v.rel_pins,
                              v.capacity_gbps) for v in wv]
    tier = next(v for v in gv if v.name == "cxl-4ch-llc1-30ns+tier0.5")
    assert tier.n_hot == 2 and tier.n_cold == 2


def _verdicts(p):
    return [(v.name, v.design, v.channels, v.llc_mb_per_core, v.premium_ns,
             v.tier_split, v.rel_area, v.rel_pins, v.meets_slo)
            for v in p.verdicts]


def _assert_plan_close(got, want, exact_p99):
    assert _verdicts(got) == _verdicts(want)
    assert (got.engine, got.steps, got.peak_rps, got.trace) == (
        want.engine, want.steps, want.peak_rps, want.trace)
    for g, w in zip(got.verdicts, want.verdicts):
        assert g.peak_rho == w.peak_rho
        if exact_p99:
            assert g.access_p99_ns == w.access_p99_ns, g.name
        else:
            assert g.access_p99_ns == pytest.approx(w.access_p99_ns,
                                                    rel=RTOL), g.name
        for f in ("token_p99_ms", "token_mean_ms"):
            assert getattr(g, f) == pytest.approx(getattr(w, f),
                                                  rel=RTOL), (g.name, f)
        np.testing.assert_allclose(g.ipc, w.ipc, rtol=RTOL)
    pick = lambda p: None if p.best is None else p.best.name
    assert pick(got) == pick(want)
    assert got.closest.name == want.closest.name


def test_plan_capacity_des_equals_reference():
    trace = traffic.synthetic_diurnal(n_epochs=2)
    calls = memsim.sim_call_count()
    got = capacity.plan_capacity(("stablelm-1.6b",), trace, **PLAN,
                                 device="cpu")
    assert memsim.sim_call_count() == calls + 1   # one batched DES run
    want = jcap.plan_capacity(("stablelm-1.6b",),
                              jtraffic.synthetic_diurnal(n_epochs=2), **PLAN)
    _assert_plan_close(got, want, exact_p99=True)
    assert got.best is not None
    names = {v.name for v in got.verdicts}
    assert "ddr-baseline" in names and any("+tier" in n for n in names)
    assert any(n.startswith("cxl-dev-") for n in names)


def test_plan_capacity_lut_equals_reference(lut, ref_lut):
    trace = traffic.synthetic_diurnal(n_epochs=2)
    calls = memsim.sim_call_count()
    got = capacity.plan_capacity(("stablelm-1.6b",), trace, **PLAN,
                                 p99_source="lut", lut=lut, device="cpu")
    assert memsim.sim_call_count() == calls       # no DES at all
    want = jcap.plan_capacity(("stablelm-1.6b",),
                              jtraffic.synthetic_diurnal(n_epochs=2), **PLAN,
                              p99_source="lut", lut=ref_lut)
    _assert_plan_close(got, want, exact_p99=False)
    assert got.engine == "lut"


def test_plan_capacity_impossible_slo_and_bad_source(lut, monkeypatch):
    trace = traffic.synthetic_diurnal(n_epochs=1)
    kw = dict(PLAN, slo_p99_ms=1e-6, channels=(2,), tier_splits=(0.0,),
              include_measured=False, peak_util=0.5)
    got = capacity.plan_capacity("stablelm-1.6b", trace, **kw,
                                 p99_source="lut", lut=lut, device="cpu")
    assert got.best is None
    assert got.closest.token_p99_ms == min(v.token_p99_ms
                                           for v in got.verdicts)
    with pytest.raises(ValueError, match="p99_source"):
        capacity.plan_capacity("stablelm-1.6b", trace, **kw,
                               p99_source="formula", device="cpu")
    # More DES devices than the CPU's logical host devices (one unless
    # $REPRO_DES_HOST_DEVICES says more) raise, as the reference's
    # "exceeds".
    monkeypatch.delenv(shardsim.ENV_HOST_DEVICES, raising=False)
    with pytest.raises(ValueError, match="exceeds"):
        capacity.plan_capacity("stablelm-1.6b", trace, **kw, devices=2,
                               device="cpu")


def test_plan_cli_equals_reference(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DES_STEPS", str(LUT_STEPS))
    argv = ["--arch", "stablelm-1.6b", "--slo-p99-ms", "10000", "--trace",
            "synthetic-diurnal", "--batch", "32", "--context", "2048",
            "--channels", "2", "4", "--premium-ns", "30", "--tier-splits",
            "0", "--no-measured"]
    assert plan.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jplan.main(argv) == 0
    want = capsys.readouterr().out
    assert "PICK " in got and "channels=" in got
    assert got == want


def test_plan_cli_miss_exits_one(lut, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DES_STEPS", str(LUT_STEPS))
    rc = plan.main(["--arch", "stablelm-1.6b", "--slo-p99-ms", "1e-6",
                    "--channels", "2", "--premium-ns", "30",
                    "--tier-splits", "0", "--no-measured", "--device",
                    "cpu"])
    assert rc == 1
    assert "NO design meets" in capsys.readouterr().out
