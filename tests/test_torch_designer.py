"""The port's gradient designer (``core/designer`` and ``python -m
repro_torch.designer``) against the JAX reference, on the CPU.

One reference-built default-grid LUT (8,000 steps, the reference's own
designer-test budget) is loaded into the port's ``QueueLUT`` and seeded
into the port's in-process store, so the CLI test reads it too and no
surface is built twice.

* ``projected_ascent`` and ``make_projector`` are host Python in both
  packages: equal trajectories, to the bit.
* ``_objective``'s value and gradient equal ``jax.value_and_grad``'s
  within ``RTOL`` 1e-5 (or ``GRAD_ATOL``) at the frontier knee, an
  interior point and a point on the area-budget surface, with the SLO
  term off and on (violated), and with the harvest duty as a third
  variable on a 5-D LUT.
* ``_verify_optimum`` is one DES run: equal dicts at a fixed point (the
  port's DES equals the reference's bit for bit).
* ``optimize_design`` end to end at 8 iterations: the same start, knee,
  iteration count and ``converged`` flag; the final fields within
  ``FIELD_RTOL`` 1e-5 (each ascent step multiplies a gradient that
  differs in its last bits by ``lr * width**2`` ~ 15, then bisects onto
  the budget surface), ``gm_speedup`` and ``token_p99_ms`` within 1e-5,
  and the verification DES's p99 within one 4-ns bin (its ``rho`` comes
  from the solve, which differs in its last bits).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpu_model as jcm
from repro.core import designer as jd
from repro.core import hw as jhw
from repro.core import queuelut as jq
from repro.core import workloads as jwl
from repro.serving import demand as jdemand
from repro_torch import designer as cli
from repro_torch.core import (coaxial, cpu_model, designer, hw, lutstore,
                              queuelut, workloads)
from repro_torch.serving import demand

LUT_STEPS = 8_000
RTOL = 1e-5
GRAD_ATOL = 1e-8
FIELD_RTOL = 1e-5
BIN_NS = 4.0
ARCH, BATCH, CONTEXT = "stablelm-1.6b", 32, 2048


def port_lut(ref):
    """The reference's tables as the port's QueueLUT."""
    return queuelut.QueueLUT(*(None if x is None else
                               torch.from_numpy(np.array(x)) for x in ref))


def seed_port_store(lut, steps):
    """Put ``lut`` in the port's in-process store under the key of the
    default surface at ``steps``, as ``default_queue_lut`` resolves it
    (port tables equal the reference's bit for bit)."""
    axes, _ = queuelut._grid_axes(
        queuelut.DEFAULT_RHO_GRID, queuelut.DEFAULT_KAPPA_GRID,
        queuelut.DEFAULT_OUTSTANDING_GRID, queuelut.DEFAULT_ETA_GRID, None)
    key = lutstore.store_key(queuelut._store_params(
        axes, None, queuelut.HARVEST_REF_BW_GBPS, steps, 0,
        queuelut.DEFAULT_REPS, queuelut.DEFAULT_ENGINE, None))
    lutstore.cache_put(key, lut)


@pytest.fixture(scope="module")
def ref_lut():
    return jq.default_queue_lut(steps=LUT_STEPS, engine="event")


@pytest.fixture(scope="module")
def lut(ref_lut):
    lut = port_lut(ref_lut)
    seed_port_store(lut, LUT_STEPS)
    return lut


# --- the ascent loop and the projection (host Python) -----------------------

BOX = {"a": (0.0, 6.0), "b": (-2.0, 2.0)}


def _toy_vg(x):
    # Concave quadratic with its unconstrained optimum at (3, 1).
    val = -((x["a"] - 3.0) ** 2) - (x["b"] - 1.0) ** 2
    g = {"a": -2.0 * (x["a"] - 3.0), "b": -2.0 * (x["b"] - 1.0)}
    return (val, {}), g


def test_projected_ascent_toy_problem():
    clip = lambda x, prev: {k: float(np.clip(v, *BOX[k]))
                            for k, v in x.items()}
    kw = dict(widths={"a": 1.0, "b": 1.0}, lr=0.3, iters=100, tol=1e-5)
    got = designer.projected_ascent({"a": 0.5, "b": -1.5}, _toy_vg, clip,
                                    **kw)
    want = jd.projected_ascent({"a": 0.5, "b": -1.5}, _toy_vg, clip, **kw)
    assert got == want
    x, traj, converged = got
    assert converged
    assert x["a"] == pytest.approx(3.0, abs=1e-2)
    assert x["b"] == pytest.approx(1.0, abs=1e-2)
    assert traj[-1]["objective"] >= traj[0]["objective"]


def test_projection_keeps_iterates_inside_budget_box():
    box = {"dram_channels": (1.0, 8.0), "llc_mb_per_core": (0.5, 4.0)}
    budget = 1.1
    vg = lambda x: ((x["dram_channels"] + x["llc_mb_per_core"], {}),
                    {"dram_channels": 1.0, "llc_mb_per_core": 1.0})
    kw = dict(widths={k: hi - lo for k, (lo, hi) in box.items()}, lr=0.5,
              iters=15, tol=1e-6)
    x0 = {"dram_channels": 2.0, "llc_mb_per_core": 1.0}
    got = designer.projected_ascent(
        x0, vg, designer.make_projector(box, budget, float("inf"), 1.0,
                                        0.0), **kw)
    want = jd.projected_ascent(
        x0, vg, jd.make_projector(box, budget, float("inf"), 1.0, 0.0),
        **kw)
    assert got == want
    x, traj, _ = got
    for t in traj:
        for k, (lo, hi) in box.items():
            assert lo - 1e-9 <= t[k] <= hi + 1e-9
        cost = coaxial.design_cost(t["dram_channels"], t["dram_channels"],
                                   t["llc_mb_per_core"])
        assert float(cost["rel_area"]) <= budget + 1e-6
    final = coaxial.design_cost(x["dram_channels"], x["dram_channels"],
                                x["llc_mb_per_core"])
    assert float(final["rel_area"]) == pytest.approx(budget, abs=1e-3)


def test_infeasible_start_refused():
    box = {"dram_channels": (1.0, 8.0), "llc_mb_per_core": (0.5, 4.0)}
    x = {"dram_channels": 8.0, "llc_mb_per_core": 4.0}
    with pytest.raises(ValueError, match="infeasible start") as got:
        designer.make_projector(box, 1.05, float("inf"), 1.0, 0.0)(x, None)
    with pytest.raises(ValueError) as want:
        jd.make_projector(box, 1.05, float("inf"), 1.0, 0.0)(x, None)
    assert str(got.value) == str(want.value)


# --- the objective: value and gradient ---------------------------------------

def _start(harvest_bw=0.0):
    """The knee the default run starts from (designer-cxl-3x at 1 MB)."""
    d = next(d for d in designer._frontier_designs(designer.DEFAULT_CHANNELS)
             if d.name == "designer-cxl-3x")
    return dataclasses.replace(d, harvest_bw_gbps=harvest_bw)


def _mix():
    return tuple(workloads.WORKLOADS) + (demand.llm_workload(
        ARCH, batch=BATCH, context=CONTEXT),)


def _base_ipc(lut):
    """The baseline's IPC under ``lut``, float32, as the port's objective
    solves it: fed to the reference's objective too
    (``test_torch_queuelut.py`` holds the solve itself)."""
    return cpu_model.solve(
        cpu_model.DDR_BASELINE, baseline=cpu_model.DDR_BASELINE,
        workloads=_mix(), queue_model="memsim", lut=lut,
        device="cpu").ipc.astype(np.float32)


def _port_vg(lut, start, x, slo_ms):
    vg = designer.ascent_objective(start, _mix(), lut, arch=ARCH,
                                   batch=BATCH, context=CONTEXT,
                                   slo_ms=slo_ms, device="cpu")
    (value, aux), grad = vg(x)
    return (float(value), {k: float(v) for k, v in aux.items()},
            {k: float(v) for k, v in grad.items()})


def _ref_vg(lut, start, x, slo_ms, base_ipc):
    wls = tuple(jwl.WORKLOADS) + (jdemand.llm_workload(
        ARCH, batch=BATCH, context=CONTEXT),)
    waves, coef = jd._wave_geometry(ARCH, BATCH, CONTEXT)
    j = lambda v: jnp.asarray(float(v))
    slo_s = float("inf") if slo_ms is None else slo_ms * 1e-3
    ref_start = jcm.MemSystem(**dataclasses.asdict(start))
    (value, aux), grad = jd._obj_vg(
        {k: j(v) for k, v in x.items()}, ref_start.as_arrays(), j(1.0),
        jcm._to_jnp(jwl.as_arrays(wls)), jcm.DDR_BASELINE.as_arrays(),
        j(jhw.SIM_CORES), jnp.asarray(base_ipc), lut, j(slo_s), j(waves),
        j(coef), j(jd.DEFAULT_PENALTY))
    return (float(value), {k: float(v) for k, v in aux.items()},
            {k: float(v) for k, v in grad.items()})


#: (channels, LLC MB/core): the knee, an interior point, and a point on
#: the 1.2 area-budget surface (where the default run stops).
POINTS = {"knee": (3.0, 1.0), "interior": (4.6, 1.7),
          "budget_surface": (5.308873882819058, 2.169803683680579)}


def _assert_vg_close(got, want):
    gv, ga, gg = got
    wv, wa, wg = want
    assert gv == pytest.approx(wv, rel=RTOL)
    assert ga.keys() == wa.keys()
    for k in wa:
        assert ga[k] == pytest.approx(wa[k], rel=RTOL), k
    assert gg.keys() == wg.keys()
    for k in wg:
        assert gg[k] == pytest.approx(wg[k], rel=RTOL, abs=GRAD_ATOL), k


@pytest.mark.parametrize("slo_ms", [None, 30.0], ids=["no_slo", "slo"])
@pytest.mark.parametrize("point", sorted(POINTS))
def test_objective_value_and_grad(lut, ref_lut, point, slo_ms):
    ch, llc = POINTS[point]
    x = {"dram_channels": ch, "llc_mb_per_core": llc}
    got = _port_vg(lut, _start(), x, slo_ms)
    want = _ref_vg(ref_lut, _start(), x, slo_ms, _base_ipc(lut))
    _assert_vg_close(got, want)
    value, aux, grad = got
    if slo_ms is not None:       # 30 ms binds: the penalty term is live
        assert aux["token_p99_s"] > slo_ms * 1e-3
        assert value < aux["gm"]
    else:
        assert value == aux["gm"]
    assert grad["dram_channels"] != 0.0


def _luts5(ref_lut):
    """A 5-D surface in both packages: the default tables shrunk along the
    duty axis (a smooth stand-in for a harvest build)."""
    duty = np.asarray(jq.DEFAULT_HARVEST_GRID, np.float32)
    scale = 1.0 - 0.4 * duty
    tabs = [np.asarray(t, np.float32)[..., None] * scale for t in
            (ref_lut.wait_ns, ref_lut.p90_wait_ns, ref_lut.p99_wait_ns,
             ref_lut.sigma_ns)]
    grids = [np.array(g) for g in ref_lut[:4]]
    ref5 = jq.QueueLUT(*(jnp.asarray(g) for g in grids),
                       *(jnp.asarray(t) for t in tabs),
                       harvest_grid=jnp.asarray(duty))
    port5 = queuelut.QueueLUT(*(torch.from_numpy(g) for g in grids),
                              *(torch.from_numpy(t) for t in tabs),
                              harvest_grid=torch.from_numpy(duty))
    return ref5, port5


def test_objective_value_and_grad_harvest(ref_lut):
    """The harvest duty as a third variable."""
    ref5, port5 = _luts5(ref_lut)
    start = _start(harvest_bw=hw.DDR5_CH_BW_GBPS)
    x = {"dram_channels": 4.6, "llc_mb_per_core": 1.7,
         "harvest_duty": 0.3}
    got = _port_vg(port5, start, x, 30.0)
    _assert_vg_close(got, _ref_vg(ref5, start, x, 30.0, _base_ipc(port5)))
    assert got[2]["harvest_duty"] != 0.0


def test_optimize_design_harvest_variable(ref_lut):
    """The ascent with the duty as its third variable stays in the duty's
    box and lends it on the returned design."""
    _, port5 = _luts5(ref_lut)
    res = designer.optimize_design(
        iters=3, lut=port5, harvest_bw_gbps=hw.DDR5_CH_BW_GBPS,
        steps=LUT_STEPS, verify_steps=LUT_STEPS, device="cpu")
    duties = [t["harvest_duty"] for t in res.trajectory]
    assert duties[0] == 0.0
    assert all(0.0 <= d <= float(port5.harvest_grid[-1]) for d in duties)
    assert res.design.harvest_duty == duties[-1] > 0.0
    assert res.design.harvest_bw_gbps == hw.DDR5_CH_BW_GBPS
    assert res.verify["harvest_duty"] == duties[-1]
    assert "harvest duty=" in res.summary()
    with pytest.raises(ValueError, match="harvest axis"):
        designer.optimize_design(iters=1, lut=port_lut(ref_lut),
                                 harvest_bw_gbps=1.0, device="cpu")


# --- the verification DES ----------------------------------------------------

def test_verify_optimum_equals_reference():
    kw = dict(rho=0.6, kappa=1.6, eta=1.0, outstanding=36.0,
              premium_ns=30.0, model_p99_ns=150.0, steps=LUT_STEPS, seed=0)
    got = designer._verify_optimum(**kw, device="cpu")
    want = jd._verify_optimum(**kw)
    assert got == want


# --- end to end --------------------------------------------------------------

def test_optimize_design_end_to_end(lut, ref_lut):
    kw = dict(area_budget=1.2, slo_ms=500.0, iters=8, steps=LUT_STEPS,
              verify_steps=LUT_STEPS)
    before = designer.designer_trace_count()
    got = designer.optimize_design(lut=lut, device="cpu", **kw)
    # One objective evaluation per recorded iterate.
    assert designer.designer_trace_count() - before == len(got.trajectory)
    want = jd.optimize_design(lut=ref_lut, **kw)
    assert dataclasses.asdict(got.start) == dataclasses.asdict(want.start)
    assert got.iters == want.iters and got.converged == want.converged
    assert got.meets_budget and got.meets_slo and got.verify["ok"]
    assert (got.meets_budget, got.meets_slo) == (want.meets_budget,
                                                 want.meets_slo)
    assert [p["design"] for p in got.frontier] == \
        [p["design"] for p in want.frontier]
    for f in ("dram_channels", "links", "llc_mb_per_core", "rel_area",
              "rel_pins"):
        assert float(getattr(got.design, f)) == pytest.approx(
            float(getattr(want.design, f)), rel=FIELD_RTOL), f
    for f in ("gm_speedup", "token_p99_ms", "latency_p99_ns"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=RTOL), f
    assert abs(got.verify["des_p99_ns"] - want.verify["des_p99_ns"]) \
        <= BIN_NS
    assert got.verify["ok"] == want.verify["ok"]


def test_slo_without_arch_refused(lut):
    with pytest.raises(ValueError, match="arch"):
        designer.optimize_design(slo_ms=10.0, arch=None, lut=lut,
                                 device="cpu")


def test_impossible_budget_refused(lut):
    with pytest.raises(ValueError, match="no frontier point fits the "
                       r"budget \(area<=0.5, pins<=inf\); cheapest "
                       "frontier point costs rel_area=0.797, "
                       "rel_pins=0.200"):
        designer.optimize_design(area_budget=0.5, slo_ms=None, arch=None,
                                 lut=lut, device="cpu")


def test_cli_exit_code_and_design_line(lut, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DES_STEPS", str(LUT_STEPS))
    import repro.designer as ref_cli
    rc = cli.main(["--iters", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "verify" in out
    assert ref_cli.main(["--iters", "6"]) == 0
    want = capsys.readouterr().out
    design = lambda s: [ln for ln in s.splitlines()
                        if ln.startswith("DESIGN ")]
    assert design(out) == design(want)
    assert design(out)[0].startswith("DESIGN OK ")


def test_cli_refuses_an_impossible_budget(lut, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DES_STEPS", str(LUT_STEPS))
    rc = cli.main(["--area-budget", "0.5", "--slo-ms", "0", "--device",
                   "cpu"])
    assert rc == 1
    assert "no frontier point" in capsys.readouterr().err


def test_designer_needs_a_card_unless_asked(lut, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        designer.optimize_design(lut=lut, iters=1)
