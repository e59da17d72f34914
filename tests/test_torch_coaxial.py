"""The port's ``core/sweepspec``, ``core/coaxial``, ``core/devices`` and
``launch/coaxial_study`` against the JAX reference, on the CPU.

Every grid is solved by both packages from the same spec, and every
``ModelResult`` field, the grid reductions (``geomean_grid``,
``speedup_grid``, ``design_cost_grid``), the Pareto frontier and
``headline()`` are held to the reference at ``RTOL`` 1e-5 relative (the
float32 fixed point agrees within 1.1e-6 measured; see
``tests/test_torch_cpu_model.py``), counts and names exactly.

Not every element settles in the fixed point's 120 damped steps: in the
grids below 1 to 20 (cell, workload) elements of 315 to 3,850 still move
by 1e-3 to 0.24 relative a step (a period-2 or chaotic orbit, in the
reference as in the port; ``default_sweep``, the headline grid, settles
everywhere).  There, the value at step 120 is a point of the oscillation
that rounding alone moves, so such an element is held within its own last
step instead: |port - reference| <= |x(121) - x(120)| + RTOL |reference|,
with x(121) from the port run one step longer (measured: within 0.51 of
a step).  Grid reductions over such cells get the same allowance.  The
paper's anchors (``tests/test_core_repro.py``) are re-run on the port.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from repro.core import coaxial as jc
from repro.core import cpu_model as jm
from repro.core import devices as jd
from repro.core import sweepspec as js
from repro_torch.core import coaxial, cpu_model, devices, hw, sweepspec
from repro_torch.core.workloads import NAMES
from repro_torch.launch import coaxial_study

RTOL = 1e-5


def assert_results_close(got, want, nxt=None):
    """Every ``ModelResult`` field at RTOL; where ``nxt`` (the port one
    fixed-point step further) shows an element still moving by more than
    RTOL, that element within its last step."""
    moving = (np.zeros(want.ipc.shape, bool) if nxt is None else
              np.abs(nxt.ipc - got.ipc) > RTOL * np.abs(got.ipc))
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.shape == w.shape, f.name
        step = 0.0 if nxt is None else np.abs(getattr(nxt, f.name) - g)
        tol = RTOL * np.abs(w) + np.where(moving, step, 0.0)
        both_nan = np.isnan(g) & np.isnan(w)
        bad = ~both_nan & ~(np.abs(g - w) <= tol)
        assert not bad.any(), (f.name, np.argwhere(bad)[:5], g[bad][:5],
                               w[bad][:5])


def one_step_further(solve):
    """``solve()`` with the fixed point run one step longer."""
    fp_iters = cpu_model.FP_ITERS
    cpu_model.FP_ITERS = fp_iters + 1
    try:
        return solve()
    finally:
        cpu_model.FP_ITERS = fp_iters


def assert_grid_close(got, want, nxt):
    """A per-cell grid reduction, each cell within RTOL plus its own last
    step."""
    tol = RTOL * np.abs(want) + np.abs(nxt - got)
    assert (np.abs(got - want) <= tol).all(), np.max(np.abs(got - want) / tol)


def _grid_designs(pkg):
    """``benchmarks/sweep_grid.py``'s designs in either package."""
    return [pkg.DDR_BASELINE] + [
        pkg.MemSystem(f"grid-cxl-{ch}x", dram_channels=ch, links=ch,
                      link_rd_gbps=hw.CXL_X8_RD_GBPS,
                      link_wr_gbps=hw.CXL_X8_WR_GBPS,
                      iface_lat_ns=hw.CXL_LAT_NS, llc_mb_per_core=1.0)
        for ch in range(1, 11)]


# Each spec is built by a function of the package, so both solve it.
SPECS = {
    "sweep_grid": lambda m: m.sweep_spec(
        design=_grid_designs(m), iface_lat_ns=tuple(
            float(x) for x in np.linspace(10.0, 100.0, 10))),
    "links_cross_zero": lambda m: m.sweep_spec(
        design=(m.DDR_BASELINE, m.COAXIAL_4X, m.COAXIAL_ASYM),
        links=(0, 2, 4)),
    "n_active_kappa": lambda m: m.sweep_spec(
        design=(m.DDR_BASELINE, m.COAXIAL_2X, m.COAXIAL_4X),
        n_active=(1, 4, 8, 12), kappa=(1.0, 1.6, 3.2)),
    "eta_mpki": lambda m: m.sweep_spec(
        design=(m.COAXIAL_4X, m.COAXIAL_5X), eta=(0.6, 1.0),
        mpki=(5.0, 20.0, 60.0)),
    "iface_llc_no_baseline": lambda m: m.sweep_spec(
        design=(m.COAXIAL_4X, m.COAXIAL_ASYM), iface_lat_ns=(None, 50.0),
        llc_mb_per_core=(0.5, 2.0)),
}


def _tensor_hashes(obj, prefix="", out=None) -> dict:
    """sha256 (first 12 hex digits) of every tensor in a tree of
    dataclasses, named tuples, dicts and sequences, by path."""
    out = {} if out is None else out
    if torch.is_tensor(obj):
        data = obj.detach().cpu().contiguous().numpy().tobytes()
        out[prefix] = hashlib.sha256(data).hexdigest()[:12]
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensor_hashes(getattr(obj, f.name), f"{prefix}.{f.name}", out)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for name, x in zip(obj._fields, obj):
            _tensor_hashes(x, f"{prefix}.{name}", out)
    elif isinstance(obj, dict):
        for name, x in obj.items():
            _tensor_hashes(x, f"{prefix}[{name}]", out)
    elif isinstance(obj, (list, tuple)):
        for i, x in enumerate(obj):
            _tensor_hashes(x, f"{prefix}[{i}]", out)
    return out


def _solve_fingerprint(inputs, request) -> str:
    """What a failure of the solve comparison reports beside the values:
    a hash of each tensor the port's cell solver was given, the fixed
    point's constants, torch's thread count, and the test files this
    process ran before (pytest drops a finished item's request, so those
    are the items whose ``_request`` is False)."""
    ran = dict.fromkeys(
        item.nodeid.split("::")[0] for item in request.session.items
        if getattr(item, "_request", None) is False)
    return (f"port solve inputs {inputs}; FP_ITERS {cpu_model.FP_ITERS}, "
            f"FP_DAMP {cpu_model.FP_DAMP}; torch threads "
            f"{torch.get_num_threads()}; worker "
            f"{os.environ.get('PYTEST_XDIST_WORKER', 'none')}; test files "
            f"run before in this process: {list(ran)}")


@pytest.mark.parametrize("spec", list(SPECS))
def test_solve_spec_matches_reference(spec, request, monkeypatch):
    inputs = []
    solve_cells = cpu_model._solve_cells

    def recording(*args, **kwargs):
        if not inputs:
            inputs.append(_tensor_hashes((args, kwargs)))
        return solve_cells(*args, **kwargs)
    monkeypatch.setattr(cpu_model, "_solve_cells", recording)
    solve = lambda: coaxial.solve_spec(SPECS[spec](coaxial), device="cpu")
    calls = cpu_model.solve_trace_count()
    got = solve()
    assert cpu_model.solve_trace_count() == calls + 1
    nxt = one_step_further(solve)
    want = jc.solve_spec(SPECS[spec](jc))
    try:
        assert got.axis_names == want.axis_names
        assert [ax.coords for ax in got.axes] == \
            [ax.coords for ax in want.axes]
        assert got.results.ipc.shape == want.results.ipc.shape
        assert_results_close(got.results, want.results, nxt.results)
        assert_grid_close(got.geomean_grid(), want.geomean_grid(),
                          nxt.geomean_grid())
        assert_grid_close(got.speedup_grid(), want.speedup_grid(),
                          one_step_further(nxt.speedup_grid))
        for k, v in want.design_cost_grid().items():
            np.testing.assert_array_equal(got.design_cost_grid()[k], v)
    except AssertionError as err:
        raise AssertionError(
            f"{err}\n{_solve_fingerprint(inputs[0], request)}") from err


def test_default_sweep_settles_everywhere():
    """The headline grid has no element still moving after 120 steps."""
    solve = lambda: coaxial.default_sweep.__wrapped__("cpu")
    got, nxt = solve().results.ipc, one_step_further(solve).results.ipc
    assert (np.abs(nxt - got) <= 1e-6 * got).all()


def test_links_axis_rederives_is_cxl():
    """The latency override reaches CXL designs only: links = 0 makes
    coaxial-4x a DDR design (it keeps its own 30 ns), links > 0 makes the
    baseline a CXL one (it takes the 50 ns)."""
    sw = coaxial.solve_spec(coaxial.sweep_spec(
        design=(coaxial.DDR_BASELINE, coaxial.COAXIAL_4X),
        iface_lat_ns=(50.0,), links=(0, 2)), device="cpu")
    iface = lambda d, n: sw.result(design=d, iface_lat=50.0,
                                   links=n).iface_ns
    np.testing.assert_array_equal(iface("coaxial-4x", 0), 30.0)
    np.testing.assert_array_equal(iface("coaxial-4x", 2), 50.0)
    np.testing.assert_array_equal(iface("ddr-baseline", 0), 0.0)
    np.testing.assert_array_equal(iface("ddr-baseline", 2), 50.0)


def test_default_sweep_and_headline_match_reference():
    sw = coaxial.default_sweep("cpu")
    assert coaxial.default_sweep("cpu") is sw        # cached per device
    assert coaxial.default_sweep(torch.device("cpu")) is sw
    want = jc.default_sweep()
    assert sw.shape == want.shape == (5, 2, 4)
    assert_results_close(sw.results, want.results)
    got_h = coaxial.headline("cpu")
    want_h = jc.headline()
    assert list(got_h) == list(want_h)
    for key, w in want_h.items():
        g = got_h[key]
        if isinstance(w, (int, str)):
            assert g == w, key
        elif isinstance(w, tuple):                   # worst: (name, value)
            assert g[0] == w[0] and g[1] == pytest.approx(w[1], rel=RTOL)
        elif isinstance(w, dict):                    # stream_copy row
            assert list(g) == list(w)
            for k in w:
                assert g[k] == (w[k] if isinstance(w[k], str) else
                                pytest.approx(w[k], rel=RTOL)), k
        else:
            assert g == pytest.approx(w, rel=RTOL), key


def test_headline_rows_of_the_reference_run():
    """The headline rows the reference prints on the CPU, to 4 digits."""
    h = coaxial.headline("cpu")
    for key, val in (("gm_4x", 1.5427), ("gm_2x", 1.3065),
                     ("gm_asym", 1.8117), ("gm_50ns", 1.4432),
                     ("edp_ratio", 0.7244), ("lbm_speedup", 2.7805),
                     ("gm_8core", 1.2754)):
        assert h[key] == pytest.approx(val, abs=5e-5), key
    assert h["gm_1core"] == pytest.approx(0.722, abs=5e-4)
    assert (h["n_above_2x"], h["n_regressions"]) == (12, 4)
    assert h["worst"][0] == "gcc" and h["worst"][1] == pytest.approx(
        0.6670, abs=5e-5)


def test_pareto_and_knee_match_reference():
    spec = lambda m: m.sweep_spec(design=m.all_designs(),
                                  llc_mb_per_core=(0.5, 1.0, 2.0, 4.0))
    solve = lambda: coaxial.solve_spec(spec(coaxial), device="cpu")
    sw = solve()
    ref = jc.solve_spec(spec(jc))
    # Two of its 700 elements have not settled (llc 0.5): the frontier's
    # speedups get the grid's largest last step as allowance.
    slack = np.max(np.abs(one_step_further(
        lambda: solve().speedup_grid()) - sw.speedup_grid()))
    for cost in ("rel_area", "rel_pins"):
        got, want = sw.pareto(cost=cost), ref.pareto(cost=cost)
        assert [(p["design"], p["llc_mb_per_core"]) for p in got] == \
            [(p["design"], p["llc_mb_per_core"]) for p in want]
        for g, w in zip(got, want):
            assert g["geomean_speedup"] == pytest.approx(
                w["geomean_speedup"], rel=RTOL, abs=slack)
            assert (g["rel_area"], g["rel_pins"]) == (w["rel_area"],
                                                      w["rel_pins"])
        k = coaxial.knee_point(got, cost=cost)
        assert k["design"] == jc.knee_point(want, cost=cost)["design"]
    # Pinned coordinates keep costing and comparing the reduced grid.
    sub = sw.sel(llc_mb_per_core=4.0).pareto()
    assert [p["design"] for p in sub] == \
        [p["design"] for p in ref.sel(llc_mb_per_core=4.0).pareto()]
    with pytest.raises(ValueError, match="memsim") as e_port:
        sw.pareto(tail=True)
    with pytest.raises(ValueError) as e_ref:
        ref.pareto(tail=True)
    assert str(e_port.value) == str(e_ref.value)
    assert np.isnan(sw.p99_grid()).all()


def test_sel_comparison_and_result_match_reference():
    sw = coaxial.sweep((coaxial.DDR_BASELINE, coaxial.COAXIAL_4X),
                       iface_lat_grid=(None, 50.0), n_active_grid=(4, 12),
                       device="cpu")
    ref = jc.sweep((jc.DDR_BASELINE, jc.COAXIAL_4X),
                   iface_lat_grid=(None, 50.0), n_active_grid=(4, 12))
    sub = sw.sel(design="coaxial-4x", iface_lat_ns=50)   # tolerant lookup
    assert sub.axis_names == ("n_active",) and sub.results.ipc.shape == (2, 35)
    assert_results_close(sub.results, ref.sel(design="coaxial-4x",
                                              iface_lat_ns=50.0).results)
    # The design's own premium and an equal explicit one are one column.
    assert_results_close(sw.result(coaxial.COAXIAL_4X, iface_lat=30.0),
                         ref.result(jc.COAXIAL_4X))
    got = sw.comparison(coaxial.COAXIAL_4X, iface_lat=50.0, n_active=4)
    want = ref.comparison(jc.COAXIAL_4X, iface_lat=50.0, n_active=4)
    assert got.geomean_speedup == pytest.approx(want.geomean_speedup,
                                                rel=RTOL)
    assert got.summary()["best"][0] == want.summary()["best"][0]
    with pytest.raises(KeyError, match="valid coordinates"):
        sw.sel(iface_lat_ns=70.0)
    with pytest.raises(KeyError, match="no axis"):
        sw.sel(kappa=1.0)


@pytest.mark.parametrize("name,fn", [
    ("evaluate", lambda m, **d: m.evaluate(m.COAXIAL_2X, n_active=8, **d)),
    ("evaluate_ddr_at_50ns", lambda m, **d: m.evaluate(
        m.DDR_BASELINE, iface_lat_ns=50.0, **d)),
    ("sensitivity_latency", lambda m, **d: m.sensitivity_latency(**d)[50.0]),
    ("sensitivity_cores", lambda m, **d: m.sensitivity_cores(**d)[1]),
])
def test_comparisons_match_reference(name, fn):
    got, want = fn(coaxial, device="cpu"), fn(jc)
    assert dataclasses.asdict(got.sys) == dataclasses.asdict(want.sys)
    assert_results_close(got.res, want.res)
    assert_results_close(got.base, want.base)
    assert got.n_regressions == want.n_regressions


def test_area_pin_and_edp_reports_match_reference():
    assert coaxial.area_report() == jc.area_report()
    assert coaxial.pin_report() == jc.pin_report()
    got = coaxial.edp_report(device="cpu")
    want = jc.edp_report()
    for part in ("baseline", "coaxial"):
        assert list(got[part]) == list(want[part])
        for k in want[part]:
            assert got[part][k] == pytest.approx(want[part][k], rel=RTOL), k
    assert got["edp_ratio"] == pytest.approx(want["edp_ratio"], rel=RTOL)
    for a, b in ((2, 4), (np.arange(1, 5), np.array([0, 1, 2, 4]))):
        for k, v in jc.design_cost(a, b, 1.0).items():
            np.testing.assert_array_equal(coaxial.design_cost(a, b, 1.0)[k], v)


# --- sweep specs ---------------------------------------------------------------

def test_spec_lowering_equals_reference():
    spec = lambda m: m.sweep_spec(
        design=(m.DDR_BASELINE, m.COAXIAL_4X), iface_lat_ns=(None, 50.0),
        n_active=(4, 12), links=(0, 4), kappa=(1.0, 2.0))
    got = sweepspec.build_flat(spec(coaxial))
    want = js.build_flat(spec(jc))
    for g, w in zip(got["sysa"], want["sysa"]):
        np.testing.assert_array_equal(g, w)
    for k in ("n_active", "iface_override_ns"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("design_overrides", "workload_overrides"):
        assert list(got[k]) == list(want[k])
        for f in want[k]:
            np.testing.assert_array_equal(got[k][f], want[k][f])
    assert sweepspec.field_bounds(spec(coaxial)) == \
        js.field_bounds(spec(jc))
    assert sweepspec.AXIS_NAMES == js.AXIS_NAMES
    assert spec(coaxial).target == "cpu"


def test_spec_errors_match_reference():
    for kw, err in ((dict(voltage=(1.0,)), ValueError),
                    (dict(kappa=(None,)), ValueError),
                    (dict(kappa=()), ValueError),
                    (dict(queue_model=("fluid",)), ValueError)):
        with pytest.raises(err):
            coaxial.sweep_spec(**kw)
        with pytest.raises(err):
            jc.sweep_spec(**kw)
    with pytest.raises(TypeError, match="MemSystem"):
        coaxial.sweep_spec(design=("coaxial-4x",))
    dup = dataclasses.replace(coaxial.COAXIAL_2X, name="coaxial-4x")
    with pytest.raises(ValueError, match="two different designs"):
        coaxial.solve_spec(coaxial.sweep_spec(
            design=(coaxial.COAXIAL_4X, dup)), device="cpu")


def _flat_lut(wait):
    """A 2-point-per-axis QueueLUT whose every table is ``wait`` ns."""
    t = torch.full((2, 2, 2, 2), float(wait))
    g = lambda a, b: torch.tensor([a, b])
    return coaxial.QueueLUT(g(0.0, 1.0), g(1.0, 4.0), g(1.0, 256.0),
                            g(0.0, 1.0), t, t, t, t)


def test_spec_solve_and_queue_model_axis():
    spec = coaxial.sweep_spec(design=(coaxial.COAXIAL_4X,),
                              queue_model="closed_form")
    sw = spec.solve(device="cpu")
    assert sw.axis_names == ("design", "queue_model")
    assert sw.shape == (2, 1)                     # the baseline prepended
    assert_results_close(sw.sel(queue_model="closed_form").results,
                         jc.sweep((jc.COAXIAL_4X,)).results[:, 0, 0])
    # Both backends: one solver pass each, through the given QueueLUT (a
    # hand-made surface; the memsim solves are held to the reference in
    # tests/test_torch_queuelut.py).
    lut = _flat_lut(wait=30.0)
    calls = cpu_model.solve_trace_count()
    both = coaxial.sweep_spec(
        design=(coaxial.COAXIAL_4X,),
        queue_model=("closed_form", "memsim")).solve(lut=lut, device="cpu")
    memsim = coaxial.sweep((coaxial.COAXIAL_4X,), queue_model="memsim",
                           lut=lut, device="cpu")
    assert cpu_model.solve_trace_count() == calls + 3
    assert both.shape == (2, 2) and both.lut is lut and memsim.lut is lut
    assert_results_close(both.sel(queue_model="closed_form").results,
                         sw.sel(queue_model="closed_form").results)
    assert_results_close(both.sel(queue_model="memsim").results,
                         memsim.results[:, 0, 0])
    assert np.isfinite(memsim.p99_grid()).all()
    assert np.isnan(both.sel(queue_model="closed_form").p99_grid()).all()


# --- registry ------------------------------------------------------------------

def test_design_registry_semantics():
    assert [d.name for d in coaxial.all_designs()] == \
        [d.name for d in jc.all_designs()]
    coaxial.default_sweep("cpu")
    with coaxial.scoped_registry():
        # The same design again: a no-op that keeps the cache warm.
        assert coaxial.register_design(
            dataclasses.replace(coaxial.COAXIAL_4X)) is coaxial.COAXIAL_4X
        assert coaxial.default_sweep.cache_info().currsize >= 1
        other = dataclasses.replace(coaxial.COAXIAL_4X, links=3)
        with pytest.raises(ValueError, match="already registered"):
            coaxial.register_design(other)
        coaxial.register_design(other, overwrite=True)
        assert coaxial.get_design("coaxial-4x") is other
        assert coaxial.default_sweep.cache_info().currsize == 0
        coaxial.default_sweep("cpu")
        coaxial.unregister_design("coaxial-5x")
        with pytest.raises(KeyError, match="unknown design"):
            coaxial.get_design("coaxial-5x")
    # Restored on exit, and the cache cleared because the registry changed.
    assert coaxial.get_design("coaxial-4x") is coaxial.COAXIAL_4X
    assert coaxial.get_design("coaxial-5x") is coaxial.COAXIAL_5X
    assert coaxial.default_sweep.cache_info().currsize == 0
    coaxial.default_sweep("cpu")
    with coaxial.scoped_registry():
        pass                                     # unchanged: cache kept
    assert coaxial.default_sweep.cache_info().currsize >= 1


def test_measured_devices_match_reference():
    assert [dataclasses.asdict(d) for d in devices.MEASURED_DEVICES] == \
        [dataclasses.asdict(d) for d in jd.MEASURED_DEVICES]
    assert devices.MEASURED_NAMES == jd.MEASURED_NAMES
    with coaxial.scoped_registry():
        first = devices.register_measured_devices()
        assert devices.register_measured_devices() == first   # idempotent
        assert [d.name for d in coaxial.all_designs()][-3:] == \
            list(devices.MEASURED_NAMES)
        got = coaxial.evaluate(coaxial.get_design("cxl-dev-b"), device="cpu")
        want = jc.evaluate(jd.MEASURED_DEVICES[1])
        assert got.geomean_speedup == pytest.approx(want.geomean_speedup,
                                                    rel=RTOL)
        devices.unregister_measured_devices()
        devices.unregister_measured_devices()                 # no-op
        assert len(coaxial.all_designs()) == 5


# --- the paper's anchors (tests/test_core_repro.py), on the port -----------------

@pytest.fixture(scope="module")
def c4():
    return coaxial.evaluate(coaxial.COAXIAL_4X, device="cpu")


def _ev(sys, **kw):
    return coaxial.evaluate(sys, device="cpu", **kw)


PAPER_ANCHORS = {
    # Fig 5, §6.1: the main result.
    "geomean_1.52": lambda c4: c4.geomean_speedup == pytest.approx(
        1.52, abs=0.06),
    "lbm_up_to_3x": lambda c4: 2.5 <= float(
        c4.speedup[NAMES.index("lbm")]) <= 3.3,
    "ten_above_2x": lambda c4: 8 <= c4.n_above_2x <= 13,
    "four_regressions_worst_gcc": lambda c4: (
        3 <= c4.n_regressions <= 6 and c4.worst[0] == "gcc"
        and 0.60 <= c4.worst[1] <= 0.80),
    "queue_share_72_91": lambda c4: (
        c4.summary()["queue_share_of_latency"] == pytest.approx(
            0.72, abs=0.05)
        and c4.summary()["max_queue_share"] == pytest.approx(0.91,
                                                             abs=0.03)),
    "queue_reduction": lambda c4: (
        c4.summary()["mean_base_queue_ns"] > 4 * c4.summary()[
            "mean_queue_ns"] and c4.summary()["mean_queue_ns"] < 60.0),
    "stream_copy_case": lambda c4: (
        c4.row("stream-copy")["base_latency_ns"] == pytest.approx(
            348.0, abs=40.0)
        and c4.row("stream-copy")["latency_ns"] == pytest.approx(
            120.0, abs=25.0)
        and c4.row("stream-copy")["speedup"] == pytest.approx(2.9,
                                                              abs=0.4)),
    "utilization_drops": lambda c4: (
        c4.summary()["mean_base_rho"] > 0.45 and c4.summary()["mean_rho"]
        < 0.5 * c4.summary()["mean_base_rho"] + 0.1),
    "baseline_calibration": lambda c4: np.allclose(
        cpu_model.solve(cpu_model.DDR_BASELINE, device="cpu").ipc,
        [w.ipc for w in cpu_model.WORKLOADS], rtol=0.15, atol=0),
    # Fig 7, §6.3: design points.
    "coaxial_2x_1.26": lambda c4: _ev(coaxial.COAXIAL_2X).geomean_speedup
    == pytest.approx(1.26, abs=0.08),
    "coaxial_asym_1.67": lambda c4: _ev(coaxial.COAXIAL_ASYM).geomean_speedup
    == pytest.approx(1.67, abs=0.16),
    "ordering_2x_4x_asym": lambda c4: (
        _ev(coaxial.COAXIAL_2X).geomean_speedup < c4.geomean_speedup
        < _ev(coaxial.COAXIAL_ASYM).geomean_speedup),
    # Fig 8, §6.4: latency sensitivity.
    "50ns_1.33": lambda c4: (
        _ev(coaxial.COAXIAL_4X, iface_lat_ns=50.0).geomean_speedup
        == pytest.approx(1.33, abs=0.12)
        and _ev(coaxial.COAXIAL_4X, iface_lat_ns=50.0).geomean_speedup
        < c4.geomean_speedup),
    "more_regressions_at_50ns": lambda c4: _ev(
        coaxial.COAXIAL_4X, iface_lat_ns=50.0).n_regressions
    >= c4.n_regressions,
    # Fig 9, §6.5: core utilization.
    "single_core_slows_down": lambda c4: (
        0.65 <= _ev(coaxial.COAXIAL_4X, n_active=1).geomean_speedup <= 0.90
        and np.mean(_ev(coaxial.COAXIAL_4X, n_active=1).speedup < 1.0)
        > 0.9),
    "xalancbmk_llc_corner": lambda c4: float(_ev(
        coaxial.COAXIAL_4X, n_active=1).speedup[NAMES.index("xalancbmk")])
    == pytest.approx(1.0, abs=0.05),
    "66pct_utilization": lambda c4: _ev(
        coaxial.COAXIAL_4X, n_active=8).geomean_speedup
    == pytest.approx(1.27, abs=0.08),
    "monotone_in_utilization": lambda c4: all(a < b for a, b in zip(*(
        lambda g: (g, g[1:]))([coaxial.sensitivity_cores(
            device="cpu")[n].geomean_speedup for n in (1, 4, 8, 12)]))),
    # Fig 3, §3.2: variance.
    "fig3_geomeans": lambda c4: [
        v["geomean"] for v in cpu_model.variance_experiment(
            device="cpu").values()] == [pytest.approx(0.86, abs=0.04),
                                        pytest.approx(0.78, abs=0.04),
                                        pytest.approx(0.71, abs=0.05)],
    "fig3_stdevs": lambda c4: np.allclose(
        [v["stdev_ns"] for v in cpu_model.variance_experiment(
            device="cpu").values()], [100.0, 150.0, 200.0], rtol=1e-6),
    # Tables 1-2: pins and area.
    "bw_per_pin_4x": lambda c4: (
        coaxial.pin_report()["bw_per_pin_ratio"] == pytest.approx(
            4.0, abs=0.5)
        and coaxial.pin_report()["bw_per_pin_ratio_duplex"]
        > coaxial.pin_report()["bw_per_pin_ratio"]),
    "table2_areas": lambda c4: (
        coaxial.area_report()["coaxial-5x"]["rel_area"] == pytest.approx(
            1.17, abs=0.01)
        and coaxial.area_report()["coaxial-2x"]["rel_area"]
        == pytest.approx(1.01, abs=0.01)
        and coaxial.area_report()["coaxial-4x"]["rel_area"]
        == pytest.approx(1.01, abs=0.01)
        and coaxial.area_report()["coaxial-5x"]["rel_pins"]
        == pytest.approx(1.0)),
    # Table 5, §6.6: power and EDP.
    "edp_table5": lambda c4: (
        (lambda e: e["baseline"]["total_w"] == pytest.approx(713.0, abs=40.0)
         and e["coaxial"]["total_w"] == pytest.approx(1180.0, abs=90.0)
         and e["edp_ratio"] == pytest.approx(0.72, abs=0.06)
         and e["coaxial"]["cxl_iface_w"] == pytest.approx(77.0, abs=1.0)
         and e["coaxial"]["ddr_mc_phy_w"] == pytest.approx(52.0, abs=1.0))(
            coaxial.edp_report(cmp=c4))),
}


@pytest.mark.parametrize("anchor", list(PAPER_ANCHORS))
def test_paper_anchor_holds_on_the_port(anchor, c4):
    assert PAPER_ANCHORS[anchor](c4)


# --- the study twin ------------------------------------------------------------

def test_coaxial_study_prints_the_reference_rows(capsys):
    got = coaxial_study.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "solving on cpu" in out and "TPU" not in out
    h = jc.headline()
    for key in ("gm_4x", "gm_2x", "gm_asym", "gm_50ns", "edp_ratio",
                "lbm_speedup"):
        assert got[key] == pytest.approx(h[key], rel=RTOL), key
    front = jc.solve_spec(jc.sweep_spec(
        design=jc.all_designs(), llc_mb_per_core=coaxial_study.PARETO_LLC)
    ).pareto(cost="rel_area")
    assert got["pareto_points"] == len(front)
    assert (got["pareto_best"], got["pareto_best_llc"]) == \
        (front[-1]["design"], front[-1]["llc_mb_per_core"])
    g = jm.design_gradient(jm.COAXIAL_4X, coaxial_study.GRADIENT_FIELDS)
    for k, v in g.items():
        assert got[f"grad_{k}"] == pytest.approx(v, rel=RTOL), k
    # The decode-plan line, on the SXM part when the CPU runs it.
    plan = coaxial_study.decode_plan(hw.H100_SXM)
    assert (got["plan_part"], got["plan_n_channels"], got["plan_speedup"]) \
        == ("SXM", plan.n_channels, plan.speedup)
    assert (f"H100 channelized decode (mistral-large 32k): "
            f"{plan.n_channels} KV channels -> {plan.speedup:.1f}x "
            f"predicted") in out


def test_coaxial_study_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        coaxial_study.main([])
