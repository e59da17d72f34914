"""The port's distribution half of the sweep engine against the reference,
on the CPU: ``sweepspec.distribution_spec`` / ``build_flat_memsim``,
``coaxial.DistributionSweepResult`` and ``distribution_sweep``,
``validate_calibration`` and ``crosscheck_engines``, at small DES budgets
under the histogram gates of ``tests/test_torch_memsim.py``.

Batch widths avoid the reference's trace-count tests' widths (12, 56
lanes), whose jit caches they must find cold.
"""

import doctest

import jax
import numpy as np
import pytest
import torch

from repro.core import coaxial as RC
from repro.core import sweepspec as RS
from repro_torch.core import coaxial as PC
from repro_torch.core import memsim as PM
from repro_torch.core import sweepspec as PS

# The histogram gates (tests/test_torch_memsim.py): quantiles within one
# bin, means within 1e-4 relative.
QUANTILE_TOL_NS = PM.BIN_NS
MEAN_RTOL = 1e-4
# The reference's own tolerances for the §3.1 example
# (tests/test_distribution_sweep.py, test_worked_example_60_to_15_by_des).
EXAMPLE_MEAN_DROP_TOL, EXAMPLE_P90_DROP_TOL = 0.10, 0.08
# Small budgets: the anchors' 8 rhos x 2 replicas.
STEPS, REPS = 16_000, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The suite runs in several worker processes at once: this module's
    torch work keeps to one thread so that it does not crowd the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def assert_stats_close(want, got):
    for q in ("p50_ns", "p90_ns", "p99_ns"):
        assert np.max(np.abs(np.asarray(getattr(want, q)) -
                             np.asarray(getattr(got, q)))) <= QUANTILE_TOL_NS
    np.testing.assert_allclose(got.mean_ns, want.mean_ns, rtol=MEAN_RTOL)
    np.testing.assert_allclose(got.stdev_ns, want.stdev_ns, rtol=MEAN_RTOL)


# ---------------------------------------------------------------------------
# Specs and lowering.
# ---------------------------------------------------------------------------

AXES = [
    dict(rho=(0.2, 0.6)),
    dict(rho=np.linspace(0.1, 0.8, 3), kappa=[1.0, 2.0], cxl_lat_ns=30.0),
    dict(stall_ns=(30.0, 45.0), harvest_duty=(0.0, 0.3), eta=0.7,
         outstanding=(4.0, np.inf)),
]


@pytest.mark.parametrize("axes", AXES)
def test_distribution_spec_and_lowering_equal_reference(axes):
    want, got = RS.distribution_spec(**axes), PS.distribution_spec(**axes)
    assert got.names == want.names and got.shape == want.shape
    assert [ax.values for ax in got.axes] == [ax.values for ax in want.axes]
    assert got.target == want.target == "memsim"
    base = PM.ChannelConfig(rho=0.4, kappa=1.5)
    rbase = RC.ChannelConfig(rho=0.4, kappa=1.5)
    fw = RS.build_flat_memsim(want, base=rbase)
    fg = PS.build_flat_memsim(got, base=base)
    for f in PS.CHANNEL_FIELDS:
        np.testing.assert_array_equal(getattr(fg["cha"], f),
                                      np.asarray(getattr(fw["cha"], f)))
    assert fg["overrides"].keys() == fw["overrides"].keys()
    for k, v in fw["overrides"].items():
        np.testing.assert_array_equal(fg["overrides"][k], v)


@pytest.mark.parametrize("call,match", [
    (lambda m: m.distribution_spec(), "at least one axis"),
    (lambda m: m.distribution_spec(warp=(1.0,)), "unknown distribution"),
    (lambda m: m.distribution_spec(rho=(0.2, None)), "not a channel"),
    (lambda m: m.distribution_spec(rho=()), "no coordinate"),
    (lambda m: m.build_flat_memsim(m.sweep_spec(
        design=(m.cpu_model.DDR_BASELINE,))), "channel-field axes only"),
])
def test_spec_errors_as_reference(call, match):
    with pytest.raises(ValueError, match=match) as want:
        call(RS)
    with pytest.raises(ValueError, match=match) as got:
        call(PS)
    assert str(got.value) == str(want.value)


def test_cpu_target_unchanged():
    spec = PS.sweep_spec(design=(PC.DDR_BASELINE, PC.COAXIAL_4X))
    assert spec.target == "cpu"
    assert PS.KIND_CHANNEL_FIELD == RS.KIND_CHANNEL_FIELD


# ---------------------------------------------------------------------------
# Distribution sweeps.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweeps():
    """The same 3 x 2 x 2 grid (10 replicas a cell, 120 lanes) through the
    reference and the port, by spec.solve and by keywords."""
    axes = dict(rho=(0.2, 0.45, 0.7), kappa=(1.0, 2.0),
                cxl_lat_ns=(0.0, 30.0))
    kw = dict(steps=10_000, seed=5, reps=10)
    with jax.threefry_partitionable(True):
        want = RS.distribution_spec(**axes).solve(**kw)
    got = PS.distribution_spec(**axes).solve(**kw, device="cpu")
    return want, got


def test_sweep_matches_reference(sweeps):
    want, got = sweeps
    assert isinstance(got, PC.DistributionSweepResult)
    assert got.shape == want.shape == (3, 2, 2)
    assert got.axis_names == want.axis_names
    assert (got.steps, got.warmup, got.seed, got.reps, got.engine) == \
        (want.steps, want.warmup, want.seed, want.reps, want.engine)
    assert got.device == "cpu"
    assert_stats_close(want.stats, got.stats)


def test_sel_cell_curve_as_reference(sweeps):
    want, got = sweeps
    # Tolerant numeric coordinates, full and partial selection.
    assert_stats_close(want.sel(rho=0.45, kappa=2, cxl_lat_ns=30.0),
                       got.sel(rho=0.4500000001, kappa=2, cxl_lat_ns=30.0))
    sub_w, sub_g = want.sel(kappa=1.0), got.sel(kappa=1.0)
    assert sub_g.axis_names == sub_w.axis_names == ("rho", "cxl_lat_ns")
    assert_stats_close(sub_w.stats, sub_g.stats)
    one_w = want.sel(rho=0.2, kappa=1.0)
    one_g = got.sel(rho=0.2, kappa=1.0)
    assert_stats_close(one_w.cell(cxl_lat_ns=0.0), one_g.cell(cxl_lat_ns=0.0))
    x_w, y_w = want.curve("rho", "p90_ns", kappa=1.0, cxl_lat_ns=0.0)
    x_g, y_g = got.curve("rho", "p90_ns", kappa=1.0, cxl_lat_ns=0.0)
    np.testing.assert_array_equal(x_g, x_w)
    assert np.max(np.abs(y_g - y_w)) <= QUANTILE_TOL_NS
    cdf_w = want.sel(rho=0.7, kappa=2.0, cxl_lat_ns=0.0).cdf()
    cdf_g = got.sel(rho=0.7, kappa=2.0, cxl_lat_ns=0.0).cdf()
    np.testing.assert_array_equal(cdf_g[0], cdf_w[0])
    np.testing.assert_allclose(cdf_g[1], cdf_w[1], atol=1e-3)


@pytest.mark.parametrize("call", [
    lambda sw: sw.sel(warp=1.0),
    lambda sw: sw.sel(rho=0.33),
    lambda sw: sw.cell(rho=0.2),
    lambda sw: sw.curve("rho"),
    lambda sw: sw.curve("warp"),
])
def test_selection_errors_as_reference(sweeps, call):
    want, got = sweeps
    with pytest.raises(KeyError) as e_w:
        call(want)
    with pytest.raises(KeyError) as e_g:
        call(got)
    assert str(e_g.value) == str(e_w.value)


def test_spec_or_axes_not_both():
    spec = PS.distribution_spec(rho=(0.3,))
    with pytest.raises(TypeError, match="spec OR axis keywords"):
        PC.distribution_sweep(spec, rho=(0.5,), steps=2_000, device="cpu")


def test_port_docstring_example_runs():
    finder = doctest.DocTestFinder(recurse=False)
    tests = [t for t in finder.find(PC.distribution_sweep,
                                    "distribution_sweep") if t.examples]
    assert tests
    runner = doctest.DocTestRunner(optionflags=doctest.ELLIPSIS)
    for t in tests:
        assert runner.run(t).failed == 0


# ---------------------------------------------------------------------------
# The README's DES surfaces.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", PM.ENGINES)
def test_validate_calibration_rows_match_reference(engine):
    kw = dict(steps=STEPS, seed=3, reps=REPS, engine=engine)
    want = RC.validate_calibration(**kw)
    got = PC.validate_calibration(**kw, device="cpu")
    assert len(got["anchors"]) == len(want["anchors"]) == 8
    for a_w, a_g in zip(want["anchors"], got["anchors"]):
        assert a_g["rho"] == a_w["rho"]
        for k in ("closed_mean_ns", "closed_p90_ns", "closed_stdev_ns"):
            assert a_g[k] == pytest.approx(a_w[k], rel=1e-6)
        assert abs(a_g["des_p90_ns"] - a_w["des_p90_ns"]) <= QUANTILE_TOL_NS
        for k in ("des_mean_ns", "des_stdev_ns"):
            assert a_g[k] == pytest.approx(a_w[k], rel=MEAN_RTOL)
    for k in ("mean_tol", "p90_tol", "stdev_tol", "engine", "ok"):
        assert got[k] == want[k]
    assert_stats_close(want["sweep"].stats, got["sweep"].stats)


def test_crosscheck_engines_rows_match_reference():
    kw = dict(steps=STEPS, seed=0, reps=REPS)
    want = RC.crosscheck_engines(**kw)
    got = PC.crosscheck_engines(**kw, device="cpu")
    for a_w, a_g in zip(want["anchors"], got["anchors"]):
        for k in ("timestep_mean_ns", "event_mean_ns"):
            assert a_g[k] == pytest.approx(a_w[k], rel=MEAN_RTOL)
        for k in ("timestep_p90_ns", "event_p90_ns"):
            assert abs(a_g[k] - a_w[k]) <= QUANTILE_TOL_NS
        for k in ("mean_ok", "p90_ok", "ok"):
            assert a_g[k] == a_w[k]
    assert got["ok"] == want["ok"]
    assert set(got["sweeps"]) == set(PM.ENGINES)
    for eng in PM.ENGINES:
        assert_stats_close(want["sweeps"][eng].stats,
                           got["sweeps"][eng].stats)


def test_worked_example_within_reference_tolerances():
    """§3.1 by the DES at a small budget: the port's mean and p90 drops lie
    within the reference test's tolerances of the reference's own."""
    kw = dict(rho=(0.6, 0.15), cxl_lat_ns=(0.0, 30.0), steps=STEPS, seed=3,
              reps=4)

    def drops(sw):
        ddr = sw.sel(rho=0.6, cxl_lat_ns=0.0)
        cxl = sw.sel(rho=0.15, cxl_lat_ns=30.0)
        return (1.0 - float(cxl.mean_ns) / float(ddr.mean_ns),
                1.0 - float(cxl.p90_ns) / float(ddr.p90_ns))

    mean_w, p90_w = drops(RC.distribution_sweep(**kw))
    mean_g, p90_g = drops(PC.distribution_sweep(**kw, device="cpu"))
    assert mean_g == pytest.approx(mean_w, abs=EXAMPLE_MEAN_DROP_TOL)
    assert p90_g == pytest.approx(p90_w, abs=EXAMPLE_P90_DROP_TOL)


def test_memsim_study_main_on_cpu(capsys):
    from repro_torch.launch import memsim_study
    out = memsim_study.main(["--device", "cpu", "--steps", "2000"])
    text = capsys.readouterr().out
    assert "validate_calibration, timestep engine" in text
    assert "crosscheck_engines" in text and "§3.1" in text
    for k in ("timestep_calibration_ok", "event_calibration_ok",
              "crosscheck_ok", "example_mean_drop", "example_p90_drop"):
        assert k in out
    assert all(np.isfinite(v) for v in out.values()
               if isinstance(v, float))
