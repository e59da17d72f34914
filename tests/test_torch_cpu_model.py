"""The port's ``core/cpu_model`` (closed-form backend) against the JAX
reference, on the CPU (the memsim backend: ``tests/test_torch_queuelut.py``).

Both compute the same float32 operations in the same order (the reference
runs without x64); only the libraries' ``pow``/``exp``/``log``/``sqrt`` may
differ in their last bits and XLA may fuse, and the 120-step damped fixed
point carries such differences: measured, every ``ModelResult`` field
agrees within 1.1e-6 relative and every ``design_gradient`` field within
6e-7.  The tests hold them at ``RTOL`` 1e-5; gradient fields that are 0
on both sides (the harvest fields, a link floor that does not bind) at
``GRAD_ATOL``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cpu_model as jm
from repro_torch.core import cpu_model, workloads

RTOL = 1e-5
GRAD_ATOL = 1e-8
DESIGN_NAMES = [d.name for d in jm.DESIGNS]


def _port_design(name):
    return next(d for d in cpu_model.DESIGNS if d.name == name)


def _ref_design(name):
    return next(d for d in jm.DESIGNS if d.name == name)


def assert_results_close(got, want, rtol=RTOL):
    """Every ``ModelResult`` field of the port against the reference."""
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert isinstance(g, np.ndarray) and g.dtype == np.float64, f.name
        assert g.shape == w.shape, f.name
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, equal_nan=True,
                                   err_msg=f.name)


# --- data ------------------------------------------------------------------------

@pytest.mark.parametrize("name", DESIGN_NAMES)
def test_design_point_equals_reference(name):
    assert dataclasses.asdict(_port_design(name)) == \
        dataclasses.asdict(_ref_design(name))
    assert _port_design(name).is_cxl == _ref_design(name).is_cxl


def test_model_constants_equal_reference():
    for k in ("MAX_MLP", "MIN_CPI_EXEC", "ALPHA_LLC", "LLC_FIT_FACTOR",
              "STREAMING_WS_MB", "FP_ITERS", "FP_DAMP", "QUEUE_MODELS",
              "SWEEPABLE_DESIGN_FIELDS", "GRADIENT_FIELDS", "FIG3_WORKLOADS",
              "FIG3_MEAN_NS", "FIG3_DISTS"):
        assert getattr(cpu_model, k) == getattr(jm, k), k
    assert cpu_model.MemSystemArrays._fields == jm.MemSystemArrays._fields
    assert [f.name for f in dataclasses.fields(cpu_model.ModelResult)] == \
        [f.name for f in dataclasses.fields(jm.ModelResult)]


def test_stack_designs_is_the_reference_in_float32():
    got = cpu_model.stack_designs(cpu_model.DESIGNS, device="cpu")
    want = jm.stack_designs(jm.DESIGNS)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (5,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = cpu_model.COAXIAL_ASYM.as_arrays(device="cpu")
    assert all(leaf.shape == () for leaf in one)
    assert float(one.is_cxl) == 1.0 and float(one.dram_channels) == 8.0


# --- solves --------------------------------------------------------------------

@pytest.mark.parametrize("name", DESIGN_NAMES)
def test_solve_matches_reference(name):
    got = cpu_model.solve(_port_design(name), device="cpu")
    want = jm.solve(_ref_design(name))
    assert got.ipc.shape == (35,)
    assert_results_close(got, want)


@pytest.mark.parametrize("kw", [
    dict(n_active=4), dict(iface_lat_ns=50.0), dict(n_active=1,
                                                    iface_lat_ns=80.0)])
def test_solve_options_match_reference(kw):
    """n_active and the latency override (on a CXL design, and on the DDR
    baseline, where solve() applies it too)."""
    for name in ("ddr-baseline", "coaxial-4x"):
        assert_results_close(
            cpu_model.solve(_port_design(name), device="cpu", **kw),
            jm.solve(_ref_design(name), **kw))


def test_solve_against_another_baseline_and_workload_subset():
    wls = workloads.WORKLOADS[:7]
    got = cpu_model.solve(cpu_model.COAXIAL_2X, baseline=cpu_model.COAXIAL_5X,
                          workloads=wls, device="cpu")
    want = jm.solve(jm.COAXIAL_2X, baseline=jm.COAXIAL_5X,
                    workloads=jm.WORKLOADS[:7])
    assert got.ipc.shape == (7,)
    assert_results_close(got, want)


def test_solve_batch_matches_reference_in_one_solver_call():
    grid = dict(n_active_grid=(1, 4, 12), iface_lat_grid=(None, 50.0))
    calls = cpu_model.solve_trace_count()
    got = cpu_model.solve_batch(cpu_model.DESIGNS, device="cpu", **grid)
    assert cpu_model.solve_trace_count() == calls + 1
    want = jm.solve_batch(jm.DESIGNS, **grid)
    assert got.ipc.shape == (5, 2, 3, 35)
    assert_results_close(got, want)
    # The baseline's column ignores the override: equal across latencies.
    np.testing.assert_array_equal(got.ipc[0, 0], got.ipc[0, 1])
    # A cell of the batch is the single-point solve.
    assert_results_close(got[2, 1, 2], cpu_model.solve(
        cpu_model.COAXIAL_4X, iface_lat_ns=50.0, device="cpu"), rtol=1e-7)


def test_closed_form_tail_outputs_are_nan():
    res = cpu_model.solve(cpu_model.COAXIAL_4X, device="cpu")
    assert np.isnan(res.latency_p99_ns).all()
    assert np.isnan(res.cpi_mem_p99).all()
    np.testing.assert_array_equal(res.cpi, 1.0 / res.ipc)


def test_calibrate_matches_reference():
    got = cpu_model.calibrate(workloads.as_arrays(device="cpu"),
                              cpu_model.DDR_BASELINE, n_active=8)
    want = jm.calibrate(jm._to_jnp(jm.as_arrays()), jm.DDR_BASELINE,
                        n_active=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_variance_experiment_matches_reference():
    got = cpu_model.variance_experiment(device="cpu")
    want = jm.variance_experiment()
    assert list(got) == list(want)
    for key in want:
        assert got[key]["stdev_ns"] == want[key]["stdev_ns"]
        assert got[key]["geomean"] == pytest.approx(want[key]["geomean"],
                                                    rel=RTOL)
        assert list(got[key]["per_workload"]) == \
            list(want[key]["per_workload"])
        np.testing.assert_allclose(list(got[key]["per_workload"].values()),
                                   list(want[key]["per_workload"].values()),
                                   rtol=RTOL)


# --- gradients -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["coaxial-4x", "coaxial-asym"])
def test_design_gradient_matches_jax(name):
    got = cpu_model.design_gradient(_port_design(name), device="cpu")
    want = jm.design_gradient(_ref_design(name))
    assert list(got) == list(want) == list(cpu_model.GRADIENT_FIELDS)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    assert got["dram_channels"] > 0 and got["iface_lat_ns"] < 0


def test_design_gradient_field_subset_and_options():
    fields = ("links", "llc_mb_per_core")
    got = cpu_model.design_gradient(cpu_model.COAXIAL_2X, fields,
                                    n_active=8, device="cpu")
    want = jm.design_gradient(jm.COAXIAL_2X, fields, n_active=8)
    assert list(got) == list(fields)
    for k in fields:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=GRAD_ATOL)
    with pytest.raises(ValueError, match="non-differentiable"):
        cpu_model.design_gradient(cpu_model.COAXIAL_4X, ("is_cxl",),
                                  device="cpu")


# --- geomean, backends, devices ----------------------------------------------------

def test_geomean_matches_reference_and_raises_on_non_positive():
    x = np.array([0.5, 1.7, 2.25])
    assert cpu_model.geomean(x) == jm.geomean(x)
    for bad in ([1.0, 0.0], [1.0, -2.0], [np.nan, 1.0]):
        with pytest.raises(ValueError, match="positive inputs"):
            cpu_model.geomean(bad)
    with pytest.raises(ValueError, match="gcc=0"):
        cpu_model.geomean([1.0, 0.0], names=("mcf", "gcc"))


@pytest.mark.parametrize("call", [
    lambda qm: cpu_model.solve(cpu_model.COAXIAL_4X, queue_model=qm,
                               device="cpu"),
    lambda qm: cpu_model.solve_batch(cpu_model.DESIGNS, queue_model=qm,
                                     device="cpu"),
    lambda qm: cpu_model.design_gradient(queue_model=qm, device="cpu"),
    lambda qm: cpu_model.calibrate(workloads.as_arrays(device="cpu"),
                                   cpu_model.DDR_BASELINE, queue_model=qm),
], ids=["solve", "solve_batch", "design_gradient", "calibrate"])
def test_memsim_backend_raises_rather_than_solving(call, monkeypatch):
    """With no ``lut``, the memsim backend resolves the default surface
    (``queuelut.default_queue_lut``; stubbed here to raise, as building it
    is a full-size DES run) before anything is solved; an unknown backend
    raises.  The memsim solves themselves are held to the reference in
    ``tests/test_torch_queuelut.py``."""
    from repro_torch.core import queuelut

    class Resolved(Exception):
        pass

    def default_surface(**kw):
        raise Resolved(kw)

    monkeypatch.setattr(queuelut, "default_queue_lut", default_surface)
    calls = cpu_model.solve_trace_count()
    with pytest.raises(Resolved) as e:
        call("memsim")
    assert e.value.args[0]["device"] in ("cpu", torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown queue_model"):
        call("lindley")
    assert cpu_model.solve_trace_count() == calls


def test_solves_default_to_the_card_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: cpu_model.solve(cpu_model.COAXIAL_4X),
                 lambda: cpu_model.design_gradient(),
                 lambda: cpu_model.variance_experiment()):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
