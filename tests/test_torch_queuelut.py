"""The port's QueueLUT lookup and the fixed point's memsim backend against
the JAX reference, on the CPU.

One reference-built LUT (default grids, 6,000 steps, 1 replica, event
engine) is loaded into the port's ``QueueLUT``; a 5-D surface for the
harvest axis is made from random tables in both packages.

* **Lookup**: all four outputs at random, grid-node and out-of-hull
  points within 1e-6 relative, or 4 float32 roundings of the table's
  largest value: the port gathers the 2**d corners of the four tables at
  once and sums them in another order than the reference's corner loop
  (the weights themselves are the reference's products, in its order).
* **Gradients** of every output with respect to every query coordinate
  equal ``jax.jacrev``'s within 1e-5 relative, or 4 float32 roundings of
  the largest corner product |T| * dt/dx on that axis (the sum over
  corners cancels, and its order differs), at off-grid points, at grid
  nodes and on the hull, where both of ``_locate``'s clips tie and JAX
  splits the gradient (``queueing.clip`` does the same).
* **Solves** under ``queue_model="memsim"`` (``solve``, ``solve_batch``,
  ``default_sweep``, the ``queue_model`` axis, ``pareto(tail=True)``,
  ``design_gradient``, ``calibrate``, the harvest branch) within 1e-5 of
  JAX, as the closed-form tests hold them; an element whose fixed point
  has not settled in 120 steps is held within its own last step.
* **Refinement**: ``refine_queue_lut`` with an explicit ``metrics=`` in
  each package gives the reference's history and tables; its default
  metrics, ``headline_metrics``, equal the reference's within 1e-5, and
  ``python -m repro_torch.lut prebuild --refine`` runs the loop.
"""

import dataclasses
import doctest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coaxial as jco
from repro.core import cpu_model as jcm
from repro.core import lutstore as jstore
from repro.core import queuelut as jq
from repro_torch.core import coaxial, cpu_model, hw, lutstore, queuelut

from test_torch_coaxial import assert_results_close, one_step_further

RTOL = 1e-5
LOOKUP_RTOL = 1e-6
EPS32 = 2.0 ** -24
GRAD_ATOL = 1e-8
#: design_gradient's fields on a 4-D LUT (the harvest fields need the
#: harvest axis, in the reference as in the port).
FIELDS_4D = tuple(f for f in cpu_model.GRADIENT_FIELDS
                  if not f.startswith("harvest"))



def ref_lookup(lut, *q):
    """The reference's four lookup outputs, stacked."""
    return jnp.stack(lut.lookup(*q))


def ref_jacobians(lut, points):
    """d (four outputs) / d (each query coordinate) at every point, ``(n,
    d, 4)``: one batched reverse pass over all points."""
    q = tuple(jnp.asarray(np.asarray(points, np.float32).T))
    jac = jax.vmap(jax.jacrev(lambda *x: jnp.stack(lut.lookup(*x)),
                              argnums=tuple(range(len(q)))))(*q)
    return np.stack([np.asarray(j) for j in jac], axis=1)


@pytest.fixture(scope="module")
def ref_lut():
    return jq.build_queue_lut(steps=6_000, reps=1)


@pytest.fixture(scope="module")
def lut(ref_lut):
    """The reference's tables as the port's QueueLUT."""
    return queuelut.QueueLUT(*(None if x is None else
                               torch.from_numpy(np.array(x)) for x in ref_lut))


@pytest.fixture(scope="module")
def luts5():
    """A 5-D surface (default grids x DEFAULT_HARVEST_GRID) of random
    tables, in both packages."""
    grids = (jq.DEFAULT_RHO_GRID, jq.DEFAULT_KAPPA_GRID,
             jq.DEFAULT_OUTSTANDING_GRID, jq.DEFAULT_ETA_GRID)
    shape = tuple(len(g) for g in grids) + (len(jq.DEFAULT_HARVEST_GRID),)
    rng = np.random.default_rng(5)
    tabs = [rng.uniform(0.0, 400.0, shape).astype(np.float32)
            for _ in range(4)]
    g32 = [np.asarray(g, np.float32) for g in
           grids + (jq.DEFAULT_HARVEST_GRID,)]
    ref = jq.QueueLUT(*(jnp.asarray(g) for g in g32[:4]),
                      *(jnp.asarray(t) for t in tabs),
                      harvest_grid=jnp.asarray(g32[4]))
    port = queuelut.QueueLUT(*(torch.from_numpy(g) for g in g32[:4]),
                             *(torch.from_numpy(t) for t in tabs),
                             harvest_grid=torch.from_numpy(g32[4]))
    return ref, port


def _grids(lut):
    g = [lut.rho_grid, lut.kappa_grid, lut.outstanding_grid, lut.eta_grid]
    if lut.harvest_grid is not None:
        g.append(lut.harvest_grid)
    return [np.asarray(x, np.float64) for x in g]


def _tables(lut):
    return [np.asarray(t, np.float64) for t in
            (lut.wait_ns, lut.p90_wait_ns, lut.p99_wait_ns, lut.sigma_ns)]


def _points(kind, grids, n=40, seed=0):
    """(d, n) float32 query coordinates of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        pts = [rng.uniform(g[0], g[-1], n) for g in grids]
        pts[2] = np.exp(rng.uniform(np.log(grids[2][0]),
                                    np.log(grids[2][-1]), n))
    elif kind == "nodes":
        pts = [rng.choice(g, n) for g in grids]
    else:   # beyond the hull on a random side of every axis
        side = rng.integers(0, 2, (len(grids), n))
        pts = [np.where(s, g[-1] * 1.3 + 0.01, g[0] * 0.5 - 0.01)
               for g, s in zip(grids, side)]
        pts[2] = np.where(side[2], grids[2][-1] * 2.0, grids[2][0] * 0.5)
    return np.asarray(pts, np.float32)


def _assert_lookup_close(got, want, lut_np):
    for g, w, t in zip(got, want, _tables(lut_np)):
        g = g.detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, rtol=LOOKUP_RTOL, atol=4 * EPS32 * np.abs(t).max())


@pytest.mark.parametrize("kind", ["random", "nodes", "outside"])
def test_lookup_matches_reference_4d(ref_lut, lut, kind):
    pts = _points(kind, _grids(ref_lut))
    got = lut.lookup(*(torch.from_numpy(p) for p in pts))
    want = ref_lookup(ref_lut, *(jnp.asarray(p) for p in pts))
    _assert_lookup_close(got, want, ref_lut)
    if kind == "nodes":     # a node reads its cell exactly
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["random", "nodes", "outside"])
def test_lookup_matches_reference_5d(luts5, kind):
    ref, port = luts5
    pts = _points(kind, _grids(ref), seed=1)
    got = port.lookup(*(torch.from_numpy(p) for p in pts))
    want = ref_lookup(ref, *(jnp.asarray(p) for p in pts))
    _assert_lookup_close(got, want, ref)


def test_lookup_broadcasts_and_wait_is_the_mean(ref_lut, lut):
    rho = torch.linspace(0.1, 0.9, 7)[:, None]
    kappa = torch.tensor([1.0, 1.5, 3.0])
    outs = lut.lookup(rho, kappa, 24.0)
    assert all(tuple(o.shape) == (7, 3) for o in outs)
    want = ref_lookup(ref_lut, jnp.asarray(rho.numpy()),
                      jnp.asarray(kappa.numpy()), jnp.float32(24.0))
    _assert_lookup_close(outs, want, ref_lut)
    assert torch.equal(lut.wait(rho, kappa, 24.0), outs[0])
    assert torch.equal(lut.wait(0.3, 1.0, 8.0, 1.0, harvest=0.5),
                       lut.wait(0.3, 1.0, 8.0, 1.0))
    laid = lut.tables("cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(laid.lookup(rho, kappa, 24.0), outs))


def _dtdx_max(grids):
    """Per axis, the largest |d t / d x| of the lookup's fraction."""
    out = []
    for a, g in enumerate(grids):
        if a == 2:
            out.append(float(np.max(1.0 / (g[:-1] * np.log(g[1:] / g[:-1])))))
        else:
            out.append(float(np.max(1.0 / np.diff(g))))
    return out


GRAD_POINTS_4D = {
    "off-grid": (0.41, 1.45, 100.0, 0.5),
    "node": (0.35, 1.6, 24.0, 0.6),
    "mixed": (0.74, 2.0, 24.0, 0.45),
    "upper-hull": (0.93, 3.2, 192.0, 1.0),
    "lower-hull": (0.05, 1.0, 2.0, 0.05),
    "outside": (0.99, 0.5, 300.0, 1.5),
}
GRAD_POINTS_5D = {
    "off-grid": (0.41, 1.45, 100.0, 0.5, 0.3),
    "node": (0.35, 1.6, 24.0, 0.6, 0.25),
    "upper-hull": (0.93, 3.2, 192.0, 1.0, 0.75),
    "lower-hull": (0.05, 1.0, 2.0, 0.05, 0.0),
}


@pytest.fixture(scope="module")
def jac4(ref_lut):
    return dict(zip(GRAD_POINTS_4D, ref_jacobians(
        ref_lut, list(GRAD_POINTS_4D.values()))))


@pytest.fixture(scope="module")
def jac5(luts5):
    return dict(zip(GRAD_POINTS_5D, ref_jacobians(
        luts5[0], list(GRAD_POINTS_5D.values()))))


def _assert_grads_match_jax(ref, port, point, want):
    x = [torch.tensor(v, dtype=torch.float32, requires_grad=True)
         for v in point]
    outs = port.lookup(*x)
    got = np.stack([np.asarray([g.item() for g in torch.autograd.grad(
        o, x, retain_graph=True)]) for o in outs], axis=1)   # (d, 4)
    tmax = np.asarray([np.abs(t).max() for t in _tables(ref)])
    atol = 4 * EPS32 * np.outer(_dtdx_max(_grids(ref)), tmax)
    bad = ~(np.abs(got - want) <= atol + RTOL * np.abs(want))
    assert not bad.any(), (point, np.argwhere(bad), got[bad], want[bad],
                           atol[bad])
    return got


@pytest.mark.parametrize("name", list(GRAD_POINTS_4D))
def test_lookup_gradients_match_jax_4d(ref_lut, lut, jac4, name):
    got = _assert_grads_match_jax(ref_lut, lut, GRAD_POINTS_4D[name],
                                  jac4[name])
    if name == "outside":
        assert not got.any()        # clamped: flat outside the hull


@pytest.mark.parametrize("name", list(GRAD_POINTS_5D))
def test_lookup_gradients_match_jax_5d(luts5, jac5, name):
    _assert_grads_match_jax(*luts5, GRAD_POINTS_5D[name], jac5[name])


def test_lookup_gradients_split_at_ties(lut):
    """On the hull both clips tie: JAX's 0.5 x 0.5 of the slope."""
    g = lut.rho_grid.numpy().astype(np.float64)
    tab = lut.wait_ns.numpy().astype(np.float64)
    x = torch.tensor(float(g[-1]), requires_grad=True)
    lut.wait(x, 1.0, 2.0, 0.05).backward()
    slope = (tab[-1, 0, 0, 0] - tab[-2, 0, 0, 0]) / (g[-1] - g[-2])
    assert x.grad.item() == pytest.approx(0.25 * slope, rel=1e-5)


def test_port_docstring_examples_run():
    finder = doctest.DocTestFinder(recurse=False)
    runner = doctest.DocTestRunner(optionflags=doctest.ELLIPSIS)
    for name, obj in (("QueueLUT", queuelut.QueueLUT),
                      ("build_queue_lut", queuelut.build_queue_lut)):
        tests = [t for t in finder.find(obj, name) if t.examples]
        assert tests, name
        for t in tests:
            assert runner.run(t).failed == 0, name


# --- solves ---------------------------------------------------------------------

@pytest.mark.parametrize("name", [d.name for d in cpu_model.DESIGNS])
def test_solve_memsim_matches_reference(ref_lut, lut, name):
    port_sys = next(d for d in cpu_model.DESIGNS if d.name == name)
    ref_sys = next(d for d in jcm.DESIGNS if d.name == name)
    solve = lambda: cpu_model.solve(port_sys, queue_model="memsim",
                                    lut=lut, device="cpu")
    got = solve()
    want = jcm.solve(ref_sys, queue_model="memsim", lut=ref_lut)
    assert_results_close(got, want, one_step_further(solve))
    assert np.isfinite(got.latency_p99_ns).all()
    assert np.isfinite(got.cpi_mem_p99).all()
    assert (got.latency_p99_ns >= got.service_ns).all()


def _full_grid():
    return dict(iface_lat_grid=(None, hw.CXL_LAT_PESSIMISTIC_NS),
                n_active_grid=(1, 4, 8, hw.SIM_CORES))


def test_solve_batch_memsim_matches_reference_in_one_call(ref_lut, lut,
                                                        sweeps):
    calls = cpu_model.solve_trace_count()
    solve = lambda: cpu_model.solve_batch(
        cpu_model.DESIGNS, queue_model="memsim", lut=lut, device="cpu",
        **_full_grid())
    got = solve()
    assert cpu_model.solve_trace_count() == calls + 1
    # The reference's grid is the default sweep's (one compile for both).
    assert_results_close(got, sweeps[1].results, one_step_further(solve))
    one = cpu_model.solve_batch((cpu_model.COAXIAL_4X,), queue_model="memsim",
                                lut=lut, device="cpu")
    assert_results_close(one, jcm.solve_batch(
        (jcm.COAXIAL_4X,), queue_model="memsim", lut=ref_lut))


@pytest.fixture(scope="module")
def sweeps(ref_lut, lut):
    """The default grid under memsim in both packages (the reference's
    ``default_sweep`` grid through ``sweep``), and the port's one step
    further."""
    solve = lambda: coaxial.default_sweep("cpu", queue_model="memsim",
                                          lut=lut)
    want = jco.sweep(iface_lat_grid=(None, hw.CXL_LAT_PESSIMISTIC_NS),
                     n_active_grid=(1, 4, 8, hw.SIM_CORES),
                     queue_model="memsim", lut=ref_lut)
    return solve(), want, one_step_further(solve)


def test_default_sweep_memsim_matches_reference(sweeps):
    got, want, nxt = sweeps
    assert got.queue_model == "memsim" and got.lut is not None
    assert_results_close(got.results, want.results, nxt.results)
    np.testing.assert_allclose(got.p99_grid(), want.p99_grid(), rtol=RTOL)
    c4, w4 = got.comparison(coaxial.COAXIAL_4X), want.comparison(
        jco.COAXIAL_4X)
    assert c4.geomean_speedup == pytest.approx(w4.geomean_speedup,
                                               rel=RTOL)


def test_memsim_default_sweep_is_one_solver_call_and_cached(lut):
    calls = cpu_model.solve_trace_count()
    coaxial.default_sweep("cpu", queue_model="memsim", lut=lut)
    assert cpu_model.solve_trace_count() == calls + 1


def test_pareto_tail_gives_the_reference_frontier(sweeps):
    got, want, _ = sweeps
    for cost in ("rel_area", "rel_pins"):
        g, w = got.pareto(cost=cost, tail=True), want.pareto(cost=cost,
                                                              tail=True)
        key = lambda p: (p["design"], p["iface_lat_ns"], p["n_active"])
        assert [key(p) for p in g] == [key(p) for p in w]
        for a, b in zip(g, w):
            assert a["latency_p99_ns"] == pytest.approx(b["latency_p99_ns"],
                                                        rel=RTOL)
            assert a["geomean_speedup"] == pytest.approx(
                b["geomean_speedup"], rel=RTOL)
        assert {key(p) for p in got.pareto(cost=cost)} <= \
            {key(p) for p in g}


def test_queue_model_axis_gives_a_baseline_per_backend(ref_lut, lut):
    def spec(m):
        return m.sweep_spec(design=m.all_designs(),
                            iface_lat_ns=(None, hw.CXL_LAT_PESSIMISTIC_NS),
                            n_active=(1, 4, 8, hw.SIM_CORES),
                            queue_model=("closed_form", "memsim"))
    calls = cpu_model.solve_trace_count()
    got = coaxial.solve_spec(spec(coaxial), lut=lut, device="cpu")
    assert cpu_model.solve_trace_count() == calls + 2    # one per backend
    want = jco.solve_spec(spec(jco), lut=ref_lut)
    assert got.shape == want.shape
    cf = got.sel(queue_model="closed_form")
    assert np.isnan(cf.p99_grid()).all()
    assert np.isfinite(got.sel(queue_model="memsim").p99_grid()).all()
    np.testing.assert_allclose(got.speedup_grid(), want.speedup_grid(),
                               rtol=RTOL)
    for qm in ("closed_form", "memsim"):
        g = got.comparison(coaxial.COAXIAL_4X, queue_model=qm)
        w = want.comparison(jco.COAXIAL_4X, queue_model=qm)
        assert g.geomean_speedup == pytest.approx(w.geomean_speedup,
                                                  rel=RTOL)
    # The per-backend references differ: memsim is compared to memsim.
    assert not np.allclose(got.sel(queue_model="memsim").speedup_grid(),
                           cf.speedup_grid())
    with pytest.raises(ValueError, match="not both"):
        coaxial.solve_spec(spec(coaxial), queue_model="memsim", lut=lut,
                           device="cpu")


def test_design_gradient_memsim_matches_jax(ref_lut, lut):
    got = cpu_model.design_gradient(cpu_model.COAXIAL_4X, FIELDS_4D,
                                    queue_model="memsim", lut=lut,
                                    device="cpu")
    want = jcm.design_gradient(jcm.COAXIAL_4X, FIELDS_4D,
                               queue_model="memsim", lut=ref_lut)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    assert got["dram_channels"] > 0.0 and got["iface_lat_ns"] < 0.0


def test_calibrate_memsim_matches_reference(ref_lut, lut):
    from repro.core.workloads import as_arrays as j_as_arrays
    from repro_torch.core.workloads import as_arrays
    got = cpu_model.calibrate(as_arrays(device="cpu"),
                              cpu_model.DDR_BASELINE, queue_model="memsim",
                              lut=lut)
    want = jcm.calibrate(jcm._to_jnp(j_as_arrays()), jcm.DDR_BASELINE,
                         queue_model="memsim", lut=ref_lut)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_harvest_branch_matches_reference(luts5):
    """``_latency_terms``'s harvest branch (``duty_eff = duty * bw /
    DDR5_CH_BW_GBPS`` on the 5th axis), at a design that lends and one
    that does not, against the reference's on the same traffic."""
    from repro.core.workloads import as_arrays as j_as_arrays
    from repro_torch.core.workloads import as_arrays
    ref, port = luts5
    lend = dict(harvest_duty=0.4, harvest_bw_gbps=26.0)
    wl, jwl = as_arrays(device="cpu"), jcm._to_jnp(j_as_arrays())
    for sys in (cpu_model.COAXIAL_4X,
                dataclasses.replace(cpu_model.COAXIAL_4X, **lend)):
        jsys = jcm.MemSystem(**dataclasses.asdict(sys))
        read = wl.ipc * 30.0
        got = cpu_model._latency_terms(
            wl, sys.as_arrays(device="cpu"), read, read * wl.wb, 12.0,
            30.0, port.tables("cpu"))
        want = jcm._latency_terms(
            jwl, jsys.as_arrays(), jnp.asarray(read.numpy()),
            jnp.asarray((read * wl.wb).numpy()), 12.0, 30.0, ref)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    # A solve through the 5-D surface: lending moves the waits.
    res = cpu_model.solve_batch(
        (cpu_model.COAXIAL_4X,
         dataclasses.replace(cpu_model.COAXIAL_4X, name="c4-lend", **lend)),
        queue_model="memsim", lut=port, device="cpu")
    assert np.isfinite(res.latency_p99_ns).all()
    assert not np.allclose(res.queue_ns[1], res.queue_ns[0])


def test_harvesting_design_rejects_a_4d_lut(ref_lut, lut):
    lend = dict(harvest_duty=0.4, harvest_bw_gbps=26.0)
    p_sys = dataclasses.replace(cpu_model.COAXIAL_4X, **lend)
    j_sys = dataclasses.replace(jcm.COAXIAL_4X, **lend)
    calls = cpu_model.solve_trace_count()
    for call in (lambda: cpu_model.solve(p_sys, queue_model="memsim",
                                         lut=lut, device="cpu"),
                 lambda: cpu_model.design_gradient(
                     cpu_model.COAXIAL_4X, ("harvest_duty",),
                     queue_model="memsim", lut=lut, device="cpu")):
        with pytest.raises(ValueError, match="no harvest axis") as e_port:
            call()
    with pytest.raises(ValueError) as e_ref:
        jcm.solve(j_sys, queue_model="memsim", lut=ref_lut)
    assert str(e_port.value) == str(e_ref.value)
    assert cpu_model.solve_trace_count() == calls


def test_closed_form_unchanged(lut):
    plain = cpu_model.solve(cpu_model.COAXIAL_4X, device="cpu")
    with_lut = cpu_model.solve(cpu_model.COAXIAL_4X, lut=lut, device="cpu")
    for f in dataclasses.fields(plain):
        assert np.array_equal(getattr(plain, f.name),
                              getattr(with_lut, f.name), equal_nan=True)
    assert np.isnan(plain.latency_p99_ns).all()
    assert np.isnan(plain.cpi_mem_p99).all()
    assert cpu_model.resolve_queue_lut("closed_form", lut) is None
    assert cpu_model.resolve_queue_lut("memsim", lut) is lut
    with pytest.raises(ValueError, match="unknown queue_model"):
        cpu_model.resolve_queue_lut("lindley")


# --- refinement -----------------------------------------------------------------

REFINE = dict(rho=(0.2, 0.6, 0.9), kappa=(1.0, 2.2), outstanding=(4.0, 64.0),
              eta=(0.3, 1.0), steps=4_000, reps=1, max_rounds=2)


def _metrics(cm, to_np):
    """Geomean speedup of coaxial-4x over DDR on memsim through the LUT,
    and (as the second convergence metric) coaxial-4x's worst-workload p99
    latency in ms: two solves of one small grid, cheaper in the reference
    than :func:`headline_metrics`' two solves of the mix with an LLM
    workload."""
    def metrics(lut):
        res = cm.solve_batch((cm.DDR_BASELINE, cm.COAXIAL_4X),
                             queue_model="memsim", lut=lut, **to_np)
        ipc = np.asarray(res.ipc, np.float64)[:, 0, 0]
        p99 = np.asarray(res.latency_p99_ns, np.float64)[1, 0, 0]
        return dict(geomean_speedup=float(np.exp(np.mean(np.log(
            ipc[1] / ipc[0])))), token_p99_ms=float(p99.max()) * 1e-6)
    return metrics


def test_refine_matches_reference(monkeypatch):
    monkeypatch.delenv(lutstore.ENV_VAR, raising=False)
    lutstore.clear_lut_cache()
    jstore.clear_lut_cache()
    got, g_hist = queuelut.refine_queue_lut(
        **REFINE, metrics=_metrics(cpu_model, dict(device="cpu")),
        device="cpu")
    want, w_hist = jq.refine_queue_lut(**REFINE, metrics=_metrics(jcm, {}))
    assert len(g_hist) == len(w_hist) >= 2
    for g, w in zip(g_hist, w_hist):
        for k in ("round", "shape", "cells", "converged"):
            assert g[k] == w[k], k
        for k in ("worst_err", "geomean_speedup", "token_p99_ms"):
            assert g[k] == pytest.approx(w[k], rel=RTOL, abs=1e-9), k
    assert g_hist[-1]["cells"] > g_hist[0]["cells"]     # the grid grew
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b))
    lutstore.clear_lut_cache()
    jstore.clear_lut_cache()


def test_headline_metrics_equal_reference(lut, ref_lut):
    got = queuelut.headline_metrics(lut, device="cpu")
    want = jq.headline_metrics(ref_lut)
    assert got.keys() == want.keys() == {"geomean_speedup", "token_p99_ms"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL), k


def test_lut_cli_prebuild_refine(monkeypatch, capsys):
    from repro_torch import lut as lut_cli
    monkeypatch.delenv(lutstore.ENV_VAR, raising=False)
    lutstore.clear_lut_cache()
    rc = lut_cli.main(["prebuild", "--refine", "--steps", "2000",
                       "--reps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    rounds = [ln for ln in out.splitlines()
              if ln.startswith("refine[event] round ")]
    assert rounds and "gm=" in rounds[0] and "tok99=" in rounds[0]
    assert out.splitlines()[-1] in ("refine[event]: converged",
                                    "refine[event]: round budget exhausted")
    lutstore.clear_lut_cache()
