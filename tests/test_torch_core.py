"""The port's ``core/hw`` and ``core/queueing`` against the JAX reference.

Constants are held equal; every queueing function is held to
``repro.core.queueing`` elementwise in float32 at rtol 1e-6 (a few ulp:
both compute the same float32 operations in the same order, and only the
libraries' ``pow`` may differ in its last bits) over a rho x kappa grid
that includes rho < 0, rho > RHO_MAX and the closed-loop cap's kink.  The
gradients of three of them are held to ``jax.grad`` off the clip and cap
boundaries, and the paper anchors of ``tests/test_core_repro.py`` hold on
the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hw as jhw
from repro.core import queueing as jq
from repro_torch.core import hw, queueing

jax.config.update("jax_platform_name", "cpu")

RTOL = 1e-6
KAPPAS = [1.0, 1.3, 2.2, 3.0]


def _rho_grid():
    rho = np.concatenate([np.linspace(-0.2, 1.2, 57),
                          [0.0, 0.15, 0.5, 0.6, 0.969, 0.97, 0.971]])
    return rho.astype(np.float32)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=RTOL, atol=0)


# --- hw ------------------------------------------------------------------------

PAPER_CONSTANTS = [k for k in vars(jhw) if k.isupper()
                   and not k.startswith("TPU")]


def test_hw_constants_are_the_reference_paper_world_and_the_cards():
    port = {k for k in vars(hw) if k.isupper()}
    assert len(PAPER_CONSTANTS) == 30
    assert port == set(PAPER_CONSTANTS) | {"H100_SXM", "H100_PCIE",
                                            "H100_NVL"}


@pytest.mark.parametrize("name", PAPER_CONSTANTS)
def test_hw_paper_constant_equals_reference(name):
    assert getattr(hw, name) == getattr(jhw, name)
    assert type(getattr(hw, name)) is type(getattr(jhw, name))


def test_hw_has_no_tpu_names():
    assert not [k for k in vars(hw) if "TPU" in k.upper()]


@pytest.mark.parametrize("name,part,bw", [
    ("NVIDIA H100 80GB HBM3", "SXM", 3.35e12),
    ("NVIDIA H100 SXM5 80GB", "SXM", 3.35e12),
    ("NVIDIA H100 PCIe", "PCIe", 2.0e12),
    ("NVIDIA H100 NVL", "NVL", 3.9e12),
])
def test_spec_for_picks_the_part_by_name(name, part, bw):
    spec = hw.spec_for(name)
    assert spec.part == part and spec.hbm_bw == bw
    assert spec.l2_bytes == 50 * 2**20
    # The data sheets order the parts the same way in every rate.
    assert hw.H100_PCIE.hbm_bw < hw.H100_SXM.hbm_bw < hw.H100_NVL.hbm_bw


# --- queueing: values ------------------------------------------------------------

def test_calibration_constants_equal_reference():
    for name in ("AVG_Q_COEF_NS", "P90_Q_COEF_NS", "P90_Q_EXP",
                 "SIGMA_BASE_NS", "SIGMA_Q_COEF", "RHO_MAX"):
        assert getattr(queueing, name) == getattr(jq, name)


@pytest.mark.parametrize("fn", ["queue_wait_ns", "avg_latency_ns",
                                "p90_latency_ns", "_clip_rho"])
def test_rho_functions_match_reference(fn):
    rho = _rho_grid()
    got = getattr(queueing, fn)(torch.from_numpy(rho))
    assert got.dtype == torch.float32
    _close(got, getattr(jq, fn)(jnp.asarray(rho)))


@pytest.mark.parametrize("kappa", KAPPAS)
def test_burst_and_link_waits_match_reference(kappa):
    rho = _rho_grid()
    t, j = torch.from_numpy(rho), jnp.asarray(rho)
    _close(queueing.burst_queue_wait_ns(t, kappa),
           jq.burst_queue_wait_ns(j, kappa))
    _close(queueing.link_queue_wait_ns(t, 2.46, kappa),
           jq.link_queue_wait_ns(j, 2.46, kappa))
    # kappa as an array too, broadcast against rho.
    kt = torch.full_like(t, kappa)
    _close(queueing.burst_queue_wait_ns(t, kt),
           jq.burst_queue_wait_ns(j, jnp.full_like(j, kappa)))


@pytest.mark.parametrize("kappa", KAPPAS)
@pytest.mark.parametrize("eta", [1.0, 0.6])
def test_effective_queue_wait_matches_reference(kappa, eta):
    rho = _rho_grid()
    # Outstanding misses per channel: the default (12 x 16) and a quarter
    # of it, which puts the cap's kink inside the grid.
    for out, bw in ((hw.SIM_CORES * hw.MAX_MLP, hw.DDR5_CH_BW_GBPS),
                    (48.0, 26.0)):
        got = queueing.effective_queue_wait_ns(
            torch.from_numpy(rho), kappa=kappa, eta=eta,
            outstanding_per_channel=out, channel_bw_gbps=bw)
        want = jq.effective_queue_wait_ns(
            jnp.asarray(rho), kappa=kappa, eta=eta,
            outstanding_per_channel=out, channel_bw_gbps=bw)
        _close(got, want)


def test_effective_queue_wait_grid_crosses_the_cap_kink():
    """The grid above has points on both sides of the closed-loop cap."""
    rho = torch.from_numpy(_rho_grid())
    w_open = queueing.burst_queue_wait_ns(rho, 1.0)
    cap = queueing.closed_loop_cap_ns(48.0, 26.0) * rho.clamp(max=1.0)
    assert (w_open < cap).any() and (w_open > cap).any()


def test_closed_loop_cap_and_stdev_match_reference():
    out = np.array([12.0, 48.0, 192.0], np.float32)
    bw = np.array([38.4, 26.0, 13.0], np.float32)
    _close(queueing.closed_loop_cap_ns(torch.from_numpy(out),
                                       torch.from_numpy(bw)),
           jq.closed_loop_cap_ns(jnp.asarray(out), jnp.asarray(bw)))
    _close(queueing.closed_loop_cap_ns(192.0, 38.4),
           jq.closed_loop_cap_ns(192.0, 38.4))
    w = np.linspace(0.0, 400.0, 41).astype(np.float32)
    _close(queueing.stdev_latency_ns(torch.from_numpy(w)),
           jq.stdev_latency_ns(jnp.asarray(w)))
    _close(queueing.stdev_latency_ns(13.0), jq.stdev_latency_ns(13.0))


@pytest.mark.parametrize("kappa", KAPPAS)
def test_closed_form_stats_match_reference(kappa):
    rho = _rho_grid()
    got = queueing.closed_form_stats(torch.from_numpy(rho), kappa=kappa,
                                     cxl_lat_ns=30.0)
    want = jq.closed_form_stats(jnp.asarray(rho), kappa=kappa,
                                cxl_lat_ns=30.0)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])


@pytest.mark.parametrize("rho", [0.0, 0.32, 0.5, 0.97, 1.5, -0.1])
def test_python_floats_match_reference(rho):
    _close(queueing.avg_latency_ns(rho), jq.avg_latency_ns(rho))
    _close(queueing.effective_queue_wait_ns(rho, kappa=2.2, eta=0.7),
           jq.effective_queue_wait_ns(rho, kappa=2.2, eta=0.7))
    for key, val in queueing.closed_form_stats(rho, kappa=1.3).items():
        _close(val, jq.closed_form_stats(rho, kappa=1.3)[key])


# --- queueing: gradients ----------------------------------------------------------

# Off the clip (0, RHO_MAX) and off the cap's kink of the default cap.
GRAD_RHOS = np.array([0.05, 0.2, 0.32, 0.5, 0.6, 0.75, 0.9], np.float32)
GRAD_RTOL = 1e-6


@pytest.mark.parametrize("fn", ["avg_latency_ns", "p90_latency_ns"])
def test_rho_gradients_match_jax(fn):
    rho = torch.from_numpy(GRAD_RHOS).requires_grad_(True)
    getattr(queueing, fn)(rho).sum().backward()
    want = jax.vmap(jax.grad(getattr(jq, fn)))(jnp.asarray(GRAD_RHOS))
    np.testing.assert_allclose(rho.grad.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL)


@pytest.mark.parametrize("kappa", [1.0, 2.2])
def test_effective_queue_wait_gradients_match_jax(kappa):
    """Gradient in rho, kappa and eta, on both sides of the cap."""
    kw = dict(outstanding_per_channel=48.0, channel_bw_gbps=26.0)
    args = [torch.tensor(GRAD_RHOS), torch.full((len(GRAD_RHOS),), kappa),
            torch.full((len(GRAD_RHOS),), 0.8)]
    for a in args:
        a.requires_grad_(True)
    w = queueing.effective_queue_wait_ns(args[0], kappa=args[1],
                                         eta=args[2], **kw)
    w.sum().backward()

    def jf(r, k, e):
        return jq.effective_queue_wait_ns(r, kappa=k, eta=e, **kw)

    want = jax.vmap(jax.grad(jf, argnums=(0, 1, 2)))(
        *(jnp.asarray(a.detach().numpy()) for a in args))
    # Off the kink: the open wait and the cap differ by > 5% everywhere;
    # at kappa 1 both sides occur, at 2.2 the cap binds everywhere.
    open_w = 0.8 * queueing.burst_queue_wait_ns(args[0].detach(), kappa)
    cap = queueing.closed_loop_cap_ns(48.0, 26.0) * \
        (args[0].detach() * kappa).clamp(max=1.0)
    assert ((open_w - cap).abs() > 0.05 * cap).all()
    if kappa == 1.0:
        assert (open_w < cap).any() and (open_w > cap).any()
    for a, g in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_RTOL)


# --- the paper's anchors (tests/test_core_repro.py), on the port ------------

def test_paper_anchors_hold_on_the_port():
    assert float(queueing.avg_latency_ns(0.0)) == pytest.approx(40.0)
    assert float(queueing.avg_latency_ns(0.5)) == pytest.approx(120.0,
                                                                rel=1e-3)
    assert float(queueing.avg_latency_ns(0.6)) == pytest.approx(160.0,
                                                                rel=1e-3)
    assert float(queueing.p90_latency_ns(0.5)) == pytest.approx(
        4.7 * 40.0, rel=0.01)
    assert float(queueing.p90_latency_ns(0.6)) == pytest.approx(
        7.1 * 40.0, rel=0.01)


def test_worked_example_60_to_15_on_the_port():
    """§3.1: 4x bandwidth moves 60% util to 15%; with the 30ns premium
    the average drops ~50% and p90 ~68%."""
    base_avg = float(queueing.avg_latency_ns(0.60))
    base_p90 = float(queueing.p90_latency_ns(0.60))
    cxl_avg = float(queueing.avg_latency_ns(0.15)) + 30.0
    cxl_p90 = float(queueing.p90_latency_ns(0.15)) + 30.0
    assert 1 - cxl_avg / base_avg == pytest.approx(0.50, abs=0.05)
    assert 1 - cxl_p90 / base_p90 == pytest.approx(0.68, abs=0.05)


# --- queueing: gradients at the clip bounds and the cap's kink ----------------

# (rho, kappa): rho at both clip bounds, and rho * kappa == 1 exactly in
# float32 (the closed-loop cap's occupancy bound; at 0.5 x 2 the default
# cap and the open wait also meet).
BOUNDARY_POINTS = [(0.0, 1.3), (jq.RHO_MAX, 1.3), (0.5, 2.0), (0.25, 4.0)]
BOUNDARY_FNS = {
    "queue_wait_ns": lambda m, r, k: m.queue_wait_ns(r),
    "avg_latency_ns": lambda m, r, k: m.avg_latency_ns(r),
    "p90_latency_ns": lambda m, r, k: m.p90_latency_ns(r),
    "_clip_rho": lambda m, r, k: m._clip_rho(r),
    "burst_queue_wait_ns": lambda m, r, k: m.burst_queue_wait_ns(r, k),
    "effective_queue_wait_ns": lambda m, r, k: m.effective_queue_wait_ns(
        r, kappa=k),
    "effective_queue_wait_ns(eta 0.6, cap 48 x 64 B / 26 GB/s)":
        lambda m, r, k: m.effective_queue_wait_ns(
            r, kappa=k, eta=0.6, outstanding_per_channel=48.0,
            channel_bw_gbps=26.0),
    "link_queue_wait_ns": lambda m, r, k: m.link_queue_wait_ns(r, 2.0, k),
    **{f"closed_form_stats[{key}]":
       (lambda key: lambda m, r, k: m.closed_form_stats(
           r, kappa=k, cxl_lat_ns=30.0)[key])(key)
       for key in ("mean_ns", "p90_ns", "stdev_ns")},
}


@pytest.mark.parametrize("rho,kappa", BOUNDARY_POINTS)
@pytest.mark.parametrize("fn", list(BOUNDARY_FNS))
def test_rho_gradients_at_bounds_match_jax(fn, rho, kappa):
    """jnp.clip / jnp.minimum split the gradient 0.5/0.5 at a tie; the
    port must too (torch.clamp passes all of it)."""
    f = BOUNDARY_FNS[fn]
    rho32 = np.float32(rho)
    r = torch.tensor(rho32, requires_grad=True)
    f(queueing, r, kappa).backward()
    want = jax.grad(lambda x: f(jq, x, kappa))(jnp.asarray(rho32))
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL)


def test_clip_bounds_are_never_written():
    """Every ``queueing`` clip shares one cached 0-dim tensor per bound,
    so a write to one would move every later solve in the process.  After
    the study twin on the CPU (the solves, the Pareto frontier and
    ``design_gradient``'s autograd through ``maximum``/``minimum``), and an
    in-place write to a clip's result, each bound the study clips to is
    untouched (``_bound`` hands back its cached tensor)."""
    from repro_torch.core import cpu_model
    from repro_torch.launch import coaxial_study
    coaxial_study.main(["--device", "cpu"])
    x = queueing.clip(torch.tensor([-1.0, 0.5, 2.0]), 0.0, 1.0)
    x.mul_(3.0)
    for value in (0.0, 1.0, 1e-9, queueing.RHO_MAX, cpu_model.MAX_MLP):
        t = queueing._bound(value, torch.float32)
        assert t is queueing._bound(value, torch.float32)
        assert t._version == 0, value
        assert t.item() == torch.tensor(value, dtype=torch.float32).item()
