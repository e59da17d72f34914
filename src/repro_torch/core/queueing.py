"""Load -> latency queuing models for channelized memory (paper §3.1, Fig 2a).

Port of ``repro/core/queueing.py``: the paper's load-latency curve of a
DDR5-4800 channel (Fig 2a), whose anchors it states explicitly:

  * unloaded latency ~= 40 ns;
  * average latency rises 3x at 50% utilization and 4x at 60%;
  * p90 latency rises 4.7x and 7.1x at the same points.

A calibrated M/G/1-style closed form matches the average-latency anchors
exactly,

    L(rho) = 40 + 80 * rho / (1 - rho)          [ns]

and the p90 anchors by

    P90(rho) = 40 + 148 * (rho / (1 - rho))**1.232

which also reproduce the worked example of §3.1 (60% -> 15% utilization
plus a 30 ns CXL premium: ~50% lower average, ~68% lower p90).  On top sit
burstiness (``kappa``), bank/channel balance (``eta``) and the closed-loop
cap of a finite outstanding-miss population; the reference's module note
says why each.

Every function takes tensors of any shape or Python floats (as the
reference's callers pass them), computes in float32 (as JAX does without
x64) and returns float32 tensors; all are differentiable by
``torch.autograd``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import hw

# Calibrated to the paper's Fig 2a anchor points -- do not tune.
AVG_Q_COEF_NS = 80.0
P90_Q_COEF_NS = 148.0
P90_Q_EXP = 1.232

#: Latency-stdev model: a base dispersion from DRAM bank/row state plus a
#: queue-wait-proportional term.  Calibrated against the paper's
#: streamcluster case study (§6.2: baseline mean 69 ns / stdev 88;
#: COAXIAL mean 76 ns / stdev 76).
SIGMA_BASE_NS = 75.0
SIGMA_Q_COEF = 1.0

#: Utilization ceiling -- keeps the open-loop hyperbola finite; the
#: closed-loop cap is what actually binds near saturation.
RHO_MAX = 0.97


def _f32(x) -> torch.Tensor:
    """``x`` as a float32 tensor (a tensor keeps its autograd graph)."""
    return torch.as_tensor(x).to(torch.float32)


def _arg(x):
    """A Python number stays one (JAX's weak type: it meets a float32
    tensor as float32); anything else becomes a float32 tensor."""
    return x if isinstance(x, (int, float)) else _f32(x)


@functools.lru_cache(maxsize=None)
def _bound(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A clip bound as a 0-dim host tensor, which a CUDA kernel takes as
    an argument; made once per value and dtype, outside inference mode so
    that autograd may save it."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype)


def maximum(x, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)`` with its gradient: at a tie torch.maximum
    splits the gradient 0.5/0.5, as JAX does (torch.clamp would pass all
    of it)."""
    return torch.maximum(x, _bound(float(lo), x.dtype))


def minimum(x, hi: float) -> torch.Tensor:
    """``jnp.minimum(x, hi)`` with its gradient (see :func:`maximum`)."""
    return torch.minimum(x, _bound(float(hi), x.dtype))


def clip(x, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``, as JAX
    computes it, gradient at the bounds included."""
    return minimum(maximum(x, lo), hi)


def _clip_rho(rho):
    return clip(_f32(rho), 0.0, RHO_MAX)


def queue_wait_ns(rho):
    """Open-loop average queue wait at utilization ``rho`` (ns)."""
    r = _clip_rho(rho)
    return AVG_Q_COEF_NS * r / (1.0 - r)


def avg_latency_ns(rho):
    """Average loaded access latency of one DDR5-4800 channel (ns)."""
    return hw.DRAM_SERVICE_NS + queue_wait_ns(rho)


def p90_latency_ns(rho):
    """p90 loaded access latency of one DDR5-4800 channel (ns)."""
    r = _clip_rho(rho)
    x = r / (1.0 - r)
    return hw.DRAM_SERVICE_NS + P90_Q_COEF_NS * x**P90_Q_EXP


def burst_queue_wait_ns(rho, kappa=1.0):
    """Queue wait under bursty (MMPP-like) arrivals: ``kappa`` is the
    peak-to-mean arrival-rate ratio, and the mean wait scales with
    ``kappa**2``; ``kappa = 1`` is the calibrated open-loop wait."""
    return _arg(kappa)**2 * queue_wait_ns(rho)


def closed_loop_cap_ns(outstanding_per_channel, channel_bw_gbps):
    """Upper bound on queue wait from a finite outstanding-miss population:
    at most N requests in flight per channel, each a 64 B / BW transfer."""
    t_xfer = hw.CACHE_LINE_B / _arg(channel_bw_gbps)  # ns (B / (GB/s) = ns)
    return _f32(_arg(outstanding_per_channel) * t_xfer)


def effective_queue_wait_ns(
    rho,
    *,
    kappa=1.0,
    eta=1.0,
    outstanding_per_channel=hw.SIM_CORES * hw.MAX_MLP,
    channel_bw_gbps=hw.DDR5_CH_BW_GBPS,
):
    """Queue wait combining burstiness, balance and the closed-loop cap.

    The cap (N * t_transfer) is scaled by the burst occupancy
    min(1, rho * kappa): during a burst the MSHRs are full even if average
    utilization is modest (the paper's bwaves case)."""
    w_open = _arg(eta) * burst_queue_wait_ns(rho, kappa)
    cap = closed_loop_cap_ns(outstanding_per_channel, channel_bw_gbps)
    occupancy = minimum(_f32(_arg(rho) * _arg(kappa)), 1.0)
    return torch.minimum(w_open, cap * occupancy)


def stdev_latency_ns(queue_wait):
    """Latency standard deviation given the average queue wait (ns):
    sigma^2 = sigma_base^2 + (c * W_q)^2."""
    return torch.sqrt(_f32(SIGMA_BASE_NS**2 +
                           (SIGMA_Q_COEF * _arg(queue_wait))**2))


def closed_form_stats(rho, *, kappa=1.0, cxl_lat_ns=0.0) -> dict:
    """The closed-form latency anchors at one operating point (ns): the
    mean / p90 / stdev that the DES is validated against, with the burst
    dispersion ``kappa**2`` on the queueing term and the fixed CXL premium
    ``cxl_lat_ns`` added."""
    wait = burst_queue_wait_ns(rho, kappa)
    r = _clip_rho(rho)
    x = _arg(kappa)**2 * r / (1.0 - r)
    cxl = _arg(cxl_lat_ns)
    return dict(
        mean_ns=hw.DRAM_SERVICE_NS + wait + cxl,
        p90_ns=hw.DRAM_SERVICE_NS + P90_Q_COEF_NS * x**P90_Q_EXP + cxl,
        stdev_ns=stdev_latency_ns(wait),
    )


def link_queue_wait_ns(rho_link, service_ns, kappa=1.0):
    """Queue wait at a serial (CXL/PCIe) link with a given per-request
    service time, M/D/1-like: W = S * rho / (2 * (1 - rho)), with the same
    ``kappa**2`` burst dispersion as the DRAM-side queue."""
    r = _clip_rho(rho_link)
    return _arg(kappa)**2 * _arg(service_ns) * r / (2.0 * (1.0 - r))
