"""Mechanistic discrete-event simulator of a channelized memory system.

Port of ``repro/core/memsim.py``: request arrivals, FIFO bus queues, DRAM
service and CXL interface delays over an arbitrary batch of channel
configurations, producing full latency *distributions* (mean / p50 / p90
/ p99 / stdev / CDF) -- Fig 2a's load-latency curve, Fig 6b's CDFs and
the §3.1 worked example.  The reference's module note gives the model
(two-state MMPP arrivals, the closed-loop ``outstanding`` admission
bound, the two-slope truncated-Pareto service law, uniform DRAM jitter,
the CXL premium, idle-I/O harvesting) and its two engines:

  * ``engine="timestep"``: a 1-ns time-stepped scan over five uniforms a
    step per lane;
  * ``engine="event"``: the per-request Lindley recursion over arrivals
    drawn by inverting the MMPP's cumulative intensity, with the jitter
    convolved into the histogram.

Each engine runs in two stages per chunk of steps (or requests):

  * STAGE A, the draws and every law that needs transcendental math, is
    vectorized torch ops at the batch's width (:func:`_ts_draws`,
    :func:`_event_arrivals`, ...).  Its randomness is the reference's own:
    :mod:`repro_torch.core.threefry` reproduces ``jax.random``'s
    partitionable Threefry bit for bit, one stream per lane keyed by
    ``fold_in(chunk_key, lane)``, so a lane draws the same uniforms as in
    the reference, at any batch width.  Float cumulative sums are taken in
    XLA's order (:func:`_cumsum0`), so the only difference left is the
    last bit of ``log``/``pow``/``exp``/``log1p``.
  * STAGE B, the sequential recursion and its binning, is one hand kernel
    launch per chunk on the card (``kernels/csrc/memsim_scan.cu``:
    ``memsim_ts_scan`` for the timestep engine's backlog scan,
    ``memsim_event_scan`` for the Lindley scan) and a per-step loop of
    torch ops on the CPU (``kernels/ref.py``).  Both bin into a per-lane
    int32 histogram on the device that persists across a run's chunks,
    where the reference emits ``(chunk, n)`` indices for a host
    ``bincount``.  Stage B is correctly-rounded elementwise arithmetic and
    integer work only, in the reference's order, so kernel and plain
    version agree bit for bit and both equal the reference's
    ``_ts_chunk_core`` / ``_event_chunk_core`` on the same stage-A
    arrays.

The reference counts JAX traces of its chunk kernels (``sim_trace_count``);
PyTorch does not trace, and the scan kernels' launch counters
(``kernels.memsim_scan.KERNELS``) take that count's place: one launch per
chunk; :func:`sim_call_count` counts the calls of :func:`simulate_cells`
(every DES run goes through it), on any device.  Every entry point takes
``device=`` (default ``"cuda"``; with no card it raises) and ``devices``,
the reference's lane sharding: stage B's lanes split over that many
devices of ``device``'s type, one scan launch a shard a chunk
(``core/shardsim``; on the CPU, logical host devices).  Results are
exactly reproducible per ``(engine, seed, budget, N, device)``, whatever
``devices`` is.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hw, shardsim, threefry
from repro_torch.core import xlamath as xm
from repro_torch.core.workloads import resolve_device
from repro_torch.kernels import ops

#: Histogram binning for latency distributions.
BIN_NS = 4.0
N_BINS = 1024         # covers 0 .. 4096 ns

#: DRAM access latency jitter (bank/row-buffer state), uniform half-width.
SERVICE_JITTER_NS = 13.5
#: Fraction of time the MMPP spends in the burst state.
BURST_DUTY = 0.3
#: Mean sojourn time in each MMPP state (ns).
BURST_SOJOURN_NS = 2000.0
#: Controller blocking episodes (the heavy service tail): with probability
#: ``STALL_PROB`` per request the controller blocks for a two-slope
#: power-law duration, slope ``STALL_ALPHA`` from ``STALL_NS`` to
#: ``STALL_BREAK_NS``, then ``STALL_ALPHA2`` out to ``STALL_MAX_NS`` (the
#: reference's note derives them from the paper's Fig-2a closed forms).
STALL_PROB = 0.01923
STALL_NS = 37.0
STALL_ALPHA = 2.138
STALL_BREAK_NS = 353.6
STALL_ALPHA2 = 1.3495
STALL_MAX_NS = 1903.7
#: Floor on the non-penalized per-request service time (ns).
MIN_SERVICE_NS = 0.05

#: Idle-I/O bandwidth harvesting: mean sojourn of each lent / reclaimed
#: window of the harvest modulating chain (ns).
HARVEST_SOJOURN_NS = 2000.0
#: Threefry salt deriving the harvest chain's streams from each chunk /
#: phase key (``fold_in(key, salt)``), so the harvest draws never shift
#: the arrival and service streams.
_HARVEST_SALT = 0x48415256

#: Default warmup fraction: the leading ``steps // WARMUP_DIV`` ns of
#: simulated time are simulated but not recorded (both engines).
WARMUP_DIV = 10

#: The two simulation engines (see module docstring).
ENGINES = ("timestep", "event")

#: Event-engine candidate budget per simulated ns: the candidate-arrival
#: intensity ``-ln(0.7)`` of the rho = 0.5 reference channel.
EVENTS_PER_NS = 0.35667

#: Steps per chunk of the timestep engine: adaptive in the batch width so
#: the chunk's ``chunk x 5 x lanes`` uniforms stay bounded.
_TS_CHUNK_ELEMS = 24_000_000
_TS_CHUNK_MIN, _TS_CHUNK_MAX = 1024, 8192
#: Requests per chunk of the event engine, adaptive the same way.
_EV_CHUNK_ELEMS = 5_000_000
_EV_CHUNK_MIN, _EV_CHUNK_MAX = 1024, 16384


def _ts_chunk_len(n: int) -> int:
    c = _TS_CHUNK_MIN
    while c < _TS_CHUNK_MAX and c * 2 * 5 * n <= _TS_CHUNK_ELEMS:
        c *= 2
    return c


def _event_chunk_len(n: int) -> int:
    c = _EV_CHUNK_MIN
    while c < _EV_CHUNK_MAX and c * 2 * n <= _EV_CHUNK_ELEMS:
        c *= 2
    return c


def canonical_chunk(engine: str) -> int:
    """The width-independent chunk length of the canonical stream contract:
    with ``chunk=canonical_chunk(engine)`` and ``stream_ids``, a cell's
    histogram does not depend on which other cells share the batch."""
    _check_engine(engine)
    return _TS_CHUNK_MIN if engine == "timestep" else _EV_CHUNK_MIN


#: Odd (golden-ratio) constant mixing the replica index into a cell's
#: 32-bit stream id: ``(stream_ids[cell] + rep * MIX) mod 2**32``.
_STREAM_REP_MIX = 0x9E3779B9


def _lane_streams(n: int, reps: int, stream_ids, device="cpu"):
    """Per-lane stream ids (int64, uint32 values) for the flattened
    ``(reps x n)`` batch: the global lane index, or the caller's ids mixed
    with the replica index."""
    if stream_ids is None:
        return torch.arange(n * reps, dtype=torch.int64, device=device)
    sid = np.asarray(stream_ids)
    if sid.shape != (n,):
        raise ValueError(f"stream_ids must have shape ({n},) -- one id "
                         f"per cell; got {sid.shape}")
    sid = sid.astype(np.uint64)
    rep = np.repeat(np.arange(reps, dtype=np.uint64), n)
    mixed = (np.tile(sid, reps) + rep * _STREAM_REP_MIX) & 0xFFFFFFFF
    return torch.from_numpy(mixed.astype(np.int64)).to(device)


#: Event engine: one MMPP sojourn is simulated per this many candidates.
_SOJOURN_DIV = 48


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """One simulated memory channel configuration; every field is
    sweepable (the module-level constants are only defaults).  The
    reference's dataclass documents each field."""

    rho: float
    kappa: float = 1.0
    outstanding: float = float("inf")
    eta: float = 1.0
    t_xfer_ns: float = hw.CACHE_LINE_B / hw.DDR5_CH_BW_GBPS
    service_ns: float = hw.DRAM_SERVICE_NS - 2.0
    cxl_lat_ns: float = 0.0
    burst_duty: float = BURST_DUTY
    burst_sojourn_ns: float = BURST_SOJOURN_NS
    stall_prob: float = STALL_PROB
    stall_ns: float = STALL_NS
    stall_alpha: float = STALL_ALPHA
    stall_break_ns: float = STALL_BREAK_NS
    stall_alpha2: float = STALL_ALPHA2
    stall_max_ns: float = STALL_MAX_NS
    service_jitter_ns: float = SERVICE_JITTER_NS
    harvest_duty: float = 0.0
    harvest_bw_gbps: float = 0.0
    harvest_sojourn_ns: float = HARVEST_SOJOURN_NS


class ChannelArrays(NamedTuple):
    """Per-channel simulation parameters, ``(N,)`` float leaves (numpy
    arrays or float32 tensors): :class:`ChannelConfig` as a structure of
    arrays, one leading cell axis shared by every leaf."""

    rho: torch.Tensor
    kappa: torch.Tensor
    outstanding: torch.Tensor
    eta: torch.Tensor
    t_xfer_ns: torch.Tensor
    service_ns: torch.Tensor
    cxl_lat_ns: torch.Tensor
    burst_duty: torch.Tensor
    burst_sojourn_ns: torch.Tensor
    stall_prob: torch.Tensor
    stall_ns: torch.Tensor
    stall_alpha: torch.Tensor
    stall_break_ns: torch.Tensor
    stall_alpha2: torch.Tensor
    stall_max_ns: torch.Tensor
    service_jitter_ns: torch.Tensor
    harvest_duty: torch.Tensor
    harvest_bw_gbps: torch.Tensor
    harvest_sojourn_ns: torch.Tensor


#: Channel fields a distribution-sweep axis may bind (all of them).
CHANNEL_FIELDS = ChannelArrays._fields


def stack_channels(configs, device="cpu") -> ChannelArrays:
    """Stack :class:`ChannelConfig` façades into ``(N,)`` float32 tensors
    on ``device``."""
    return ChannelArrays(*(
        torch.tensor([float(getattr(c, f)) for c in configs],
                     dtype=torch.float32, device=device)
        for f in CHANNEL_FIELDS))


def _apply_channel_overrides(cha: ChannelArrays, ov) -> ChannelArrays:
    """NaN-masked per-field substitution (NaN = keep the channel's own)."""
    return cha._replace(**{
        f: torch.where(torch.isnan(v), getattr(cha, f), v)
        for f, v in ov.items()})


def _nan_overrides(n: int, device="cpu") -> dict:
    nans = torch.full((n,), float("nan"), dtype=torch.float32, device=device)
    return {f: nans for f in CHANNEL_FIELDS}


def _check_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    return engine




def _host(v) -> np.ndarray:
    """A leaf as a numpy array, wherever it lives."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _pareto_seg(ratio, a):
    """Per-unit-survival mean of one power-law segment,
    ``(1 - ratio**(a-1)) / (a-1)``, with its ``a -> 1`` limit
    ``-log(ratio)`` taken branch-free."""
    d = a - 1.0
    near_one = torch.abs(d) < 1e-4
    safe = torch.where(near_one, 1.0, d)
    return torch.where(near_one, -xm.log(ratio),
                       (1.0 - xm.pow(ratio, safe)) / safe)


def _channel_terms(c: ChannelArrays) -> dict:
    """Derived per-channel quantities shared by both engines: MMPP rates
    and switching probabilities, the two-slope blocking tail, the
    small-service level that keeps E[S] = t_xfer, and the lattice
    candidate intensities of the event engine.  The three ``a * b + c``
    of ``rate_lo``, ``stall_mean`` and ``s_small`` are rounded once, as
    the reference's compiled code contracts them into FMAs.  The logs of
    the blocking law's per-lane constants, which the event engine's
    inverse CDF takes in every chunk, are taken here once a run (the same
    function of the same values, so the same float32 results)."""
    rate_avg = c.rho / c.t_xfer_ns
    rate_hi = torch.clamp(c.kappa * rate_avg, max=0.98)
    rate_lo = torch.clamp(
        xm.fma(-c.burst_duty, rate_hi, rate_avg) / (1.0 - c.burst_duty),
        min=0.0)
    p_leave = 1.0 / c.burst_sojourn_ns
    p_enter = p_leave * c.burst_duty / (1.0 - c.burst_duty)
    sn, xb = c.stall_ns, c.stall_break_ns
    a1, a2, cap = c.stall_alpha, c.stall_alpha2, c.stall_max_ns
    q_b = xm.pow(sn / xb, a1)
    stall_mean = xm.fma(q_b * xb, _pareto_seg(xb / cap, a2),
                        xm.fma(sn, _pareto_seg(sn / xb, a1), sn))
    p_stall = torch.clamp(c.stall_prob * c.eta, 0.0, 0.999)
    s_small = (xm.fma(-p_stall, stall_mean, c.t_xfer_ns) /
               (1.0 - p_stall))
    s_small = torch.clamp(s_small, min=MIN_SERVICE_NS)
    lam_hi = -xm.log1p(-rate_hi)
    lam_lo = -xm.log1p(-rate_lo)
    lam_avg = -xm.log1p(-torch.clamp(rate_avg, max=0.98))
    # log(q_b) = log((sn / xb) ** a1), as the reference's compiled code
    # simplifies it.
    log_qb = a1 * xm.log(sn / xb)
    return dict(rate_avg=rate_avg, rate_hi=rate_hi, rate_lo=rate_lo,
                p_leave=p_leave, p_enter=p_enter, q_b=q_b,
                p_stall=p_stall, s_small=s_small, lam_hi=lam_hi,
                lam_lo=lam_lo, lam_avg=lam_avg, log_qb=log_qb,
                log_p_stall=xm.log(p_stall), log_sn=xm.log(sn),
                log_xb=xm.log(xb))


def _harvest_terms(c: ChannelArrays) -> dict:
    """The harvest chain's per-ns leave / entry probabilities and the work
    shrink while lent, ``base_bw / (base_bw + harvest_bw)`` (exactly 1 at
    ``harvest_bw_gbps = 0``; ``h_enter`` exactly 0 at duty 0)."""
    h_leave = 1.0 / c.harvest_sojourn_ns
    h_enter = h_leave * c.harvest_duty / (1.0 - c.harvest_duty)
    h_scale = 1.0 / (1.0 + c.harvest_bw_gbps * c.t_xfer_ns /
                     hw.CACHE_LINE_B)
    return dict(h_leave=h_leave, h_enter=h_enter, h_scale=h_scale)


def _harvest_active(cha: ChannelArrays, ov) -> bool:
    """True iff any lane has an effective ``harvest_duty > 0`` AND
    ``harvest_bw_gbps > 0``.  Inactive batches skip the harvest draws:
    the chain is a provable no-op there, so the skip changes no value."""
    def eff(field):
        own = _host(getattr(cha, field)).astype(np.float64)
        if field not in ov:
            return own
        o = _host(ov[field]).astype(np.float64)
        return np.where(np.isnan(o), own, o)
    return bool(np.any((eff("harvest_duty") > 0.0)
                       & (eff("harvest_bw_gbps") > 0.0)))


def _scan_terms(c: ChannelArrays, t: dict) -> dict:
    """Per-run channel constants of the stage B scans: MMPP switch / rate
    terms, the admission bound and the deterministic access latency
    ``lat0 = service + pipeline + CXL``."""
    return dict(p_leave=t["p_leave"], p_enter=t["p_enter"],
                rate_hi=t["rate_hi"], rate_lo=t["rate_lo"],
                bound=c.outstanding * c.t_xfer_ns,
                lat0=c.service_ns + 2.0 + c.cxl_lat_ns)


#: Rows of the timestep scan's ``(9, n)`` terms, in the kernel's order.
TS_TERMS = ("p_leave", "p_enter", "rate_hi", "rate_lo", "bound", "lat0",
            "h_leave", "h_enter", "h_scale")
#: Rows of the event scan's ``(2, n)`` terms.
EVENT_TERMS = ("bound", "lat0")


# ---------------------------------------------------------------------------
# Stage A helpers.
# ---------------------------------------------------------------------------

#: Cumulative sum along dim 0 in XLA's order of float additions.
_cumsum0 = xm.cumsum0


# ---------------------------------------------------------------------------
# Timestep engine: the 1-ns reference.
# ---------------------------------------------------------------------------

def _ts_draws(c: ChannelArrays, t: dict, lanes, key, chunk: int):
    """Stage A of the timestep engine: one chunk of per-lane randomness.

    The five uniforms a step per lane (switch / arrival / jitter /
    blocking-or-not / blocking size) from the lane-keyed streams, and the
    laws that need transcendental math: the jitter offset and the
    two-slope service draw.  Returns contiguous ``(chunk, n)`` float32
    ``(switch_u, arrive_u, jitter, svc)``."""
    q_b, s_small, p_stall = t["q_b"], t["s_small"], t["p_stall"]
    sn, xb = c.stall_ns, c.stall_break_ns
    a1, a2, cap = c.stall_alpha, c.stall_alpha2, c.stall_max_ns
    # (5, chunk, n): draw j of step k is element (k, j) of the lane's
    # (chunk, 5) stream, laid out draw-major so each row is contiguous.
    u5 = threefry.lane_uniform(key, lanes, (chunk, 5), dims=(1, 0))
    switch_u, arrive_u, jitter_u, svc_u, size_u = u5.unbind(0)
    jitter = (jitter_u * 2.0 - 1.0) * c.service_jitter_ns
    # Inverse-CDF sample of the two-slope law: the uniform IS the survival
    # value -- above q_b the first slope applies, below it the far tail.
    u = torch.clamp(size_u, min=1e-7)
    stall = torch.where(u > q_b, sn * xm.pow(u, -1.0 / a1),
                        xb * xm.pow(q_b / u, 1.0 / a2))
    stall = torch.minimum(stall, cap)
    svc = torch.where(svc_u < p_stall, stall, s_small)
    return switch_u, arrive_u, jitter, svc


def _ts_harvest_u(lanes, key, chunk: int):
    """Harvest half of timestep stage A: one chunk of per-lane switch
    uniforms for the lent/reclaimed chain, ``(chunk, n)``, from a separate
    salted stream so the five arrival/service uniforms never shift."""
    return threefry.lane_uniform(threefry.fold_in(key, _HARVEST_SALT),
                                 lanes, (chunk,))


def _ts_terms(c: ChannelArrays, t: dict):
    """The timestep scan's ``(9, n)`` terms (rows :data:`TS_TERMS`)."""
    terms = {**_scan_terms(c, t), **_harvest_terms(c)}
    return torch.stack([terms[k] for k in TS_TERMS]).contiguous()


class _Shards:
    """Stage B's lanes split over ``ndev`` devices (``core/shardsim``):
    ``split`` pads a ``(..., n)`` array to the shards' total width with a
    constant and hands each shard its slice on its device; ``merge`` puts
    the shards' histogram rows back in lane order and drops the padding.
    One device is the unsplit batch itself, with no copy."""

    def __init__(self, n: int, ndev: int, device):
        self.n, self.device = n, device
        self.pad = shardsim.pad_width(n, ndev)
        self.parts = shardsim.shards(n + self.pad, ndev, device)

    def split(self, x, value):
        if x is None or (len(self.parts) == 1 and self.pad == 0):
            return [x] * len(self.parts)
        x = shardsim.pad_lanes(x, self.pad, value)
        return [x[..., sl].to(dev).contiguous() for sl, dev in self.parts]

    def hists(self):
        return [torch.zeros((sl.stop - sl.start, N_BINS), dtype=torch.int32,
                            device=dev) for sl, dev in self.parts]

    def merge(self, hists):
        if len(hists) == 1 and self.pad == 0:
            return hists[0]
        return torch.cat([h.to(self.device) for h in hists])[:self.n]


def _run_timestep(c, t, steps, seed, warmup, lanes, chunk, hactive,
                  ndev=1):
    n = lanes.shape[0]
    device = lanes.device
    chunk = _ts_chunk_len(n) if chunk is None else int(chunk)
    n_chunks = -(-steps // chunk)
    ckeys = threefry.split(threefry.prng_key(seed, device), n_chunks)
    sh = _Shards(n, ndev, device)
    terms = sh.split(_ts_terms(c, t), float("nan"))
    n_tot = n + sh.pad
    carry = sh.split(torch.stack([torch.zeros(n_tot), torch.ones(n_tot),
                                  torch.zeros(n_tot)]).to(device),
                     0.0)                          # backlog, in_burst, lent
    hist = sh.hists()
    for k in range(n_chunks):
        sw, au, jit_ns, svc = (sh.split(x, 0.0) for x in
                               _ts_draws(c, t, lanes, ckeys[k], chunk))
        # Unharvested batches pass no harvest draws: the chain then reads
        # zeros, which with h_enter = 0 or h_scale = 1 is value-identical.
        hu = sh.split(_ts_harvest_u(lanes, ckeys[k], chunk)
                      if hactive else None, 0.0)
        # Step j of this chunk is recorded iff warmup <= k*chunk + j < steps.
        t0 = k * chunk
        rec_lo = min(max(warmup - t0, 0), chunk)
        rec_hi = min(max(steps - t0, 0), chunk)
        for i in range(ndev):
            ops.ts_scan(terms[i], carry[i], sw[i], au[i], jit_ns[i], svc[i],
                        hu[i], rec_lo, rec_hi, hist[i])
    return sh.merge(hist)


# ---------------------------------------------------------------------------
# Event engine: per-request Lindley scan.
# ---------------------------------------------------------------------------

def _event_tables(c: ChannelArrays, t: dict, lanes, key, n_sojourns: int):
    """Simulate the MMPP modulating chain once per run (per lane):
    alternating exponential sojourns starting in the burst state.  Returns
    the ``(n, M+1)`` cumulative-intensity rows and the ``(n, M+1, 3)``
    table of (boundary time, cumulative intensity, segment rate); the last
    segment extends to infinity at the average rate."""
    n = lanes.shape[0]
    su = threefry.lane_uniform(key, lanes, (n_sojourns,), minval=1e-12)
    burst = (torch.arange(n_sojourns, device=su.device) % 2 == 0)[:, None]
    # 1 / p_leave and 1 / p_enter as the reference's compiled code
    # simplifies them: 1 / (1 / s) is s, 1 / (a * b / c) is c / (a * b).
    soj = -xm.log(su) * torch.where(
        burst, c.burst_sojourn_ns,
        (1.0 - c.burst_duty) / (t["p_leave"] * c.burst_duty))
    rate_m = torch.where(burst, t["lam_hi"], t["lam_lo"])
    zero = torch.zeros((1, n), device=su.device)
    T0 = torch.cat([zero, _cumsum0(soj)])
    L0 = torch.cat([zero, _cumsum0(rate_m * soj)])
    rate_seg = torch.cat(
        [rate_m, torch.clamp(t["lam_avg"], min=1e-9)[None]])
    Lt = L0.T.contiguous()
    return Lt, torch.stack([T0.T, Lt, rate_seg.T], dim=-1)


def _event_arrivals(c: ChannelArrays, t: dict, state, lanes, key, tabs,
                    warmup_ns, chunk: int):
    """Stage A of the event engine: one chunk of arrivals and services.

    Unit-exponential increments of cumulative intensity, inverted through
    the per-lane piecewise-linear table to continuous arrival times, then
    ceiled onto the 1-ns lattice (same-cell candidates merge); a service
    draw from the two-slope law (selection and size from one uniform).
    Returns the ``(u_last, t_last)`` carry and ``(chunk, n)`` ``gaps``,
    ``svc`` (float32) and ``rec_time`` (bool)."""
    n = lanes.shape[0]
    q_b, s_small, p_stall = t["q_b"], t["s_small"], t["p_stall"]
    a1, a2, cap = c.stall_alpha, c.stall_alpha2, c.stall_max_ns
    Lt, packed = tabs
    m = Lt.shape[1] - 1

    u_last, t_last = state
    u = threefry.lane_uniform(key, lanes, (2, chunk), minval=1e-12)
    lg = xm.log(u)
    # Arrival times: the segment of request k is #{j : L0[j] < U_k} - 1, a
    # staircase in k: the few boundaries are positioned among the sorted
    # requests (one searchsorted per lane) and the staircase recovered by a
    # scatter-add and a cumulative count.
    upos = u_last[None, :] + _cumsum0(-lg[0])                     # (C, n)
    ut = upos.T.contiguous()                                      # (n, C)
    pos = torch.searchsorted(ut, Lt, right=True)                  # (n, M+1)
    cnt = torch.zeros((n, chunk + 1), dtype=torch.int64, device=u.device)
    cnt.scatter_add_(1, pos, torch.ones_like(pos))
    seg = torch.clamp(torch.cumsum(cnt[:, :chunk], dim=1) - 1, 0, m)
    tab = torch.gather(packed, 1, seg[..., None].expand(n, chunk, 3))
    arr_t = torch.ceil(tab[..., 0] + (ut - tab[..., 1]) /
                       torch.clamp(tab[..., 2], min=1e-12)).T     # (C, n)
    gaps = torch.diff(torch.cat([t_last[None, :], arr_t]), dim=0)
    real = gaps > 0.5                  # same-cell candidates merge
    # Service: one uniform for selection AND size, one log + one exp for
    # the two-slope inverse CDF (the slope pick happens in log space).
    us = u[1]
    lu = lg[1] - t["log_p_stall"]
    log_stall = torch.where(us > q_b * p_stall,
                            t["log_sn"] - lu / a1,
                            t["log_xb"] + (t["log_qb"] - lu) / a2)
    svc = torch.where(us < p_stall,
                      torch.minimum(xm.exp(log_stall), cap), s_small)
    svc = torch.where(real, svc, 0.0)  # phantoms add no work
    # Lattice cell k is recorded iff the timestep engine would record step
    # k-1, i.e. past the warmup window (stage B adds the admission test).
    warm = float(np.float32(warmup_ns) + np.float32(0.5))     # float32
    rec_time = real & (arr_t > warm)
    return ((upos[-1], arr_t[-1]), gaps.contiguous(), svc.contiguous(),
            rec_time.contiguous())


def _event_harvest_tabs(c: ChannelArrays, lanes, key, n_windows: int):
    """Simulate the harvest lent/reclaimed chain once per run (per lane):
    alternating exponential sojourns starting in the RECLAIMED state, from
    the salted streams.  Returns ``(n, M)`` cumulative boundary times; an
    arrival's interval is lent iff its index is odd."""
    h = _harvest_terms(c)
    su = threefry.lane_uniform(threefry.fold_in(key, _HARVEST_SALT), lanes,
                               (n_windows,), minval=1e-12)
    lent = (torch.arange(n_windows, device=su.device) % 2 == 1)[:, None]
    soj = -xm.log(su) * torch.where(
        lent, c.harvest_sojourn_ns,
        (1.0 - c.harvest_duty) / (h["h_leave"] * c.harvest_duty))
    return _cumsum0(soj).T.contiguous()


def _event_harvest_scale(svc, gaps, t0, bounds, h_scale):
    """Scale the services that arrive inside lent windows.  Arrival times
    are rebuilt from the gaps: lattice cells are whole float32 integers
    (below 2**24 ns), so any order of summation reproduces them exactly."""
    arr_t = t0[None, :] + torch.cumsum(gaps, dim=0)       # (C, n)
    idx = torch.searchsorted(bounds, arr_t.T.contiguous())
    lent = (idx % 2 == 1).T
    return torch.where(lent, svc * h_scale[None, :], svc).contiguous()


def events_for_steps(steps: int) -> int:
    """Event-engine request budget equivalent to ``steps`` ns of timestep
    budget (see :data:`EVENTS_PER_NS`)."""
    return max(_EV_CHUNK_MIN, int(round(steps * EVENTS_PER_NS)))


def _event_terms(c: ChannelArrays, t: dict):
    """The event scan's ``(2, n)`` terms (rows :data:`EVENT_TERMS`)."""
    terms = _scan_terms(c, t)
    return torch.stack([terms[k] for k in EVENT_TERMS]).contiguous()


def _run_event(c, t, warmup, events, seed, lanes, chunk, hactive, ndev=1):
    n = lanes.shape[0]
    device = lanes.device
    chunk = _event_chunk_len(n) if chunk is None else int(chunk)
    n_chunks = -(-events // chunk)
    n_sojourns = max(64, (n_chunks * chunk) // _SOJOURN_DIV)
    phase_key, chunk_root = threefry.split(threefry.prng_key(seed, device), 2)
    keys = threefry.split(chunk_root, n_chunks)
    tabs = _event_tables(c, t, lanes, phase_key, n_sojourns)
    sh = _Shards(n, ndev, device)
    terms = sh.split(_event_terms(c, t), float("nan"))
    state_a = (torch.zeros(n, device=device), torch.zeros(n, device=device))
    W = sh.split(torch.zeros(n, device=device), 0.0)
    hist = sh.hists()
    if hactive:
        htabs = _event_harvest_tabs(c, lanes, phase_key, n_sojourns)
        h_scale = _harvest_terms(c)["h_scale"]
    for k in range(n_chunks):
        t_prev = state_a[1]
        state_a, gaps, svc, rec_time = _event_arrivals(
            c, t, state_a, lanes, keys[k], tabs, warmup, chunk)
        if hactive:
            svc = _event_harvest_scale(svc, gaps, t_prev, htabs, h_scale)
        gaps, svc, rec_time = (sh.split(gaps, 1.0), sh.split(svc, 0.0),
                               sh.split(rec_time, False))
        for i in range(ndev):
            ops.event_scan(terms[i], W[i], gaps[i], svc[i], rec_time[i],
                           hist[i])
    return sh.merge(hist)


# ---------------------------------------------------------------------------
# Host side: jitter convolution and statistics (numpy, as the reference).
# ---------------------------------------------------------------------------

def _jitter_kernel(width: np.ndarray) -> np.ndarray:
    """Per-lane histogram kernel of the uniform(-w, w) DRAM jitter: tap k
    holds the overlap of bin offset ``[k*BIN - BIN/2, k*BIN + BIN/2)``
    with the jitter support; zero width is the identity kernel."""
    width = np.asarray(width, np.float64)
    taps = int(np.ceil(np.max(width, initial=0.0) / BIN_NS)) + 1
    k = np.arange(-taps, taps + 1, dtype=np.float64)
    wide = width[:, None] >= 1e-9
    w = np.where(wide, width[:, None], 1.0)
    lo = np.maximum(k[None, :] * BIN_NS - BIN_NS / 2, -w)
    hi = np.minimum(k[None, :] * BIN_NS + BIN_NS / 2, w)
    kern = np.maximum(hi - lo, 0.0) / (2.0 * w)
    kern = np.where(wide, kern, (k == 0.0)[None, :])
    return kern


def _convolve_jitter(hist: np.ndarray, width: np.ndarray) -> np.ndarray:
    """Convolve per-lane histograms with their jitter kernels, clamping
    shifted-out mass into the edge bins (mass is conserved exactly)."""
    kern = _jitter_kernel(width)
    taps = (kern.shape[1] - 1) // 2
    out = np.zeros_like(hist, np.float64)
    nb = hist.shape[-1]
    for i, kk in enumerate(range(-taps, taps + 1)):
        w = kern[:, i][:, None]
        if not np.any(w > 0):
            continue
        if kk >= nb:               # shift beyond the span: all mass clamps
            out[:, -1:] += hist.sum(axis=1, keepdims=True) * w
        elif kk <= -nb:
            out[:, :1] += hist.sum(axis=1, keepdims=True) * w
        elif kk >= 0:
            out[:, kk:] += hist[:, :nb - kk] * w
            if kk > 0:
                out[:, -1:] += hist[:, nb - kk:].sum(axis=1, keepdims=True) * w
        else:
            out[:, :kk] += hist[:, -kk:] * w
            out[:, :1] += hist[:, :-kk].sum(axis=1, keepdims=True) * w
    return out


@dataclasses.dataclass
class LatencyStats:
    """Latency-distribution summary; leaves share any leading cell/grid
    shape, with ``hist`` carrying one trailing bin axis."""

    mean_ns: np.ndarray
    stdev_ns: np.ndarray
    p50_ns: np.ndarray
    p90_ns: np.ndarray
    p99_ns: np.ndarray
    hist: np.ndarray            # (..., N_BINS) counts
    bin_ns: float = BIN_NS

    _ARRAY_FIELDS = ("mean_ns", "stdev_ns", "p50_ns", "p90_ns", "p99_ns",
                     "hist")

    def __getitem__(self, idx) -> "LatencyStats":
        """Slice the leading (cell/grid) axes of every leaf identically."""
        return LatencyStats(**{f: getattr(self, f)[idx]
                               for f in self._ARRAY_FIELDS},
                            bin_ns=self.bin_ns)

    def reshape(self, *grid_shape) -> "LatencyStats":
        """Reshape the leading axes; the histogram bin axis stays last."""
        shaped = {f: getattr(self, f).reshape(grid_shape)
                  for f in self._ARRAY_FIELDS if f != "hist"}
        shaped["hist"] = self.hist.reshape(tuple(grid_shape) +
                                           self.hist.shape[-1:])
        return LatencyStats(**shaped, bin_ns=self.bin_ns)

    def cdf(self, i=None) -> tuple[np.ndarray, np.ndarray]:
        """(latency_ns, cdf) arrays for cell ``i`` (Fig 6b); ``i`` may be
        omitted when the stats hold a single cell."""
        h = self.hist if i is None else self.hist[i]
        if h.ndim != 1:
            raise ValueError(
                f"cdf() needs one cell; hist has shape {h.shape} -- "
                f"index a cell or sel() down to one")
        c = np.cumsum(h) / max(h.sum(), 1.0)
        x = (np.arange(h.shape[-1]) + 0.5) * self.bin_ns
        return x, c


def _stats_from_hist(hist: np.ndarray) -> LatencyStats:
    centers = (np.arange(hist.shape[-1]) + 0.5) * BIN_NS
    total = np.maximum(hist.sum(axis=-1, keepdims=True), 1.0)
    p = hist / total
    mean = (p * centers).sum(axis=-1)
    var = (p * (centers - mean[..., None]) ** 2).sum(axis=-1)
    cum = np.cumsum(p, axis=-1)

    def quantile(q):
        idx = np.argmax(cum >= q, axis=-1)
        return (idx + 0.5) * BIN_NS

    return LatencyStats(
        mean_ns=mean, stdev_ns=np.sqrt(var), p50_ns=quantile(0.5),
        p90_ns=quantile(0.9), p99_ns=quantile(0.99), hist=hist)


def default_warmup(steps: int) -> int:
    return steps // WARMUP_DIV


def merge_reps(stats: LatencyStats) -> LatencyStats:
    """Merge a ``keep_reps=True`` result over its leading replica axis;
    counts are integers, so this is exactly the ``keep_reps=False``
    result."""
    return _stats_from_hist(stats.hist.sum(axis=0))


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

#: Calls of :func:`simulate_cells` so far (see :func:`sim_call_count`).
_SIM_CALLS = [0]


def sim_call_count() -> int:
    """Calls of :func:`simulate_cells` so far, on any device: what a warm
    QueueLUT store read must leave flat (the reference counts its chunk
    kernels' traces for the same purpose)."""
    return _SIM_CALLS[0]


def simulate_cells(cha: ChannelArrays, *, overrides=None,
                   steps: int = 200_000, seed: int = 0,
                   warmup: int | None = None, reps: int = 1,
                   engine: str = "timestep", events: int | None = None,
                   devices=None, keep_reps: bool = False,
                   stream_ids=None, chunk: int | None = None,
                   device="cuda") -> LatencyStats:
    """Simulate N flattened cells in one batch on ``device``.

    ``cha`` leaves are ``(N,)`` (numpy arrays or tensors); ``overrides``
    maps channel fields to ``(N,)`` arrays with NaN meaning "keep the
    channel's own value".  ``steps`` is the simulated-time budget in ns
    for either engine; ``engine="event"`` converts it to a request budget
    (:func:`events_for_steps`) unless ``events`` pins one.  ``warmup`` ns
    (default ``steps // 10``) are not recorded.  ``reps`` replicas of
    every cell run in the same batch and are merged, or kept on a leading
    axis with ``keep_reps=True``.  ``stream_ids`` (``(N,)`` uint32) keys
    each lane's streams by the caller's id and ``chunk`` pins the chunk
    schedule (:func:`canonical_chunk`), which together make a cell's
    histogram independent of the other cells in the batch.  ``devices``
    splits the flattened ``(cells x reps)`` lanes of stage B over that
    many devices of ``device``'s type (``None`` consults
    ``$REPRO_DES_DEVICES``, default 1; ``"auto"`` uses all of them;
    ``core/shardsim``); the histograms are bit-identical at any count.
    """
    _check_engine(engine)
    n = int(np.shape(cha.rho)[0])
    reps = int(reps)
    if reps < 1:
        raise ValueError(f"reps must be >= 1; got {reps}")
    warmup = default_warmup(steps) if warmup is None else int(warmup)
    if not 0 <= warmup < steps:
        raise ValueError(f"warmup must be in [0, steps); got {warmup} "
                         f"with steps={steps}")
    if events is not None and engine != "event":
        raise ValueError("events is an event-engine budget; use steps "
                         "for the timestep engine")
    device = resolve_device(device)
    ndev = shardsim.resolve_devices(devices, device)
    _SIM_CALLS[0] += 1

    def tile(v):
        return np.tile(_host(v).astype(np.float32), reps)

    ov_host = {f: tile(v) for f, v in (overrides or {}).items()}
    cha_host = ChannelArrays(*(tile(leaf) for leaf in cha))
    lanes = _lane_streams(n, reps, stream_ids, device)
    if chunk is not None and int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    n_real = n * reps
    ov = _nan_overrides(n_real, device)
    ov.update({f: torch.from_numpy(v).to(device)
               for f, v in ov_host.items()})
    c = _apply_channel_overrides(ChannelArrays(*(
        torch.from_numpy(v).to(device) for v in cha_host)), ov)
    hactive = _harvest_active(cha_host, ov_host)
    t = _channel_terms(c)
    if engine == "timestep":
        hist = _host(_run_timestep(c, t, int(steps), seed, warmup, lanes,
                                   chunk, hactive, ndev)).astype(np.float64)
    else:
        events = (events_for_steps(steps) if events is None
                  else max(1, int(events)))
        hist = _host(_run_event(c, t, warmup, events, seed, lanes, chunk,
                                hactive, ndev)).astype(np.float64)
        # Jitter is additive observation noise: convolve its exact uniform
        # distribution into the histogram (per-lane effective width).
        sj = ov_host.get("service_jitter_ns")
        width = cha_host.service_jitter_ns if sj is None else np.where(
            np.isnan(sj), cha_host.service_jitter_ns, sj)
        hist = _convolve_jitter(hist, width)
    hist = hist.reshape(reps, n, -1)
    if keep_reps:
        return _stats_from_hist(hist)
    return _stats_from_hist(hist.sum(axis=0))


def simulate(configs, steps: int = 200_000, seed: int = 0,
             warmup: int | None = None, reps: int = 1,
             engine: str = "timestep", devices=None,
             device="cuda") -> LatencyStats:
    """Simulate a batch of :class:`ChannelConfig` and return stats (a shim
    over :func:`simulate_cells`)."""
    return simulate_cells(stack_channels(configs), steps=steps, seed=seed,
                          warmup=warmup, reps=reps, engine=engine,
                          devices=devices, device=device)


def load_latency_curve(rhos=None, kappa: float = 1.0, cxl_lat_ns: float = 0.0,
                       steps: int = 200_000, seed: int = 0,
                       warmup: int | None = None, reps: int = 1,
                       engine: str = "timestep", devices=None,
                       device="cuda") -> dict:
    """Fig 2a: mean/p90 latency vs bus utilization for one channel type."""
    if rhos is None:
        rhos = np.linspace(0.05, 0.95, 19)
    configs = [ChannelConfig(rho=float(r), kappa=kappa,
                             cxl_lat_ns=cxl_lat_ns) for r in rhos]
    stats = simulate(configs, steps=steps, seed=seed, warmup=warmup,
                     reps=reps, engine=engine, devices=devices, device=device)
    return dict(rho=np.asarray(rhos), mean_ns=stats.mean_ns,
                p90_ns=stats.p90_ns, p99_ns=stats.p99_ns,
                stdev_ns=stats.stdev_ns)
