"""Fixed-point loaded-CPU performance model (the ChampSim stand-in).

Port of ``repro/core/cpu_model.py``, both queue backends.  The paper
simulates a 12-core OoO CPU (Table 3) with ChampSim+DRAMsim3; the
reproduction uses a bottleneck model that captures the effects the
paper's argument rests on:

    CPI = max(CPI_exec + CPI_mem,  CPI_bw)
    CPI_mem = (MPKI/1000) * (L_mean + gamma * L_stdev) * f_clk / MLP
    CPI_bw  = per-instruction bytes / available bandwidth  (any interface)

with L_mean = DRAM service + queue wait + CXL premium (+ link queue), and
the queue wait from the calibrated load-latency model (``queueing``).
Utilization depends on achieved IPC and IPC on the latency at that
utilization, so a damped fixed point is solved, for all workloads at once.

Calibration: per workload, the effective MLP and ``CPI_exec`` are derived
so the *baseline* DDR system reproduces Table 4's IPC exactly, given the
workload's ``exec_frac``.  COAXIAL designs are then evaluated with the same
per-workload parameters -- the speedups are predictions, not fits.

Batching: a :class:`MemSystem` is a frozen-dataclass façade; the solver
consumes :class:`MemSystemArrays`, a NamedTuple of float tensors
(``is_cxl`` is a 0/1 mask).  Every model term is branch-free in the
design dimension (mask arithmetic, ``torch.where``), so one function,
:func:`_solve_cells`, serves every solve surface.  Where the reference
vmaps one cell over a flattened cell axis, the port broadcasts: per-cell
values are ``(N, 1)`` columns and workload parameters ``(1, W)`` rows, so
a grid of any number of named axes is one call of :func:`_solve_cells`
over ``(N, W)`` tensors, calibration included (it varies by cell with
``n_active`` and the workload overrides).  The fixed point is a Python
loop of ``FP_ITERS`` steps over whole-grid tensors.  Overrides are NaN
masked (NaN = "keep the design's / workload's own value").

Arithmetic is float32 in the reference's order of operations (its solver
runs without x64); results come back as float64 numpy copies.  The solve
is differentiable end to end: :func:`design_gradient` takes
d(geomean speedup)/d(design field) by ``torch.autograd`` through the
unrolled fixed point.  ``jnp.clip``/``jnp.minimum``/``jnp.maximum`` are
``queueing.clip``/``minimum``/``maximum``, which split the gradient at a
tie as JAX does.

Queue-wait backends: ``queue_model="closed_form"`` (the default) uses the
calibrated ``queueing.effective_queue_wait_ns`` / ``stdev_latency_ns``
pair; ``queue_model="memsim"`` replaces both with a DES-derived
:class:`repro_torch.core.queuelut.QueueLUT` (mean wait and latency stdev
read from the mechanism's measured tables through differentiable
multilinear interpolation), passed in as ``lut=`` or resolved to the
default surface through the LUT store.  The solver lays the LUT out on
its device once per solve (``QueueLUT.tables``); calibration runs under
the same backend.  On the memsim backend the LUT also carries the
DES-measured p99 queue wait, and the solver returns ``latency_p99_ns`` /
``cpi_mem_p99`` at the converged operating point (they do not feed the
fixed point); the closed form has no tail law, so they are NaN there.

Every solve surface takes ``device=`` (default ``"cuda"``); with no card
it raises rather than solve on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hw, queueing
from repro_torch.core.queueing import clip, maximum
from repro_torch.core.workloads import (SWEEPABLE_FIELDS as SWEEPABLE_WORKLOAD_FIELDS,
                                        WORKLOADS, WorkloadArrays, as_arrays,
                                        resolve_device)

#: Architectural bound on outstanding misses per core (MSHRs / 256-ROB).
MAX_MLP = hw.MAX_MLP
#: Floor on the calibrated non-memory CPI.
MIN_CPI_EXEC = 0.02
#: LLC miss-rate sensitivity to capacity: MPKI ~ C^-alpha (sqrt(2)-rule-ish).
ALPHA_LLC = 0.25
#: MPKI multiplier when the working set fits in the LLC.
LLC_FIT_FACTOR = 0.05
#: Working sets at/above this are treated as streaming (compulsory misses):
#: their MPKI does not react to LLC capacity.
STREAMING_WS_MB = 1024.0
#: Fixed-point iterations / damping.
FP_ITERS = 120
FP_DAMP = 0.5

#: Pluggable queue-wait backends of the fixed point (see module docstring).
QUEUE_MODELS = ("closed_form", "memsim")


def resolve_queue_lut(queue_model: str, lut=None, *, harvest: bool = False,
                      device="cuda"):
    """Map a backend name to the LUT the solver consumes.

    ``closed_form`` -> ``None``; ``memsim`` -> the given
    :class:`~repro_torch.core.queuelut.QueueLUT`, or the default surface
    when none is passed (resolved through the LUT store: memory ->
    ``$REPRO_LUT_CACHE/torch`` -> a build on ``device``).  ``harvest=True``
    means the solve needs the harvest axis: the default build gains it,
    and an explicitly passed 4-D surface is rejected rather than
    silently dropping the mechanism.
    """
    if queue_model not in QUEUE_MODELS:
        raise ValueError(f"unknown queue_model {queue_model!r}; "
                         f"choose from {QUEUE_MODELS}")
    if queue_model == "closed_form":
        return None
    if lut is None:
        from repro_torch.core import queuelut  # runtime: import cycle
        lut = queuelut.default_queue_lut(harvest=harvest, device=device)
    elif harvest and lut.harvest_grid is None:
        raise ValueError(
            "designs harvest (harvest_duty * harvest_bw_gbps > 0) but "
            "the given QueueLUT has no harvest axis; build it with "
            "build_queue_lut(harvest=...) or pass lut=None")
    return lut


def _any_harvest(sysa: "MemSystemArrays", sys_ov=None) -> bool:
    """Host-side peek: does any cell harvest (effective ``harvest_duty``
    AND ``harvest_bw_gbps`` > 0 with NaN-masked overrides applied)?  Used
    only to pick the default LUT surface."""
    ov = sys_ov or {}

    def eff(f):
        s = _host(getattr(sysa, f))
        v = _host(ov[f]) if f in ov else np.nan
        return np.where(np.isnan(v), s, v)

    return bool(np.any((eff("harvest_duty") > 0.0)
                       & (eff("harvest_bw_gbps") > 0.0)))


def _host(x) -> np.ndarray:
    """A leaf (tensor or array) as a float64 numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


@dataclasses.dataclass(frozen=True)
class MemSystem:
    """One server memory-system design point (Table 2, scaled to 12 cores)."""

    name: str
    dram_channels: int          # DDR5 channels behind all interfaces
    links: int                  # CXL links (0 => direct DDR attach)
    link_rd_gbps: float         # per-link read goodput
    link_wr_gbps: float         # per-link write goodput
    iface_lat_ns: float         # CXL end-to-end latency premium
    llc_mb_per_core: float
    rel_area: float = 1.0       # die area relative to the DDR baseline
    rel_pins: float = 1.0       # memory-interface pins relative to baseline
    #: Idle-I/O harvesting (arXiv 2511.12349).  Only the memsim backend
    #: acts on these; the closed form ignores both.
    harvest_duty: float = 0.0
    harvest_bw_gbps: float = 0.0

    @property
    def is_cxl(self) -> bool:
        return self.links > 0

    def as_arrays(self, device="cuda") -> "MemSystemArrays":
        """0-dim float32 tensor view of this design (solver calling form)."""
        return stack_designs([self], device=device)._map(lambda x: x[0])


class MemSystemArrays(NamedTuple):
    """Design-point parameters, batchable along leading axes.

    All leaves share one shape: ``()`` for one design, ``(D,)`` for a
    stacked design axis, ``(N, 1)`` inside the cell solver.  ``is_cxl``
    is a 0/1 mask so the solver stays branch-free in the design dimension.
    Leaves are float32 tensors in the solver, numpy arrays where
    ``sweepspec.build_flat`` lowers a spec.
    """

    dram_channels: torch.Tensor
    links: torch.Tensor
    link_rd_gbps: torch.Tensor
    link_wr_gbps: torch.Tensor
    iface_lat_ns: torch.Tensor
    llc_mb_per_core: torch.Tensor
    harvest_duty: torch.Tensor
    harvest_bw_gbps: torch.Tensor
    is_cxl: torch.Tensor

    def _map(self, fn) -> "MemSystemArrays":
        return MemSystemArrays(*(fn(leaf) for leaf in self))


#: Design fields a sweep axis may override (everything except the derived
#: ``is_cxl`` mask and ``iface_lat_ns``, which has its own NaN-masked
#: override argument with the legacy CXL-only semantics).
SWEEPABLE_DESIGN_FIELDS = ("dram_channels", "links", "link_rd_gbps",
                           "link_wr_gbps", "llc_mb_per_core",
                           "harvest_duty", "harvest_bw_gbps")


def _design_row(d: MemSystem) -> list[float]:
    return [float(getattr(d, f)) for f in MemSystemArrays._fields
            if f != "is_cxl"] + [1.0 if d.is_cxl else 0.0]


def stack_designs(designs, *, device="cuda") -> MemSystemArrays:
    """Stack ``MemSystem`` façades into one ``(D,)``-leaved tuple of
    float32 tensors on ``device``."""
    table = torch.tensor([_design_row(d) for d in designs],
                         dtype=torch.float64)
    leaves = table.to(torch.float32).to(resolve_device(device))
    return MemSystemArrays(*leaves.T)


def _apply_design_overrides(sysa: MemSystemArrays, ov) -> MemSystemArrays:
    """NaN-masked per-field substitution; ``is_cxl`` is re-derived from the
    effective link count so a ``links`` axis can cross the DDR/CXL boundary
    branch-free."""
    eff = {f: torch.where(torch.isnan(v), getattr(sysa, f), v)
           for f, v in ov.items()}
    sysa = sysa._replace(**eff)
    return sysa._replace(is_cxl=(sysa.links > 0).to(sysa.links.dtype))


def _apply_workload_overrides(wl: WorkloadArrays, ov) -> WorkloadArrays:
    """NaN-masked substitution of one scalar per behavioral parameter,
    broadcast over all workloads (a bound axis redefines the parameter for
    the whole suite -- a synthetic-workload sweep)."""
    repl = {f: torch.where(torch.isnan(v), getattr(wl, f), v)
            for f, v in ov.items()}
    return dataclasses.replace(wl, **repl)


def _bw_efficiency(wb):
    """Sustained/peak DDR efficiency: 70-90% depending on R/W turnaround."""
    write_share = wb / (1.0 + wb)
    return 0.92 - 0.18 * write_share


@dataclasses.dataclass
class ModelResult:
    """Per-workload outputs of one (memory system x utilization) evaluation,
    as float64 numpy arrays.

    Arrays are ``(n_workloads,)`` for a single design point;
    :func:`solve_batch` returns the same structure with leading
    ``(designs, iface_lats, core_counts)`` axes.
    """

    ipc: np.ndarray
    cpi: np.ndarray
    latency_ns: np.ndarray       # mean LLC-miss latency
    queue_ns: np.ndarray         # queue-wait component (DRAM + link)
    iface_ns: np.ndarray         # CXL interface component
    service_ns: np.ndarray       # DRAM service component
    sigma_ns: np.ndarray         # latency stdev
    rho: np.ndarray              # DRAM-side bandwidth utilization
    read_gbps: np.ndarray
    write_gbps: np.ndarray
    latency_p99_ns: np.ndarray   # p99 LLC-miss latency (NaN: closed form)
    cpi_mem_p99: np.ndarray      # memory CPI at the p99 latency (NaN: cf)

    def speedup_vs(self, base: "ModelResult") -> np.ndarray:
        return self.ipc / base.ipc

    def __getitem__(self, idx) -> "ModelResult":
        """Slice every field identically (e.g. one design from a batch)."""
        return ModelResult(**{f.name: getattr(self, f.name)[idx]
                              for f in dataclasses.fields(self)})

    def reshape(self, *grid_shape) -> "ModelResult":
        """Reshape the leading (cell) axes; the workload axis stays last."""
        re = lambda x: x.reshape(tuple(grid_shape) + x.shape[-1:])
        return ModelResult(**{f.name: re(getattr(self, f.name))
                              for f in dataclasses.fields(self)})


def _mpki_eff(wl: WorkloadArrays, sysa: MemSystemArrays, n_active):
    scale = (2.0 / sysa.llc_mb_per_core) ** ALPHA_LLC
    streaming = wl.ws_mb >= STREAMING_WS_MB
    mpki = wl.mpki * torch.where(streaming, 1.0, scale)
    llc_total = sysa.llc_mb_per_core * hw.SIM_CORES
    fits = (wl.ws_mb * n_active) <= llc_total
    return torch.where(fits, wl.mpki * LLC_FIT_FACTOR, mpki)


def _latency_terms(wl, sysa: MemSystemArrays, read_gbps, write_gbps,
                   n_active, iface_lat_ns, lut=None):
    """Mean latency components + stdev + p99 at the given traffic level.

    Branch-free in the design dimension: link terms are computed with
    guarded denominators and zeroed by the ``is_cxl`` mask (a multiply, so
    a DDR design, links == 0, gets exactly the no-link values).

    ``lut`` selects the queue-wait backend: ``None`` is the calibrated
    closed form; a :class:`~repro_torch.core.queuelut.LutTables` (a
    QueueLUT laid out on the solve's device) replaces the DRAM-side wait
    with the DES-measured mean-wait table (``eta`` a grid axis) and the
    sigma heuristic with the DES-measured latency-stdev table.  The CXL
    link queue keeps its closed form either way.

    Returns ``(latency, queue, sigma, rho, latency_p99)``; the p99 is DRAM
    service + the DES-measured p99 queue wait + (mean) link wait +
    interface premium, NaN under the closed form (no tail law).
    """
    eff = _bw_efficiency(wl.wb)
    ch_bw = hw.DDR5_CH_BW_GBPS * eff
    rho = (read_gbps + write_gbps) / (sysa.dram_channels * ch_bw)
    outstanding = n_active * MAX_MLP / sysa.dram_channels
    if lut is None:
        w_dram = queueing.effective_queue_wait_ns(
            rho, kappa=wl.kappa, eta=wl.eta,
            outstanding_per_channel=outstanding, channel_bw_gbps=ch_bw)
    elif lut.harvest_grid is not None:
        # Harvest query in table units: lent-time fraction scaled to the
        # one-channel reference bandwidth the axis was built at.
        harvest = (sysa.harvest_duty * sysa.harvest_bw_gbps /
                   hw.DDR5_CH_BW_GBPS)
        w_dram, _, w_p99, sigma_mem = lut.lookup(rho, wl.kappa, outstanding,
                                                 wl.eta, harvest)
    else:
        w_dram, _, w_p99, sigma_mem = lut.lookup(rho, wl.kappa, outstanding,
                                                 wl.eta)
    link_rd_bw = maximum(sysa.links * sysa.link_rd_gbps, 1e-9)
    rho_rx = read_gbps / link_rd_bw
    svc_rx = hw.CACHE_LINE_B / maximum(sysa.link_rd_gbps, 1e-9)
    w_link = sysa.is_cxl * queueing.link_queue_wait_ns(rho_rx, svc_rx,
                                                       wl.kappa)
    queue = w_dram + w_link
    sigma = (queueing.stdev_latency_ns(queue) if lut is None
             else torch.broadcast_to(sigma_mem, queue.shape))
    latency = hw.DRAM_SERVICE_NS + queue + iface_lat_ns
    if lut is None:
        latency_p99 = torch.full_like(latency, float("nan"))
    else:
        latency_p99 = torch.broadcast_to(
            hw.DRAM_SERVICE_NS + w_p99 + w_link + iface_lat_ns,
            latency.shape)
    return latency, queue, sigma, rho, latency_p99


def _cpi_mem(wl, mpki_eff, latency, sigma, mlp):
    l_eff_cyc = (latency + wl.gamma * sigma) * hw.CORE_CLK_GHZ
    return (mpki_eff / 1000.0) * l_eff_cyc / mlp


def _cpi_mem_p99(mpki_eff, latency_p99, mlp):
    """Memory CPI with every miss charged the p99 latency -- the tail
    counterpart of :func:`_cpi_mem` (NaN under the closed form)."""
    return (mpki_eff / 1000.0) * latency_p99 * hw.CORE_CLK_GHZ / mlp


def _cpi_bw(wl, mpki_eff, sysa: MemSystemArrays, n_active):
    """Bandwidth-bound CPI floor for every interface in the system.

    The CXL-link floors are masked by ``is_cxl``; ``max`` with a masked 0
    leaves the DDR-only floor untouched.
    """
    bytes_rd = (mpki_eff / 1000.0) * hw.CACHE_LINE_B          # per inst
    bytes_wr = bytes_rd * wl.wb
    eff = _bw_efficiency(wl.wb)
    cpi = (bytes_rd + bytes_wr) * n_active * hw.CORE_CLK_GHZ / \
        (sysa.dram_channels * hw.DDR5_CH_BW_GBPS * eff)
    link_rd_bw = maximum(sysa.links * sysa.link_rd_gbps, 1e-9)
    link_wr_bw = maximum(sysa.links * sysa.link_wr_gbps, 1e-9)
    cpi = torch.maximum(cpi, sysa.is_cxl * bytes_rd * n_active *
                        hw.CORE_CLK_GHZ / link_rd_bw)
    cpi = torch.maximum(cpi, sysa.is_cxl * bytes_wr * n_active *
                        hw.CORE_CLK_GHZ / link_wr_bw)
    return cpi


def _traffic(wl, ipc, mpki_eff, n_active):
    read = ipc * hw.CORE_CLK_GHZ * n_active * (mpki_eff / 1000.0) * \
        hw.CACHE_LINE_B  # GB/s
    return read, read * wl.wb


def _mlp_eff(wl, mlp_cal, rho):
    """Load-adaptive effective MLP: prefetchers run further ahead when
    bandwidth is free, so mlp_eff = mlp_cal * (1 + pf_boost * (1 - rho)),
    within the architectural [1, MAX_MLP]."""
    return clip(mlp_cal * (1.0 + wl.pf_boost * (1.0 - _rho01(rho))),
                1.0, MAX_MLP)


def _rho01(rho):
    return clip(rho, 0.0, 1.0)


def _calibrate(wl: WorkloadArrays, base: MemSystemArrays, n_active,
               lut=None):
    """Core of :func:`calibrate` (baseline as tensors).  Calibration runs
    under the SAME queue backend as the solve: the memsim-backed model
    re-derives (cpi_exec, mlp_cal) against the DES waits."""
    mpki_eff = _mpki_eff(wl, base, n_active)
    read, write = _traffic(wl, wl.ipc, mpki_eff, n_active)
    latency, _, sigma, rho_base, _ = _latency_terms(
        wl, base, read, write, n_active, base.iface_lat_ns, lut)
    l_eff_cyc = (latency + wl.gamma * sigma) * hw.CORE_CLK_GHZ
    budget = (1.0 - wl.exec_frac) / wl.ipc
    mlp_raw = (mpki_eff / 1000.0) * l_eff_cyc / maximum(budget, 1e-9)
    mlp_base = clip(mlp_raw, 1.0, MAX_MLP)
    mlp_cal = mlp_base / (1.0 + wl.pf_boost * (1.0 - _rho01(rho_base)))
    cpi_exec = maximum(
        1.0 / wl.ipc - (mpki_eff / 1000.0) * l_eff_cyc / mlp_base,
        MIN_CPI_EXEC)
    return cpi_exec, mlp_cal


def calibrate(wl: WorkloadArrays, baseline, n_active=hw.SIM_CORES,
              queue_model: str = "closed_form", lut=None):
    """Per-workload (cpi_exec, mlp_cal) reproducing Table 4 on the baseline.

    Given exec_frac, the memory-CPI budget at the table operating point is
    (1 - exec_frac)/IPC; the effective MLP at the *baseline* utilization is
    whatever makes the latency model meet that budget, clamped to the
    architectural [1, MAX_MLP]; mlp_cal back-solves the load-adaptive form.
    ``baseline`` may be a :class:`MemSystem` (made on ``wl``'s device) or
    a :class:`MemSystemArrays`.  ``queue_model`` (and ``lut``) pick the
    wait backend the calibration is run against.
    """
    device = wl.ipc.device
    lut = resolve_queue_lut(queue_model, lut, device=device)
    if isinstance(baseline, MemSystem):
        baseline = baseline.as_arrays(device=device)
    return _calibrate(wl, baseline, n_active,
                      None if lut is None else lut.tables(device))


def _solve_point(wl, sysa: MemSystemArrays, base: MemSystemArrays,
                 n_active, iface_override_ns, lut=None):
    """Calibrate + solve design points, all workloads at once (any shapes
    that broadcast: one point, or ``(N, 1)`` cells against ``(1, W)``
    workloads).

    ``iface_override_ns`` replaces the CXL latency premium of CXL designs;
    ``nan`` means "use the design's own premium".  Non-CXL designs keep
    their (zero) premium, so a baseline sliced out of any latency grid is
    identical to the baseline solved alone.  ``lut`` (None = closed form;
    else a ``LutTables`` on the solve's device) picks the queue-wait
    backend for calibration AND the fixed point.
    """
    cpi_exec, mlp = _calibrate(wl, base, n_active, lut)
    premium = torch.where(
        sysa.is_cxl > 0.0,
        torch.where(torch.isnan(iface_override_ns), sysa.iface_lat_ns,
                    iface_override_ns),
        sysa.iface_lat_ns)
    mpki_eff = _mpki_eff(wl, sysa, n_active)
    cpi_bw = _cpi_bw(wl, mpki_eff, sysa, n_active)

    ipc = wl.ipc
    for _ in range(FP_ITERS):
        read, write = _traffic(wl, ipc, mpki_eff, n_active)
        latency, _, sigma, rho, _ = _latency_terms(
            wl, sysa, read, write, n_active, premium, lut)
        mlp_eff = _mlp_eff(wl, mlp, rho)
        cpi = torch.maximum(
            cpi_exec + _cpi_mem(wl, mpki_eff, latency, sigma, mlp_eff),
            cpi_bw)
        ipc = (1 - FP_DAMP) * ipc + FP_DAMP / cpi
    read, write = _traffic(wl, ipc, mpki_eff, n_active)
    latency, queue, sigma, rho, lat_p99 = _latency_terms(
        wl, sysa, read, write, n_active, premium, lut)
    iface = torch.broadcast_to(premium, ipc.shape)
    cpi_p99 = _cpi_mem_p99(mpki_eff, lat_p99, _mlp_eff(wl, mlp, rho))
    return (ipc, latency, queue, sigma, rho, read, write, iface,
            lat_p99, cpi_p99)


#: Calls of the batched cell solver :func:`_solve_cells`.  The port has no
#: traces; the name is the reference's, whose counter pins that a whole
#: named-axis grid -- however many axes -- costs ONE solver pass.  Here it
#: pins the same: one call per grid.
_TRACE_COUNT = [0]


def solve_trace_count() -> int:
    """Calls of the batched cell solver so far (one per solved grid)."""
    return _TRACE_COUNT[0]


def _solve_cells(wl, sysa, base, n_active, iface_ov, sys_ov, wl_ov,
                 lut=None):
    """Solve ONE flattened axis of grid cells in one pass.

    Every per-cell input -- the design leaves, the core count, the CXL
    latency override and both overrides dicts -- is ``(N,)``; the
    workload parameters are ``(W,)``.  Cells become ``(N, 1)`` columns and
    workloads ``(1, W)`` rows, the overrides apply branch-free, and one
    broadcast :func:`_solve_point` solves the grid (``lut`` shared by
    every cell).  Output tensors are ``(N, W)``.
    """
    _TRACE_COUNT[0] += 1
    col = lambda x: x[:, None]
    wl = dataclasses.replace(wl, **{f: getattr(wl, f)[None, :]
                                    for f in SWEEPABLE_WORKLOAD_FIELDS})
    wl = _apply_workload_overrides(wl, {f: col(v) for f, v in wl_ov.items()})
    sysa = _apply_design_overrides(sysa._map(col),
                                   {f: col(v) for f, v in sys_ov.items()})
    return _solve_point(wl, sysa, base, col(n_active), col(iface_ov), lut)


def _pack_result(out, squeeze: bool) -> ModelResult:
    """The solver's ten outputs as a float64 numpy :class:`ModelResult`
    (one device-to-host copy)."""
    stacked = torch.stack([torch.broadcast_to(x, out[0].shape)
                           for x in out]).cpu().numpy().astype(np.float64)
    if squeeze:
        stacked = stacked[:, 0]
    (ipc, latency, queue, sigma, rho, read, write, iface,
     lat_p99, cpi_p99) = stacked
    return ModelResult(
        ipc=ipc, cpi=1.0 / ipc, latency_ns=latency, queue_ns=queue,
        iface_ns=iface, service_ns=np.full_like(ipc, hw.DRAM_SERVICE_NS),
        sigma_ns=sigma, rho=rho, read_gbps=read, write_gbps=write,
        latency_p99_ns=lat_p99, cpi_mem_p99=cpi_p99)


def _grid(values) -> np.ndarray:
    return np.asarray([float('nan') if v is None else float(v)
                       for v in values], np.float64)


def _nan_cells(n: int, fields) -> dict:
    nans = np.full(n, np.nan)
    return {f: nans for f in fields}


def _cells_to_device(arrays: dict, device) -> dict:
    """``{name: (N,) array}`` to float32 tensors on ``device``, rounded
    from float64 as the reference's ``jnp.asarray`` rounds them, in one
    host-to-device copy."""
    table = np.stack([np.asarray(a, np.float64) for a in arrays.values()])
    rows = torch.from_numpy(table.astype(np.float32)).to(device).unbind(0)
    return dict(zip(arrays, rows))


def solve_cells(sysa: MemSystemArrays, *, n_active, iface_override_ns=None,
                design_overrides=None, workload_overrides=None,
                baseline: MemSystem | None = None,
                workloads=WORKLOADS, queue_model: str = "closed_form",
                lut=None, device="cuda") -> ModelResult:
    """Solve N flattened grid cells in one call of the cell solver.

    ``sysa`` leaves and ``n_active`` are ``(N,)`` (numpy arrays or
    tensors); ``iface_override_ns`` and every overrides entry are ``(N,)``
    with NaN meaning "keep the design's / workload's own value".  Missing
    override fields are filled with NaN.  ``queue_model`` picks the wait
    backend (``"memsim"`` resolves ``lut`` to the default surface when
    none is given).  Solves on ``device``.
    """
    device = resolve_device(device)
    n = int(np.shape(sysa.dram_channels)[0])
    cells = {f"sys.{f}": _host(leaf) for f, leaf in zip(sysa._fields, sysa)}
    cells["n_active"] = _host(n_active)
    cells["iface"] = (np.full(n, np.nan) if iface_override_ns is None
                      else _host(iface_override_ns))
    sys_ov = _nan_cells(n, SWEEPABLE_DESIGN_FIELDS)
    sys_ov.update({f: _host(v) for f, v in (design_overrides or {}).items()})
    lut = resolve_queue_lut(queue_model, lut,
                            harvest=_any_harvest(sysa, sys_ov),
                            device=device)
    wl_ov = _nan_cells(n, SWEEPABLE_WORKLOAD_FIELDS)
    wl_ov.update({f: _host(v) for f, v in (workload_overrides or {}).items()})
    cells.update({f"sys_ov.{f}": v for f, v in sys_ov.items()})
    cells.update({f"wl_ov.{f}": v for f, v in wl_ov.items()})
    t = _cells_to_device(cells, device)
    pick = lambda prefix: {k.split(".", 1)[1]: v for k, v in t.items()
                           if k.startswith(prefix + ".")}
    wl = as_arrays(workloads, device=device)
    base = (baseline or DDR_BASELINE).as_arrays(device=device)
    with torch.no_grad():
        out = _solve_cells(wl, MemSystemArrays(**pick("sys")), base,
                           t["n_active"], t["iface"], pick("sys_ov"),
                           pick("wl_ov"),
                           None if lut is None else lut.tables(device))
    return _pack_result(out, squeeze=False)


def solve(sys: MemSystem, *, baseline: MemSystem | None = None,
          n_active: int = hw.SIM_CORES, iface_lat_ns: float | None = None,
          workloads=WORKLOADS, queue_model: str = "closed_form",
          lut=None, device="cuda") -> ModelResult:
    """Evaluate all workloads on ``sys`` (calibrated against ``baseline``):
    the cell solver with N=1.  ``queue_model="memsim"`` evaluates the fixed
    point through the DES-derived QueueLUT (``lut``, or the default
    surface) instead of the closed form."""
    sysa = MemSystemArrays(*(np.asarray([x]) for x in _design_row(sys)))
    if iface_lat_ns is not None:
        # Legacy solve() applied an explicit override even to non-CXL
        # designs; mirroring the field keeps that behaviour under the mask.
        sysa = sysa._replace(iface_lat_ns=np.asarray([float(iface_lat_ns)]))
    res = solve_cells(sysa, n_active=_grid([n_active]),
                      iface_override_ns=_grid([iface_lat_ns]),
                      baseline=baseline, workloads=workloads,
                      queue_model=queue_model, lut=lut, device=device)
    return res[0]


def solve_batch(designs, *, n_active_grid=(hw.SIM_CORES,),
                iface_lat_grid=(None,), baseline: MemSystem | None = None,
                workloads=WORKLOADS, queue_model: str = "closed_form",
                lut=None, device="cuda") -> ModelResult:
    """Evaluate a designs x iface-latencies x core-counts grid in ONE pass.

    ``iface_lat_grid`` entries override the CXL latency premium; ``None``
    means "each design's own premium".  Non-CXL designs ignore the override
    (their premium stays 0).

    Returns a :class:`ModelResult` whose arrays have shape
    ``(len(designs), len(iface_lat_grid), len(n_active_grid), n_workloads)``.
    """
    designs = tuple(designs)
    d, l, c = len(designs), len(iface_lat_grid), len(n_active_grid)
    rows = np.asarray([_design_row(x) for x in designs], np.float64)
    # Flatten design-major / core-minor: cell (i, j, k) -> i*L*C + j*C + k.
    sysa = MemSystemArrays(*np.repeat(rows, l * c, axis=0).T)
    iface = np.tile(np.repeat(_grid(iface_lat_grid), c), d)
    n_active = np.tile(_grid(n_active_grid), d * l)
    res = solve_cells(sysa, n_active=n_active, iface_override_ns=iface,
                      baseline=baseline, workloads=workloads,
                      queue_model=queue_model, lut=lut, device=device)
    return res.reshape(d, l, c)


# ---------------------------------------------------------------------------
# Design points (Table 2, scaled to the simulated 12-core slice, Table 3).
# ---------------------------------------------------------------------------

DDR_BASELINE = MemSystem(
    "ddr-baseline", dram_channels=1, links=0, link_rd_gbps=0.0,
    link_wr_gbps=0.0, iface_lat_ns=0.0, llc_mb_per_core=2.0,
    rel_area=1.0, rel_pins=1.0)

COAXIAL_2X = MemSystem(
    "coaxial-2x", dram_channels=2, links=2, link_rd_gbps=hw.CXL_X8_RD_GBPS,
    link_wr_gbps=hw.CXL_X8_WR_GBPS, iface_lat_ns=hw.CXL_LAT_NS,
    llc_mb_per_core=2.0, rel_area=1.01, rel_pins=24 * 32 / (12 * 160))

COAXIAL_4X = MemSystem(
    "coaxial-4x", dram_channels=4, links=4, link_rd_gbps=hw.CXL_X8_RD_GBPS,
    link_wr_gbps=hw.CXL_X8_WR_GBPS, iface_lat_ns=hw.CXL_LAT_NS,
    llc_mb_per_core=1.0, rel_area=1.01, rel_pins=48 * 32 / (12 * 160))

COAXIAL_5X = MemSystem(
    "coaxial-5x", dram_channels=5, links=5, link_rd_gbps=hw.CXL_X8_RD_GBPS,
    link_wr_gbps=hw.CXL_X8_WR_GBPS, iface_lat_ns=hw.CXL_LAT_NS,
    llc_mb_per_core=2.0, rel_area=1.17, rel_pins=1.0)

#: 4 CXL-asym links, each feeding TWO DDR controllers on the type-3 device
#: (§4.3): 8 DRAM channels' worth of banks behind 4 asymmetric links.
COAXIAL_ASYM = MemSystem(
    "coaxial-asym", dram_channels=8, links=4,
    link_rd_gbps=hw.CXL_ASYM_RD_GBPS, link_wr_gbps=hw.CXL_ASYM_WR_GBPS,
    iface_lat_ns=hw.CXL_LAT_NS, llc_mb_per_core=1.0,
    rel_area=1.01, rel_pins=48 * 32 / (12 * 160))

DESIGNS = (DDR_BASELINE, COAXIAL_2X, COAXIAL_4X, COAXIAL_5X, COAXIAL_ASYM)


# ---------------------------------------------------------------------------
# Fig 3: variance-only experiment (bimodal latency, constant 150ns average).
# ---------------------------------------------------------------------------

#: The five Fig-3 workloads, in decreasing memory-bandwidth intensity.
FIG3_WORKLOADS = ("pagerank", "components", "masstree", "omnetpp", "raytrace")
FIG3_MEAN_NS = 150.0
#: (low, high) bimodal points with 4:1 ratio -> stdev 100/150/200 ns.
FIG3_DISTS = ((100.0, 350.0), (75.0, 450.0), (50.0, 550.0))


def variance_experiment(workload_names=FIG3_WORKLOADS, dists=FIG3_DISTS, *,
                        device="cuda"):
    """Relative performance under bimodal latency vs fixed 150ns (Fig 3)."""
    wls = [w for n in workload_names for w in WORKLOADS if w.name == n]
    wl = as_arrays(wls, device=device)
    with torch.no_grad():
        cpi_exec, mlp_cal = calibrate(wl, DDR_BASELINE)
        # The toy system of Fig 3 is unloaded (fixed-latency memory).
        mlp = _mlp_eff(wl, mlp_cal, torch.zeros_like(wl.ipc))

    def perf(sigma_ns):
        l_eff = (FIG3_MEAN_NS + wl.gamma * sigma_ns) * hw.CORE_CLK_GHZ
        cpi = cpi_exec + (wl.mpki / 1000.0) * l_eff / mlp
        l_fix = FIG3_MEAN_NS * hw.CORE_CLK_GHZ
        cpi_fix = cpi_exec + (wl.mpki / 1000.0) * l_fix / mlp
        return (cpi_fix / cpi).cpu().numpy().astype(np.float64)

    out = {}
    for lo, hi in dists:
        sigma = float(np.sqrt(0.8 * (FIG3_MEAN_NS - lo) ** 2 +
                              0.2 * (hi - FIG3_MEAN_NS) ** 2))
        rel = perf(sigma)
        out[(lo, hi)] = dict(
            stdev_ns=sigma,
            per_workload=dict(zip(wl.name, rel.tolist())),
            geomean=float(np.exp(np.mean(np.log(rel)))))
    return out


def geomean(x, names=None) -> float:
    """Geometric mean of strictly positive values.

    Non-positive (or NaN) entries would silently propagate NaN out of the
    log; raise instead, naming the offending workloads when ``names`` is
    given (``Comparison.geomean_speedup`` passes its workload names).
    """
    x = np.asarray(x, np.float64)
    good = x > 0  # NaN compares false
    if not np.all(good):
        bad = np.flatnonzero(~good.reshape(-1))
        flat = x.reshape(-1)
        label = lambda i: names[i] if names is not None else f"[{i}]"
        detail = ", ".join(f"{label(int(i))}={flat[i]:g}" for i in bad[:8])
        more = "" if bad.size <= 8 else f" (+{bad.size - 8} more)"
        raise ValueError(
            f"geomean requires positive inputs; offending entries: "
            f"{detail}{more}")
    return float(np.exp(np.mean(np.log(x))))


# ---------------------------------------------------------------------------
# Gradient-based design optimization: torch.autograd through the fixed point.
# ---------------------------------------------------------------------------

#: Design fields :func:`design_gradient` may differentiate with respect to
#: (the continuous fields; ``is_cxl`` topology is held fixed).
GRADIENT_FIELDS = SWEEPABLE_DESIGN_FIELDS + ("iface_lat_ns",)


def _gm_speedup(vals, sysa0, wl, basea, n_active, base_ipc, lut=None):
    """Geomean speedup of ``sysa0`` with ``vals`` substituted, vs a fixed
    baseline IPC vector -- the scalar :func:`design_gradient` derives."""
    sysa = sysa0._replace(**vals)
    nan = torch.full((), float("nan"), device=base_ipc.device)
    ipc = _solve_point(wl, sysa, basea, n_active, nan, lut)[0]
    return torch.exp(torch.mean(torch.log(ipc / base_ipc)))


def design_gradient(sys: MemSystem | None = None,
                    fields=GRADIENT_FIELDS, *,
                    n_active: int = hw.SIM_CORES,
                    baseline: MemSystem | None = None,
                    workloads=WORKLOADS,
                    queue_model: str = "closed_form",
                    lut=None, device="cuda") -> dict[str, float]:
    """d(geomean speedup vs baseline) / d(design field) at ``sys``.

    Differentiates straight through the damped fixed point (autograd
    records its ``FP_ITERS`` steps).  The ``is_cxl`` topology mask is held
    at the design's own value -- gradients flow through capacities
    (channels, links, bandwidths, LLC), not through the discrete DDR/CXL
    switch.  Under ``queue_model="memsim"`` the reverse pass also flows
    through the QueueLUT's multilinear interpolation, with the baseline
    reference solved under the same backend.  Returns ``{field:
    gradient}`` in the order requested.

    Example::

        >>> from repro_torch.core.cpu_model import COAXIAL_4X, design_gradient
        >>> g = design_gradient(COAXIAL_4X,
        ...                     ("dram_channels", "iface_lat_ns"),
        ...                     device="cpu")
        >>> sorted(g)
        ['dram_channels', 'iface_lat_ns']
        >>> g["dram_channels"] > 0.0    # more channels always help
        True
        >>> g["iface_lat_ns"] < 0.0     # a slower link never does
        True
    """
    sys = sys if sys is not None else COAXIAL_4X
    unknown = [f for f in fields if f not in GRADIENT_FIELDS]
    if unknown:
        raise ValueError(f"non-differentiable or unknown design fields "
                         f"{unknown}; choose from {GRADIENT_FIELDS}")
    device = resolve_device(device)
    baseline = baseline or DDR_BASELINE
    lut = resolve_queue_lut(
        queue_model, lut,
        harvest=(_any_harvest(MemSystemArrays(*map(np.asarray,
                                                   _design_row(sys))))
                 or "harvest_duty" in fields
                 or "harvest_bw_gbps" in fields), device=device)
    wl = as_arrays(workloads, device=device)
    # The reference is constant under the differentiated fields.
    base_ipc = torch.from_numpy(
        solve(baseline, baseline=baseline, n_active=n_active,
              workloads=workloads, queue_model=queue_model, lut=lut,
              device=device).ipc.astype(np.float32)).to(device)
    sysa0 = sys.as_arrays(device=device)
    vals = {f: getattr(sysa0, f).clone().requires_grad_(True)
            for f in fields}
    n = torch.full((), float(n_active), device=device)
    gm = _gm_speedup(vals, sysa0, wl, baseline.as_arrays(device=device), n,
                     base_ipc, None if lut is None else lut.tables(device))
    grads = torch.autograd.grad(gm, list(vals.values()), allow_unused=True)
    return {f: 0.0 if g is None else float(g)
            for f, g in zip(fields, grads)}
