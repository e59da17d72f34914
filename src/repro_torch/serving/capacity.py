"""Capacity planner: min-area design meeting a p99 token-latency SLO.

Port of ``repro/serving/capacity.py``.  Both sides run on ``device=``
(default the card): the model side is one ``coaxial.solve_spec``, the
mechanism side one ``memsim.simulate`` over every cell, whose event
engine runs the hand kernel ``memsim_event_scan`` on the card (the
timestep engine ``memsim_ts_scan``), or, with ``p99_source="lut"``, one
``QueueLUT`` lookup of every cell.

The deployment question the paper's argument implies: given a model
fleet at a (batch, context) operating point and a request-rate trace,
which memory-system design -- (channels, LLC, CXL premium, tier split)
-- meets a p99 token-latency SLO at minimum silicon area?

The planner composes the repo's two existing truths instead of adding a
third model:

* **Model side** (``cpu_model`` via :func:`coaxial.solve_spec`): every
  candidate design is solved against the fleet's derived LLM workloads
  in one batched grid, giving per-design IPC -- the compute/bandwidth-
  coupled floor on decode-step time.

* **Mechanism side** (``memsim``, event engine): every (design, tier
  split, trace epoch) becomes one or two DES cells -- a direct-DDR lane
  and a CXL lane -- with ``rho`` from offered bytes vs lane bandwidth
  and ``kappa`` from the epoch.  All cells across all candidates run as
  ONE batched simulation, and p99 access latency is read from the event
  engine's exact per-request records (:class:`LatencyStats` histograms),
  not from a closed form.

Token latency composes the two: one decode step issues
``batch * read_bytes / 64`` line fetches with at most ``MAX_MLP x
cores`` in flight, i.e. ``waves = lines / in_flight`` dependent rounds;
each wave's completion is gated by its slowest straggler, which for
hundreds of in-flight accesses is the high-percentile access latency.
So ``token_p99 = waves * access_p99`` floored by the model-side step
time.  The 12-core simulated slice is scaled to the paper's 144-core
server (Table 2's own x12) for capacity and in-flight accounting.

Tier split ``s`` models a DDR+CXL tiered point (CXL-enabled Tiered
Memory, 2503.17864): ``round(s * channels)`` channels move to a
direct-attached DDR tier (no premium, full DDR pins paid), the rest
stay behind CXL; traffic stripes proportionally to channel count.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from repro_torch.core import coaxial, hw, memsim
from repro_torch.core.cpu_model import DDR_BASELINE, MemSystem
from repro_torch.core.devices import MEASURED_DEVICES
from repro_torch.serving.demand import decode_demand, llm_workload
from repro_torch.serving.traffic import Trace

#: Simulated 12-core slice -> full server (Table 2's scale factor).
SCALE = coaxial.FULL_CORES // hw.SIM_CORES
#: Default simulated-time budget per DES cell, ns (overridable via the
#: ``steps`` argument; benchmarks pass their ``des_budget``).
DEFAULT_STEPS = 60_000


def _per_channel_gbps(channels: int, links: int, link_rd_gbps: float) -> float:
    """Read bandwidth one channel can actually deliver, GB/s."""
    if links:
        return min(hw.DDR5_CH_BW_GBPS, links * link_rd_gbps / channels)
    return hw.DDR5_CH_BW_GBPS


def _design_per_ch(d: MemSystem) -> float:
    return _per_channel_gbps(d.dram_channels, d.links, d.link_rd_gbps)


def capacity_gbps(d: MemSystem) -> float:
    """Full-server read bandwidth of a candidate design, GB/s."""
    return d.dram_channels * _design_per_ch(d) * SCALE


def candidate_designs(channels=(2, 4, 8), llc_mb=(1.0,),
                      premium_ns=(hw.CXL_LAT_NS, hw.CXL_LAT_PESSIMISTIC_NS),
                      include_registry: bool = True,
                      include_measured: bool = True) -> tuple:
    """The candidate set: registry designs + a generated CXL grid +
    measured devices, deduplicated by name (first wins).

    Generated points follow the coaxial-Nx idiom (one x8 link per DDR
    channel behind it) with Table-1/2 area accounting via
    :func:`coaxial.design_cost`.
    """
    out: dict[str, MemSystem] = {DDR_BASELINE.name: DDR_BASELINE}
    if include_registry:
        for d in coaxial.all_designs():
            out.setdefault(d.name, d)
    for ch in channels:
        for llc in llc_mb:
            for prem in premium_ns:
                name = f"cxl-{ch}ch-llc{llc:g}-{prem:g}ns"
                if name in out:
                    continue
                cost = coaxial.design_cost(ch, ch, llc)
                out[name] = MemSystem(
                    name, dram_channels=int(ch), links=int(ch),
                    link_rd_gbps=hw.CXL_X8_RD_GBPS,
                    link_wr_gbps=hw.CXL_X8_WR_GBPS,
                    iface_lat_ns=float(prem), llc_mb_per_core=float(llc),
                    rel_area=float(cost["rel_area"]),
                    rel_pins=float(cost["rel_pins"]))
    if include_measured:
        for d in MEASURED_DEVICES:
            out.setdefault(d.name, d)
    return tuple(out.values())


def _tiered_cost(d: MemSystem, n_hot: int, links_cold: int) -> dict:
    """Table-1/2 accounting for a DDR+CXL tiered variant of ``d``.

    ``design_cost`` models pure designs; a tiered point is the hot
    tier's DDR channels plus the cold tier's links, so combine two pure
    calls and subtract the double-counted core+LLC base."""
    llc = d.llc_mb_per_core
    hot = coaxial.design_cost(n_hot, 0, llc)
    cold = coaxial.design_cost(0, links_cold, llc)
    none = coaxial.design_cost(0, 0, llc)
    return dict(
        rel_area=float(hot["rel_area"] + cold["rel_area"] -
                       none["rel_area"]),
        rel_pins=float(hot["rel_pins"] + cold["rel_pins"]))


@dataclasses.dataclass(frozen=True)
class _Variant:
    """One (design, tier split) point and its lane geometry."""

    design: MemSystem
    tier_split: float
    n_hot: int
    n_cold: int
    links_cold: int
    rel_area: float
    rel_pins: float

    @property
    def name(self) -> str:
        if self.tier_split:
            return f"{self.design.name}+tier{self.tier_split:g}"
        return self.design.name

    @property
    def lanes(self) -> tuple:
        """((channel_count, per_channel_gbps, premium_ns), ...)."""
        out = []
        if self.n_hot:
            out.append((self.n_hot, hw.DDR5_CH_BW_GBPS, 0.0))
        if self.n_cold:
            per = _per_channel_gbps(self.n_cold, self.links_cold,
                                    self.design.link_rd_gbps)
            out.append((self.n_cold, per, self.design.iface_lat_ns))
        return tuple(out)

    @property
    def capacity_gbps(self) -> float:
        return sum(n * per for n, per, _ in self.lanes) * SCALE


def _variants(designs, tier_splits) -> list:
    out = []
    for d in designs:
        if d.links == 0:
            # Pure direct-DDR design: one hot lane, split is moot.
            out.append(_Variant(d, 0.0, d.dram_channels, 0, 0,
                                d.rel_area, d.rel_pins))
            continue
        seen = set()
        for s in tier_splits:
            n_hot = int(round(s * d.dram_channels))
            if n_hot in seen:
                continue
            seen.add(n_hot)
            n_cold = d.dram_channels - n_hot
            links_cold = (max(1, math.ceil(d.links * n_cold /
                                           d.dram_channels))
                          if n_cold else 0)
            if n_hot == 0:
                out.append(_Variant(d, 0.0, 0, n_cold, d.links,
                                    d.rel_area, d.rel_pins))
            else:
                cost = _tiered_cost(d, n_hot, links_cold)
                out.append(_Variant(d, n_hot / d.dram_channels, n_hot,
                                    n_cold, links_cold,
                                    cost["rel_area"], cost["rel_pins"]))
    return out


@dataclasses.dataclass(frozen=True)
class DesignVerdict:
    """One candidate's fate against the SLO."""

    name: str
    design: str              # underlying registry/generated design name
    channels: int
    llc_mb_per_core: float
    premium_ns: float
    tier_split: float
    rel_area: float
    rel_pins: float
    ipc: tuple               # model-side per-arch IPC on this design
    peak_rho: float          # worst-epoch lane utilization
    access_p99_ns: float     # worst-epoch byte-weighted access p99 (DES)
    token_p99_ms: float      # worst epoch x arch, wave model + IPC floor
    token_mean_ms: float
    meets_slo: bool


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Every candidate's verdict, cheapest-first, plus the pick."""

    archs: tuple
    batch: int
    context: int
    tokens_per_req: float
    trace: str
    peak_rps: float
    slo_p99_ms: float
    engine: str
    steps: int
    demands: tuple           # DecodeDemand per arch
    verdicts: tuple          # sorted by (rel_area, rel_pins, name)

    @property
    def best(self) -> DesignVerdict | None:
        """Minimum-area verdict meeting the SLO (None if none do)."""
        for v in self.verdicts:
            if v.meets_slo:
                return v
        return None

    @property
    def closest(self) -> DesignVerdict:
        """Fallback pick: the lowest-p99 candidate."""
        return min(self.verdicts, key=lambda v: v.token_p99_ms)

    def table(self) -> str:
        hdr = (f"{'design':34s} {'area':>6s} {'pins':>6s} {'rho':>5s} "
               f"{'acc p99':>9s} {'tok p99':>10s} {'SLO':>4s}")
        lines = [hdr]
        for v in self.verdicts:
            lines.append(
                f"{v.name:34s} {v.rel_area:6.3f} {v.rel_pins:6.3f} "
                f"{v.peak_rho:5.2f} {v.access_p99_ns:7.0f}ns "
                f"{v.token_p99_ms:8.1f}ms {'ok' if v.meets_slo else 'NO':>4s}")
        return "\n".join(lines)


def default_steps() -> int:
    """Library default DES budget, honoring ``$REPRO_DES_STEPS``."""
    cap = os.environ.get("REPRO_DES_STEPS")
    if cap:
        return min(DEFAULT_STEPS, int(cap))
    return DEFAULT_STEPS


def plan_capacity(archs, trace: Trace, *, slo_p99_ms: float,
                  batch: int = 128, context: int = 4096,
                  tokens_per_req: float = 128.0,
                  channels=(2, 4, 8), llc_mb=(1.0,),
                  premium_ns=(hw.CXL_LAT_NS, hw.CXL_LAT_PESSIMISTIC_NS),
                  tier_splits=(0.0, 0.5),
                  include_registry: bool = True,
                  include_measured: bool = True,
                  peak_util: float | None = None,
                  harvest_bw_gbps: float = 0.0,
                  steps: int | None = None, seed: int = 0,
                  engine: str = "event", devices=None,
                  p99_source: str = "des", lut=None,
                  device="cuda") -> CapacityPlan:
    """Sweep candidates against a trace; return every verdict + the pick.

    ``archs`` is one arch id or a fleet of them (requests split evenly).
    ``peak_util`` rescales the trace so its peak offered load hits that
    utilization of the LARGEST candidate (shape-only traces); omit it to
    take the trace's absolute request rates.  ``steps`` is the DES
    simulated-time budget per cell (default :func:`default_steps`).

    ``p99_source`` picks where access latency comes from: ``"des"``
    (default) runs the batched per-cell simulation; ``"lut"`` reads the
    mean and p99 wait from a :class:`~repro_torch.core.queuelut.QueueLUT`
    (``lut``, or the shared default surface) -- the same in-loop tail
    the designer ascends, so a plan and a ``repro_torch.core.designer`` run
    judge candidates by one law.  LUT mode approximates each lane by
    the LUT's build-base transfer/service constants (the per-lane
    ``t_xfer_ns`` is folded into ``rho`` already), trading per-cell DES
    fidelity for a zero-simulation sweep -- with a warm
    ``$REPRO_LUT_CACHE`` (the persistent LUT store,
    :mod:`repro_torch.core.lutstore`) the whole plan then runs without a
    single DES run.

    ``harvest_bw_gbps > 0`` enables idle-I/O harvesting (arXiv
    2511.12349): each epoch lends that much idle I/O bandwidth per
    channel for its ``harvest_duty`` fraction of time (fill the trace
    via :meth:`~repro_torch.serving.traffic.Trace.with_harvest`, which
    anti-correlates duty with load, or a 4th CSV column).  DES cells
    run the true two-state chain; LUT mode queries the harvest axis at
    the reference-bandwidth ``duty_eff`` reduction.

    Everything runs on ``device``: the solve, the DES (its lanes split
    over ``devices`` devices, as ``memsim``'s), the LUT's build on a
    store miss and its lookup.
    """
    if isinstance(archs, str):
        archs = (archs,)
    archs = tuple(archs)
    if steps is None:
        steps = default_steps()
    demands = tuple(decode_demand(a, batch=batch, context=context)
                    for a in archs)
    workloads = tuple(llm_workload(a, batch=batch, context=context)
                      for a in archs)

    designs = candidate_designs(channels=channels, llc_mb=llc_mb,
                                premium_ns=premium_ns,
                                include_registry=include_registry,
                                include_measured=include_measured)
    variants = _variants(designs, tier_splits)

    # --- model side: one batched solve of every design x arch ----------
    sw = coaxial.solve_spec(coaxial.sweep_spec(design=designs),
                            workloads=workloads, device=device)
    ipc_tab = np.asarray(sw.results.ipc, np.float64)
    ipc_tab = ipc_tab.reshape(len(sw.designs), len(workloads))
    ipc_by_name = {d.name: tuple(float(x) for x in ipc_tab[i])
                   for i, d in enumerate(sw.designs)}

    # --- traffic: offered bytes per second, per epoch -------------------
    # Each request decodes tokens_per_req tokens; each token moves the
    # arch's read+write bytes.  The fleet splits the request rate evenly.
    bytes_per_req = sum(
        tokens_per_req * (d.read_bytes + d.state_write_bytes)
        for d in demands) / len(demands)
    if peak_util is not None:
        cap_max = max(v.capacity_gbps for v in variants)
        peak_offered = trace.peak_rps * bytes_per_req / 1e9
        if peak_offered > 0:
            trace = trace.scaled(peak_util * cap_max / peak_offered)
    epochs = trace.epochs

    # --- mechanism side: ONE batched DES over every (variant, epoch,
    # lane) cell; p99 access latency from per-request records. ----------
    configs, index = [], {}
    for vi, v in enumerate(variants):
        total_ch = v.n_hot + v.n_cold
        for ei, e in enumerate(epochs):
            offered = e.rps * bytes_per_req / 1e9          # GB/s
            for li, (n_ch, per_gbps, prem) in enumerate(v.lanes):
                share = n_ch / total_ch
                rho = min(max(offered * share /
                              (n_ch * per_gbps * SCALE), 0.02), 0.95)
                index[(vi, ei, li)] = len(configs)
                configs.append(memsim.ChannelConfig(
                    rho=rho, kappa=e.kappa,
                    outstanding=hw.MAX_MLP * hw.SIM_CORES / total_ch,
                    t_xfer_ns=hw.CACHE_LINE_B / per_gbps,
                    cxl_lat_ns=prem,
                    harvest_duty=e.harvest_duty,
                    harvest_bw_gbps=float(harvest_bw_gbps)))
    if p99_source == "lut":
        from repro_torch.core import queuelut
        needs_h = (float(harvest_bw_gbps) > 0.0
                   and any(e.harvest_duty > 0.0 for e in epochs))
        if lut is None:
            lut = queuelut.default_queue_lut(steps=steps, engine=engine,
                                             harvest=needs_h, device=device)
        elif needs_h and lut.harvest_grid is None:
            raise ValueError(
                "harvesting trace needs a QueueLUT with the harvest "
                "axis; build_queue_lut(harvest=...) or pass lut=None")
        arr = lambda attr: np.asarray([getattr(c, attr) for c in configs],
                                      np.float64)
        # float64 queries rounded once to float32 on the lookup's device,
        # as the reference's jnp lookup rounds them.
        q = lambda x: torch.from_numpy(x.astype(np.float32)).to(device)
        query = [q(arr(f)) for f in ("rho", "kappa", "outstanding", "eta")]
        if lut.harvest_grid is not None:
            query.append(q(arr("harvest_duty") * arr("harvest_bw_gbps") /
                           queuelut.HARVEST_REF_BW_GBPS))
        w_mean, _, w_p99, _ = lut.tables(device).lookup(*query)
        host = lambda t: t.cpu().numpy().astype(np.float64)
        prem = arr("cxl_lat_ns")
        mean = hw.DRAM_SERVICE_NS + host(w_mean) + prem
        p99 = hw.DRAM_SERVICE_NS + host(w_p99) + prem
    elif p99_source == "des":
        stats = memsim.simulate(configs, steps=steps, seed=seed,
                                engine=engine, devices=devices,
                                device=device)
        p99 = np.asarray(stats.p99_ns, np.float64)
        mean = np.asarray(stats.mean_ns, np.float64)
    else:
        raise ValueError(f"p99_source must be 'des' or 'lut', "
                         f"got {p99_source!r}")
    rho_of = np.asarray([c.rho for c in configs], np.float64)

    # --- compose token latency, judge the SLO ---------------------------
    in_flight = hw.MAX_MLP * hw.SIM_CORES * SCALE
    verdicts = []
    for vi, v in enumerate(variants):
        total_ch = v.n_hot + v.n_cold
        shares = [n / total_ch for n, _, _ in v.lanes]
        worst_p99 = worst_mean = worst_rho = 0.0
        for ei in range(len(epochs)):
            cells = [index[(vi, ei, li)] for li in range(len(v.lanes))]
            acc99 = float(sum(s * p99[c] for s, c in zip(shares, cells)))
            accmu = float(sum(s * mean[c] for s, c in zip(shares, cells)))
            worst_p99 = max(worst_p99, acc99)
            worst_mean = max(worst_mean, accmu)
            worst_rho = max(worst_rho, float(rho_of[cells].max()))
        ipcs = ipc_by_name[v.design.name]
        tok99 = tokmu = 0.0
        for d, ipc in zip(demands, ipcs):
            lines = batch * d.read_bytes / hw.CACHE_LINE_B
            waves = max(lines / in_flight, 1.0)
            # Model-side floor: the step also retires instructions.
            t_model = (batch * d.inst_per_token /
                       (ipc * hw.CORE_CLK_GHZ * 1e9 *
                        hw.SIM_CORES * SCALE))
            tok99 = max(tok99, waves * worst_p99 * 1e-9, t_model)
            tokmu = max(tokmu, waves * worst_mean * 1e-9, t_model)
        verdicts.append(DesignVerdict(
            name=v.name, design=v.design.name,
            channels=v.design.dram_channels,
            llc_mb_per_core=v.design.llc_mb_per_core,
            premium_ns=v.design.iface_lat_ns if v.n_cold else 0.0,
            tier_split=v.tier_split, rel_area=v.rel_area,
            rel_pins=v.rel_pins, ipc=ipcs, peak_rho=worst_rho,
            access_p99_ns=worst_p99, token_p99_ms=tok99 * 1e3,
            token_mean_ms=tokmu * 1e3,
            meets_slo=bool(tok99 * 1e3 <= slo_p99_ms)))
    verdicts.sort(key=lambda v: (v.rel_area, v.rel_pins, v.name))
    return CapacityPlan(
        archs=archs, batch=batch, context=context,
        tokens_per_req=tokens_per_req, trace=trace.name,
        peak_rps=trace.peak_rps, slo_p99_ms=slo_p99_ms,
        engine=engine if p99_source == "des" else "lut",
        steps=steps, demands=demands, verdicts=tuple(verdicts))
