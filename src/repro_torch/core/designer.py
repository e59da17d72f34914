"""Projected-gradient-ascent co-design under an area budget and p99 SLO.

Port of ``repro/core/designer.py``.  :func:`optimize_design` *returns*
the design instead of leaving a grid to eyeball.  It

1. solves the channels x LLC frontier grid under ``queue_model="memsim"``
   (the DES-derived :class:`~repro_torch.core.queuelut.QueueLUT` carries
   the p99-wait table, so every cell has a mechanistic tail),
2. ranks the frontier tail-aware -- ``SweepResult.pareto(tail=True)``
   orders by (area, mean speedup, p99) -- and starts at the knee of the
   within-budget subset (:func:`coaxial.knee_point`),
3. ascends the objective's gradient (``torch.autograd``) THROUGH the
   damped fixed point and the LUT's multilinear interpolation: geomean
   speedup of the workload mix, minus a quadratic penalty when the
   serving workload's p99 TOKEN latency (the capacity planner's wave
   model, composed in-loop from the differentiable ``latency_p99_ns``)
   exceeds the SLO,
4. projects each iterate onto the feasible set: clip to the box the
   frontier spec implies (:func:`sweepspec.field_bounds`), then bisect
   back toward the last feasible point until the Table-1/2 cost
   (:func:`coaxial.design_cost`) meets the area/pin budget -- the cost
   is monotone in (channels, LLC), so the segment crossing is unique,
5. re-verifies the returned optimum with ONE direct
   ``memsim.simulate(engine="event")`` run at the solved operating point
   (on the card: the hand kernel ``memsim_event_scan``) and gates the
   model-vs-DES p99 within the calibration tolerance.

The optimizer moves the continuous fields ``dram_channels`` (links tied
1:1 for CXL topologies, the coaxial-Nx idiom) and ``llc_mb_per_core``
(plus ``harvest_duty`` when harvesting); the DDR/CXL topology itself is
fixed by the starting point.  Everything runs on ``device=`` (default
the card): the frontier solve, every value-and-grad (autograd records
the fixed point's 120 steps and replays them backwards) and the DES.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core import (coaxial, cpu_model, hw, memsim, queuelut,
                              sweepspec)
from repro_torch.core.cpu_model import DDR_BASELINE, MemSystem
from repro_torch.core.workloads import WORKLOADS, as_arrays, resolve_device

#: Frontier grid the optimizer starts from (mirrors
#: ``benchmarks/pareto_frontier.py``'s channels x LLC plane).
DEFAULT_CHANNELS = tuple(range(1, 9))
DEFAULT_LLC_MB = (0.5, 1.0, 2.0, 4.0)
#: Ascent hyperparameters.
DEFAULT_ITERS = 40
DEFAULT_LR = 0.3
DEFAULT_TOL = 1e-4
#: SLO-violation penalty weight (objective units: geomean speedup).
DEFAULT_PENALTY = 10.0
#: Simulated 12-core slice -> full server (Table 2's scale factor).
SCALE = coaxial.FULL_CORES // hw.SIM_CORES
#: Model-vs-DES p99 gate at the returned optimum: same envelope as the
#: LUT's off-grid interpolation cross-check (relative OR absolute).
VERIFY_REL_TOL = 0.35
VERIFY_ABS_TOL_NS = 4.0


def default_steps() -> int:
    """Default LUT-build DES budget, honoring ``$REPRO_DES_STEPS``."""
    cap = os.environ.get("REPRO_DES_STEPS")
    if cap:
        return min(queuelut.DEFAULT_STEPS, int(cap))
    return queuelut.DEFAULT_STEPS


# ---------------------------------------------------------------------------
# The differentiable objective: one value-and-grad a step.
# ---------------------------------------------------------------------------

#: Evaluations of the objective.  The name is the reference's, whose
#: counter pins that an ascent costs ONE trace of its jitted
#: value-and-grad.  The port has no trace; its counter pins the other half
#: of that contract: an ascent evaluates the objective once per recorded
#: iterate, ``len(trajectory)`` times in all.
_TRACE_COUNT = [0]


def designer_trace_count() -> int:
    """Objective evaluations so far (one per recorded ascent iterate)."""
    return _TRACE_COUNT[0]


def _objective(x, sysa0, tie, wl, basea, n_active, base_ipc, lut,
               slo_s, waves, model_coef, penalty):
    """Penalized geomean speedup at design fields ``x`` (0-dim tensors).

    ``x`` binds ``dram_channels`` and ``llc_mb_per_core`` (plus
    ``harvest_duty`` when idle-I/O harvesting is an ascent variable --
    the lent bandwidth itself stays a constant of ``sysa0``); ``tie``
    (0/1) ties the link count to the channel count for CXL topologies.
    The SLO term composes the LAST workload's (the serving workload's)
    differentiable p99 access latency into the capacity planner's wave
    model: ``token_p99 = max(waves * latency_p99, model_coef / ipc)``,
    and charges ``penalty * relu(token_p99/slo - 1)^2``.  ``slo_s=inf``
    disables the constraint (the relu is exactly zero).  Both maxima are
    ``torch.maximum``, which splits the gradient at a tie as
    ``jnp.maximum`` does.  ``lut`` is a ``LutTables`` on the solve's
    device.
    """
    _TRACE_COUNT[0] += 1
    ch = x["dram_channels"]
    llc = x["llc_mb_per_core"]
    links = tie * ch + (1.0 - tie) * sysa0.links
    sysa = sysa0._replace(dram_channels=ch, links=links,
                          llc_mb_per_core=llc)
    if "harvest_duty" in x:
        sysa = sysa._replace(harvest_duty=x["harvest_duty"])
    nan = torch.full((), float("nan"), device=base_ipc.device)
    out = cpu_model._solve_point(wl, sysa, basea, n_active, nan, lut)
    ipc, lat99 = out[0], out[8]
    gm = torch.exp(torch.mean(torch.log(ipc / base_ipc)))
    tok99_s = torch.maximum(waves * lat99[-1] * 1e-9,
                            model_coef / ipc[-1])
    viol = torch.maximum(tok99_s / slo_s - 1.0, torch.zeros_like(tok99_s))
    value = gm - penalty * viol ** 2
    aux = dict(gm=gm, latency_p99_ns=lat99[-1], token_p99_s=tok99_s,
               rho=out[4][-1], ipc=ipc[-1], worst_p99_ns=torch.max(lat99))
    return value, aux


def _value_and_grad(x, sysa0, tie, wl, basea, n_active, base_ipc, lut,
                    slo_s, waves, model_coef, penalty):
    """``((value, aux), grad)`` of :func:`_objective` at the float fields
    ``x``: the reference's ``jax.value_and_grad(..., has_aux=True)``.
    Each field becomes a float32 leaf on ``base_ipc``'s device; the value,
    the aux values and the gradients come back as detached 0-dim
    tensors."""
    device = base_ipc.device
    leaves = {k: torch.tensor(float(v), dtype=torch.float32, device=device,
                              requires_grad=True) for k, v in x.items()}
    value, aux = _objective(leaves, sysa0, tie, wl, basea, n_active,
                            base_ipc, lut, slo_s, waves, model_coef,
                            penalty)
    grads = torch.autograd.grad(value, list(leaves.values()),
                                allow_unused=True)
    grad = {k: torch.zeros((), device=device) if g is None else g
            for k, g in zip(leaves, grads)}
    return (value.detach(), {k: v.detach() for k, v in aux.items()}), grad


def ascent_objective(start: MemSystem, workloads, lut, *, arch, batch,
                     context, slo_ms, penalty=DEFAULT_PENALTY,
                     device="cuda"):
    """The ascent's ``value_and_grad(x)`` from ``start`` (what
    :func:`optimize_design` ascends): the mix ``workloads`` (the SLO
    workload last) and the baseline's IPC solved through ``lut`` on
    ``device``, the wave geometry of ``arch``, the links tied to the
    channels when ``start`` is CXL."""
    device = resolve_device(device)
    base_ipc = torch.from_numpy(
        cpu_model.solve(DDR_BASELINE, baseline=DDR_BASELINE,
                        workloads=workloads, queue_model="memsim",
                        lut=lut, device=device).ipc.astype(np.float32)
    ).to(device)
    waves, model_coef = _wave_geometry(arch, batch, context)
    slo_s = float("inf") if slo_ms is None else slo_ms * 1e-3
    j = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)
    args = (start.as_arrays(device=device), j(1.0 if start.is_cxl else 0.0),
            as_arrays(workloads, device=device),
            DDR_BASELINE.as_arrays(device=device), j(hw.SIM_CORES),
            base_ipc, lut.tables(device), j(slo_s), j(waves),
            j(model_coef), j(penalty))
    return lambda x: _value_and_grad(x, *args)


# ---------------------------------------------------------------------------
# Projection: box clip + bisection back to the budget surface.
# ---------------------------------------------------------------------------

def _clip_box(x: dict, box: dict) -> dict:
    return {k: float(np.clip(v, *box[k])) for k, v in x.items()}


def _cost_of(x: dict, tie: float, links0: float) -> dict:
    ch = x["dram_channels"]
    links = tie * ch + (1.0 - tie) * links0
    c = coaxial.design_cost(ch, links, x["llc_mb_per_core"])
    return {k: float(v) for k, v in c.items()}


def _within_budget(cost: dict, area_budget: float,
                   pin_budget: float) -> bool:
    return (cost["rel_area"] <= area_budget + 1e-9
            and cost["rel_pins"] <= pin_budget + 1e-9)


def make_projector(box: dict, area_budget: float, pin_budget: float,
                   tie: float, links0: float):
    """Projection onto the feasible set for :func:`projected_ascent`.

    Feasible = inside ``box`` AND Table-1/2 cost within the budgets.
    The returned function clips to the box, then -- if the budget is
    violated -- bisects along the segment back to the (feasible)
    previous iterate: the cost is monotone in every field, so the
    segment crosses the budget surface exactly once.
    """
    def project(x: dict, x_prev: dict | None) -> dict:
        x = _clip_box(x, box)
        if _within_budget(_cost_of(x, tie, links0), area_budget,
                          pin_budget):
            return x
        if x_prev is None:
            raise ValueError(
                f"infeasible start {x}: cost {_cost_of(x, tie, links0)} "
                f"exceeds budget (area<={area_budget}, "
                f"pins<={pin_budget})")
        lo, hi = 0.0, 1.0  # t=0 is x_prev (feasible), t=1 is x
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            xm = {k: x_prev[k] + mid * (x[k] - x_prev[k]) for k in x}
            if _within_budget(_cost_of(xm, tie, links0), area_budget,
                              pin_budget):
                lo = mid
            else:
                hi = mid
        return {k: x_prev[k] + lo * (x[k] - x_prev[k]) for k in x}

    return project


def projected_ascent(x0: dict, value_and_grad, project, *,
                     widths: dict, lr: float = DEFAULT_LR,
                     iters: int = DEFAULT_ITERS,
                     tol: float = DEFAULT_TOL):
    """Generic projected-gradient-ascent loop.

    ``value_and_grad(x) -> ((value, aux), grad)`` with ``grad`` a dict
    matching ``x``; ``project(x, x_prev) -> x`` maps any point onto the
    feasible set (``x_prev`` is the last feasible iterate, or None for
    the start).  Steps are preconditioned by the squared box widths
    (``x += lr * g * width^2``), so fields on wildly different scales
    (channels ~1..8, LLC ~0.5..4) move comparably.  Stops early when the
    projected step falls below ``tol`` in box-relative units.

    Returns ``(x, trajectory, converged)``; ``trajectory`` has one entry
    per evaluated iterate (the start included), each carrying the fields,
    objective value and aux -- exactly one ``value_and_grad`` call per
    entry, ``iters + 1`` at most.
    """
    x = project(dict(x0), None)
    traj = []
    converged = False
    for it in range(int(iters)):
        (value, aux), g = value_and_grad(x)
        traj.append(dict(iter=it, **x, objective=float(value),
                         **{k: float(v) for k, v in aux.items()}))
        x_new = project({k: x[k] + lr * float(g[k]) * widths[k] ** 2
                         for k in x}, x)
        step = max(abs(x_new[k] - x[k]) / widths[k] for k in x)
        x = x_new
        if step < tol:
            converged = True
            break
    (value, aux), _ = value_and_grad(x)
    traj.append(dict(iter=len(traj), **x, objective=float(value),
                     **{k: float(v) for k, v in aux.items()}))
    return x, traj, converged


# ---------------------------------------------------------------------------
# The end-to-end designer.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DesignerResult:
    """The optimized design plus everything needed to audit it."""

    design: MemSystem        # the returned (continuous-field) optimum
    start: MemSystem         # the frontier-knee starting point
    frontier: tuple          # pareto(tail=True) points the knee came from
    gm_speedup: float        # geomean speedup of the mix at the optimum
    rel_area: float
    rel_pins: float
    area_budget: float
    pin_budget: float
    slo_ms: float | None
    token_p99_ms: float      # in-loop wave-model token p99 (SLO workload)
    latency_p99_ns: float    # in-loop p99 access latency (SLO workload)
    meets_budget: bool
    meets_slo: bool          # in-loop token p99 vs the SLO
    iters: int               # objective evaluations spent
    converged: bool
    trajectory: tuple        # per-iterate records (fields, value, aux)
    verify: dict             # direct-DES re-verification at the optimum

    def summary(self) -> str:
        d, v = self.design, self.verify
        lines = [
            f"start   {self.start.name}: ch={self.start.dram_channels:g} "
            f"llc={self.start.llc_mb_per_core:g}MB",
            f"optimum ch={float(d.dram_channels):.2f} "
            f"llc={float(d.llc_mb_per_core):.2f}MB "
            f"links={float(d.links):.2f}"
            + ("" if not d.harvest_duty else
               f" harvest duty={float(d.harvest_duty):.2f}"
               f"@{float(d.harvest_bw_gbps):g}GB/s"),
            f"cost    rel_area={self.rel_area:.3f} (<= {self.area_budget:g})"
            f" rel_pins={self.rel_pins:.3f}"
            + ("" if np.isinf(self.pin_budget)
               else f" (<= {self.pin_budget:g})"),
            f"mix     geomean speedup {self.gm_speedup:.3f}x "
            f"in {self.iters} iters"
            f" ({'converged' if self.converged else 'budget-limited'})",
            f"tail    access p99 {self.latency_p99_ns:.0f}ns -> token p99 "
            f"{self.token_p99_ms:.2f}ms"
            + ("" if self.slo_ms is None
               else f" (SLO {self.slo_ms:g}ms: "
                    f"{'ok' if self.meets_slo else 'MISS'})"),
            f"verify  DES p99 {v['des_p99_ns']:.0f}ns vs model "
            f"{v['model_p99_ns']:.0f}ns (rel err {v['rel_err']:+.2%}, "
            f"{'ok' if v['ok'] else 'DRIFT'})",
        ]
        return "\n".join(lines)


def _frontier_designs(channels) -> list[MemSystem]:
    """DDR baseline + one coaxial-Nx-idiom point per channel count."""
    return [DDR_BASELINE] + [
        MemSystem(f"designer-cxl-{ch}x", dram_channels=ch, links=ch,
                  link_rd_gbps=hw.CXL_X8_RD_GBPS,
                  link_wr_gbps=hw.CXL_X8_WR_GBPS,
                  iface_lat_ns=hw.CXL_LAT_NS, llc_mb_per_core=1.0)
        for ch in channels]


def _wave_geometry(arch: str | None, batch: int, context: int):
    """(waves, model_coef) of the capacity planner's token composition;
    both constants w.r.t. the design fields (plain floats)."""
    if arch is None:
        return 0.0, 0.0
    from repro_torch.serving.demand import decode_demand
    d = decode_demand(arch, batch=batch, context=context)
    in_flight = hw.MAX_MLP * hw.SIM_CORES * SCALE
    waves = max(batch * d.read_bytes / hw.CACHE_LINE_B / in_flight, 1.0)
    model_coef = (batch * d.inst_per_token /
                  (hw.CORE_CLK_GHZ * 1e9 * hw.SIM_CORES * SCALE))
    return waves, model_coef


def _verify_optimum(*, rho, kappa, eta, outstanding, premium_ns,
                    model_p99_ns, steps, seed, engine="event",
                    harvest_duty=0.0, harvest_bw_gbps=0.0,
                    device="cuda") -> dict:
    """ONE direct DES run at the optimum's operating point, on ``device``.

    The channel config mirrors the LUT's build base (default transfer
    and service constants) at the solved (rho, kappa, outstanding, eta)
    and the design's CXL premium; ``rho`` is clamped to the LUT hull so
    the comparison judges the table's interpolation, not extrapolation
    beyond where the surface was ever built.  A harvesting optimum runs
    the DES with the TRUE per-channel ``(harvest_duty, harvest_bw_gbps)``
    pair -- this is the backstop for the LUT's reference-bandwidth
    ``duty_eff`` reduction (see queuelut.DEFAULT_HARVEST_GRID).
    """
    rho_c = float(np.clip(rho, queuelut.DEFAULT_RHO_GRID[0],
                          queuelut.DEFAULT_RHO_GRID[-1]))
    cfg = memsim.ChannelConfig(
        rho=rho_c, kappa=float(kappa), outstanding=float(outstanding),
        eta=float(eta), cxl_lat_ns=float(premium_ns),
        harvest_duty=float(harvest_duty),
        harvest_bw_gbps=float(harvest_bw_gbps))
    stats = memsim.simulate([cfg], steps=int(steps), seed=int(seed),
                            engine=engine, device=device)
    des99 = float(np.asarray(stats.p99_ns).reshape(-1)[0])
    rel_err = (des99 - model_p99_ns) / max(model_p99_ns, 1e-9)
    ok = (abs(rel_err) <= VERIFY_REL_TOL
          or abs(des99 - model_p99_ns) <= VERIFY_ABS_TOL_NS)
    return dict(engine=engine, steps=int(steps), rho=rho_c,
                kappa=float(kappa), eta=float(eta),
                outstanding=float(outstanding),
                premium_ns=float(premium_ns),
                harvest_duty=float(harvest_duty),
                harvest_bw_gbps=float(harvest_bw_gbps),
                des_p99_ns=des99,
                model_p99_ns=float(model_p99_ns),
                rel_err=float(rel_err), ok=bool(ok))


def optimize_design(*, area_budget: float = 1.2,
                    pin_budget: float | None = None,
                    slo_ms: float | None = 500.0,
                    arch: str | None = "stablelm-1.6b",
                    batch: int = 32, context: int = 2048,
                    channels=DEFAULT_CHANNELS, llc_mb=DEFAULT_LLC_MB,
                    cost: str = "rel_area",
                    iters: int = DEFAULT_ITERS, lr: float = DEFAULT_LR,
                    tol: float = DEFAULT_TOL,
                    penalty: float = DEFAULT_PENALTY,
                    harvest_bw_gbps: float = 0.0,
                    harvest_duty_max: float | None = None,
                    lut=None, steps: int | None = None, seed: int = 0,
                    engine: str = "event",
                    verify_steps: int | None = None,
                    workloads=None, device="cuda") -> DesignerResult:
    """Optimize a memory system under an area/pin budget and a p99 SLO.

    See the module docstring for the five stages.  ``arch`` names the
    serving workload whose wave-model TOKEN p99 carries the SLO (its
    derived LLM workload joins the Table-4 mix); ``slo_ms=None`` or
    ``arch=None`` drops the constraint.  ``lut``/``steps``/``engine``
    control the QueueLUT surface (default: the default grid at
    :func:`default_steps`, resolved through the persistent LUT store --
    with a warm ``$REPRO_LUT_CACHE`` the optimizer starts without
    running the DES at all); ``verify_steps`` the final DES
    re-verification budget (default: the LUT's).

    ``harvest_bw_gbps > 0`` makes idle-I/O harvesting (arXiv 2511.12349)
    a THIRD ascent variable: the design may lend that much idle I/O
    bandwidth per DRAM channel, and ``harvest_duty`` joins the ascent in
    the box ``[0, harvest_duty_max]`` (default: the top of the LUT's
    harvest grid -- the ascent stays on the measured surface).  Lending
    idle links costs no area or pins, so the projection leaves the duty
    untouched; the QueueLUT then needs its harvest axis (the default
    build gains it automatically).  Everything runs on ``device``.
    Returns a :class:`DesignerResult`; ``result.design`` is the
    optimized (continuous-field) :class:`MemSystem`.
    """
    if slo_ms is not None and arch is None:
        raise ValueError("an SLO needs a serving workload: pass arch=")
    device = resolve_device(device)
    steps = default_steps() if steps is None else int(steps)
    harvesting = float(harvest_bw_gbps) > 0.0
    if lut is None:
        lut = queuelut.default_queue_lut(steps=steps, engine=engine,
                                         harvest=harvesting, device=device)
    elif harvesting and lut.harvest_grid is None:
        raise ValueError("harvest_bw_gbps > 0 needs a QueueLUT with the "
                         "harvest axis; build_queue_lut(harvest=...) or "
                         "pass lut=None")
    if harvest_duty_max is None:
        harvest_duty_max = (float(lut.harvest_grid[-1]) if harvesting
                            else 0.0)
    pin_budget = float("inf") if pin_budget is None else float(pin_budget)

    if workloads is None:
        workloads = tuple(WORKLOADS)
        if arch is not None:
            from repro_torch.serving.demand import llm_workload
            workloads += (llm_workload(arch, batch=batch,
                                       context=context),)
    else:
        workloads = tuple(workloads)

    # -- stage 1+2: tail-ranked frontier, knee of the in-budget subset --
    designs = _frontier_designs(channels)
    spec = sweepspec.sweep_spec(design=designs, llc_mb_per_core=llc_mb)
    sw = coaxial.solve_spec(spec, workloads=workloads,
                            queue_model="memsim", lut=lut, device=device)
    frontier = sw.pareto(cost=cost, tail=True)
    feasible = [p for p in frontier
                if p["rel_area"] <= area_budget + 1e-9
                and p["rel_pins"] <= pin_budget + 1e-9]
    if not feasible:
        cheapest = min(frontier, key=lambda p: (p["rel_area"],
                                                p["rel_pins"]))
        raise ValueError(
            f"no frontier point fits the budget (area<={area_budget}, "
            f"pins<={pin_budget}); cheapest frontier point costs "
            f"rel_area={cheapest['rel_area']:.3f}, "
            f"rel_pins={cheapest['rel_pins']:.3f}")
    knee = coaxial.knee_point(feasible, cost=cost)
    start = dataclasses.replace(
        next(d for d in designs if d.name == knee["design"]),
        llc_mb_per_core=float(knee["llc_mb_per_core"]),
        harvest_bw_gbps=float(harvest_bw_gbps))

    # -- stage 3+4: projected ascent from the knee ----------------------
    bounds = sweepspec.field_bounds(spec)
    box = {f: bounds[f] for f in ("dram_channels", "llc_mb_per_core")}
    if harvesting:
        box["harvest_duty"] = (0.0, float(harvest_duty_max))
    widths = {f: hi - lo for f, (lo, hi) in box.items()}
    tie = 1.0 if start.is_cxl else 0.0
    project = make_projector(box, float(area_budget), pin_budget, tie,
                             float(start.links))

    value_and_grad = ascent_objective(
        start, workloads, lut, arch=arch, batch=batch, context=context,
        slo_ms=slo_ms, penalty=penalty, device=device)
    x0 = {"dram_channels": float(start.dram_channels),
          "llc_mb_per_core": float(start.llc_mb_per_core)}
    if harvesting:
        x0["harvest_duty"] = 0.0
    x, traj, converged = projected_ascent(
        x0, value_and_grad, project, widths=widths, lr=lr, iters=iters,
        tol=tol)

    # -- stage 5: package + direct-DES re-verification ------------------
    final = traj[-1]
    ch = x["dram_channels"]
    links = tie * ch + (1.0 - tie) * float(start.links)
    costs = _cost_of(x, tie, float(start.links))
    design = dataclasses.replace(
        start, name="designer-opt", dram_channels=ch, links=links,
        llc_mb_per_core=x["llc_mb_per_core"],
        harvest_duty=x.get("harvest_duty", 0.0),
        rel_area=costs["rel_area"], rel_pins=costs["rel_pins"])
    slo_wl = workloads[-1]
    outstanding = hw.SIM_CORES * hw.MAX_MLP / max(ch, 1e-9)
    verify = _verify_optimum(
        rho=final["rho"], kappa=slo_wl.kappa, eta=slo_wl.eta,
        outstanding=outstanding, premium_ns=design.iface_lat_ns,
        model_p99_ns=final["latency_p99_ns"],
        steps=steps if verify_steps is None else int(verify_steps),
        seed=seed, engine="event",
        harvest_duty=design.harvest_duty,
        harvest_bw_gbps=design.harvest_bw_gbps, device=device)
    tok99_ms = final["token_p99_s"] * 1e3
    return DesignerResult(
        design=design, start=start, frontier=tuple(frontier),
        gm_speedup=final["gm"], rel_area=costs["rel_area"],
        rel_pins=costs["rel_pins"], area_budget=float(area_budget),
        pin_budget=pin_budget, slo_ms=slo_ms,
        token_p99_ms=tok99_ms,
        latency_p99_ns=final["latency_p99_ns"],
        meets_budget=_within_budget(costs, float(area_budget),
                                    pin_budget),
        meets_slo=bool(slo_ms is None or tok99_ms <= slo_ms),
        iters=len(traj), converged=converged, trajectory=tuple(traj),
        verify=verify)
