"""End-to-end COAXIAL evaluation engine (paper §4-§6, Tables 2 & 5).

Port of ``repro/core/coaxial.py``.  Everything the paper reports is
derivable from here:

  * :func:`sweep` / :func:`solve_spec` -- the design-space engine: one
    solver pass over a grid of named axes, returning a
    :class:`SweepResult` from which all figures slice;
  * :func:`evaluate` -- per-workload speedups, latency breakdowns and
    utilizations for any design point (Figs 5, 7, 8, 9);
  * :func:`register_design` / :func:`get_design` / :func:`all_designs` --
    the design registry;
  * :func:`area_report` / :func:`pin_report` -- Table 1/2 accounting;
  * :func:`edp_report` -- the §6.6 power and energy-delay-product model
    (Table 5);
  * :func:`sensitivity_latency` / :func:`sensitivity_cores` -- §6.4 / §6.5;
  * :func:`headline` -- every headline number from ONE batched sweep.

A sweep lowers to ONE flattened call of the cell solver
(``cpu_model.solve_cells``) on ``device`` (default ``"cuda"``; tests pass
``"cpu"``) per queue backend, whatever its axes::

    sw = coaxial.solve_spec(coaxial.sweep_spec(
        design=coaxial.all_designs(), iface_lat_ns=[None, 50.0],
        llc_mb_per_core=np.linspace(0.5, 4, 8), kappa=[1.0, 1.6, 3.2]))
    sw.sel(design="coaxial-4x", kappa=1.6).geomean_grid()
    sw.pareto()                      # area/pins vs speedup frontier

The DES is a sweep target too (the distribution half): on ``device``,

  * :func:`distribution_sweep` -- named-axis latency distributions from
    ``memsim`` (:class:`DistributionSweepResult`, ``sel``/``cell``/
    ``curve``);
  * :func:`validate_calibration` -- DES vs the closed form at the rho
    anchors (mean / p90 / stdev gates);
  * :func:`crosscheck_engines` -- timestep vs event engine.

The fixed point's queue backend is a choice per solve:
``queue_model="memsim"`` (argument or axis) solves through the
DES-derived :class:`QueueLUT` (``lut=``, or :func:`default_queue_lut`
resolved through the LUT store), which also gives each cell its p99
latency: ``SweepResult.p99_grid`` and ``pareto(tail=True)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import cpu_model, hw, memsim, queueing
from repro_torch.core import workloads as _workloads
from repro_torch.core.cpu_model import (COAXIAL_2X, COAXIAL_4X, COAXIAL_5X,
                                        COAXIAL_ASYM, DDR_BASELINE, DESIGNS,
                                        QUEUE_MODELS, MemSystem, ModelResult,
                                        design_gradient, geomean, solve,
                                        solve_batch)
from repro_torch.core.memsim import ChannelConfig, LatencyStats
from repro_torch.core.queuelut import (QueueLUT, build_queue_lut,
                                       default_queue_lut)
from repro_torch.core.sweepspec import (KIND_DESIGN, KIND_IFACE,
                                        KIND_N_ACTIVE, KIND_QUEUE_MODEL,
                                        KIND_WORKLOAD_FIELD, Axis, SweepSpec,
                                        _flat, build_flat, build_flat_memsim,
                                        distribution_spec, sweep_spec)
from repro_torch.core.workloads import NAMES, WORKLOADS

__all__ = [
    "COAXIAL_2X", "COAXIAL_4X", "COAXIAL_5X", "COAXIAL_ASYM", "DDR_BASELINE",
    "DESIGNS", "MemSystem", "evaluate", "Comparison", "SweepResult", "sweep",
    "Axis", "SweepSpec", "sweep_spec", "solve_spec", "design_gradient",
    "default_sweep", "register_design", "unregister_design", "get_design",
    "all_designs", "scoped_registry", "knee_point",
    "area_report", "pin_report", "design_cost", "edp_report",
    "sensitivity_latency", "sensitivity_cores", "headline", "QUEUE_MODELS",
    "ChannelConfig", "LatencyStats", "DistributionSweepResult",
    "distribution_spec", "distribution_sweep", "validate_calibration",
    "crosscheck_engines", "QueueLUT", "build_queue_lut", "default_queue_lut",
]


# ---------------------------------------------------------------------------
# Design registry.  Seeded with the paper's Table-2 points; configs and the
# planner register additional points (e.g. channel-count sweeps) at runtime.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, MemSystem] = {}


def register_design(sys: MemSystem, *, overwrite: bool = False) -> MemSystem:
    """Add a design point to the registry (and to every future sweep).

    Re-registering the SAME design is an idempotent no-op (the existing
    entry is returned and the sweep cache is left warm); only a
    *different* design under an existing name raises without
    ``overwrite`` -- that is the silent-shadowing case worth refusing.
    """
    prev = _REGISTRY.get(sys.name)
    if prev is not None:
        if prev == sys:
            return prev
        if not overwrite:
            raise ValueError(f"design {sys.name!r} already registered "
                             f"with different parameters")
    _REGISTRY[sys.name] = sys
    default_sweep.cache_clear()
    return sys


def unregister_design(name: str) -> MemSystem:
    """Remove a registered design point (the seed points may be removed
    too, but the DDR baseline is always re-added by :func:`sweep`)."""
    sys = _REGISTRY.pop(name)
    default_sweep.cache_clear()
    return sys


def get_design(name: str) -> MemSystem:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown design {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def all_designs() -> tuple[MemSystem, ...]:
    """All registered design points, registration-ordered."""
    return tuple(_REGISTRY.values())


for _d in DESIGNS:
    _REGISTRY[_d.name] = _d
del _d


@contextlib.contextmanager
def scoped_registry():
    """Snapshot both runtime registries; restore them on exit.

    Guards the design registry (this module) and the workload registry
    (:mod:`workloads`) against mutation leaks: anything
    registered inside the ``with`` block -- measured devices, LLM
    workloads, planner candidates -- is rolled back afterwards, and the
    :func:`default_sweep` cache is invalidated iff the registries
    actually changed, so later sweeps solve exactly the pre-block world.
    Reentrant and exception-safe (restore runs in a ``finally``).
    """
    designs = dict(_REGISTRY)
    wls = dict(_workloads._REGISTRY)
    try:
        yield
    finally:
        changed = (_REGISTRY != designs
                   or _workloads._REGISTRY != wls)
        _REGISTRY.clear()
        _REGISTRY.update(designs)
        _workloads._REGISTRY.clear()
        _workloads._REGISTRY.update(wls)
        if changed:
            default_sweep.cache_clear()


@dataclasses.dataclass
class Comparison:
    """A design point evaluated against the DDR baseline."""

    sys: MemSystem
    base: ModelResult
    res: ModelResult
    names: tuple

    @property
    def speedup(self) -> np.ndarray:
        return self.res.speedup_vs(self.base)

    @property
    def geomean_speedup(self) -> float:
        return geomean(self.speedup, self.names)

    @property
    def n_above_2x(self) -> int:
        return int(np.sum(self.speedup > 2.0))

    @property
    def n_regressions(self) -> int:
        return int(np.sum(self.speedup < 0.995))

    @property
    def worst(self) -> tuple[str, float]:
        i = int(np.argmin(self.speedup))
        return self.names[i], float(self.speedup[i])

    @property
    def best(self) -> tuple[str, float]:
        i = int(np.argmax(self.speedup))
        return self.names[i], float(self.speedup[i])

    def row(self, name: str) -> dict:
        i = self.names.index(name)
        return dict(
            name=name, speedup=float(self.speedup[i]),
            base_latency_ns=float(self.base.latency_ns[i]),
            base_queue_ns=float(self.base.queue_ns[i]),
            latency_ns=float(self.res.latency_ns[i]),
            queue_ns=float(self.res.queue_ns[i]),
            base_rho=float(self.base.rho[i]), rho=float(self.res.rho[i]),
        )

    def summary(self) -> dict:
        return dict(
            design=self.sys.name,
            geomean_speedup=self.geomean_speedup,
            best=self.best, worst=self.worst,
            n_above_2x=self.n_above_2x, n_regressions=self.n_regressions,
            mean_base_queue_ns=float(np.mean(self.base.queue_ns)),
            mean_queue_ns=float(np.mean(self.res.queue_ns)),
            mean_base_rho=float(np.mean(self.base.rho)),
            mean_rho=float(np.mean(self.res.rho)),
            queue_share_of_latency=float(np.mean(
                self.base.queue_ns / self.base.latency_ns)),
            max_queue_share=float(np.max(
                self.base.queue_ns / self.base.latency_ns)),
        )


# ---------------------------------------------------------------------------
# The sweep engine.
# ---------------------------------------------------------------------------

_UNSET = object()


class _NamedAxes:
    """Shared axis plumbing for named-axis result containers (the
    model-sweep result here; the reference's distribution-sweep result
    carries an ``axes`` tuple and resolves coordinates the same way)."""

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(ax) for ax in self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(ax.name for ax in self.axes)

    def _axis_pos(self, name: str) -> int:
        for p, ax in enumerate(self.axes):
            if ax.name == name:
                return p
        raise KeyError(f"no axis {name!r} in sweep; axes: "
                       f"{list(self.axis_names)}")

    def axis(self, name: str) -> Axis:
        return self.axes[self._axis_pos(name)]


@dataclasses.dataclass(frozen=True)
class SweepResult(_NamedAxes):
    """Stacked model results over a grid of named axes.

    ``results`` arrays have shape ``spec shape + (n_workloads,)``; the
    axes (in grid order) name each dimension.  Individual
    :class:`ModelResult` slices and baseline :class:`Comparison` objects
    are views into the one batched solve -- no further fixed-point
    iteration happens after construction (:meth:`speedup_grid` solves
    its un-overridden baseline column once, on demand).  Cells are selected
    by coordinate, never by position: ``sw.sel(design="coaxial-4x",
    kappa=1.6)``, with numeric coordinates matched tolerantly
    (``iface_lat_ns=50`` and ``50.0`` resolve identically).
    """

    axes: tuple[Axis, ...]
    names: tuple[str, ...]
    results: ModelResult
    baseline_name: str = DDR_BASELINE.name
    workloads: tuple = WORKLOADS
    baseline_sys: MemSystem = DDR_BASELINE
    #: Length-1 axes recording the coordinates :meth:`sel` pinned, so the
    #: baseline reference and cost accounting keep honouring them.
    pinned: tuple[Axis, ...] = ()
    #: Queue-wait backend the grid was solved under; when a
    #: ``queue_model`` AXIS is present it overrides this scalar per cell.
    queue_model: str = "closed_form"
    #: Device the grid was solved on; the baseline reference re-solves there.
    device: str = "cuda"
    #: Resolved :class:`QueueLUT` (memsim backend only) so the baseline
    #: reference re-solves against the same surface.
    lut: object = dataclasses.field(default=None, repr=False, compare=False)

    # -- legacy positional views (the historical D/L/C triple) ------------

    @property
    def designs(self) -> tuple[MemSystem, ...]:
        return self.axis("design").values

    @property
    def iface_lats(self) -> tuple:
        return self.axis("iface_lat_ns").values

    @property
    def cores(self) -> tuple[int, ...]:
        return tuple(int(v) for v in self.axis("n_active").values)

    def design_index(self, sys) -> int:
        return self.axis("design").index(sys)

    # -- coordinate resolution --------------------------------------------

    def _coord_index(self, ax: Axis, value, design=None) -> int:
        """Axis lookup + the iface aliasing rule: for a given design, its
        own premium and an equal explicit override are the same column
        (the solver's NaN mask makes them identical)."""
        try:
            return ax.index(value)
        except KeyError as err:
            if ax.kind == KIND_IFACE and design is not None:
                if value is None:
                    try:
                        return ax.index(design.iface_lat_ns)
                    except KeyError:
                        pass
                else:
                    try:
                        aliases = np.isclose(float(value),
                                             design.iface_lat_ns,
                                             rtol=1e-6, atol=1e-12)
                    except (TypeError, ValueError):
                        aliases = False
                    if aliases:
                        try:
                            return ax.index(None)
                        except KeyError:
                            pass
            raise err

    def _design_ctx(self, coords):
        """Validate coordinate names; resolve the design the coordinates
        address (the iface-aliasing context), if any."""
        for k in coords:
            if k not in self.axis_names:
                raise KeyError(f"no axis {k!r} in sweep; axes: "
                               f"{list(self.axis_names)}")
        if "design" in coords:
            dax = self.axis("design")
            return dax.values[dax.index(coords["design"])]
        return None

    def indices(self, **coords) -> tuple[int, ...]:
        """Full grid index from named coordinates.

        Axes of length 1 may be omitted; any longer axis must be pinned.
        """
        design = self._design_ctx(coords)
        out = []
        for ax in self.axes:
            if ax.name in coords:
                out.append(self._coord_index(ax, coords[ax.name], design))
            elif len(ax) == 1:
                out.append(0)
            else:
                raise KeyError(
                    f"axis {ax.name!r} has {len(ax)} coordinates; pass "
                    f"{ax.name}=<one of {list(ax.coords)}>")
        return tuple(out)

    def sel(self, **coords) -> "SweepResult":
        """Select coordinates by axis name; each selected axis is dropped.

        ``sw.sel(design="coaxial-4x", kappa=1.6)`` replaces the historical
        positional index triple.  Partial selection returns a reduced
        sweep over the remaining axes; the selected coordinates stay
        pinned, so :meth:`speedup_grid` / :meth:`pareto` keep comparing
        and costing the reduced grid at those coordinates.

        Example::

            >>> from repro_torch.core import coaxial
            >>> sw = coaxial.sweep((coaxial.DDR_BASELINE,
            ...                     coaxial.COAXIAL_4X),
            ...                    iface_lat_grid=(None, 50.0), device="cpu")
            >>> sub = sw.sel(design="coaxial-4x", iface_lat_ns=50.0)
            >>> sub.axis_names           # selected axes are dropped
            ('n_active',)
            >>> sub.results.ipc.shape    # one cell x 35 workloads
            (1, 35)
            >>> sw.sel(design="coaxial-4x", iface_lat_ns=50
            ...        ).results.ipc.shape    # tolerant numeric lookup
            (1, 35)
        """
        design = self._design_ctx(coords)
        res = self.results
        kept: list[Axis] = []
        pins: list[Axis] = []
        pos = 0
        for ax in self.axes:
            if ax.name in coords:
                i = self._coord_index(ax, coords[ax.name], design)
                res = res[(slice(None),) * pos + (i,)]
                pins.append(Axis(ax.name, (ax.values[i],), ax.kind))
            else:
                kept.append(ax)
                pos += 1
        return dataclasses.replace(self, axes=tuple(kept), results=res,
                                   pinned=self.pinned + tuple(pins))

    def _legacy_coords(self, sys, iface_lat, n_active, coords) -> dict:
        coords = dict(coords)
        if sys is not None:
            coords.setdefault("design", sys)
        if iface_lat is not _UNSET:
            coords["iface_lat_ns"] = iface_lat
        elif "iface_lat_ns" in self.axis_names:
            coords.setdefault("iface_lat_ns", None)
        if n_active is not _UNSET:
            coords["n_active"] = n_active
        elif "n_active" in self.axis_names:
            coords.setdefault("n_active", hw.SIM_CORES)
        return coords

    def result(self, sys=None, *, iface_lat=_UNSET, n_active=_UNSET,
               **coords) -> ModelResult:
        """The ``(n_workloads,)`` ModelResult slice for one grid point."""
        coords = self._legacy_coords(sys, iface_lat, n_active, coords)
        return self.results[self.indices(**coords)]

    def comparison(self, sys, *, iface_lat=_UNSET, n_active=_UNSET,
                   **coords) -> Comparison:
        """``sys`` vs the DDR baseline at the same grid coordinates.

        The baseline is sliced from the same non-design cell as ``sys``
        (it ignores the latency override -- no CXL interface -- so any
        latency column serves as its reference).
        """
        coords = self._legacy_coords(sys, iface_lat, n_active, coords)
        idx = self.indices(**coords)
        p = self._axis_pos("design")
        bidx = idx[:p] + (self.design_index(self.baseline_name),) + idx[p + 1:]
        return Comparison(sys=self.axis("design").values[idx[p]],
                          base=self.results[bidx], res=self.results[idx],
                          names=self.names)

    # -- grid-level reductions --------------------------------------------

    def geomean_grid(self) -> np.ndarray:
        """Geomean speedup vs the in-grid baseline row, for every cell.

        Shape = the grid shape.  The reference is the baseline design at
        the SAME non-design coordinates, so axes that override the
        baseline too (workload or design-field axes) compare like against
        like; :meth:`speedup_grid` compares against the un-overridden
        baseline instead.  Once :meth:`sel` has pinned the design axis the
        in-grid baseline row is gone, so this delegates to
        :meth:`speedup_grid` (identical whenever no design-field axis is
        in play).
        """
        if "design" not in self.axis_names:
            return self.speedup_grid()
        p = self._axis_pos("design")
        b = self.design_index(self.baseline_name)
        ipc = self.results.ipc
        base = np.take(ipc, [b], axis=p)
        return np.exp(np.mean(np.log(ipc / base), axis=-1))

    @functools.cached_property
    def _baseline_ipc(self) -> np.ndarray:
        """IPC of the UN-overridden baseline design at every cell's
        workload / core-count coordinates (design and design-field axes
        pinned to the plain baseline): the fixed reference column for
        :meth:`speedup_grid` and :meth:`pareto`.

        The baseline only varies along ``n_active``, workload and
        ``queue_model`` axes (and the iface axis if the baseline itself
        is CXL), so only those are solved -- sel()-pinned coordinates
        included -- and the result is broadcast across the rest of the
        grid.  A queue-model axis is a per-backend re-solve (each backend
        gets its own reference, never one across models).
        """
        base = self.baseline_sys
        varying = (KIND_N_ACTIVE, KIND_WORKLOAD_FIELD, KIND_QUEUE_MODEL) + (
            (KIND_IFACE,) if base.is_cxl else ())
        live = [ax for ax in self.axes if ax.kind in varying]
        pins = [ax for ax in self.pinned if ax.kind in varying]
        qax = next((ax for ax in live + pins
                    if ax.kind == KIND_QUEUE_MODEL), None)
        solve_live = [ax for ax in live if ax.kind != KIND_QUEUE_MODEL]
        solve_pins = [ax for ax in pins if ax.kind != KIND_QUEUE_MODEL]
        spec = SweepSpec((Axis("design", (base,), KIND_DESIGN),
                          *solve_live, *solve_pins))
        flat = build_flat(spec, pin_design=base)
        backends = (tuple(qax.values) if qax is not None
                    else (self.queue_model,))
        cells = []
        for qm in backends:
            res = cpu_model.solve_cells(
                flat["sysa"], n_active=flat["n_active"],
                iface_override_ns=flat["iface_override_ns"],
                workload_overrides=flat["workload_overrides"],
                baseline=base, workloads=self.workloads,
                queue_model=qm, lut=self.lut, device=self.device)
            w = res.ipc.shape[-1]
            cells.append(res.ipc.reshape(
                tuple(len(ax) for ax in solve_live) + (w,)))
        if qax is not None and qax in live:
            # Stack the per-backend references at the axis' live position.
            ipc = np.stack(cells, axis=live.index(qax))
        else:
            ipc = cells[0]
        w = ipc.shape[-1]
        # Broadcastable view: live-axis lengths in grid position, 1 elsewhere.
        bshape = tuple(len(ax) if ax.kind in varying else 1
                       for ax in self.axes) + (w,)
        return ipc.reshape(bshape)

    def speedup_grid(self) -> np.ndarray:
        """Geomean speedup of every cell vs the fixed, un-overridden
        baseline design (workload axes still apply to the reference --
        a modified workload is compared on both systems)."""
        ratio = self.results.ipc / self._baseline_ipc
        return np.exp(np.mean(np.log(ratio), axis=-1))

    def _effective_fields(self) -> dict[str, np.ndarray]:
        """Per-cell effective design fields: the design axis' own values,
        replaced wherever a design-field axis overrides them.  sel()-pinned
        axes participate as length-1 trailing dimensions, so a pinned
        design or field override still shapes the cost accounting."""
        axes = self.axes + self.pinned
        ext = tuple(len(ax) for ax in axes)
        names = [ax.name for ax in axes]
        designs = axes[names.index("design")].values
        out = {}
        for f in ("dram_channels", "links", "llc_mb_per_core"):
            if f in names:
                q = names.index(f)
                eff = _flat(axes[q].values, q, ext)
            else:
                per_design = [float(getattr(d, f)) for d in designs]
                eff = _flat(per_design, names.index("design"), ext)
            # pinned axes are length 1, so the flat cell count equals the
            # live grid's -- collapse straight to the live shape.
            out[f] = eff.reshape(self.shape)
        return out

    def design_cost_grid(self) -> dict[str, np.ndarray]:
        """Per-cell ``rel_area`` / ``rel_pins`` from the effective design
        fields -- a swept LLC or channel count changes the cost too."""
        eff = self._effective_fields()
        return design_cost(eff["dram_channels"], eff["links"],
                           eff["llc_mb_per_core"])

    def p99_grid(self) -> np.ndarray:
        """Worst-workload p99 LLC-miss latency per cell (ns).

        Max (not geomean) across the workload axis: the tail story is a
        guarantee, so the slowest workload's p99 is the cell's p99.  All
        NaN unless the grid was solved under ``queue_model="memsim"``
        (the closed form has no tail law).
        """
        return np.max(self.results.latency_p99_ns, axis=-1)

    def _cell_point(self, cell, flat_costs, gm) -> dict:
        """Named coordinates + cost/speedup payload for one flat cell."""
        idx = np.unravel_index(cell, self.shape)
        point = {ax.name: ax.coords[0] for ax in self.pinned}
        point.update({ax.name: ax.coords[i]
                      for ax, i in zip(self.axes, idx)})
        point.update(
            rel_area=float(flat_costs["rel_area"][cell]),
            rel_pins=float(flat_costs["rel_pins"][cell]),
            geomean_speedup=float(gm[cell]))
        return point

    def pareto(self, *, cost: str = "rel_area",
               tail: bool = False) -> list[dict]:
        """The non-dominated (min cost, max geomean speedup) frontier over
        every grid cell.

        ``cost`` is ``"rel_area"`` or ``"rel_pins"``.  Pin axes first with
        :meth:`sel` to restrict the subset: ``sw.sel(n_active=12).
        pareto()``.  Returns frontier points sorted by ascending cost,
        each a dict of the cell's named coordinates plus ``rel_area``,
        ``rel_pins`` and ``geomean_speedup`` (vs the un-overridden
        baseline).

        ``tail=True`` ranks by ``(cost, mean speedup, p99)`` instead: a
        cell survives unless some other cell is at least as good on ALL
        of (min cost, max geomean speedup, min worst-workload p99) and
        strictly better on one.  Each point then also carries
        ``latency_p99_ns`` (from :meth:`p99_grid`).  Requires a
        ``queue_model="memsim"`` solve; raises otherwise (the closed
        form's tail is NaN).

        Example::

            >>> from repro_torch.core import coaxial
            >>> sw = coaxial.sweep((coaxial.DDR_BASELINE,
            ...                     coaxial.COAXIAL_2X,
            ...                     coaxial.COAXIAL_4X), device="cpu")
            >>> front = sw.pareto(cost="rel_area")
            >>> [round(p["rel_area"], 3) for p in front] == sorted(
            ...     round(p["rel_area"], 3) for p in front)
            True
            >>> front[-1]["design"]      # max speedup ends the frontier
            'coaxial-4x'
        """
        costs = self.design_cost_grid()
        if cost not in costs:
            raise ValueError(f"cost must be one of {sorted(costs)}, "
                             f"got {cost!r}")
        gm = self.speedup_grid().reshape(-1)
        flat_costs = {k: v.reshape(-1) for k, v in costs.items()}
        if tail:
            return self._pareto_tail(cost, flat_costs, gm)
        order = np.lexsort((-gm, flat_costs[cost]))
        frontier, best = [], -np.inf
        for cell in order:
            if gm[cell] <= best + 1e-12:
                continue
            best = gm[cell]
            frontier.append(self._cell_point(cell, flat_costs, gm))
        return frontier

    def _pareto_tail(self, cost, flat_costs, gm) -> list[dict]:
        """3-objective (min cost, max speedup, min p99) non-dominated
        filter behind ``pareto(tail=True)``."""
        p99 = self.p99_grid().reshape(-1)
        if np.all(np.isnan(p99)):
            raise ValueError(
                "pareto(tail=True) needs p99 latencies; solve the sweep "
                "under queue_model='memsim' (the closed form has no tail "
                "law)")
        c = flat_costs[cost]
        eps = 1e-12
        frontier, seen = [], set()
        for cell in np.lexsort((p99, -gm, c)):
            dominated = np.any((c <= c[cell] + eps)
                               & (gm >= gm[cell] - eps)
                               & (p99 <= p99[cell] + eps)
                               & ((c < c[cell] - eps)
                                  | (gm > gm[cell] + eps)
                                  | (p99 < p99[cell] - eps)))
            key = (round(float(c[cell]), 12), round(float(gm[cell]), 12),
                   round(float(p99[cell]), 9))
            if dominated or key in seen:
                continue
            seen.add(key)
            point = self._cell_point(cell, flat_costs, gm)
            point["latency_p99_ns"] = float(p99[cell])
            frontier.append(point)
        return frontier


def knee_point(frontier, *, cost: str = "rel_area") -> dict:
    """Frontier point farthest (perpendicular) from the endpoint chord.

    The "buy this one" design of a cost-vs-speedup frontier (as returned
    by :meth:`SweepResult.pareto`): beyond the knee, each extra unit of
    ``cost`` buys visibly less speedup.  Degenerate frontiers (<= 2
    points) return the last (max-speedup) point.
    """
    if len(frontier) <= 2:
        return frontier[-1]
    xy = np.array([[p[cost], p["geomean_speedup"]] for p in frontier])
    a, b = xy[0], xy[-1]
    chord = b - a
    chord = chord / np.linalg.norm(chord)
    rel = xy - a
    dist = np.abs(rel[:, 0] * chord[1] - rel[:, 1] * chord[0])
    return frontier[int(np.argmax(dist))]


def solve_spec(spec: SweepSpec, *, workloads=WORKLOADS,
               baseline: MemSystem = DDR_BASELINE,
               queue_model: str = "closed_form", lut=None,
               device="cuda") -> SweepResult:
    """Solve a named-axis :class:`SweepSpec` in one call of the cell solver
    on ``device``.

    The baseline is prepended to the design axis if absent so comparisons
    can always be sliced; two different designs sharing a name are
    rejected (results are name-keyed).  However many axes the spec
    declares, the grid costs ONE solver pass per backend: ``queue_model``
    picks the fixed point's queue-wait backend for the whole grid, and a
    ``queue_model`` AXIS in the spec solves one pass per backend and
    stacks them.  ``lut`` is the memsim backend's :class:`QueueLUT`
    (default: :func:`default_queue_lut`, with the harvest axis when any
    cell harvests), resolved once per memsim pass.
    """
    axes = list(spec.axes)
    try:
        p = [ax.name for ax in axes].index("design")
    except ValueError:
        p = 0
        axes.insert(0, Axis("design", tuple(all_designs()), KIND_DESIGN))
    designs = tuple(axes[p].values)
    if not any(d.name == baseline.name for d in designs):
        designs = (baseline,) + designs
    seen: dict[str, MemSystem] = {}
    for d in designs:
        prev = seen.setdefault(d.name, d)
        if prev != d:
            # Results are sliced by name -- two different designs under one
            # name would silently shadow each other.
            raise ValueError(
                f"two different designs named {d.name!r} in one sweep")
    axes[p] = Axis("design", tuple(seen.values()), KIND_DESIGN)
    qpos = [i for i, ax in enumerate(axes) if ax.kind == KIND_QUEUE_MODEL]
    if len(qpos) > 1:
        raise ValueError("at most one queue_model axis per sweep")
    if qpos:
        if queue_model != "closed_form":
            raise ValueError(
                "pass the backend either as a queue_model axis or as the "
                "queue_model argument, not both")
        q = qpos[0]
        qax = axes.pop(q)
        sub = SweepSpec(tuple(axes))
        subs = [solve_spec(sub, workloads=workloads, baseline=baseline,
                           queue_model=qm, lut=lut, device=device)
                for qm in qax.values]
        res = ModelResult(**{
            f.name: np.stack([getattr(s.results, f.name) for s in subs],
                             axis=q)
            for f in dataclasses.fields(ModelResult)})
        first = subs[0]
        return dataclasses.replace(
            first, axes=first.axes[:q] + (qax,) + first.axes[q:],
            results=res,
            lut=next((s.lut for s in subs if s.lut is not None), None))
    spec = SweepSpec(tuple(axes))
    flat = build_flat(spec)
    # Resolve AFTER flattening: a harvesting design (or a harvest_duty /
    # harvest_bw_gbps design-field axis) needs the 5-D default surface.
    lut = cpu_model.resolve_queue_lut(
        queue_model, lut,
        harvest=cpu_model._any_harvest(flat["sysa"],
                                       flat["design_overrides"]),
        device=device)
    res = cpu_model.solve_cells(
        flat["sysa"], n_active=flat["n_active"],
        iface_override_ns=flat["iface_override_ns"],
        design_overrides=flat["design_overrides"],
        workload_overrides=flat["workload_overrides"],
        baseline=baseline, workloads=workloads,
        queue_model=queue_model, lut=lut, device=device)
    return SweepResult(
        axes=spec.axes, names=tuple(w.name for w in workloads),
        results=res.reshape(*spec.shape), baseline_name=baseline.name,
        workloads=tuple(workloads), baseline_sys=baseline,
        queue_model=queue_model, device=str(device), lut=lut)


def sweep(designs=None, *, iface_lat_grid=(None,),
          n_active_grid=(hw.SIM_CORES,), workloads=WORKLOADS,
          baseline: MemSystem = DDR_BASELINE,
          queue_model: str = "closed_form", lut=None,
          device="cuda") -> SweepResult:
    """Solve the historical designs x latencies x cores grid.

    Thin shim over :func:`solve_spec` -- the positional triple is just the
    named axes ``(design, iface_lat_ns, n_active)``, so results keep the
    legacy ``(D, L, C, n_workloads)`` layout.  ``iface_lat_grid`` entries
    override the CXL premium of CXL designs (``None`` = each design's own
    value).  ``n_active_grid`` are active core counts; calibration is
    redone per core count, as in the paper.  ``queue_model="memsim"``
    solves the same grid through the DES-derived :class:`QueueLUT`.
    """
    spec = sweep_spec(
        design=tuple(designs) if designs is not None else all_designs(),
        iface_lat_ns=tuple(iface_lat_grid),
        n_active=tuple(n_active_grid))
    return solve_spec(spec, workloads=workloads, baseline=baseline,
                      queue_model=queue_model, lut=lut, device=device)


def default_sweep(device="cuda", queue_model: str = "closed_form",
                  lut=None) -> SweepResult:
    """The shared grid behind every figure/table: all registered designs,
    both §6.4 latency points, all §6.5 core counts, solved on ``device``
    under ``queue_model`` (through ``lut``, default the
    :func:`default_queue_lut` surface, for ``"memsim"``).  Without a
    ``lut`` the grid is cached per device and backend, however the device
    is spelled (``"cuda"``, ``"cuda:0"`` and ``torch.device("cuda")``
    share one grid; the cache is cleared when a registry changes);
    ``default_sweep.__wrapped__(device, queue_model)`` solves anew without
    the cache, as does any call that passes a ``lut``.
    """
    device = _workloads.resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if lut is not None:
        return _default_grid(str(device), queue_model, lut)
    return _default_sweep(str(device), queue_model)


def _default_grid(device: str, queue_model: str, lut) -> SweepResult:
    return sweep(iface_lat_grid=(None, hw.CXL_LAT_PESSIMISTIC_NS),
                 n_active_grid=(1, 4, 8, hw.SIM_CORES),
                 queue_model=queue_model, lut=lut, device=device)


@functools.lru_cache(maxsize=None)
def _default_sweep(device: str,
                   queue_model: str = "closed_form") -> SweepResult:
    return _default_grid(device, queue_model, None)


default_sweep.cache_clear = _default_sweep.cache_clear
default_sweep.cache_info = _default_sweep.cache_info
default_sweep.__wrapped__ = _default_sweep.__wrapped__


def _unshadow(sys: MemSystem) -> MemSystem:
    """Rename a modified design that still carries the baseline's name.

    Sweep results are name-keyed; without the rename such a design would
    either shadow the comparator or be rejected by sweep()'s dedup check.
    """
    if sys.name == DDR_BASELINE.name and sys != DDR_BASELINE:
        return dataclasses.replace(sys, name=f"{sys.name}*")
    return sys


def evaluate(sys: MemSystem = COAXIAL_4X, *, n_active: int = hw.SIM_CORES,
             iface_lat_ns: float | None = None,
             workloads=WORKLOADS, device="cuda") -> Comparison:
    res_sys = sys
    if iface_lat_ns is not None and not sys.is_cxl:
        # The sweep grid's latency override only reaches CXL designs, but
        # evaluate() historically applied an explicit premium to any design
        # -- bake it into the design point.
        res_sys = dataclasses.replace(
            sys, name=f"{sys.name}@{iface_lat_ns:g}ns",
            iface_lat_ns=float(iface_lat_ns))
    res_sys = _unshadow(res_sys)
    sw = sweep((DDR_BASELINE, res_sys), iface_lat_grid=(iface_lat_ns,),
               n_active_grid=(n_active,), workloads=workloads, device=device)
    cmp = sw.comparison(res_sys, iface_lat=iface_lat_ns, n_active=n_active)
    if res_sys is not sys:
        cmp = dataclasses.replace(cmp, sys=sys)
    return cmp


def sensitivity_latency(latencies_ns=(hw.CXL_LAT_NS,
                                      hw.CXL_LAT_PESSIMISTIC_NS),
                        sys: MemSystem = COAXIAL_4X, *, device="cuda") -> dict:
    """§6.4: COAXIAL speedup at 30ns vs 50ns CXL premium (Fig 8)."""
    if not sys.is_cxl:
        # Latency overrides bypass non-CXL designs inside the grid; per-
        # point evaluate() bakes the premium in.
        return {lat: evaluate(sys, iface_lat_ns=lat, device=device)
                for lat in latencies_ns}
    sys = _unshadow(sys)
    sw = sweep((DDR_BASELINE, sys), iface_lat_grid=tuple(latencies_ns),
               device=device)
    return {lat: sw.comparison(sys, iface_lat=lat) for lat in latencies_ns}


def sensitivity_cores(cores=(1, 4, 8, 12), sys: MemSystem = COAXIAL_4X, *,
                      device="cuda"):
    """§6.5: speedup vs active cores; baseline at the same core count."""
    sys = _unshadow(sys)
    sw = sweep((DDR_BASELINE, sys), n_active_grid=tuple(cores),
               device=device)
    return {n: sw.comparison(sys, n_active=n) for n in cores}


# ---------------------------------------------------------------------------
# Distribution sweeps: the DES (memsim) as a first-class sweep target.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistributionSweepResult(_NamedAxes):
    """Stacked DES latency distributions over a grid of named channel axes.

    ``stats`` leaves have the grid shape (``hist`` with one trailing bin
    axis); the axes name each dimension.  Cells are selected by
    coordinate, never by position, with the same tolerant numeric
    matching and KeyError UX as :class:`SweepResult`:
    ``sw.sel(rho=0.6, kappa=2.0, cxl_lat_ns=30.0)`` returns the cell's
    :class:`LatencyStats` once every axis is pinned, or a reduced sweep
    over the remaining axes otherwise.
    """

    axes: tuple[Axis, ...]
    stats: LatencyStats
    base: ChannelConfig
    steps: int
    warmup: int
    seed: int
    reps: int = 1
    #: Which memsim engine produced the distributions ("timestep" or
    #: "event").
    engine: str = "timestep"
    #: The device the DES ran on.
    device: str = "cuda"

    def sel(self, **coords):
        """Select coordinates by axis name; each selected axis is dropped.

        Numeric coordinates match tolerantly; an unknown axis or
        coordinate raises one clear :class:`KeyError` listing the valid
        choices.  Returns the cell's :class:`LatencyStats` when no axes
        remain, else a reduced :class:`DistributionSweepResult`.
        """
        for k in coords:
            if k not in self.axis_names:
                raise KeyError(f"no axis {k!r} in sweep; axes: "
                               f"{list(self.axis_names)}")
        stats = self.stats
        kept: list[Axis] = []
        pos = 0
        for ax in self.axes:
            if ax.name in coords:
                i = ax.index(coords[ax.name])
                stats = stats[(slice(None),) * pos + (i,)]
            else:
                kept.append(ax)
                pos += 1
        if not kept:
            return stats
        return dataclasses.replace(self, axes=tuple(kept), stats=stats)

    def cell(self, **coords) -> LatencyStats:
        """The single-cell :class:`LatencyStats` at fully pinned
        coordinates (axes of length 1 may be omitted)."""
        full = dict(coords)
        for ax in self.axes:
            if ax.name not in full:
                if len(ax) == 1:
                    full[ax.name] = ax.values[0]
                else:
                    raise KeyError(
                        f"axis {ax.name!r} has {len(ax)} coordinates; pass "
                        f"{ax.name}=<one of {list(ax.coords)}>")
        return self.sel(**full)

    def curve(self, along: str, field: str = "mean_ns", **coords):
        """(axis coordinates, stat values) along one axis, other axes
        pinned by ``coords`` -- the Fig-2a load-latency curve shape."""
        ax = self.axis(along)
        sub = self.sel(**coords) if coords else self
        if isinstance(sub, LatencyStats) or sub.axis_names != (along,):
            raise KeyError(
                f"curve(along={along!r}) needs every other axis pinned; "
                f"axes: {list(self.axis_names)}")
        return np.asarray(ax.values, np.float64), getattr(sub.stats, field)


def distribution_sweep(spec: SweepSpec | None = None, *,
                       base: ChannelConfig | None = None,
                       steps: int = 200_000, seed: int = 0,
                       warmup: int | None = None, reps: int = 1,
                       engine: str = "timestep", devices=None,
                       stream_ids=None, chunk: int | None = None,
                       device="cuda", **axes) -> DistributionSweepResult:
    """Run the DES over a named-axis grid of channel parameters on
    ``device``.

    Pass a memsim-targeted :class:`SweepSpec` (from
    :func:`distribution_spec`) or the axes directly as keywords; the grid
    lowers to ONE simulation over the flattened cell batch (``reps``
    replicas a cell, merged into the histograms).  ``base`` supplies every
    unbound channel field (default: a plain DDR channel at the field
    defaults); ``engine`` picks ``"timestep"`` or ``"event"``;
    ``stream_ids``/``chunk`` pass through to ``memsim.simulate_cells``
    (the canonical stream contract); ``devices`` splits the DES lanes over
    that many devices (``core/shardsim``; bit-identical at any count).

    Example (doctest-sized step budget, on the CPU)::

        >>> from repro_torch.core import coaxial
        >>> sw = coaxial.distribution_sweep(rho=(0.2, 0.6),
        ...                                 cxl_lat_ns=(0.0, 30.0),
        ...                                 steps=20_000, reps=2,
        ...                                 device="cpu")
        >>> sw.shape
        (2, 2)
        >>> cell = sw.sel(rho=0.6, cxl_lat_ns=30.0)   # -> LatencyStats
        >>> bool(cell.p90_ns >= cell.p50_ns)
        True
    """
    if spec is None:
        spec = distribution_spec(**axes)
    elif axes:
        raise TypeError("pass a spec OR axis keywords, not both")
    flat = build_flat_memsim(spec, base=base)
    warmup = memsim.default_warmup(steps) if warmup is None else int(warmup)
    stats = memsim.simulate_cells(
        flat["cha"], overrides=flat["overrides"], steps=steps, seed=seed,
        warmup=warmup, reps=reps, engine=engine, devices=devices,
        stream_ids=stream_ids, chunk=chunk, device=device)
    return DistributionSweepResult(
        axes=spec.axes, stats=stats.reshape(*spec.shape),
        base=base if base is not None else ChannelConfig(rho=0.5),
        steps=steps, warmup=warmup, seed=seed, reps=reps, engine=engine,
        device=str(device))


#: Default rho anchors for the DES <-> closed-form cross-check.
CALIBRATION_RHOS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)
#: Cross-check tolerances: relative mean / p90 / stdev deviation per
#: anchor (the stdev gate is deliberately loose: the closed form's sigma is
#: a §6.2 workload-level fit, the DES measures the channel's own
#: heavy-tailed dispersion).
CALIBRATION_MEAN_TOL = 0.15
CALIBRATION_P90_TOL = 0.20
CALIBRATION_STDEV_TOL = 1.25


def validate_calibration(rhos=CALIBRATION_RHOS, *, kappa: float = 1.0,
                         cxl_lat_ns: float = 0.0, steps: int = 200_000,
                         seed: int = 0, warmup: int | None = None,
                         reps: int = 48, engine: str = "timestep",
                         devices=None,
                         mean_tol: float = CALIBRATION_MEAN_TOL,
                         p90_tol: float = CALIBRATION_P90_TOL,
                         stdev_tol: float = CALIBRATION_STDEV_TOL,
                         device="cuda") -> dict:
    """Cross-validate the DES against the closed-form queueing model.

    ONE batched distribution sweep over the rho anchors on ``device``,
    its mean / p90 / stdev held against :func:`queueing.closed_form_stats`
    at every anchor.  Returns ``anchors`` (one row per rho with both
    values and the relative deltas), ``max_abs_mean_err`` /
    ``max_abs_p90_err`` / ``max_abs_stdev_err``, the tolerances, an
    overall ``ok`` flag, and the ``sweep`` itself.
    """
    rhos = tuple(float(r) for r in rhos)
    base = ChannelConfig(rho=0.5, kappa=float(kappa),
                         cxl_lat_ns=float(cxl_lat_ns))
    sw = distribution_sweep(distribution_spec(rho=rhos), base=base,
                            steps=steps, seed=seed, warmup=warmup,
                            reps=reps, engine=engine, devices=devices,
                            device=device)
    anchors = []
    for r in rhos:
        des = sw.sel(rho=r)
        cf = {k: float(v) for k, v in queueing.closed_form_stats(
            r, kappa=kappa, cxl_lat_ns=cxl_lat_ns).items()}
        row = dict(rho=r,
                   des_mean_ns=float(des.mean_ns),
                   closed_mean_ns=cf["mean_ns"],
                   mean_err=float(des.mean_ns) / cf["mean_ns"] - 1.0,
                   des_p90_ns=float(des.p90_ns),
                   closed_p90_ns=cf["p90_ns"],
                   p90_err=float(des.p90_ns) / cf["p90_ns"] - 1.0,
                   des_stdev_ns=float(des.stdev_ns),
                   closed_stdev_ns=cf["stdev_ns"],
                   stdev_err=float(des.stdev_ns) / cf["stdev_ns"] - 1.0)
        anchors.append(row)
    max_mean = max(abs(a["mean_err"]) for a in anchors)
    max_p90 = max(abs(a["p90_err"]) for a in anchors)
    max_stdev = max(abs(a["stdev_err"]) for a in anchors)
    return dict(anchors=anchors, max_abs_mean_err=max_mean,
                max_abs_p90_err=max_p90, max_abs_stdev_err=max_stdev,
                mean_tol=mean_tol, p90_tol=p90_tol, stdev_tol=stdev_tol,
                engine=engine,
                ok=bool(max_mean <= mean_tol and max_p90 <= p90_tol
                        and max_stdev <= stdev_tol),
                sweep=sw)


#: Engine-vs-engine agreement gates (relative mean / p90 deviation per
#: anchor); the engines agree statistically, not bitwise.
ENGINE_MEAN_TOL = 0.10
ENGINE_P90_TOL = 0.15
#: Noise allowance: an anchor whose engine delta lies within ``k``
#: batched-means standard errors of zero passes as well.
ENGINE_SE_K = 3.0


def crosscheck_engines(rhos=CALIBRATION_RHOS, *, kappa: float = 1.0,
                       cxl_lat_ns: float = 0.0, steps: int = 200_000,
                       seed: int = 0, warmup: int | None = None,
                       reps: int = 32,
                       mean_tol: float = ENGINE_MEAN_TOL,
                       p90_tol: float = ENGINE_P90_TOL,
                       se_k: float = ENGINE_SE_K, devices=None,
                       base: ChannelConfig | None = None,
                       device="cuda") -> dict:
    """Statistical cross-check of the two memsim engines at the closed-form
    rho anchors, on ``device``.

    The same anchor grid runs through both engines at the same ``steps``
    budget; an anchor passes if its relative mean (p90) deviation is
    within ``mean_tol`` (``p90_tol``) OR within ``se_k`` batched-means
    standard errors of zero (the ``reps`` replicas are the batches).
    ``base`` replaces the default anchor channel wholesale (its ``rho`` is
    overridden per anchor).  Returns one row per anchor, the largest
    deviations, the per-engine ``sweeps`` and an ``ok`` flag.
    """
    rhos = tuple(float(r) for r in rhos)
    if base is None:
        base = ChannelConfig(rho=0.5, kappa=float(kappa),
                             cxl_lat_ns=float(cxl_lat_ns))
    spec = distribution_spec(rho=rhos)
    flat = build_flat_memsim(spec, base=base)
    warm = memsim.default_warmup(steps) if warmup is None else int(warmup)
    sweeps, per_rep = {}, {}
    for eng in memsim.ENGINES:
        # ONE simulation per engine: per-replica stats for the SE, merged
        # histograms (equal to a keep_reps=False run) for the rest.
        per_rep[eng] = memsim.simulate_cells(
            flat["cha"], overrides=flat["overrides"], steps=int(steps),
            seed=seed, warmup=warm, reps=reps, engine=eng,
            devices=devices, keep_reps=True, device=device)
        merged = memsim.merge_reps(per_rep[eng])
        sweeps[eng] = DistributionSweepResult(
            axes=spec.axes, stats=merged.reshape(*spec.shape), base=base,
            steps=int(steps), warmup=warm, seed=seed, reps=reps,
            engine=eng, device=str(device))

    def se(field, eng, i):
        """Batched-means standard error of the merged statistic."""
        batch = np.asarray(getattr(per_rep[eng], field))[:, i]
        if batch.shape[0] < 2:
            return np.nan
        return float(np.std(batch, ddof=1) / np.sqrt(batch.shape[0]))

    anchors = []
    for i, r in enumerate(rhos):
        ts = sweeps["timestep"].sel(rho=r)
        ev = sweeps["event"].sel(rho=r)
        row = dict(rho=r,
                   timestep_mean_ns=float(ts.mean_ns),
                   event_mean_ns=float(ev.mean_ns),
                   mean_err=float(ev.mean_ns) / float(ts.mean_ns) - 1.0,
                   timestep_p90_ns=float(ts.p90_ns),
                   event_p90_ns=float(ev.p90_ns),
                   p90_err=float(ev.p90_ns) / float(ts.p90_ns) - 1.0)
        for stat, field in (("mean", "mean_ns"), ("p90", "p90_ns")):
            se_d = np.sqrt(se(field, "timestep", i) ** 2 +
                           se(field, "event", i) ** 2)
            delta = row[f"event_{field}"] - row[f"timestep_{field}"]
            # A zero/NaN SE degenerates cleanly: zero delta passes with
            # z = 0, any other delta falls back to the relative gate.
            z = delta / se_d if se_d > 0 else (
                0.0 if delta == 0.0 else np.copysign(np.inf, delta))
            row[f"{stat}_se_ns"] = float(se_d)
            row[f"{stat}_z"] = float(z)
            row[f"{stat}_ok"] = bool(abs(row[f"{stat}_err"]) <= (
                mean_tol if stat == "mean" else p90_tol)
                or abs(z) <= se_k)
        row["ok"] = row["mean_ok"] and row["p90_ok"]
        anchors.append(row)
    max_mean = max(abs(a["mean_err"]) for a in anchors)
    max_p90 = max(abs(a["p90_err"]) for a in anchors)
    return dict(anchors=anchors, max_abs_mean_err=max_mean,
                max_abs_p90_err=max_p90, mean_tol=mean_tol,
                p90_tol=p90_tol, se_k=se_k, sweeps=sweeps,
                ok=all(a["ok"] for a in anchors))


# ---------------------------------------------------------------------------
# Table 1 / Table 2: area and pins for the full 144-core server.
# ---------------------------------------------------------------------------

FULL_CORES = 144
FULL_DDR_CHANNELS = 12


def _die_area(cores, llc_mb, ddr_ch, pcie_x8):
    return (cores * hw.AREA_ZEN3_CORE + llc_mb * hw.AREA_L3_PER_MB +
            ddr_ch * hw.AREA_DDR_CH + pcie_x8 * hw.AREA_PCIE_X8)


def design_cost(dram_channels, links, llc_mb_per_core) -> dict:
    """Vectorized Table-1/2 area & pin accounting for arbitrary field
    values (inputs broadcast together; ``is_cxl`` derives from the link
    count).  The shared core behind :func:`area_report` and
    :meth:`SweepResult.design_cost_grid` / :meth:`SweepResult.pareto`."""
    ch = np.asarray(dram_channels, np.float64)
    lk = np.asarray(links, np.float64)
    llc = np.asarray(llc_mb_per_core, np.float64)
    base = _die_area(FULL_CORES, FULL_CORES * 2, FULL_DDR_CHANNELS, 0)
    scale = FULL_CORES // hw.SIM_CORES
    ddr_ch = np.where(lk > 0, 0.0, ch * scale)
    pcie_x8 = lk * scale
    area = _die_area(FULL_CORES, FULL_CORES * llc, ddr_ch, pcie_x8)
    pins = ddr_ch * hw.DDR5_PINS + pcie_x8 * hw.PCIE_X8_PINS
    return dict(rel_area=area / base, mem_pins=pins,
                rel_pins=pins / (12 * hw.DDR5_PINS))


def area_report(designs=None) -> dict:
    """Reproduces Table 2's relative-area column from Table 1's entries.

    Derived from each registered design's own fields (LLC per core, links,
    channels) scaled 12-core slice -> 144-core server, so registry
    additions get Table-2 accounting for free.
    """
    out = {}
    for sys in (designs if designs is not None else all_designs()):
        c = design_cost(sys.dram_channels, sys.links, sys.llc_mb_per_core)
        out[sys.name] = dict(rel_area=float(c["rel_area"]),
                             mem_pins=int(c["mem_pins"]),
                             rel_pins=float(c["rel_pins"]))
    return out


def pin_report() -> dict:
    """§4.1: pins and peak bandwidth per interface choice."""
    ddr_per_pin = hw.DDR5_CH_BW_GBPS / hw.DDR5_PINS
    # The paper's "4x" compares PCIe's *per-direction* bandwidth per pin
    # against DDR's combined-direction figure (conservative: PCIe moves the
    # same bytes in the other direction simultaneously, §2.3).
    x8_per_pin_dir = hw.PCIE_X8_GBPS_PER_DIR / hw.PCIE_X8_PINS
    return dict(
        ddr5_pins=hw.DDR5_PINS,
        ddr5_peak_gbps=hw.DDR5_CH_BW_GBPS,
        ddr5_gbps_per_pin=ddr_per_pin,
        x8_pins=hw.PCIE_X8_PINS,
        x8_peak_gbps_per_dir=hw.PCIE_X8_GBPS_PER_DIR,
        x8_gbps_per_pin_per_dir=x8_per_pin_dir,
        x8_gbps_per_pin_duplex=2 * hw.PCIE_X8_GBPS_PER_DIR / hw.PCIE_X8_PINS,
        bw_per_pin_ratio=x8_per_pin_dir / ddr_per_pin,
        bw_per_pin_ratio_duplex=2 * x8_per_pin_dir / ddr_per_pin,
    )


# ---------------------------------------------------------------------------
# Table 5: power and EDP for the 144-core server.
# ---------------------------------------------------------------------------

def _dimm_power(channels, util):
    return channels * (hw.DIMM_STATIC_W_PER_CH + hw.DIMM_DYN_W_PER_CH * util)


def edp_report(sys: MemSystem = COAXIAL_4X, *,
               cmp: Comparison | None = None, device="cuda") -> dict:
    """§6.6 power/EDP model.  Pass ``cmp`` (e.g. a sweep slice) to reuse an
    already-solved comparison instead of re-evaluating on ``device``."""
    if cmp is None:
        cmp = evaluate(sys, device=device)
    # Scale channel counts 12-core sim -> 144-core server (x12).
    scale = FULL_CORES // hw.SIM_CORES
    base_ch = DDR_BASELINE.dram_channels * scale
    sys_ch = sys.dram_channels * scale
    lanes = sys.links * scale * 8

    util_base = float(np.mean(cmp.base.rho))
    util_sys = float(np.mean(cmp.res.rho))

    p_base = dict(
        package_w=hw.PKG_POWER_W,
        ddr_mc_phy_w=base_ch * hw.DDR_MC_PHY_W_PER_CH,
        dimm_w=_dimm_power(base_ch, util_base),
        cxl_iface_w=0.0)
    p_sys = dict(
        package_w=hw.PKG_POWER_W,
        ddr_mc_phy_w=sys_ch * hw.DDR_MC_PHY_W_PER_CH,
        dimm_w=_dimm_power(sys_ch, util_sys),
        cxl_iface_w=lanes * hw.PCIE_LANE_POWER_W)

    total_base = sum(p_base.values())
    total_sys = sum(p_sys.values())
    cpi_base = geomean(cmp.base.cpi)
    cpi_sys = geomean(cmp.res.cpi)
    edp_base = total_base * cpi_base**2
    edp_sys = total_sys * cpi_sys**2
    return dict(
        baseline=dict(**p_base, total_w=total_base, cpi=cpi_base,
                      util=util_base, edp=edp_base),
        coaxial=dict(**p_sys, total_w=total_sys, cpi=cpi_sys,
                     util=util_sys, edp=edp_sys),
        edp_ratio=edp_sys / edp_base,
        power_ratio=total_sys / total_base,
    )


# ---------------------------------------------------------------------------
# Convenience: the full headline table for tests / EXPERIMENTS.md.
# ---------------------------------------------------------------------------

def headline(device="cuda") -> dict:
    """All headline numbers, sliced out of ONE batched sweep on ``device``."""
    sw = default_sweep(device)
    c4 = sw.comparison(COAXIAL_4X)
    c2 = sw.comparison(COAXIAL_2X)
    ca = sw.comparison(COAXIAL_ASYM)
    c50 = sw.comparison(COAXIAL_4X, iface_lat=hw.CXL_LAT_PESSIMISTIC_NS)
    fig3 = cpu_model.variance_experiment(device=device)
    edp = edp_report(COAXIAL_4X, cmp=c4)
    return dict(
        gm_4x=c4.geomean_speedup,
        gm_2x=c2.geomean_speedup,
        gm_asym=ca.geomean_speedup,
        gm_50ns=c50.geomean_speedup,
        lbm_speedup=float(c4.speedup[NAMES.index("lbm")]),
        n_above_2x=c4.n_above_2x,
        n_regressions=c4.n_regressions,
        worst=c4.worst,
        queue_share=c4.summary()["queue_share_of_latency"],
        max_queue_share=c4.summary()["max_queue_share"],
        mean_base_queue_ns=c4.summary()["mean_base_queue_ns"],
        mean_coax_queue_ns=c4.summary()["mean_queue_ns"],
        stream_copy=c4.row("stream-copy"),
        fig3_geomeans=[v["geomean"] for v in fig3.values()],
        edp_ratio=edp["edp_ratio"],
        gm_1core=sw.comparison(COAXIAL_4X, n_active=1).geomean_speedup,
        gm_8core=sw.comparison(COAXIAL_4X, n_active=8).geomean_speedup,
        util_base=edp["baseline"]["util"],
        util_coax=edp["coaxial"]["util"],
    )
