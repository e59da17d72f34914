"""Declarative named-axis sweep specs over the COAXIAL design space.

Port of ``repro/core/sweepspec.py``, its design (``"cpu"``) target.  A
:class:`SweepSpec` is an ordered set of named :class:`Axis` objects; an
axis can bind

  * the ``design`` axis itself (a tuple of :class:`MemSystem` points),
  * any sweepable design field (``dram_channels``, ``links``,
    ``link_rd_gbps``, ``link_wr_gbps``, ``llc_mb_per_core``) -- the axis
    value overrides that field for EVERY design in the sweep,
  * ``iface_lat_ns`` -- the legacy CXL-latency-premium axis (``None`` =
    each design's own premium; non-CXL designs ignore the override),
  * ``n_active`` -- active core counts (calibration is redone per count),
  * any workload behavioral parameter (``kappa``, ``eta``, ``mpki``, ...)
    -- the axis value overrides that parameter for EVERY workload, and
    calibration runs against the overridden workload,
  * ``queue_model`` -- the solver backend (``"closed_form"`` /
    ``"memsim"``), solved one pass per backend by ``coaxial.solve_spec``.

The DES is a sweep target too: :func:`distribution_spec` builds a spec
whose axes bind :class:`memsim.ChannelConfig` fields (``rho``, ``kappa``,
``cxl_lat_ns``, any calibration constant), :func:`build_flat_memsim`
lowers it the same NaN-masked way, and ``spec.solve()`` dispatches on
``spec.target`` -- ``coaxial.distribution_sweep`` returns named-axis
latency *distributions* instead of model results.

Example::

    spec = sweep_spec(design=all_designs(),
                      iface_lat_ns=[None, 50.0],
                      llc_mb_per_core=np.linspace(0.5, 4, 8),
                      kappa=[1.0, 1.6, 3.2])
    sw = spec.solve()                      # ONE solver pass for the 4-D grid
    sw.sel(design="coaxial-4x", kappa=1.6).geomean_grid()

The spec is pure data: :func:`build_flat` lowers it to the flattened
per-cell numpy arrays that :func:`cpu_model.solve_cells` consumes, and
``coaxial.solve_spec`` wraps the solved grid in a named-axis
``SweepResult``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import cpu_model, memsim, workloads
from repro_torch.core.cpu_model import QUEUE_MODELS, MemSystem, MemSystemArrays
from repro_torch.core.memsim import ChannelArrays, ChannelConfig

#: Design fields an axis may override (``iface_lat_ns`` has its own
#: dedicated axis with the legacy CXL-only semantics).
DESIGN_FIELDS = cpu_model.SWEEPABLE_DESIGN_FIELDS
#: Workload behavioral parameters an axis may override.
WORKLOAD_FIELDS = workloads.SWEEPABLE_FIELDS
#: memsim channel fields a distribution-sweep axis may bind (the operating
#: point AND every calibration constant; see :func:`distribution_spec`).
CHANNEL_FIELDS = memsim.CHANNEL_FIELDS

#: Axis kinds.
KIND_DESIGN = "design"
KIND_IFACE = "iface_lat"
KIND_N_ACTIVE = "n_active"
KIND_DESIGN_FIELD = "design_field"
KIND_WORKLOAD_FIELD = "workload_field"
KIND_CHANNEL_FIELD = "channel_field"
KIND_QUEUE_MODEL = "queue_model"

#: Every bindable axis name (the valid ``sweep_spec`` keywords).
AXIS_NAMES = (("design", "iface_lat_ns", "n_active", "queue_model") +
              DESIGN_FIELDS + WORKLOAD_FIELDS)


def _kind_of(name: str) -> str:
    if name == "design":
        return KIND_DESIGN
    if name == "iface_lat_ns":
        return KIND_IFACE
    if name == "n_active":
        return KIND_N_ACTIVE
    if name == "queue_model":
        return KIND_QUEUE_MODEL
    if name in DESIGN_FIELDS:
        return KIND_DESIGN_FIELD
    if name in WORKLOAD_FIELDS:
        return KIND_WORKLOAD_FIELD
    raise ValueError(
        f"unknown sweep axis {name!r}; bindable axes: design, iface_lat_ns, "
        f"n_active, queue_model, design fields {DESIGN_FIELDS}, "
        f"workload fields {WORKLOAD_FIELDS}")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named sweep dimension: a field name and its coordinate values."""

    name: str
    values: tuple
    kind: str

    def __len__(self) -> int:
        return len(self.values)

    @property
    def coords(self) -> tuple:
        """Human-facing coordinates (design names for the design axis)."""
        if self.kind == KIND_DESIGN:
            return tuple(d.name for d in self.values)
        return self.values

    def index(self, value) -> int:
        """Tolerant coordinate lookup.

        Designs match by name (or :class:`MemSystem` identity); numeric
        coordinates match with ``np.isclose`` so ``50`` and ``50.0`` (or a
        linspace-rounded ``49.999999999``) resolve to the same cell; ``None``
        matches only ``None``.  Raises one clear :class:`KeyError` listing
        the valid coordinates otherwise.
        """
        if self.kind == KIND_DESIGN:
            name = value.name if isinstance(value, MemSystem) else value
            for i, d in enumerate(self.values):
                if d.name == name:
                    return i
        elif self.kind == KIND_QUEUE_MODEL:
            for i, v in enumerate(self.values):
                if v == value:
                    return i
        else:
            try:
                num = None if value is None else float(value)
            except (TypeError, ValueError):
                num = object()  # not float-convertible: matches nothing
            for i, v in enumerate(self.values):
                if v is None or num is None:
                    if v is None and num is None:
                        return i
                    continue
                if not isinstance(num, float):
                    break
                if np.isclose(num, float(v), rtol=1e-6, atol=1e-12):
                    return i
        raise KeyError(
            f"{value!r} is not a coordinate of axis {self.name!r}; "
            f"valid coordinates: {list(self.coords)}")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """An ordered tuple of named axes describing one sweep grid."""

    axes: tuple[Axis, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(ax) for ax in self.axes)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(ax.name for ax in self.axes)

    def axis(self, name: str) -> Axis:
        for ax in self.axes:
            if ax.name == name:
                return ax
        raise KeyError(f"no axis {name!r} in spec; axes: {self.names}")

    @property
    def target(self) -> str:
        """Which engine the spec lowers to: ``"cpu"`` (the closed-form
        ``cpu_model`` solver) or ``"memsim"`` (the DES)."""
        return ("memsim" if any(ax.kind == KIND_CHANNEL_FIELD
                                for ax in self.axes) else "cpu")

    def solve(self, **kwargs):
        """Solve the grid: ``coaxial.SweepResult`` for cpu-targeted specs,
        ``coaxial.DistributionSweepResult`` for memsim-targeted ones.
        Keyword arguments (``device`` among them) pass through to
        ``coaxial.solve_spec`` or ``coaxial.distribution_sweep``."""
        from repro_torch.core import coaxial  # runtime: coaxial imports us
        if self.target == "memsim":
            return coaxial.distribution_sweep(self, **kwargs)
        return coaxial.solve_spec(self, **kwargs)


def _as_axis(name: str, values) -> Axis:
    kind = _kind_of(name)
    if kind == KIND_DESIGN:
        values = tuple(values)
        for d in values:
            if not isinstance(d, MemSystem):
                raise TypeError(
                    f"design axis entries must be MemSystem, got {d!r}")
    elif kind == KIND_QUEUE_MODEL:
        if isinstance(values, str):
            values = (values,)
        values = tuple(values)
        for v in values:
            if v not in QUEUE_MODELS:
                raise ValueError(
                    f"axis 'queue_model': {v!r} is not a backend; choose "
                    f"from {QUEUE_MODELS}")
    else:
        if np.ndim(values) == 0 and not isinstance(values, (list, tuple)):
            values = (values,)
        conv = []
        for v in values:
            if v is None:
                if kind != KIND_IFACE:
                    raise ValueError(
                        f"axis {name!r}: None is only meaningful on the "
                        f"iface_lat_ns axis ('use the design's own premium')")
                conv.append(None)
            else:
                conv.append(int(v) if kind == KIND_N_ACTIVE else float(v))
        values = tuple(conv)
    if not values:
        raise ValueError(f"axis {name!r} has no coordinate values")
    return Axis(name=name, values=values, kind=kind)


def sweep_spec(design=None, **axes) -> SweepSpec:
    """Build a :class:`SweepSpec`; axis order is declaration order.

    ``design`` defaults to every registered design (``coaxial.
    all_designs()``) and always comes first; the remaining keyword
    arguments each declare one axis binding the named field.  Scalars are
    promoted to length-1 axes.  ``queue_model`` is an axis too -- the
    solver backend (``"closed_form"`` / ``"memsim"``) sweeps like any
    other coordinate (``coaxial.solve_spec`` runs one pass per backend
    and stacks them).

    Example::

        >>> from repro_torch.core.sweepspec import sweep_spec
        >>> from repro_torch.core.cpu_model import COAXIAL_4X, DDR_BASELINE
        >>> spec = sweep_spec(design=(DDR_BASELINE, COAXIAL_4X),
        ...                   iface_lat_ns=[None, 50.0],
        ...                   kappa=[1.0, 1.6],
        ...                   queue_model=("closed_form", "memsim"))
        >>> spec.names
        ('design', 'iface_lat_ns', 'kappa', 'queue_model')
        >>> spec.shape
        (2, 2, 2, 2)
        >>> spec.axis("kappa").values
        (1.0, 1.6)
        >>> spec.axis("queue_model").index("memsim")
        1
    """
    if design is None:
        from repro_torch.core import coaxial  # registry lives there
        design = coaxial.all_designs()
    built = [_as_axis("design", design)]
    for name, values in axes.items():
        _kind_of(name)  # raise the single clear error before building
        built.append(_as_axis(name, values))
    return SweepSpec(axes=tuple(built))


def field_bounds(spec: SweepSpec) -> dict[str, tuple[float, float]]:
    """Per-design-field ``(lo, hi)`` ranges implied by a spec's axes.

    The feasible box a projected-ascent optimizer (the reference's
    ``designer``) derives from the frontier spec it
    started from: a design-field axis bounds its field directly by its
    min/max coordinates, and the design axis bounds every remaining
    sweepable field by the spread across its design points -- so the
    optimizer can never leave the region the grid (and hence the pareto
    knee it started at) actually covered.

    Example::

        >>> from repro_torch.core.cpu_model import COAXIAL_4X, DDR_BASELINE
        >>> from repro_torch.core.sweepspec import field_bounds, sweep_spec
        >>> b = field_bounds(sweep_spec(
        ...     design=(DDR_BASELINE, COAXIAL_4X),
        ...     llc_mb_per_core=(0.5, 4.0)))
        >>> b["llc_mb_per_core"]
        (0.5, 4.0)
        >>> b["dram_channels"]      # from the design axis' spread
        (1.0, 4.0)
    """
    out: dict[str, tuple[float, float]] = {}
    design_ax = None
    for ax in spec.axes:
        if ax.kind == KIND_DESIGN:
            design_ax = ax
        elif ax.kind == KIND_DESIGN_FIELD:
            vals = [float(v) for v in ax.values]
            out[ax.name] = (min(vals), max(vals))
    if design_ax is not None:
        for f in DESIGN_FIELDS:
            if f in out:
                continue
            vals = [float(getattr(d, f)) for d in design_ax.values]
            out[f] = (min(vals), max(vals))
    return out


# ---------------------------------------------------------------------------
# Lowering: spec -> the flattened per-cell arrays the cell solver eats.
# ---------------------------------------------------------------------------

def _flat(values, pos: int, shape: tuple[int, ...]) -> np.ndarray:
    """Broadcast one axis' values across the grid, flattened to ``(N,)``."""
    arr = np.asarray(values, np.float64)
    view = arr.reshape(tuple(arr.size if j == pos else 1
                             for j in range(len(shape))))
    return np.ascontiguousarray(np.broadcast_to(view, shape)).reshape(-1)


def _design_leaves(designs) -> dict[str, np.ndarray]:
    leaves = {f: np.array([float(getattr(d, f)) for d in designs])
              for f in MemSystemArrays._fields if f != "is_cxl"}
    leaves["is_cxl"] = np.array([1.0 if d.is_cxl else 0.0 for d in designs])
    return leaves


def build_flat(spec: SweepSpec, *, pin_design: MemSystem | None = None
               ) -> dict:
    """Lower ``spec`` to flattened solver inputs (all leaves ``(N,)``).

    Returns a dict with keys ``sysa`` (a :class:`MemSystemArrays` of
    numpy leaves), ``n_active``, ``iface_override_ns``,
    ``design_overrides`` and ``workload_overrides`` (NaN = unbound).

    ``pin_design`` replaces every cell's design with the given point and
    drops the design-field overrides -- the un-overridden reference column
    :meth:`coaxial.SweepResult.baseline_ipc_grid` is built from.
    """
    shape = spec.shape
    n = int(np.prod(shape))
    nans = np.full(n, np.nan)
    sys_ov = {f: nans for f in DESIGN_FIELDS}
    wl_ov = {f: nans for f in WORKLOAD_FIELDS}
    n_active = np.full(n, float(cpu_model.hw.SIM_CORES))
    iface = nans
    sysa = None
    for pos, ax in enumerate(spec.axes):
        if ax.kind == KIND_DESIGN:
            designs = ((pin_design,) * len(ax) if pin_design is not None
                       else ax.values)
            leaves = _design_leaves(designs)
            sysa = MemSystemArrays(**{
                f: _flat(v, pos, shape) for f, v in leaves.items()})
        elif ax.kind == KIND_IFACE:
            vals = [np.nan if v is None else v for v in ax.values]
            iface = _flat(vals, pos, shape)
        elif ax.kind == KIND_N_ACTIVE:
            n_active = _flat(ax.values, pos, shape)
        elif ax.kind == KIND_QUEUE_MODEL:
            # The backend is a choice per solve, not a per-cell array:
            # coaxial.solve_spec splits the grid and solves one pass per
            # backend before lowering reaches this point.
            raise ValueError(
                "queue_model axes cannot lower to flat cell arrays; "
                "solve them through coaxial.solve_spec")
        elif ax.kind == KIND_DESIGN_FIELD:
            if pin_design is None:
                sys_ov = dict(sys_ov)
                sys_ov[ax.name] = _flat(ax.values, pos, shape)
        else:
            wl_ov = dict(wl_ov)
            wl_ov[ax.name] = _flat(ax.values, pos, shape)
    if sysa is None:
        raise ValueError("spec has no design axis (use sweep_spec(...))")
    return dict(sysa=sysa, n_active=n_active, iface_override_ns=iface,
                design_overrides=sys_ov, workload_overrides=wl_ov)


# ---------------------------------------------------------------------------
# memsim target: distribution sweeps over ChannelConfig fields.
# ---------------------------------------------------------------------------

def distribution_spec(**axes) -> SweepSpec:
    """Build a memsim-targeted :class:`SweepSpec` of channel-field axes.

    Every keyword names a :class:`memsim.ChannelConfig` field (``rho``,
    ``kappa``, ``cxl_lat_ns``, ``stall_ns``, ...); axis order is
    declaration order and scalars are promoted to length-1 axes.  The
    spec lowers to ONE simulation over the flattened cell batch
    (:func:`build_flat_memsim`) under either memsim engine, and
    ``coaxial.distribution_sweep`` wraps the result in a named-axis
    ``DistributionSweepResult``.
    """
    if not axes:
        raise ValueError("distribution_spec needs at least one axis; "
                         f"bindable channel fields: {CHANNEL_FIELDS}")
    built = []
    for name, values in axes.items():
        if name not in CHANNEL_FIELDS:
            raise ValueError(
                f"unknown distribution axis {name!r}; bindable channel "
                f"fields: {CHANNEL_FIELDS}")
        if np.ndim(values) == 0 and not isinstance(values, (list, tuple)):
            values = (values,)
        conv = []
        for v in values:
            if v is None:
                raise ValueError(
                    f"axis {name!r}: None is not a channel coordinate")
            conv.append(float(v))
        if not conv:
            raise ValueError(f"axis {name!r} has no coordinate values")
        built.append(Axis(name=name, values=tuple(conv),
                          kind=KIND_CHANNEL_FIELD))
    return SweepSpec(axes=tuple(built))


def build_flat_memsim(spec: SweepSpec,
                      base: ChannelConfig | None = None) -> dict:
    """Lower a memsim-targeted spec to flattened simulator inputs.

    Returns ``cha`` (a :class:`ChannelArrays` of the base channel's values
    broadcast to ``(N,)`` numpy arrays) and ``overrides`` (NaN = "keep the
    base channel's value", one ``(N,)`` array per bound axis), which
    ``memsim.simulate_cells`` applies branch-free.
    """
    base = base if base is not None else ChannelConfig(rho=0.5)
    bad = [ax.name for ax in spec.axes if ax.kind != KIND_CHANNEL_FIELD]
    if bad:
        raise ValueError(
            f"memsim lowering needs channel-field axes only; non-channel "
            f"axes in spec: {bad} (build with distribution_spec(...))")
    shape = spec.shape
    n = int(np.prod(shape))
    cha = ChannelArrays(*(
        np.full(n, float(getattr(base, f))) for f in CHANNEL_FIELDS))
    overrides = {}
    for pos, ax in enumerate(spec.axes):
        overrides[ax.name] = _flat(ax.values, pos, shape)
    return dict(cha=cha, overrides=overrides)
