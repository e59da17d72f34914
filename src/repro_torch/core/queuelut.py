"""DES-derived queue-wait lookup surface: the mechanism as a solver backend.

Port of ``repro/core/queuelut.py``.  ``cpu_model``'s fixed point needs,
per workload and per iteration, the DRAM-side queue wait at an operating
point (utilization ``rho``, burstiness ``kappa``, closed-loop population
``outstanding``, DRAM-sensitivity ``eta``).  The closed form answers that
analytically; this module answers it mechanistically: one batched
``coaxial.distribution_sweep`` runs the DES (``memsim``, its scans the
hand kernels of ``kernels/csrc/memsim_scan.cu`` on the card) over a
(rho, kappa, outstanding, eta) grid, and the latency distributions are
reduced to four tables (mean wait / p90 wait / p99 wait / latency
stdev).  The reference's module note says what each axis simulates.

:class:`QueueLUT` is a NamedTuple of those tables plus their grids,
float32 tensors on the CPU as built or loaded, with differentiable
multilinear interpolation: piecewise linear in the query point (the
``outstanding`` axis located in LOG space, its grid being geometric),
clamped to the grid hull.  Where the reference's ``_blend`` sums 2**d
corner cells table by table, the port stacks the four tables and gathers
every corner of all four in one indexing op; the corner weights are the
reference's products in its order, so only the sum over corners is taken
in another order (last-bit differences: ``tests/test_torch_queuelut.py``
holds the lookup to the reference within 1e-6 relative or 4 float32
roundings of the largest table value).  The solver lays a LUT out once
per solve on its own device (:meth:`QueueLUT.tables`) and looks up
through that.

Build cost: the default surface (14 x 6 x 6 x 4 grid, 2 replicas, 120k
steps) is one batched run of the event engine: 42 launches of
``memsim_event_scan`` on the card, one per canonical chunk.
:func:`default_queue_lut` resolves it through the persistent store
(``core/lutstore``), so a process pays for it once and a warm store
never.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hw, lutstore
from repro_torch.core.lutstore import clear_lut_cache  # noqa: F401 -- re-export
from repro_torch.core.queueing import clip

#: Default utilization grid: denser near saturation, where the open-loop
#: hyperbola is steep.
DEFAULT_RHO_GRID = (0.05, 0.15, 0.25, 0.35, 0.45, 0.55, 0.62, 0.68,
                    0.74, 0.79, 0.84, 0.88, 0.91, 0.93)
#: Default burstiness grid (the Table-4 suite values 1.3..1.6 and the
#: synthetic-sweep range up to 3.2).
DEFAULT_KAPPA_GRID = (1.0, 1.3, 1.6, 2.2, 2.7, 3.2)
#: Default closed-loop population grid, geometric: the lookup
#: interpolates this axis in log space.
DEFAULT_OUTSTANDING_GRID = (2.0, 4.0, 8.0, 24.0, 64.0, 192.0)
#: Default DRAM-sensitivity grid (the surface is near-linear in eta).
DEFAULT_ETA_GRID = (0.05, 0.30, 0.60, 1.0)
#: Optional 5th axis: lent-time fraction of the idle-I/O harvesting chain,
#: built at the reference lent bandwidth :data:`HARVEST_REF_BW_GBPS` (one
#: DDR5 channel's worth); queries at other lent bandwidths map through
#: ``duty_eff = duty * bw / ref`` (``cpu_model._latency_terms``).
DEFAULT_HARVEST_GRID = (0.0, 0.25, 0.5, 0.75)
HARVEST_REF_BW_GBPS = hw.DDR5_CH_BW_GBPS
#: Default DES budget per cell (ns simulated) and replicas per cell.
DEFAULT_STEPS = 120_000
DEFAULT_REPS = 2
#: Default build engine: the per-request event engine.
DEFAULT_ENGINE = "event"


def _as_f32(x, device) -> torch.Tensor:
    """A query as a float32 tensor on ``device`` (a tensor keeps its
    autograd graph)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class QueueLUT(NamedTuple):
    """DES-measured queue-wait surface over (rho, kappa, outstanding, eta).

    Nine leaves: four ascending coordinate grids and four ``(R, K, O, E)``
    tables -- mean queue wait, p90 queue wait, p99 queue wait, and latency
    standard deviation (all ns) -- float32 tensors, plus an optional 5th
    grid (``harvest_grid``; the tables then gain a trailing axis).
    :meth:`lookup` interpolates all four multilinearly (clamped at the
    hull; the ``outstanding`` axis in log space), broadcasts its queries
    and is differentiable in the query point.

    Example (a hand-built two-point surface; real tables come from
    :func:`build_queue_lut`)::

        >>> import torch
        >>> from repro_torch.core.queuelut import QueueLUT
        >>> z = torch.zeros((2, 2, 2, 2))
        >>> w = z.clone()
        >>> w[1] = 80.0
        >>> lut = QueueLUT(rho_grid=torch.tensor([0.0, 1.0]),
        ...                kappa_grid=torch.tensor([1.0, 2.0]),
        ...                outstanding_grid=torch.tensor([1.0, 100.0]),
        ...                eta_grid=torch.tensor([0.0, 1.0]),
        ...                wait_ns=w, p90_wait_ns=z, p99_wait_ns=z,
        ...                sigma_ns=z)
        >>> float(lut.wait(0.5, 1.0, 1.0, 1.0))  # halfway up the rho edge
        40.0
        >>> float(lut.wait(2.0, 1.0, 1.0, 1.0))  # clamped at the grid hull
        80.0
        >>> float(lut.wait(0.5, 1.0, 10.0, 1.0))  # log-space outstanding:
        40.0
    """

    rho_grid: torch.Tensor          # (R,) ascending
    kappa_grid: torch.Tensor        # (K,) ascending
    outstanding_grid: torch.Tensor  # (O,) ascending, positive
    eta_grid: torch.Tensor          # (E,) ascending
    wait_ns: torch.Tensor           # (R, K, O, E[, H]) mean queue wait
    p90_wait_ns: torch.Tensor       # (R, K, O, E[, H]) p90 queue wait
    p99_wait_ns: torch.Tensor       # (R, K, O, E[, H]) p99 queue wait
    sigma_ns: torch.Tensor          # (R, K, O, E[, H]) latency stdev
    #: Optional 5th axis (None => 4-D tables): lent-time fraction of the
    #: idle-I/O harvesting chain at the reference lent bandwidth.
    harvest_grid: torch.Tensor | None = None

    def tables(self, device=None) -> "LutTables":
        """This surface laid out for lookup on ``device`` (default: where
        its tables are)."""
        return LutTables(self, self.wait_ns.device if device is None
                         else device)

    def lookup(self, rho, kappa, outstanding, eta=1.0, harvest=0.0):
        """Interpolated ``(mean wait, p90 wait, p99 wait, sigma)``.

        Queries broadcast together; out-of-grid coordinates clamp to the
        nearest hull face.  ``harvest`` queries the optional 5th axis and
        is ignored on a 4-D surface (``cpu_model`` resolves the right
        surface and raises on a mismatch).  The lookup runs where the
        first tensor query lies, or where the tables lie when every query
        is a number.
        """
        device = next((x.device for x in (rho, kappa, outstanding, eta,
                                          harvest)
                       if isinstance(x, torch.Tensor)), None)
        return self.tables(device).lookup(rho, kappa, outstanding, eta,
                                          harvest)

    def wait(self, rho, kappa, outstanding, eta=1.0, harvest=0.0):
        """Interpolated mean queue wait alone (ns)."""
        return self.lookup(rho, kappa, outstanding, eta, harvest)[0]


class LutTables:
    """A :class:`QueueLUT` laid out for lookup on one device.

    Holds the four tables stacked and flattened to ``(4, cells)``, each
    axis's interior nodes, the lower node and the span of every interval
    (in log space for ``outstanding``, as the reference's ``_locate``
    forms them), the hull bounds as host floats, the row-major strides and
    the flat offsets of the ``2**d`` corners of a cell.  Made once per
    solve, so the fixed point's lookups copy nothing to the device.
    """

    def __init__(self, lut: QueueLUT, device):
        grids = [lut.rho_grid, lut.kappa_grid, lut.outstanding_grid,
                 lut.eta_grid]
        self.logs = [False, False, True, False]
        if lut.harvest_grid is not None:
            grids.append(lut.harvest_grid)
            self.logs.append(False)
        self.device = torch.device(device)
        self.harvest_grid = (None if lut.harvest_grid is None
                             else lut.harvest_grid.to(self.device))
        host = [g.detach().cpu() for g in grids]
        self.bounds = [(float(g[0]), float(g[-1])) for g in host]
        sizes = [int(g.shape[0]) for g in host]
        grids = [g.to(self.device) for g in host]
        self.inner = [g[1:-1] for g in grids]
        self.lo = [g[:-1] for g in grids]
        self.span = [torch.log(g[1:] / g[:-1]) if lg else g[1:] - g[:-1]
                     for g, lg in zip(grids, self.logs)]
        self.strides = [int(np.prod(sizes[d + 1:]))
                        for d in range(len(sizes))]
        self.flat = torch.stack([lut.wait_ns, lut.p90_wait_ns,
                                 lut.p99_wait_ns, lut.sigma_ns]).reshape(
                                     4, -1).to(self.device)
        d = len(sizes)
        self.offsets = torch.tensor(
            [sum(((c >> a) & 1) * self.strides[a] for a in range(d))
             for c in range(2 ** d)], dtype=torch.int64, device=self.device)

    def _locate(self, a: int, x):
        """(lower index, fraction) of ``x`` on axis ``a``, clamped: the
        reference's ``_locate``, its two clips ``queueing.clip`` (which
        splits the gradient at a tie, as ``jnp.clip`` does)."""
        x = clip(x, *self.bounds[a])
        # x lies on the hull, so the reference's clip(searchsorted(grid, x,
        # right) - 1, 0, n - 2) is the count of interior nodes <= x.
        i = torch.searchsorted(self.inner[a], x, right=True)
        lo = self.lo[a][i]
        if self.logs[a]:
            t = torch.log(x / lo) / self.span[a][i]
        else:
            t = (x - lo) / self.span[a][i]
        return i, clip(t, 0.0, 1.0)

    def lookup(self, rho, kappa, outstanding, eta=1.0, harvest=0.0):
        """Interpolated ``(mean wait, p90 wait, p99 wait, sigma)``, each of
        the queries' broadcast shape (see :meth:`QueueLUT.lookup`)."""
        q = [rho, kappa, outstanding, eta]
        if self.harvest_grid is not None:
            q.append(harvest)
        q = [_as_f32(x, self.device) for x in q]
        shape = torch.broadcast_shapes(*(x.shape for x in q))
        # Equal ranks, so the corner axis of the weights stays leading.
        q = [x.reshape((1,) * (len(shape) - x.dim()) + x.shape) for x in q]
        base, w = 0, None
        for a, x in enumerate(q):
            i, t = self._locate(a, x)
            base = base + i * self.strides[a]
            # Corner bit a of the reference's ``_blend`` is axis a: the
            # weights of axis a index the high half of the corner axis.
            f = torch.stack([1.0 - t, t])
            w = f if w is None else (f[:, None] * w[None]).reshape(
                (-1,) + torch.broadcast_shapes(f.shape[1:], w.shape[1:]))
        idx = base + self.offsets.reshape((-1,) + (1,) * len(shape))
        out = (self.flat[:, idx] * w).sum(1)
        return tuple(out.reshape((4,) + tuple(shape)).unbind(0))


def _check_grid(name, grid, positive: bool = False):
    g = np.asarray(grid, np.float64)
    if g.ndim != 1 or g.size < 2:
        raise ValueError(f"{name} grid needs >= 2 points, got {g.shape}")
    if not np.all(np.diff(g) > 0):
        raise ValueError(f"{name} grid must be strictly ascending: "
                         f"{g.tolist()}")
    if positive and g[0] <= 0:
        raise ValueError(f"{name} grid must be positive (it interpolates "
                         f"in log space): {g.tolist()}")
    return tuple(float(v) for v in g)


#: Salt of the per-cell stream-id hash (the reference's: the same cell
#: draws the same streams in both packages).
_CELL_SALT = b"qlut-cell-v1:"


def cell_stream_ids(names, coords) -> np.ndarray:
    """Per-cell uint32 stream ids keyed by the cell's COORDINATES: the
    first 32 bits of a sha256 over the exact (hex-formatted) coordinate
    values.  With the pinned chunk schedule (``memsim.canonical_chunk``)
    this makes every LUT cell's DES result independent of which other
    cells share the batch (the reference's note gives the contract)."""
    names = tuple(names)
    coords = np.asarray(coords, np.float64)
    ids = np.empty(coords.shape[0], np.uint32)
    for i, row in enumerate(coords):
        body = ";".join(f"{n}={float(v).hex()}"
                        for n, v in zip(names, row))
        h = hashlib.sha256(_CELL_SALT + body.encode()).digest()
        ids[i] = int.from_bytes(h[:4], "little")
    return ids


def _grid_axes(rho, kappa, outstanding, eta, harvest):
    """Validate grids; returns the ordered axes dict (+ checked grids)."""
    rho = _check_grid("rho", rho)
    kappa = _check_grid("kappa", kappa)
    outstanding = _check_grid("outstanding", outstanding, positive=True)
    eta = _check_grid("eta", eta)
    axes = dict(rho=rho, kappa=kappa, outstanding=outstanding, eta=eta)
    if harvest is not None:
        harvest = _check_grid("harvest", harvest)
        if harvest[0] < 0.0 or harvest[-1] >= 1.0:
            raise ValueError(f"harvest (duty) grid must lie in [0, 1): "
                             f"{list(harvest)}")
        axes["harvest_duty"] = harvest
    return axes, harvest


def _cell_coords(axes: dict) -> np.ndarray:
    """(N, d) float64 coordinates of the C-order flattened grid --
    exactly the flat cell order of ``coaxial.distribution_sweep``."""
    mesh = np.meshgrid(*(np.asarray(g, np.float64) for g in axes.values()),
                       indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _base_cell_map(axes: dict, base_lut: QueueLUT):
    """(present mask, base flat indices) of target cells found in a base:
    a target cell is PRESENT when every coordinate matches a base grid
    point exactly, compared in float32 (the grids' dtype)."""
    base_grids = [_np(g) for g in
                  (base_lut.rho_grid, base_lut.kappa_grid,
                   base_lut.outstanding_grid, base_lut.eta_grid)]
    if base_lut.harvest_grid is not None:
        base_grids.append(_np(base_lut.harvest_grid))
    if len(base_grids) != len(axes):
        raise ValueError(
            "base_lut axis count does not match the target grid: "
            f"{len(base_grids)} vs {len(axes)} (harvest mismatch?)")
    shape = tuple(len(g) for g in axes.values())
    maps = []
    for tgt, bg in zip(axes.values(), base_grids):
        tgt32 = np.asarray(tgt, np.float32)
        m = np.full(len(tgt32), -1, np.int64)
        for j, v in enumerate(tgt32):
            hit = np.flatnonzero(bg == v)
            if hit.size:
                m[j] = hit[0]
        maps.append(m)
    idx = np.stack(np.meshgrid(*(np.arange(s) for s in shape),
                               indexing="ij"), -1).reshape(-1, len(shape))
    base_pos = np.stack([maps[a][idx[:, a]] for a in range(len(shape))],
                        axis=-1)
    present = (base_pos >= 0).all(axis=-1)
    base_shape = tuple(len(g) for g in base_grids)
    flat = (np.ravel_multi_index(base_pos[present].T, base_shape)
            if present.any() else np.empty(0, np.int64))
    return present, flat


def _harvest_base(harvest, base, harvest_bw_gbps):
    """The base channel of a harvest build: lends ``harvest_bw_gbps``."""
    from repro_torch.core import memsim  # runtime: import cycle
    if harvest is not None and base is None:
        base = memsim.ChannelConfig(
            rho=0.5, harvest_bw_gbps=float(harvest_bw_gbps))
    return base


def _stat_arrays(stats):
    """The four tables of a DES run, float64: waits are the latency
    mean/p90/p99 less the unloaded DRAM service time (floored at 0), sigma
    the latency stdev."""
    return (np.maximum(np.asarray(stats.mean_ns, np.float64)
                       - hw.DRAM_SERVICE_NS, 0.0),
            np.maximum(np.asarray(stats.p90_ns, np.float64)
                       - hw.DRAM_SERVICE_NS, 0.0),
            np.maximum(np.asarray(stats.p99_ns, np.float64)
                       - hw.DRAM_SERVICE_NS, 0.0),
            np.asarray(stats.stdev_ns, np.float64))


def _f32_cpu(x) -> torch.Tensor:
    """float64 values rounded once to a float32 CPU tensor (the
    reference's ``jnp.asarray`` of a float64 array without x64)."""
    return torch.from_numpy(np.asarray(x, np.float64).astype(np.float32))


def build_queue_lut(*, rho=DEFAULT_RHO_GRID, kappa=DEFAULT_KAPPA_GRID,
                    outstanding=DEFAULT_OUTSTANDING_GRID,
                    eta=DEFAULT_ETA_GRID, harvest=None,
                    harvest_bw_gbps: float = HARVEST_REF_BW_GBPS,
                    steps: int = DEFAULT_STEPS, seed: int = 0,
                    reps: int = DEFAULT_REPS, base=None,
                    engine: str = DEFAULT_ENGINE,
                    devices=None, base_lut: QueueLUT | None = None,
                    device="cuda") -> QueueLUT:
    """Run ONE batched distribution sweep on ``device`` and reduce it to a
    QueueLUT (float32 CPU tensors).

    The wait tables are the DES latency means/p90s/p99s minus the unloaded
    DRAM service time; the sigma table is the DES latency stdev.  Every
    build runs under the canonical stream contract (streams keyed by the
    cell's coordinates, :func:`cell_stream_ids`; the chunk pinned,
    ``memsim.canonical_chunk``), so a cell's tables are a pure function of
    its coordinates and the build parameters, on either device.  That
    makes builds incremental: ``base_lut`` (built with the same
    parameters) donates every cell it covers and only the missing cells
    are simulated -- bit-identical to a build from scratch.  ``harvest``
    (a duty grid in [0, 1)) grows the optional 5th axis, the base channel
    lending ``harvest_bw_gbps`` while lent.  ``devices`` splits the build's
    DES lanes over devices (``core/shardsim``; the tables are the same).

    Example (tiny grid, doctest-sized budget, on the CPU)::

        >>> from repro_torch.core.queuelut import build_queue_lut
        >>> lut = build_queue_lut(rho=(0.2, 0.6), kappa=(1.0, 2.0),
        ...                       outstanding=(8.0, 192.0),
        ...                       eta=(0.1, 1.0), steps=4000, reps=1,
        ...                       device="cpu")
        >>> tuple(lut.wait_ns.shape)
        (2, 2, 2, 2)
        >>> bool(lut.wait(0.6, 1.0, 192.0, 1.0) >
        ...      lut.wait(0.2, 1.0, 192.0, 1.0))
        True
    """
    from repro_torch.core import coaxial, memsim  # runtime: import cycle
    axes, harvest = _grid_axes(rho, kappa, outstanding, eta, harvest)
    base = _harvest_base(harvest, base, harvest_bw_gbps)
    coords = _cell_coords(axes)
    sids = cell_stream_ids(axes.keys(), coords)
    chunk = memsim.canonical_chunk(engine)
    shape = tuple(len(g) for g in axes.values())
    grids = tuple(axes.values())

    if base_lut is None:
        sw = coaxial.distribution_sweep(
            **axes, base=base, steps=int(steps), seed=int(seed),
            reps=int(reps), engine=engine, devices=devices,
            stream_ids=sids, chunk=chunk, device=device)
        tables = _stat_arrays(sw.stats)
    else:
        present, base_flat = _base_cell_map(axes, base_lut)
        missing = np.flatnonzero(~present)
        spec = coaxial.distribution_spec(**axes)
        flat = coaxial.build_flat_memsim(spec, base=base)
        fresh = None
        if missing.size:
            cha = memsim.ChannelArrays(
                *(np.asarray(leaf)[missing] for leaf in flat["cha"]))
            ov = {f: np.asarray(v)[missing]
                  for f, v in flat["overrides"].items()}
            stats = memsim.simulate_cells(
                cha, overrides=ov, steps=int(steps), seed=int(seed),
                warmup=memsim.default_warmup(int(steps)),
                reps=int(reps), engine=engine, devices=devices,
                stream_ids=sids[missing], chunk=chunk, device=device)
            fresh = _stat_arrays(stats)
        base_tables = (base_lut.wait_ns, base_lut.p90_wait_ns,
                       base_lut.p99_wait_ns, base_lut.sigma_ns)
        tables = []
        for t, bt in enumerate(base_tables):
            full = np.empty(coords.shape[0], np.float64)
            # float32 -> float64 -> float32 round-trips exactly, so
            # donated cells keep the base surface's bits.
            full[present] = _np(bt).astype(np.float64).ravel()[base_flat]
            if fresh is not None:
                full[missing] = fresh[t]
            tables.append(full)

    wait, p90, p99, sigma = (t.reshape(shape) for t in tables)
    return QueueLUT(
        rho_grid=_f32_cpu(grids[0]), kappa_grid=_f32_cpu(grids[1]),
        outstanding_grid=_f32_cpu(grids[2]), eta_grid=_f32_cpu(grids[3]),
        wait_ns=_f32_cpu(wait), p90_wait_ns=_f32_cpu(p90),
        p99_wait_ns=_f32_cpu(p99), sigma_ns=_f32_cpu(sigma),
        harvest_grid=None if harvest is None else _f32_cpu(harvest))


def _store_params(axes: dict, harvest, harvest_bw_gbps, steps, seed,
                  reps, engine, base) -> dict:
    """The canonical JSON-able param dict behind a store key.  Neither
    ``devices`` nor ``device`` is in it: the tables do not depend on
    them."""
    base_fields = (None if base is None
                   else {k: float(v) for k, v in
                         sorted(dataclasses.asdict(base).items())})
    return dict(schema="queue_lut",
                axes={n: list(g) for n, g in axes.items()},
                harvest_bw_gbps=(float(harvest_bw_gbps)
                                 if harvest is not None else None),
                steps=int(steps), seed=int(seed), reps=int(reps),
                engine=str(engine), base=base_fields)


def resolve_lut(*, rho=DEFAULT_RHO_GRID, kappa=DEFAULT_KAPPA_GRID,
                outstanding=DEFAULT_OUTSTANDING_GRID,
                eta=DEFAULT_ETA_GRID, harvest=None,
                harvest_bw_gbps: float = HARVEST_REF_BW_GBPS,
                steps: int = DEFAULT_STEPS, seed: int = 0,
                reps: int = DEFAULT_REPS, base=None,
                engine: str = DEFAULT_ENGINE, devices=None,
                base_lut: QueueLUT | None = None,
                device="cuda") -> QueueLUT:
    """Store-backed :func:`build_queue_lut`: memory -> disk -> simulate.

    The resolution order is (1) the bounded in-process layer, (2) the
    ``$REPRO_LUT_CACHE/torch`` on-disk store (bit-identical read, no DES
    run), (3) a fresh build on ``device`` -- which is then persisted.
    ``base_lut`` only matters on a full miss: the build grows the base
    incrementally instead of starting from scratch.
    """
    axes, harvest = _grid_axes(rho, kappa, outstanding, eta, harvest)
    base = _harvest_base(harvest, base, harvest_bw_gbps)
    key = lutstore.store_key(_store_params(
        axes, harvest, harvest_bw_gbps, steps, seed, reps, engine, base))
    lut = lutstore.cache_get(key)
    if lut is None:
        lut = lutstore.load(key)
        if lut is None:
            lut = build_queue_lut(
                rho=axes["rho"], kappa=axes["kappa"],
                outstanding=axes["outstanding"], eta=axes["eta"],
                harvest=harvest, harvest_bw_gbps=harvest_bw_gbps,
                steps=steps, seed=seed, reps=reps, base=base,
                engine=engine, devices=devices, base_lut=base_lut,
                device=device)
            lutstore.save(key, lut, meta=dict(
                engine=str(engine), steps=int(steps), seed=int(seed),
                reps=int(reps), shape=list(lut.wait_ns.shape),
                harvest=harvest is not None))
        lutstore.cache_put(key, lut)
    return lut


def default_queue_lut(steps: int = DEFAULT_STEPS, seed: int = 0,
                      reps: int = DEFAULT_REPS,
                      engine: str = DEFAULT_ENGINE,
                      harvest: bool = False, device="cuda") -> QueueLUT:
    """The shared default-grid surface, resolved through the LUT store
    (built on ``device`` on a miss).  This is what
    ``cpu_model.solve(..., queue_model="memsim")`` uses when no LUT is
    passed (``harvest=True`` when any solved design harvests: the tables
    gain the :data:`DEFAULT_HARVEST_GRID` axis)."""
    return resolve_lut(steps=steps, seed=seed, reps=reps, engine=engine,
                       harvest=DEFAULT_HARVEST_GRID if harvest else None,
                       device=device)


# ---------------------------------------------------------------------------
# Adaptive grid refinement.
# ---------------------------------------------------------------------------

#: The LLM serving anchor whose wave-model token p99 tracks refinement.
REFINE_ARCH = "mistral-large-123b"

#: Probe anchor: the off-axis coordinates each midpoint is probed at.
PROBE_ANCHOR = dict(rho=0.74, kappa=1.6, outstanding=24.0, eta=0.60,
                    harvest_duty=0.0)

#: Intervals whose probe error is below this floor are never bisected --
#: DES sampling noise, not interpolation error.
REFINE_ERR_FLOOR = 0.02


def headline_metrics(lut: QueueLUT, device="cuda") -> dict:
    """The two convergence metrics of :func:`refine_queue_lut`.

    ``geomean_speedup``: CoaXiaL-4x over the DDR baseline, geomean over
    the Table-4 suite, both solved on the MEMSIM backend through ``lut``
    (the fig7 headline).  ``token_p99_ms``: the capacity planner's
    wave-model token p99 for :data:`REFINE_ARCH` on CoaXiaL-4x, composed
    from the solved ``latency_p99_ns``/``ipc`` exactly as the designer's
    in-loop SLO does.  Both are pure LUT-backed fixed-point solves on
    ``device`` -- no DES runs, so a refinement round costs two solves
    plus the probe batch.
    """
    from repro_torch.core import cpu_model  # runtime: import cycle
    from repro_torch.core.designer import _wave_geometry
    from repro_torch.serving.demand import (DEFAULT_BATCH, DEFAULT_CONTEXT,
                                            llm_workload)
    wls = tuple(cpu_model.WORKLOADS) + (llm_workload(REFINE_ARCH),)
    res = cpu_model.solve(cpu_model.COAXIAL_4X, queue_model="memsim",
                          lut=lut, workloads=wls, device=device)
    ref = cpu_model.solve(cpu_model.DDR_BASELINE, queue_model="memsim",
                          lut=lut, workloads=wls, device=device)
    n_suite = len(cpu_model.WORKLOADS)
    sp = (np.asarray(res.ipc, np.float64)[:n_suite]
          / np.asarray(ref.ipc, np.float64)[:n_suite])
    waves, model_coef = _wave_geometry(REFINE_ARCH, DEFAULT_BATCH,
                                       DEFAULT_CONTEXT)
    tok99_s = max(waves * float(res.latency_p99_ns[-1]) * 1e-9,
                  model_coef / float(res.ipc[-1]))
    return dict(geomean_speedup=float(np.exp(np.mean(np.log(sp)))),
                token_p99_ms=tok99_s * 1e3)


def _midpoint(axis: str, lo: float, hi: float) -> float:
    """Interval midpoint in the axis's interpolation space (geometric
    for the log-interpolated ``outstanding`` axis, arithmetic else)."""
    if axis == "outstanding":
        return float(np.sqrt(lo * hi))
    return 0.5 * (lo + hi)


def refine_queue_lut(*, rho=None, kappa=None, outstanding=None,
                     eta=None, harvest=None,
                     harvest_bw_gbps: float = HARVEST_REF_BW_GBPS,
                     steps: int = DEFAULT_STEPS, seed: int = 0,
                     reps: int = DEFAULT_REPS,
                     engine: str = DEFAULT_ENGINE, devices=None,
                     tol: float = 0.01, max_rounds: int = 4,
                     metrics=None, device="cuda"):
    """Adaptively refine the LUT grid until the metrics stop moving.

    Starting from the given grids (default: every-other-point
    coarsenings of the default grids), each round (1) resolves the
    current grid through the store, growing the previous round's surface
    incrementally; (2) evaluates ``metrics(lut)`` (a dict with
    ``geomean_speedup`` and ``token_p99_ms``; default
    :func:`headline_metrics` on ``device``) and stops when both moved
    less than ``tol`` (relative) against the previous round; (3) else
    probes every interval midpoint per axis (off-axis coordinates at
    :data:`PROBE_ANCHOR`) against ONE batched DES run on ``device`` and
    bisects the worst-error interval of each axis whose error clears
    :data:`REFINE_ERR_FLOOR`.  Returns ``(lut, history)``, one dict per
    round (shape, cells, metrics, deltas, worst probe error, seconds,
    ``converged``).
    """
    from repro_torch.core import memsim  # runtime: import cycle
    if metrics is None:
        metrics = lambda lut: headline_metrics(lut, device=device)
    grids = dict(
        rho=tuple(rho) if rho is not None else DEFAULT_RHO_GRID[::2],
        kappa=(tuple(kappa) if kappa is not None
               else DEFAULT_KAPPA_GRID[::2]),
        outstanding=(tuple(outstanding) if outstanding is not None
                     else DEFAULT_OUTSTANDING_GRID[::2]),
        eta=tuple(eta) if eta is not None else DEFAULT_ETA_GRID[::2])
    if harvest is not None:
        grids["harvest_duty"] = tuple(harvest)
    history: list[dict] = []
    lut, prev = None, None
    for rnd in range(int(max_rounds)):
        t0 = time.perf_counter()
        lut = resolve_lut(
            rho=grids["rho"], kappa=grids["kappa"],
            outstanding=grids["outstanding"], eta=grids["eta"],
            harvest=grids.get("harvest_duty"),
            harvest_bw_gbps=harvest_bw_gbps, steps=steps, seed=seed,
            reps=reps, engine=engine, devices=devices, base_lut=lut,
            device=device)
        m = metrics(lut)
        row = dict(round=rnd,
                   shape=tuple(len(g) for g in grids.values()),
                   cells=int(np.prod([len(g) for g in grids.values()])),
                   converged=False, worst_err=0.0,
                   seconds=round(time.perf_counter() - t0, 3), **m)
        if prev is not None:
            row["d_geomean"] = abs(m["geomean_speedup"]
                                   / prev["geomean_speedup"] - 1.0)
            row["d_token_p99"] = abs(m["token_p99_ms"]
                                     / prev["token_p99_ms"] - 1.0)
            if (row["d_geomean"] < tol and row["d_token_p99"] < tol):
                row["converged"] = True
                history.append(row)
                break
        prev = m

        # Probe every interval midpoint, one batched DES run (canonical
        # streams: the probes are reproducible cell for cell).
        probes, owners = [], []
        for axis, grid in grids.items():
            for j in range(len(grid) - 1):
                c = dict(PROBE_ANCHOR)
                if "harvest_duty" not in grids:
                    c.pop("harvest_duty")
                c[axis] = _midpoint(axis, grid[j], grid[j + 1])
                probes.append(c)
                owners.append((axis, j))
        names = tuple(grids)
        coords = np.asarray([[p[n] for n in names] for p in probes])
        extra = ({"harvest_bw_gbps": float(harvest_bw_gbps)}
                 if "harvest_duty" in grids else {})
        cha = memsim.stack_channels(
            [memsim.ChannelConfig(**p, **extra) for p in probes])
        stats = memsim.simulate_cells(
            cha, steps=int(steps), seed=int(seed), reps=int(reps),
            engine=engine, devices=devices,
            stream_ids=cell_stream_ids(names, coords),
            chunk=memsim.canonical_chunk(engine), device=device)
        des_wait = np.maximum(
            np.asarray(stats.mean_ns, np.float64) - hw.DRAM_SERVICE_NS,
            0.0)
        tabs = lut.tables()
        lut_wait = np.asarray([float(tabs.lookup(
            p["rho"], p["kappa"], p["outstanding"], p["eta"],
            p.get("harvest_duty", 0.0))[0]) for p in probes])
        # Error relative to the TOTAL access latency (wait + service):
        # that is what the solver consumes.
        err = (np.abs(lut_wait - des_wait)
               / (des_wait + hw.DRAM_SERVICE_NS))
        row["worst_err"] = float(err.max()) if len(err) else 0.0
        history.append(row)

        # Bisect each axis's worst interval (if it clears the floor).
        grew = False
        for axis in names:
            cand = [(err[i], owners[i][1]) for i in range(len(owners))
                    if owners[i][0] == axis]
            if not cand:
                continue
            worst, j = max(cand)
            if worst <= REFINE_ERR_FLOOR:
                continue
            g = list(grids[axis])
            g.insert(j + 1, _midpoint(axis, g[j], g[j + 1]))
            grids[axis] = tuple(g)
            grew = True
        if not grew:
            # Nothing left to bisect: the next round's metrics cannot
            # move, so record the (exactly zero) deltas and stop.
            m2 = metrics(lut)
            history.append(dict(
                round=rnd + 1, shape=row["shape"], cells=row["cells"],
                converged=True, worst_err=row["worst_err"], seconds=0.0,
                d_geomean=0.0, d_token_p99=0.0, **m2))
            break
    return lut, history
