"""The paper's 35 evaluated workloads (Table 4) and their memory behaviour.

Port of ``repro/core/workloads.py``: the port's own copy of the Table-4
anchors (IPC and LLC MPKI on the DDR baseline, which ``cpu_model``
reproduces exactly when it calibrates) and of the behavioural parameters
the paper describes but does not tabulate, set from suite defaults plus
per-workload overrides where the paper gives evidence:

  wb         write-back traffic per read (R:W 2:1-3:1, §4.3).
  kappa      burst peak-to-mean arrival ratio (§6.2, bwaves).
  eta        bank/channel balance factor (§6.2, kmeans).
  exec_frac  non-memory share of baseline CPI (sets the effective MLP).
  gamma      stall sensitivity to latency *variance* (§3.2).
  ws_mb      per-instance working set, for LLC-fit corner cases (§6.5).

The registry (``register_workload`` ...) is the live view that sweeps
read; ``WORKLOADS`` stays the Table-4 calibration set.  ``as_arrays``
gives the structure-of-arrays view as float32 tensors on a device.
"""

from __future__ import annotations

import dataclasses
import sys

import torch


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    suite: str
    ipc: float        # Table 4, per-core IPC on the loaded DDR baseline
    mpki: float       # Table 4, LLC misses per kilo-instruction
    wb: float         # write-back bytes per read byte
    kappa: float      # burst peak-to-mean arrival-rate ratio (>= 1)
    eta: float        # bank/channel balance factor (<= 1)
    exec_frac: float  # non-memory share of baseline CPI
    gamma: float      # stall sensitivity to latency stdev
    pf_boost: float   # extra MLP from prefetchers when bandwidth is free
    ws_mb: float      # per-instance working set (MB)


def _w(name, suite, ipc, mpki, *, wb, kappa, eta, exec_frac, gamma,
       pf_boost=0.0, ws_mb=512.0):
    return Workload(name, suite, ipc, mpki, wb=wb, kappa=kappa, eta=eta,
                    exec_frac=exec_frac, gamma=gamma, pf_boost=pf_boost,
                    ws_mb=ws_mb)


# Suite defaults: (wb, kappa, eta, exec_frac, gamma)
_LIGRA = dict(wb=0.30, kappa=1.5, eta=0.85, exec_frac=0.20, gamma=0.35,
              pf_boost=0.8)
_SPEC = dict(wb=0.50, kappa=1.3, eta=0.80, exec_frac=0.45, gamma=0.40,
             pf_boost=1.0)
_PARSEC = dict(wb=0.40, kappa=1.6, eta=0.55, exec_frac=0.60, gamma=0.55,
               pf_boost=0.3)


WORKLOADS: tuple[Workload, ...] = (
    # --- Ligra graph analytics (12) -------------------------------------
    _w("pagerank", "ligra", 0.36, 40, **_LIGRA),
    _w("pagerank-delta", "ligra", 0.31, 27, **_LIGRA),
    _w("components-shortcut", "ligra", 0.34, 48, **_LIGRA),
    _w("components", "ligra", 0.36, 48, **_LIGRA),
    _w("bc", "ligra", 0.33, 34, **_LIGRA),
    _w("radii", "ligra", 0.41, 33, **_LIGRA),
    _w("bfscc", "ligra", 0.68, 17, **{**_LIGRA, "exec_frac": 0.30}),
    _w("bfs", "ligra", 0.69, 15, **{**_LIGRA, "exec_frac": 0.30}),
    _w("bfs-bitvector", "ligra", 0.84, 15, **{**_LIGRA, "exec_frac": 0.30}),
    _w("bellmanford", "ligra", 0.86, 9, **{**_LIGRA, "exec_frac": 0.35}),
    _w("triangle", "ligra", 0.65, 21, **{**_LIGRA, "exec_frac": 0.30}),
    _w("mis", "ligra", 1.37, 8, **{**_LIGRA, "exec_frac": 0.50,
                                   "gamma": 0.25}),
    # --- STREAM (4): independent streaming, MSHRs saturated --------------
    _w("stream-copy", "stream", 0.17, 58, wb=0.40, kappa=1.5, eta=1.0,
       exec_frac=0.05, gamma=0.05, pf_boost=1.5, ws_mb=4096),
    _w("stream-scale", "stream", 0.21, 48, wb=0.40, kappa=1.5, eta=1.0,
       exec_frac=0.05, gamma=0.05, pf_boost=1.5, ws_mb=4096),
    _w("stream-add", "stream", 0.16, 69, wb=0.33, kappa=1.5, eta=1.0,
       exec_frac=0.05, gamma=0.05, pf_boost=1.5, ws_mb=4096),
    _w("stream-triad", "stream", 0.18, 59, wb=0.33, kappa=1.5, eta=1.0,
       exec_frac=0.05, gamma=0.05, pf_boost=1.5, ws_mb=4096),
    # --- SPEC-speed 2017 (12) -------------------------------------------
    # lbm: stream-like, 91% of latency is queuing (paper §3.1/Fig 5).
    _w("lbm", "spec", 0.14, 64, wb=0.5, kappa=1.5, eta=1.0, exec_frac=0.05,
       gamma=0.05, pf_boost=1.5, ws_mb=2048),
    # bwaves: bursty -- ~390ns queuing at only ~32% utilization (§6.2).
    _w("bwaves", "spec", 0.33, 14, wb=0.5, kappa=3.2, eta=1.0,
       exec_frac=0.30, gamma=0.20, pf_boost=1.0),
    _w("cactusbssn", "spec", 0.68, 8, **{**_SPEC, "exec_frac": 0.50,
                                         "gamma": 0.30}),
    _w("fotonik3d", "spec", 0.33, 22, **{**_SPEC, "wb": 0.6, "eta": 0.9,
                                         "exec_frac": 0.25, "gamma": 0.20,
                                         "pf_boost": 1.5}),
    _w("cam4", "spec", 0.87, 6, **{**_SPEC, "exec_frac": 0.60}),
    _w("wrf", "spec", 0.61, 11, **_SPEC),
    # mcf / omnetpp / xalancbmk: pointer-heavy, dependence-dominated.
    _w("mcf", "spec", 0.793, 13, wb=0.3, kappa=1.3, eta=0.7, exec_frac=0.50,
       gamma=0.55, pf_boost=0.0),
    _w("roms", "spec", 0.783, 6, **{**_SPEC, "exec_frac": 0.55}),
    _w("pop2", "spec", 1.55, 3, **{**_SPEC, "exec_frac": 0.70}),
    _w("omnetpp", "spec", 0.51, 10, wb=0.3, kappa=1.3, eta=0.6,
       exec_frac=0.50, gamma=0.60, pf_boost=0.0),
    _w("xalancbmk", "spec", 0.55, 12, wb=0.3, kappa=1.3, eta=0.6,
       exec_frac=0.50, gamma=0.50, pf_boost=0.0, ws_mb=10.0),
    # gcc: low-moderate traffic + heavy dependencies -> worst regression.
    _w("gcc", "spec", 0.31, 19, wb=0.3, kappa=1.0, eta=0.10,
       exec_frac=0.05, gamma=0.65, pf_boost=0.0),
    # --- PARSEC (5) -------------------------------------------------------
    _w("fluidanimate", "parsec", 0.78, 7, **_PARSEC),
    _w("facesim", "parsec", 0.74, 6, **_PARSEC),
    _w("raytrace", "parsec", 1.17, 5, **{**_PARSEC, "exec_frac": 0.65,
                                         "gamma": 0.40}),
    # streamcluster: mean 69ns / stdev 88ns baseline; 76/76 on COAXIAL
    # (§6.2) -- balanced-ish mean but bank-imbalance variance.
    _w("streamcluster", "parsec", 0.99, 14, wb=0.40, kappa=1.0, eta=0.05,
       exec_frac=0.35, gamma=0.80, pf_boost=0.5),
    _w("canneal", "parsec", 0.66, 7, **{**_PARSEC, "eta": 0.6,
                                        "exec_frac": 0.50, "gamma": 0.5}),
    # --- KVS & data analytics (2) ----------------------------------------
    _w("masstree", "kvs", 0.37, 21, wb=0.30, kappa=1.6, eta=0.85,
       exec_frac=0.40, gamma=0.50, pf_boost=0.0),
    # kmeans: highest utilization yet ~50ns queuing; near-zero writes (§6.2).
    _w("kmeans", "kvs", 0.50, 36, wb=0.05, kappa=1.0, eta=0.13,
       exec_frac=0.30, gamma=0.15, pf_boost=1.5, ws_mb=2048),
)


NAMES = tuple(w.name for w in WORKLOADS)
SUITES = tuple(sorted({w.suite for w in WORKLOADS}))

#: Behavioral parameters a sweep axis may bind (every float field of
#: :class:`WorkloadArrays`); ``name`` is identity, not a parameter.
SWEEPABLE_FIELDS = ("ipc", "mpki", "wb", "kappa", "eta", "exec_frac",
                    "gamma", "pf_boost", "ws_mb")

# ---------------------------------------------------------------------------
# Workload registry.  Seeded with Table 4; derived workloads register at
# runtime and flow into every registry-backed sweep, exactly like
# coaxial's design registry.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, "Workload"] = {w.name: w for w in WORKLOADS}


def _registry_changed():
    """Invalidate caches keyed on the registry (looked up, not imported:
    coaxial imports this module)."""
    coaxial = sys.modules.get("repro_torch.core.coaxial")
    if coaxial is not None:
        coaxial.default_sweep.cache_clear()


def register_workload(w: Workload, *, overwrite: bool = False) -> Workload:
    """Add a workload to the registry (and to every future registry-backed
    sweep).

    Re-registering the SAME workload is an idempotent no-op (the
    existing entry is returned, caches stay warm); a *different*
    workload under an existing name -- Table-4 seeds included -- raises
    unless ``overwrite``.
    """
    prev = _REGISTRY.get(w.name)
    if prev is not None:
        if prev == w:
            return prev
        if not overwrite:
            raise ValueError(f"workload {w.name!r} already registered "
                             f"with different parameters")
    _REGISTRY[w.name] = w
    _registry_changed()
    return w


def unregister_workload(name: str) -> Workload:
    """Remove a registered workload (Table-4 seeds may be removed too;
    re-import the module to restore them)."""
    w = _REGISTRY.pop(name)
    _registry_changed()
    return w


def all_workloads() -> tuple[Workload, ...]:
    """All registered workloads, registration-ordered (Table 4 first)."""
    return tuple(_REGISTRY.values())


def by_name(name: str) -> Workload:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; "
                       f"known: {sorted(_REGISTRY)}") from None


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device with no card
    raises: no solve moves to the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: torch sees no CUDA card; "
                           f"pass device='cpu' to solve on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class WorkloadArrays:
    """Structure-of-arrays view for vectorized evaluation: one tensor per
    parameter, workloads along the last axis."""

    name: tuple
    ipc: torch.Tensor
    mpki: torch.Tensor
    wb: torch.Tensor
    kappa: torch.Tensor
    eta: torch.Tensor
    exec_frac: torch.Tensor
    gamma: torch.Tensor
    pf_boost: torch.Tensor
    ws_mb: torch.Tensor

    def __len__(self):
        return len(self.name)


def as_arrays(workloads=WORKLOADS, *, device="cuda",
              dtype=torch.float32) -> WorkloadArrays:
    """The workloads' parameters as ``dtype`` tensors on ``device`` (the
    reference's float64 table, rounded once to ``dtype``, as its solver
    does without x64)."""
    device = resolve_device(device)
    table = torch.tensor([[float(getattr(w, f)) for w in workloads]
                          for f in SWEEPABLE_FIELDS], dtype=torch.float64)
    rows = table.to(dtype).to(device).unbind(0)
    return WorkloadArrays(name=tuple(w.name for w in workloads),
                          **dict(zip(SWEEPABLE_FIELDS, rows)))
