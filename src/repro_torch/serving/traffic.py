"""Request-rate traces -> per-epoch (rho, kappa) MMPP operating points.

Port of ``repro/serving/traffic.py``: pure Python and numpy, a copy of
the reference.

Serving load is doubly stochastic: a slow daily (or incident-driven)
envelope modulates the request rate, and within any epoch the arrivals
are bursty.  The DES already models the fast time scale exactly -- its
MMPP arrival process (``kappa``, ``burst_duty``, ``burst_sojourn_ns``)
is the within-epoch burstiness -- so a trace only has to supply the slow
envelope: a piecewise-constant sequence of :class:`Epoch` s, each with a
mean request rate and a peak-to-mean ``kappa`` for the DES to apply
inside the epoch.  The capacity planner turns each epoch into one DES
cell per memory tier (rho from offered bytes vs design bandwidth, kappa
verbatim), so p99 access latency per epoch comes from the event engine's
per-request records, not from a formula.

Three sources of traces:

* :func:`synthetic_diurnal` -- sinusoidal day: rate swings between a
  trough and a peak, burstiness rises with load (busy hours are also the
  bursty hours).
* :func:`poisson_burst`    -- flash-crowd pattern: a base rate with
  seeded random burst epochs at a multiple of it.
* :func:`load_csv`         -- measured traces, rows of ``t_s,rps[,kappa]``.

``get_trace`` resolves a CLI name or CSV path to a :class:`Trace`.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

#: kappa floor: even "calm" serving traffic is burstier than Poisson.
KAPPA_MIN = 1.0


@dataclasses.dataclass(frozen=True)
class Epoch:
    """One piecewise-constant segment of the request-rate envelope."""

    t_s: float       # epoch start, seconds since trace start
    dur_s: float     # epoch length, seconds
    rps: float       # mean offered request rate in the epoch
    kappa: float     # within-epoch burst peak-to-mean ratio (>= 1)
    #: Idle-I/O harvest lent-time fraction inside this epoch (arXiv
    #: 2511.12349): how much of the epoch the I/O links are idle enough
    #: to lend to the memory pool.  0 (the default) = no harvesting;
    #: :meth:`Trace.with_harvest` fills it anti-correlated with load.
    harvest_duty: float = 0.0

    def __post_init__(self):
        if self.dur_s <= 0 or self.rps < 0 or self.kappa < KAPPA_MIN:
            raise ValueError(f"bad epoch {self!r}")
        if not 0.0 <= self.harvest_duty < 1.0:
            raise ValueError(f"harvest_duty must be in [0, 1): {self!r}")


@dataclasses.dataclass(frozen=True)
class Trace:
    """A named request-rate trace (piecewise-constant envelope)."""

    name: str
    epochs: tuple[Epoch, ...]

    def __post_init__(self):
        if not self.epochs:
            raise ValueError("a trace needs at least one epoch")

    @property
    def peak_rps(self) -> float:
        return max(e.rps for e in self.epochs)

    @property
    def duration_s(self) -> float:
        return sum(e.dur_s for e in self.epochs)

    def scaled(self, factor: float) -> "Trace":
        """Same shape, every epoch's rate multiplied by ``factor``."""
        return Trace(self.name, tuple(
            dataclasses.replace(e, rps=e.rps * factor)
            for e in self.epochs))

    def with_harvest(self, duty_max: float) -> "Trace":
        """Fill per-epoch harvest duty ANTI-correlated with load.

        I/O links are idle when request load is low, so each epoch lends
        ``duty_max * (1 - rps / peak_rps)`` of its time: zero at the
        trace's peak epoch, approaching ``duty_max`` at a dead-idle one.
        ``duty_max=0`` clears harvesting (every epoch back to 0).
        """
        if not 0.0 <= duty_max < 1.0:
            raise ValueError(f"duty_max must be in [0, 1): {duty_max!r}")
        peak = self.peak_rps
        return Trace(self.name, tuple(
            dataclasses.replace(
                e, harvest_duty=duty_max * (1.0 - (e.rps / peak
                                                   if peak > 0 else 1.0)))
            for e in self.epochs))

    def to_csv(self, path: str) -> None:
        harvested = any(e.harvest_duty for e in self.epochs)
        with open(path, "w") as f:
            f.write("t_s,rps,kappa,harvest_duty\n" if harvested
                    else "t_s,rps,kappa\n")
            for e in self.epochs:
                row = f"{e.t_s:g},{e.rps:g},{e.kappa:g}"
                if harvested:
                    row += f",{e.harvest_duty:g}"
                f.write(row + "\n")


def synthetic_diurnal(n_epochs: int = 8, epoch_s: float = 3 * 3600.0,
                      peak_rps: float = 1.0, trough_frac: float = 0.25,
                      kappa_base: float = 1.3,
                      kappa_peak: float = 2.2) -> Trace:
    """A sinusoidal day sampled into ``n_epochs`` constant segments.

    Rate swings between ``trough_frac * peak_rps`` and ``peak_rps``;
    burstiness interpolates from ``kappa_base`` at the trough to
    ``kappa_peak`` at the peak (busy hours are bursty hours).
    """
    if not 0.0 < trough_frac <= 1.0:
        raise ValueError("trough_frac must be in (0, 1]")
    epochs = []
    for i in range(n_epochs):
        # Phase puts the peak mid-trace; s in [0, 1].
        s = 0.5 - 0.5 * math.cos(2.0 * math.pi * (i + 0.5) / n_epochs)
        rps = peak_rps * (trough_frac + (1.0 - trough_frac) * s)
        kappa = kappa_base + (kappa_peak - kappa_base) * s
        epochs.append(Epoch(i * epoch_s, epoch_s, rps, kappa))
    return Trace("synthetic-diurnal", tuple(epochs))


def poisson_burst(n_epochs: int = 12, epoch_s: float = 600.0,
                  base_rps: float = 0.4, burst_prob: float = 0.25,
                  burst_mult: float = 3.0, kappa_base: float = 1.4,
                  kappa_burst: float = 2.8, seed: int = 0) -> Trace:
    """Flash-crowd envelope: seeded random epochs at ``burst_mult``x."""
    rng = np.random.default_rng(seed)
    epochs = []
    for i in range(n_epochs):
        burst = bool(rng.random() < burst_prob)
        jitter = float(rng.uniform(0.85, 1.15))
        rps = base_rps * (burst_mult if burst else 1.0) * jitter
        kappa = kappa_burst if burst else kappa_base
        epochs.append(Epoch(i * epoch_s, epoch_s, rps, kappa))
    return Trace("poisson-burst", tuple(epochs))


def load_csv(path: str, name: str | None = None,
             default_kappa: float = 1.5) -> Trace:
    """Load ``t_s,rps[,kappa[,harvest_duty]]`` rows (header optional,
    ``#`` comments).

    Epoch durations come from consecutive start times; the last epoch
    reuses the previous duration (or 60 s for a one-row trace).

    The loader validates instead of guessing: ``t_s`` must be strictly
    increasing (a duplicate or out-of-order timestamp would silently
    become a zero- or negative-duration epoch), ``rps`` non-negative,
    ``kappa >= KAPPA_MIN``, ``harvest_duty`` in [0, 1), and every field
    float-parseable.  Violations raise ``ValueError`` naming the 1-based
    line number.  Only the FIRST non-comment line may be a non-numeric
    header.
    """
    rows = []
    seen_any = False
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 2:
                raise ValueError(
                    f"{path}:{lineno}: expected "
                    f"t_s,rps[,kappa[,harvest_duty]], got {line!r}")
            try:
                t = float(parts[0])
            except ValueError:
                if not seen_any:
                    seen_any = True
                    continue       # header row
                raise ValueError(
                    f"{path}:{lineno}: non-numeric t_s {parts[0]!r} "
                    f"(a header is only allowed as the first row)"
                ) from None
            seen_any = True
            try:
                rps = float(parts[1])
                kappa = (float(parts[2]) if len(parts) > 2
                         else default_kappa)
                duty = float(parts[3]) if len(parts) > 3 else 0.0
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from None
            if rows and t <= rows[-1][1][0]:
                op = "duplicates" if t == rows[-1][1][0] else "precedes"
                raise ValueError(
                    f"{path}:{lineno}: t_s={t:g} {op} the previous "
                    f"row's t_s={rows[-1][1][0]:g}; timestamps must be "
                    f"strictly increasing")
            if rps < 0:
                raise ValueError(
                    f"{path}:{lineno}: negative rps {rps:g}")
            if kappa < KAPPA_MIN:
                raise ValueError(
                    f"{path}:{lineno}: kappa {kappa:g} below the "
                    f"{KAPPA_MIN:g} floor")
            if not 0.0 <= duty < 1.0:
                raise ValueError(
                    f"{path}:{lineno}: harvest_duty {duty:g} outside "
                    f"[0, 1)")
            rows.append((lineno, (t, rps, kappa, duty)))
    if not rows:
        raise ValueError(f"no data rows in trace CSV {path!r}")
    rows = [r for _, r in rows]
    epochs = []
    for i, (t, rps, kappa, duty) in enumerate(rows):
        if i + 1 < len(rows):
            dur = rows[i + 1][0] - t
        elif epochs:
            dur = epochs[-1].dur_s
        else:
            dur = 60.0
        epochs.append(Epoch(t, dur, rps, kappa, duty))
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    return Trace(name, tuple(epochs))


#: Named generators the CLI accepts directly.
TRACES = {
    "synthetic-diurnal": synthetic_diurnal,
    "poisson-burst": poisson_burst,
}


def get_trace(name_or_path: str) -> Trace:
    """Resolve a built-in trace name or a CSV path to a :class:`Trace`."""
    gen = TRACES.get(name_or_path)
    if gen is not None:
        return gen()
    if os.path.exists(name_or_path):
        return load_csv(name_or_path)
    raise KeyError(f"unknown trace {name_or_path!r}; named traces: "
                   f"{sorted(TRACES)} (or a CSV path)")
