"""CLI: ``python -m repro_torch.lut`` -- manage the port's QueueLUT store.

Port of ``repro/lut.py``.  Subcommands::

    python -m repro_torch.lut prebuild [--harvest] [--engine event] [--refine]
                                       [--device cuda]
    python -m repro_torch.lut inspect
    python -m repro_torch.lut gc [--older-than-days N | --all]

``prebuild`` resolves the default-grid surface(s) through the store
(``$REPRO_LUT_CACHE/torch``; see :mod:`repro_torch.core.lutstore`),
building on ``--device`` (default the card) on a miss, and prints per
surface the resolution wall-clock, the DES runs it made
(``memsim.sim_call_count``) and the scan kernels' launches on the card
(``kernels.memsim_scan.KERNELS``); a warm read prints ``sim_calls=0``.
``--refine`` runs :func:`repro_torch.core.queuelut.refine_queue_lut`
instead, printing the round-by-round convergence trajectory (each
round's grown grid is itself stored, so refinement also seeds the store).

``inspect`` lists every stored surface with its build meta; ``gc`` drops
quarantined artifacts plus entries that are stale (fingerprint mismatch)
or older than ``--older-than-days`` (``--all`` empties the store).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core import lutstore, memsim, queuelut
from repro_torch.kernels import memsim_scan


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.lut",
        description="prebuild / inspect / gc the on-disk QueueLUT store")
    sub = p.add_subparsers(dest="cmd", required=True)

    pb = sub.add_parser("prebuild",
                        help="resolve default surfaces into the store")
    pb.add_argument("--engine", choices=memsim.ENGINES, action="append",
                    help="engine(s) to build for (default: event)")
    pb.add_argument("--steps", type=int, default=queuelut.DEFAULT_STEPS)
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument("--reps", type=int, default=queuelut.DEFAULT_REPS)
    pb.add_argument("--harvest", action="store_true",
                    help="also build the 5-axis harvesting surface")
    pb.add_argument("--refine", action="store_true",
                    help="run the adaptive refinement loop instead of "
                         "the fixed default grid")
    pb.add_argument("--tol", type=float, default=0.01,
                    help="refinement convergence tolerance (rel.)")
    pb.add_argument("--device", default="cuda",
                    help="device a missing surface is built (and a "
                         "refinement solved) on (default: cuda)")

    sub.add_parser("inspect", help="list stored surfaces")

    g = sub.add_parser("gc", help="drop stale/quarantined entries")
    g.add_argument("--older-than-days", type=float, default=None)
    g.add_argument("--all", action="store_true",
                   help="empty the store entirely")
    return p


def _fmt_bytes(n: int) -> str:
    return f"{n / 1024:.0f} KiB" if n < 1 << 20 else f"{n / 1e6:.1f} MB"


def _launches() -> dict:
    return {k: v.launches for k, v in memsim_scan.KERNELS.items()}


def _prebuild(args) -> int:
    if lutstore.cache_dir() is None:
        print(f"WARNING: ${lutstore.ENV_VAR} is unset -- surfaces are "
              "built but not persisted")
    engines = tuple(dict.fromkeys(args.engine or ["event"]))
    harvests = (False, True) if args.harvest else (False,)
    if args.refine:
        for engine in engines:
            _, hist = queuelut.refine_queue_lut(
                steps=args.steps, seed=args.seed, reps=args.reps,
                engine=engine, tol=args.tol, device=args.device)
            for r in hist:
                extra = ("" if "d_geomean" not in r else
                         f" d_gm={r['d_geomean']:.4f} "
                         f"d_p99={r['d_token_p99']:.4f}")
                print(f"refine[{engine}] round {r['round']}: "
                      f"shape={r['shape']} cells={r['cells']} "
                      f"gm={r['geomean_speedup']:.4f} "
                      f"tok99={r['token_p99_ms']:.1f}ms "
                      f"worst_err={r['worst_err']:.3f} "
                      f"{r['seconds']:.1f}s{extra}")
            print(f"refine[{engine}]: "
                  + ("converged" if hist[-1]["converged"]
                     else "round budget exhausted"))
        return 0
    for engine in engines:
        for harvest in harvests:
            t0, n0, k0 = time.perf_counter(), memsim.sim_call_count(), \
                _launches()
            lut = queuelut.default_queue_lut(
                steps=args.steps, seed=args.seed, reps=args.reps,
                engine=engine, harvest=harvest, device=args.device)
            dt = time.perf_counter() - t0
            calls = memsim.sim_call_count() - n0
            launched = " ".join(f"{k}={v - k0[k]}"
                                for k, v in _launches().items())
            print(f"prebuild engine={engine} harvest={harvest}: "
                  f"shape={tuple(lut.wait_ns.shape)} {dt:.2f}s "
                  f"sim_calls={calls} launches: {launched}"
                  + (" (warm)" if calls == 0 else ""))
    return 0


def _inspect() -> int:
    root = lutstore.cache_dir()
    if root is None:
        print(f"${lutstore.ENV_VAR} is unset -- no store")
        return 1
    rows = lutstore.entries()
    fp = lutstore.mechanism_fingerprint()
    print(f"store {root}: {len(rows)} surface(s), fingerprint {fp[:12]}")
    for e in rows:
        stale = "" if e.get("fingerprint") == fp else "  [STALE]"
        print(f"  {e['path'].rsplit('/', 1)[-1]}  "
              f"{_fmt_bytes(e['bytes'])}  engine={e.get('engine', '?')} "
              f"steps={e.get('steps', '?')} shape={e.get('shape', '?')}"
              f"{stale}")
    return 0


def _gc(args) -> int:
    out = lutstore.gc(max_age_days=args.older_than_days,
                      everything=args.all)
    print(f"gc: removed {out['removed']} file(s), "
          f"freed {_fmt_bytes(out['bytes'])}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "prebuild":
        return _prebuild(args)
    if args.cmd == "inspect":
        return _inspect()
    return _gc(args)


if __name__ == "__main__":
    raise SystemExit(main())
