"""CLI for the gradient-based designer: ``python -m repro_torch.designer``.

Port of ``repro/designer.py``, with ``--device`` (default ``cuda``).
Optimizes a memory system under an area/pin budget and a p99 token-
latency SLO by projected gradient ascent through the differentiable
performance model (see :mod:`repro_torch.core.designer`), then
re-verifies the returned optimum with one direct event-driven DES run.

    python -m repro_torch.designer --area-budget 1.2 --slo-ms 500
    python -m repro_torch.designer --device cpu --steps 20000

Exit status 0 when the returned design meets the budget and the SLO and
the DES re-verification agrees within the calibration tolerance; 1
otherwise (the design is still printed so the miss can be audited).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.designer",
        description="Gradient-ascend a CXL memory-system design under an "
                    "area/pin budget and a p99 token-latency SLO.")
    p.add_argument("--area-budget", type=float, default=1.2,
                   help="max rel_area vs the DDR baseline (default 1.2)")
    p.add_argument("--pin-budget", type=float, default=None,
                   help="max rel_pins vs the DDR baseline (default: "
                        "unbounded)")
    p.add_argument("--slo-ms", type=float, default=500.0,
                   help="p99 token-latency SLO in ms; 0 disables the "
                        "constraint (default 500)")
    p.add_argument("--arch", default="stablelm-1.6b",
                   help="serving arch whose token p99 carries the SLO")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--context", type=int, default=2048)
    p.add_argument("--iters", type=int, default=None,
                   help="max ascent iterations")
    p.add_argument("--lr", type=float, default=None, help="step size")
    p.add_argument("--steps", type=int, default=None,
                   help="DES steps for the LUT build and verification "
                        "(default: honors $REPRO_DES_STEPS)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--engine", default="event",
                   choices=("event", "timestep"),
                   help="DES engine for the LUT build (verification is "
                        "always event-driven)")
    p.add_argument("--cost", default="rel_area",
                   choices=("rel_area", "rel_pins"),
                   help="frontier cost axis for the knee start")
    p.add_argument("--trajectory", action="store_true",
                   help="print the per-iteration ascent trajectory")
    p.add_argument("--device", default="cuda",
                   help="device the solves and the DES run on "
                        "(default: cuda)")
    args = p.parse_args(argv)

    from repro_torch.core import designer

    kwargs = dict(area_budget=args.area_budget,
                  pin_budget=args.pin_budget,
                  slo_ms=None if args.slo_ms <= 0 else args.slo_ms,
                  arch=args.arch, batch=args.batch, context=args.context,
                  cost=args.cost, steps=args.steps, seed=args.seed,
                  engine=args.engine, device=args.device)
    if args.iters is not None:
        kwargs["iters"] = args.iters
    if args.lr is not None:
        kwargs["lr"] = args.lr
    try:
        res = designer.optimize_design(**kwargs)
    except ValueError as e:
        print(f"designer: {e}", file=sys.stderr)
        return 1

    if args.trajectory:
        for t in res.trajectory:
            print(f"  it={t['iter']:3d} ch={t['dram_channels']:.3f} "
                  f"llc={t['llc_mb_per_core']:.3f} obj={t['objective']:.4f} "
                  f"gm={t['gm']:.4f} tok99={t['token_p99_s'] * 1e3:.2f}ms")
    print(res.summary())
    ok = res.meets_budget and res.meets_slo and res.verify["ok"]
    print(f"DESIGN {'OK' if ok else 'MISS'} "
          f"ch={float(res.design.dram_channels):.2f} "
          f"links={float(res.design.links):.2f} "
          f"llc={float(res.design.llc_mb_per_core):.2f}MB "
          f"area={res.rel_area:.3f} gm={res.gm_speedup:.3f}x")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
