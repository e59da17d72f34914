"""CLI: ``python -m repro_torch.serving.plan`` -- pick a design for an SLO.

Port of ``repro/serving/plan.py``, with ``--device`` (default ``cuda``:
the solve and the DES run on the card; ``--device cpu`` runs both on the
CPU).  Examples::

    python -m repro_torch.serving.plan --arch mistral-large-123b \
        --slo-p99-ms 400 --trace synthetic-diurnal
    python -m repro_torch.serving.plan --arch stablelm-1.6b \
        --arch rwkv6-1.6b --slo-p99-ms 50 --trace poisson-burst \
        --peak-rps 0.5 --device cpu

With ``--peak-rps`` the trace's absolute rates are replaced so its peak
hits that request rate; otherwise ``--peak-util`` (default 0.65) scales
the trace so peak offered bytes sit at that fraction of the largest
candidate's bandwidth -- the planner then answers "which design clears
the SLO at a load the biggest machine could carry at 65%".
"""

from __future__ import annotations

import argparse

from repro_torch.core import hw
from repro_torch.serving.capacity import plan_capacity
from repro_torch.serving.traffic import TRACES, get_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.plan",
        description="LLM serving capacity planner on the COAXIAL engine")
    p.add_argument("--arch", action="append", required=True,
                   help="model arch id (repeat for a fleet)")
    p.add_argument("--slo-p99-ms", type=float, required=True,
                   help="p99 token-latency SLO, milliseconds")
    p.add_argument("--trace", default="synthetic-diurnal",
                   help=f"trace name {sorted(TRACES)} or a CSV path")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--context", type=int, default=4096)
    p.add_argument("--tokens-per-req", type=float, default=128.0)
    p.add_argument("--peak-rps", type=float, default=None,
                   help="pin the trace's peak request rate (abs. load)")
    p.add_argument("--peak-util", type=float, default=0.65,
                   help="scale trace to this peak utilization of the "
                        "largest candidate (ignored with --peak-rps)")
    p.add_argument("--channels", type=int, nargs="+", default=[2, 4, 8])
    p.add_argument("--llc-mb", type=float, nargs="+", default=[1.0])
    p.add_argument("--premium-ns", type=float, nargs="+",
                   default=[hw.CXL_LAT_NS, hw.CXL_LAT_PESSIMISTIC_NS])
    p.add_argument("--tier-splits", type=float, nargs="+",
                   default=[0.0, 0.5])
    p.add_argument("--no-measured", action="store_true",
                   help="exclude the measured 2303.15375 device points")
    p.add_argument("--steps", type=int, default=None,
                   help="DES simulated-time budget per cell, ns")
    p.add_argument("--engine", choices=("event", "timestep"),
                   default="event")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--p99-source", choices=("des", "lut"), default="des",
                   help="access p99 from one batched DES run (des) or "
                        "from the default QueueLUT (lut)")
    p.add_argument("--device", default="cuda",
                   help="device the solve and the DES run on "
                        "(default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    trace = get_trace(args.trace)
    peak_util = None if args.peak_rps is not None else args.peak_util
    if args.peak_rps is not None:
        trace = trace.scaled(args.peak_rps / trace.peak_rps)
    plan = plan_capacity(
        tuple(args.arch), trace, slo_p99_ms=args.slo_p99_ms,
        batch=args.batch, context=args.context,
        tokens_per_req=args.tokens_per_req,
        channels=tuple(args.channels), llc_mb=tuple(args.llc_mb),
        premium_ns=tuple(args.premium_ns),
        tier_splits=tuple(args.tier_splits),
        include_measured=not args.no_measured, peak_util=peak_util,
        steps=args.steps, seed=args.seed, engine=args.engine,
        p99_source=args.p99_source, device=args.device)
    for d in plan.demands:
        print(f"demand {d.arch}: {d.read_bytes / 1e6:.1f} MB/token "
              f"(mpki {d.mpki:.2f}, wb {d.wb:.3f}, ipc {d.ipc:.2f}, "
              f"exec_frac {d.exec_frac:.2f})")
    print(f"trace {plan.trace}: peak {plan.peak_rps:.3g} req/s, "
          f"{len(trace.epochs)} epochs; engine={plan.engine} "
          f"steps={plan.steps}")
    print(plan.table())
    best = plan.best
    if best is None:
        c = plan.closest
        print(f"\nNO design meets p99 <= {plan.slo_p99_ms:g} ms; closest: "
              f"{c.name} at {c.token_p99_ms:.1f} ms "
              f"(channels={c.channels}, llc={c.llc_mb_per_core:g} MB/core, "
              f"premium={c.premium_ns:g} ns, split={c.tier_split:g})")
        return 1
    print(f"\nPICK {best.name}: channels={best.channels}, "
          f"llc={best.llc_mb_per_core:g} MB/core, "
          f"premium={best.premium_ns:g} ns, tier_split={best.tier_split:g} "
          f"-- rel_area {best.rel_area:.3f}, p99 {best.token_p99_ms:.1f} ms "
          f"<= SLO {plan.slo_p99_ms:g} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
