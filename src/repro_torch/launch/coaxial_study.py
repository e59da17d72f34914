"""Reproduce the paper's headline analysis in one command, on the card.

    PYTHONPATH=src python -m repro_torch.launch.coaxial_study
    PYTHONPATH=src python -m repro_torch.launch.coaxial_study --device cpu

Port of ``examples/coaxial_study.py``: prints the Fig 5 / Fig 7 / Fig 8 /
Table 5 headline numbers next to the paper's reported values, the lbm
row, the area/speedup Pareto frontier over every design x LLC size, the
gradient of the geomean speedup at COAXIAL-4x, and the channelized-decode
plan the same queueing argument gives for mistral-large at 32k context
on H100s over NVLink (``core/planner.plan_decode_kv``, the reference's
own byte and flop counts).  Solves on the card unless ``--device cpu``
is given; with no card, ``--device cuda`` raises.  The plan is for the
H100 part the run is on; on the CPU for the part a caller passes
(``main(..., spec=)``), by default the SXM part.

``main`` returns the printed numbers as a dict, so that a caller can hold
one device's run against another's.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import coaxial, hw, planner
from repro_torch.core.workloads import resolve_device

PAPER = {
    "coaxial-4x": 1.52, "coaxial-2x": 1.26, "coaxial-asym": 1.67,
    "50ns": 1.33, "edp": 0.72,
}
#: The LLC sizes of the Pareto sweep (MB per core).
PARETO_LLC = (0.5, 1.0, 2.0, 4.0)
#: The design fields whose gradient the study prints.
GRADIENT_FIELDS = ("dram_channels", "llc_mb_per_core", "iface_lat_ns")
#: mistral-large-123b decoding at 32k context, the reference's own counts:
#: batch 8, 88 layers, 8 KV heads of 128 and 96 query heads, bf16.  KV
#: bytes read a step (K and V, all layers), attention flops a step, and
#: the bytes a merge stage exchanges (fp32 (B, Hq, D + 2) partials a layer).
DECODE_LAYERS = 88
DECODE_PLAN = dict(kv_bytes=8 * 32768 * 8 * 128 * 2 * 2 * 88,
                   qkv_flops=4 * 88 * 8 * 32768 * 96 * 128,
                   combine_bytes=88 * 8 * 96 * 130 * 4)


def decode_plan(spec: hw.GpuSpec) -> planner.DecodePlan:
    """The study's channelized-decode plan on the H100 part ``spec``."""
    return planner.plan_decode_kv(**DECODE_PLAN, spec=spec)


def main(argv=None, spec: hw.GpuSpec | None = None) -> dict:
    """Run the study; ``spec`` is the H100 part the decode plan is for
    (by default the card's own, and the SXM part on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args(argv).device
    name = ("CPU" if resolve_device(device).type == "cpu"
            else torch.cuda.get_device_name(0))
    if spec is None:
        spec = hw.H100_SXM if name == "CPU" else hw.spec_for(name)
    print(f"[coaxial_study] solving on {device} ({name})")
    print(f"{'metric':34s} {'paper':>8s} {'ours':>8s}")
    # One batched sweep solves every (design, latency, core-count) cell.
    sw = coaxial.default_sweep(device)
    c4 = sw.comparison(coaxial.COAXIAL_4X)
    c2 = sw.comparison(coaxial.COAXIAL_2X)
    ca = sw.comparison(coaxial.COAXIAL_ASYM)
    c50 = sw.comparison(coaxial.COAXIAL_4X, iface_lat=50.0)
    edp = coaxial.edp_report(coaxial.COAXIAL_4X, cmp=c4)
    out = dict(gm_4x=c4.geomean_speedup, gm_2x=c2.geomean_speedup,
               gm_asym=ca.geomean_speedup, gm_50ns=c50.geomean_speedup,
               edp_ratio=edp["edp_ratio"])
    rows = [
        ("geomean speedup, COAXIAL-4x", PAPER["coaxial-4x"], out["gm_4x"]),
        ("geomean speedup, COAXIAL-2x", PAPER["coaxial-2x"], out["gm_2x"]),
        ("geomean speedup, COAXIAL-asym", PAPER["coaxial-asym"],
         out["gm_asym"]),
        ("geomean speedup @50ns premium", PAPER["50ns"], out["gm_50ns"]),
        ("EDP ratio (Table 5)", PAPER["edp"], out["edp_ratio"]),
    ]
    for label, paper, ours in rows:
        print(f"{label:34s} {paper:8.2f} {ours:8.2f}")
    print()
    lbm = c4.row("lbm")
    out.update(lbm_base_latency_ns=lbm["base_latency_ns"],
               lbm_latency_ns=lbm["latency_ns"], lbm_speedup=lbm["speedup"])
    print(f"lbm: {lbm['base_latency_ns']:.0f}ns -> {lbm['latency_ns']:.0f}ns, "
          f"speedup {lbm['speedup']:.2f}x (paper: ~3x, queuing-dominated)")

    # Beyond the paper: a named-axis sweep (every design x LLC capacities,
    # one solver pass) reduced to its area/speedup Pareto frontier, and the
    # gradient of the same differentiable model at COAXIAL-4x.
    grid = coaxial.sweep_spec(design=coaxial.all_designs(),
                              llc_mb_per_core=PARETO_LLC)
    front = coaxial.solve_spec(grid, device=device).pareto(cost="rel_area")
    best = front[-1]
    out.update(pareto_points=len(front), pareto_best=best["design"],
               pareto_best_llc=best["llc_mb_per_core"],
               pareto_best_speedup=best["geomean_speedup"],
               pareto_best_area=best["rel_area"])
    print(f"\npareto frontier (designs x LLC, {len(front)} points): best "
          f"{best['design']}@{best['llc_mb_per_core']:g}MB/core = "
          f"{best['geomean_speedup']:.2f}x at {best['rel_area']:.2f}x area")
    g = coaxial.design_gradient(coaxial.COAXIAL_4X, GRADIENT_FIELDS,
                                device=device)
    out.update({f"grad_{k}": v for k, v in g.items()})
    print("d(geomean speedup)/d(field) at coaxial-4x: " +
          ", ".join(f"{k}={v:+.4f}" for k, v in g.items()))

    plan = decode_plan(spec)
    out.update(plan_part=spec.part, plan_n_channels=plan.n_channels,
               plan_speedup=plan.speedup, plan_step_s=plan.cost.total_s,
               plan_baseline_s=plan.baseline.total_s,
               plan_dominant=plan.cost.dominant)
    print(f"H100 channelized decode (mistral-large 32k): "
          f"{plan.n_channels} KV channels -> {plan.speedup:.1f}x predicted "
          f"(H100 {spec.part}, NVLink {spec.link_bw / 1e9:g} GB/s one way)")
    return out


if __name__ == "__main__":
    main()
