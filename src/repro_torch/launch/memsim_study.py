"""The memory-system DES's surfaces in one command, on the card.

    PYTHONPATH=src python -m repro_torch.launch.memsim_study
    PYTHONPATH=src python -m repro_torch.launch.memsim_study --device cpu \
        --steps 20000

Runs, through ``repro_torch.core.coaxial`` and ``memsim`` (the README's
DES surfaces):

  * ``validate_calibration`` per engine at its gate settings (seed 3,
    48 replicas): the DES's mean, p90 and stdev against the closed form at
    each rho anchor, with the relative errors and the ``ok`` flag;
  * ``crosscheck_engines`` (seed 0, 64 replicas): event engine against
    timestep engine at each anchor, with the z-scores and ``ok``;
  * the paper's §3.1 worked example by the DES: a 60%-utilized DDR
    channel moved to 15% utilization plus a 30 ns CXL premium, its drop
    in mean and p90 latency next to the paper's ~50% and ~68%.

``--steps`` is the simulated-time budget of every run (default 200,000 ns,
the gates' own).  Simulates on the card unless ``--device cpu`` is given;
with no card, ``--device cuda`` raises.  ``main`` returns the printed
numbers as a dict, so that a caller can hold one device's run against
another's.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import coaxial, memsim
from repro_torch.core.workloads import resolve_device

#: The paper's §3.1 worked example: mean and p90 latency drop.
PAPER = {"mean_drop": 0.50, "p90_drop": 0.68}
#: Gate settings of the reference's calibration tests.
CALIBRATION_SEED, CALIBRATION_REPS = 3, 48
CROSSCHECK_SEED, CROSSCHECK_REPS = 0, 64
EXAMPLE_SEED, EXAMPLE_REPS = 3, 32


def calibration(steps: int, engine: str, device) -> dict:
    val = coaxial.validate_calibration(
        steps=steps, seed=CALIBRATION_SEED, reps=CALIBRATION_REPS,
        engine=engine, device=device)
    print(f"validate_calibration, {engine} engine ({steps} steps, seed "
          f"{CALIBRATION_SEED}, {CALIBRATION_REPS} reps): DES vs closed form")
    print(f"{'rho':>5s} {'mean':>9s} {'closed':>9s} {'err':>7s} "
          f"{'p90':>9s} {'closed':>9s} {'err':>7s} {'stdev':>9s} "
          f"{'closed':>9s} {'err':>7s}")
    out = {}
    for a in val["anchors"]:
        print(f"{a['rho']:5.2f} {a['des_mean_ns']:9.3f} "
              f"{a['closed_mean_ns']:9.3f} {a['mean_err']:+7.4f} "
              f"{a['des_p90_ns']:9.3f} {a['closed_p90_ns']:9.3f} "
              f"{a['p90_err']:+7.4f} {a['des_stdev_ns']:9.3f} "
              f"{a['closed_stdev_ns']:9.3f} {a['stdev_err']:+7.4f}")
        for k in ("des_mean_ns", "des_p90_ns", "des_stdev_ns"):
            out[f"{engine}_{k}_rho{a['rho']}"] = a[k]
    print(f"max |err|: mean {val['max_abs_mean_err']:.4f} (tol "
          f"{val['mean_tol']}), p90 {val['max_abs_p90_err']:.4f} (tol "
          f"{val['p90_tol']}), stdev {val['max_abs_stdev_err']:.4f} (tol "
          f"{val['stdev_tol']}) -> ok {val['ok']}")
    out.update({f"{engine}_max_abs_{k}_err": val[f"max_abs_{k}_err"]
                for k in ("mean", "p90", "stdev")})
    out[f"{engine}_calibration_ok"] = val["ok"]
    return out


def crosscheck(steps: int, device) -> dict:
    cc = coaxial.crosscheck_engines(steps=steps, seed=CROSSCHECK_SEED,
                                    reps=CROSSCHECK_REPS, device=device)
    print(f"crosscheck_engines ({steps} steps, seed {CROSSCHECK_SEED}, "
          f"{CROSSCHECK_REPS} reps): event vs timestep engine")
    print(f"{'rho':>5s} {'ts mean':>9s} {'ev mean':>9s} {'err':>7s} "
          f"{'z':>7s} {'ts p90':>9s} {'ev p90':>9s} {'err':>7s} {'z':>7s} "
          f"ok")
    out = {}
    for a in cc["anchors"]:
        print(f"{a['rho']:5.2f} {a['timestep_mean_ns']:9.3f} "
              f"{a['event_mean_ns']:9.3f} {a['mean_err']:+7.4f} "
              f"{a['mean_z']:+7.2f} {a['timestep_p90_ns']:9.3f} "
              f"{a['event_p90_ns']:9.3f} {a['p90_err']:+7.4f} "
              f"{a['p90_z']:+7.2f} {a['ok']}")
        for k in ("timestep_mean_ns", "event_mean_ns", "timestep_p90_ns",
                  "event_p90_ns"):
            out[f"crosscheck_{k}_rho{a['rho']}"] = a[k]
    print(f"max |err|: mean {cc['max_abs_mean_err']:.4f} (tol "
          f"{cc['mean_tol']}), p90 {cc['max_abs_p90_err']:.4f} (tol "
          f"{cc['p90_tol']}), or |z| <= {cc['se_k']} -> ok {cc['ok']}")
    out["crosscheck_ok"] = cc["ok"]
    return out


def worked_example(steps: int, device) -> dict:
    sw = coaxial.distribution_sweep(
        rho=(0.6, 0.15), cxl_lat_ns=(0.0, 30.0), steps=steps,
        seed=EXAMPLE_SEED, reps=EXAMPLE_REPS, device=device)
    ddr = sw.sel(rho=0.6, cxl_lat_ns=0.0)
    cxl = sw.sel(rho=0.15, cxl_lat_ns=30.0)
    out = dict(ddr_mean_ns=float(ddr.mean_ns), ddr_p90_ns=float(ddr.p90_ns),
               cxl_mean_ns=float(cxl.mean_ns), cxl_p90_ns=float(cxl.p90_ns))
    out["mean_drop"] = 1.0 - out["cxl_mean_ns"] / out["ddr_mean_ns"]
    out["p90_drop"] = 1.0 - out["cxl_p90_ns"] / out["ddr_p90_ns"]
    print(f"§3.1 worked example by the DES ({steps} steps, seed "
          f"{EXAMPLE_SEED}, {EXAMPLE_REPS} reps): DDR at 60% mean "
          f"{out['ddr_mean_ns']:.3f} ns p90 {out['ddr_p90_ns']:.3f} ns; CXL "
          f"at 15% + 30 ns mean {out['cxl_mean_ns']:.3f} ns p90 "
          f"{out['cxl_p90_ns']:.3f} ns")
    print(f"{'metric':34s} {'paper':>8s} {'ours':>8s}")
    print(f"{'mean latency drop':34s} {PAPER['mean_drop']:8.2f} "
          f"{out['mean_drop']:8.4f}")
    print(f"{'p90 latency drop':34s} {PAPER['p90_drop']:8.2f} "
          f"{out['p90_drop']:8.4f}")
    return {f"example_{k}": v for k, v in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=200_000,
                    help="simulated ns of every run (default 200000)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = ("CPU" if device.type == "cpu"
            else torch.cuda.get_device_name(0))
    print(f"[memsim_study] simulating on {args.device} ({name})")
    out = {}
    for engine in memsim.ENGINES:
        out.update(calibration(args.steps, engine, args.device))
    out.update(crosscheck(args.steps, args.device))
    out.update(worked_example(args.steps, args.device))
    return out


if __name__ == "__main__":
    main()
