"""The products behind a dry-run cell's FLOPs a chip, port and reference.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_products.py \
        ARCH SHAPE [--top N] [--port-only] [--multi-pod]

Lists the largest terms of one cell's FLOPs a chip, each side in a
process of its own, largest first:
  * the port: ``repro_torch.launch.dryrun.run_cell`` with the cost
    meter's products (``core/hloparse``: mm, bmm, ...) summed by op and
    operand shapes, and the hand kernels' stand-in charges by the
    function that charged them;
  * the reference: the compiled HLO of ``repro.launch.dryrun.run_cell``'s
    cell, its dots summed by the loops around them (each ``while``'s trip
    count, as ``repro.core.hloparse.analyze`` scales it) and by operand
    shapes.
A term's shapes are a rank's local ones, so they show how each side
splits the work.  ``--port-only`` runs the port's side alone (where JAX
is not installed); ``--multi-pod`` takes the cell on the multi-pod mesh.
This script imports neither package itself.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PORT = """
import collections, sys, traceback
from repro_torch.core import hloparse as H
from repro_torch.launch import dryrun
terms = collections.Counter()
count, charge = H.Meter._count, H.charge
def counted(self, name, func, args, out):
    if name in H._DOTS:
        i = 1 if name in ("aten.addmm", "aten.baddbmm") else 0
        terms[(name, tuple(args[i].shape), tuple(args[i + 1].shape))] += \\
            H._dot_flops(name, args, out)
    return count(self, name, func, args, out)
def charged(flops, nbytes):
    terms[("charge", traceback.extract_stack(limit=3)[0].name, "")] += flops
    return charge(flops, nbytes)
H.Meter._count, H.charge = counted, charged
res = dryrun.run_cell(sys.argv[1], sys.argv[2], multi_pod=sys.argv[4] == "1")
print(f"port {res.status} {res.flops_per_chip:.4e} FLOP a chip {res.error[:300]}")
for key, flops in terms.most_common(int(sys.argv[3])):
    print(f"  {flops:.3e}", *key)
"""

_REFERENCE = """
import collections, re, sys
from repro.core import hloparse as H
from repro.launch import dryrun
texts = []
analyze = H.analyze
H.analyze = lambda text: texts.append(text) or analyze(text)
res = dryrun.run_cell(sys.argv[1], sys.argv[2], multi_pod=sys.argv[4] == "1")
print(f"reference {res.status} {res.flops_per_chip:.4e} FLOP a chip")
comps = H.parse_computations(texts[0]) if texts else {}
terms = collections.Counter()
def walk(name, scale, loops):
    ops = comps.get(name, [])
    shapes = {op.name: H._first_array_dims(op.type_str)[1] for op in ops}
    for op in ops:
        if op.op == "while":
            body = re.search(r"body=%?([\\w\\.\\-]+)", op.attrs).group(1)
            cond = re.search(r"condition=%?([\\w\\.\\-]+)", op.attrs)
            trips = H._trip_count(comps.get(cond.group(1), [])) if cond else 1
            walk(body, scale * trips, loops + (f"while x{trips}",))
        elif op.op in ("fusion", "call"):
            m = re.search(r"(?:calls|to_apply)=%?([\\w\\.\\-]+)", op.attrs)
            if m:
                walk(m.group(1), scale, loops)
        elif op.op == "conditional":
            m = H._BRANCHES_RE.search(op.attrs)
            for b in (m.group(1).split(",") if m else ()):
                walk(b.strip().lstrip("%"), scale, loops + ("cond",))
        elif op.op == "dot":
            terms[(" / ".join(loops) or "-",) + tuple(
                str(shapes.get(o)) for o in op.operands[:2])] += \\
                H._dot_flops(op, shapes) * scale
if texts:
    walk(comps["__entry_name__"], 1, ())
for key, flops in terms.most_common(int(sys.argv[3])):
    print(f"  {flops:.3e}", *key)
"""


def _run(code: str, arch: str, shape: str, top: int, multi_pod: bool) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", code, arch, shape, str(top),
                          "1" if multi_pod else "0"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=3600)
    if run.returncode:
        raise RuntimeError(f"{arch} {shape}: exit {run.returncode}\n"
                           f"{run.stderr[-2000:]}")
    return run.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    print(_run(_PORT, args.arch, args.shape, args.top, args.multi_pod),
          end="", flush=True)
    if not args.port_only:
        print(_run(_REFERENCE, args.arch, args.shape, args.top,
                   args.multi_pod), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
