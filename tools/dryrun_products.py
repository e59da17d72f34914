"""The products and collectives behind dry-run cells, port and reference.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_products.py \
        ARCH SHAPE [--top N] [--port-only] [--multi-pod] [--collectives]
    PYTHONPATH=src python tools/dryrun_products.py --all DIR [--jobs N] \
        [--sites]
    python tools/dryrun_products.py --diff DIR_A DIR_B [--top N]

Lists the largest terms of one cell's FLOPs a chip, each side in a
process of its own, largest first:
  * the port: ``repro_torch.launch.dryrun.run_cell`` with the cost
    meter's products (``core/hloparse``: mm, bmm, ...) summed by op and
    operand shapes, and the hand kernels' stand-in charges by the
    function that charged them; with ``--collectives`` also the meter's
    collectives summed by kind, op, received shape and dtype;
  * the reference: the compiled HLO of ``repro.launch.dryrun.run_cell``'s
    cell, its dots summed by the loops around them (each ``while``'s trip
    count, as ``repro.core.hloparse.analyze`` scales it) and by operand
    shapes.
A term's shapes are a rank's local ones, so they show how each side
splits the work.  ``--port-only`` runs the port's side alone (where JAX
is not installed); ``--multi-pod`` takes the cell on the multi-pod mesh.

``--all DIR`` writes every term of the port's 31 cells that
``tools/dryrun_vs_reference.py`` holds (its ``CELLS`` on (32, 8) and
``MULTI_POD_CELLS`` on (2, 32, 8)), none dropped, ``--jobs`` processes at
a time, one ``DIR/<arch>__<shape>__<mesh>.json`` a cell with the torch
version that ran it; with ``--sites`` each term also by the site that
issued it: the innermost frame of the port's ``models``, ``kernels`` or
``distributed`` package, and for an op of the backward pass (``bwd``)
the frame that made its autograd node in the forward (autograd's anomaly
mode records it, at some cost in host time).  ``--diff`` reads two such directories (say torch
2.11's and 2.13's) and prints, cell by cell, FLOPs and collective bytes
a chip of each with their ratio, and the terms (summed over their
sites) whose sums differ.
This script imports neither package itself.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PORT = """
import collections, json, re, sys, traceback
import torch
from repro_torch.core import hloparse as H
from repro_torch.launch import dryrun
arch, shape, top, multi, out = sys.argv[1:6]
sites = "sites" in sys.argv[6:]
if sites:
    torch.autograd.set_detect_anomaly(True, check_nan=False)
FRAME = re.compile(r'File "([^"]*)", line (\\d+), in (\\S+)')
def site_of(frames):
    # The innermost frame of the port's models or kernels, else of its
    # distributed layer.
    best = {}
    for path, line, fn in frames:
        path = path.replace("\\\\", "/")
        rel = path.split("/repro_torch/", 1)[-1] if "/repro_torch/" in path \\
            else ""
        for pkg in ("models/", "kernels/", "distributed/"):
            if rel.startswith(pkg):
                best["distributed/" if pkg == "distributed/" else "model"] = \\
                    f"{rel}:{line} {fn}"
    return best.get("model") or best.get("distributed/") or "-"
def site():
    if not sites:
        return ""
    node = torch._C._current_autograd_node()
    if node is not None:
        tb = node.metadata.get("traceback_") or []
        frames = FRAME.findall("".join(tb))
        return "bwd " + site_of([(p, int(l), f) for p, l, f in frames])
    return site_of([(f.filename, f.lineno, f.name)
                    for f in traceback.extract_stack()])
products, colls = collections.Counter(), collections.Counter()
calls = collections.Counter()
count, charge = H.Meter._count, H.charge
def counted(self, name, func, args, out):
    if name in H._DOTS:
        i = 1 if name in ("aten.addmm", "aten.baddbmm") else 0
        key = (name, str(tuple(args[i].shape)), str(tuple(args[i + 1].shape)),
               site())
        products[key] += H._dot_flops(
            name, args, out if name != "aten.convolution_backward" else None)
        calls[("p",) + key] += 1
    rule = H._COLLECTIVE_OPS.get(name)
    if rule is not None:
        got = out if rule[1] == "result" else args[0]
        t = next(H._tensors(got), None)
        key = (rule[0], name, str(tuple(t.shape)) if t is not None else "-",
               str(t.dtype).replace("torch.", "") if t is not None else "-",
               site())
        colls[key] += H._nbytes(got)
        calls[("c",) + key] += 1
    return count(self, name, func, args, out)
def charged(flops, nbytes):
    key = ("charge", traceback.extract_stack(limit=3)[0].name, "", site())
    products[key] += flops
    calls[("p",) + key] += 1
    return charge(flops, nbytes)
H.Meter._count, H.charge = counted, charged
res = dryrun.run_cell(arch, shape, multi_pod=multi == "1")
print(f"port {res.status} {res.flops_per_chip:.4e} FLOP a chip, "
      f"{res.collectives.get('total', 0):.4e} collective B a chip, torch "
      f"{torch.__version__} {res.error[:300]}")
def merged(counter, n):
    # Summed over sites: the terms by op and shapes.
    agg = collections.Counter()
    for key, v in counter.items():
        agg[key[:n]] += v
    return agg.most_common(int(top))
for key, flops in merged(products, 3):
    print(f"  {flops:.3e}", *key)
if "collectives" in sys.argv[6:]:
    print("collectives (bytes received a chip):")
    for key, nbytes in merged(colls, 4):
        print(f"  {nbytes:.3e}", *key)
if out != "-":
    record = dict(arch=arch, shape=shape, mesh=res.mesh,
                  torch=torch.__version__, status=res.status,
                  error=res.error, seconds=res.seconds,
                  flops_per_chip=res.flops_per_chip,
                  collectives=res.collectives, memory=res.memory,
                  products=[list(k) + [v, calls[("p",) + k]]
                            for k, v in products.items()],
                  collective_terms=[list(k) + [v, calls[("c",) + k]]
                                    for k, v in colls.items()])
    with open(out, "w") as f:
        json.dump(record, f, indent=0)
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


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def _run(code: str, arch: str, shape: str, top: int, multi_pod: bool,
         out: str = "-", collectives: bool = False,
         sites: bool = False) -> str:
    argv = [sys.executable, "-c", code, arch, shape, str(top),
            "1" if multi_pod else "0"]
    if code is _PORT:
        argv += [out] + (["collectives"] if collectives else []) + (
            ["sites"] if sites else [])
    run = subprocess.run(argv, capture_output=True, text=True, env=_env(),
                         cwd=ROOT, timeout=3600)
    if run.returncode:
        raise RuntimeError(f"{arch} {shape}: exit {run.returncode}\n"
                           f"{run.stderr[-2000:]}")
    return run.stdout


def all_cells() -> list:
    """(arch, shape, multi-pod) of the 31 cells of
    ``tools/dryrun_vs_reference.py``."""
    sys.path.insert(0, str(ROOT / "tools"))
    import dryrun_vs_reference as vs
    return [(a, s, False) for a, s in vs.CELLS] + \
        [(a, s, True) for a, s in vs.MULTI_POD_CELLS]


def cell_file(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'2x32x8' if multi_pod else '32x8'}.json"


def run_all(out_dir: str, jobs: int, sites: bool = False) -> int:
    """Every cell's terms into ``out_dir``, ``jobs`` processes at once."""
    Path(out_dir).mkdir(parents=True, exist_ok=True)

    def one(cell):
        arch, shape, multi = cell
        path = str(Path(out_dir) / cell_file(*cell))
        try:
            head = _run(_PORT, arch, shape, 0, multi, path,
                        sites=sites).splitlines()[0]
        except Exception as e:          # noqa: BLE001 -- report every cell
            head = f"failed: {str(e)[-600:]}"
        print(f"{arch:22s} {shape:12s} {'2x32x8' if multi else '32x8':7s} "
              f"{head}", flush=True)
        return head.startswith("port ok")

    with ThreadPoolExecutor(jobs) as pool:
        ok = list(pool.map(one, all_cells()))
    return 0 if all(ok) else 1


def _terms(rec: dict, kind: str) -> collections.Counter:
    """A cell's terms summed over their sites, without their call counts:
    products by (op, shapes), collectives by (kind, op, shape, dtype)."""
    out = collections.Counter()
    for row in rec[kind]:
        *key, _, value, _ = row
        out[tuple(key)] += value
    return out


def diff(dir_a: str, dir_b: str, top: int) -> int:
    """Cell by cell, ``dir_a``'s FLOPs and collective bytes a chip over
    ``dir_b``'s, and the terms that differ (largest difference first)."""
    for path in sorted(Path(dir_a).glob("*.json")):
        other = Path(dir_b) / path.name
        if not other.exists():
            continue
        a, b = json.loads(path.read_text()), json.loads(other.read_text())
        if a["status"] != "ok" or b["status"] != "ok":
            print(f"{path.stem}: {a['status']} / {b['status']}")
            continue
        ca, cb = a["collectives"]["total"], b["collectives"]["total"]
        print(f"{path.stem}: torch {a['torch']} / {b['torch']}: FLOP "
              f"{a['flops_per_chip']:.4e} / {b['flops_per_chip']:.4e} = "
              f"{a['flops_per_chip'] / max(b['flops_per_chip'], 1):.4f}; "
              f"collective B {ca:.4e} / {cb:.4e} = {ca / max(cb, 1):.3f}")
        for kind in ("products", "collective_terms"):
            ta, tb = _terms(a, kind), _terms(b, kind)
            gap = {k: ta.get(k, 0) - tb.get(k, 0) for k in set(ta) | set(tb)}
            gap = sorted(((v, k) for k, v in gap.items() if v),
                         key=lambda vk: -abs(vk[0]))
            for v, key in gap[:top]:
                print(f"    {kind[0]} {v:+.3e} ({ta.get(key, 0):.3e} / "
                      f"{tb.get(key, 0):.3e})", *key)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?")
    ap.add_argument("shape", nargs="?")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--collectives", action="store_true",
                    help="also list the port's collectives")
    ap.add_argument("--sites", action="store_true",
                    help="with --all, key each term by its site too "
                    "(autograd's anomaly mode: slower)")
    ap.add_argument("--all", default=None, metavar="DIR",
                    help="every cell's terms into DIR (port only)")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--diff", nargs=2, default=None, metavar="DIR")
    args = ap.parse_args(argv)
    if args.diff:
        return diff(*args.diff, args.top)
    if args.all:
        return run_all(args.all, args.jobs, args.sites)
    if not args.arch or not args.shape:
        ap.error("ARCH and SHAPE required unless --all or --diff")
    print(_run(_PORT, args.arch, args.shape, args.top, args.multi_pod,
               collectives=args.collectives), end="", flush=True)
    if not args.port_only:
        print(_run(_REFERENCE, args.arch, args.shape, args.top,
                   args.multi_pod), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
