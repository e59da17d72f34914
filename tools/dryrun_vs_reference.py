"""The port's dry-run cells beside the reference's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_vs_reference.py \
        [--cells stablelm-1.6b:decode_32k,...] [--multi-pod] \
        [--port-only] [--json OUT]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_vs_reference.py \
        --leaves --cells hubert-xlarge:train_4k [--multi-pod] [--top N]

For each of the 21 single-pod cells (``CELLS``: every architecture's
``train_4k`` and ``decode_32k`` and the ``long_500k`` cells), or with
``--multi-pod`` the ten multi-pod ``prefill_32k`` cells
(``MULTI_POD_CELLS``), runs the reference's
``repro.launch.dryrun.run_cell`` in a process of its own (that module fakes
512 host devices when it is imported, and ``run_cell`` returns its result
without writing it anywhere) and the port's ``python -m
repro_torch.launch.dryrun`` in another, and prints FLOP, collective bytes
and argument GiB a chip of each, with the port's over the reference's
(the JSON also keeps the reference's collective bytes with each
collective counted once, not scaled by its loop's trip count).
The reference's mesh is its own (16, 16), or (2, 16, 16) with
``--multi-pod``; the port's (32, 8) or (2, 32, 8).

Beside them stands a yardstick that does not depend on either layout: the
reference's FLOPs of the same step compiled for one device (its
``hloparse.analyze`` of ``jax.jit(step)`` without shardings, in a process
of its own) over the cell's chips, each chip's share of the whole step's
work.  A chip that reads below its share leaves work out; above it, it
repeats work that another chip also does (GSPMD's choice in the
reference's counts, a replicated layout in the port's).

``--port-only`` runs the port's cells alone (where JAX is not installed:
the card's machine, whose torch resolves DTensor's layouts its own way).
The last line is a JSON object of every cell; ``--json`` writes it to a
file too.

``--leaves`` lists each side's arguments of the cell's step leaf by leaf
instead (the train state and the batch, or the parameters, the batch and
the cache): the leaf's path, its local shape on a chip, its dtype and
bytes, each side in a process of its own (the port: the DTensors
``launch.dryrun`` builds, its step not run; the reference: each
``ShapeDtypeStruct``'s ``NamedSharding.shard_shape`` under the shardings
its ``run_cell`` compiles with); then every leaf of either side, largest
difference first, with both sides' bytes, the leaves one side lacks, and
the totals (the reference's against its ``memory_analysis``).
This script imports neither package itself.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: The 21 single-pod cells that run: every arch's train_4k and
#: decode_32k (hubert-xlarge has no decode) and the long_500k cells.
CELLS = tuple((arch, shape) for arch in (
    "stablelm-1.6b", "starcoder2-3b", "mistral-large-123b", "stablelm-3b",
    "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b", "qwen2-vl-72b",
    "rwkv6-1.6b", "hubert-xlarge") for shape in (
    "train_4k", "decode_32k", "long_500k") if not (
    (arch == "hubert-xlarge" and shape != "train_4k") or
    (shape == "long_500k" and arch not in ("zamba2-2.7b", "rwkv6-1.6b"))))

#: The ten multi-pod cells, ``--multi-pod``'s default: every arch's
#: ``prefill_32k``, whose batch of 32 does not divide the port's 64 data
#: ranks (each sequence splits in halves over ``pod``) and does divide
#: the reference's 32.
MULTI_POD_CELLS = tuple((arch, "prefill_32k") for arch, shape in CELLS
                        if shape == "train_4k")

#: What each side reports, by the result's keys.
FIELDS = ("flops_per_chip", "collective_bytes", "argument_gib")

_REFERENCE = """
import dataclasses, json, sys
from repro.launch import dryrun
res = dryrun.run_cell(sys.argv[1], sys.argv[2], multi_pod=sys.argv[3] == "1")
print(json.dumps(dataclasses.asdict(res)))
"""


_WHOLE = """
import json, sys
import jax
from repro.launch import dryrun     # fakes 512 host devices on import
from repro.configs import get_config, get_shape
from repro.core import hloparse
from repro.distributed.step import (TrainStepConfig, make_serve_step,
                                    make_train_step, train_state_specs)
from repro.models.model import Model, batch_spec, decode_batch_spec
cfg, shape = get_config(sys.argv[1]), get_shape(sys.argv[2])
model = Model(cfg)
if shape.kind in ("train", "prefill"):
    step_cfg = TrainStepConfig()
    fn = make_train_step(model, step_cfg)
    args = (train_state_specs(model, step_cfg),
            batch_spec(cfg, shape.global_batch, shape.seq_len))
else:
    fn = make_serve_step(model)
    args = (jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0))),
            decode_batch_spec(cfg, shape.global_batch),
            jax.eval_shape(lambda: model.make_cache(shape.global_batch,
                                                    shape.seq_len)))
text = jax.jit(fn).lower(*args).compile().as_text()
print(json.dumps({"flops": hloparse.analyze(text).flops}))
"""


#: Each side's argument leaves: (path, local shape, dtype, bytes) a chip.
_PORT_LEAVES = """
import json, sys
import torch
from torch.distributed.tensor import DTensor
from repro_torch.core import hloparse
from repro_torch.launch import dryrun
leaves, names = [], []
def walk(tree, path):
    if isinstance(tree, dict):
        for k, v in tree.items():
            walk(v, path + (str(k),))
    elif torch.is_tensor(tree):
        x = tree.to_local() if isinstance(tree, DTensor) else tree
        leaves.append(["/".join(path), list(x.shape),
                       str(x.dtype).replace("torch.", ""),
                       x.numel() * x.element_size()])
class Stop(Exception):
    pass
local_bytes, depth = dryrun._local_bytes, [0]
def record(tree):
    # run_step's sum over the step's arguments: each top-level call.
    if depth[0] == 0:
        names.append(tree)
    depth[0] += 1
    try:
        return local_bytes(tree)
    finally:
        depth[0] -= 1
def stop(self):
    # The step's arguments are built (run_step sums their bytes just
    # before it opens the meter): list them and run no step.
    raise Stop()
dryrun._local_bytes, hloparse.Meter.__enter__ = record, stop
res = dryrun.run_cell(sys.argv[1], sys.argv[2], multi_pod=sys.argv[3] == "1")
top = ("state", "batch") if len(names) == 2 else ("params", "batch", "cache")
for name, tree in zip(top, names):
    walk(tree, (name,))
print(json.dumps({"leaves": leaves}))
"""

_REFERENCE_LEAVES = """
import json, sys
import jax
from repro.launch import dryrun     # fakes 512 host devices on import
from repro.configs import get_config, get_shape
from repro.distributed import sharding as shd
from repro.distributed.step import TrainStepConfig, train_state_specs
from repro.launch.mesh import make_production_mesh
from repro.models.model import Model, batch_spec, decode_batch_spec
arch, shape_name, multi = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
cfg, shape = get_config(arch), get_shape(shape_name)
mesh = make_production_mesh(multi_pod=multi)
model = Model(cfg)
# The shardings run_cell compiles the step with.
if shape.kind in ("train", "prefill"):
    rules = shd.train_rules(mesh, cfg)
    state = train_state_specs(model, TrainStepConfig())
    p_sh = shd.param_shardings(model, mesh, rules)
    state_sh = dict(params=p_sh, opt=dict(master=p_sh, mu=p_sh, nu=p_sh),
                    step=shd.replicated(mesh, state["step"]))
    batch = batch_spec(cfg, shape.global_batch, shape.seq_len)
    args = dict(state=(state, state_sh),
                batch=(batch, shd.batch_shardings(mesh, batch)))
else:
    rules = shd.decode_rules(mesh, cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    batch = decode_batch_spec(cfg, shape.global_batch)
    cache = jax.eval_shape(
        lambda: model.make_cache(shape.global_batch, shape.seq_len))
    args = dict(params=(params, shd.param_shardings(model, mesh, rules)),
                batch=(batch, shd.batch_shardings(mesh, batch)),
                cache=(cache, shd.cache_shardings(cfg, mesh, cache)))
leaves = []
for name, (tree, shardings) in args.items():
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    sh = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(
        x, jax.sharding.Sharding))
    for (path, leaf), s in zip(flat, sh):
        local = s.shard_shape(leaf.shape)
        n = 1
        for d in local:
            n *= d
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        leaves.append(["/".join([name] + keys), list(local),
                       str(leaf.dtype), n * leaf.dtype.itemsize])
res = dryrun.run_cell(arch, shape_name, multi_pod=multi)
print(json.dumps({"leaves": leaves, "memory": res.memory}))
"""


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def _summary(res: dict) -> dict:
    """A cell's status and the three numbers a chip."""
    out = {"status": res["status"], "seconds": res.get("seconds", 0.0)}
    if res["status"] == "ok":
        out.update(flops_per_chip=res["flops_per_chip"],
                   collective_bytes=res["collectives"]["total"],
                   argument_gib=res["memory"]["argument_bytes"] / 2**30)
        unscaled = res["collectives"].get("unscaled")
        if unscaled:
            # The reference's collectives each counted once, not scaled
            # by the trip counts of the loops they sit in.
            out["collective_bytes_unscaled"] = unscaled["total"]
    elif res.get("error"):
        out["error"] = res["error"].splitlines()[0][:200]
    return out


def reference_cell(arch: str, shape: str, multi_pod: bool = False,
                   timeout: float = 3600) -> dict:
    """The reference's ``run_cell`` in a process of its own."""
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE, arch, shape,
         "1" if multi_pod else "0"], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=timeout)
    if run.returncode:
        raise RuntimeError(f"reference {arch} {shape}: exit "
                           f"{run.returncode}\n{run.stderr[-2000:]}")
    return _summary(json.loads(run.stdout.strip().splitlines()[-1]))


def reference_whole(arch: str, shape: str, timeout: float = 3600) -> float:
    """The reference's FLOPs of the cell's whole step compiled for one
    device, in a process of its own."""
    run = subprocess.run([sys.executable, "-c", _WHOLE, arch, shape],
                         capture_output=True, text=True, env=_env(),
                         cwd=ROOT, timeout=timeout)
    if run.returncode:
        raise RuntimeError(f"reference whole step {arch} {shape}: exit "
                           f"{run.returncode}\n{run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])["flops"]


def port_cell(arch: str, shape: str, multi_pod: bool = False,
              timeout: float = 3600) -> dict:
    """The port's dry-run CLI for one cell in a process of its own."""
    with tempfile.TemporaryDirectory() as out:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--out", out]
        run = subprocess.run(argv + (["--multi-pod"] if multi_pod else []),
                             capture_output=True, text=True, env=_env(),
                             cwd=ROOT, timeout=timeout)
        found = list(Path(out).glob("*.json"))
        if not found:
            raise RuntimeError(f"port {arch} {shape}: exit "
                               f"{run.returncode}\n{run.stderr[-2000:]}")
        return _summary(json.loads(found[0].read_text()))


def _leaves(code: str, arch: str, shape: str, multi_pod: bool,
            timeout: float = 3600) -> dict:
    run = subprocess.run([sys.executable, "-c", code, arch, shape,
                          "1" if multi_pod else "0"], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=timeout)
    if run.returncode:
        raise RuntimeError(f"{arch} {shape}: exit {run.returncode}\n"
                           f"{run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def leaves(arch: str, shape: str, multi_pod: bool, top: int) -> dict:
    """Both sides' argument leaves of one cell, printed side by side."""
    port = _leaves(_PORT_LEAVES, arch, shape, multi_pod)
    ref = _leaves(_REFERENCE_LEAVES, arch, shape, multi_pod)
    pl = {row[0]: row for row in port["leaves"]}
    rl = {row[0]: row for row in ref["leaves"]}
    total_p = sum(row[3] for row in pl.values())
    total_r = sum(row[3] for row in rl.values())
    print(f"{arch} {shape}: argument bytes a chip, port {total_p} "
          f"({total_p / 2**30:.4g} GiB) / reference {total_r} "
          f"({total_r / 2**30:.4g} GiB; memory_analysis "
          f"{ref['memory'].get('argument_bytes')})")
    for path in sorted(set(pl) | set(rl), key=lambda k: -abs(
            pl.get(k, [0] * 4)[3] - rl.get(k, [0] * 4)[3]))[:top]:
        p, r = pl.get(path), rl.get(path)
        side = lambda row: ("-" if row is None else
                            f"{tuple(row[1])} {row[2]} {row[3]}")
        print(f"  {path}: port {side(p)} | reference {side(r)}")
    return {"arch": arch, "shape": shape, "port": port["leaves"],
            "reference": ref["leaves"], "reference_memory": ref["memory"]}


def _fmt(cell: dict, key: str) -> str:
    return f"{cell[key]:.4g}" if key in cell else cell["status"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=None,
                    help="arch:shape,... (default: CELLS)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--leaves", action="store_true",
                    help="list both sides' argument leaves instead")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    cells = (MULTI_POD_CELLS if args.multi_pod else CELLS) \
        if args.cells is None else tuple(
            tuple(c.split(":")) for c in args.cells.split(","))
    if args.leaves:
        out = [leaves(arch, shape, args.multi_pod, args.top)
               for arch, shape in cells]
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(out, indent=1))
        return 0
    chips = 512 if args.multi_pod else 256
    rows = []
    for arch, shape in cells:
        row = {"arch": arch, "shape": shape,
               "port": port_cell(arch, shape, args.multi_pod)}
        if not args.port_only:
            row["reference"] = reference_cell(arch, shape, args.multi_pod)
            row["whole_step_flops"] = reference_whole(arch, shape)
            row["share"] = row["whole_step_flops"] / chips
        port, ref = row["port"], row.get("reference", {})
        text = [f"{arch:20s} {shape:11s}"]
        for key in FIELDS:
            line = f"{key} {_fmt(port, key)}"
            if key in port and key in ref:
                row[f"{key}_ratio"] = port[key] / ref[key] if ref[key] else None
                line += (f" / ref {_fmt(ref, key)} = "
                         f"{row[f'{key}_ratio']:.3f}" if ref[key] else
                         f" / ref {_fmt(ref, key)}")
            elif ref:
                line += f" / ref {_fmt(ref, key)}"
            text.append(line)
        if "share" in row:
            line = f"share {row['share']:.4g}"
            for side, cell in (("port", port), ("ref", ref)):
                if "flops_per_chip" in cell:
                    row[f"{side}_share_ratio"] = \
                        cell["flops_per_chip"] / row["share"]
                    line += f" {side} {row[f'{side}_share_ratio']:.3f}"
            text.append(line)
        print("  ".join(text), flush=True)
        rows.append(row)
    out = {"multi_pod": args.multi_pod, "cells": rows}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 1 if any(r["port"]["status"] == "error" for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
