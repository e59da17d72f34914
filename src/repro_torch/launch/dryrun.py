"""Multi-pod dry run: every (arch x shape x mesh) cell on a fake world.

Port of ``repro/launch/dryrun.py``.  The reference fakes 512 host
devices, lowers and compiles each cell's step under the sharding rules
and reads the compiled HLO.  The port has no compiler to ask, so it runs
the step itself, eagerly, in a world that costs nothing:

  1. a ``"fake"`` process group of 256 or 512 ranks in this one process
     (``torch.testing._internal.distributed.fake_pg``: every collective
     returns at once), and the production mesh over it
     (``launch/mesh.make_production_mesh``: (32, 8) or (2, 32, 8)), a
     CUDA mesh as in production, so that DTensor issues the collectives it
     would issue there (on a CPU mesh it trades each all-to-all for an
     all-gather, which gloo lacks); no card is touched.  The multi-pod
     mesh runs with its ``pod`` and ``data`` axes folded into one
     (:func:`fold_pod`);
  2. the parameters, the optimizer state, the batch and the cache are
     DTensors laid out by the rules (``distributed/sharding``), each built
     from this rank's local shard on the ``meta`` device (shapes and
     dtypes, no storage), so every tensor the step makes from them is a
     meta tensor too.  (Under ``FakeTensorMode`` DTensor's own bookkeeping
     -- the small host tensors it reads shard offsets from -- turns fake
     and fails; meta shards keep it on the host.);
  3. one train step (``train`` and ``prefill`` shapes) or one serve step
     (``decode``: one token against a full ``seq_len`` cache) runs under
     the activation rules (``distributed/context``) and the cost meter
     (``core/hloparse.Meter``): the model runs on each rank's local
     shards with the port's own splits and collectives
     (``distributed/context``), and a layout it cannot split fails HERE,
     which is the point.  The hand kernels take the path they take on the
     card: each runs on its local shard (``kernels/ops``), as a meta
     stand-in that charges the kernel's work;
  4. the cell's :class:`CellResult` goes to ``<out>/<cell>.json``
     (``--out``, default ``dryrun_out/`` at the repository's root, which
     git ignores).

A train or prefill cell whose global batch does not divide the data
ranks (the multi-pod ``prefill_32k`` cells: 32 sequences on (2 x 32)
data ranks, where the reference's (2 x 16) divide them) splits each
sequence in halves over ``pod`` (``sharding.sequence_parts``,
``split_sequences``): rank p x 32 + d holds half p of sequence d, and
the blocks exchange what crosses the halves' edge over the pod group
(the ``seq_pair`` rule, ``distributed/layout.SeqPair``), so each chip
does 1/512 of the step; a batch that splits neither way raises.  Rank 0
runs half 0; half 1 issues the same products and collectives.

The decode cache is laid out as the reference's default: batch over the
data axes and the sequence over ``model``, the channelized cache
(``cache_shardings(kv_channels=True)``): each ``model`` rank holds and
reads 1/8 of the context, K2's partial build runs on its slice (its
stand-in here), and two small all-reduces over ``model`` merge the
ranks' (max, sum, acc) (``kernels/ops.decode_attn``).
``--no-kv-channels`` lays the whole sequence on every ``model`` rank
instead, as the reference's flag of that name does.  The reference's
``--fsdp-gather`` has no counterpart: the port always gathers a layer's
weights at use (``distributed/context``); nor does its
``--kv-select-update``: each rank always writes the new K/V rows into its
own slice of the cache; nor does its ``--act-shard seq`` (the residual
stream's sequence over ``model``), which the local layer does not build.
The layouts and collectives are the port's own, so the counts do not depend
on the torch version.

Costs are per rank (rank 0's local shards).  Of the reference's fields,
``xla_flops`` and ``xla_bytes`` (XLA's ``cost_analysis``) and the
``output``/``temp``/``alias`` bytes of ``memory_analysis`` have no eager
counterpart and are dropped; ``memory`` holds the argument bytes (the
local shards of everything the step is given) and the output bytes (of
everything it returns).  ``collectives`` holds the meter's bytes by
collective and their total.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k \\
      [--multi-pod] [--no-kv-channels] [--remat dots]
  python -m repro_torch.launch.dryrun --all [--multi-pod]   # every cell
  python -m repro_torch.launch.dryrun --collective-proof [--multi-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCHS, SHAPES, cell_status, get_config, \
    get_shape
from repro_torch.core import hloparse
from repro_torch.distributed import context, layout
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.step import (TrainStepConfig, make_serve_step,
                                          make_train_step, train_state_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import Model, batch_spec, decode_batch_spec
from repro_torch.models.transformer import init_cache

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "dryrun_out")


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake world of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def fold_pod(mesh):
    """The mesh the step runs on: a multi-pod mesh's ``pod`` and ``data``
    axes folded into one ``data`` axis over the same ranks in the same
    order (pod major), which is what sharding a dimension over
    ("pod", "data") does: each collective over the data ranks is then one
    call over one group."""
    if "pod" not in mesh.mesh_dim_names:
        return mesh
    sizes = shd.axis_sizes(mesh)
    return init_device_mesh(mesh.device_type,
                            (sizes["pod"] * sizes["data"], sizes["model"]),
                            mesh_dim_names=("data", "model"))


def sharded_empty(shape, dtype, sharding) -> DTensor:
    """A DTensor of global ``shape`` laid out by ``sharding``, built from
    this rank's local shard alone, on the ``meta`` device."""
    mesh, placements = sharding.mesh, sharding.placements
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            # The rules shard only dimensions that divide (spec_for).
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=dtype,
                                          device="meta"), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _place(tree, shardings):
    """A tree of meta tensors -> sharded empty DTensors; a ``None``
    sharding keeps the leaf (the cache's host-int length)."""
    return L.map_tree(lambda t, sh: t if sh is None else
                      sharded_empty(t.shape, t.dtype, sh), tree, shardings)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors of ``tree``."""
    if isinstance(tree, dict):
        return sum(_local_bytes(sub) for sub in tree.values())
    if not torch.is_tensor(tree):
        return 0                        # the cache's host-int length
    x = tree.to_local() if isinstance(tree, DTensor) else tree
    return x.numel() * x.element_size()


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str
    seconds: float = 0.0
    flops_per_chip: float = 0.0       # from the meter, per rank
    bytes_per_chip: float = 0.0       # op-boundary proxy
    hbm_bytes_per_chip: float = 0.0   # fused-boundary proxy
    collectives: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)
    chips: int = 0
    error: str = ""
    variant: str = "baseline"
    seq_parts: int = 1                # parts of each sequence over pod

    def to_json(self):
        return dataclasses.asdict(self)


def _train_cell(model, mesh, shape, compress_grads, microbatch,
                full_mesh=None, parts=1):
    """The train step and its arguments on the step's ``mesh``; with
    ``parts`` > 1 the batch's rows are the parts of its sequences over
    ``full_mesh``'s ``pod`` axis (``sharding.split_sequences``)."""
    cfg = model.cfg
    if parts > 1 and microbatch > 1:
        raise ValueError("microbatches of a batch of split sequences")
    rules = shd.train_rules(mesh, cfg)
    step_cfg = TrainStepConfig(compress_grads=compress_grads,
                               microbatch=microbatch)
    specs = train_state_specs(model, step_cfg)
    p_sh = shd.param_shardings(model, mesh, rules)
    state_sh = dict(params=p_sh, opt=dict(master=p_sh, mu=p_sh, nu=p_sh),
                    step=None)
    if compress_grads:
        state_sh["ef"] = p_sh
    state = _place(specs, state_sh)
    state["step"] = torch.zeros((), dtype=torch.int32)
    batch = batch_spec(cfg, shape.global_batch, shape.seq_len)
    if parts > 1:
        batch = shd.split_sequences(full_mesh, batch, parts)
    batch = _place(batch, shd.batch_shardings(mesh, batch))
    return make_train_step(model, step_cfg), (state, batch)


def _decode_cell(model, mesh, shape, kv_channels):
    cfg = model.cfg
    p_sh = shd.param_shardings(model, mesh, shd.decode_rules(mesh, cfg))
    params = _place(L.map_tree(
        lambda s: torch.empty(s.shape, dtype=model.dtype, device="meta"),
        model.specs()), p_sh)
    batch = decode_batch_spec(cfg, shape.global_batch)
    batch = _place(batch, shd.batch_shardings(mesh, batch))
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, model.dtype,
                       "meta")
    cache = _place(cache, shd.cache_shardings(cfg, mesh, cache,
                                              kv_channels=kv_channels))
    # One new token against a full context: the step writes the last slot
    # and attends over every key.
    cache["len"] = shape.seq_len - 1
    return make_serve_step(model), (params, batch, cache)


def run_step(cfg, shape, mesh, res: CellResult, *, kv_channels=True,
             compress_grads=False, microbatch=1) -> CellResult:
    """One cell's step on ``mesh`` (a mesh of the current world, its
    ``pod`` axis folded for the step: :func:`fold_pod`) under the meter,
    its costs written into ``res``.  ``kv_channels`` lays a decode cache's
    sequence over ``model`` (module note).

    A train or prefill step whose batch does not divide the data ranks
    splits each sequence in halves over ``pod`` (``sharding.sequence_parts``;
    it raises where that does not divide either) under a ``seq_pair``
    rule, and runs as this rank's half (rank 0's: half 0).  Both halves
    issue the same products and collectives (``layout.SeqPair``), so
    either's counts are the cell's."""
    step_mesh = fold_pod(mesh)
    parts = shd.sequence_parts(mesh, shape.global_batch, shape.seq_len) \
        if shape.kind in ("train", "prefill") else 1
    act_rules = {"batch": shd.fsdp_axes(step_mesh)}
    model = Model(cfg, device="cpu")
    if parts > 1:
        act_rules["seq_pair"] = layout.SeqPair.over(mesh, "pod")
    if shape.kind in ("train", "prefill"):
        fn, args = _train_cell(model, step_mesh, shape, compress_grads,
                               microbatch, mesh, parts)
    else:
        fn, args = _decode_cell(model, step_mesh, shape, kv_channels)
    arg_bytes = sum(_local_bytes(a) for a in args)
    with context.activation_rules(step_mesh, act_rules), \
            hloparse.Meter() as meter:
        out = fn(*args)
    out_bytes = sum(_local_bytes(o) for o in out)
    cost = meter.cost
    res.seq_parts = parts
    res.flops_per_chip = float(cost.flops)
    res.bytes_per_chip = float(cost.bytes)
    res.hbm_bytes_per_chip = float(cost.bytes_hbm)
    res.collectives = dict(cost.coll, total=cost.coll_total)
    res.memory = dict(argument_bytes=arg_bytes, output_bytes=out_bytes)
    return res


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             remat: str | None = None, variant: str = "baseline",
             **step_kw) -> CellResult:
    """One (arch x shape) cell on the production mesh; ``step_kw`` as
    :func:`run_step`'s.  A cell that fails is recorded ``error``."""
    cfg = get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = get_shape(shape_name)
    mesh_name = "2x32x8" if multi_pod else "32x8"
    status = cell_status(cfg, shape)
    res = CellResult(arch=arch, shape=shape_name, mesh=mesh_name,
                     status=status, variant=variant)
    if status != "ok":
        return res

    t0 = time.time()
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        res.chips = mesh.size()
        run_step(cfg, shape, mesh, res, **step_kw)
    except Exception as e:          # noqa: BLE001 -- record, don't crash --all
        res.status = "error"
        # The message, then the innermost frames of the traceback.
        frames = traceback.format_exc().splitlines()[-24:-1]
        res.error = (f"{type(e).__name__}: {e}"[:1000] + "\n" +
                     "\n".join(frames))[:4000]
    res.seconds = time.time() - t0
    return res


def result_path(res: CellResult, out_dir: str = RESULTS_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{res.arch}__{res.shape}__{res.mesh}__{res.variant}.json"
    return os.path.join(out_dir, name)


#: The collective proof's gradient tree: (name, shape), float32.
PROOF_GRADS = (("wq", (4096, 4096)), ("wi", (4096, 11008)),
               ("head", (4096, 32000)))


def collective_proof(multi_pod: bool = False,
                     out_dir: str = RESULTS_DIR) -> dict:
    """The int8 reducer against the float32 one over the production
    mesh's ``data`` axis, by the meter's collective bytes a rank."""
    from repro_torch.distributed import int8_collectives as i8

    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    out = {}
    grads = {name: torch.empty(shape, device="meta")
             for name, shape in PROOF_GRADS}
    for mode in ("f32", "int8"):
        reducer = i8.make_reducer(mesh, axis="data", int8=(mode == "int8"))
        with hloparse.Meter() as meter:
            reducer(grads)
        cost = meter.cost
        out[mode] = dict(collective_bytes=cost.coll_total,
                         by_op={k: v for k, v in cost.coll.items() if v})
    out["reduction_factor"] = (out["f32"]["collective_bytes"] /
                               max(out["int8"]["collective_bytes"], 1.0))
    # The meter counts an all-reduce's output once, but a ring all-reduce
    # moves ~2x its size (reduce-scatter + all-gather); the int8 path's
    # all-to-all and all-gathers are counted at their wire volume.  So the
    # wire-level reduction is ~2x the metric ratio.
    out["wire_level_factor_estimate"] = 2.0 * out["reduction_factor"]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "int8_proof.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(f"[proof] f32 coll bytes/chip:  {out['f32']['collective_bytes']:.3e}")
    print(f"[proof] int8 coll bytes/chip: {out['int8']['collective_bytes']:.3e}")
    print(f"[proof] reduction: {out['reduction_factor']:.2f}x (metric) / "
          f"~{out['wire_level_factor_estimate']:.0f}x wire-level")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--no-kv-channels", action="store_true",
                    help="keep the decode cache's whole sequence on every "
                    "model rank")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--collective-proof", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory for the cells' JSON")
    args = ap.parse_args(argv)

    try:
        if args.collective_proof:
            collective_proof(multi_pod=args.multi_pod, out_dir=args.out)
            return 0
        if args.all:
            cells = [(arch, shape.name) for arch in ARCHS for shape in SHAPES]
        else:
            if not args.arch or not args.shape:
                ap.error("--arch and --shape required unless --all")
            cells = [(args.arch, args.shape)]

        failures = 0
        for arch, shape in cells:
            res = run_cell(arch, shape, multi_pod=args.multi_pod,
                           remat=args.remat,
                           kv_channels=not args.no_kv_channels,
                           compress_grads=args.compress_grads,
                           microbatch=args.microbatch,
                           variant=args.variant)
            with open(result_path(res, args.out), "w") as f:
                json.dump(res.to_json(), f, indent=2)
            tag = res.status if res.status != "ok" else (
                f"ok  {res.seconds:6.1f}s  "
                f"flops/chip={res.flops_per_chip:.3e} "
                f"coll={res.collectives.get('total', 0):.3e}B "
                f"args={res.memory.get('argument_bytes', 0) / 2**30:.2f}GiB")
            print(f"[dryrun] {arch:22s} {shape:12s} {res.mesh:8s} {tag}",
                  flush=True)
            if res.status == "error":
                failures += 1
                print("         " + res.error.splitlines()[0][:160],
                      flush=True)
        return 1 if failures else 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
