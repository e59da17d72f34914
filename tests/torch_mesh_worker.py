"""A real multi-process world on the CPU for the port's mesh tests (not a
test file: the ``test_torch_*`` files import it).

``run_world(job, world, payload)`` spawns ``world`` processes joined by a
``gloo`` process group, runs ``JOBS[job](rank, payload)`` in each and
returns rank 0's result.  The rendezvous store listens on a port the
kernel picks (port 0), every join has its own timeout, and a rank that
fails or hangs fails the call.  The workers import torch and
``repro_torch`` only; what the reference computes comes in ``payload``
(numpy) from the test process.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 240


def run_world(job: str, world: int, payload: dict):
    """Rank 0's result of ``JOBS[job]`` over a ``world``-rank gloo world."""
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "payload.pkl"), os.path.join(tmp, "out")
        with open(src, "wb") as f:
            pickle.dump(payload, f)
        procs = [ctx.Process(target=_entry, args=(job, rank, world,
                                                  store.port, src, dst))
                 for rank in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(JOIN_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"{job}: ranks exited {codes}")
        with open(dst, "rb") as f:
            return pickle.load(f)


def _entry(job, rank, world, port, src, dst):
    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        with open(src, "rb") as f:
            payload = pickle.load(f)
        out = JOBS[job](rank, payload)
        dist.barrier()
        if rank == 0:
            with open(dst, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Jobs.
# ---------------------------------------------------------------------------

def _full(x):
    from torch.distributed.tensor import DTensor
    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().numpy()


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _host_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(model_axis=2, device_type="cpu")


def model_job(rank, payload):
    """Loss and gradients of each smoke model under ``train_rules`` on a
    (2, 2) mesh, and a served prompt under ``decode_rules`` with a
    channelized cache, all as whole tensors."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.step import (_grads, make_prefill,
                                              make_serve_step)
    from repro_torch.models import Model, smoke_variant
    from repro_torch.models import layers as L

    mesh = _host_mesh()
    out = {}
    whole = _watch_whole_gathers()
    for arch, case in payload["train"].items():
        cfg = smoke_variant(get_config(arch))
        model = Model(cfg, device="cpu")
        whole(cfg)      # forget what earlier gathers of results made whole
        params = shd.distribute(_tensors(case["params"]),
                                shd.param_shardings(model, mesh,
                                                    shd.train_rules(mesh, cfg)))
        for _, p in L.flatten_tree(params, torch.is_tensor):
            p.requires_grad_(True)
        batch = _tensors(case["batch"])
        batch = shd.distribute(batch, shd.batch_shardings(mesh, batch))
        with context.activation_rules(mesh, {"batch": shd.fsdp_axes(mesh)}):
            loss, _ = model.loss(params, batch)
            grads = _grads(loss, params)
        tables = whole(cfg)     # before the gradients are gathered here
        out[arch] = dict(loss=float(_full(loss)),
                         grads=L.map_tree(_full, grads), whole_tables=tables)
    out["serve"] = serve_on(mesh, payload["serve"])
    return out


def serve_on(mesh, serve, **over):
    """A smoke model's prompt and greedy steps under ``decode_rules`` with
    a channelized cache on ``mesh``: the logits of each, whole."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.step import make_prefill, make_serve_step
    from repro_torch.models import Model, smoke_variant

    cfg = smoke_variant(get_config(serve["arch"]), **over)
    model = Model(cfg, device="cpu")
    params = shd.distribute(_tensors(serve["params"]), shd.param_shardings(
        model, mesh, shd.decode_rules(mesh, cfg)))
    cache = model.make_cache(*serve["cache"])
    cache = shd.distribute(cache, shd.cache_shardings(cfg, mesh, cache))
    prompt = _tensors(serve["prompt"])
    rules = {"batch": shd.fsdp_axes(mesh), "kv_select_update": True,
             "kv_partials": True, "kv_seq": "model"}
    logits = []
    with context.activation_rules(mesh, rules):
        lg, cache = make_prefill(model)(
            params, shd.distribute(prompt, shd.batch_shardings(mesh, prompt)),
            cache)
        step = make_serve_step(model)
        for _ in range(serve["steps"]):
            logits.append(_full(lg))
            tok = torch.from_numpy(logits[-1].argmax(-1).astype(np.int32))
            sb = dict(tokens=tok[:, None], positions=torch.full(
                (len(tok), 1), cache["len"], dtype=torch.int32))
            lg, cache = step(params, shd.distribute(
                sb, shd.batch_shardings(mesh, sb)), cache)
        logits.append(_full(lg))
    return dict(logits=logits, placements=str(
        cache["k"].placements if "k" in cache else cache["wkv"].placements),
        ssm_placements=str(cache["ssm_state"].placements)
        if "ssm_state" in cache else None)


@contextlib.contextmanager
def _gathers_of(tail):
    """Inside the block, the local shapes of every DTensor all-gather
    whose input ends in ``tail``."""
    import torch.distributed._functional_collectives as funcol
    names = [n for n in ("all_gather_single", "all_gather_tensor")
             if hasattr(funcol, n)]
    saved = {n: getattr(funcol, n) for n in names}
    seen = []

    def watched(fn):
        def gather(x, *args, **kwargs):
            if tuple(x.shape[-len(tail):]) == tuple(tail):
                seen.append(tuple(x.shape))
            return fn(x, *args, **kwargs)
        return gather
    for n in names:
        setattr(funcol, n, watched(saved[n]))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(funcol, n, fn)


def _every_rank(x):
    """``x`` of every rank, in rank order."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, list(x))
    return got


def _watch_whole_gathers():
    """Record every redistribution (forward or backward) whose target is
    whole on every rank; ``seen(cfg)`` returns, and forgets, those of an
    embedding table's or a loss head's global shape."""
    from torch.distributed.tensor import _redistribute

    targets = []
    inner = _redistribute.redistribute_local_tensor

    def watched(local, current, target, *args, **kwargs):
        if all(p.is_replicate() for p in target.placements):
            targets.append(tuple(target.shape))
        return inner(local, current, target, *args, **kwargs)
    _redistribute.redistribute_local_tensor = watched

    def seen(cfg):
        tables = {(cfg.vocab, cfg.d_model), (cfg.d_model, cfg.vocab)}
        found = [t for t in targets if t in tables]
        targets.clear()
        return found
    return seen


def kernel_job(rank, payload):
    """The hand kernels' DTensor dispatch (``ops._per_shard``) with their
    plain versions standing in for the kernels, and the plain paths'
    DTensor propagation (a sequence-sharded cache included)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops, ref

    mesh = _host_mesh()
    q, k, v = (torch.from_numpy(payload[n]) for n in ("q", "k", "v"))
    length = payload["length"]
    dt = lambda x, *pl: distribute_tensor(x, mesh, pl)
    out = {}
    # Batch over data, heads over model: the kernel runs on local shards.
    got = ops._per_shard(
        lambda q, k, v: ref.decode_attn_ref(q, k, v, length), "k",
        {"q": (dt(q, Replicate(), Replicate()), {"batch": 0, "head": 1}),
         "k": (dt(k, Shard(0), Shard(2)), {"batch": 0, "whole": 1,
                                           "head": 2}),
         "v": (dt(v, Shard(0), Shard(2)), {"batch": 0, "whole": 1,
                                           "head": 2})},
        ({"batch": 0, "head": 1},), "decode_attn")
    out["per_shard"] = (_full(got), str(got.placements))
    # The cache's sequence over model (8 keys a rank): each rank's partials
    # of its own keys, merged over model.  At length 5 rank 1's slice lies
    # wholly past the valid prefix.
    calls = []
    partials_ref = ref.decode_attn_partials_ref
    ref.decode_attn_partials_ref = lambda *a: calls.append(a[3]) or \
        partials_ref(*a)
    try:
        seq = {}
        for n in (length, 5):
            calls.clear()
            got = ops.decode_attn(dt(q, Shard(0), Replicate()),
                                  dt(k, Shard(0), Shard(1)),
                                  dt(v, Shard(0), Shard(1)), n)
            seq[n] = (_full(got), str(got.placements), _every_rank(calls))
        out["seq_partials"] = seq
        # The same cache through _per_shard's "seq" role directly, with a
        # rank's partials and merge spelled out.
        cache = {"batch": 0, "seq": 1, "head": 2}
        calls.clear()
        got = ops._per_shard(
            None, "k",
            {"q": (dt(q, Shard(0), Replicate()), {"batch": 0, "head": 1}),
             "k": (dt(k, Shard(0), Shard(1)), cache),
             "v": (dt(v, Shard(0), Shard(1)), cache)},
            ({"batch": 0, "head": 1},), "decode_attn",
            partials=lambda offset, reduce, q, k, v: ops.merge_partials(
                *ref.decode_attn_partials_ref(
                    q, k, v, min(max(5 - offset, 0), k.shape[1])), q.dtype,
                lambda x: reduce(x, "max"), lambda x: reduce(x, "sum")))
        out["seq_per_shard"] = (_full(got), _every_rank(calls))
    finally:
        ref.decode_attn_partials_ref = partials_ref
    # The plain decode on CPU DTensors whose cache is split over model:
    # the same partial route.
    got = ops.decode_attn(dt(q, Shard(0), Replicate()),
                          dt(k, Shard(0), Shard(1)),
                          dt(v, Shard(0), Shard(1)), length)
    out["channelized"] = _full(got)
    r, kk, vv, w = (torch.from_numpy(payload[n]) for n in
                    ("r", "wk", "wv", "w"))
    u, s0 = torch.from_numpy(payload["u"]), torch.from_numpy(payload["s0"])
    seq = (Shard(0), Shard(2))
    y, s = ops.wkv(dt(r, *seq), dt(kk, *seq), dt(vv, *seq), dt(w, *seq),
                   dt(u, Replicate(), Shard(0)), dt(s0, Shard(0), Shard(1)))
    out["wkv"] = (_full(y), _full(s))
    return out


def int8_job(rank, payload):
    """Gradient trees reduced over ``data`` of a (4, 1) mesh by the int8
    and the float32 reducer, under the cost meter: the same tree on every
    rank ("same") and each rank its own ("distinct": rank r takes row r
    of every array)."""
    from repro_torch.core import hloparse
    from repro_torch.distributed import int8_collectives as i8
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model_axis=1, device_type="cpu")
    out = {}
    for case, trees in payload.items():
        grads = {name: torch.from_numpy(x if case == "same" else x[rank])
                 for name, x in trees.items()}
        for mode in ("int8", "f32"):
            reducer = i8.make_reducer(mesh, axis="data",
                                      int8=(mode == "int8"))
            with hloparse.Meter() as meter:
                reduced = reducer(grads)
            out[case, mode] = dict(
                tree={k: x.numpy() for k, x in reduced.items()},
                coll=dict(meter.cost.coll))
    return out


def _place_params(tree, specs, mesh, rules, grad=False):
    """Numpy parameters as DTensors laid out by ``rules`` over their
    specs' logical axes."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    out = {}
    for name, spec in specs.items():
        sh = shd.Sharding(mesh, shd.spec_for(spec.shape, spec.axes, rules,
                                             mesh))
        t = shd.distribute({name: _tensors(tree[name])}, {name: sh})[name]
        out[name] = t.requires_grad_(grad)
    return L.map_tree(lambda t: t, out)


def _batch_rows(x, mesh):
    from repro_torch.distributed import sharding as shd
    return shd.distribute({"x": x}, shd.batch_shardings(mesh, {"x": x}))["x"]


def moe_layout_job(rank, payload):
    """The MoE block with its buffer split over a (2, 2) mesh (experts over
    model, capacity over data): outputs, aux losses, and every rank's
    (token, slot) ranks within their experts as it routed them."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe, smoke_variant

    mesh = _host_mesh()
    out = {}
    ranks_of = moe.global_ranks
    for key, case in payload.items():
        cfg = smoke_variant(get_config(case["arch"]), **case["over"])
        rules = shd.train_rules(mesh, cfg)
        p = _place_params(case["params"], moe.moe_specs(cfg, layered=False),
                          mesh, rules)
        x = _batch_rows(_tensors(case["x"]), mesh)
        seen = []
        moe.global_ranks = lambda *a: seen.append(ranks_of(*a)) or seen[-1]
        try:
            with context.activation_rules(mesh, {"batch": ("data",)}):
                y, aux = moe.moe_apply(cfg, p, x, return_aux=True)
        finally:
            moe.global_ranks = ranks_of
        out[key] = dict(y=_full(y), aux={k: float(_full(v)) for k, v in
                                         aux.items()},
                        ranks=_every_rank(seen[0].tolist()),
                        placements=str(y.placements))
    return out


def mamba_layout_job(rank, payload):
    """The Mamba2 block with its heads split over model on a (2, 2) mesh:
    a prefill, the decode step from its state, and the gradients of a
    weighted sum of the prefill's output."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import smoke_variant, ssm

    mesh = _host_mesh()
    cfg = smoke_variant(get_config("zamba2-2.7b"))
    rules = shd.train_rules(mesh, cfg)
    p = _place_params(payload["params"], ssm.ssm_specs(cfg, layered=False),
                      mesh, rules, grad=True)
    x = _batch_rows(_tensors(payload["x"]), mesh).requires_grad_(True)
    x1 = _batch_rows(_tensors(payload["x1"]), mesh)
    calls = []
    inner = ssm._mamba_sharded
    ssm._mamba_sharded = lambda *a: calls.append(a[-1]) or inner(*a)
    try:
        with context.activation_rules(mesh, {"batch": ("data",)}):
            y, (state, conv) = ssm.mamba_apply(cfg, p, x)
            weight = _batch_rows(_tensors(payload["r"]), mesh)
            (y * weight).sum().backward()
            with torch.no_grad():
                y1, (state1, conv1) = ssm.mamba_apply(cfg, p, x1, state,
                                                      conv)
    finally:
        ssm._mamba_sharded = inner
    calls_layer = list(calls)
    ssm._mamba_sharded = lambda *a: calls.append(a[-1]) or inner(*a)
    # A rank's heads of a layer's decode state.
    tail = (cfg.ssm_heads // 2, cfg.ssm_state, cfg.ssm_head_dim)
    try:
        with _gathers_of(tail) as state_gathers:
            served = serve_on(mesh, payload["serve"])
    finally:
        ssm._mamba_sharded = inner
    return dict(y=_full(y), state=_full(state), conv=_full(conv),
                y1=_full(y1), state1=_full(state1), conv1=_full(conv1),
                grads={k: _full(t.grad) for k, t in p.items()},
                dx=_full(x.grad), calls=calls_layer,
                served_calls=len(calls) - len(calls_layer),
                state_gathers=state_gathers,
                state_placements=str(state.placements), serve=served)


def grouped_job(rank, payload):
    """Grouped-query attention with fewer KV heads than model ranks on a
    (1, 4) mesh: the loss and gradients of a smoke model under
    ``train_rules``, and a prompt served with the cache's heads whole
    (``kv_channels=False``); the plain attention's and K2's plain
    version's query and key shapes on this rank."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.step import _grads
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model, attention, smoke_variant
    from repro_torch.models import layers as L

    mesh = make_host_mesh(model_axis=4, device_type="cpu")
    cfg = smoke_variant(get_config(payload["arch"]), **payload["over"])
    model = Model(cfg, device="cpu")
    shapes = {"attend": [], "decode": []}
    attend, decode = attention.reference_attention, ref.decode_attn_ref

    def seen_attend(q, k, v, causal=True):
        shapes["attend"].append((tuple(q.shape), tuple(k.shape)))
        return attend(q, k, v, causal)

    def seen_decode(q, k, v, length):
        shapes["decode"].append((tuple(q.shape), tuple(k.shape)))
        return decode(q, k, v, length)
    attention.reference_attention, ref.decode_attn_ref = (seen_attend,
                                                          seen_decode)
    try:
        params = shd.distribute(_tensors(payload["params"]),
                                shd.param_shardings(
                                    model, mesh, shd.train_rules(mesh, cfg)))
        for _, t in L.flatten_tree(params, torch.is_tensor):
            t.requires_grad_(True)
        batch = _tensors(payload["batch"])
        batch = shd.distribute(batch, shd.batch_shardings(mesh, batch))
        with context.activation_rules(mesh, {"batch": ("data",)}):
            loss, _ = model.loss(params, batch)
            grads = _grads(loss, params)
        train_shapes = list(shapes["attend"])
        params = shd.distribute(_tensors(payload["params"]),
                                shd.param_shardings(
                                    model, mesh, shd.decode_rules(mesh, cfg)))
        cache = model.make_cache(*payload["cache"])
        cache = shd.distribute(cache, shd.cache_shardings(
            cfg, mesh, cache, kv_channels=False))
        prompt = _tensors(payload["prompt"])
        logits = []
        with torch.no_grad(), context.activation_rules(
                mesh, {"batch": ("data",)}):
            lg, cache = model.prefill(params, shd.distribute(
                prompt, shd.batch_shardings(mesh, prompt)), cache)
            for _ in range(payload["steps"]):
                logits.append(_full(lg))
                tok = torch.from_numpy(logits[-1].argmax(-1).astype(np.int32))
                sb = dict(tokens=tok[:, None], positions=torch.full(
                    (len(tok), 1), cache["len"], dtype=torch.int32))
                lg, cache = model.decode_step(params, shd.distribute(
                    sb, shd.batch_shardings(mesh, sb)), cache)
            logits.append(_full(lg))
    finally:
        attention.reference_attention, ref.decode_attn_ref = attend, decode
    return dict(loss=float(_full(loss)), grads=L.map_tree(_full, grads),
                logits=logits, train_shapes=train_shapes,
                decode_shapes=shapes["decode"])


def batch1_job(rank, payload):
    """Smoke models served at batch 1 on a (2, 2) mesh, where the data
    ranks hold the batch whole: rwkv6's take parts of its features,
    zamba2's shares of its channelized cache's KV heads."""
    return {arch: serve_on(_host_mesh(), case)
            for arch, case in payload.items()}


def context_parallel_job(rank, payload):
    """Smoke models' loss and gradients with each sequence split over
    ``pod`` on a (pod 2, data 2, model 1) mesh, folded to (4, 1) for the
    step (``launch/dryrun.fold_pod``): the batch re-indexed as the halves
    of its sequences (``sharding.split_sequences``) under the
    ``seq_pair`` rule; whole, with each rank's calls of the WKV's plain
    versions (K3 and K3b's stand-ins on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed import context, layout
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.step import _grads
    from repro_torch.kernels import ref
    from repro_torch.launch.dryrun import fold_pod
    from repro_torch.models import Model, smoke_variant
    from repro_torch.models import layers as L

    full = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    mesh = fold_pod(full)
    pair = layout.SeqPair.over(full)
    calls = {"wkv_ref": 0, "wkv_bwd_ref": 0}
    saved = {name: getattr(ref, name) for name in calls}

    def counted(name):
        def fn(*args):
            calls[name] += 1
            return saved[name](*args)
        return fn
    out = {}
    try:
        for name in calls:
            setattr(ref, name, counted(name))
        for arch, case in payload.items():
            cfg = smoke_variant(get_config(arch), **case.get("over", {}))
            model = Model(cfg, device="cpu")
            params = shd.distribute(_tensors(case["params"]),
                                    shd.param_shardings(
                                        model, mesh,
                                        shd.train_rules(mesh, cfg)))
            for _, p in L.flatten_tree(params, torch.is_tensor):
                p.requires_grad_(True)
            batch = shd.split_sequences(full, _tensors(case["batch"]), 2)
            batch = shd.distribute(batch, shd.batch_shardings(mesh, batch))
            calls.update(dict.fromkeys(calls, 0))
            rules = {"batch": shd.fsdp_axes(mesh), "seq_pair": pair}
            with context.activation_rules(mesh, rules):
                loss, _ = model.loss(params, batch)
                grads = _grads(loss, params)
            out[arch] = dict(loss=float(_full(loss)),
                             grads=L.map_tree(_full, grads),
                             calls=_every_rank(sorted(calls.items())))
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)
    return out


@contextlib.contextmanager
def wide_floats():
    """Inside the block ``Tensor.float()`` of a floating tensor gives
    float64, so that a float64 model's float32 math (norms, the WKV's
    states, the loss) runs in float64 too: two orders of the same sums
    then agree to float64's rounding."""
    saved = torch.Tensor.float
    own = "float" in vars(torch.Tensor)
    torch.Tensor.float = lambda self, *args, **kwargs: (
        self.double() if self.is_floating_point() else
        saved(self, *args, **kwargs))
    try:
        yield
    finally:
        if own:
            torch.Tensor.float = saved
        else:
            del torch.Tensor.float


def wide_train_job(rank, payload):
    """Smoke models' loss and gradients in float64 (:func:`wide_floats`)
    under ``train_rules`` on a (2, 2) mesh, as whole tensors: rwkv6's
    blocks split their heads, towers and mixes over ``model``
    (``models/rwkv``), an exact split of the same math."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.step import _grads
    from repro_torch.models import Model, smoke_variant
    from repro_torch.models import layers as L

    mesh = _host_mesh()
    out = {}
    with wide_floats():
        for arch, case in payload.items():
            model = Model(smoke_variant(get_config(arch)), device="cpu")
            params = shd.distribute(
                _tensors(case["params"]), shd.param_shardings(
                    model, mesh, shd.train_rules(mesh, model.cfg)))
            for _, p in L.flatten_tree(params, torch.is_tensor):
                p.requires_grad_(True)
            batch = _tensors(case["batch"])
            batch = shd.distribute(batch, shd.batch_shardings(mesh, batch))
            with context.activation_rules(mesh,
                                          {"batch": shd.fsdp_axes(mesh)}):
                loss, _ = model.loss(params, batch)
                grads = _grads(loss, params)
            out[arch] = dict(loss=float(_full(loss)),
                             grads=L.map_tree(_full, grads))
    return out


@contextlib.contextmanager
def dtensor_ops():
    """Inside the block every op dispatched with a DTensor argument (what
    reaches DTensor's op dispatcher and its sharding propagation) is
    recorded: (op, each DTensor argument's placements and global shape).
    A dispatch mode sees each op before DTensor's dispatch does, on any
    torch version."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                self.ops.append((str(func), [
                    (str(a.placements), tuple(a.shape)) for a in args
                    if isinstance(a, DTensor)]))
                return NotImplemented
            return func(*args, **(kwargs or {}))

    with Seen() as mode:
        yield mode.ops


def _leaf_accumulation(op, params):
    """Whether a recorded DTensor op is the accumulation of a parameter's
    gradients laid out alike: an add of two DTensors of one layout and a
    parameter's shape."""
    name, tensors = op
    shapes = {tuple(p.shape) for p in params}
    return name.startswith("aten.add") and len(tensors) == 2 and \
        tensors[0] == tensors[1] and tensors[0][1] in shapes


def local_layout_job(rank, payload):
    """Each smoke family on a (2, 2) mesh: ``Model.loss`` and its backward
    under ``train_rules``, and a prefill and one decode step under
    ``decode_rules`` with a channelized cache, with every op that reaches
    DTensor's dispatcher recorded (:func:`dtensor_ops`); returns, a
    family and phase, the ops other than a leaf's gradient accumulation
    laid out alike, and the loss and logits (finite)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import Model, smoke_variant
    from repro_torch.models import layers as L

    mesh = _host_mesh()
    out = {}
    for arch in payload["archs"]:
        cfg = smoke_variant(get_config(arch))
        model = Model(cfg, device="cpu")
        init = model.init(0)
        params = shd.distribute(init, shd.param_shardings(
            model, mesh, shd.train_rules(mesh, cfg)))
        leaves = [p.requires_grad_(True) for _, p in
                  L.flatten_tree(params, torch.is_tensor)]
        data = {k: torch.as_tensor(v) for k, v in SyntheticDataset(
            cfg, 4, 16, seed=3).batch_at(0).items()}
        batch = shd.distribute(data, shd.batch_shardings(mesh, data))
        rules = {"batch": shd.fsdp_axes(mesh)}
        with context.activation_rules(mesh, rules), dtensor_ops() as seen:
            loss, _ = model.loss(params, batch)
            grads = torch.autograd.grad(loss.to_local(), leaves,
                                        allow_unused=True)
        out[arch, "train"] = dict(
            ops=[op for op in seen if not _leaf_accumulation(op, leaves)],
            finite=bool(torch.isfinite(loss.to_local())) and all(
                bool(torch.isfinite(g.to_local()).all())
                for g in grads if g is not None))
        if not cfg.has_decode:
            continue
        params = shd.distribute(init, shd.param_shardings(
            model, mesh, shd.decode_rules(mesh, cfg)))
        cache = model.make_cache(4, 16)
        cache = shd.distribute(cache, shd.cache_shardings(cfg, mesh, cache))
        prompt = {k: v[:, :8] for k, v in data.items()
                  if k in ("tokens", "positions")}
        with torch.no_grad(), context.activation_rules(mesh, rules), \
                dtensor_ops() as seen:
            lg, cache = model.prefill(params, shd.distribute(
                prompt, shd.batch_shardings(mesh, prompt)), cache)
            sb = {k: v[:, 8:9] for k, v in data.items()
                  if k in ("tokens", "positions")}
            lg, cache = model.decode_step(params, shd.distribute(
                sb, shd.batch_shardings(mesh, sb)), cache)
        out[arch, "decode"] = dict(
            ops=seen, finite=bool(torch.isfinite(lg.to_local()).all()))
    return out


def sharding_job(rank, payload):
    return dict(model_job(rank, payload["model"]),
                wide=wide_train_job(rank, payload["wide"]),
                batch1=batch1_job(rank, payload["batch1"]),
                kernels=kernel_job(rank, payload["kernels"]),
                moe=moe_layout_job(rank, payload["moe"]),
                mamba=mamba_layout_job(rank, payload["mamba"]),
                grouped=grouped_job(rank, payload["grouped"]))


JOBS = {"sharding": sharding_job, "int8": int8_job,
        "context_parallel": context_parallel_job,
        "local_layout": local_layout_job}
