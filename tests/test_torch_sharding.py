"""The port's multi-device layer (``distributed/{sharding,context}``,
``launch/mesh``, the models' sharding hooks and the kernels' DTensor
dispatch) against the reference, on the CPU.

* Spec tuples: every parameter, cache and batch leaf of the six families,
  at smoke size on host meshes and at full size on the reference's TPU
  meshes and the port's H100 meshes (objects with a mesh's names and
  sizes; the reference's side an ``AbstractMesh``), equal to the
  reference's ``PartitionSpec``s.
* Local shards: each rank's shard of every parameter on 4-rank meshes
  (a fake process group, one rank at a time) starts where the reference's
  ``devices_indices_map`` puts that device's, ``("pod", "data")`` pod
  major.
* The kernel layer imports no model (``distributed/layout`` is a leaf).
* A real 4-rank gloo world (spawned once, ``torch_mesh_worker``): the
  smoke models' loss and gradients under ``train_rules`` against the
  one-process port and the reference (the embedding lookup and the loss
  head vocab-parallel: no redistribution makes either table whole); a
  served prompt under ``decode_rules`` with a channelized cache against
  the one-process serve; the kernels' DTensor dispatch, a cache whose
  sequence is split over ``model`` through each rank's partials and
  their merge (one rank's slice empty at length 5).
* The same world, the blocks that split their work as GSPMD splits the
  reference's: the MoE buffer's blocks over a (2, 2) mesh with tokens
  dropped on both data ranks (each (token, slot)'s rank within its expert
  equal to one device's exactly, the output and aux losses against
  ``repro.models.moe``); the Mamba2 heads over ``model`` for a prefill
  and the decode step from its state against ``repro.models.ssm``, with
  the gradients against one process; grouped-query attention with 8
  query heads over 2 KV heads on a (1, 4) mesh (2 query heads and their
  group's KV head a rank) against the reference's loss and gradients,
  and served against one process.
"""

import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, Mesh, NamedSharding
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

import torch_mesh_worker
from repro.configs import SHAPES
from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticDataset as JSyntheticDataset
from repro.distributed import sharding as jshd
from repro.models import Model as JModel
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.config import smoke_variant as jsmoke
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import step as pstep
from repro_torch.kernels import ref
from repro_torch.models import Model, layers, moe, smoke_variant, ssm
from repro_torch.models import model as pmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_cache

FAMILIES = ["stablelm-1.6b", "olmoe-1b-7b", "rwkv6-1.6b", "zamba2-2.7b",
            "qwen2-vl-72b", "hubert-xlarge"]
#: (name, axis sizes) of the meshes the specs are held on.
FULL_MESHES = [("tpu-16x16", {"data": 16, "model": 16}),
               ("tpu-2x16x16", {"pod": 2, "data": 16, "model": 16}),
               ("h100-32x8", {"data": 32, "model": 8}),
               ("h100-2x32x8", {"pod": 2, "data": 32, "model": 8})]
HOST_MESHES = [("2x2", {"data": 2, "model": 2}),
               ("2x2x1", {"pod": 2, "data": 2, "model": 1})]
# The 4-rank world against one process, float32: the same products in
# other orders of summation (a contraction split over ranks).
RTOL, ATOL = 1e-5, 1e-6


def _meshes(sizes):
    names = tuple(sizes)
    port = types.SimpleNamespace(mesh_dim_names=names,
                                 shape=tuple(sizes.values()))
    return port, AbstractMesh(tuple(sizes.values()), names)


def _spec(p, nd):
    """A reference PartitionSpec as the port's per-dimension tuple."""
    parts = tuple(p)
    return parts + (None,) * (nd - len(parts))


def _leaves(tree, is_leaf):
    return dict(layers.flatten_tree(tree, is_leaf=is_leaf))


def _jleaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _cfgs(arch, smoke):
    if smoke:
        return smoke_variant(get_config(arch)), jsmoke(jget_config(arch))
    return get_config(arch), jget_config(arch)


def _check_params(cfg, jcfg, pmesh, jmesh):
    for rules_of in ("train_rules", "decode_rules"):
        got = shd.param_shardings(Model(cfg, device="cpu"), pmesh,
                                  getattr(shd, rules_of)(pmesh, cfg))
        want = jshd.param_shardings(JModel(jcfg), jmesh,
                                    getattr(jshd, rules_of)(jmesh, jcfg))
        got = _leaves(got, lambda x: isinstance(x, shd.Sharding))
        want = _jleaves(want)
        assert got.keys() == want.keys()
        for path, sh in got.items():
            assert sh.spec == _spec(want[path].spec, len(sh.spec)), \
                (rules_of, path)


def _check_batches(cfg, jcfg, pmesh, jmesh, batch, seq):
    for p_tree, j_tree in (
            (pmodel.batch_spec(cfg, batch, seq),
             jmodel.batch_spec(jcfg, batch, seq)),
            (pmodel.decode_batch_spec(cfg, batch),
             jmodel.decode_batch_spec(jcfg, batch))):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in p_tree.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in j_tree.items()}
        got = shd.batch_shardings(pmesh, p_tree)
        want = jshd.batch_shardings(jmesh, j_tree)
        for name, sh in got.items():
            assert sh.spec == _spec(want[name].spec, len(sh.spec)), name


def _check_cache(cfg, jcfg, pmesh, jmesh, batch, seq):
    if not cfg.has_decode:
        return
    cache = init_cache(cfg, batch, seq, pmodel.DTYPES[cfg.dtype], "meta")
    jcache = jax.eval_shape(lambda: JModel(jcfg).make_cache(batch, seq))
    for kv_channels in (True, False):
        got = shd.cache_shardings(cfg, pmesh, cache, kv_channels)
        want = jshd.cache_shardings(jcfg, jmesh, jcache, kv_channels)
        assert got.keys() == want.keys()
        assert got["len"] is None and tuple(want["len"].spec) == ()
        for name, sh in got.items():
            if name != "len":
                assert tuple(cache[name].shape) == jcache[name].shape
                assert sh.spec == _spec(want[name].spec, len(sh.spec)), name


@pytest.mark.parametrize("mesh_name,sizes", HOST_MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_specs_equal_reference(arch, mesh_name, sizes):
    cfg, jcfg = _cfgs(arch, smoke=True)
    pmesh, jmesh = _meshes(sizes)
    _check_params(cfg, jcfg, pmesh, jmesh)
    _check_batches(cfg, jcfg, pmesh, jmesh, 4, 16)
    _check_cache(cfg, jcfg, pmesh, jmesh, 4, 16)


@pytest.mark.parametrize("mesh_name,sizes", FULL_MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_full_size_specs_equal_reference(arch, mesh_name, sizes):
    cfg, jcfg = _cfgs(arch, smoke=False)
    pmesh, jmesh = _meshes(sizes)
    _check_params(cfg, jcfg, pmesh, jmesh)
    for shape in SHAPES:
        if shape.kind == "decode":
            if shape.seq_len <= 32768:
                _check_cache(cfg, jcfg, pmesh, jmesh, shape.global_batch,
                             shape.seq_len)
        else:
            _check_batches(cfg, jcfg, pmesh, jmesh, shape.global_batch,
                           shape.seq_len)


def test_rules_as_reference():
    pmesh, jmesh = _meshes({"pod": 2, "data": 32, "model": 8})
    for arch in FAMILIES:
        cfg, jcfg = _cfgs(arch, smoke=False)
        assert shd.train_rules(pmesh, cfg) == jshd.train_rules(jmesh, jcfg)
        assert shd.decode_rules(pmesh, cfg) == jshd.decode_rules(jmesh,
                                                                 jcfg)
    moe = get_config("olmoe-1b-7b")
    assert shd.train_rules(pmesh, moe)["mlp"] is None
    assert shd.decode_rules(pmesh, moe)["embed"] is None
    assert shd.fsdp_axes(pmesh) == ("pod", "data")
    assert shd.axis_size(pmesh, ("pod", "data")) == 64


def test_placements_fold_pod_and_data_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    pmesh, _ = _meshes({"pod": 2, "data": 32, "model": 8})
    assert shd.placements(pmesh, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert shd.placements(pmesh, (None, None)) == (Replicate(),) * 3


def test_kernel_layer_imports_no_model():
    """``kernels/ops``, and ``core/memsim`` through it, take DTensor's
    layout helpers from the leaf ``distributed/layout``: importing them
    loads neither the model package nor the sharding rules."""
    code = ("import sys, repro_torch.kernels.ops, repro_torch.core.memsim; "
            "print(sorted(m for m in sys.modules if m.startswith(("
            "'repro_torch.models', 'repro_torch.distributed.sharding', "
            "'repro_torch.distributed.context'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("mesh_name,sizes", HOST_MESHES)
def test_local_shards_equal_reference_devices_indices_map(mesh_name, sizes):
    """Each rank's shard offsets and lengths, rank r on the reference's
    device r (both lay the ranks out row major over the mesh)."""
    names, shape = tuple(sizes), tuple(sizes.values())
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), names)
    cases = []
    for arch in FAMILIES:
        cfg, jcfg = _cfgs(arch, smoke=True)
        want = _jleaves(jshd.param_shardings(
            JModel(jcfg), jmesh, jshd.train_rules(jmesh, jcfg)))
        specs = _leaves(Model(cfg, device="cpu").specs(), layers.is_spec)
        cases += [(path, spec.shape, want[path]) for path, spec in
                  specs.items()]
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    try:
        for rank in range(4):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=4)
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            for path, dims, jsh in cases:
                spec = _spec(jsh.spec, len(dims))
                local, offset = compute_local_shape_and_global_offset(
                    dims, mesh, shd.placements(mesh, spec))
                index = jsh.devices_indices_map(dims)[jax.devices()[rank]]
                assert tuple(offset) == tuple(s.start or 0 for s in index), \
                    (rank, path)
                assert tuple(local) == tuple(
                    len(range(*s.indices(n))) for s, n in zip(index, dims)), \
                    (rank, path)
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The 4-rank gloo world.
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("stablelm-1.6b", "olmoe-1b-7b")
SERVE_STEPS = 3


def _jpair(arch, **over):
    cfg, jcfg = _cfgs(arch, smoke=True)
    if over:
        cfg, jcfg = smoke_variant(get_config(arch), **over), \
            jsmoke(jget_config(arch), **over)
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                         jparams), "cpu")
    return jm, jparams, Model(cfg, device="cpu"), params


def _numpy(tree):
    return layers.map_tree(lambda t: t.detach().numpy(), tree)


@pytest.fixture(scope="module")
def world():
    """One spawn of the world for the module: its inputs, rank 0's
    results, and the reference's and the one-process port's values."""
    payload = {"train": {}}
    want = {}
    for arch in TRAIN_ARCHS:
        jm, jparams, m, params = _jpair(arch)
        batch = JSyntheticDataset(jm.cfg, 4, 16, seed=3).batch_at(0)
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            jm.loss, has_aux=True))(jparams, batch)
        for _, p in layers.flatten_tree(params, torch.is_tensor):
            p.requires_grad_(True)
        loss, _ = m.loss(params, batch)
        grads = pstep._grads(loss, params)
        payload["train"][arch] = dict(
            params=_numpy(params), batch={k: np.asarray(v) for k, v in
                                          batch.items()})
        want[arch] = dict(
            ref_loss=float(jloss), loss=loss.item(), grads=_numpy(grads),
            ref_grads=jax.tree_util.tree_map(np.asarray, jgrads))
    # The served prompt: the one-process port's greedy steps.
    _, _, m, params = _jpair("stablelm-1.6b")
    prompt = {k: np.asarray(v) for k, v in JSyntheticDataset(
        m.cfg, 4, 8, seed=5).batch_at(0).items()
        if k in ("tokens", "positions")}
    cache = m.make_cache(4, 16)
    lg, cache = m.prefill(params, prompt, cache)
    serve = [lg.numpy()]
    for _ in range(SERVE_STEPS):
        tok = lg.argmax(-1).to(torch.int32)
        sb = dict(tokens=tok[:, None], positions=torch.full(
            (4, 1), cache["len"], dtype=torch.int32))
        lg, cache = m.decode_step(params, sb, cache)
        serve.append(lg.numpy())
    payload["serve"] = dict(arch="stablelm-1.6b", params=_numpy(params),
                            cache=(4, 16), prompt=prompt, steps=SERVE_STEPS)
    want["serve"] = serve
    gen = np.random.default_rng(0)
    rn = lambda *shape: gen.standard_normal(shape).astype(np.float32)
    kernels = dict(q=rn(4, 4, 16), k=rn(4, 16, 2, 16), v=rn(4, 16, 2, 16),
                   length=11, r=rn(2, 5, 2, 8), wk=rn(2, 5, 2, 8),
                   wv=rn(2, 5, 2, 8), u=rn(2, 8),
                   w=gen.uniform(0.5, 0.99, (2, 5, 2, 8)).astype(np.float32),
                   s0=rn(2, 2, 8, 8))
    layouts, want_layouts = _layout_cases()
    got = torch_mesh_worker.run_world(
        "sharding", 4, {"model": payload, "kernels": kernels, **layouts})
    return dict(got=got, want=dict(want, **want_layouts), kernels=kernels)


#: MoE cases of the world: capacity factors whose capacity (4 and 5 slots
#: an expert for 32 tokens of top 2 over 4 experts) drops tokens on both
#: data ranks; 5 does not divide the 2 data ranks, so the buffer's
#: capacity axis is padded to 6.
MOE_CASES = {"cap4": 0.25, "cap5": 0.3125}
#: Served at batch 1, which the 2 data ranks do not split.
BATCH1_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")
#: Grouped-query attention: 8 query heads over 2 KV heads, 4 model ranks.
GROUPED = ("starcoder2-3b", dict(n_heads=8, n_kv_heads=2))
# The Mamba2 block with split heads against the reference: the tolerance
# of tests/test_torch_ssm.py (float32, sums in other orders).
SSM_TOL = dict(rtol=1e-4, atol=1e-5)


def _moe_case(cf):
    over = dict(capacity_factor=cf)
    cfg = smoke_variant(get_config("olmoe-1b-7b"), **over)
    jcfg = jsmoke(jget_config("olmoe-1b-7b"), **over)
    rng = np.random.default_rng(11)
    params = {name: (rng.standard_normal(spec.shape) /
                     np.sqrt(spec.shape[-2])).astype(np.float32)
              for name, spec in moe.moe_specs(cfg, layered=False).items()}
    x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x), return_aux=True)
    # One device's ranks, as the reference ranks them.
    gates = jax.nn.softmax((jnp.asarray(x).reshape(-1, cfg.d_model) @
                            jp["router"]).astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(gates, cfg.top_k)
    flat = np.eye(cfg.n_experts, dtype=np.int64)[np.asarray(topi)].reshape(
        -1, cfg.n_experts)
    ranks = ((np.cumsum(flat, 0) - flat) * flat).sum(-1).reshape(
        -1, cfg.top_k)
    return (dict(arch="olmoe-1b-7b", over=over, params=params, x=x),
            dict(y=np.asarray(jy), aux={k: float(v) for k, v in
                                        jaux.items()},
                 ranks=ranks, cap=moe.capacity(cfg, x.shape[0] * x.shape[1])))


def _mamba_case():
    cfg = smoke_variant(get_config("zamba2-2.7b"))
    jcfg = jsmoke(jget_config("zamba2-2.7b"))
    rng = np.random.default_rng(12)
    rn = lambda *shape, scale=0.5: (scale * rng.standard_normal(shape)
                                    ).astype(np.float32)
    params = {name: rn(*spec.shape) for name, spec in
              ssm.ssm_specs(cfg, layered=False).items()}
    params["in_proj"] *= 2 * cfg.d_model ** -0.5
    params["out_proj"] *= 2 * cfg.d_inner ** -0.5
    x, x1, r = rn(2, 8, cfg.d_model), rn(2, 1, cfg.d_model), rn(2, 8,
                                                                 cfg.d_model)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy, (js, jc) = jssm.mamba_apply(jcfg, jp, jnp.asarray(x))
    jy1, (js1, jc1) = jssm.mamba_apply(jcfg, jp, jnp.asarray(x1), js, jc)
    # The gradients of one process of the port.
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = ssm.mamba_apply(cfg, tp, tx)
    (y * torch.from_numpy(r)).sum().backward()
    want = dict(y=jy, state=js, conv=jc, y1=jy1, state1=js1, conv1=jc1)
    serve, served = _serve_case("zamba2-2.7b")
    return (dict(params=params, x=x, x1=x1, r=r, serve=serve),
            dict({k: np.asarray(v) for k, v in want.items()},
                 grads={k: t.grad.numpy() for k, t in tp.items()},
                 dx=tx.grad.numpy(), serve=served))


def _serve_case(arch, batch=4, **over):
    """A served prompt's payload and the one-process port's logits of its
    prefill and greedy steps."""
    _, _, m, params = _jpair(arch, **over)
    prompt = {k: np.asarray(v) for k, v in JSyntheticDataset(
        m.cfg, batch, 8, seed=5).batch_at(0).items()
        if k in ("tokens", "positions")}
    cache = m.make_cache(batch, 16)
    lg, cache = m.prefill(params, prompt, cache)
    serve = [lg.numpy()]
    for _ in range(SERVE_STEPS):
        tok = lg.argmax(-1).to(torch.int32)
        sb = dict(tokens=tok[:, None], positions=torch.full(
            (batch, 1), cache["len"], dtype=torch.int32))
        lg, cache = m.decode_step(params, sb, cache)
        serve.append(lg.numpy())
    return (dict(arch=arch, params=_numpy(params), cache=(batch, 16),
                 prompt=prompt, steps=SERVE_STEPS), serve)


def _grouped_case():
    arch, over = GROUPED
    jm, jparams, m, params = _jpair(arch, **over)
    batch = JSyntheticDataset(jm.cfg, 4, 16, seed=3).batch_at(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jparams, batch)
    prompt = {k: np.asarray(v) for k, v in JSyntheticDataset(
        m.cfg, 4, 8, seed=5).batch_at(0).items()
        if k in ("tokens", "positions")}
    cache = m.make_cache(4, 16)
    lg, cache = m.prefill(params, prompt, cache)
    serve = [lg.numpy()]
    for _ in range(SERVE_STEPS):
        tok = lg.argmax(-1).to(torch.int32)
        sb = dict(tokens=tok[:, None], positions=torch.full(
            (4, 1), cache["len"], dtype=torch.int32))
        lg, cache = m.decode_step(params, sb, cache)
        serve.append(lg.numpy())
    return (dict(arch=arch, over=over, params=_numpy(params),
                 batch={k: np.asarray(v) for k, v in batch.items()},
                 cache=(4, 16), prompt=prompt, steps=SERVE_STEPS),
            dict(ref_loss=float(jloss), serve=serve,
                 ref_grads=jax.tree_util.tree_map(np.asarray, jgrads)))


def _layout_cases():
    """The layout jobs' payloads and what the reference (and one process
    of the port) computes for them."""
    got, want = {}, {}
    cases = {key: _moe_case(cf) for key, cf in MOE_CASES.items()}
    got["moe"] = {key: c[0] for key, c in cases.items()}
    want["moe"] = {key: c[1] for key, c in cases.items()}
    got["mamba"], want["mamba"] = _mamba_case()
    got["grouped"], want["grouped"] = _grouped_case()
    cases = {arch: _serve_case(arch, batch=1) for arch in BATCH1_ARCHS}
    got["batch1"] = {arch: c[0] for arch, c in cases.items()}
    want["batch1"] = {arch: c[1] for arch, c in cases.items()}
    got["wide"], want["wide"] = _wide_case(WIDE_ARCH)
    return got, want


#: The float64 witness of the world: a family whose blocks run on local
#: tensors with their own split (``models/rwkv``).
WIDE_ARCH = "rwkv6-1.6b"


def _wide_case(arch):
    """A smoke model's float64 loss and gradients on one process
    (``torch_mesh_worker.wide_floats``), and the world's payload."""
    m = Model(smoke_variant(get_config(arch)), device="cpu")
    params = layers.map_tree(lambda t: t.double(), m.init(0))
    batch = {k: torch.as_tensor(v) for k, v in SyntheticDataset(
        m.cfg, 4, 16, seed=3).batch_at(0).items()}
    for _, p in layers.flatten_tree(params, torch.is_tensor):
        p.requires_grad_(True)
    with torch_mesh_worker.wide_floats():
        loss, _ = m.loss(params, batch)
        grads = pstep._grads(loss, params)
    payload = {arch: dict(params=_numpy(params), batch={
        k: v.numpy() for k, v in batch.items()})}
    return payload, dict(loss=loss.item(), grads=_numpy(grads))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_grads_on_4_ranks_equal_one_process(world, arch):
    got, want = world["got"][arch], world["want"][arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL,
                               atol=ATOL)
    g = _leaves(got["grads"], lambda x: isinstance(x, np.ndarray))
    w = _leaves(want["grads"], lambda x: isinstance(x, np.ndarray))
    assert g.keys() == w.keys()
    for path in g:
        np.testing.assert_allclose(g[path], w[path], rtol=RTOL, atol=ATOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_grads_on_4_ranks_equal_reference(world, arch):
    got, want = world["got"][arch], world["want"][arch]
    np.testing.assert_allclose(got["loss"], want["ref_loss"], rtol=RTOL,
                               atol=ATOL)
    g = _leaves(got["grads"], lambda x: isinstance(x, np.ndarray))
    w = dict(layers.flatten_tree(want["ref_grads"],
                                 is_leaf=lambda x: not isinstance(x, dict)))
    assert g.keys() == w.keys()
    for path in g:
        np.testing.assert_allclose(g[path], np.asarray(w[path]), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_serve_on_4_ranks_with_channelized_cache_equals_one_process(world):
    got = world["got"]["serve"]
    # The cache: batch over data, sequence over model.
    assert got["placements"] == "(Shard(dim=1), Shard(dim=2))"
    assert len(got["logits"]) == len(world["want"]["serve"])
    for step, (g, w) in enumerate(zip(got["logits"], world["want"]["serve"])):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-5,
                                   err_msg=step)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_vocab_parallel_lookup_and_loss_gather_no_whole_table(world, arch):
    """The loss and gradients above come from the vocab-parallel lookup
    and cross-entropy: no redistribution, forward or backward, made the
    embedding table or the head whole on a rank."""
    assert world["got"][arch]["whole_tables"] == []


def _decode_want(kw, length=None):
    q, k, v = (torch.from_numpy(kw[n]) for n in ("q", "k", "v"))
    return ref.decode_attn_ref(
        q, k, v, kw["length"] if length is None else length).numpy()


def test_kernel_runs_on_local_shards_of_batch_and_heads(world):
    got, placements = world["got"]["kernels"]["per_shard"]
    assert placements == "(Shard(dim=0), Shard(dim=1))"
    np.testing.assert_allclose(got, _decode_want(world["kernels"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("length", [11, 5])
def test_kernel_merges_partials_of_a_sequence_sharded_cache(world, length):
    """A cache of 16 keys split over model (8 a rank): each rank runs the
    partials of its own valid keys (rank 1's slice empty at length 5) and
    the merge over model equals the plain version over the whole cache,
    replicated over model."""
    got, placements, calls = world["got"]["kernels"]["seq_partials"][length]
    assert placements == "(Shard(dim=0), Replicate())"
    # Ranks (data, model) in row-major order: model coordinate r % 2.
    local = [min(max(length - 8 * (r % 2), 0), 8) for r in range(4)]
    assert calls == [[n] for n in local]
    np.testing.assert_allclose(got, _decode_want(world["kernels"], length),
                               rtol=1e-5, atol=1e-6)


def test_per_shard_seq_role_merges_each_ranks_partials(world):
    got, calls = world["got"]["kernels"]["seq_per_shard"]
    assert calls == [[5], [0], [5], [0]]
    np.testing.assert_allclose(got, _decode_want(world["kernels"], 5),
                               rtol=1e-5, atol=1e-6)


def test_plain_decode_runs_channelized_on_a_sequence_sharded_cache(world):
    np.testing.assert_allclose(world["got"]["kernels"]["channelized"],
                               _decode_want(world["kernels"]), rtol=1e-5,
                               atol=1e-6)


def test_plain_wkv_on_batch_and_head_sharded_inputs(world):
    kw = world["kernels"]
    t = lambda n: torch.from_numpy(kw[n])
    y, s = ref.wkv_ref(t("r"), t("wk"), t("wv"), t("w"), t("u"), t("s0"))
    got_y, got_s = world["got"]["kernels"]["wkv"]
    np.testing.assert_allclose(got_y, y.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_s, s.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The blocks that split their work over the world (``_layout_cases``).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(MOE_CASES))
def test_moe_ranks_on_2x2_equal_one_device_with_drops_on_both_data_ranks(
        world, key):
    got, want = world["got"]["moe"][key], world["want"]["moe"][key]
    ranks, cap = want["ranks"], want["cap"]
    t_loc = len(ranks) // 2
    # Ranks (data, model) in row-major order: data coordinate r // 2.
    for r, mine in enumerate(got["ranks"]):
        d = r // 2
        np.testing.assert_array_equal(np.asarray(mine).reshape(
            -1, ranks.shape[1]),
                                      ranks[d * t_loc:(d + 1) * t_loc])
    keep = ranks < cap
    assert not keep[:t_loc].all() and not keep[t_loc:].all()


@pytest.mark.parametrize("key", sorted(MOE_CASES))
def test_moe_blocks_on_2x2_equal_reference(world, key):
    got, want = world["got"]["moe"][key], world["want"]["moe"][key]
    assert got["placements"] == "(Shard(dim=0), Replicate())"
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-6)
    assert got["aux"].keys() == want["aux"].keys()
    assert got["aux"]["moe_overflow"] == want["aux"]["moe_overflow"] > 0
    for name, value in want["aux"].items():
        np.testing.assert_allclose(got["aux"][name], value, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", ["y", "state", "conv", "y1", "state1",
                                  "conv1"])
def test_mamba_heads_split_over_model_equal_reference(world, name):
    got, want = world["got"]["mamba"], world["want"]["mamba"]
    # The split path ran on both calls, over the model dimension (1).
    assert got["calls"] == [1, 1]
    assert got["state_placements"] == "(Shard(dim=0), Shard(dim=1))"
    np.testing.assert_allclose(got[name], want[name], **SSM_TOL,
                               err_msg=name)


def test_mamba_heads_split_over_model_gradients_equal_one_process(world):
    got, want = world["got"]["mamba"], world["want"]["mamba"]
    np.testing.assert_allclose(got["dx"], want["dx"], **SSM_TOL)
    assert got["grads"].keys() == want["grads"].keys()
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, **SSM_TOL,
                                   err_msg=name)


def test_grouped_attention_on_1x4_equals_reference(world):
    got, want = world["got"]["grouped"], world["want"]["grouped"]
    np.testing.assert_allclose(got["loss"], want["ref_loss"], rtol=RTOL,
                               atol=ATOL)
    g = _leaves(got["grads"], lambda x: isinstance(x, np.ndarray))
    w = dict(layers.flatten_tree(want["ref_grads"],
                                 is_leaf=lambda x: not isinstance(x, dict)))
    assert g.keys() == w.keys()
    for path in g:
        np.testing.assert_allclose(g[path], np.asarray(w[path]), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_grouped_attention_runs_each_ranks_group(world):
    """Each rank attends with 2 query heads and its group's KV head, in
    the loss's passes and in every decode step."""
    got = world["got"]["grouped"]
    hd = 16
    assert got["train_shapes"] and set(got["train_shapes"]) == {
        ((4, 16, 2, hd), (4, 16, 1, hd))}
    assert len(got["decode_shapes"]) == SERVE_STEPS * 2 and set(
        got["decode_shapes"]) == {((4, 2, hd), (4, 16, 1, hd))}


def test_grouped_serve_on_1x4_equals_one_process(world):
    got, want = world["got"]["grouped"], world["want"]["grouped"]
    assert len(got["logits"]) == len(want["serve"])
    for step, (g, w) in enumerate(zip(got["logits"], want["serve"])):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-5, err_msg=step)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_hybrid_serve_with_split_heads_on_2x2_equals_one_process(world):
    """zamba2's smoke model served on (2, 2): each Mamba layer's heads
    over model (its state and conv window written back into the cache),
    the shared block's cache channelized."""
    got, want = world["got"]["mamba"], world["want"]["mamba"]
    n_layers = smoke_variant(get_config("zamba2-2.7b")).n_layers
    assert got["served_calls"] == n_layers * (SERVE_STEPS + 1)
    assert len(got["serve"]["logits"]) == len(want["serve"])
    for step, (g, w) in enumerate(zip(got["serve"]["logits"],
                                      want["serve"])):
        # The hybrid family's logits tolerance (test_torch_model.py): the
        # SSD in float32 is sensitive to the order of its sums.
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=step)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_hybrid_serve_keeps_each_ranks_heads_of_the_state(world):
    """The served cache's SSM states keep their heads split over model
    (``ssm.state_layout``): a layer's new state is written back with no
    all-gather of the heads of another rank."""
    got = world["got"]["mamba"]
    assert got["serve"]["ssm_placements"] == "(Shard(dim=1), Shard(dim=2))"
    assert got["state_gathers"] == []


def test_split_heads_train_in_float64_equals_one_process(world):
    """rwkv6's blocks on local tensors (heads, towers and mixes split over
    ``model``, explicit collectives) in float64 on (2, 2): loss and every
    gradient leaf as one process's to float64's rounding (the same math
    in another order; in float32 rounding moves the embedding's gradient
    ~2e-6)."""
    got, want = world["got"]["wide"][WIDE_ARCH], world["want"]["wide"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-13)
    g = _leaves(got["grads"], lambda x: isinstance(x, np.ndarray))
    w = _leaves(want["grads"], lambda x: isinstance(x, np.ndarray))
    assert g.keys() == w.keys()
    for path in g:
        scale = np.abs(w[path]).max()
        np.testing.assert_allclose(g[path], w[path], rtol=0,
                                   atol=1e-12 * max(scale, 1.0),
                                   err_msg=path)


@pytest.mark.parametrize("arch", BATCH1_ARCHS)
def test_serve_at_batch_1_on_2x2_equals_one_process(world, arch):
    """At batch 1 the data ranks hold the batch whole: each takes a part of
    its model rank's columns of the products (``context.Ranks``: rwkv6's
    blocks, ``column_product``, ``row_product``) and zamba2's a share of
    its channelized cache's KV heads (``ops.decode_attn``)."""
    got, want = world["got"]["batch1"][arch], world["want"]["batch1"][arch]
    # The hybrid family's logits tolerance, as above.
    tol = dict(rtol=1e-4, atol=1e-4) if arch == "zamba2-2.7b" else dict(
        rtol=RTOL, atol=1e-5)
    assert len(got["logits"]) == len(want)
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, **tol, err_msg=step)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
