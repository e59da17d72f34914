"""Sequences split over ``pod`` (context parallelism), on the CPU.

A train or prefill step whose batch does not divide its data ranks splits
each sequence into parts over the mesh's ``pod`` axis
(``distributed/sharding.split_sequences``): the batch's rows become the
parts, and the blocks hand what crosses a part's edge over the ranks that
share the sequences (``distributed/layout.SeqPair``): the token shift's
and the conv's tails, the WKV's and the SSD's states, attention's keys
and values, and the MoE's capacity order.

* The real 4-rank gloo world (``torch_mesh_worker``, its
  ``context_parallel`` job): a (pod 2, data 2, model 1) mesh, folded to
  (4, 1) for the step, batch 2: each rank holds half of one sequence.
  Each of the six families' smoke models (olmoe with tokens dropped) gives
  the one-process loss and gradients, and the reference's
  ``Model.loss`` on the same weights carried to it; every rank runs its
  own half of the WKV once (K3 and K3b's plain versions).
* ``ref.wkv_ref`` and ``ref.wkv_bwd_ref`` chained over two halves (the
  state handed forward, its gradient handed back) against one call over
  the whole sequence, the attention of a part's queries against the whole
  pass's rows, and the batch's re-indexing.
"""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worker
from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticDataset as JSyntheticDataset
from repro.models import Model as JModel
from repro.models.config import smoke_variant as jsmoke
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import step as pstep
from repro_torch.kernels import ref
from repro_torch.models import Model, attention, layers, smoke_variant

FAMILIES = ["stablelm-1.6b", "olmoe-1b-7b", "rwkv6-1.6b", "zamba2-2.7b",
            "qwen2-vl-72b", "hubert-xlarge"]
#: olmoe at a capacity factor of 1: 4 slots an expert for 32 tokens of
#: top 2 over 4 experts, so tokens overflow (the loss moves by 1e-2 from
#: the smoke config's), and the split must drop the one process's.
OVER = {"olmoe-1b-7b": dict(capacity_factor=1.0)}
B, S = 2, 32
# The split step against one process, float32: the same products summed
# in other orders (a contraction over the rows of two ranks; the SSD's
# initial state read out apart from its chunks, where the hybrid family's
# float32 SSD is sensitive to the order: ROADMAP §3).  The losses within
# RTOL (measured 8.0e-8 at most); each gradient leaf within LEAF_TOL of
# its largest element (measured 4.7e-7 at most; zamba2's 2.6e-5, a_log).
RTOL = 1e-5
LEAF_TOL = {"zamba2-2.7b": 1e-4}
LEAF_TOL_DEFAULT = 5e-6
# Against the reference's loss (XLA's float32 on the same weights):
# measured 7.9e-8 relative at most.
REF_RTOL = 1e-5


def _numpy(tree):
    return layers.map_tree(lambda t: t.detach().numpy(), tree)


def _leaves(tree):
    return dict(layers.flatten_tree(
        tree, is_leaf=lambda x: isinstance(x, np.ndarray)))


@pytest.fixture(scope="module")
def world():
    """One spawn of the world: each family's split step on it, and the
    one-process port's and the reference's values on the same weights."""
    payload, want = {}, {}
    for arch in FAMILIES:
        over = OVER.get(arch, {})
        cfg = smoke_variant(get_config(arch), **over)
        jm = JModel(jsmoke(jget_config(arch), **over))
        m = Model(cfg, device="cpu")
        # The port's weights carried to the reference: the same tree of
        # keys, shapes and layouts (``models/convert``).
        params = m.init(0)
        batch = {k: np.asarray(v) for k, v in
                 JSyntheticDataset(jm.cfg, B, S, seed=3).batch_at(0).items()}
        jloss, _ = jax.jit(jm.loss)(_numpy(params), batch)
        for _, p in layers.flatten_tree(params, torch.is_tensor):
            p.requires_grad_(True)
        calls = {"wkv_ref": 0, "wkv_bwd_ref": 0}
        saved = {name: getattr(ref, name) for name in calls}
        try:
            for name in calls:
                setattr(ref, name, lambda *a, _n=name: calls.__setitem__(
                    _n, calls[_n] + 1) or saved[_n](*a))
            loss, _ = m.loss(params, batch)
            grads = pstep._grads(loss, params)
        finally:
            for name, fn in saved.items():
                setattr(ref, name, fn)
        payload[arch] = dict(over=over, params=_numpy(params), batch=batch)
        want[arch] = dict(loss=loss.item(), grads=_numpy(grads),
                          ref_loss=float(jloss), calls=sorted(calls.items()))
    got = torch_mesh_worker.run_world("context_parallel", 4, payload)
    return dict(got=got, want=want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_split_step_loss_and_grads_equal_one_process(world, arch):
    got, want = world["got"][arch], world["want"][arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    g, w = _leaves(got["grads"]), _leaves(want["grads"])
    assert g.keys() == w.keys()
    tol = LEAF_TOL.get(arch, LEAF_TOL_DEFAULT)
    for path in g:
        top = np.abs(w[path]).max()
        assert top > 0 or not g[path].any(), path
        assert np.abs(g[path] - w[path]).max() <= tol * top, path


@pytest.mark.parametrize("arch", FAMILIES)
def test_split_step_loss_equals_reference(world, arch):
    np.testing.assert_allclose(world["got"][arch]["loss"],
                               world["want"][arch]["ref_loss"],
                               rtol=REF_RTOL)


def test_moe_split_drops_the_tokens_one_process_drops(world):
    """At capacity factor 1 tokens overflow, so the loss depends on which
    (token, slot)s keep their slots: ranked in the sequences' own (b, s)
    order, the split's loss is the one process's, away from the loss with
    no drop."""
    got = world["got"]["olmoe-1b-7b"]["loss"]
    m = Model(smoke_variant(get_config("olmoe-1b-7b")), device="cpu")
    batch = JSyntheticDataset(m.cfg, B, S, seed=3).batch_at(0)
    undropped = m.loss(m.init(0), batch)[0].item()
    assert abs(got - undropped) > 1e-3
    np.testing.assert_allclose(got, world["want"]["olmoe-1b-7b"]["loss"],
                               rtol=RTOL)


def test_each_rank_runs_its_half_of_the_wkv_once(world):
    """Every rank calls the WKV's forward and backward (K3 and K3b on the
    card) as often as one process does: each layer's forward and its
    remat recompute, and its backward, each on its own half."""
    got, want = world["got"]["rwkv6-1.6b"], world["want"]["rwkv6-1.6b"]
    assert dict(want["calls"])["wkv_bwd_ref"] > 0
    assert got["calls"] == [want["calls"]] * 4


def _wkv_inputs(t, seed=0):
    gen = np.random.default_rng(seed)
    rn = lambda *shape: torch.from_numpy(
        gen.standard_normal(shape).astype(np.float32))
    r, k, v = rn(2, t, 3, 8), rn(2, t, 3, 8), rn(2, t, 3, 8)
    w = torch.from_numpy(gen.uniform(0.5, 0.99, (2, t, 3, 8))
                         .astype(np.float32))
    return r, k, v, w, rn(3, 8), rn(2, 3, 8, 8), rn(2, t, 3, 8), \
        rn(2, 3, 8, 8)


def test_wkv_plain_versions_chained_over_two_halves_equal_one_call():
    """The two halves' forward from the first's final state, and their
    backward with the second's initial-state gradient handed back as the
    first's final-state gradient, equal one call over the whole sequence
    (the same steps in the same order: measured equal to 1e-6)."""
    t, h = 12, 6
    r, k, v, w, u, s0, dy, ds_t = _wkv_inputs(t)
    y, s = ref.wkv_ref(r, k, v, w, u, s0)
    grads = ref.wkv_bwd_ref(r, k, v, w, u, s0, dy, ds_t)
    first, second = (slice(None, h), slice(h, None))
    part = lambda x, sl: x[:, sl].contiguous()
    y0, s_mid = ref.wkv_ref(*(part(x, first) for x in (r, k, v, w)), u, s0)
    y1, s_end = ref.wkv_ref(*(part(x, second) for x in (r, k, v, w)), u,
                            s_mid)
    g1 = ref.wkv_bwd_ref(*(part(x, second) for x in (r, k, v, w)), u, s_mid,
                         part(dy, second), ds_t)
    g0 = ref.wkv_bwd_ref(*(part(x, first) for x in (r, k, v, w)), u, s0,
                         part(dy, first), g1[5])
    close = lambda a, b: np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    close(torch.cat([y0, y1], dim=1), y)
    close(s_end, s)
    for i in range(4):                      # dr, dk, dv, dw
        close(torch.cat([g0[i], g1[i]], dim=1), grads[i])
    close(g0[4] + g1[4], grads[4])          # du
    close(g0[5], grads[5])                  # ds0


@pytest.mark.parametrize("form", ["reference_attention", "flash_attention"])
def test_a_parts_queries_against_every_key_are_the_whole_pass_rows(form):
    """Causal attention of the second half's queries against the whole
    sequence's keys, the mask at their own positions (``q_start``), is
    the whole pass's second half, and the first half's the first."""
    attend = getattr(attention, form)
    gen = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(gen.standard_normal((1, 64, 4, 8))
                                .astype(np.float32)) for _ in range(3))
    kw = {"chunk": 16} if form == "flash_attention" else {}
    whole = attend(q, k, v, causal=True, **kw)
    for p in (0, 1):
        rows = slice(32 * p, 32 * (p + 1))
        got = attend(q[:, rows], k, v, causal=True, q_start=32 * p, **kw)
        np.testing.assert_allclose(got.numpy(), whole[:, rows].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_split_sequences_puts_part_p_of_sequence_b_in_row_p_b_plus_b():
    mesh = type("Mesh", (), {"mesh_dim_names": ("pod", "data", "model"),
                             "shape": (2, 4, 8)})()
    x = np.arange(3 * 8 * 2).reshape(3, 8, 2)
    got = shd.split_sequences(mesh, {"x": x, "t": x[..., 0]}, 2)
    assert got["x"].shape == (6, 4, 2) and got["t"].shape == (6, 4)
    for p in (0, 1):
        for b in range(3):
            np.testing.assert_array_equal(got["x"][p * 3 + b],
                                          x[b, 4 * p:4 * (p + 1)])
    with pytest.raises(ValueError, match="parts a sequence over a pod"):
        shd.split_sequences(mesh, {"x": x}, 4)
    with pytest.raises(ValueError, match="does not split"):
        shd.split_sequences(mesh, {"x": x[:, :7]}, 2)
    # 32 sequences on 64 data ranks split in two; 32 of 4,095 tokens or
    # 16 sequences do not.
    assert shd.sequence_parts(mesh, 32, 32768) == 1
    big = type("Mesh", (), {"mesh_dim_names": ("pod", "data", "model"),
                            "shape": (2, 32, 8)})()
    assert shd.sequence_parts(big, 32, 32768) == 2
    assert shd.sequence_parts(big, 64, 4096) == 1
    for batch, seq in ((32, 4095), (16, 32768)):
        with pytest.raises(ValueError, match="does not divide"):
            shd.sequence_parts(big, batch, seq)
