"""The port's own splits of the dry run's products (``distributed/context``
``Ranks``, ``column_product``, ``row_product``; ``models/rwkv``'s blocks on
local tensors), on the CPU.

DTensor's sharding propagation, left to choose a product's layout, chooses
differently in different torch versions (torch 2.11 ran rwkv6's WKV with
every head on every ``model`` rank, 2.13 some of its products whole), so a
dry run's FLOPs and collectives a chip depended on the version.  The port
now splits each product itself.  These tests run three cells at the
production mesh, on meta shards in a fake world, with the depth cut to two
layers: rwkv6-1.6b's ``train_4k`` on (32, 8), its ``prefill_32k`` on
(2, 32, 8) (each sequence in halves over ``pod``) and stablelm-1.6b's
``decode_32k`` on (32, 8).  Every matrix product the cost meter sees,
summed by op and local operand shapes (as ``tools/dryrun_products.py``
sums them), must carry the FLOPs of its global product over the ranks its
rule splits: the rows over the data ranks, the heads, the MLP's hidden
units and the vocabulary over the 8 ``model`` ranks, the low-rank towers'
columns and the mixes' features too.  A product that runs whole on a rank
where its rule splits it has other local shapes, or other FLOPs, and
fails.  The decode cell's collectives are held by kind as well: one
all-reduce into the residual stream after the attention and after the
MLP, none of DTensor's own.
"""

import collections
import dataclasses

import pytest
import torch.distributed as dist

from repro_torch.configs import get_config, get_shape
from repro_torch.core import hloparse
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

LAYERS = 2
DATA, MODEL = 32, 8


@pytest.fixture(autouse=True)
def no_world_left():
    """Each test leaves no process group behind."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _run(arch, shape, multi_pod, monkeypatch):
    """The cell at ``LAYERS`` layers: its products' FLOPs by (op, local
    operand shapes), and its result."""
    products = collections.Counter()
    count = hloparse.Meter._count

    def counted(self, name, func, args, out):
        if name in hloparse._DOTS:
            i = 1 if name in ("aten.addmm", "aten.baddbmm") else 0
            products[(name, tuple(args[i].shape),
                      tuple(args[i + 1].shape))] += hloparse._dot_flops(
                name, args, out)
        return count(self, name, func, args, out)

    monkeypatch.setattr(hloparse.Meter, "_count", counted)
    cfg = dataclasses.replace(get_config(arch), n_layers=LAYERS)
    dryrun.fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    res = dryrun.CellResult(arch=arch, shape=shape, mesh="", status="ok")
    dryrun.run_step(cfg, get_shape(shape), mesh, res)
    return products, res


class Expected:
    """The FLOPs by (op, local operand shapes) of products split as their
    rules say."""

    def __init__(self):
        self.flops = collections.Counter()

    def mm(self, m, k, n, forward=1, grads=True):
        """(m, k) @ (k, n), ``forward`` times forward (a remat layer's is
        recomputed in the backward), and with ``grads`` its backward: the
        gradient of the left (m, n) @ (n, k) and of the right
        (k, m) @ (m, n)."""
        f = 2.0 * m * k * n
        self.flops[("aten.mm", (m, k), (k, n))] += forward * f
        if grads:
            self.flops[("aten.mm", (m, n), (n, k))] += f
            self.flops[("aten.mm", (k, m), (m, n))] += f

    def bmm(self, g, m, k, n, forward=1):
        """g batches of (m, k) @ (k, n), with their backward."""
        f = 2.0 * g * m * k * n
        self.flops[("aten.bmm", (g, m, k), (g, k, n))] += forward * f
        self.flops[("aten.bmm", (g, m, n), (g, n, k))] += f
        self.flops[("aten.bmm", (g, k, m), (g, m, n))] += f


def _rwkv_train_step(tokens: int, rows: int, seq: int) -> Expected:
    """rwkv6-1.6b's train step (remat "full") on a rank that holds
    ``tokens`` tokens (``rows`` rows of ``seq``): every layer product split
    over the 8 model ranks, and the vocab-parallel loss head's 1,024-token
    chunks."""
    cfg = get_config("rwkv6-1.6b")
    d, f, r, v = cfg.d_model, cfg.d_ff, cfg.rwkv_lora_rank, cfg.vocab
    e = Expected()
    for _ in range(LAYERS):
        # Time mix: the tower's columns and the mixes' features, each
        # rank's heads of r, k, v, g and of the decay, its rows of wo.
        e.mm(tokens, d, 5 * r // MODEL, forward=2)
        e.bmm(5, tokens, r, d // MODEL, forward=2)
        for _ in ("wr", "wk", "wv", "wg"):
            e.mm(tokens, d, d // MODEL, forward=2)
        e.mm(tokens, d, r // MODEL, forward=2)
        e.mm(tokens, r, d // MODEL, forward=2)
        e.mm(tokens, d // MODEL, d, forward=2)
        # Channel mix: cm_wk's and cm_wr's columns, cm_wv's rows.
        e.mm(tokens, d, f // MODEL, forward=2)
        e.mm(tokens, d, d // MODEL, forward=2)
        e.mm(tokens, f // MODEL, d, forward=2)
    for _ in range(seq // 1024):
        e.mm(rows * 1024, d, v // MODEL)
    return e


def _assert_products(got, expected):
    assert set(got) == set(expected.flops), (
        f"unexpected products {sorted(set(got) - set(expected.flops))}, "
        f"missing {sorted(set(expected.flops) - set(got))}")
    for key, flops in expected.flops.items():
        assert got[key] == flops, (key, got[key], flops)


def test_rwkv_train_splits_every_product_over_data_and_model(monkeypatch):
    """rwkv6-1.6b ``train_4k`` on (32, 8): each data rank's 8 rows of
    4,096 tokens, every product's columns (or contracted rows) over the 8
    model ranks: 1/256 of the step's products on every rank."""
    got, res = _run("rwkv6-1.6b", "train_4k", False, monkeypatch)
    shape = get_shape("train_4k")
    rows = shape.global_batch // DATA
    _assert_products(got, _rwkv_train_step(rows * shape.seq_len, rows,
                                           shape.seq_len))
    assert res.flops_per_chip == sum(got.values()) + _wkv_charges(
        rows * shape.seq_len)


def test_rwkv_split_prefill_splits_every_product(monkeypatch):
    """rwkv6-1.6b ``prefill_32k`` on (2, 32, 8): 32 sequences in halves over
    ``pod``, one half of 16,384 tokens a data rank, each product split over
    the 8 model ranks as in the train step."""
    got, res = _run("rwkv6-1.6b", "prefill_32k", True, monkeypatch)
    assert res.seq_parts == 2
    half = get_shape("prefill_32k").seq_len // 2
    _assert_products(got, _rwkv_train_step(half, 1, half))
    assert res.flops_per_chip == sum(got.values()) + _wkv_charges(half)


def _wkv_charges(tokens: int) -> float:
    """The WKV stand-ins' charges a rank (``kernels/ops._wkv_meta`` and
    its backward): 4 T H D^2 forward, twice (remat), and 8 T H D^2
    backward, over the rank's 4 heads."""
    cfg = get_config("rwkv6-1.6b")
    heads = cfg.rwkv_heads // MODEL
    one = 4.0 * tokens * heads * cfg.rwkv_head_dim ** 2
    return LAYERS * (2 * one + 2 * one)


def test_dense_decode_splits_heads_mlp_and_vocabulary(monkeypatch):
    """stablelm-1.6b ``decode_32k`` on (32, 8): each data rank's 4 rows of
    one new token; each model rank's query, key and value heads, its rows
    of wo, its hidden units of the MLP and its vocabulary columns; and the
    attention's and the MLP's pending sums each one all-reduce of the
    rows' residual stream, as the embedding's lookup is."""
    got, res = _run("stablelm-1.6b", "decode_32k", False, monkeypatch)
    cfg = get_config("stablelm-1.6b")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    rows = get_shape("decode_32k").global_batch // DATA
    e = Expected()
    for _ in range(LAYERS):
        for heads in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads):
            e.mm(rows, d, heads * hd // MODEL, grads=False)
        e.mm(rows, cfg.n_heads * hd // MODEL, d, grads=False)
        e.mm(rows, d, f // MODEL, forward=2, grads=False)
        e.mm(rows, f // MODEL, d, grads=False)
    e.mm(rows, d, cfg.vocab // MODEL, grads=False)
    _assert_products(got, e)
    stream = rows * d * 2               # (4, 1, 2048) bfloat16
    assert res.collectives["all-reduce"] == pytest.approx(
        (1 + 2 * LAYERS) * stream + LAYERS * _merge_bytes(cfg, rows))
    assert res.collectives["reduce-scatter"] == 0
    assert res.collectives["all-to-all"] == 0


def _merge_bytes(cfg, rows: int) -> float:
    """The channelized decode's merge of a layer (``ops.merge_partials``):
    a float32 max all-reduce of (rows, heads) and a sum of (rows, heads,
    D + 1)."""
    heads = cfg.n_heads
    return 4.0 * rows * heads * (1 + cfg.resolved_head_dim + 1)
