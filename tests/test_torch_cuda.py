"""The port on the card: hand kernels against their plain versions.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode; their CPU counterparts are tested in the other
``test_torch_*`` files).  This file imports neither JAX nor ``repro``, so
it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import itertools

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv_wkv as kw
from repro_torch.kernels import stream as ks
from repro_torch.launch import serve
from repro_torch.models import Model, smoke_variant

import memsim_edge_inputs as edge

# float32: the reference's own kernel-test tolerance.  bfloat16: kernel and
# plain version both compute in fp32 and round once to bf16.
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-3),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _qkv(b, hq, hk, d, s, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=gen,
                                    dtype=torch.float32).to(dtype)
    return mk(b, hq, d), mk(b, s, hk, d), mk(b, s, hk, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,s", [
    (8, 32, 32, 64, 1056),      # stablelm-1.6b serving slice
    (8, 24, 2, 128, 4096),      # starcoder2-3b attention (G = 12)
    (8, 16, 16, 128, 1056),     # olmoe-1b-7b serving slice (D 128, G 1)
    (2, 4, 2, 16, 40),          # smoke variants (head dim 16)
    (3, 8, 1, 32, 300),         # G = 8, head dim 32
    (2, 96, 8, 128, 32768),     # a mistral-large-123b layer at 32k (G 12)
    (8, 32, 32, 80, 1056),      # zamba2-2.7b decode (head dim 80)
    (8, 64, 8, 128, 1056),      # qwen2-vl-72b decode (G 8, head dim 128)
])
def test_kernel_matches_plain(dtype, b, hq, hk, d, s):
    """Lengths 1 (at 32k for the mistral layer), a third, S - 1 and S."""
    _need_card()
    q, k, v = _qkv(b, hq, hk, d, s, dtype)
    for length in (1, s // 3, s - 1, s):
        got = da.decode_attn(q, k, v, length)
        want = ref.decode_attn_ref(q, k, v, length)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _assert_partials_close(got, want, dtype):
    """m within TOL, l within its rtol, acc through acc / l within TOL (the
    bf16 build rounds the probabilities before P V, as the ordinary build
    does, which moves acc by a share of its own size)."""
    (m, l, acc), (wm, wl, wacc) = got, want
    torch.testing.assert_close(m, wm, **TOL[dtype])
    torch.testing.assert_close(l, wl, rtol=TOL[dtype]["rtol"], atol=0.0)
    torch.testing.assert_close(acc / l[..., None], wacc / wl[..., None],
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,s", [
    (8, 32, 32, 64, 1056),      # stablelm-1.6b serving slice
    (8, 96, 8, 128, 4096),      # one rank's slice of a mistral-large layer
    (8, 24, 2, 128, 4096),      # starcoder2-3b attention (G = 12)
    (8, 32, 32, 80, 1056),      # zamba2-2.7b decode (head dim 80)
    (8, 64, 8, 128, 1056),      # qwen2-vl-72b decode (G 8, head dim 128)
])
def test_partials_match_plain(dtype, b, hq, hk, d, s):
    """K2's partial build against ``decode_attn_partials_ref`` at lengths
    1, a third, S - 1 and S; at length 0 the terms of no key."""
    _need_card()
    q, k, v = _qkv(b, hq, hk, d, s, dtype, seed=3)
    for length in (1, s // 3, s - 1, s):
        _assert_partials_close(da.decode_attn_partials(q, k, v, length),
                               ref.decode_attn_partials_ref(q, k, v, length),
                               dtype)
    m, l, acc = da.decode_attn_partials(q, k, v, 0)
    assert torch.equal(m, torch.full_like(m, -1e30))
    assert not l.any() and not acc.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pieces,length", [(2, 32768), (4, 32768),
                                           (8, 32768), (8, 20000), (4, 1)])
def test_merged_slices_equal_one_launch(dtype, pieces, length):
    """A mistral-large layer's cache cut into sequence slices, the partial
    build on each and ``ops.merge_partials`` over them: one K2 launch over
    the whole cache, within TOL (at 20,000 keys of 8 slices the last three
    are empty)."""
    _need_card()
    q, k, v = _qkv(2, 96, 8, 128, 32768, dtype, seed=4)
    w = 32768 // pieces
    terms = [da.decode_attn_partials(
        q, k[:, i * w:(i + 1) * w].contiguous(),
        v[:, i * w:(i + 1) * w].contiguous(), min(max(length - i * w, 0), w))
        for i in range(pieces)]
    m, l, acc = (torch.stack(x) for x in zip(*terms))
    got = ops.merge_partials(m, l, acc, q.dtype,
                             lambda x: x.amax(0, keepdim=True),
                             lambda x: x.sum(0))
    torch.testing.assert_close(got.float(),
                               da.decode_attn(q, k, v, length).float(),
                               **TOL[dtype])


def test_partials_refuse_a_length_outside_the_cache():
    _need_card()
    q, k, v = _qkv(2, 4, 2, 16, 40, torch.float32)
    for length in (-1, 41):
        with pytest.raises(ValueError, match="outside"):
            da.decode_attn_partials(q, k, v, length)
    with pytest.raises(ValueError, match="outside"):
        da.decode_attn(q, k, v, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [1, 3, 8, 16])
def test_kernel_matches_plain_at_part_and_tile_edges(dtype, parts):
    """A split forced to ``parts``: lengths that leave most parts empty
    (1, 2) and lengths one either side of a tile and a part boundary."""
    _need_card()
    q, k, v = _qkv(2, 24, 2, 128, 4096, dtype, seed=2)
    tile = da.TILE_KEYS
    for length in (1, 2, tile - 1, tile, tile + 1, 4 * tile - 1, 4 * tile,
                   4 * tile + 1, 4095, 4096):
        part = da.split(parts, length).part_keys
        for n in (length, min(part + 1, 4096), max(part - 1, 1)):
            got = da._launch(q, k, v, n, da.split(parts, n))
            want = ref.decode_attn_ref(q, k, v, n)
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [None, 3, 16])
def test_kernel_counts_each_boundary_key_once(dtype, parts):
    """The keys either side of each part boundary of the split taken at a
    length, of the first tile and of the length dominate the softmax (every
    query head of a KV head is q0, they are 4 q0), each carrying its own
    dimension in v: a key dropped, counted twice or read past length moves
    the output by >= 4/(n+1), where random inputs hide it under the
    tolerance."""
    _need_card()
    b, hq, hk, d, s = 2, 24, 2, 128, 4096
    q, k, v = _qkv(b, hq, hk, d, s, dtype, seed=5)
    q0 = q.view(b, hk, hq // hk, d)[:, :, 0]
    q = q0[:, :, None].expand(b, hk, hq // hk, d).reshape(b, hq, d)
    q = q.contiguous()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for length in (1, 65, 961, 1025, 2049, 4095, 4096):
        cut = (da.partition(b, hk, length, sms) if parts is None
               else da.split(parts, length))
        edges = [da.TILE_KEYS, length] + [
            p * cut.part_keys for p in range(1, cut.parts)
            if p * cut.part_keys < length]
        keys = sorted({x + dx for x in edges for dx in (-1, 0)
                       if 0 <= x + dx < s})
        kk, vv = k.clone(), v.clone()
        kk[:, keys] = 4 * q0[:, None]
        vv[:, keys] = 0
        for i, n in enumerate(keys):
            vv[:, n, :, i] = 4
        got = da._launch(q, kk, vv, length, cut)
        want = ref.decode_attn_ref(q, kk, vv, length)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_back_to_back_at_alternating_shapes(dtype):
    """Calls at alternating shapes, splits and lengths, queued without a
    synchronize, each held to the plain version: no merge state may carry
    from one launch to the next."""
    _need_card()
    shapes = [(8, 24, 2, 128, 4096), (8, 32, 32, 64, 1056),
              (2, 96, 8, 128, 8192), (8, 32, 32, 80, 1056)]
    inputs = [_qkv(*shape, dtype, seed=i) for i, shape in enumerate(shapes)]
    calls = [(i, length) for length in (1, 700, 1040) for i in range(4)]
    got = [da.decode_attn(*inputs[i], n) for i, n in calls + calls[::-1]]
    for (i, n), out in zip(calls + calls[::-1], got):
        want = ref.decode_attn_ref(*inputs[i], n)
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_ignores_poisoned_tail(dtype):
    _need_card()
    q, k, v = _qkv(2, 8, 2, 64, 700, dtype, seed=1)
    clean = da.decode_attn(q, k, v, 333)
    k[:, 333:], v[:, 333:] = 1e4, -1e4
    assert torch.equal(da.decode_attn(q, k, v, 333), clean)


def test_dispatch_launches_on_cuda_and_raises_on_bad_input():
    _need_card()
    q, k, v = _qkv(1, 4, 2, 64, 64, torch.float32)
    before = da.KERNEL.launches
    ops.decode_attn(q, k, v, 10)
    assert da.KERNEL.launches == before + 1
    with pytest.raises(ValueError, match="outside"):
        ops.decode_attn(q, k, v, 0)
    with pytest.raises(TypeError):
        ops.decode_attn(q.half(), k.half(), v.half(), 10)
    strided = torch.zeros(1, 64, 2, 128, device="cuda")[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attn(q, strided, strided, 10)
    with pytest.raises(ValueError, match="mixed"):
        ops.decode_attn(q.cpu(), k, v, 10)
    q72, k72, v72 = _qkv(1, 4, 2, 72, 64, torch.float32)  # no such head dim
    with pytest.raises(ValueError, match="no kernel built"):
        ops.decode_attn(q72, k72, v72, 10)
    with pytest.raises(ValueError, match="parts"):
        da._launch(q, k, v, 10, da.split(da.MAX_PARTS + 1, 10))
    assert da.KERNEL.launches == before + 1


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-3b",
                                  "olmoe-1b-7b", "zamba2-2.7b",
                                  "qwen2-vl-72b"])
def test_decode_step_kernel_path_matches_plain_path(arch):
    """float32 smoke model: the decode step through the kernel and through
    the plain decode_attention give the same logits (qwen2-vl's prompt
    carries the pipeline's vision rows and M-RoPE positions)."""
    _need_card()
    cfg = smoke_variant(get_config(arch))
    m = Model(cfg)
    params = m.init(0)
    batch = SyntheticDataset(cfg, 2, 17, seed=3).batch_at(0)
    prompt = {k: v[:, :16] for k, v in batch.items()
              if k not in ("targets", "loss_mask")}
    step = {k: batch[k][:, 16:17] for k in ("tokens", "positions")}
    _, cache = m.prefill(params, prompt, m.make_cache(2, 20))
    # A pass writes its cache in place (a hybrid model's Mamba states
    # too): each path's step starts from its own copy.
    copy = {k: (t.clone() if torch.is_tensor(t) else t)
            for k, t in cache.items()}
    a, _ = m.decode_step(params, step, cache)
    b, _ = m.decode_step(params, step, copy, plain_kernels=True)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_vlm_one_token_prompt_with_vision_embeds_runs_on_the_card():
    """bf16 qwen2-vl: a one-token prompt that carries vision embeddings
    runs in float32 activations (as the reference's does), so its
    attention meets the bf16 cache upcast: one launch of the kernel's
    float32 build a layer, equal to the plain path."""
    _need_card()
    cfg = smoke_variant(get_config("qwen2-vl-72b"), dtype="bfloat16")
    m = Model(cfg)
    params = m.init(0)
    batch = SyntheticDataset(cfg, 2, 1, seed=3).batch_at(0)
    prompt = {k: v for k, v in batch.items()
              if k not in ("targets", "loss_mask")}
    before = da.KERNEL.launches
    a, _ = m.prefill(params, prompt, m.make_cache(2, 4))
    assert da.KERNEL.launches - before == cfg.n_layers
    b, _ = m.prefill(params, prompt, m.make_cache(2, 4), plain_kernels=True)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b",
                                  "zamba2-2.7b", "qwen2-vl-72b"])
def test_serve_smoke_launches_the_kernel_every_layer_and_step(arch):
    """Once a step for every attention layer: zamba2's shared block runs
    once a group of ``attn_every`` Mamba layers."""
    _need_card()
    cfg = smoke_variant(get_config(arch))
    attn_layers = cfg.n_layers // (
        cfg.attn_every if cfg.family == "hybrid" else 1)
    before = da.KERNEL.launches
    toks = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "10", "--gen", "4"])
    assert toks.shape == (2, 4)
    assert da.KERNEL.launches - before == 4 * attn_layers


# ---------------------------------------------------------------------------
# wkv (K3)
# ---------------------------------------------------------------------------

# The reference's own wkv kernel-test tolerance.  It holds for bf16 r/k/v
# too: kernel and plain version read the same bf16 values and compute in
# fp32.
WKV_TOL = dict(atol=1e-4, rtol=1e-4)


def _wkv_inputs(b, t, h, d, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    r, k, v = (mk(b, t, h, d).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(mk(b, t, h, d) - 3.0))   # time_mix's range
    return r, k, v, w, mk(h, d), mk(b, h, d, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,d", [
    (8, 1, 32, 64),         # rwkv6-1.6b decode step
    (2, 300, 32, 64),       # rwkv6-1.6b prefill, ragged length
    (2, 77, 4, 32),         # the reference tests' head dims
    (3, 40, 4, 16),         # smoke variant (head dim 16)
])
def test_wkv_kernel_matches_plain(dtype, b, t, h, d):
    _need_card()
    args = _wkv_inputs(b, t, h, d, dtype)
    y, s = kw.wkv(*args)
    y_ref, s_ref = ref.wkv_ref(*args)
    assert y.dtype == s.dtype == torch.float32
    torch.testing.assert_close(y, y_ref, **WKV_TOL)
    torch.testing.assert_close(s, s_ref, **WKV_TOL)


def _chunk_steps(dtype, d):
    """The kernel's steps a chunk for r/k/v of ``dtype``, as the built
    library reports it."""
    return kw.geometry(dtype, (1, 2, 1, d))["chunk_steps"]


# Sequence lengths around the kernel's chunk of tc steps.
CHUNK_EDGES = {"1": lambda tc: 1, "tc-1": lambda tc: tc - 1,
               "tc": lambda tc: tc, "tc+1": lambda tc: tc + 1,
               "2tc+1": lambda tc: 2 * tc + 1, "1024": lambda tc: 1024}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("length", list(CHUNK_EDGES))
def test_wkv_kernel_matches_plain_at_chunk_edges(dtype, d, length):
    """Lengths at and around the chunk's edges; B * H = 15 blocks, not a
    multiple of the blocks an SM holds."""
    _need_card()
    t = CHUNK_EDGES[length](_chunk_steps(dtype, d))
    args = _wkv_inputs(3, t, 5, d, dtype, seed=t + d)
    y, s = kw.wkv(*args)
    y_ref, s_ref = ref.wkv_ref(*args)
    torch.testing.assert_close(y, y_ref, **WKV_TOL)
    torch.testing.assert_close(s, s_ref, **WKV_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cut", ["53", "tc", "2tc", "2tc+1"])
def test_wkv_kernel_chains_bit_exactly(dtype, cut):
    """wkv over T equals two chained pieces, bit for bit, cut inside a
    chunk (53) or exactly at a chunk's edge."""
    _need_card()
    tc = _chunk_steps(dtype, 64)
    at = {"53": 53, "tc": tc, "2tc": 2 * tc, "2tc+1": 2 * tc + 1}[cut]
    r, k, v, w, u, s0 = _wkv_inputs(2, 4 * tc + 3, 8, 64, dtype, seed=1)
    y, s = kw.wkv(r, k, v, w, u, s0)
    half = lambda x, sl: x[:, sl].contiguous()
    y1, s1 = kw.wkv(*(half(x, slice(0, at)) for x in (r, k, v, w)), u, s0)
    y2, s2 = kw.wkv(*(half(x, slice(at, None)) for x in (r, k, v, w)), u, s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(s2, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_geometry_reports_the_launch(dtype):
    """One block a (batch, head); a prefill stages its chunks in shared
    memory, a decode step takes none; the card holds the blocks."""
    _need_card()
    prefill = kw.geometry(dtype, (8, 1024, 32, 64))
    decode = kw.geometry(dtype, (8, 1, 32, 64))
    for geo in (prefill, decode):
        assert geo["blocks"] == 8 * 32
        assert geo["threads"] % 32 == 0
        assert geo["threads"] == 64 // geo["columns"] * geo["key_groups"]
        assert geo["blocks_per_sm"] >= 2
    assert prefill["smem_bytes"] > 0 and decode["smem_bytes"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_in_place_state_matches_out_of_place(dtype):
    """state_out = state (the decode cache's update) gives the same y and
    final state, bit for bit, as a new output state, also at a length of
    several chunks."""
    _need_card()
    for t in (1, 37, 3 * _chunk_steps(dtype, 64) + 5):
        r, k, v, w, u, s0 = _wkv_inputs(4, t, 32, 64, dtype, seed=t)
        y, s = kw.wkv(r, k, v, w, u, s0)
        state = s0.clone()
        y2, s2 = kw.wkv(r, k, v, w, u, state, state_out=state)
        assert s2 is state
        assert torch.equal(y2, y) and torch.equal(state, s)


def test_wkv_dispatch_launches_on_cuda_and_raises_on_bad_input():
    _need_card()
    r, k, v, w, u, s0 = _wkv_inputs(1, 5, 2, 32, torch.float32)
    before = kw.KERNEL.launches
    ops.wkv(r, k, v, w, u, s0)
    assert kw.KERNEL.launches == before + 1
    with pytest.raises(TypeError):                 # fp16 r/k/v
        ops.wkv(r.half(), k.half(), v.half(), w, u, s0)
    with pytest.raises(TypeError):                 # bf16 decay
        ops.wkv(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(TypeError):                 # mixed r/k/v types
        ops.wkv(r, k.bfloat16(), v, w, u, s0)
    strided = torch.zeros(1, 5, 2, 64, device="cuda")[..., :32]
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv(strided, k, v, w, u, s0)
    with pytest.raises(ValueError, match="shape|want"):
        ops.wkv(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="mixed"):
        ops.wkv(r.cpu(), k, v, w, u, s0)
    buf = torch.zeros(2 * s0.numel(), device="cuda")
    with pytest.raises(ValueError, match="overlaps"):
        ops.wkv(r, k, v, w, u, buf[:s0.numel()].view(s0.shape),
                state_out=buf[4:4 + s0.numel()].view(s0.shape))
    with pytest.raises(ValueError, match="no kernel built"):
        ops.wkv(*_wkv_inputs(1, 5, 2, 128, torch.float32))
    with pytest.raises(ValueError, match="no kernel built"):
        kw.geometry(torch.float32, (1, 5, 2, 128))
    assert kw.KERNEL.launches == before + 1


def test_rwkv_prefill_and_decode_kernel_path_match_plain_path():
    """float32 smoke rwkv6: prefill and a decode step through the kernel
    and through wkv_ref give the same logits and states."""
    _need_card()
    cfg = smoke_variant(get_config("rwkv6-1.6b"))
    m = Model(cfg)
    params = m.init(0)
    batch = SyntheticDataset(cfg, 2, 17, seed=3).batch_at(0)
    prompt = {k: batch[k][:, :16] for k in ("tokens", "positions")}
    step = {k: batch[k][:, 16:17] for k in ("tokens", "positions")}
    a, ca = m.prefill(params, prompt, m.make_cache(2, 17))
    b, cb = m.prefill(params, prompt, m.make_cache(2, 17),
                      plain_kernels=True)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ca["wkv"], cb["wkv"], **WKV_TOL)
    # Each decode step writes its cache in place: one from each prefill.
    a, _ = m.decode_step(params, step, ca)
    b, _ = m.decode_step(params, step, cb, plain_kernels=True)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_serve_smoke_launches_wkv_every_layer_and_pass():
    """rwkv6 serve: one wkv launch per layer for serve's prefill, for
    greedy_generate's prefill and for each decode step; no decode_attn."""
    _need_card()
    before = kw.KERNEL.launches, da.KERNEL.launches
    toks = serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--batch", "2",
                       "--prompt-len", "10", "--gen", "4"])
    assert toks.shape == (2, 4)
    n_layers = smoke_variant(get_config("rwkv6-1.6b")).n_layers
    assert (kw.KERNEL.launches - before[0],
            da.KERNEL.launches - before[1]) == ((4 + 2) * n_layers, 0)


# ---------------------------------------------------------------------------
# wkv's backward (K3b)
# ---------------------------------------------------------------------------

def _wkv_bwd_inputs(b, t, h, d, dtype, decay="model", ds_t=True, seed=0):
    """wkv's inputs, then dy and (or None) ds_t.  ``decay`` "model" is
    time_mix's exp(-exp(N(0,1) - 3)); "sigmoid" the reference test's
    sigmoid(N(0,1)) * 0.5 + 0.5."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    r, k, v = (mk(b, t, h, d).to(dtype) for _ in range(3))
    z = mk(b, t, h, d)
    w = torch.exp(-torch.exp(z - 3.0)) if decay == "model" else \
        torch.sigmoid(z) * 0.5 + 0.5
    u, s0, dy = mk(h, d), mk(b, h, d, d), mk(b, t, h, d)
    return r, k, v, w, u, s0, dy, (mk(b, h, d, d) if ds_t else None)


def assert_wkv_grads_close(got, want, dtype):
    """K3b against wkv_bwd_ref: every output within 1e-4 of its largest
    element (fp32 sums in another order over D and the same recurrence
    over T); dr, dk, dv in bf16 also within 1e-2 of themselves (both
    round once to bf16 from fp32 that may differ in its last bits)."""
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        rtol = 1e-2 if g.dtype == torch.bfloat16 else 0.0
        scale = x.float().abs().max().item()
        torch.testing.assert_close(g.float(), x.float(), rtol=rtol,
                                   atol=1e-4 * scale, msg=name)


SEG = kw.SEGMENT   # steps a segment of K3b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["model", "sigmoid"])
@pytest.mark.parametrize("ds_t", [False, True], ids=["dsT0", "dsT"])
@pytest.mark.parametrize("b,t,h,d", [
    (2, 1, 4, 16),          # one step
    (3, SEG - 1, 5, 16),    # a segment's edges
    (3, SEG, 5, 32),
    (3, SEG + 1, 5, 64),
    (2, 33, 3, 32),
    (2, 300, 32, 64),       # rwkv6-1.6b's heads, ragged length
    # one (batch, head), one block, at each D, below, at and one above a
    # segment
    (1, SEG - 1, 1, 16), (1, SEG, 1, 16), (1, SEG + 1, 1, 16),
    (1, SEG - 1, 1, 32), (1, SEG, 1, 32), (1, SEG + 1, 1, 32),
    (1, SEG - 1, 1, 64), (1, SEG, 1, 64), (1, SEG + 1, 1, 64),
    (1, 2 * SEG + 1, 1, 64),
])
def test_wkv_bwd_kernel_matches_plain(dtype, decay, ds_t, b, t, h, d):
    _need_card()
    r, k, v, w, u, s0, dy, dst = _wkv_bwd_inputs(b, t, h, d, dtype, decay,
                                                 ds_t, seed=t + d)
    got = kw.wkv_bwd(r, k, v, w, u, s0, dy, dst)
    want = ref.wkv_bwd_ref(r, k, v, w, u, s0, dy, dst)
    assert_wkv_grads_close(got, want, dtype)


def test_wkv_bwd_geometry_reports_the_launch():
    """One block a (batch, head), the wrapper's segment, whole warps of
    the tile, the card holding a block."""
    _need_card()
    for dtype, d in itertools.product((torch.float32, torch.bfloat16),
                                      kw.HEAD_DIMS_BWD):
        geo = kw.geometry_bwd(dtype, (8, 1024, 32, d))
        assert geo["blocks"] == 8 * 32 and geo["segment"] == kw.SEGMENT
        assert geo["threads"] % 32 == 0
        assert geo["threads"] * geo["keys"] * geo["columns"] == d * d
        assert geo["blocks_per_sm"] >= 1 and geo["smem_bytes"] > 0
        assert 0 < geo["registers"] <= 255


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_autograd_on_card_launches_k3_and_k3b(dtype):
    """ops.wkv under autograd on CUDA tensors: one K3 and one K3b launch;
    its gradients equal the plain path's (wkv_ref, wkv_bwd_ref)."""
    _need_card()
    r, k, v, w, u, s0, dy, _ = _wkv_bwd_inputs(2, 40, 4, 32, dtype)
    grads = {}
    for plain in (False, True):
        xs = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
        before = kw.KERNEL.launches, kw.KERNEL_BWD.launches
        y, s = ops.wkv(*xs, plain=plain)
        (y * dy).sum().backward()
        launched = (kw.KERNEL.launches - before[0],
                    kw.KERNEL_BWD.launches - before[1])
        assert launched == ((0, 0) if plain else (1, 1))
        grads[plain] = [x.grad for x in xs]
    assert_wkv_grads_close(grads[False], grads[True], dtype)


def test_wkv_bwd_raises_on_bad_input():
    _need_card()
    r, k, v, w, u, s0, dy, dst = _wkv_bwd_inputs(1, 5, 2, 32, torch.float32)
    before = kw.KERNEL_BWD.launches
    with pytest.raises(TypeError):                     # fp16 r/k/v
        kw.wkv_bwd(r.half(), k.half(), v.half(), w, u, s0, dy, dst)
    with pytest.raises(TypeError):                     # bf16 dy
        kw.wkv_bwd(r, k, v, w, u, s0, dy.bfloat16(), dst)
    with pytest.raises(ValueError, match="want"):
        kw.wkv_bwd(r, k, v, w, u, s0, dy[:, :2].contiguous(), dst)
    with pytest.raises(ValueError, match="no kernel built"):
        kw.wkv_bwd(*_wkv_bwd_inputs(1, 5, 2, 128, torch.float32))
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.wkv(r.requires_grad_(), k, v, w, u, s0, state_out=s0.clone())
    assert kw.KERNEL_BWD.launches == before


# ---------------------------------------------------------------------------
# STREAM (K1a-d)
# ---------------------------------------------------------------------------

def _stream_inputs(shape, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
            for _ in range(2)]


def _stream_pairs(a, b, alpha):
    return {"copy": (ks.stream_copy(a), ref.stream_copy_ref(a)),
            "scale": (ks.stream_scale(a, alpha),
                      ref.stream_scale_ref(a, alpha)),
            "add": (ks.stream_add(a, b), ref.stream_add_ref(a, b)),
            "triad": (ks.stream_triad(a, b, alpha),
                      ref.stream_triad_ref(a, b, alpha))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (128, 128), (300, 128),     # the reference tests' shapes
    (1,), (7,), (4099,),        # shorter than a vector, ragged tails
    (2**20 + 3,),
])
def test_stream_kernels_equal_plain(dtype, shape):
    """Bit for bit: alpha 0.1 is not exact in bf16, so the kernels must
    round it, and the triad, as the plain versions do."""
    _need_card()
    a, b = _stream_inputs(shape, dtype)
    for name, (got, want) in _stream_pairs(a, b, 0.1).items():
        assert got.shape == want.shape and got.dtype == dtype, name
        assert torch.equal(got, want), name
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(ks.stream_copy(a).view(bits), a.view(bits))


def test_stream_kernels_count_one_launch_a_call_and_raise_on_bad_input():
    _need_card()
    a, b = _stream_inputs(1000, torch.float32)
    before = {n: k.launches for n, k in ks.KERNELS.items()}
    ops.stream_copy(a)
    ops.stream_scale(a, 2.0)
    ops.stream_add(a, b)
    ops.stream_triad(a, b, 2.0)
    assert {n: k.launches - before[n] for n, k in ks.KERNELS.items()} == \
        dict.fromkeys(ks.KERNELS, 1)
    with pytest.raises(TypeError):                  # fp16
        ops.stream_copy(a.half())
    with pytest.raises(TypeError):                  # mixed types
        ops.stream_add(a, b.bfloat16())
    with pytest.raises(ValueError, match="shapes"):
        ops.stream_add(a, b[:999])
    with pytest.raises(ValueError, match="aligned"):   # 4-byte offset
        ops.stream_triad(a[1:], b[1:], 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.stream_scale(a.view(10, 100).t(), 2.0)
    with pytest.raises(ValueError, match="mixed"):
        ops.stream_add(a, b.cpu())
    assert {n: k.launches - before[n] for n, k in ks.KERNELS.items()} == \
        dict.fromkeys(ks.KERNELS, 1)


# --- memsim stage B: the two scan kernels (K4, K5) --------------------------

def _memsim_stage_a(lanes, harvest, outstanding, chunk=1024, seed=0):
    from repro_torch.core import memsim, threefry
    cfgs = [memsim.ChannelConfig(rho=0.05 + 0.9 * i / lanes,
                                 kappa=1.0 + (i % 4) * 0.7,
                                 outstanding=outstanding,
                                 harvest_duty=0.3 if harvest else 0.0,
                                 harvest_bw_gbps=20.0 if harvest else 0.0)
            for i in range(lanes)]
    c = memsim.stack_channels(cfgs, device="cuda")
    t = memsim._channel_terms(c)
    ids = torch.arange(lanes, device="cuda")
    key = threefry.split(threefry.prng_key(seed, "cuda"), 2)[1]
    return memsim, c, t, ids, key


@pytest.mark.parametrize("lanes", [37, 1000])
@pytest.mark.parametrize("harvest", [False, True])
@pytest.mark.parametrize("outstanding", [4.0, float("inf")])
@pytest.mark.parametrize("chunk", [1024, 1021])
def test_memsim_scans_match_plain(lanes, harvest, outstanding, chunk):
    """K4 and K5 equal ref.ts_scan_ref / ref.event_scan_ref bit for bit on
    stage-A draws made on the card, over two chained chunks (1021 steps is
    not a multiple of the kernels' stage of steps)."""
    _need_card()
    from repro_torch.kernels import memsim_scan as ms
    memsim, c, t, ids, key = _memsim_stage_a(lanes, harvest, outstanding)
    terms = memsim._ts_terms(c, t)
    carry = [torch.stack([torch.zeros(lanes), torch.ones(lanes),
                          torch.zeros(lanes)]).cuda() for _ in range(2)]
    hist = [torch.zeros((lanes, ms.N_BINS), dtype=torch.int32,
                        device="cuda") for _ in range(2)]
    for k in range(2):
        draws = memsim._ts_draws(c, t, ids, key, chunk)
        hu = memsim._ts_harvest_u(ids, key, chunk) if harvest else None
        ms.ts_scan(terms, carry[0], *draws, hu, 100 * k, 900, hist[0])
        ref.ts_scan_ref(terms, carry[1], *draws, hu, 100 * k, 900, hist[1])
        assert torch.equal(carry[0], carry[1])
        assert torch.equal(hist[0], hist[1])
    tabs = memsim._event_tables(c, t, ids, key, 64)
    ev_terms = memsim._event_terms(c, t)
    w = [torch.zeros(lanes, device="cuda") for _ in range(2)]
    state = (torch.zeros(lanes, device="cuda"),
             torch.zeros(lanes, device="cuda"))
    for k in range(2):
        state, gaps, svc, rec = memsim._event_arrivals(
            c, t, state, ids, key, tabs, 100, chunk)
        ms.event_scan(ev_terms, w[0], gaps, svc, rec, hist[0])
        ref.event_scan_ref(ev_terms, w[1], gaps, svc, rec, hist[1])
        assert torch.equal(w[0], w[1])
        assert torch.equal(hist[0], hist[1])
    assert int(hist[0].sum()) > 0


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("harvest", [False, True], ids=["plain", "harvest"])
@pytest.mark.parametrize("window", edge.WINDOWS)
def test_memsim_ts_scan_edges_match_plain(window, harvest):
    """K4 on the crafted edges of tests/memsim_edge_inputs.py (a backlog at
    the bound, draws at their thresholds, services 0, -0, inf and NaN,
    latencies on bin edges, past 4,096 ns and below 0, bound inf) equals
    ref.ts_scan_ref: carries by bit pattern, histograms exactly."""
    _need_card()
    import numpy as np

    from repro_torch.core.memsim import TS_TERMS
    from repro_torch.kernels import memsim_scan as ms
    terms, carry, chunks = edge.ts_inputs(harvest)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    p_terms = t(np.stack([terms[k] for k in TS_TERMS]))
    carries = [t(np.stack(carry)) for _ in range(2)]
    n = p_terms.shape[1]
    hists = [torch.zeros((n, ms.N_BINS), dtype=torch.int32, device="cuda")
             for _ in range(2)]
    for sw, au, jit_ns, svc, hu in chunks:
        args = (t(sw), t(au), t(jit_ns), t(svc), t(hu) if harvest else None,
                *window)
        ms.ts_scan(p_terms, carries[0], *args, hists[0])
        ref.ts_scan_ref(p_terms, carries[1], *args, hists[1])
        assert torch.equal(_bits(carries[0]), _bits(carries[1]))
        assert torch.equal(hists[0], hists[1])


@pytest.mark.parametrize("window", edge.WINDOWS)
def test_memsim_event_scan_edges_match_plain(window):
    """K5 on the crafted edges (a wait at the bound, services 0, -0, inf
    and NaN, a wait of -0 with gap 0 and service -0, latencies on bin
    edges, past 4,096 ns and below 0, bound inf) equals
    ref.event_scan_ref: carries by bit pattern, histograms exactly."""
    _need_card()
    import numpy as np

    from repro_torch.kernels import memsim_scan as ms
    terms, w0, chunks = edge.event_inputs(window)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    p_terms = t(np.stack([terms["bound"], terms["lat0"]]))
    ws = [t(w0) for _ in range(2)]
    n = p_terms.shape[1]
    hists = [torch.zeros((n, ms.N_BINS), dtype=torch.int32, device="cuda")
             for _ in range(2)]
    for gaps, svc, rec in chunks:
        args = (t(gaps), t(svc), t(rec))
        ms.event_scan(p_terms, ws[0], *args, hists[0])
        ref.event_scan_ref(p_terms, ws[1], *args, hists[1])
        assert torch.equal(_bits(ws[0]), _bits(ws[1]))
        assert torch.equal(hists[0], hists[1])


@pytest.mark.parametrize("lanes", [1, 31, 32, 33])
@pytest.mark.parametrize("chunk", ["1", "D-1", "D", "D+1", "1021"])
def test_memsim_scans_match_plain_at_ring_edges(lanes, chunk):
    """K4 and K5 equal their plain versions bit for bit at the edges of
    their 32-lane blocks and of their ring of D steps (ms.ring_steps()),
    over two chained chunks, harvest on for the timestep scan, record
    windows that start and end inside a stage of the ring."""
    _need_card()
    from repro_torch.kernels import memsim_scan as ms
    depth = ms.ring_steps()
    steps = {"1": 1, "D-1": depth - 1, "D": depth, "D+1": depth + 1,
             "1021": 1021}[chunk]
    memsim, c, t, ids, key = _memsim_stage_a(lanes, True, 4.0)
    terms = memsim._ts_terms(c, t)
    carry = [torch.stack([torch.zeros(lanes), torch.ones(lanes),
                          torch.zeros(lanes)]).cuda() for _ in range(2)]
    hist = [torch.zeros((lanes, ms.N_BINS), dtype=torch.int32,
                        device="cuda") for _ in range(2)]
    for k, (lo, hi) in enumerate([(steps // 3 + 3, steps),
                                  (0, 2 * steps // 3 + 1)]):
        draws = memsim._ts_draws(c, t, ids, key, steps)
        hu = memsim._ts_harvest_u(ids, key, steps)
        ms.ts_scan(terms, carry[0], *draws, hu, lo, hi, hist[0])
        ref.ts_scan_ref(terms, carry[1], *draws, hu, lo, hi, hist[1])
        assert torch.equal(carry[0], carry[1])
        assert torch.equal(hist[0], hist[1])
    tabs = memsim._event_tables(c, t, ids, key, 64)
    ev_terms = memsim._event_terms(c, t)
    w = [torch.zeros(lanes, device="cuda") for _ in range(2)]
    state = (torch.zeros(lanes, device="cuda"),
             torch.zeros(lanes, device="cuda"))
    for _ in range(2):
        state, gaps, svc, rec = memsim._event_arrivals(
            c, t, state, ids, key, tabs, 0, steps)
        ms.event_scan(ev_terms, w[0], gaps, svc, rec, hist[0])
        ref.event_scan_ref(ev_terms, w[1], gaps, svc, rec, hist[1])
        assert torch.equal(w[0], w[1])
        assert torch.equal(hist[0], hist[1])


def test_memsim_simulate_card_equals_cpu():
    """The whole DES on the card equals the same code on the CPU."""
    _need_card()
    import numpy as np

    from repro_torch.core import memsim
    cfgs = [memsim.ChannelConfig(rho=r, kappa=k) for r in (0.2, 0.5, 0.8)
            for k in (1.0, 2.5)]
    for engine in memsim.ENGINES:
        a = memsim.simulate(cfgs, steps=20_000, reps=2, engine=engine,
                            device="cuda")
        b = memsim.simulate(cfgs, steps=20_000, reps=2, engine=engine,
                            device="cpu")
        np.testing.assert_array_equal(a.hist, b.hist)


def test_memsim_scan_wrappers_refuse_bad_inputs():
    _need_card()
    from repro_torch.kernels import memsim_scan as ms
    n = 5
    terms, w = torch.zeros(2, n, device="cuda"), torch.zeros(n, device="cuda")
    gaps = torch.zeros(8, n, device="cuda")
    rec = torch.zeros(8, n, dtype=torch.bool, device="cuda")
    hist = torch.zeros(n, ms.N_BINS, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        ms.event_scan(terms, w, gaps.double(), gaps, rec, hist)
    with pytest.raises(ValueError):
        ms.event_scan(terms, w, gaps.t().contiguous().t(), gaps, rec, hist)
    with pytest.raises(ValueError):
        ms.event_scan(terms, w.cpu(), gaps, gaps, rec, hist)


# --- the QueueLUT and the memsim backend (core/queuelut, core/cpu_model) -------

LUT_GRID = dict(rho=(0.2, 0.5, 0.8), kappa=(1.0, 2.0),
                outstanding=(8.0, 64.0), eta=(0.3, 1.0))


@pytest.mark.parametrize("engine", ["event", "timestep"])
@pytest.mark.parametrize("harvest", [None, (0.0, 0.5)],
                         ids=["4d", "harvest"])
def test_queuelut_subgrid_build_card_equals_cpu(engine, harvest):
    """A QueueLUT built on the card equals the same build on the CPU bit
    for bit (its scans are K4/K5 there, the plain versions here)."""
    _need_card()
    from repro_torch.core import queuelut
    kw = dict(**LUT_GRID, steps=6_000, reps=2, engine=engine,
              harvest=harvest)
    card = queuelut.build_queue_lut(**kw, device="cuda")
    cpu = queuelut.build_queue_lut(**kw, device="cpu")
    for a, b in zip(card, cpu):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.device.type == "cpu" and torch.equal(a, b)


def _random_lut(harvest: bool, seed=0):
    import numpy as np

    from repro_torch.core import queuelut
    grids = [queuelut.DEFAULT_RHO_GRID, queuelut.DEFAULT_KAPPA_GRID,
             queuelut.DEFAULT_OUTSTANDING_GRID, queuelut.DEFAULT_ETA_GRID]
    if harvest:
        grids.append(queuelut.DEFAULT_HARVEST_GRID)
    rng = np.random.default_rng(seed)
    shape = tuple(len(g) for g in grids)
    tabs = [torch.from_numpy(rng.uniform(0, 400, shape).astype(np.float32))
            for _ in range(4)]
    g = [torch.tensor(x, dtype=torch.float32) for x in grids]
    return queuelut.QueueLUT(*g[:4], *tabs,
                             harvest_grid=g[4] if harvest else None)


def _two_point_lut():
    """The docstring's two-point surface (no interior grid nodes)."""
    from repro_torch.core.queuelut import QueueLUT
    z = torch.zeros((2, 2, 2, 2))
    w = z.clone()
    w[1] = 80.0
    g = lambda a, b: torch.tensor([a, b])
    return QueueLUT(g(0.0, 1.0), g(1.0, 2.0), g(1.0, 100.0), g(0.0, 1.0),
                    w, z, z, z)


@pytest.mark.parametrize("harvest", [False, True], ids=["4d", "harvest"])
def test_queuelut_lookup_on_card_equals_cpu(harvest):
    """Lookup and its gradients on CUDA tensors against the CPU: the same
    gathers and weights; only the order of the corner sum and the last bit
    of ``log`` may differ (1e-6 relative, or 4 float32 roundings of the
    largest table value)."""
    _need_card()
    lut = _random_lut(harvest)
    gen = torch.Generator().manual_seed(1)
    q = [torch.rand(500, generator=gen) * s + o for s, o in
         ((1.0, 0.0), (3.0, 0.8), (250.0, 1.0), (1.2, 0.0), (0.9, 0.0))]
    q = q[:5 if harvest else 4]
    xs = {d: [x.clone().to(d).requires_grad_(True) for x in q]
          for d in ("cpu", "cuda")}
    # QueueLUT.lookup itself, its tables on the CPU: it looks up where
    # the queries lie.
    outs = {d: lut.lookup(*xs[d]) for d in xs}
    atol = 4 * 2.0 ** -24 * 400.0
    for a, b, c in zip(outs["cuda"], outs["cpu"],
                       lut.tables("cuda").lookup(*xs["cuda"])):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b.detach(), rtol=1e-6, atol=atol)
        assert torch.equal(a, c)
    small = _two_point_lut()
    assert torch.equal(
        small.tables("cuda").lookup(0.5, 1.0, 10.0, 1.0)[0].cpu(),
        small.wait(0.5, 1.0, 10.0, 1.0))
    for d in xs:
        sum(o.sum() for o in outs[d]).backward()
    for a, b in zip(xs["cuda"], xs["cpu"]):
        # 4 float32 roundings of the largest |table| x dt/dx (1 / 0.02 on
        # the rho grid's finest interval).
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-5,
                                   atol=4 * 2.0 ** -24 * 400.0 * 50.0)


def test_memsim_solve_card_within_1e_5_of_cpu():
    """A memsim-backed solve on the card against the CPU, the same code in
    float32: settled elements within 1e-5 (phase 6's gate), an element
    still moving after the fixed point's last step within that step."""
    _need_card()
    import numpy as np

    from repro_torch.core import cpu_model
    lut = _random_lut(False)
    lut = lut._replace(**{f: getattr(lut, f).sort(dim=0).values * 0.2
                          for f in ("wait_ns", "p90_wait_ns",
                                    "p99_wait_ns", "sigma_ns")})
    solve = lambda device: cpu_model.solve_batch(
        cpu_model.DESIGNS, n_active_grid=(4, 12), queue_model="memsim",
        lut=lut, device=device)
    card, cpu = solve("cuda"), solve("cpu")
    cpu_model.FP_ITERS += 1
    try:
        nxt = solve("cuda")
    finally:
        cpu_model.FP_ITERS -= 1
    moving = np.abs(nxt.ipc - card.ipc) > 1e-5 * np.abs(card.ipc)
    for f in ("ipc", "latency_ns", "sigma_ns", "latency_p99_ns",
              "cpi_mem_p99"):
        a, b = getattr(card, f), getattr(cpu, f)
        step = np.where(moving, np.abs(getattr(nxt, f) - a), 0.0)
        assert np.isfinite(a).all(), f
        assert (np.abs(a - b) <= 1e-5 * np.abs(b) + step).all(), f


# --- the multi-device layer ---------------------------------------------------

def _need_cards(n):
    _need_card()
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards; torch sees "
                    f"{torch.cuda.device_count()}")


def test_sharded_des_asks_for_no_more_cards_than_there_are():
    _need_card()
    from repro_torch.core import memsim, shardsim
    n = torch.cuda.device_count()
    assert shardsim.resolve_devices("auto", device="cuda") == n
    with pytest.raises(ValueError, match="exceeds"):
        memsim.simulate([memsim.ChannelConfig(rho=0.5)], steps=2_000,
                        devices=n + 1)


@pytest.mark.parametrize("engine", ["timestep", "event"])
def test_sharded_des_on_two_cards_is_bit_identical(engine):
    _need_cards(2)
    import numpy as np

    from repro_torch.core import memsim
    cfgs = [memsim.ChannelConfig(rho=r) for r in (0.3, 0.5, 0.7, 0.8, 0.9)]
    kw = dict(steps=20_000, seed=2, reps=3, engine=engine)
    one = memsim.simulate(cfgs, devices=1, **kw)
    two = memsim.simulate(cfgs, devices=2, **kw)
    np.testing.assert_array_equal(one.hist, two.hist)


def test_kernels_run_on_local_shards_of_a_one_rank_mesh():
    """K2 and K3 take DTensors of a (1, 1) NCCL mesh: one launch each on
    the local shards, equal to their plain versions."""
    _need_card()
    import datetime

    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    store = dist.TCPStore("127.0.0.1", 0, world_size=1, is_master=True,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        q, k, v = _qkv(8, 32, 32, 64, 1056, torch.bfloat16, seed=4)
        before = da.KERNEL.launches
        got = ops.decode_attn(
            distribute_tensor(q, mesh, (Shard(0), Shard(1))),
            distribute_tensor(k, mesh, (Shard(0), Shard(1))),
            distribute_tensor(v, mesh, (Shard(0), Shard(1))), 1000)
        assert da.KERNEL.launches == before + 1
        torch.testing.assert_close(got.full_tensor().float(), ref.decode_attn_ref(
            q, k, v, 1000).float(), **TOL[torch.bfloat16])
        r, kk, vv, w, u, s0 = _wkv_inputs(2, 40, 4, 64, torch.bfloat16)
        dt = lambda x, *pl: distribute_tensor(x, mesh, pl)
        seq, st = (Shard(0), Shard(2)), (Shard(0), Shard(1))
        before = kw.KERNEL.launches
        y, s = ops.wkv(dt(r, *seq), dt(kk, *seq), dt(vv, *seq),
                       dt(w, *seq), dt(u, Shard(0), Shard(0)),
                       dt(s0, *st))
        assert kw.KERNEL.launches == before + 1
        want_y, want_s = ref.wkv_ref(r, kk, vv, w, u, s0)
        torch.testing.assert_close(y.full_tensor(), want_y, **WKV_TOL)
        torch.testing.assert_close(s.full_tensor(), want_s, **WKV_TOL)
    finally:
        dist.destroy_process_group()
