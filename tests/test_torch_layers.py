"""Each module of the port's serving slice against its reference function.

Identical numpy inputs go through ``repro.models.*`` (JAX, CPU) and
``repro_torch.models.*`` (PyTorch, CPU) in float32; outputs must agree to
rtol 1e-5 (atol 1e-6 for entries near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.config import smoke_variant as jsmoke
from repro_torch.configs import get_config
from repro_torch.models import attention, layers
from repro_torch.models.config import smoke_variant

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-6)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cfgs(arch):
    return smoke_variant(get_config(arch)), jsmoke(jget_config(arch))


def test_rms_norm():
    jx, tx = _both(_randn(0, 2, 5, 64))
    jw, tw = _both(0.1 * _randn(1, 64))
    _close(layers.rms_norm(tx, tw, 1e-5), jlayers.rms_norm(jx, jw, 1e-5))


@pytest.mark.parametrize("hq,hk,d", [(4, 2, 16), (8, 8, 64)])
def test_apply_rope(hq, hk, d):
    jq, tq = _both(_randn(2, 2, 7, hq, d))
    jk, tk = _both(_randn(3, 2, 7, hk, d))
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    jp, tp = _both(pos)
    got_q, got_k = layers.apply_rope(tq, tk, tp, d, 10_000.0)
    want_q, want_k = jlayers.apply_rope(jq, jk, jp, d, 10_000.0)
    _close(got_q, want_q)
    _close(got_k, want_k)


def _mrope_positions(b):
    """(b, 23, 3) qwen2-vl style M-RoPE positions whose t, h and w
    components differ: 3 text tokens, a 4 x 4 grid of image tokens (t
    fixed, h the row, w the column), then 4 text tokens; batch row i
    starts at 5 i.  (The synthetic pipeline's positions repeat one value
    in all three components, under which a wrong section table would
    pass.)"""
    rows = []
    for i in range(b):
        start = 5 * i
        text = [(start + j,) * 3 for j in range(3)]
        t0 = start + 3
        grid = [(t0, t0 + r, t0 + c) for r in range(4) for c in range(4)]
        after = [(t0 + 4 + j,) * 3 for j in range(4)]
        rows.append(text + grid + after)
    return np.asarray(rows, np.int32)


@pytest.mark.parametrize("sections,hq,hk,d", [((2, 3, 3), 4, 2, 16),
                                              ((16, 24, 24), 8, 1, 128)])
def test_apply_mrope(sections, hq, hk, d):
    """M-RoPE against the reference at the smoke variant's sections and
    qwen2-vl-72b's, on positions with distinct t/h/w components; the
    same call with the section table reversed must not match."""
    pos = _mrope_positions(2)
    jq, tq = _both(_randn(12, 2, pos.shape[1], hq, d))
    jk, tk = _both(_randn(13, 2, pos.shape[1], hk, d))
    jp, tp = _both(pos)
    want = jlayers.apply_rope(jq, jk, jp, d, 1_000_000.0, sections)
    got = layers.apply_rope(tq, tk, tp, d, 1_000_000.0, sections)
    for g, w in zip(got, want):
        _close(g, w)
    wrong = layers.apply_rope(tq, tk, tp, d, 1_000_000.0, sections[::-1])
    assert not np.allclose(wrong[0].numpy(), np.asarray(want[0]), **TOL)


def test_apply_mrope_rejects_flat_positions():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="M-RoPE"):
        layers.apply_rope(q, q, torch.zeros(1, 4, dtype=torch.int32), 16,
                          1e4, (2, 3, 3))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-3b"])
def test_mlp_apply(arch):
    cfg, jcfg = _cfgs(arch)
    assert cfg.activation == {"stablelm-1.6b": "swiglu",
                              "starcoder2-3b": "gelu"}[arch]
    names = ("wi", "wg", "wo") if cfg.activation == "swiglu" else ("wi", "wo")
    shapes = {"wi": (64, 128), "wg": (64, 128), "wo": (128, 64)}
    jp, tp = {}, {}
    for i, n in enumerate(names):
        jp[n], tp[n] = _both(0.1 * _randn(10 + i, *shapes[n]))
    jx, tx = _both(_randn(4, 2, 5, 64))
    _close(layers.mlp_apply(cfg, tp, tx), jlayers.mlp_apply(jcfg, jp, jx))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-3b",
                                  "qwen2-vl-72b"])
def test_qkv_project(arch):
    """qwen2-vl-72b: (B, S, 3) M-RoPE positions pass through unchanged."""
    cfg, jcfg = _cfgs(arch)
    specs = attention.attn_specs(cfg, layered=False)
    jp, tp = {}, {}
    for i, (n, spec) in enumerate(sorted(specs.items())):
        jp[n], tp[n] = _both(0.1 * _randn(20 + i, *spec.shape))
    if cfg.mrope_sections:
        pos = _mrope_positions(2)
    else:
        pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    jx, tx = _both(_randn(5, 2, pos.shape[1], cfg.d_model))
    jpos, tpos = _both(pos)
    for got, want in zip(attention.qkv_project(cfg, tp, tx, tpos),
                         jattn.qkv_project(jcfg, jp, jx, jpos)):
        _close(got, want)


@pytest.mark.parametrize("hq,hk", [(4, 2), (4, 4)])
def test_reference_attention(hq, hk):
    jq, tq = _both(_randn(6, 2, 9, hq, 16))
    jk, tk = _both(_randn(7, 2, 9, hk, 16))
    jv, tv = _both(_randn(8, 2, 9, hk, 16))
    _close(attention.reference_attention(tq, tk, tv),
           jattn.reference_attention(jq, jk, jv))


@pytest.mark.parametrize("sq,q_start", [(1, None), (1, 20), (5, 12),
                                        (16, 0)])
@pytest.mark.parametrize("hq,hk", [(4, 2), (4, 4)])
def test_decode_attention(sq, q_start, hq, hk):
    """Sq = 1 (a decode step) and Sq > 1 with q_start (prefill)."""
    s_max = 32
    jq, tq = _both(_randn(9, 2, sq, hq, 16))
    jk, tk = _both(_randn(10, 2, s_max, hk, 16))
    jv, tv = _both(_randn(11, 2, s_max, hk, 16))
    lens = np.array([21, 17], np.int32) if q_start is None else np.full(
        (2,), q_start + sq, np.int32)
    jl, tl = _both(lens)
    got = attention.decode_attention(tq, tk, tv, tl, q_start=q_start)
    want = jattn.decode_attention(jq, jk, jv, jl, q_start=q_start)
    _close(got, want)
