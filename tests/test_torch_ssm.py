"""The port's Mamba2 (SSD) block against the reference, and the hybrid
and vlm parameter trees and caches.

``repro_torch.models.ssm`` against ``repro.models.ssm`` on zamba2-2.7b's
smoke widths (d_model 64, d_inner 128, 8 heads of 16, state 16, conv 4)
in float32, on identical seeded numpy inputs and parameters: all three
branches of ``mamba_apply`` (a prefill with no state, a prefill continued
from a carried state, the recurrent decode step), their conv windows,
``_ssd_chunked`` and ``_causal_conv`` directly, and ``init_ssm_cache``;
then ``params_from_jax`` on zamba2's ``shared_attn`` and qwen2-vl's
``frontend`` subtrees, and the hybrid decode cache's layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.models.config import smoke_variant as jsmoke
from repro_torch.configs import get_config
from repro_torch.models import smoke_variant, ssm, transformer
from repro_torch.models.convert import params_from_jax

# float32, the same formulas on the same inputs: only the order of the
# sums inside the products differs between the two libraries (and the
# order in which the three-operand einsums are contracted).
TOL = dict(rtol=1e-4, atol=1e-5)
B = 2


@pytest.fixture(scope="module")
def cfgs():
    return (smoke_variant(get_config("zamba2-2.7b")),
            jsmoke(jget_config("zamba2-2.7b")))


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def params(cfgs):
    """One layer's parameters, every leaf random (the spec's zeros would
    leave a_log, dt_bias, d_skip and gate_norm untested)."""
    cfg, _ = cfgs
    rng = np.random.default_rng(0)
    specs = ssm.ssm_specs(cfg, layered=False)
    out = {name: _randn(rng, *spec.shape, scale=0.5)
           for name, spec in specs.items()}
    out["in_proj"] *= 2 * cfg.d_model ** -0.5
    out["out_proj"] *= 2 * cfg.d_inner ** -0.5
    return out


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=what)


def _x(seed, s, d):
    return _randn(np.random.default_rng(seed), B, s, d)


def _check_step(cfg, jcfg, params, x, state=None, what=""):
    """One ``mamba_apply`` on both sides from the same (numpy) state;
    returns the reference's new state as numpy."""
    jp, tp = _both(params)
    jst = tst = (None, None)
    if state is not None:
        jst = tuple(jnp.asarray(a) for a in state)
        tst = tuple(torch.from_numpy(np.array(a)) for a in state)
    want, (jstate, jconv) = jssm.mamba_apply(jcfg, jp, jnp.asarray(x), *jst)
    got, (tstate, tconv) = ssm.mamba_apply(cfg, tp, torch.from_numpy(x),
                                           *tst)
    _close(got, want, f"{what}: output")
    _close(tstate, jstate, f"{what}: state")
    _close(tconv, jconv, f"{what}: conv window")
    assert tstate.dtype == torch.float32 and tconv.dtype == got.dtype
    return np.asarray(jstate), np.asarray(jconv)


@pytest.mark.parametrize("s", [192, 40], ids=["three-chunks", "one-chunk"])
def test_mamba_prefill_without_state(cfgs, params, s):
    """192 tokens: three 64-token chunks, the state carried across two
    chunk boundaries; 40 tokens: not a multiple of 64, so one chunk."""
    cfg, jcfg = cfgs
    _check_step(cfg, jcfg, params, _x(1, s, cfg.d_model), what=f"S {s}")


def test_mamba_prefill_continuation_from_state(cfgs, params):
    """128 tokens, then 64 more from the carried state and conv window."""
    cfg, jcfg = cfgs
    state = _check_step(cfg, jcfg, params, _x(2, 128, cfg.d_model),
                        what="first 128")
    _check_step(cfg, jcfg, params, _x(3, 64, cfg.d_model), state,
                what="continuation")


def test_mamba_recurrent_decode_steps(cfgs, params):
    """A 40-token prefill, then 8 one-token steps, each from the
    reference's state of the step before."""
    cfg, jcfg = cfgs
    state = _check_step(cfg, jcfg, params, _x(4, 40, cfg.d_model),
                        what="prefill")
    for t in range(8):
        state = _check_step(cfg, jcfg, params, _x(10 + t, 1, cfg.d_model),
                            state, what=f"step {t}")


def test_mamba_prefill_from_zero_state_is_prefill_without_one(cfgs, params):
    """``Model.prefill`` takes the continuation branch from a zero cache:
    it must give what the no-state branch gives."""
    cfg, _ = cfgs
    _, tp = _both(params)
    x = torch.from_numpy(_x(5, 64, cfg.d_model))
    zero = ssm.init_ssm_cache(cfg, B, torch.float32, "cpu")
    a, (sa, ca) = ssm.mamba_apply(cfg, tp, x)
    b, (sb, cb) = ssm.mamba_apply(cfg, tp, x, *zero)
    for got, want in ((b, a), (sb, sa), (cb, ca)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("s,init", [(192, False), (192, True), (12, True)],
                         ids=["chunks", "chunks-from-state", "one-chunk"])
def test_ssd_chunked(cfgs, s, init):
    cfg, _ = cfgs
    rng = np.random.default_rng(6)
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = _randn(rng, B, s, h, p)
    dt = np.log1p(np.exp(_randn(rng, B, s, h))).astype(np.float32)
    a = -np.exp(_randn(rng, h, scale=0.5))
    # C . B of unit variance, as in the block (sums of ~1e2 such terms
    # then stay far above the float32 rounding of their order).
    bm, cm = (_randn(rng, B, s, n, scale=n ** -0.25) for _ in range(2))
    args = (xh, dt, a, bm, cm) + ((_randn(rng, B, h, n, p),) if init else ())
    want_y, want_s = jssm._ssd_chunked(*map(jnp.asarray, args))
    got_y, got_s = ssm._ssd_chunked(*map(torch.from_numpy, args))
    _close(got_y, want_y, "y")
    _close(got_s, want_s, "final state")


def test_causal_conv(cfgs):
    cfg, _ = cfgs
    rng = np.random.default_rng(7)
    c = cfg.d_inner + 2 * cfg.ssm_state
    x, w, b = (_randn(rng, B, 9, c), _randn(rng, cfg.ssm_conv, c),
               _randn(rng, c))
    _close(ssm._causal_conv(*map(torch.from_numpy, (x, w, b))),
           jssm._causal_conv(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_ssm_cache(cfgs, dtype):
    cfg, jcfg = cfgs
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jstate, jconv = jssm.init_ssm_cache(jcfg, 3, jdtype)
    state, conv = ssm.init_ssm_cache(cfg, 3, dtype, "cpu")
    assert state.shape == jstate.shape and state.dtype == torch.float32
    assert conv.shape == jconv.shape and conv.dtype == dtype
    assert not state.any() and not conv.any()


@pytest.mark.parametrize("arch,subtree", [("zamba2-2.7b", "shared_attn"),
                                          ("qwen2-vl-72b", "frontend")])
def test_params_from_jax_carries_the_new_subtrees(arch, subtree):
    jcfg = jsmoke(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    jparams = jax.tree_util.tree_map(
        np.asarray, JModel(jcfg).init(jax.random.PRNGKey(1)))
    params = params_from_jax(cfg, jparams, device="cpu")
    assert params.keys() == jparams.keys()
    flat = lambda t: {k: v for k, v in jax.tree_util.tree_leaves_with_path(
        t)}
    got, want = flat(params[subtree]), flat(jparams[subtree])
    assert got.keys() == want.keys() and want
    for path, a in want.items():
        assert got[path].shape == a.shape
        np.testing.assert_array_equal(got[path].numpy(), a)
    bad = {k: v for k, v in jparams.items() if k != subtree}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(cfg, bad, device="cpu")


def test_hybrid_init_cache_layout():
    cfg = smoke_variant(get_config("zamba2-2.7b"), dtype="bfloat16")
    cache = transformer.init_cache(cfg, 3, 99, torch.bfloat16, "cpu")
    groups = cfg.n_layers // cfg.attn_every
    assert cache["len"] == 0 and isinstance(cache["len"], int)
    assert cache["ssm_state"].shape == (cfg.n_layers, 3, cfg.ssm_heads,
                                        cfg.ssm_state, cfg.ssm_head_dim)
    assert cache["ssm_state"].dtype == torch.float32
    assert cache["conv"].shape == (cfg.n_layers, 3, cfg.ssm_conv - 1,
                                   cfg.d_inner + 2 * cfg.ssm_state)
    kv = (groups, 3, 99, cfg.n_kv_heads, cfg.resolved_head_dim)
    for name in ("conv", "k", "v"):
        assert cache[name].dtype == torch.bfloat16
    assert cache["k"].shape == cache["v"].shape == kv
