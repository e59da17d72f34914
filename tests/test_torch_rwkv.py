"""The port's wkv (K3) and RWKV6 blocks against the reference.

On the CPU, ``repro_torch.kernels.ops.wkv`` runs the plain version
``wkv_ref``; it is held to ``repro.kernels.rwkv_wkv.wkv`` in interpret mode
and to ``repro.kernels.ref.wkv_ref`` on identical numpy inputs.  The
port's ``time_mix`` / ``channel_mix`` run on parameters carried from the
reference's ``Model.init``.  The hand CUDA kernel itself is held to the
plain version in ``test_torch_cuda.py``, which runs only where there is a
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.rwkv_wkv import wkv as jax_wkv
from repro.models import Model as JModel
from repro.models import rwkv as jrwkv
from repro.models.config import smoke_variant as jsmoke
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv_wkv as kw
from repro_torch.models import Model, rwkv, smoke_variant, transformer
from repro_torch.models.convert import params_from_jax

jax.config.update("jax_platform_name", "cpu")

# The reference's own wkv kernel-test tolerance (tests/test_kernels.py).
WKV_TOL = dict(atol=1e-4, rtol=1e-4)
# Whole blocks in float32: the same formulas on the same weights; only the
# order of the matmul sums differs between the two libraries.
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


def _wkv_inputs(seed, b, t, h, d, decay="sigmoid"):
    """r, k, v, w, u, s0 as float32 numpy arrays.  ``decay`` "sigmoid" is
    the reference test's w in (0.5, 1); "model" is time_mix's
    exp(-exp(N(0,1) - 3))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    z = rng.standard_normal((b, t, h, d))
    w = (1 / (1 + np.exp(-z)) * 0.5 + 0.5 if decay == "sigmoid"
         else np.exp(-np.exp(z - 3.0))).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32)
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32)
    return r, k, v, w, u, s0


def _port_wkv(*arrays):
    y, s = ops.wkv(*(torch.from_numpy(a) for a in arrays))
    return y.numpy(), s.numpy()


@pytest.mark.parametrize("t", [64, 128, 256])
@pytest.mark.parametrize("h,d", [(2, 32), (4, 64)])
def test_wkv_sweep_matches_reference_kernel(t, h, d):
    arrays = _wkv_inputs(0, 2, t, h, d)
    y, s = _port_wkv(*arrays)
    jy, js = jax_wkv(*(jnp.asarray(a) for a in arrays), block_t=64,
                     interpret=True)
    np.testing.assert_allclose(y, np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(s, np.asarray(js), **WKV_TOL)
    assert y.dtype == s.dtype == np.float32


@pytest.mark.parametrize("t", [1, 7, 100])
@pytest.mark.parametrize("decay", ["sigmoid", "model"])
def test_wkv_ragged_length_matches_reference_ref(t, decay):
    """Lengths that are not multiples of the reference's 128-step tile."""
    arrays = _wkv_inputs(1, 2, t, 2, 16, decay)
    y, s = _port_wkv(*arrays)
    jy, js = jref.wkv_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(y, np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(s, np.asarray(js), **WKV_TOL)


@pytest.mark.parametrize("split", [1, 64, 127])
def test_wkv_state_chaining(split):
    """wkv over T equals wkv over [0, split) chained into [split, T)."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 1, 128, 2, 32)
    y_full, s_full = _port_wkv(r, k, v, w, u, s0)
    cut = lambda a, sl: np.ascontiguousarray(a[:, sl])
    y1, s1 = _port_wkv(*(cut(a, slice(0, split)) for a in (r, k, v, w)),
                       u, s0)
    y2, s2 = _port_wkv(*(cut(a, slice(split, None)) for a in (r, k, v, w)),
                       u, s1)
    np.testing.assert_allclose(np.concatenate([y1, y2], axis=1), y_full,
                               **WKV_TOL)
    np.testing.assert_allclose(s2, s_full, **WKV_TOL)


@pytest.mark.parametrize("decay", [0.05, 0.5, 0.9, 0.99])
def test_wkv_uniform_decay(decay):
    """With k = 0 the state only decays: S_T = S_0 * decay**T."""
    b, t, h, d = 1, 64, 1, 32
    r, _, v, _, _, s0 = _wkv_inputs(3, b, t, h, d)
    k = np.zeros_like(r)
    w = np.full_like(r, decay)
    u = np.zeros((h, d), np.float32)
    _, s = _port_wkv(r, k, v, w, u, s0)
    np.testing.assert_allclose(s, s0 * np.float32(decay) ** t, atol=1e-5,
                               rtol=1e-3)


def test_wkv_cpu_dispatch_never_touches_the_kernel():
    before = kw.KERNEL.launches
    _port_wkv(*_wkv_inputs(4, 1, 5, 2, 16))
    assert kw.KERNEL.launches == before
    assert kw.KERNEL._fn is None and kw.KERNEL.library._lib is None


def test_wkv_dispatch_raises_on_mixed_devices():
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in _wkv_inputs(5, 1, 3, 2, 16))
    with pytest.raises(ValueError, match="mixed"):
        ops.wkv(r, k, v, w, u, s0.to("meta"))


def test_wkv_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it has no CPU fallback."""
    arrays = (torch.from_numpy(a) for a in _wkv_inputs(6, 1, 3, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kw.wkv(*arrays)
    assert kw.KERNEL.library._lib is None


@pytest.mark.parametrize("t", [1, 9])
def test_wkv_state_out_in_place_matches_a_new_state(t):
    """ops.wkv with state_out = state (the decode cache's update) returns
    that tensor holding the state a new output would hold."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(7, 2, t, 2, 16)]
    y, s = ops.wkv(*args)
    state = args[5].clone()
    y2, s2 = ops.wkv(*args[:5], state, state_out=state)
    assert s2 is state
    assert torch.equal(y2, y) and torch.equal(state, s)


def test_wkv_kernel_wrapper_refuses_a_partly_overlapping_state_out():
    """state_out may be the input state or apart from it, nothing between:
    the kernel's blocks would read states another block has written."""
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in _wkv_inputs(8, 1, 3, 2, 16))
    buf = torch.zeros(2 * s0.numel())
    with pytest.raises(ValueError, match="overlaps"):
        kw.wkv(r, k, v, w, u, buf[:s0.numel()].view(s0.shape),
               state_out=buf[4:4 + s0.numel()].view(s0.shape))


def test_cached_pass_writes_the_ssm_cache_in_place():
    """prefill and decode_step return the cache tensors they were given,
    holding the new states (the values are held to the reference in
    test_torch_model.py)."""
    cfg = smoke_variant(get_config("rwkv6-1.6b"))
    m = Model(cfg, device="cpu")
    params = m.init(0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 6)).astype(np.int32))
    batch = dict(tokens=tokens, positions=torch.arange(6, dtype=torch.int32
                                                       ).expand(2, 6))
    cache = m.make_cache(2, 7)
    tensors = {k: t for k, t in cache.items() if k != "len"}
    _, out = m.prefill(params, batch, cache)
    assert out["len"] == 6 and cache["len"] == 0
    assert all(out[k] is t and t.any() for k, t in tensors.items())
    before = cache["wkv"].clone()
    step = {k: t[:, :1] for k, t in batch.items()}
    _, out2 = m.decode_step(params, step, out)
    assert out2["len"] == 7 and out2["wkv"] is tensors["wkv"]
    assert not torch.equal(tensors["wkv"], before)


# ---------------------------------------------------------------------------
# RWKV6 blocks with the reference's parameters.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blocks():
    """(reference cfg, port cfg, layer-0 rwkv params as jax and torch)."""
    jcfg = jsmoke(jget_config("rwkv6-1.6b"))
    cfg = smoke_variant(get_config("rwkv6-1.6b"))
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))["layers"]["rwkv"]
    jp = {name: np.array(a[0]) for name, a in jp.items()}
    # Non-zero bases, gates and norms, so every parameter moves the output.
    rng = np.random.default_rng(9)
    for name in ("mix_base", "decay_base", "bonus_u", "ln_x", "cm_mix"):
        jp[name] = (0.5 * rng.standard_normal(jp[name].shape)).astype(
            np.float32)
    p = {name: torch.from_numpy(a) for name, a in jp.items()}
    return jcfg, cfg, {n: jnp.asarray(a) for n, a in jp.items()}, p


def _block_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    d, h, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    shift = rng.standard_normal((b, d)).astype(np.float32)
    state = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    return x, shift, state


def test_time_mix_matches_reference(blocks):
    jcfg, cfg, jp, p = blocks
    x, shift, state = _block_inputs(cfg, 2, 9, 0)
    jy, (jshift, jstate) = jrwkv.time_mix(jcfg, jp, jnp.asarray(x),
                                          jnp.asarray(shift),
                                          jnp.asarray(state))
    y, (new_shift, new_state) = rwkv.time_mix(
        cfg, p, *(torch.from_numpy(a) for a in (x, shift, state)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **BLOCK_TOL)
    np.testing.assert_allclose(new_shift.numpy(), np.asarray(jshift),
                               **BLOCK_TOL)
    np.testing.assert_allclose(new_state.numpy(), np.asarray(jstate),
                               **BLOCK_TOL)


def test_channel_mix_matches_reference(blocks):
    jcfg, cfg, jp, p = blocks
    x, shift, _ = _block_inputs(cfg, 2, 9, 1)
    jy, jshift = jrwkv.channel_mix(jcfg, jp, jnp.asarray(x),
                                   jnp.asarray(shift))
    y, new_shift = rwkv.channel_mix(cfg, p, torch.from_numpy(x),
                                    torch.from_numpy(shift))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **BLOCK_TOL)
    np.testing.assert_allclose(new_shift.numpy(), np.asarray(jshift),
                               **BLOCK_TOL)


def test_time_mix_prefill_then_steps_equals_one_pass(blocks):
    """A prompt, then one-token steps carrying (shift, state), gives the
    outputs and final state of one pass over the whole sequence."""
    _, cfg, _, p = blocks
    x, shift, state = (torch.from_numpy(a)
                       for a in _block_inputs(cfg, 2, 10, 2))
    y_full, (shift_full, state_full) = rwkv.time_mix(cfg, p, x, shift, state)
    y, (sh, st) = rwkv.time_mix(cfg, p, x[:, :6], shift, state)
    ys = [y]
    for t in range(6, 10):
        y, (sh, st) = rwkv.time_mix(cfg, p, x[:, t:t + 1], sh, st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_full, **BLOCK_TOL)
    torch.testing.assert_close(sh, shift_full, rtol=0, atol=0)
    torch.testing.assert_close(st, state_full, **BLOCK_TOL)


def test_params_from_jax_carries_the_rwkv6_smoke_tree():
    jcfg = jsmoke(jget_config("rwkv6-1.6b"))
    cfg = smoke_variant(get_config("rwkv6-1.6b"))
    jparams = jax.tree_util.tree_map(
        np.asarray, JModel(jcfg).init(jax.random.PRNGKey(1)))
    params = params_from_jax(cfg, jparams, device="cpu")
    assert set(params["layers"]) == {"ln1", "ln2", "rwkv"}
    assert set(params["layers"]["rwkv"]) == set(
        rwkv.rwkv_specs(cfg)) == set(jparams["layers"]["rwkv"])
    for name, a in jparams["layers"]["rwkv"].items():
        got = params["layers"]["rwkv"][name]
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), a)
    bad = dict(jparams, layers=dict(jparams["layers"], rwkv={
        n: a for n, a in jparams["layers"]["rwkv"].items() if n != "wo"}))
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(cfg, bad, device="cpu")


def test_init_cache_layout():
    cfg = smoke_variant(get_config("rwkv6-1.6b"), dtype="bfloat16")
    cache = transformer.init_cache(cfg, 3, 99, torch.bfloat16, "cpu")
    l, d, h, hd = (cfg.n_layers, cfg.d_model, cfg.rwkv_heads,
                   cfg.rwkv_head_dim)
    assert cache["len"] == 0 and isinstance(cache["len"], int)
    assert cache["tm_shift"].shape == cache["cm_shift"].shape == (l, 3, d)
    assert cache["tm_shift"].dtype == cache["cm_shift"].dtype == \
        torch.bfloat16
    assert cache["wkv"].shape == (l, 3, h, hd, hd)
    assert cache["wkv"].dtype == torch.float32
    assert all(not t.any() for k, t in cache.items() if k != "len")
