"""The port's mixture-of-experts layer (``models/moe.py``) against the JAX
reference, on the CPU, in float32.

The same parameters and inputs, drawn with numpy from a seed, go through
``repro.models.moe.moe_apply`` and the port's.  Outputs and the aux
losses (``return_aux=True``) agree within rtol 1e-5 (atol 1e-6 for
entries near zero): the two differ only in the order of float32 sums
inside the expert products and the k-slot combine.  The routing itself
(top-k experts, ranks, capacity, drops) is integer and must be equal,
which ``moe_overflow`` shows exactly.  Cases, on smoke configs of
olmoe-1b-7b (also with its full 64 experts, top 8, and with the gelu
expert of the reference's other branch) and phi3.5-moe-42b:
  * no drops (the smoke capacity factor, 8);
  * capacity factor 1.0 over enough tokens that experts overflow;
  * a router whose columns repeat over inputs whose products are exact,
    so that gates tie exactly and only the tie order (lower expert index
    first, as ``jax.lax.top_k``) decides the dispatch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.config import smoke_variant as jsmoke
from repro_torch.configs import get_config
from repro_torch.models import moe, smoke_variant

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-6)
#: (arch, overrides of the smoke config).
CONFIGS = {
    "olmoe": ("olmoe-1b-7b", {}),
    "olmoe-e64": ("olmoe-1b-7b", dict(n_experts=64, top_k=8)),
    "olmoe-gelu": ("olmoe-1b-7b", dict(activation="gelu")),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {}),
}
AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_overflow")


def _configs(key, **more):
    arch, over = CONFIGS[key]
    over = {**over, **more}
    return (jsmoke(jget_config(arch), **over),
            smoke_variant(get_config(arch), **over))


def _params(cfg, seed):
    """moe_specs' leaves (one layer), fan-in scaled normals from numpy."""
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(spec.shape) /
                   np.sqrt(spec.shape[-2])).astype(np.float32)
            for name, spec in moe.moe_specs(cfg, layered=False).items()}


def _run_both(jcfg, cfg, params, x):
    jy, jaux = jmoe.moe_apply(jcfg, {k: jnp.asarray(v)
                                     for k, v in params.items()},
                              jnp.asarray(x), return_aux=True)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    y, aux = moe.moe_apply(cfg, tp, torch.from_numpy(x), return_aux=True)
    y_only = moe.moe_apply(cfg, tp, torch.from_numpy(x))
    assert torch.equal(y, y_only)
    return (np.asarray(jy), {k: float(v) for k, v in jaux.items()},
            y.numpy(), {k: float(v) for k, v in aux.items()})


def _assert_match(jcfg, cfg, params, x):
    jy, jaux, y, aux = _run_both(jcfg, cfg, params, x)
    assert y.shape == jy.shape == x.shape and y.dtype == np.float32
    np.testing.assert_allclose(y, jy, **TOL)
    assert aux.keys() == jaux.keys() == set(AUX_KEYS)
    assert aux["moe_overflow"] == jaux["moe_overflow"]
    for key in AUX_KEYS:
        np.testing.assert_allclose(aux[key], jaux[key], **TOL, err_msg=key)
    return aux


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_moe_apply_without_drops(key):
    jcfg, cfg = _configs(key)
    x = np.random.default_rng(1).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    aux = _assert_match(jcfg, cfg, _params(cfg, 2), x)
    assert aux["moe_overflow"] == 0.0


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_moe_apply_with_drops(key):
    """capacity factor 1.0: every slot of the batch has room only if the
    router were perfectly balanced; a skewed router overflows."""
    jcfg, cfg = _configs(key, capacity_factor=1.0)
    x = np.random.default_rng(3).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    params = _params(cfg, 4)
    params["router"][:, 0] += 0.5          # skew towards expert 0
    aux = _assert_match(jcfg, cfg, params, x)
    assert aux["moe_overflow"] > 0.0


@pytest.mark.parametrize("key", sorted(CONFIGS))
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_apply_with_tied_gates(key, cf):
    """Columns of the router repeat in pairs and every product is exact
    (entries are small multiples of powers of two), so tied experts get
    bit-equal gates in both packages."""
    jcfg, cfg = _configs(key, capacity_factor=cf)
    rng = np.random.default_rng(5)
    x = (rng.integers(-2, 3, (4, 8, cfg.d_model)) * 0.5).astype(np.float32)
    params = _params(cfg, 6)
    e = cfg.n_experts
    base = rng.integers(-2, 3, (cfg.d_model, e)) * 0.125
    params["router"] = base[:, np.arange(e) // 2 * 2].astype(np.float32)
    # The ties reach the top-k boundary of some tokens.
    logits = x.reshape(-1, cfg.d_model) @ params["router"]
    srt = -np.sort(-logits, axis=-1)
    assert (srt[:, cfg.top_k - 1] == srt[:, cfg.top_k]).any()
    _assert_match(jcfg, cfg, params, x)


def test_top_k_orders_ties_as_jax():
    rng = np.random.default_rng(7)
    for shape, k in (((50, 64), 8), ((33, 16), 2), ((9, 4), 2), ((5, 7), 7)):
        x = rng.integers(0, 4, shape).astype(np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        v, i = moe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 8.0])
def test_capacity_equals_reference(arch, cf):
    jcfg = dataclasses.replace(jget_config(arch), capacity_factor=cf)
    cfg = dataclasses.replace(get_config(arch), capacity_factor=cf)
    for n in (1, 2, 7, 8, 9, 31, 64, 100, 257, 1000, 1024, 8192, 65_536):
        assert moe.capacity(cfg, n) == jmoe.capacity(jcfg, n), n


def test_specs_equal_reference():
    for arch in ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"):
        jcfg, cfg = jget_config(arch), get_config(arch)
        for layered in (True, False):
            got = moe.moe_specs(cfg, layered)
            want = jmoe.moe_specs(jcfg, layered)
            assert got.keys() == want.keys()
            for name in got:
                assert (got[name].shape, got[name].axes) == \
                    (want[name].shape, want[name].axes)
