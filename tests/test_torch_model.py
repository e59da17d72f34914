"""The serving slice as a whole: the port against the reference model.

On ``smoke_variant`` configs of stablelm-1.6b (MHA, SwiGLU),
starcoder2-3b (GQA G = 2, GELU), rwkv6-1.6b (ssm: RWKV6 time-mix and
channel-mix) and olmoe-1b-7b (moe: routed experts) in float32, the reference's ``Model.init`` parameters are
carried into the port with ``params_from_jax``; then prefill logits, eight
teacher-forced ``decode_step`` logits, the cache contents (over the
family's own keys) and ``greedy_generate``'s tokens must agree.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticDataset as JSyntheticDataset
from repro.models import Model as JModel
from repro.models.config import smoke_variant as jsmoke
from repro.models.transformer import forward as jforward
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.models import Model, smoke_variant
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import PORTED_FAMILIES, forward

jax.config.update("jax_platform_name", "cpu")

ARCHS_UNDER_TEST = ["stablelm-1.6b", "starcoder2-3b", "rwkv6-1.6b",
                    "olmoe-1b-7b"]
#: The decode cache's tensors, by family.
CACHE_KEYS = {"dense": ("k", "v"), "moe": ("k", "v"),
              "ssm": ("tm_shift", "wkv", "cm_shift")}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
B, PROMPT, STEPS = 2, 12, 8


@pytest.fixture(scope="module", params=ARCHS_UNDER_TEST)
def pair(request):
    """(reference model, its params, port model, port params, prompt)."""
    jcfg = jsmoke(jget_config(request.param))
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = smoke_variant(get_config(request.param))
    m = Model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    batch = JSyntheticDataset(jcfg, B, PROMPT + STEPS, seed=7).batch_at(0)
    return jm, jparams, m, params, batch


def _prompt(batch):
    return {k: batch[k][:, :PROMPT] for k in ("tokens", "positions")}


def test_prefill_and_teacher_forced_decode(pair):
    jm, jparams, m, params, batch = pair
    jcache = jm.make_cache(B, PROMPT + STEPS)
    cache = m.make_cache(B, PROMPT + STEPS)
    jlogits, jcache = jax.jit(jm.prefill)(jparams, _prompt(batch), jcache)
    logits, cache = m.prefill(params, _prompt(batch), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    jstep = jax.jit(jm.decode_step)
    for t in range(PROMPT, PROMPT + STEPS):
        sb = {k: batch[k][:, t:t + 1] for k in ("tokens", "positions")}
        jlogits, jcache = jstep(jparams, sb, jcache)
        logits, cache = m.decode_step(params, sb, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL, err_msg=f"step {t}")
    assert cache["len"] == int(jcache["len"]) == PROMPT + STEPS
    for name in CACHE_KEYS[m.cfg.family]:
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **LOGIT_TOL)


def test_greedy_generate_tokens_and_cache(pair):
    jm, jparams, m, params, batch = pair
    gen = jax.jit(jm.greedy_generate, static_argnames=("steps",))
    jtoks, jcache = gen(jparams, _prompt(batch),
                        jm.make_cache(B, PROMPT + STEPS), steps=STEPS)
    toks, cache = m.greedy_generate(params, _prompt(batch),
                                    m.make_cache(B, PROMPT + STEPS), STEPS)
    assert toks.dtype == torch.int32 and toks.shape == (B, STEPS)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert cache["len"] == int(jcache["len"])
    for name in CACHE_KEYS[m.cfg.family]:
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **LOGIT_TOL)


def test_uncached_forward_matches_reference(pair):
    """The stack without a cache (causal reference_attention per layer;
    rwkv layers from a zero state)."""
    jm, jparams, m, params, batch = pair
    toks = {k: batch[k] for k in ("tokens", "positions")}
    jh, _ = jforward(jm.cfg, jparams, toks)
    h, cache = forward(m.cfg, params, {k: torch.from_numpy(v)
                                       for k, v in toks.items()})
    assert cache is None
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **LOGIT_TOL)


def test_plain_decode_path_matches_dispatch_on_cpu(pair):
    """On CPU tensors the kernel path is the plain version: both paths
    give the same prefill and decode logits.  A pass writes its cache in
    place, so each path's decode step starts from its own copy."""
    _, _, m, params, batch = pair
    cache = m.make_cache(B, PROMPT + 1)
    a, cache = m.prefill(params, _prompt(batch), cache)
    b, _ = m.prefill(params, _prompt(batch), m.make_cache(B, PROMPT + 1),
                     plain_kernels=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGIT_TOL)
    sb = {k: batch[k][:, PROMPT:PROMPT + 1] for k in ("tokens", "positions")}
    copy = {k: (t.clone() if torch.is_tensor(t) else t)
            for k, t in cache.items()}
    a, _ = m.decode_step(params, sb, cache)
    b, _ = m.decode_step(params, sb, copy, plain_kernels=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    cfg = get_config(arch)
    if cfg.family not in PORTED_FAMILIES:
        with pytest.raises(NotImplementedError, match="not ported"):
            Model(cfg, device="cpu")
        return
    assert Model(cfg, device="cpu").param_count() == \
        JModel(jget_config(arch)).param_count()


def test_init_is_seeded_and_path_keyed():
    cfg = smoke_variant(get_config("stablelm-1.6b"))
    m = Model(cfg, device="cpu")
    a, b, c = m.init(0), m.init(0), m.init(1)
    wq = a["layers"]["attn"]["wq"]
    assert torch.equal(wq, b["layers"]["attn"]["wq"])
    assert not torch.equal(wq, c["layers"]["attn"]["wq"])
    assert not torch.equal(wq, a["layers"]["attn"]["wk"])
    assert torch.all(a["layers"]["ln1"] == 0)
    # Fan-in scaling: std ~ 1/sqrt(d_in).
    std = float(wq.std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_synthetic_dataset_matches_reference():
    cfg = smoke_variant(get_config("starcoder2-3b"))
    jcfg = jsmoke(jget_config("starcoder2-3b"))
    got = SyntheticDataset(cfg, 3, 40, seed=5).batch_at(2)
    want = JSyntheticDataset(jcfg, 3, 40, seed=5).batch_at(2)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Model(smoke_variant(get_config("stablelm-1.6b")))
