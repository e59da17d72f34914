"""The serving slice as a whole: the port against the reference model.

On ``smoke_variant`` configs of stablelm-1.6b (MHA, SwiGLU),
starcoder2-3b (GQA G = 2, GELU), rwkv6-1.6b (ssm: RWKV6 time-mix and
channel-mix), olmoe-1b-7b (moe: routed experts), zamba2-2.7b (hybrid:
Mamba2 groups with a shared attention block) and qwen2-vl-72b (vlm: M-RoPE
positions and vision rows) in float32, the reference's ``Model.init``
parameters are carried into the port with ``params_from_jax``; then
prefill logits, eight teacher-forced ``decode_step`` logits, the cache
contents (over the family's own keys) and ``greedy_generate``'s tokens
must agree.  zamba2 runs a 12-token prompt (one SSD chunk) and a 128-token
one (two chunks, the state carried across their boundary).  A bf16 vlm
prefill with vision rows is held to the reference's float32 activations.
"""

import jax
import jax.numpy as jnp
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
from repro_torch.models.transformer import forward

jax.config.update("jax_platform_name", "cpu")

#: (arch, prompt length).
ARCHS_UNDER_TEST = [("stablelm-1.6b", 12), ("starcoder2-3b", 12),
                    ("rwkv6-1.6b", 12), ("olmoe-1b-7b", 12),
                    ("zamba2-2.7b", 12), ("zamba2-2.7b", 128),
                    ("qwen2-vl-72b", 12)]
#: The decode cache's tensors, by family.
CACHE_KEYS = {"dense": ("k", "v"), "vlm": ("k", "v"), "moe": ("k", "v"),
              "hybrid": ("ssm_state", "conv", "k", "v"),
              "ssm": ("tm_shift", "wkv", "cm_shift")}
#: The prompt's keys beside the tokens and positions ((B, S) or, for
#: M-RoPE, (B, S, 3)): the vlm pipeline's vision rows.
PROMPT_KEYS = ("tokens", "positions", "vision_embeds", "vision_mask")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
# The hybrid family against the reference.  Its SSD takes exp(seg_i -
# seg_j) of cumulative sums of the step sizes that reach ~-1e2 over a
# chunk at this init (a = -1, dt ~ 0.7, a float32 step of ~1e-5 there), so
# a step size one float32 step apart, which the two libraries' orders of
# summation in ``x @ in_proj`` give, moves every later partial sum and the
# block's output by up to ~3e-5 (measured with the reference's own SSD on
# step sizes 1 ulp apart).  The reference does not meet LOGIT_TOL against
# itself: jitted against run op by op it differs by up to 5.5e-5 on a
# 136-token pass (23 elements outside LOGIT_TOL).  Measured port against
# reference, at rtol 1e-4: the logits need atol 3.6e-5 (max|d| 4.6e-5,
# |logit| <= 4.4); the caches and the uncached pass's hidden states need
# atol 2.0e-4 (max|d| 2.8e-4, |x| <= 21; the K/V of the 128-token case).
# So the logits are held at atol 1e-4, the states at 1e-3.  A wrong
# branch, state, conv window or KV slice moves them by > 1e-2.
HYBRID_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
HYBRID_STATE_TOL = dict(rtol=1e-4, atol=1e-3)
B, STEPS = 2, 8


@pytest.fixture(scope="module", params=ARCHS_UNDER_TEST,
                ids=lambda p: p[0] if p[1] == 12 else f"{p[0]}-prompt{p[1]}")
def pair(request):
    """(reference model, its params, port model, port params, batch,
    prompt length)."""
    arch, prompt = request.param
    jcfg = jsmoke(jget_config(arch))
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = smoke_variant(get_config(arch))
    m = Model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    batch = JSyntheticDataset(jcfg, B, prompt + STEPS, seed=7).batch_at(0)
    return jm, jparams, m, params, batch, prompt


def _tol(cfg, state: bool = False):
    """The tolerance against the reference: of the logits, or with
    ``state`` of the caches and hidden states."""
    if cfg.family != "hybrid":
        return LOGIT_TOL
    return HYBRID_STATE_TOL if state else HYBRID_LOGIT_TOL


def _prompt(batch, prompt):
    return {k: batch[k][:, :prompt] for k in PROMPT_KEYS if k in batch}


def _step(batch, t):
    return {k: batch[k][:, t:t + 1] for k in ("tokens", "positions")}


def test_prefill_and_teacher_forced_decode(pair):
    jm, jparams, m, params, batch, prompt = pair
    jcache = jm.make_cache(B, prompt + STEPS)
    cache = m.make_cache(B, prompt + STEPS)
    jlogits, jcache = jax.jit(jm.prefill)(jparams, _prompt(batch, prompt),
                                          jcache)
    logits, cache = m.prefill(params, _prompt(batch, prompt), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **_tol(m.cfg))
    jstep = jax.jit(jm.decode_step)
    for t in range(prompt, prompt + STEPS):
        sb = _step(batch, t)
        jlogits, jcache = jstep(jparams, sb, jcache)
        logits, cache = m.decode_step(params, sb, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **_tol(m.cfg), err_msg=f"step {t}")
    assert cache["len"] == int(jcache["len"]) == prompt + STEPS
    for name in CACHE_KEYS[m.cfg.family]:
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]),
                                   **_tol(m.cfg, state=True))


def test_greedy_generate_tokens_and_cache(pair):
    jm, jparams, m, params, batch, prompt = pair
    gen = jax.jit(jm.greedy_generate, static_argnames=("steps",))
    jtoks, jcache = gen(jparams, _prompt(batch, prompt),
                        jm.make_cache(B, prompt + STEPS), steps=STEPS)
    toks, cache = m.greedy_generate(params, _prompt(batch, prompt),
                                    m.make_cache(B, prompt + STEPS), STEPS)
    assert toks.dtype == torch.int32 and toks.shape == (B, STEPS)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert cache["len"] == int(jcache["len"])
    for name in CACHE_KEYS[m.cfg.family]:
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]),
                                   **_tol(m.cfg, state=True))


def test_uncached_forward_matches_reference(pair):
    """The stack without a cache (causal reference_attention per layer;
    rwkv and Mamba layers from no state)."""
    jm, jparams, m, params, batch, _ = pair
    toks = {k: batch[k] for k in PROMPT_KEYS if k in batch}
    jh, _ = jforward(jm.cfg, jparams, toks)
    h, cache = forward(m.cfg, params, {k: torch.from_numpy(v)
                                       for k, v in toks.items()})
    assert cache is None
    np.testing.assert_allclose(h.numpy(), np.asarray(jh),
                               **_tol(m.cfg, state=True))


def test_plain_decode_path_matches_dispatch_on_cpu(pair):
    """On CPU tensors the kernel path is the plain version: both paths
    give the same prefill and decode logits.  A pass writes its cache in
    place, so each path's decode step starts from its own copy."""
    _, _, m, params, batch, prompt = pair
    cache = m.make_cache(B, prompt + 1)
    a, cache = m.prefill(params, _prompt(batch, prompt), cache)
    b, _ = m.prefill(params, _prompt(batch, prompt),
                     m.make_cache(B, prompt + 1), plain_kernels=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGIT_TOL)
    sb = _step(batch, prompt)
    copy = {k: (t.clone() if torch.is_tensor(t) else t)
            for k, t in cache.items()}
    a, _ = m.decode_step(params, sb, cache)
    b, _ = m.decode_step(params, sb, copy, plain_kernels=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    cfg = get_config(arch)
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


def test_synthetic_dataset_matches_reference_with_vision_rows():
    cfg = smoke_variant(get_config("qwen2-vl-72b"))
    jcfg = jsmoke(jget_config("qwen2-vl-72b"))
    got = SyntheticDataset(cfg, 2, 300, seed=5).batch_at(1)
    want = JSyntheticDataset(jcfg, 2, 300, seed=5).batch_at(1)
    assert got.keys() == want.keys() and got["positions"].shape == (2, 300, 3)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# bf16 with vision rows: the reference's float32 vision_embeds promote the
# whole prefill to float32 activations (each bf16 weight upcast); only the
# K/V written into the bf16 cache round to bf16, and a float32 difference
# of ~1e-7 between the libraries can flip one such rounding (2**-8
# relative) of a key or value, which moves the outputs by far less than
# one bf16 step of their own.  Measured: 1.9e-6 on hidden states up to
# 3.7; the same pass kept in bf16 (vision_embeds cast to bf16 first)
# differs from the reference by 5e-2.
VISION_BF16_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("prompt", [16, 1])
def test_vlm_bf16_prefill_with_vision_rows_matches_reference_dtype(prompt):
    """The hidden states of a bf16 qwen2-vl prefill with vision rows are
    float32, as the reference's are, and match them; the decode step
    after it stays bf16 on both sides.  A one-token prompt carries the
    vision embeddings with no vision row set, which promotes the pass all
    the same (its attention meets the bf16 cache upcast to float32)."""
    arch = "qwen2-vl-72b"
    jcfg = jsmoke(jget_config(arch), dtype="bfloat16")
    cfg = smoke_variant(get_config(arch), dtype="bfloat16")
    jm, m = JModel(jcfg), Model(cfg, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jparams), device="cpu")
    batch = JSyntheticDataset(jcfg, B, prompt + 1, seed=7).batch_at(0)
    assert batch["vision_mask"][:, :prompt].any() == (prompt > 1)
    jcache, cache = jm.make_cache(B, prompt + 1), m.make_cache(B, prompt + 1)
    pb = _prompt(batch, prompt)
    jh, jcache = jforward(jcfg, jparams, pb, cache=jcache)
    h, cache = forward(cfg, params, {k: torch.from_numpy(v)
                                     for k, v in pb.items()}, cache=cache)
    assert jh.dtype == jnp.float32 and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **VISION_BF16_TOL)
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32),
                                   **VISION_BF16_TOL)
    sb = _step(batch, prompt)
    jh, _ = jforward(jcfg, jparams, sb, cache=jcache)
    h, _ = forward(cfg, params, {k: torch.from_numpy(v)
                                 for k, v in sb.items()}, cache=cache)
    assert jh.dtype == jnp.bfloat16 and h.dtype == torch.bfloat16


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for arch in ("stablelm-1.6b", "zamba2-2.7b", "qwen2-vl-72b"):
        with pytest.raises(RuntimeError, match="no CUDA"):
            Model(smoke_variant(get_config(arch)))
