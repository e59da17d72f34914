"""The port's decode_attn (K2) against the reference's Pallas kernel.

On the CPU, ``repro_torch.kernels.ops.decode_attn`` runs the plain version
``decode_attn_ref``; it is held to ``repro.kernels.decode_attn`` in
interpret mode and to ``repro.kernels.ref.decode_attn_ref`` on identical
numpy inputs.  The hand CUDA kernel itself is held to the plain version in
``test_torch_cuda.py``, which runs only where there is a card.  What the
kernel does around its arithmetic is held here: the split of each cache
into parts of whole tiles (``decode_attn.partition``) covers the prefix
once, and the parts' softmax partials, merged as the kernel's clusters
merge them, equal the reference's kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attn import decode_attn as jax_decode_attn
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import ops

jax.config.update("jax_platform_name", "cpu")

# float32: the reference's own kernel-test tolerance.
F32_TOL = dict(atol=2e-5, rtol=2e-3)
# bfloat16: both sides round the same fp32 result to bf16; allow one
# rounding step apart (bf16 spacing is <= 2**-7 for |x| < 2).
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _inputs(seed, b, hq, hk, d, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, length, dtype=torch.float32):
    out = ops.decode_attn(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                          length)
    return out.float().numpy()


@pytest.mark.parametrize("hq,hk", [(8, 8), (8, 2), (12, 2), (4, 1)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [512, 1024, 1536])
def test_decode_attn_sweep_matches_reference(hq, hk, d, s):
    q, k, v = _inputs(0, 2, hq, hk, d, s)
    length = s - 100
    got = _port(q, k, v, length)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jlen = jnp.array(length, jnp.int32)
    want_kernel = jax_decode_attn(jq, jk, jv, jlen, block_s=512,
                                  interpret=True)
    want_ref = jref.decode_attn_ref(jq, jk, jv, jlen)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(want_ref), **F32_TOL)


@pytest.mark.parametrize("hq,hk,d", [(4, 2, 64), (12, 2, 128), (8, 8, 64)])
def test_decode_attn_bf16_matches_reference(hq, hk, d):
    s = 512
    q, k, v = _inputs(1, 2, hq, hk, d, s)
    length = 333
    got = _port(q, k, v, length, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jax_decode_attn(jq, jk, jv, jnp.array(length, jnp.int32),
                           interpret=True)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("length", [1, 2, 127, 128, 129, 500, 640])
def test_decode_attn_length_masking(length):
    """Valid-prefix lengths that are and are not tile multiples."""
    q, k, v = _inputs(2, 2, 4, 2, 64, 640)
    got = _port(q, k, v, length)
    want = jref.decode_attn_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                jnp.array(length, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("length", [1, 200, 383])
def test_decode_attn_poison_past_length_is_ignored(g, length):
    """Entries past ``length`` never move the output."""
    s = 384
    q, k, v = _inputs(3, 1, 2 * g, 2, 64, s)
    clean = _port(q, k, v, length)
    k2, v2 = k.copy(), v.copy()
    k2[:, length:] = 77.0
    v2[:, length:] = -1e4
    np.testing.assert_allclose(_port(q, k2, v2, length), clean, atol=1e-5)


def test_cpu_dispatch_never_touches_the_kernel():
    before = da.KERNEL.launches
    q, k, v = _inputs(4, 2, 8, 2, 64, 256)
    _port(q, k, v, 200)
    assert da.KERNEL.launches == before
    assert da.KERNEL._fn is None and da.KERNEL.library._lib is None


def test_dispatch_raises_on_mixed_devices():
    q = torch.zeros(1, 2, 64)
    k = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        ops.decode_attn(q, k, k, 4)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it has no CPU fallback."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 2, 2, 64, 16))
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attn(q, k, v, 8)
    assert da.KERNEL.library._lib is None


# --- the split over the cache (csrc/decode_attn.cu's parts and merge) -------

SMS = 132   # an H100 SXM's SMs


def _assert_covers(cut, length):
    """The parts are [lo, hi) runs of whole tiles that cover [0, length)
    once, in order; empty parts (lo == hi == length) only at the end."""
    assert 1 <= cut.parts <= da.MAX_PARTS
    assert cut.part_keys % da.TILE_KEYS == 0 and cut.part_keys > 0
    bounds = cut.bounds(length)
    assert len(bounds) == cut.parts
    assert bounds[0][0] == 0 and bounds[-1][1] == length
    for (lo, hi), (nlo, _) in zip(bounds, bounds[1:]):
        assert hi == nlo
    for lo, hi in bounds:
        assert 0 <= lo <= hi <= length
        assert lo % da.TILE_KEYS == 0 or lo == length
    assert sum(hi - lo for lo, hi in bounds) == length
    empty = [lo == hi for lo, hi in bounds]
    assert empty == sorted(empty)


def _assert_partition(b, hk, length, sms):
    cut = da.partition(b, hk, length, sms)
    _assert_covers(cut, length)
    # One wave of at most one block an SM (or one part), parts of at least
    # MIN_PART_KEYS keys unless there is one.
    assert cut.parts == 1 or b * hk * cut.parts <= sms
    assert cut.parts == 1 or length // cut.parts >= da.MIN_PART_KEYS
    assert cut.parts & (cut.parts - 1) == 0


def test_partition_covers_the_prefix_once():
    """Any B, Hk, length and SM count, and every forced split."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(st.integers(1, 64), st.integers(1, 64),
               st.integers(1, 1 << 17), st.integers(1, 264),
               st.integers(1, da.MAX_PARTS))
    @hyp.settings(max_examples=300, deadline=None)
    def check(b, hk, length, sms, parts):
        _assert_partition(b, hk, length, sms)
        _assert_covers(da.split(parts, length), length)

    check()


@pytest.mark.parametrize("arch,b,hk,length,parts,blocks", [
    ("stablelm-1.6b", 8, 32, 1040, 1, 256),
    ("olmoe-1b-7b", 8, 16, 1040, 1, 128),
    ("starcoder2-3b", 8, 2, 4096, 8, 128),
    ("mistral-large-123b layer", 8, 8, 32768, 2, 128),
])
def test_partition_at_the_path_shapes(arch, b, hk, length, parts, blocks):
    cut = da.partition(b, hk, length, SMS)
    assert (cut.parts, b * hk * cut.parts) == (parts, blocks), arch
    _assert_covers(cut, length)


def test_most_parts_empty_at_short_lengths():
    for length in (1, 2, da.TILE_KEYS + 1):
        cut = da.split(da.MAX_PARTS, length)
        assert cut.part_keys == da.TILE_KEYS
        lens = [hi - lo for lo, hi in cut.bounds(length)]
        assert sum(n > 0 for n in lens) == -(-length // da.TILE_KEYS)


def _partials(q, k, v, lo, hi):
    """One part's (m, l, acc) as a block of the kernel leaves them, fp32:
    the running max, the sum of exponentials and the unnormalized output
    over keys [lo, hi); an empty part is (-1e30, 0, 0)."""
    b, hq, d = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, hk, hq // hk, d)
    if hi == lo:
        return (torch.full((b, hk, hq // hk), -1e30),
                torch.zeros(b, hk, hq // hk), torch.zeros(b, hk, hq // hk, d))
    s = torch.einsum("bhgd,bshd->bhgs", qg, k[:, lo:hi]) * d ** -0.5
    m = s.max(-1).values
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.einsum("bhgs,bshd->bhgd", p, v[:, lo:hi])


def _merge(parts):
    """The cluster's merge: weights exp(m_r - max) / sum_r l_r exp(...)."""
    m = torch.stack([p[0] for p in parts])
    mx = m.max(0).values
    w = torch.exp(m - mx)
    den = (w * torch.stack([p[1] for p in parts])).sum(0)
    acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    return acc / den[..., None]


@pytest.mark.parametrize("length", [1, 65, 640])
def test_merge_of_parts_matches_reference(length):
    """Per-part partials merged as the kernel's clusters merge them, with
    empty parts, held to the reference's Pallas kernel in interpret mode
    at every split the kernel may take."""
    q, k, v = _inputs(6, 2, 8, 2, 64, 1024)
    want = np.asarray(jax_decode_attn(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.array(length, jnp.int32),
        interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for parts in (1, 2, 3, 4, 16):
        cut = da.split(parts, length)
        got = _merge([_partials(tq, tk, tv, lo, hi)
                      for lo, hi in cut.bounds(length)])
        np.testing.assert_allclose(got.reshape(q.shape).numpy(), want,
                                   **F32_TOL)
