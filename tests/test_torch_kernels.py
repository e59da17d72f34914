"""The port's decode_attn (K2) against the reference's Pallas kernel.

On the CPU, ``repro_torch.kernels.ops.decode_attn`` runs the plain version
``decode_attn_ref``; it is held to ``repro.kernels.decode_attn`` in
interpret mode and to ``repro.kernels.ref.decode_attn_ref`` on identical
numpy inputs.  The hand CUDA kernel itself is held to the plain version in
``test_torch_cuda.py``, which runs only where there is a card.
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
