"""The channelized decode's arithmetic, and the vocab-parallel loss's, on
the CPU.

* ``ref.decode_attn_partials_ref`` (the plain version of K2's partial
  build) over N = 1, 2, 3 and 8 slices of a cache, and over uneven cuts,
  some slices wholly past the valid prefix, merged by
  ``ops.merge_partials`` with the reductions over a stacked axis: equal to
  ``ref.decode_attn_ref`` over the whole cache and to the reference's
  ``repro.models.attention.decode_attention`` on the same numpy inputs
  (float32 at rtol 1e-5; bfloat16 at the K2 CPU tolerance of
  ``test_torch_kernels.py``).  An empty slice's terms are those of no key.
* ``ops.decode_attn_partials`` dispatches by device: the plain version on
  the CPU, a stand-in on ``meta`` that charges the slice's work.
* ``layers.vocab_parallel_nll`` with the vocabulary cut into N slices and
  its three reductions over the stacked slices: the loss and its
  gradients equal ``layers.chunked_ce_loss`` on the whole head.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import decode_attention as jax_decode_attention
from repro_torch.core import hloparse
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

B, HQ, HK, D, S = 2, 8, 2, 16, 24
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# test_torch_kernels.py's bfloat16 tolerance for K2 on the CPU.
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _qkv(seed, dtype=torch.float32):
    gen = np.random.default_rng(seed)
    q, k, v = (gen.standard_normal(shape).astype(np.float32)
               for shape in ((B, HQ, D), (B, S, HK, D), (B, S, HK, D)))
    return (q, k, v), tuple(torch.from_numpy(x).to(dtype) for x in (q, k, v))


def _merged(q, k, v, length, cuts):
    """The slices [cuts[i], cuts[i + 1]) of the cache, each slice's terms of
    its valid keys, merged over the stacked slices."""
    terms = [ref.decode_attn_partials_ref(
        q, k[:, lo:hi], v[:, lo:hi], min(max(length - lo, 0), hi - lo))
        for lo, hi in zip(cuts[:-1], cuts[1:])]
    m, l, acc = (torch.stack(x) for x in zip(*terms))
    return ops.merge_partials(m, l, acc, q.dtype,
                              lambda x: x.amax(0, keepdim=True),
                              lambda x: x.sum(0))


def _jax_want(arrays, length, dtype):
    q, k, v = (jnp.asarray(x, dtype) for x in arrays)
    out = jax_decode_attention(q[:, None], k, v,
                               jnp.full((B,), length, jnp.int32))
    return np.asarray(out[:, 0].astype(jnp.float32))


@pytest.mark.parametrize("length", [1, 5, 13, S])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_slices_merge_to_the_whole_cache(n, length):
    arrays, (q, k, v) = _qkv(n * 100 + length)
    got = _merged(q, k, v, length, list(range(0, S + 1, S // n)))
    want = ref.decode_attn_ref(q, k, v, length)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    np.testing.assert_allclose(got.numpy(),
                               _jax_want(arrays, length, jnp.float32),
                               **F32_TOL)


@pytest.mark.parametrize("cuts", [(0, 5, 6, S), (0, 1, 2, 3, 23, S),
                                  (0, 16, S)])
@pytest.mark.parametrize("length", [1, 4, 6, 20])
def test_uneven_slices_merge_to_the_whole_cache(cuts, length):
    _, (q, k, v) = _qkv(length + len(cuts))
    np.testing.assert_allclose(_merged(q, k, v, length, cuts).numpy(),
                               ref.decode_attn_ref(q, k, v, length).numpy(),
                               **F32_TOL)


@pytest.mark.parametrize("n,length", [(2, 7), (3, 24), (8, 2)])
def test_bf16_slices_merge_to_the_whole_cache(n, length):
    arrays, (q, k, v) = _qkv(n + length, torch.bfloat16)
    got = _merged(q, k, v, length, list(range(0, S + 1, S // n)))
    assert got.dtype == torch.bfloat16
    want = ref.decode_attn_ref(q, k, v, length)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_want(arrays, length, jnp.bfloat16),
                               **BF16_TOL)


def test_an_empty_slice_has_the_terms_of_no_key():
    _, (q, k, v) = _qkv(3)
    m, l, acc = ref.decode_attn_partials_ref(q, k, v, 0)
    assert torch.equal(m, torch.full((B, HQ), -1e30))
    assert torch.equal(l, torch.zeros(B, HQ))
    assert torch.equal(acc, torch.zeros(B, HQ, D))


def test_partials_normalize_to_the_output():
    _, (q, k, v) = _qkv(4)
    m, l, acc = ref.decode_attn_partials_ref(q, k, v, 17)
    assert m.dtype == l.dtype == acc.dtype == torch.float32
    np.testing.assert_allclose((acc / l[..., None]).numpy(),
                               ref.decode_attn_ref(q, k, v, 17).numpy(),
                               **F32_TOL)
    assert torch.equal(ops.merge_partials(m, l, acc, q.dtype),
                       acc / l[..., None])


def test_partials_dispatch_by_device():
    _, (q, k, v) = _qkv(5)
    got = ops.decode_attn_partials(q, k, v, 9)
    for x, y in zip(got, ref.decode_attn_partials_ref(q, k, v, 9)):
        assert torch.equal(x, y)
    meta = [x.to("meta") for x in (q, k, v)]
    with hloparse.Meter() as meter:
        m, l, acc = ops.decode_attn_partials(*meta, 9)
    assert (m.shape, l.shape, acc.shape) == ((B, HQ), (B, HQ), (B, HQ, D))
    assert m.device.type == "meta" and acc.dtype == torch.float32
    assert meter.cost.flops == 4 * B * HQ * 9 * D


# --- the vocab-parallel cross-entropy ---------------------------------------

VB, VS, VD, V, CHUNK = 2, 8, 16, 48, 4


def _ce_inputs(seed):
    gen = np.random.default_rng(seed)
    h = torch.from_numpy(gen.standard_normal((VB, VS, VD)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy(gen.standard_normal((VD, V)).astype(
        np.float32)).requires_grad_(True)
    targets = torch.from_numpy(gen.integers(0, V, (VB, VS)))
    mask = torch.from_numpy((gen.random((VB, VS)) < 0.7).astype(np.float32))
    return h, w, targets, mask


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_vocab_slices_give_the_whole_heads_loss_and_gradients(n):
    h, w, targets, mask = _ce_inputs(n)
    want = layers.chunked_ce_loss(h, w, targets, mask, chunk=CHUNK)
    want_h, want_w = torch.autograd.grad(want, (h, w))
    cols = V // n
    logits = torch.stack([(h @ w[:, i * cols:(i + 1) * cols]).float()
                          for i in range(n)])            # (n, B, S, V / n)
    lo = (torch.arange(n) * cols)[:, None, None]
    nll = layers.vocab_parallel_nll(logits, targets[None], lo,
                                    lambda x: x.amax(0, keepdim=True),
                                    lambda x: x.sum(0))
    got = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    got_h, got_w = torch.autograd.grad(got, (h, w))
    np.testing.assert_allclose(got.item(), want.item(), **F32_TOL)
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), **F32_TOL)
    np.testing.assert_allclose(got_w.numpy(), want_w.numpy(), **F32_TOL)
