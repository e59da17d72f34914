"""The port on the card: hand kernels against their plain versions.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode; their CPU counterparts are tested in the other
``test_torch_*`` files).  This file imports neither JAX nor ``repro``, so
it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import Model, smoke_variant

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
    (2, 4, 2, 16, 40),          # smoke variants (head dim 16)
    (3, 8, 1, 32, 300),         # G = 8, head dim 32
])
def test_kernel_matches_plain(dtype, b, hq, hk, d, s):
    _need_card()
    q, k, v = _qkv(b, hq, hk, d, s, dtype)
    for length in (1, s // 3, s - 1, s):
        got = da.decode_attn(q, k, v, length)
        want = ref.decode_attn_ref(q, k, v, length)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


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
    q80, k80, v80 = _qkv(1, 4, 2, 80, 64, torch.float32)  # stablelm-3b dim
    with pytest.raises(ValueError, match="no kernel built"):
        ops.decode_attn(q80, k80, v80, 10)
    assert da.KERNEL.launches == before + 1


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-3b"])
def test_decode_step_kernel_path_matches_plain_path(arch):
    """float32 smoke model: the decode step through the kernel and through
    the plain decode_attention give the same logits."""
    _need_card()
    cfg = smoke_variant(get_config(arch))
    m = Model(cfg)
    params = m.init(0)
    batch = SyntheticDataset(cfg, 2, 17, seed=3).batch_at(0)
    prompt = {k: batch[k][:, :16] for k in ("tokens", "positions")}
    step = {k: batch[k][:, 16:17] for k in ("tokens", "positions")}
    _, cache = m.prefill(params, prompt, m.make_cache(2, 20))
    a, _ = m.decode_step(params, step, cache)
    b, _ = m.decode_step(params, step, cache, plain_decode=True)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_serve_smoke_launches_the_kernel_every_layer_and_step():
    _need_card()
    before = da.KERNEL.launches
    toks = serve.main(["--arch", "stablelm-1.6b", "--smoke", "--batch", "2",
                       "--prompt-len", "10", "--gen", "4"])
    assert toks.shape == (2, 4)
    assert da.KERNEL.launches - before == 4 * smoke_variant(
        get_config("stablelm-1.6b")).n_layers
