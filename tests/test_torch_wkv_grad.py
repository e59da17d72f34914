"""The gradient of wkv: K3b's plain version and the autograd dispatch.

``repro_torch.kernels.ref.wkv_bwd_ref`` (the plain version of K3b, the
hand backward kernel) is held to ``jax.vjp`` of the reference's
``repro.models.rwkv._wkv_scan``, the scan the reference's training path
differentiates, on identical numpy inputs.  ``ops.wkv`` under
``torch.autograd`` on CPU tensors is held to autograd through the plain
forward loop ``ref.wkv_ref``.  K3b itself is held to ``wkv_bwd_ref`` in
``test_torch_cuda.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro_torch.kernels import ops, ref

jax.config.update("jax_platform_name", "cpu")

NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
# float32, the same formulas: the recurrence over T in the same order and
# sums over D in another; measured max|d| <= 2.3e-7 of each output's
# largest element.  Held at 1e-5 of it.
GRAD_TOL = 1e-5


def _inputs(seed, b, t, h, d, decay):
    """r, k, v, w, u, s0, dy, ds_t as float32 numpy arrays.  ``decay``
    "sigmoid" is the reference test's w in (0.5, 1); "model" is
    time_mix's exp(-exp(N(0,1) - 3))."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    r, k, v, z = (mk(b, t, h, d) for _ in range(4))
    w = (1 / (1 + np.exp(-z)) * 0.5 + 0.5 if decay == "sigmoid"
         else np.exp(-np.exp(z - 3.0))).astype(np.float32)
    return r, k, v, w, mk(h, d), mk(b, h, d, d), mk(b, t, h, d), \
        mk(b, h, d, d)


def _close(name, got, want):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("decay", ["sigmoid", "model"])
@pytest.mark.parametrize("ds_t", [False, True], ids=["dsT0", "dsT"])
@pytest.mark.parametrize("b,t,h,d", [(2, 37, 3, 16), (1, 1, 2, 32),
                                     (2, 20, 2, 64)])
def test_wkv_bwd_ref_matches_jax_vjp(b, t, h, d, ds_t, decay):
    r, k, v, w, u, s0, dy, dst = _inputs(t + d, b, t, h, d, decay)
    if not ds_t:
        dst = np.zeros_like(dst)
    _, vjp = jax.vjp(jrwkv._wkv_scan,
                     *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    got = ref.wkv_bwd_ref(*(torch.from_numpy(a) for a in
                            (r, k, v, w, u, s0, dy)),
                          torch.from_numpy(dst) if ds_t else None)
    for name, g, x in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == x.shape, name
        _close(name, g.numpy(), x)


@pytest.mark.parametrize("ds_t", [False, True], ids=["dsT0", "dsT"])
def test_wkv_autograd_on_cpu_matches_autograd_through_wkv_ref(ds_t):
    """ops.wkv's gradients (the autograd Function, wkv_bwd_ref on the CPU)
    against torch.autograd through the plain loop, for every input."""
    arrays = _inputs(5, 2, 23, 3, 16, "model")
    dy, dst = (torch.from_numpy(a) for a in arrays[6:])
    grads = []
    for fn in (ops.wkv, ref.wkv_ref):
        xs = [torch.from_numpy(a).requires_grad_() for a in arrays[:6]]
        y, s = fn(*xs)
        loss = (y * dy).sum() + ((s * dst).sum() if ds_t else 0.0)
        loss.backward()
        grads.append([x.grad for x in xs])
    for name, g, x in zip(NAMES, *grads):
        _close(name, g.numpy(), x.numpy())


def test_wkv_autograd_keeps_bf16_gradients_and_plain_flag():
    """bf16 r/k/v get bf16 gradients (w, u and the state fp32), and
    ``plain=True`` gives the CPU path's gradients on CPU tensors."""
    arrays = _inputs(7, 1, 9, 2, 16, "sigmoid")[:6]
    dy = torch.from_numpy(_inputs(8, 1, 9, 2, 16, "sigmoid")[6])
    out = []
    for plain in (False, True):
        xs = [torch.from_numpy(a) for a in arrays]
        xs = [x.bfloat16() if i < 3 else x for i, x in enumerate(xs)]
        xs = [x.requires_grad_() for x in xs]
        y, _ = ops.wkv(*xs, plain=plain)
        (y * dy).sum().backward()
        out.append([x.grad for x in xs])
    assert [g.dtype for g in out[0]] == [torch.bfloat16] * 3 + \
        [torch.float32] * 3
    for g, x in zip(*out):
        assert torch.equal(g, x)


def test_wkv_in_place_state_path_refuses_a_gradient():
    """The decode cache's in-place update has no gradient: asking for one
    raises; under no_grad it writes the state as before."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _inputs(9, 1, 4, 2, 16, "model")[:6])
    state = s0.clone()
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.wkv(r.requires_grad_(), k, v, w, u, state, state_out=state)
    with torch.no_grad():
        y, s = ops.wkv(r, k, v, w, u, state, state_out=state)
    assert s is state
    y2, s2 = ref.wkv_ref(r.detach(), k, v, w, u, s0)
    assert torch.equal(y, y2) and torch.equal(state, s2)
