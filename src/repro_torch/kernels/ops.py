"""Public wrappers for the hand kernels: dispatch by the tensors' device.

Port of ``repro/kernels/ops.py``, whose ``on_tpu()`` / ``_interp()`` chose
between the compiled Pallas kernel and interpret mode.  Here:

* every input on the CPU -> the plain PyTorch version in ``ref.py``;
* every input on CUDA    -> the hand kernel, which counts the launch;
  ``wkv``'s gradient is a kernel too (K3b), through ``torch.autograd``;
* anything else (mixed devices, or a dtype, shape or layout the kernel
  does not take) raises.  Nothing falls back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import memsim_scan as _ms
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv_wkv as _wkv
from repro_torch.kernels import stream as _stream


def _all_on_cpu(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"inputs on mixed or unsupported devices: "
                     f"{[str(t.device) for t in tensors]}")


def stream_copy(a):
    """o = a, a new tensor."""
    if _all_on_cpu(a):
        return ref.stream_copy_ref(a)
    return _stream.stream_copy(a)


def stream_scale(a, alpha):
    """o = alpha * a, alpha rounded to a's type."""
    if _all_on_cpu(a):
        return ref.stream_scale_ref(a, alpha)
    return _stream.stream_scale(a, alpha)


def stream_add(a, b):
    """o = a + b."""
    if _all_on_cpu(a, b):
        return ref.stream_add_ref(a, b)
    return _stream.stream_add(a, b)


def stream_triad(a, b, alpha):
    """o = a + alpha * b, rounded as the reference."""
    if _all_on_cpu(a, b):
        return ref.stream_triad_ref(a, b, alpha)
    return _stream.stream_triad(a, b, alpha)


def decode_attn(q, k, v, length: int):
    """q: (B, Hq, D); k/v: (B, S, Hk, D); length: int -> (B, Hq, D)."""
    if _all_on_cpu(q, k, v):
        return ref.decode_attn_ref(q, k, v, length)
    return _da.decode_attn(q, k, v, length)


class _Wkv(torch.autograd.Function):
    """wkv with its gradient: forward K3 and backward K3b on CUDA tensors;
    ``wkv_ref`` and ``wkv_bwd_ref`` on CPU tensors, or with ``plain`` on
    any device (the comparison path)."""

    @staticmethod
    def forward(ctx, plain, r, k, v, w, u, state):
        ctx.plain = plain or _all_on_cpu(r, k, v, w, u, state)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        if ctx.plain:
            return ref.wkv_ref(r, k, v, w, u, state)
        return _wkv.wkv(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, ds_t):
        r, k, v, w, u, state = ctx.saved_tensors
        dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device) \
            if dy is None else dy.float().contiguous()
        if ds_t is not None:
            ds_t = ds_t.float().contiguous()
        bwd = ref.wkv_bwd_ref if ctx.plain else _wkv.wkv_bwd
        return (None, *bwd(r, k, v, w, u, state, dy, ds_t))


def wkv(r, k, v, w, u, state, state_out=None, plain: bool = False):
    """r/k/v/w: (B, T, H, D); u: (H, D); state: (B, H, D, D) fp32.

    Returns (y (B, T, H, D) fp32, final state (B, H, D, D) fp32), with a
    gradient (K3b on the card) for every input.  With ``state_out`` the
    final state goes into it (it may be ``state``): the decode cache's
    in-place update, which has no gradient and raises if one is asked for.
    ``plain`` takes the plain versions on any device (path comparison)."""
    extra = () if state_out is None else (state_out,)
    on_cpu = _all_on_cpu(r, k, v, w, u, state, *extra)
    if state_out is None:
        return _Wkv.apply(plain, r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        raise RuntimeError("wkv: the in-place state update (state_out) has "
                           "no gradient; call it under torch.no_grad()")
    if plain or on_cpu:
        return ref.wkv_ref(r, k, v, w, u, state, state_out)
    return _wkv.wkv(r, k, v, w, u, state, state_out)


def ts_scan(terms, carry, switch_u, arrive_u, jitter, svc, harvest_u,
            rec_lo: int, rec_hi: int, hist):
    """One chunk of memsim's timestep backlog scan: carry and hist updated
    in place (arguments: ``ref.ts_scan_ref``)."""
    extra = () if harvest_u is None else (harvest_u,)
    if _all_on_cpu(terms, carry, switch_u, arrive_u, jitter, svc, hist,
                   *extra):
        return ref.ts_scan_ref(terms, carry, switch_u, arrive_u, jitter, svc,
                               harvest_u, rec_lo, rec_hi, hist)
    return _ms.ts_scan(terms, carry, switch_u, arrive_u, jitter, svc,
                       harvest_u, rec_lo, rec_hi, hist)


def event_scan(terms, W, gaps, svc, rec_time, hist):
    """One chunk of memsim's Lindley scan: W and hist updated in place
    (arguments: ``ref.event_scan_ref``)."""
    if _all_on_cpu(terms, W, gaps, svc, rec_time, hist):
        return ref.event_scan_ref(terms, W, gaps, svc, rec_time, hist)
    return _ms.event_scan(terms, W, gaps, svc, rec_time, hist)
