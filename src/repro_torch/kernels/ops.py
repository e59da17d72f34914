"""Public wrappers for the hand kernels: dispatch by the tensors' device.

Port of ``repro/kernels/ops.py``, whose ``on_tpu()`` / ``_interp()`` chose
between the compiled Pallas kernel and interpret mode.  Here:

* every input on the CPU -> the plain PyTorch version in ``ref.py``;
* every input on CUDA    -> the hand kernel, which counts the launch;
* anything else (mixed devices, or a dtype, shape or layout the kernel
  does not take) raises.  Nothing falls back.
"""

from __future__ import annotations

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


def wkv(r, k, v, w, u, state, state_out=None):
    """r/k/v/w: (B, T, H, D); u: (H, D); state: (B, H, D, D) fp32.

    Returns (y (B, T, H, D) fp32, final state (B, H, D, D) fp32); the
    final state goes into ``state_out`` when given (it may be ``state``)."""
    extra = () if state_out is None else (state_out,)
    if _all_on_cpu(r, k, v, w, u, state, *extra):
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
