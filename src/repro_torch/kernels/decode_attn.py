"""GQA flash-decode attention: wrapper of the hand kernel for Hopper.

The kernel (``csrc/decode_attn.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attn.py::_decode_kernel``: one query token per
sequence attends the valid prefix ``pos < length`` of its KV cache.  It is
bounded by the K/V bytes it reads, ``2 * B * length * Hk * D * itemsize``;
the source note says how its design streams them.

``decode_attn`` here launches the kernel on CUDA tensors only and raises on
anything it does not take.  Its plain version is ``ref.decode_attn_ref``;
``ops.decode_attn`` picks between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


KERNEL = Kernel("decode_attn", [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,             # is_bf16, D, G
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # q, k, v
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,          # out, B, S
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])         # Hk, length, stream


def _check(q, k, v, length):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attn: want q (B,Hq,D), k=v (B,S,Hk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    _, s, hk, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hk:
        raise ValueError(f"decode_attn: shapes disagree: q {tuple(q.shape)},"
                         f" k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attn: {name} is on {t.device}; the "
                             f"kernel needs every input on one CUDA device")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"decode_attn: {name} is {t.dtype}; the kernel "
                            f"takes float32 or bfloat16, one type for all")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attn: {name} must be contiguous and "
                             f"16-byte aligned")
    if isinstance(length, bool) or not isinstance(length, int):
        raise TypeError(f"decode_attn: length must be a host int, got "
                        f"{type(length).__name__}")
    if not 1 <= length <= s:
        raise ValueError(f"decode_attn: length {length} outside [1, {s}]")


def decode_attn(q, k, v, length: int):
    """q: (B, Hq, D); k/v: (B, S, Hk, D); length: int in [1, S]
    -> (B, Hq, D) in q.dtype.  Launches the CUDA kernel."""
    _check(q, k, v, length)
    b, hq, d = q.shape
    _, s, hk, _ = k.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        KERNEL.launch(DTYPES[q.dtype], d, hq // hk, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hk,
                      length, stream, config=f"head dim {d}, group {hq // hk}")
    return out
