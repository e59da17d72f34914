"""STREAM copy / scale / add / triad: wrappers of the hand kernels for Hopper.

The kernels (``csrc/stream.cu``, one library with one launcher each)
replace the Pallas TPU kernels of ``repro/kernels/stream.py``, the paper's
bandwidth probe (its §5).  Each is bounded by the bytes it moves,
``stream_bytes``; the source note says how its design streams them.

The wrappers launch on CUDA tensors only: float32 or bfloat16, one type for
all arrays, equal shapes, contiguous and 16-byte aligned (a tensor that is
not, such as a view at an odd offset, raises; there is no scalar path for
it).  The arrays are taken as n flat elements, whatever their shape; the
output is a new tensor of the input's shape.  alpha is rounded to the
arrays' type before the launch, as the reference does.  The plain versions
are ``ref.stream_*_ref``; ``ops.stream_*`` picks between the two by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary, Kernel
from repro_torch.kernels.ref import round_to

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Arrays each call reads and writes, by op (as ``repro``'s stream_bytes).
ARRAYS = {"copy": 2, "scale": 2, "add": 3, "triad": 3}

LIBRARY = CudaLibrary("stream")
_P, _I, _F, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
#: One kernel per op, all from ``csrc/stream.cu``; each counts its launches.
KERNELS = {
    "stream_copy": Kernel("stream_copy", [_I, _P, _P, _N, _P], LIBRARY),
    "stream_scale": Kernel("stream_scale", [_I, _P, _P, _F, _N, _P],
                           LIBRARY),
    "stream_add": Kernel("stream_add", [_I, _P, _P, _P, _N, _P], LIBRARY),
    "stream_triad": Kernel("stream_triad", [_I, _P, _P, _P, _F, _N, _P],
                           LIBRARY),
}


def stream_bytes(name: str, shape, dtype=torch.float32) -> int:
    """Bytes one call moves: each input read once, the output written
    once."""
    n = 1
    for d in shape:
        n *= d
    return ARRAYS[name] * n * dtype.itemsize


def _check(name, *arrays):
    a = arrays[0]
    for i, t in enumerate(arrays):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name}: input {i} is on {t.device}; the "
                             f"kernel needs every input on one CUDA device")
        if t.dtype not in DTYPES or t.dtype != a.dtype:
            raise TypeError(f"{name}: input {i} is {t.dtype}; the kernel "
                            f"takes float32 or bfloat16, one type for all")
        if t.shape != a.shape:
            raise ValueError(f"{name}: shapes differ: {tuple(a.shape)} and "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: input {i} must be contiguous and "
                             f"16-byte aligned")


def _run(name, arrays, alpha=None):
    _check(name, *arrays)
    a = arrays[0]
    out = torch.empty_like(a)
    n = a.numel()
    if n == 0:
        return out
    args = [DTYPES[a.dtype], *(t.data_ptr() for t in arrays), out.data_ptr()]
    if alpha is not None:
        args.append(round_to(alpha, a.dtype))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        KERNELS[name].launch(*args, n, stream, config=str(a.dtype))
    return out


def stream_copy(a):
    """o = a.  Launches the CUDA kernel."""
    return _run("stream_copy", (a,))


def stream_scale(a, alpha):
    """o = alpha * a, alpha rounded to a's type.  Launches the CUDA kernel."""
    return _run("stream_scale", (a,), alpha)


def stream_add(a, b):
    """o = a + b.  Launches the CUDA kernel."""
    return _run("stream_add", (a, b))


def stream_triad(a, b, alpha):
    """o = a + alpha * b, rounded as ``ref.stream_triad_ref``.  Launches the
    CUDA kernel."""
    return _run("stream_triad", (a, b), alpha)
