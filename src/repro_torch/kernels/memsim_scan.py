"""memsim stage B: wrappers of the two scan kernels for Hopper.

The kernels (``csrc/memsim_scan.cu``, one library with two launchers)
replace the reference's two ``lax.scan`` loops in ``repro/core/memsim.py``:
``memsim_ts_scan`` (K4) the timestep engine's backlog scan
``_ts_chunk_core``, ``memsim_event_scan`` (K5) the event engine's Lindley
scan ``_event_chunk_core``.  Each call runs one chunk of steps over n
lanes, 32 lanes a block: one warp copies the draws into a ring of
``ring_steps()`` steps in shared memory, the other runs the lanes' chains
from it.  It updates the carry in place and adds the chunk's recorded
latencies to a per-lane int32 histogram in place.  The source note gives
the design and the bound (``scan_bytes`` counts the bytes).

The wrappers launch on CUDA tensors only: float32 terms, carries and
draws, a bool ``rec_time``, an int32 ``(n, 1024)`` histogram, all on one
device and contiguous; anything else raises.  The plain versions are
``ref.ts_scan_ref`` / ``ref.event_scan_ref``; ``ops.ts_scan`` /
``ops.event_scan`` pick between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary, Kernel

N_BINS = 1024                  # the kernels' histogram width (memsim.N_BINS)

LIBRARY = CudaLibrary("memsim_scan")
_P, _I = ctypes.c_void_p, ctypes.c_int
#: One kernel per engine, both from ``csrc/memsim_scan.cu``; each counts
#: its launches (one a chunk).
KERNELS = {
    "memsim_ts_scan": Kernel(
        "memsim_ts_scan", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                           _P], LIBRARY),
    "memsim_event_scan": Kernel(
        "memsim_event_scan", [_P, _P, _P, _P, _P, _I, _I, _P, _P], LIBRARY),
}


def ring_steps() -> int:
    """Steps of draws the kernels stage ahead in shared memory (the
    source's ``kDepth``); builds the library."""
    fn = LIBRARY.load().memsim_scan_ring_steps
    fn.restype = ctypes.c_int
    return int(fn())


def scan_bytes(name: str, steps: int, n: int) -> int:
    """Bytes one launch must move: each draw read once (an unharvested
    timestep launch reads four float32 a lane-step, an event launch two
    float32 and a flag), the terms read once, the carry and the histogram
    read and written once."""
    hist = 2 * n * N_BINS * 4
    if name == "memsim_ts_scan":
        return steps * n * 4 * 4 + 9 * n * 4 + 2 * 3 * n * 4 + hist
    return steps * n * (4 + 4 + 1) + 2 * n * 4 + 2 * n * 4 + hist


def _check(name, tensors, dtypes, shapes):
    dev = tensors[0].device
    for i, (t, dt, shape) in enumerate(zip(tensors, dtypes, shapes)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: input {i} is on {t.device}; the "
                             f"kernel needs every input on one CUDA device")
        if t.dtype != dt:
            raise TypeError(f"{name}: input {i} is {t.dtype}; the kernel "
                            f"takes {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: input {i} has shape {tuple(t.shape)}"
                             f", expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input {i} must be contiguous")


def ts_scan(terms, carry, switch_u, arrive_u, jitter, svc, harvest_u,
            rec_lo: int, rec_hi: int, hist):
    """One chunk of the timestep backlog scan, in place (see
    ``ref.ts_scan_ref`` for the arguments).  Launches the CUDA kernel."""
    steps, n = switch_u.shape
    f32 = torch.float32
    tensors = [terms, carry, switch_u, arrive_u, jitter, svc, hist]
    dtypes = [f32] * 6 + [torch.int32]
    shapes = [(9, n), (3, n)] + [(steps, n)] * 4 + [(n, N_BINS)]
    if harvest_u is not None:
        tensors.append(harvest_u)
        dtypes.append(f32)
        shapes.append((steps, n))
    _check("memsim_ts_scan", tensors, dtypes, shapes)
    if steps == 0 or n == 0:
        return
    stream = torch.cuda.current_stream(terms.device).cuda_stream
    hu = None if harvest_u is None else harvest_u.data_ptr()
    with torch.cuda.device(terms.device):
        KERNELS["memsim_ts_scan"].launch(
            terms.data_ptr(), carry.data_ptr(), switch_u.data_ptr(),
            arrive_u.data_ptr(), jitter.data_ptr(), svc.data_ptr(), hu,
            steps, n, int(rec_lo), int(rec_hi), hist.data_ptr(), stream,
            config="float32")


def event_scan(terms, W, gaps, svc, rec_time, hist):
    """One chunk of the Lindley scan, in place (see ``ref.event_scan_ref``
    for the arguments).  Launches the CUDA kernel."""
    steps, n = gaps.shape
    f32 = torch.float32
    _check("memsim_event_scan", [terms, W, gaps, svc, rec_time, hist],
           [f32, f32, f32, f32, torch.bool, torch.int32],
           [(2, n), (n,), (steps, n), (steps, n), (steps, n), (n, N_BINS)])
    if steps == 0 or n == 0:
        return
    stream = torch.cuda.current_stream(terms.device).cuda_stream
    with torch.cuda.device(terms.device):
        KERNELS["memsim_event_scan"].launch(
            terms.data_ptr(), W.data_ptr(), gaps.data_ptr(), svc.data_ptr(),
            rec_time.data_ptr(), steps, n, hist.data_ptr(), stream,
            config="float32")
