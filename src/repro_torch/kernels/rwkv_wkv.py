"""RWKV6 WKV recurrence: wrapper of the hand kernel for Hopper.

The kernel (``csrc/rwkv_wkv.cu``) replaces the Pallas TPU kernel
``repro/kernels/rwkv_wkv.py::_wkv_kernel``:

    y_t = r_t (S + u * k_t^T v_t);   S <- diag(w_t) S + k_t^T v_t

sequential in t, one (D, D) fp32 state per (batch, head).  At a prefill
shape it is bounded by its 5 * B*T*H*D^2 fp32 operations (the bonus term
u factors out of the sum), at a decode step by the state's bytes.  The
source note gives the lane map (a tile of keys x columns a thread, fixed
at compile time), the chunks staged by asynchronous copy, and why chaining
stays bit-exact; ``geometry`` reports the launch the kernel makes.

``wkv`` here launches the kernel on CUDA tensors only and raises on
anything it does not take.  Its plain version is ``ref.wkv_ref``;
``ops.wkv`` picks between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel

#: r/k/v types the kernel takes (w, u, the state and y are fp32).
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = Kernel("rwkv_wkv", [
    ctypes.c_int, ctypes.c_int,                           # is_bf16, D
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # r, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # w, u, s0
    ctypes.c_void_p, ctypes.c_void_p,                     # y, state_out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,             # B, T, H
    ctypes.c_void_p])                                     # stream


def _overlap(a, b) -> bool:
    lo_a, lo_b = a.data_ptr(), b.data_ptr()
    return (lo_a < lo_b + b.numel() * b.element_size() and
            lo_b < lo_a + a.numel() * a.element_size())


def _check(r, k, v, w, u, state, state_out, who="wkv", extra=()):
    """Raise on anything the kernel does not take.  ``extra``: more
    (name, tensor) pairs that must be fp32, contiguous and on r's device
    (the backward's dy and final-state gradient)."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"{who}: want r, k, v, w all (B,T,H,D); got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, t, h, d = r.shape
    if u.shape != (h, d) or state.shape != (b, h, d, d):
        raise ValueError(f"{who}: want u (H,D) = {(h, d)} and state "
                         f"(B,H,D,D) = {(b, h, d, d)}; got "
                         f"{tuple(u.shape)}, {tuple(state.shape)}")
    if t < 1:
        raise ValueError(f"{who}: the kernel needs T >= 1")
    if state_out.shape != state.shape:
        raise ValueError(f"{who}: want state_out {tuple(state.shape)}; got "
                         f"{tuple(state_out.shape)}")
    # state_out may be state itself (in place), never a part of it.
    if state_out.data_ptr() != state.data_ptr() and \
            _overlap(state_out, state):
        raise ValueError(f"{who}: state_out overlaps state without being it")
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
             ("state", state), ("state_out", state_out), *extra)
    for name, x in named:
        if x.device.type != "cuda" or x.device != r.device:
            raise ValueError(f"{who}: {name} is on {x.device}; the kernel "
                             f"needs every input on one CUDA device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be contiguous and 16-byte "
                             f"aligned")
    for name, x in named[:3]:
        if x.dtype not in DTYPES or x.dtype != r.dtype:
            raise TypeError(f"{who}: {name} is {x.dtype}; r, k, v must be "
                            f"float32 or bfloat16, one type for all three")
    for name, x in named[3:]:
        if x.dtype != torch.float32:
            raise TypeError(f"{who}: {name} is {x.dtype}; the kernel takes "
                            f"it in float32")


def wkv(r, k, v, w, u, state, state_out=None):
    """r/k/v: (B, T, H, D) fp32 or bf16; w: (B, T, H, D) fp32; u: (H, D)
    fp32; state: (B, H, D, D) fp32.  Returns (y (B, T, H, D) fp32, final
    state (B, H, D, D) fp32).  The final state is written into
    ``state_out`` when given, which may be ``state`` itself (in place),
    else into a new tensor.  Launches the CUDA kernel.
    """
    s_out = torch.empty_like(state) if state_out is None else state_out
    _check(r, k, v, w, u, state, s_out)
    b, t, h, d = r.shape
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        KERNEL.launch(DTYPES[r.dtype], d, r.data_ptr(), k.data_ptr(),
                      v.data_ptr(), w.data_ptr(), u.data_ptr(),
                      state.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, t,
                      h, stream, config=f"head dim {d}")
    return y, s_out


#: What ``geometry`` reports, in the order the library writes it.
GEOMETRY = ("blocks", "threads", "chunk_steps", "key_groups", "columns",
            "smem_bytes", "blocks_per_sm")
#: What ``geometry_bwd`` reports: blocks (one a (batch, head)), threads a
#: block, steps a segment, keys and value columns a thread, dynamic shared
#: bytes a block, blocks an SM of the current device holds at once,
#: registers a thread.
GEOMETRY_BWD = ("blocks", "threads", "segment", "keys", "columns",
                "smem_bytes", "blocks_per_sm", "registers")


def _geometry(kernel, names, dtype, shape) -> dict:
    kernel.fn()   # builds and loads the library
    fn = getattr(kernel.library.load(), f"{kernel.name}_geometry")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(names))()
    b, t, h, d = shape
    err = fn(DTYPES[dtype], d, b, t, h, out)
    if err == -1:
        raise ValueError(f"{kernel.name}: no kernel built for head dim {d}")
    if err:
        raise RuntimeError(f"{kernel.name} geometry: "
                           f"{kernel._error_string(err).decode()}")
    return dict(zip(names, out))


def geometry(dtype, shape) -> dict:
    """The launch ``wkv`` makes for r/k/v of ``dtype`` and ``shape``
    (B, T, H, D): blocks, threads a block, steps a chunk, key groups,
    value columns a thread, dynamic shared bytes a block, and the blocks
    an SM of the current device holds at once.  Builds the library at
    first use; launches nothing."""
    return _geometry(KERNEL, GEOMETRY, dtype, shape)


def geometry_bwd(dtype, shape) -> dict:
    """The launch ``wkv_bwd`` makes (``GEOMETRY_BWD``), as ``geometry``."""
    return _geometry(KERNEL_BWD, GEOMETRY_BWD, dtype, shape)


KERNEL_BWD = Kernel("rwkv_wkv_bwd", [
    ctypes.c_int, ctypes.c_int,                           # is_bf16, D
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # r, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # w, u, s0
    ctypes.c_void_p, ctypes.c_void_p,                     # dy, ds_T
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # dr, dk, dv
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # dw, du_part, ds0
    ctypes.c_void_p,                                      # ckpt
    ctypes.c_int, ctypes.c_int, ctypes.c_int,             # B, T, H
    ctypes.c_void_p])                                     # stream

#: Head dims K3b's source builds (it refuses a launch at any other).
HEAD_DIMS_BWD = (16, 32, 64)
#: Steps a segment of K3b (``kSeg`` in the source): it keeps a checkpoint
#: of the state at every segment's start but the last and recomputes a
#: segment's states into shared memory.  ``geometry_bwd`` reports the
#: built value.
SEGMENT = 8


def checkpoint_shape(shape) -> tuple:
    """The fp32 checkpoints K3b keeps in device memory for r of ``shape``
    (B, T, H, D): the state at the start of every segment but the last,
    (B*H, ceil(T / SEGMENT) - 1, D, D).  Raises for a head dim the source
    does not build."""
    b, t, h, d = shape
    if d not in HEAD_DIMS_BWD:
        raise ValueError(f"wkv_bwd: no kernel built for head dim {d} "
                         f"(built: {list(HEAD_DIMS_BWD)})")
    return (b * h, -(-t // SEGMENT) - 1, d, d)


def wkv_bwd(r, k, v, w, u, state, dy, ds_t=None):
    """The backward of ``wkv``: r/k/v (B, T, H, D) fp32 or bf16, w (B, T,
    H, D) fp32, u (H, D) fp32, state (B, H, D, D) fp32 (the initial state
    of the forward), dy (B, T, H, D) fp32, ds_t (B, H, D, D) fp32 or None
    (zero).  Returns (dr, dk, dv in r's type, dw (B, T, H, D) fp32, du
    (H, D) fp32, ds0 (B, H, D, D) fp32).  Launches K3b, one block a
    (batch, head); du is summed over the batch from one partial a (batch,
    head)."""
    ckpt_shape = checkpoint_shape(r.shape)
    extra = [("dy", dy)] + ([] if ds_t is None else [("ds_t", ds_t)])
    _check(r, k, v, w, u, state, state, who="wkv_bwd", extra=extra)
    if dy.shape != r.shape or (ds_t is not None and
                               ds_t.shape != state.shape):
        raise ValueError(f"wkv_bwd: want dy {tuple(r.shape)} and ds_t "
                         f"{tuple(state.shape)}; got {tuple(dy.shape)}, "
                         f"{None if ds_t is None else tuple(ds_t.shape)}")
    b, t, h, d = r.shape
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du_part = torch.empty((b, h, d), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(state)
    ckpt = torch.empty(ckpt_shape, dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        KERNEL_BWD.launch(
            DTYPES[r.dtype], d, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u.data_ptr(), state.data_ptr(), dy.data_ptr(),
            None if ds_t is None else ds_t.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
            ds0.data_ptr(), ckpt.data_ptr(), b, t, h, stream,
            config=f"head dim {d}")
    return dr, dk, dv, dw, du_part.sum(dim=0), ds0
