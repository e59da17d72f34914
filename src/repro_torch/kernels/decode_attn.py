"""GQA flash-decode attention: wrapper of the hand kernel for Hopper.

The kernel (``csrc/decode_attn.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attn.py::_decode_kernel``: one query token per
sequence attends the valid prefix ``pos < length`` of its KV cache.  It is
bounded by the K/V bytes it reads, ``2 * B * length * Hk * D * itemsize``.
Each (batch, KV head)'s prefix is cut into ``P`` parts of whole tiles
(:func:`partition`); the ``P`` blocks of one (batch, KV head) form a
thread-block cluster and merge their softmax partials in the same launch
(a lone part writes its result itself).
The source note gives the ring of tiles and the tensor-core products.

``decode_attn`` here launches the kernel on CUDA tensors only and raises on
anything it does not take.  Its plain version is ``ref.decode_attn_ref``;
``ops.decode_attn`` picks between the two by the tensors' device.

``decode_attn_partials`` launches the partial build of the same source:
the same cut and cluster merge, but it writes the merged float32 terms
(m, l, acc) of the keys ``[0, length)`` in place of their normalized
output, for a rank that holds one slice of a sequence-split cache (the
channelized decode, ``ops.decode_attn``); ``length`` may be 0.  Its plain
version is ``ref.decode_attn_partials_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import Kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Keys a tile and the most parts (one cluster) a (batch, KV head) takes:
#: ``kTileKeys`` and ``kMaxParts`` of ``csrc/decode_attn.cu``, whose
#: launcher refuses a split that is not made of whole tiles.
TILE_KEYS = 64
MAX_PARTS = 16
#: Parts hold at least this many keys, so that each block still streams.
MIN_PART_KEYS = 256

KERNEL = Kernel("decode_attn", [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,             # is_bf16, D, G
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # q, k, v
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,          # out, B, S
    ctypes.c_int, ctypes.c_int,                           # Hk, length
    ctypes.c_int, ctypes.c_int,                           # parts, part_keys
    ctypes.c_void_p])                                     # stream

#: The partial build: one library with :data:`KERNEL`, its own launch count.
PARTIALS = Kernel("decode_attn_partials", [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,             # is_bf16, D, G
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # q, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # m, l, acc
    ctypes.c_int, ctypes.c_int,                           # B, S
    ctypes.c_int, ctypes.c_int,                           # Hk, length
    ctypes.c_int, ctypes.c_int,                           # parts, part_keys
    ctypes.c_void_p], library=KERNEL.library)             # stream


class Split(NamedTuple):
    """``parts`` blocks a (batch, KV head), each taking ``part_keys`` keys
    (a whole number of tiles) of the prefix; the last parts may be empty."""

    parts: int
    part_keys: int

    def bounds(self, length: int) -> list[tuple[int, int]]:
        """Each part's keys ``[lo, hi)`` within ``[0, length)``, as the
        kernel cuts them."""
        return [(min(p * self.part_keys, length),
                 min((p + 1) * self.part_keys, length))
                for p in range(self.parts)]


def split(parts: int, length: int) -> Split:
    """``length`` keys in ``parts`` parts of whole tiles (at least one
    tile a part: a length of 0 leaves every part empty)."""
    tiles = max(1, -(-length // TILE_KEYS))
    return Split(parts, -(-tiles // parts) * TILE_KEYS)


def partition(b: int, hk: int, length: int, sms: int) -> Split:
    """The split the kernel takes for ``b`` x ``hk`` (batch, KV head) pairs
    of ``length`` keys on a card of ``sms`` SMs: the most parts, a power of
    two, that keep the blocks to one wave of at most one an SM, while each
    part keeps ``MIN_PART_KEYS`` keys and one cluster holds them all.

    One block an SM streams at the card's rate (it keeps two tiles in
    flight); more blocks only add each block's fixed cost (its first
    tiles' latency, the merge) and clusters that the GPCs cannot all hold
    at once (``tools/decode_attn_levers.py`` times the alternatives)."""
    limit = min(MAX_PARTS, max(1, length // MIN_PART_KEYS))
    parts = 1
    while parts * 2 <= limit and b * hk * parts * 2 <= sms:
        parts *= 2
    return split(parts, length)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: The head dims and query groups the library is built for
#: (``csrc/decode_attn.cu``'s ``switch_d`` and ``switch_g``).
HEAD_DIMS, GROUPS = (16, 32, 64, 80, 128), (1, 2, 4, 8, 12)


def built(d: int, g: int) -> bool:
    """Whether K2 is built for head dim ``d`` and group ``g``."""
    return d in HEAD_DIMS and g in GROUPS


def _check(q, k, v, length, least: int = 1):
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
    if not least <= length <= s:
        raise ValueError(f"decode_attn: length {length} outside "
                         f"[{least}, {s}]")


def decode_attn(q, k, v, length: int):
    """q: (B, Hq, D); k/v: (B, S, Hk, D); length: int in [1, S]
    -> (B, Hq, D) in q.dtype.  Launches the CUDA kernel, split by
    :func:`partition`."""
    _check(q, k, v, length)
    cut = partition(q.shape[0], k.shape[2], length, _sms(q.device.index))
    return _launch(q, k, v, length, cut)


def _launch(q, k, v, length: int, cut: Split):
    """The launch of checked inputs, split by ``cut``: what
    :func:`decode_attn` does with :func:`partition`'s split, and what the
    card tests and ``tools/decode_attn_levers.py`` call to force one."""
    if not 1 <= cut.parts <= MAX_PARTS:
        raise ValueError(f"decode_attn: parts {cut.parts} outside "
                         f"[1, {MAX_PARTS}]")
    b, hq, d = q.shape
    _, s, hk, _ = k.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        KERNEL.launch(DTYPES[q.dtype], d, hq // hk, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hk,
                      length, cut.parts, cut.part_keys, stream,
                      config=f"head dim {d}, group {hq // hk}")
    return out


def decode_attn_partials(q, k, v, length: int):
    """q: (B, Hq, D); k/v: (B, S, Hk, D); length: int in [0, S] -> the
    float32 terms of the keys ``[0, length)``: m (B, Hq), the largest
    scaled score (-1e30 for no key); l (B, Hq), the sum of exp(score - m);
    acc (B, Hq, D), the sum of exp(score - m) v.  Launches the partial
    build of the CUDA kernel, split by :func:`partition`."""
    _check(q, k, v, length, least=0)
    cut = partition(q.shape[0], k.shape[2], length, _sms(q.device.index))
    return _launch_partials(q, k, v, length, cut)


def _launch_partials(q, k, v, length: int, cut: Split):
    """:func:`_launch` of the partial build."""
    if not 1 <= cut.parts <= MAX_PARTS:
        raise ValueError(f"decode_attn_partials: parts {cut.parts} outside "
                         f"[1, {MAX_PARTS}]")
    b, hq, d = q.shape
    _, s, hk, _ = k.shape
    m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        PARTIALS.launch(DTYPES[q.dtype], d, hq // hk, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), m.data_ptr(),
                        l.data_ptr(), acc.data_ptr(), b, s, hk, length,
                        cut.parts, cut.part_keys, stream,
                        config=f"head dim {d}, group {hq // hk}")
    return m, l, acc


#: What the library's geometry reports, in its order.
GEOMETRY = ("threads", "tile_keys", "stages", "ring_bytes", "smem_bytes",
            "max_parts", "blocks_per_sm", "clusters")


def geometry(dtype, shape, length: int) -> dict:
    """The launch ``decode_attn`` makes for q of ``dtype`` and a cache of
    ``shape`` (B, Hq, Hk, D, S) at ``length``: the split (parts = cluster
    size, keys a part), blocks, threads a block, the ring's tile, stages
    and bytes, dynamic shared bytes a block, and the blocks and clusters
    the current device holds at once.  Builds the library at first use;
    launches nothing."""
    b, _, hk, _, _ = shape
    cut = partition(b, hk, length, _sms(torch.cuda.current_device()))
    return _geometry(dtype, shape, cut)


def _geometry(dtype, shape, cut: Split) -> dict:
    """:func:`geometry` of the launch split by ``cut``."""
    b, hq, hk, d, _ = shape
    KERNEL.fn()   # builds and loads the library
    fn = KERNEL.library.load().decode_attn_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(GEOMETRY))()
    err = fn(DTYPES[dtype], d, hq // hk, cut.parts, out)
    if err == -1:
        raise ValueError(f"decode_attn: no kernel built for head dim {d}, "
                         f"group {hq // hk}")
    if err:
        raise RuntimeError(f"decode_attn geometry: "
                           f"{KERNEL._error_string(err).decode()}")
    return {"parts": cut.parts, "cluster": cut.parts,
            "part_keys": cut.part_keys, "blocks": b * hk * cut.parts,
            **dict(zip(GEOMETRY, out))}
