"""Threefry-2x32 counter-based random bits in integer torch ops.

The generator the reference gets from ``jax.random``, in the scheme JAX
calls *partitionable* (``jax_threefry_partitionable``, the default since
JAX 0.5; the module ``jax/_src/prng.py`` defines it).  In that scheme:

  * a key is two 32-bit words; ``prng_key(seed)`` is ``[seed >> 32,
    seed & 0xFFFFFFFF]``;
  * ``split(key, n)`` is ``threefry2x32(key, (0, i))`` for ``i < n``, the
    two output words forming key ``i``;
  * ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
  * ``random_bits(key, shape)`` is ``y0 ^ y1`` of ``threefry2x32(key,
    (i >> 32, i & 0xFFFFFFFF))`` over the row-major flat index ``i``;
  * ``uniform`` puts the top 23 bits in a float's mantissa,
    ``bitcast((bits >> 9) | 0x3F800000) - 1``, then ``max(minval,
    f * (1 - minval) + minval)`` in float32.

So these functions give the reference's draws bit for bit, on the CPU and
on CUDA alike: the hash is integer arithmetic, carried in int64 tensors
masked to 32 bits (uint32 arithmetic has no full torch support).  A word
is an int64 in ``[0, 2**32)``; a key is an int64 tensor whose last axis
holds its two words.  The older non-partitionable scheme (JAX < 0.5,
which ``requirements-dev.txt`` still admits) draws other bits and is not
reproduced.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000          # float32 1.0


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counts ``(x0, x1)`` under key
    ``(k0, k1)``; all int64 words, broadcast together.  Returns the two
    output words (new tensors; the rounds run in place on them)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = torch.broadcast_tensors((x0 + ks[0]) & MASK,
                                     (x1 + ks[1]) & MASK)
    x0, x1 = x0.contiguous(), x1.clone(memory_format=torch.contiguous_format)
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_left_shift(x1, r, out=tmp)       # rotate left by r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(tmp)
            x1.bitwise_and_(MASK).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x0, x1


def prng_key(seed: int, device="cpu"):
    """``jax.random.PRNGKey(seed)``: an int64 tensor of two words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def split(key, n: int):
    """``jax.random.split(key, n)``: ``(n, 2)`` keys."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``, batched over ``data``: one key
    per element of the int64 tensor ``data`` (values read as uint32),
    shape ``data.shape + (2,)``."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, shape):
    """``jax.random.bits(key, shape)`` (uint32), as int64 words."""
    shape = tuple(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=key.device).reshape(shape)
    y0, y1 = threefry2x32(key[0], key[1], i >> 32, i & MASK)
    return y0 ^ y1


def _to_uniform(bits, minval: float):
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0:
        return f              # f * 1 + 0 is f exactly
    # float32 minval and 1 - minval, as Python floats (no device copy).
    lo = np.float32(minval)
    span = float(np.float32(1.0) - lo)
    return torch.clamp(f * span + float(lo), min=float(lo))


def uniform(key, shape, minval: float = 0.0):
    """``jax.random.uniform(key, shape, minval=minval)`` in float32 (upper
    bound 1)."""
    return _to_uniform(random_bits(key, shape), minval)


def lane_uniform(key, lanes, shape, minval: float = 0.0, dims=None):
    """One stream per lane: ``uniform(fold_in(key, lane), shape, minval)``
    for each lane id of the int64 tensor ``lanes`` (``(n,)``, uint32
    values), stacked on a trailing lane axis: ``shape + (n,)`` float32.
    The reference's ``vmap(fold_in)`` then ``vmap(uniform)`` and
    ``moveaxis`` (``memsim._lane_uniforms``).

    ``dims`` permutes the draw axes as ``Tensor.permute`` would (the lane
    axis stays last), and the result is made contiguous in that order
    directly: each draw keeps its index in ``shape``."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=lanes.device).reshape(shape)
    if dims is not None:
        idx = idx.permute(*dims)
    lane_keys = fold_in(key, lanes)                       # (n, 2)
    i = idx.unsqueeze(-1)
    y0, y1 = threefry2x32(lane_keys[:, 0], lane_keys[:, 1], i >> 32,
                          i & MASK)
    return _to_uniform(y0 ^ y1, minval)
