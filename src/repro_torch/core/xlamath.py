"""float32 ``log``, ``exp``, ``log1p``, ``pow``, FMA and cumulative sums as
the reference's compiled code rounds them, in torch ops.

The reference's DES runs its transcendental math through XLA's CPU code
generator, which does not call a correctly rounded library: ``log`` and
``exp`` are Cephes polynomials evaluated with fused multiply-adds (the
``log`` is off the correctly rounded value in ~14% of float32 inputs, the
``exp`` in ~10%), ``log1p`` is Cephes' rational approximation below
``sqrt(2) - 1`` and ``log(1 + x)`` above, and ``pow`` is the C library's
``powf``.  XLA also contracts some ``a * b + c`` of a compiled function
into one FMA.  These functions give the same float32 results from
elementwise torch ops, so that the port's stage A equals the reference's
on the CPU and on CUDA alike.  That matters for the event engine, whose
``ceil`` onto the 1-ns lattice turns a last-bit difference of an arrival
time into a whole cell: with torch's own float32 math (and
``torch.cumsum``) ~1.6% of its arrivals land in another cell than the
reference's and its histograms drift ~1.5e-2 of their mass (L1), where
with these they are equal (``tools/memsim_agreement.py --plain-math``
measures both).  How they round:

  * an FMA is computed in float64 (the product of two float32 is exact
    there) and rounded once to float32; it differs from a true FMA only
    where that double rounding hits a float32 midpoint (~2**-29 of
    inputs);
  * ``pow`` is float64 ``pow`` rounded to float32; it equals ``powf`` in
    all but ~6e-4 of the inputs of the DES's service draws.

Domain: positive finite ``log`` arguments (0 gives -inf, a negative or
NaN argument NaN), ``exp`` arguments within +-88.37 (clamped there), and
``log1p`` arguments above -1: the DES's own ranges.
"""

from __future__ import annotations

import numpy as np
import torch

F32, F64 = torch.float32, torch.float64


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float: a tensor op takes it as
    that float32 value, with no copy to the device."""
    return float(np.float32(v))


def _f32s(*vs) -> tuple:
    return tuple(_f32(v) for v in vs)


_LOG_P = _f32s(7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
               -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
               2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = _f32s(-2.12194440e-4, 0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_MIN_NORM = _f32(1.17549435e-38)

_EXP_P = _f32s(1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3,
               4.1665795894E-2, 1.6666665459E-1, 5.0000001201E-1)
_EXP_LOG2E = _f32(1.44269504088896341)
_EXP_C1, _EXP_C2 = _f32s(-0.693359375, 2.12194440e-4)
_EXP_HI = _f32(88.3762626647950)

_LOG1P_SMALL = _f32(0.41421356237309504880)      # sqrt(2) - 1
_LOG1P_NUM = _f32s(4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
                   6.5787325942061044846969E0, 2.9911919328553073277375E1,
                   6.0949667980987787057556E1, 5.7112963590585538103336E1,
                   2.0039553499201281259648E1)
_LOG1P_DEN = _f32s(1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
                   2.2176239823732856465394E2, 3.0909872225312059774938E2,
                   2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _wide(v):
    return v.to(F64) if torch.is_tensor(v) else float(v)


def fma(a, b, c):
    """``a * b + c`` in float32 with one rounding; tensors are float32,
    Python floats float32 values (:func:`_f32`); one operand at least is a
    tensor."""
    return (_wide(a) * _wide(b) + _wide(c)).to(F32)


def log(x):
    """Natural log of a float32 tensor (Cephes ``logf``, as XLA's CPU code
    computes it)."""
    x = torch.as_tensor(x, dtype=F32)
    m = torch.clamp(x, min=_MIN_NORM)
    bits = m.view(torch.int32)
    e = (bits >> 23) - 0x7F
    m = ((bits & ~0x7F800000) | 0x3F000000).view(F32)   # in [0.5, 1)
    e = 1.0 + e.to(F32)
    low = m < _SQRTHF
    # m < sqrt(1/2): x = 2m - 1 and e - 1; else x = m - 1.
    e = e - low.to(F32)
    m = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = fma(m, p[0], p[1])
    y1 = fma(m, p[3], p[4])
    y2 = fma(m, p[6], p[7])
    y = fma(y, m, p[2])
    y1 = fma(y1, m, p[5])
    y2 = fma(y2, m, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, _LOG_Q1 * e)
    out = ((m - 0.5 * x2) + y) + _LOG_Q2 * e
    out = torch.where(x == 0.0, float("-inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0.0) | torch.isnan(x), float("nan"), out)


def exp(x):
    """Exponential of a float32 tensor (Cephes ``expf``, as XLA's CPU code
    computes it)."""
    x = torch.clamp(torch.as_tensor(x, dtype=F32), -_EXP_HI, _EXP_HI)
    n = torch.floor(fma(x, _EXP_LOG2E, 0.5))
    r = fma(n, _EXP_C1, x)
    r = fma(n, _EXP_C2, r)
    r2 = r * r
    y = torch.full_like(r, _EXP_P[0])
    for coef in _EXP_P[1:]:
        y = fma(y, r, coef)
    y = fma(y, r2, r) + 1.0
    two_n = ((n.to(torch.int64) + 1023) << 52).view(F64)     # 2**n, exact
    return (y.to(F64) * two_n).to(F32)


def _horner(x, coefs):
    p = torch.zeros_like(x)
    for coef in coefs:
        p = fma(p, x, coef)
    return p


def log1p(x):
    """``log(1 + x)`` of a float32 tensor (XLA's CPU ``log1p``: Cephes'
    rational approximation where ``|x| < sqrt(2) - 1``)."""
    x = torch.as_tensor(x, dtype=F32)
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + (-0.5 * x2 + (x * x2) * small)
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small,
                       log(x + 1.0))


def pow(x, y):
    """``x ** y`` for float32 tensors (the C library's ``powf``, to within
    its last bit in ~6e-4 of the DES's inputs)."""
    x, y = torch.as_tensor(x, dtype=F32), torch.as_tensor(y, dtype=F32)
    return torch.pow(x.to(F64), y.to(F64)).to(F32)


#: Block length of XLA's cumulative sum.  XLA (CPU) computes a cumulative
#: sum of length L > 16 as blocks of 16, each summed left to right, plus
#: the exclusive cumulative sum of the block totals, taken the same way
#: recursively; a length <= 16 is summed left to right.
_XLA_SCAN_BLOCK = 16


def cumsum0(x):
    """Cumulative sum along dim 0 in XLA's order of float additions, so
    that equal inputs give the reference's partial sums bit for bit (a
    float sum's value depends on its order; ``torch.cumsum`` sums in
    another, and on the CPU in float64)."""
    length = x.shape[0]
    b = _XLA_SCAN_BLOCK
    if length <= b:
        out = x.clone()
        for j in range(1, length):
            out[j] += out[j - 1]
        return out
    nb = -(-length // b)
    pad = nb * b - length
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    inner = x.reshape((nb, b) + x.shape[1:]).clone()
    for j in range(1, b):
        inner[:, j] += inner[:, j - 1]
    before = cumsum0(inner[:, -1])
    excl = torch.cat([before.new_zeros((1,) + before.shape[1:]),
                      before[:-1]])
    return (inner + excl[:, None]).reshape((nb * b,) + x.shape[1:])[:length]
