"""STREAM HBM-bandwidth probe: copy, scale, add and triad on the card.

    PYTHONPATH=src python -m repro_torch.launch.stream                # 2**26 f32
    PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --smoke

Port of ``benchmarks/stream_kernels.py``, the paper's bandwidth-roofline
probe (its §5).  Where that script printed a modelled roofline fraction,
this one measures: each op runs through ``kernels.ops`` (the hand kernels
of ``kernels/csrc/stream.cu`` on the card), timed by CUDA events over
``--iters`` launches after ``WARMUP`` launches; it reports the mean and
STREAM's best-of, the bytes/s, and the share of the card's HBM peak
(``core.hw.spec_for``).  Each array follows STREAM's sizing rule, at least
4x the last-level cache (the 50 MB L2): the default 2**26 float32
elements is 268 MB an array.  Below that size the HBM fraction is not
given.  On the card the probe then times each op at the reference's
(2048, 512) float32 shape, which the L2 holds: launch and host time, with
no HBM fraction.  Inputs are made on the device from ``--seed``; the last
output of each op is held to its plain version.  Runs on the card unless
``--device cpu`` is given (the plain versions, timed by the host clock: no
device time); with no card, ``--device cuda`` raises.

Rows are ``name,us_per_call,derived``, as the reference's.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import hw
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import stream as kstream

#: Launches of each op before the clock starts.
WARMUP = 3
#: The reference's shape (``benchmarks/stream_kernels.py``): L2-resident.
REF_SHAPE = (2048, 512)
ALPHA = 2.0                        # the reference's scalar
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OPS = {"copy": (ops.stream_copy, ref.stream_copy_ref, 1, False),
       "scale": (ops.stream_scale, ref.stream_scale_ref, 1, True),
       "add": (ops.stream_add, ref.stream_add_ref, 2, False),
       "triad": (ops.stream_triad, ref.stream_triad_ref, 2, True)}


def emit(name, us, derived):
    """One ``name,us_per_call,derived`` row; ``us=None`` leaves it empty."""
    print(f"{name},{'' if us is None else f'{us:.1f}'},{derived}",
          flush=True)


def _times(fn, iters, device):
    """(mean ms, best ms, last output) of ``iters`` calls after ``WARMUP``:
    CUDA events around each launch on the card, the host clock on the
    CPU."""
    for _ in range(WARMUP):
        out = fn()
    if device.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(iters + 1)]
        torch.cuda.synchronize(device)
        events[0].record()
        for ev in events[1:]:
            out = fn()
            ev.record()
        events[-1].synchronize()
        per = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    else:
        per = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn()
            per.append((time.perf_counter() - t0) * 1e3)
    return sum(per) / iters, min(per), out


def _inputs(shape, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for _ in range(2)]


def _probe(name, arrays, iters, device):
    fn, plain, n_in, scalar = OPS[name]
    args = (*arrays[:n_in], *((ALPHA,) if scalar else ()))
    mean, best, out = _times(lambda: fn(*args), iters, device)
    if not torch.equal(out, plain(*args)):
        raise RuntimeError(f"stream {name}: output differs from its plain "
                           f"version")
    return mean, best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2**26,
                    help="elements per array")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help=f"the reference's {REF_SHAPE} shape")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch sees no CUDA card; pass "
                           "--device cpu to run the plain versions")
    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    shape = REF_SHAPE if args.smoke else (args.n,)
    n = shape[0] * shape[1] if args.smoke else args.n
    on_card = device.type == "cuda"
    card, streams = "", False
    array_bytes = n * dtype.itemsize
    if on_card:
        card_name = torch.cuda.get_device_name(device)
        spec = hw.spec_for(card_name)
        card = f" ({card_name}, H100 {spec.part} peaks)"
        streams = array_bytes >= 4 * spec.l2_bytes
    print(f"[stream] device={device}{card} shape={shape} dtype={args.dtype}"
          f" {array_bytes / 1e6:.1f} MB an array, iters={args.iters} after "
          f"{WARMUP} warm-up", flush=True)
    if on_card:
        build.load_all([kstream.LIBRARY])
        for kern in kstream.KERNELS.values():
            kern.fn()
        if not streams:
            print(f"[stream] arrays below 4 x L2 "
                  f"({4 * spec.l2_bytes / 1e6:.1f} MB): no HBM fraction",
                  flush=True)

    arrays = _inputs(shape, dtype, args.seed, device)
    results = {}
    for name in OPS:
        mean, best = _probe(name, arrays, args.iters, device)
        nbytes = kstream.stream_bytes(name, shape, dtype)
        row = dict(bytes=nbytes, mean_ms=mean, best_ms=best, gbps=None,
                   bound_ms=None, hbm_fraction=None)
        emit(f"stream.{name}.bytes", mean * 1e3, nbytes)
        if not on_card:
            emit(f"stream.{name}.best_us", best * 1e3,
                 "host clock, plain version")
        else:
            row["gbps"] = nbytes / best / 1e6
            row["bound_ms"] = nbytes / spec.hbm_bw * 1e3
            emit(f"stream.{name}.best_us", best * 1e3,
                 f"{row['gbps']:.1f} GB/s")
            emit(f"stream.{name}.hbm_roofline_us", None,
                 f"{row['bound_ms'] * 1e3:.2f}")
            if streams:
                row["hbm_fraction"] = row["bound_ms"] / best
                emit(f"stream.{name}.hbm_fraction", None,
                     f"{row['hbm_fraction']:.4f} (mean "
                     f"{row['bound_ms'] / mean:.4f})")
        results[name] = row
    del arrays
    if on_card and not args.smoke:
        small = _inputs(REF_SHAPE, torch.float32, args.seed, device)
        for name in OPS:
            mean, best = _probe(name, small, args.iters, device)
            results[name]["l2_mean_ms"] = mean
            emit(f"stream.{name}.l2_resident_us", mean * 1e3,
                 f"{REF_SHAPE} float32 in L2: no HBM fraction (best "
                 f"{best * 1e3:.1f} us)")
    return results


if __name__ == "__main__":
    main()
