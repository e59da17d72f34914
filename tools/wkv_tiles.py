"""Time the wkv kernel of the PyTorch port at other register tiles.

    PYTHONPATH=src python tools/wkv_tiles.py

``src/repro_torch/kernels/csrc/rwkv_wkv.cu`` fixes its tile at compile
time: ``kKeyGroups`` key groups P (each thread holds D / P keys) and
``kColumns`` value columns C a thread, P 4 and C 4.  This script writes a
copy of the source for each (P, C) in TILES with those two constants
replaced, builds each copy (one nvcc each, all started together, into the
port's git-ignored ``kernels/_build/``), holds each build to
``ref.wkv_ref`` within the kernel tests' tolerance and to chaining bit for
bit, and then times all builds in turns, forward and back, at
rwkv6-1.6b's serving shapes:

* prefill: B 8, T 1024, H 32, D 64, bf16 r/k/v; device time a launch by
  the profiler over 5 launches, and the mean of 20 back-to-back launches
  by CUDA events;
* decode: T 1, 24 distinct states (one a layer) updated in place, as a
  decode step has them; device time a launch by the profiler.  Beside it,
  the device time of PyTorch's elementwise kernel reading and writing the
  same 24 states in place (``mul_(1.0)``): the same state bytes, and no
  wkv work.

It prints the card (nvidia-smi name, power limit), one line per build and
timing, and last a JSON object with the numbers.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import rwkv_wkv as kw

#: (key groups, columns a thread) to build; (4, 4) is the source's own.
TILES = ((4, 4), (8, 4), (16, 4), (8, 8), (16, 8))
WKV_TOL = dict(atol=1e-4, rtol=1e-4)   # the kernel tests' tolerance


def tile_source(p: int, c: int) -> str:
    """The kernel's source with the tile set to ``p`` key groups and ``c``
    columns a thread; raises if the source no longer states them."""
    src = kw.KERNEL.library.source.read_text()
    for name, val in (("kKeyGroups", p), ("kColumns", c)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {val};", src)
        if n != 1:
            raise RuntimeError(f"{kw.KERNEL.library.source} states "
                               f"{name} {n} times, not once")
    return src


def tile_kernel(p: int, c: int) -> build.Kernel:
    """A launcher of the source built at tile (p, c)."""
    lib = build.CudaLibrary("rwkv_wkv")
    lib.source = build.BUILD_DIR / "wkv_tiles" / f"rwkv_wkv_p{p}_c{c}.cu"
    lib.source.parent.mkdir(parents=True, exist_ok=True)
    lib.source.write_text(tile_source(p, c))
    return build.Kernel("rwkv_wkv", kw.KERNEL.argtypes, lib)


@contextlib.contextmanager
def launching(kernel: build.Kernel):
    """``kw.wkv`` and ``kw.geometry`` go through ``kernel`` inside."""
    saved, kw.KERNEL = kw.KERNEL, kernel
    try:
        yield
    finally:
        kw.KERNEL = saved


def inputs(b, t, h, d, dtype, seed):
    """r, k, v in ``dtype``; w in time_mix's range; u, state fp32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    r, k, v = (mk(b, t, h, d).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(mk(b, t, h, d) - 3.0))
    return r, k, v, w, mk(h, d), mk(b, h, d, d)


def device_ms(fn, launches: int, kernel: str = "wkv_kernel"):
    """Device time a launch of the kernel whose name holds ``kernel`` over
    one call of ``fn`` (which makes ``launches`` launches), by the
    profiler; None if it saw none."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and
            kernel in ev.key]
    if not rows or rows[0].count != launches:
        return None
    return rows[0].self_device_time_total / 1e3 / launches


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(tile):
    """Fail unless the build agrees with wkv_ref and chains bit for bit."""
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, h, d in ((2, 77, 4, 64), (3, 40, 4, 16), (2, 33, 4, 32),
                           (8, 1, 32, 64)):
            args = inputs(b, t, h, d, dtype, seed=t + d)
            y, s = kw.wkv(*args)
            y_ref, s_ref = ref.wkv_ref(*args)
            if not (torch.allclose(y, y_ref, **WKV_TOL) and
                    torch.allclose(s, s_ref, **WKV_TOL)):
                sys.exit(f"{tile}: wkv disagrees with wkv_ref at "
                         f"{(b, t, h, d)}, {dtype}")
            if t > 1:
                cut = t // 3 + 1
                part = lambda x, sl: x[:, sl].contiguous()
                r, k, v, w, u, s0 = args
                y1, s1 = kw.wkv(*(part(x, slice(0, cut))
                                  for x in (r, k, v, w)), u, s0)
                y2, s2 = kw.wkv(*(part(x, slice(cut, None))
                                  for x in (r, k, v, w)), u, s1)
                if not (torch.equal(torch.cat([y1, y2], 1), y) and
                        torch.equal(s2, s)):
                    sys.exit(f"{tile}: chaining is not bit-exact at "
                             f"{(b, t, h, d)}, {dtype}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--layers", type=int, default=24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("wkv_tiles: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kernels = {tile: tile_kernel(*tile) for tile in TILES}
    build.load_all([kern.library for kern in kernels.values()])
    b, t, h, d = args.batch, args.prompt_len, args.heads, 64
    for tile, kern in kernels.items():
        for line in kern.library.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{tile} ptxas: {line.strip()}", flush=True)
        with launching(kern):
            check(tile)
            geo = kw.geometry(torch.bfloat16, (b, t, h, d))
        print(f"{tile}: agrees with wkv_ref, chains bit-exactly; launch "
              f"{geo}", flush=True)

    prefill = inputs(b, t, h, d, torch.bfloat16, seed=5)
    layers = [inputs(b, 1, h, d, torch.bfloat16, seed=100 + i)
              for i in range(args.layers)]
    res = {tile: {"prefill_dev_ms": [], "prefill_events_ms": [],
                  "decode_dev_ms": []} for tile in TILES}
    in_place = []
    for tile in (*TILES, *reversed(TILES)):
        touch = lambda: [a[5].mul_(1.0) for a in layers]
        touch()
        in_place.append(device_ms(touch, args.layers, "elementwise"))
        with launching(kernels[tile]):
            one = lambda: kw.wkv(*prefill)
            res[tile]["prefill_events_ms"].append(events_ms(one))
            res[tile]["prefill_dev_ms"].append(
                device_ms(lambda: [one() for _ in range(5)], 5))
            step = lambda: [kw.wkv(*a, state_out=a[5]) for a in layers]
            step()
            res[tile]["decode_dev_ms"].append(device_ms(step, args.layers))
    for tile, row in res.items():
        print(f"P {tile[0]} C {tile[1]}: prefill B{b} T{t} H{h} D{d} bf16: "
              f"device {row['prefill_dev_ms']} ms a launch (profiler), events "
              f"{row['prefill_events_ms']} ms; decode T1, {args.layers} "
              f"states in place: device {row['decode_dev_ms']} ms a launch",
              flush=True)
    print(f"mul_(1.0) of the same {args.layers} states in place: device "
          f"{in_place} ms a launch", flush=True)
    out = {"card": smi, "shape": [b, t, h, d],
           "tiles": {f"P{p}_C{c}": row for (p, c), row in res.items()},
           "state_in_place_mul_ms": in_place}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
