"""Time the decode attention kernel K2 of the PyTorch port by split and ring.

    PYTHONPATH=src python tools/decode_attn_levers.py
        [--builds s3w4p128,s3w4,s4w2p128] [--parts 0,1,2,4,8,16]
        [--parent FILE]

``src/repro_torch/kernels/csrc/decode_attn.cu`` fixes its ring of K/V
tiles at compile time (``kStages`` tiles of 16 keys a warp, ``kWarps``
warps a block, ``kStages - 1`` tiles loaded ahead) and takes its split
over the cache (``parts`` blocks a (batch, KV head), one cluster) from
the wrapper, which picks it with ``decode_attn.partition``.  This script
writes a copy of the source for each ``s<stages>w<warps>[p128][c]``
in ``--builds`` (``p128``: the copies' 128-byte L2 prefetch, as the
source has it; without, the copy's ``cp.async`` is rewritten to prefetch
nothing; ``c``: the cluster's barriers and merge at one part too, where
the source's lone block writes its result itself; the source's own is
``s3w4p128``), and builds
``--parent``, an
earlier ``decode_attn.cu`` with the launcher of before the split (one
block a (batch, KV head), no split arguments: e.g. ``git show
<commit>:src/repro_torch/kernels/csrc/decode_attn.cu``), beside them (one
nvcc each, all started together, into the port's git-ignored
``kernels/_build/decode_attn_levers/``).  It holds every build to
``ref.decode_attn_ref`` within ``chip_smoke``'s ``KERNEL_TOL`` at each
shape below, in bf16, split by ``partition`` and into every count in
``--parts`` (0 stands for ``partition``'s own), and then times each
(build, split) in turns, forward and back (the parent first and last),
in a CUDA graph of 20 calls (the card's time: ``chip_smoke.graph_ms``)
and by CUDA events around back-to-back calls (which, at the small
shapes, time the host's call rather than the card), each call on the
next of as many copies of the cache as exceed twice the L2 together
(cold, as a decode step finds a layer's cache):

* stablelm-1.6b's decode (B 8, Hq 32, Hk 32, D 64, length 1,040);
* starcoder2-3b's attention (B 8, Hq 24, Hk 2, D 128, length 4,096);
* olmoe-1b-7b's decode (B 8, Hq 16, Hk 16, D 128, length 1,040);
* zamba2-2.7b's decode (B 8, Hq 32, Hk 32, D 80, length 1,040);
* one mistral-large-123b layer at 32k (B 8, Hq 96, Hk 8, D 128, G 12).

Beside each shape: its byte bound at 3.35 TB/s and SDPA's time
(``enable_gqa``) on the same copies.  A build with no kernel at a shape
(the parent at D 80) is left out there.  It prints the card (nvidia-smi
name, power limit), each build's registers (ptxas), one line per
timing, and last a JSON object with the numbers.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke  # noqa: E402  (rand_qkv, time_ms, graph_ms, KERNEL_TOL)
from repro_torch.core import hw  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import decode_attn as da  # noqa: E402

OUT = build.BUILD_DIR / "decode_attn_levers"

#: name -> ((B, Hq, Hk, D, S), length)
SHAPES = {
    "stablelm-1.6b": ((8, 32, 32, 64, 1056), 1040),
    "starcoder2-3b": ((8, 24, 2, 128, 4096), 4096),
    "olmoe-1b-7b": ((8, 16, 16, 128, 1056), 1040),
    "zamba2-2.7b": ((8, 32, 32, 80, 1056), 1040),
    "mistral-large-123b layer": ((8, 96, 8, 128, 32768), 32768),
}


#: The launcher's arguments before the split: no parts, no part_keys.
PARENT_ARGTYPES = [a for i, a in enumerate(da.KERNEL.argtypes)
                   if i not in (11, 12)]
PREFETCH = "cp.async.cg.shared.global.L2::128B"
LONE = "gridDim.x == 1"   # the source's test for a lone part


def patched(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{da.KERNEL.library.source} states {old!r} "
                           f"{text.count(old)} times, not once")
    return text.replace(old, new)


def copy_kernel(build_name: str, src: str) -> build.Kernel:
    lib = build.CudaLibrary("decode_attn")
    lib.source = OUT / f"decode_attn_{build_name}.cu"
    lib.source.parent.mkdir(parents=True, exist_ok=True)
    lib.source.write_text(src)
    return build.Kernel("decode_attn", da.KERNEL.argtypes, lib)


def ring_kernel(build_name: str) -> build.Kernel:
    """A launcher of the source built as ``s<stages>w<warps>[p128][c]``:
    a ring of ``stages`` tiles of 16 keys a warp, ``warps`` warps a block,
    a 128-byte L2 prefetch on each copy (none when left out), and with
    ``c`` the cluster's barriers and merge at one part as well."""
    stages, warps, prefetch, cluster = re.fullmatch(
        r"s(\d+)w(\d+)(p128)?(c)?", build_name).groups()
    src = da.KERNEL.library.source.read_text()
    for const, val in (("kStages", stages), ("kWarps", warps)):
        src, n = re.subn(rf"constexpr int {const} = \d+;",
                         f"constexpr int {const} = {val};", src)
        if n != 1:
            raise RuntimeError(f"{da.KERNEL.library.source} states {const} "
                               f"{n} times, not once")
    if not prefetch:
        src = patched(src, PREFETCH, "cp.async.cg.shared.global")
    if cluster:
        if src.count(LONE) != 2:
            raise RuntimeError(f"{da.KERNEL.library.source} states {LONE!r} "
                               f"{src.count(LONE)} times, not twice")
        src = src.replace(LONE, "false")
    kern = copy_kernel(build_name, src)
    kern.tile_keys = 16 * int(warps)
    return kern


def parent_kernel(path: Path) -> build.Kernel:
    kern = copy_kernel("parent", path.read_text())
    kern.argtypes = PARENT_ARGTYPES
    return kern


def parent_attn(kern: build.Kernel, q, k, v, length: int):
    """``decode_attn`` through the parent's launcher: one block a (batch,
    KV head)."""
    b, hq, d = q.shape
    _, s, hk, _ = k.shape
    out = torch.empty_like(q)
    kern.launch(da.DTYPES[q.dtype], d, hq // hk, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, s, hk, length,
                torch.cuda.current_stream().cuda_stream,
                config=f"head dim {d}, group {hq // hk}")
    return out


@contextlib.contextmanager
def launching(kernel: build.Kernel):
    """``da._launch`` and ``da._geometry`` go through ``kernel``, its
    parts cut in its own tiles."""
    saved = da.KERNEL, da.TILE_KEYS
    da.KERNEL, da.TILE_KEYS = kernel, kernel.tile_keys
    try:
        yield
    finally:
        da.KERNEL, da.TILE_KEYS = saved


#: Mangled kernel names in ptxas's report -> "bf16" or "f32".
KINDS = {"mma": "bf16", "kernelI13__nv_bfloat16": "bf16",
         "lanes": "f32", "kernelIf": "f32"}


def registers(log: str) -> dict:
    """{(bf16 or f32, D, G): registers} from a ptxas -v report, of this
    source's kernels or the parent's."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"decode_attn_(mma|lanes|kernelI13__nv_bfloat16|"
                      r"kernelIf)I?Li(\d+)ELi(\d+)E", line)
        if m:
            name = (KINDS[m.group(1)], int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = int(m.group(1))
            name = None
    return out


def copies_of(shape, seed):
    b, hq, hk, d, s = shape
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    n = max(1, -(-2 * l2 // (2 * b * s * hk * d * 2)))
    return [chip_smoke.rand_qkv(b, hq, hk, d, s, torch.bfloat16, seed + i)
            for i in range(n)]


def cycling(fn, n):
    calls = iter(range(1 << 62))
    return lambda: fn(next(calls) % n)


def runner(kernels, case, shape, length):
    """A call ``(q, k, v) -> out`` of ``case`` = (build, parts) at
    ``shape`` and ``length``, and its geometry (None for the parent)."""
    st, p = case
    if st == "parent":
        return (lambda q, k, v: parent_attn(kernels[st], q, k, v, length),
                None)
    b, _, hk, _, _ = shape
    with launching(kernels[st]):
        cut = (da.partition(b, hk, length,
                            da._sms(torch.cuda.current_device()))
               if p is None else da.split(p, length))
        geo = da._geometry(torch.bfloat16, shape, cut)

    def run(q, k, v):
        with launching(kernels[st]):
            return da._launch(q, k, v, length, cut)
    return run, geo


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--builds", default="s3w4p128,s3w4,s4w2p128")
    ap.add_argument("--parts", default="0,1,2,4,8,16")
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("decode_attn_levers: needs a CUDA card")
    stages = args.builds.split(",")
    splits = [int(x) or None for x in args.parts.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    spec = hw.spec_for(torch.cuda.get_device_name(0))
    kernels = {st: ring_kernel(st) for st in stages}
    if args.parent is not None:
        kernels["parent"] = parent_kernel(args.parent)
    build.load_all([kern.library for kern in kernels.values()])
    regs = {}
    for st, kern in kernels.items():
        kern.fn()
        regs[st] = registers(kern.library.ptxas_log)
        bf = {f"D{d} G{g}": r for (kind, d, g), r in sorted(regs[st].items())
              if kind == "bf16"}
        print(f"{st}: bf16 registers {bf or 'not reported (an identical '
                                       'source was built before)'}",
              flush=True)

    result = {"card": smi, "shapes": {}}
    for name, (shape, length) in SHAPES.items():
        b, hq, hk, d, s = shape
        copies = copies_of(shape, seed=len(name))
        n = len(copies)
        nbytes = 2 * b * length * hk * d * 2 + 2 * b * hq * d * 2
        bound = nbytes / spec.hbm_bw * 1e3
        views = [(q[:, :, None], k[:, :length].transpose(1, 2),
                  v[:, :length].transpose(1, 2)) for q, k, v in copies]
        sdpa = cycling(lambda i: F.scaled_dot_product_attention(
            *views[i], enable_gqa=True), n)
        want = ref.decode_attn_ref(*copies[0], length).float()
        cases = [(st, p) for st in stages for p in splits]
        if "parent" in kernels:
            cases.insert(0, ("parent", None))
        calls, geos = {}, {}
        for case in list(cases):
            try:
                calls[case], geos[case] = runner(kernels, case, shape, length)
                got = calls[case](*copies[0]).float()
            except ValueError as err:   # no kernel built at this shape
                print(f"  {case[0]}: {err}", flush=True)
                cases.remove(case)
                continue
            if not torch.allclose(got, want,
                                  **chip_smoke.KERNEL_TOL[torch.bfloat16]):
                sys.exit(f"{name}: build {case[0]}, parts {case[1]}: "
                         f"disagrees with decode_attn_ref (max|err| "
                         f"{(got - want).abs().max().item():.3e})")
        times = {c: [] for c in cases}
        dev = {c: [] for c in cases}
        lib, lib_dev = [], []
        for order in (cases, cases[::-1]):
            lib.append(chip_smoke.time_ms(sdpa))
            lib_dev.append(chip_smoke.graph_ms(sdpa))
            for case in order:
                fn = cycling(lambda i: calls[case](*copies[i]), n)
                times[case].append(chip_smoke.time_ms(fn))
                dev[case].append(chip_smoke.graph_ms(fn))
        row = {"bound_ms": bound, "sdpa_ms": lib, "sdpa_graph_ms": lib_dev,
               "copies": n, "builds": {}}
        print(f"{name} {shape} length {length}: bound {bound:.5f} ms by "
              f"bytes; SDPA {lib} ms by events, in a graph {lib_dev} ms; {n} "
              f"cache copies", flush=True)
        for (st, p), ts in times.items():
            geo = geos[(st, p)] or {"parts": 1, "blocks": b * hk}
            best = min(dev[(st, p)])
            launch = (f"{geo['blocks']} blocks, {geo['blocks_per_sm']} an "
                      f"SM, {geo['clusters']} clusters at once, "
                      f"{geo['smem_bytes']} B shared"
                      if geos[(st, p)] else f"{geo['blocks']} blocks")
            print(f"  {st} parts {geo['parts']:2d}"
                  f"{' (partition)' if p is None and st != 'parent' else ''}"
                  f": in a graph {dev[(st, p)]} ms -> {bound / best:.3f} of "
                  f"the bound, {best / min(lib_dev):.3f} of SDPA's; events "
                  f"{ts} ms; {launch}", flush=True)
            label = st if st == "parent" else \
                f"{st}_p{'auto' if p is None else p}"
            row["builds"][label] = {"graph_ms": dev[(st, p)], "ms": ts,
                                    **geo}
        result["shapes"][name] = row
        del copies, views, calls
        torch.cuda.empty_cache()
    result["registers"] = {st: {f"{k} D{d} G{g}": r
                                for (k, d, g), r in sorted(r_.items())}
                           for st, r_ in regs.items()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
