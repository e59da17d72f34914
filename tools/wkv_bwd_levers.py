"""Time K3b, the wkv backward kernel of the PyTorch port, by segment and tile.

    PYTHONPATH=src python tools/wkv_bwd_levers.py
        [--builds s8,s4,s8q] [--parent FILE] [--iters 20]

``src/repro_torch/kernels/csrc/rwkv_wkv_bwd.cu`` fixes at compile time
its segment (``kSeg``: steps whose states a block keeps in shared memory,
and the checkpoint interval) and its tile (``kKeys`` x ``kCols``: keys x
columns a thread).  This script writes a copy of the source for each
``s<segment>[k<keys>c<columns>][q]`` in ``--builds`` with those
constants rewritten (the source's own is ``s8k4c4``; a trailing ``q``
also puts timing probes into the copy: ``clock64`` cycles by phase of
each block's thread 0, written over the first elements of its ds0, so
such a build is timed and read, not checked), and builds ``--parent``,
an earlier ``rwkv_wkv_bwd.cu`` with the launcher of before the states
moved to shared memory (one block a (batch, head), a ``scratch`` of a
segment's states in device memory: e.g. ``git show
<commit>:src/repro_torch/kernels/csrc/rwkv_wkv_bwd.cu``), beside them
(one nvcc each, all started together, into the port's git-ignored
``kernels/_build/wkv_bwd_levers/``).  It holds every build to
``ref.wkv_bwd_ref`` within ``chip_smoke``'s ``WKV_BWD_TOL`` at segment
edges, a ragged length and the training shape, in bf16 and fp32, then
times them all in turns, forward and back (the parent first and last),
at the training shape (B 8, T 1,024, H 32, D 64: rwkv6-1.6b) in bf16 and
in fp32, by CUDA events over ``--iters`` back-to-back calls.  Beside each
time: the bound (``chip_smoke.wkv_bwd_cost`` at the card's fp32 rate)
and the share of it, each build's registers and spills (ptxas), blocks
an SM and shared bytes (its geometry), and its checkpoint bytes.  It
prints the card (nvidia-smi name, power limit) first, one line per build
and timing, and last a JSON object with the numbers.  Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke  # noqa: E402  (check_wkv_bwd, time_ms, wkv_bwd_cost)
from repro_torch.core import hw  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import rwkv_wkv as kw  # noqa: E402

OUT = build.BUILD_DIR / "wkv_bwd_levers"
SHAPE = chip_smoke.TRAIN_SHAPE

#: The parent's launcher: ckpt, then a segment's scratch.
_ARGS = kw.KERNEL_BWD.argtypes
PARENT_ARGTYPES = [*_ARGS[:17], ctypes.c_void_p, *_ARGS[17:]]
PARENT_GEOMETRY = ("blocks", "threads", "segment", "key_groups", "columns",
                   "smem_bytes", "blocks_per_sm")
PARENT_SEGMENT = 16

#: The phases a probe build counts, each ending where its probe goes:
#: before the line ``offset`` lines below the source's one line holding
#: the text.
PHASES = (
    ("pass1 wait", "__syncthreads();  // segment n is in;", 1),
    ("pass1 steps", "for (int t = 0; t < kSeg; ++t) advance(s, in, t);", 1),
    ("pass2 wait", "__syncthreads();  // stage n and its checkpoint are in;",
     1),
    ("pass2 copies issued", "const Stage in = view(n);", 0),
    ("bonus scalars", "// The segment's states S^t", 0),
    ("recompute", "// The segment after's outputs, a segment late", 0),
    ("outputs of the segment after", "// The walk back.", 0),
    ("walk", "// dv: summed over the warps", 0),
    ("dv and bonus terms", "du = fmaf(__fmul_rn(rk, kk), vdy[t], du);", 3),
    ("end", "du_part[static_cast<size_t>(bh) * D + tid] = sum;", 2),
)
PROBE_HEAD = """
  // Cycles by phase (thread 0), written over ds0 at the end.
  long long probe[{n}] = {{}}, probe_t = clock64();
  auto probe_at = [&](int i) {{
    if (tid == 0) {{
      const long long now = clock64();
      probe[i] += now - probe_t;
      probe_t = now;
    }}
  }};
"""
PROBE_TAIL = """
    if (tid == 0)
      for (int i = 0; i < {n}; ++i) ds0[state0 + i] = probe[i];
"""


def parse_build(name: str) -> dict:
    """``s<segment>[k<keys>c<columns>][q]`` -> the constants to rewrite,
    and whether to probe."""
    m = re.fullmatch(r"s(\d+)(?:k(\d+)c(\d+))?(q)?", name)
    if m is None:
        raise SystemExit(f"wkv_bwd_levers: bad build name {name!r}")
    seg, keys, cols, probes = m.groups()
    consts = {"kSeg": int(seg)}
    if keys:
        consts.update(kKeys=int(keys), kCols=int(cols))
    return {"consts": consts, "probes": bool(probes)}


def once(src: str, line: str) -> int:
    """Where the source's one line holding ``line`` starts."""
    hits = [i for i, x in enumerate(src.splitlines(keepends=True))
            if line in x]
    if len(hits) != 1:
        raise RuntimeError(f"{kw.KERNEL_BWD.library.source} states "
                           f"{line!r} {len(hits)} times, not once")
    return hits[0]


def with_probes(src: str) -> str:
    """The source with a probe at the end of each of ``PHASES``."""
    lines = src.splitlines(keepends=True)
    before = {once(src, "u_s[j] = u[h * D + j];") + 1:
              PROBE_HEAD.format(n=len(PHASES))}
    for i, (_, line, offset) in enumerate(PHASES):
        text = f"    probe_at({i});\n"
        if i == len(PHASES) - 1:
            text += PROBE_TAIL.format(n=len(PHASES))
        n = once(src, line) + offset
        before[n] = before.get(n, "") + text
    return "".join(before.get(n, "") + x for n, x in enumerate(lines))


def probe_cycles(kern, call) -> dict:
    """Mean cycles by phase over the blocks of one call of a probe
    build, and the mean total."""
    with launching(kern):
        out = kw.wkv_bwd(*call)
    torch.cuda.synchronize()
    b, _, h, d = call[0].shape
    cyc = out[5].reshape(b * h, d * d)[:, :len(PHASES)].double()
    mean = cyc.mean(dim=0).tolist()
    return {"cycles": dict(zip((p[0] for p in PHASES), mean)),
            "total": sum(mean), "max_block_total": cyc.sum(dim=1).max().item()}


def copy_kernel(name: str, src: str, argtypes) -> build.Kernel:
    lib = build.CudaLibrary("rwkv_wkv_bwd")
    lib.source = OUT / f"rwkv_wkv_bwd_{name}.cu"
    lib.source.parent.mkdir(parents=True, exist_ok=True)
    lib.source.write_text(src)
    return build.Kernel("rwkv_wkv_bwd", argtypes, lib)


def lever_kernel(name: str) -> build.Kernel:
    spec = parse_build(name)
    src = kw.KERNEL_BWD.library.source.read_text()
    for const, val in spec["consts"].items():
        src, n = re.subn(rf"constexpr int {const} = \d+;",
                         f"constexpr int {const} = {val};", src)
        if n != 1:
            raise RuntimeError(f"{kw.KERNEL_BWD.library.source} states "
                               f"{const} {n} times, not once")
    if spec["probes"]:
        src = with_probes(src)
    kern = copy_kernel(name, src, kw.KERNEL_BWD.argtypes)
    kern.segment = spec["consts"]["kSeg"]
    kern.probes = spec["probes"]
    return kern


@contextlib.contextmanager
def launching(kern: build.Kernel):
    """``kw.wkv_bwd`` and ``kw.geometry_bwd`` go through ``kern`` inside,
    with its segment."""
    saved = kw.KERNEL_BWD, kw.SEGMENT
    kw.KERNEL_BWD, kw.SEGMENT = kern, kern.segment
    try:
        yield
    finally:
        kw.KERNEL_BWD, kw.SEGMENT = saved


def lever_bwd(kern):
    def run(*args):
        with launching(kern):
            return kw.wkv_bwd(*args)
    return run


def parent_bwd(kern):
    """``wkv_bwd`` through the parent's launcher: one block a (batch,
    head), ckpt and scratch allocated here."""
    def run(r, k, v, w, u, state, dy, ds_t=None):
        b, t, h, d = r.shape
        dr, dk, dv = (torch.empty_like(r) for _ in range(3))
        dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
        du_part = torch.empty((b, h, d), dtype=torch.float32,
                              device=r.device)
        ds0 = torch.empty_like(state)
        ckpt = torch.empty((b * h, -(-t // PARENT_SEGMENT), d, d),
                           dtype=torch.float32, device=r.device)
        scratch = torch.empty((b * h, PARENT_SEGMENT, d, d),
                              dtype=torch.float32, device=r.device)
        kern.launch(kw.DTYPES[r.dtype], d, r.data_ptr(), k.data_ptr(),
                    v.data_ptr(), w.data_ptr(), u.data_ptr(),
                    state.data_ptr(), dy.data_ptr(),
                    None if ds_t is None else ds_t.data_ptr(), dr.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                    du_part.data_ptr(), ds0.data_ptr(), ckpt.data_ptr(),
                    scratch.data_ptr(), b, t, h,
                    torch.cuda.current_stream().cuda_stream,
                    config=f"head dim {d}")
        return dr, dk, dv, dw, du_part.sum(dim=0), ds0
    return run


def ptxas(log: str) -> dict:
    """{"bf16" or "f32": (registers, spill store bytes, spill load bytes)}
    of the D 64 kernels in a ptxas -v report."""
    out, kind = {}, None
    for line in log.splitlines():
        m = re.search(r"wkv_bwd_kernelI(13__nv_bfloat16|f)Li(\d+)E", line)
        if m:
            kind = (("bf16" if m.group(1) != "f" else "f32")
                    if m.group(2) == "64" else None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kind:
            out[kind] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and kind:
            out.setdefault(kind, [None, None, None])[0] = int(m.group(1))
            kind = None
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--builds", default="s8,s4,s8q")
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("wkv_bwd_levers: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    spec = hw.spec_for(torch.cuda.get_device_name(0))
    kernels = {name: lever_kernel(name) for name in args.builds.split(",")}
    if args.parent is not None:
        kernels["parent"] = copy_kernel("parent", args.parent.read_text(),
                                        PARENT_ARGTYPES)
    build.load_all([kern.library for kern in kernels.values()])
    fns, info = {}, {}
    b, t, h, d = SHAPE
    for name, kern in kernels.items():
        kern.fn()
        regs = ptxas(kern.library.ptxas_log)
        if name == "parent":
            fns[name] = parent_bwd(kern)
            geo = {str(dt): kw._geometry(kern, PARENT_GEOMETRY, dt, SHAPE)
                   for dt in (torch.bfloat16, torch.float32)}
            ckpt = 4 * b * h * d * d * -(-t // PARENT_SEGMENT)
            scratch = 4 * b * h * d * d * PARENT_SEGMENT
        else:
            fns[name] = lever_bwd(kern)
            with launching(kern):
                geo = {str(dt): kw.geometry_bwd(dt, SHAPE)
                       for dt in (torch.bfloat16, torch.float32)}
                ckpt = 4 * b * h * d * d * kw.checkpoint_shape(SHAPE)[1]
            scratch = 0
        info[name] = {"ptxas": regs, "geometry": geo, "ckpt_bytes": ckpt,
                      "scratch_bytes": scratch}
        print(f"{name}: ptxas D 64 [registers, spill stores, spill loads] "
              f"{regs or 'not reported (an identical source was built '
                        'before)'}; ckpt {ckpt} B, scratch {scratch} B; "
              f"geometry {geo}", flush=True)

    seg = max(kern.segment for kern in kernels.values()
              if hasattr(kern, "segment"))
    checks = [((1, seg - 1, 1, 64), "model", False),
              ((1, seg + 1, 1, 64), "sigmoid", True),
              ((2, 2 * seg + 3, 3, 64), "model", True),
              ((2, 100, 4, 64), "sigmoid", False),
              (SHAPE, "model", False)]
    worst = {}
    for name, fn in fns.items():
        if getattr(kernels[name], "probes", False):
            continue
        fake = types.SimpleNamespace(wkv_bwd=fn)
        for dtype in (torch.bfloat16, torch.float32):
            for i, (shape, decay, ds_t) in enumerate(checks):
                err = chip_smoke.check_wkv_bwd(fake, ref, shape, dtype, decay,
                                               ds_t, seed=400 + i)
                if shape == SHAPE:
                    worst[f"{name} {dtype}"] = err
        print(f"{name}: agrees with wkv_bwd_ref within "
              f"{chip_smoke.WKV_BWD_TOL} of each output's largest", flush=True)

    order = list(fns)
    if "parent" in order:
        order.remove("parent")
        order = ["parent", *order]
    times = {name: {} for name in fns}
    bounds, probes = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v, w, u, s0 = chip_smoke.rand_wkv(b, t, h, d, dtype, "model",
                                                77)
        dy = torch.randn(b, t, h, d, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(78))
        call = (r, k, v, w, u, s0, dy)
        nbytes, flops = chip_smoke.wkv_bwd_cost(b, t, h, d,
                                                r.element_size())
        t_bytes, t_ops = nbytes / spec.hbm_bw, flops / spec.peak_fp32_flops
        bound = max(t_bytes, t_ops) * 1e3
        bounds[str(dtype)] = {"ms": bound, "by": "bytes" if t_bytes >= t_ops
                              else "operations"}
        for name in (*order, *reversed(order)):
            ms = chip_smoke.time_ms(lambda: fns[name](*call),
                                    iters=args.iters, warmup=2)
            times[name].setdefault(str(dtype), []).append(ms)
        for name in order:
            if getattr(kernels[name], "probes", False):
                cyc = probes[f"{name} {dtype}"] = probe_cycles(kernels[name],
                                                               call)
                print(f"{name} {dtype} probes (cycles of thread 0, mean of "
                      f"the blocks): {cyc}", flush=True)
            got = times[name][str(dtype)]
            print(f"{name} {dtype} B{b} T{t} H{h} D{d} on {smi}: {got} ms "
                  f"by events; bound {bound:.5f} ms by "
                  f"{bounds[str(dtype)]['by']} -> {bound / min(got):.3f} of "
                  f"the bound", flush=True)
        del call, r, k, v, w, u, s0, dy
        torch.cuda.empty_cache()
    out = {"card": smi, "shape": list(SHAPE), "order": order,
           "bounds": bounds, "times_ms": times, "builds": info,
           "max_abs_err_at_shape": worst, "probes": probes}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
