"""Time the DES scan kernels K4/K5 of the PyTorch port lever by lever.

    PYTHONPATH=src python tools/memsim_scan_levers.py [--parent FILE] [--sass]

Builds copies of ``src/repro_torch/kernels/csrc/memsim_scan.cu`` with one
design choice changed each (one nvcc each, all started together, into the
port's git-ignored ``kernels/_build/memsim_levers/``), holds every build
bit for bit (``torch.equal`` on carries and histograms) to the plain
versions ``ref.ts_scan_ref`` / ``ref.event_scan_ref``, and times all builds
in turns, forward and back, by CUDA events at three shapes:

* K4 at 8,192 steps x 384 lanes and K5 at 8,192 x 384
  (``validate_calibration``'s width and both engines' chunk there);
* K5 at 1,024 x 4,032 (the default QueueLUT grid's width and chunk).

The builds (``VARIANTS``): the source as it is (a ring 128 steps deep in
stages of 32); rings of 64 and 256 steps; stages of 16 steps (rings of 128
and 32) and of 64; the count under a branch instead of an add of 0 or 1
every step; the counts in a table in shared memory, added to the device's
histogram at the end of a launch, by an add every step or under a branch;
K4's chain with both outcomes of the admission test formed before the
select; K5's chain as the reference writes it (the max before the adds)
instead of both outcomes formed first; K4's max of the backlog as one
``max.NaN`` instruction.  ``--probes`` also times builds with
work taken out (no copies into the ring, no count, neither): what that
work costs; their results are not the scans' and are not checked.  With
``--parent FILE`` (an
earlier ``memsim_scan.cu`` with the same C interface) also that file as it
is and with 32-thread blocks (its ``kThreads``).  With ``--sass`` it writes
``cuobjdump -sass`` of the source's build (and the parent's) beside the
builds and prints, for each kernel, its instructions and, for each loop,
its length and what it holds.

It prints the card (nvidia-smi name, power limit), one line per build and
timing, and last a JSON object with the numbers (also written beside
the builds, ``memsim_scan_levers.json``).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the LUT grid's cells)
from repro_torch.core import coaxial, memsim, threefry  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import memsim_scan as ms  # noqa: E402

OUT = build.BUILD_DIR / "memsim_levers"   # builds, SASS, the JSON

_COUNTS = re.compile(r"struct Counts \{.*?\n\};\n", re.S)
_ADD_HEAD = (
    "  __device__ __forceinline__ void add(bool recorded, float latency) "
    "const {\n"
    "    const unsigned b = min(__float2uint_rz(__fmul_rn(latency, "
    "kBinScale)),\n"
    "                           static_cast<unsigned>(kBins - 1));\n")

# The counts in a table in shared memory: (1,024 bins x 32 lanes) int32
# after the stage barriers, bin-major with lane l of bin b in column
# l ^ (b mod 32) (a step's adds and the flush each touch 32 banks), zeroed
# at the start of a launch, counted with a shared atomic add of 0 or 1
# every step (or ``add_body``), added to the device's histogram at the end
# by coalesced 128-byte atomic adds, all-zero lines skipped.
_TABLE_ADD = (
    '    asm volatile("red.shared.add.s32 [%0], %1;" ::"r"(word(b, lane)),\n'
    '                 "r"(static_cast<int>(recorded)));\n')


def _table(add_body: str = _TABLE_ADD):
    counts = (
        "struct Counts {\n"
        "  uint32_t base;\n  unsigned lane;\n"
        "  __device__ __forceinline__ uint32_t word(unsigned bin, unsigned l)"
        " const {\n"
        "    return base + 4u * (bin * kLanes + (l ^ (bin % kLanes)));\n  }\n"
        "  __device__ __forceinline__ void clear() const {\n"
        "#pragma unroll 8\n"
        "    for (unsigned i = lane; i < kBins * kLanes / 4; i += kLanes) {\n"
        '      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::'
        '"r"(base + 16u * i), "r"(0u) : "memory");\n'
        "    }\n    __syncwarp();\n  }\n"
        + _ADD_HEAD + add_body + "  }\n"
        "  __device__ __forceinline__ void flush(int* hist, int lane0, "
        "int lanes) const {\n"
        "    __syncwarp();\n"
        "    for (int l = 0; l < lanes; ++l) {\n"
        "      int* const row = hist + static_cast<int64_t>(lane0 + l) * "
        "kBins + lane;\n"
        "#pragma unroll 4\n"
        "      for (int c = 0; c < kBins / kLanes; ++c) {\n"
        "        int v;\n"
        '        asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : '
        '"r"(word(c * kLanes + lane, l)) : "memory");\n'
        "        if (__any_sync(0xffffffffu, v != 0)) {\n"
        '          asm volatile("red.global.add.s32 [%0], %1;" ::'
        '"l"(row + c * kLanes), "r"(v) : "memory");\n'
        "        }\n      }\n    }\n  }\n"
        "};\n")
    return [
        (_COUNTS, counts),
        ("  return arrays * kArrayBytes + kBarrierBytes;",
         "  return arrays * kArrayBytes + kBarrierBytes + kBins * kLanes * 4;"),
        ("    return;\n  }\n  if (lane < n) {\n",
         "    return;\n  }\n"
         "  const Counts table{hand.full + kBarrierBytes, j};\n"
         "  table.clear();\n"
         "  if (lane < n) {\n"),
        ("    s.counts.row = hist + static_cast<int64_t>(lane) * kBins;\n",
         "    s.counts = table;\n"),
        (re.compile(r"(\n    (?:w\[lane\] = s\.wc;|carry\[2 \* n \+ lane\] = "
                    r"s\.lent \? 1\.0f : 0\.0f;)\n  \}\n)\}"),
         lambda m: m.group(1) + "  table.flush(hist, lane0, lanes);\n}"),
    ]


#: name -> (source: "this" or "parent", [(text or regex, replacement),
#: ...]); each must match the source (every match is replaced; a callable
#: replacement is given the match).
VARIANTS = {
    "source (ring 128)": ("this", []),
    "ring 64": ("this", [("constexpr int kStages = 4;",
                          "constexpr int kStages = 2;")]),
    "ring 256": ("this", [("constexpr int kStages = 4;",
                           "constexpr int kStages = 8;")]),
    "stages of 16 steps": ("this", [
        ("constexpr int kStage = 32;", "constexpr int kStage = 16;"),
        ("constexpr int kStages = 4;", "constexpr int kStages = 8;")]),
    "stages of 16 steps, ring 32": ("this", [
        ("constexpr int kStage = 32;", "constexpr int kStage = 16;"),
        ("constexpr int kStages = 4;", "constexpr int kStages = 2;")]),
    "stages of 64 steps": ("this", [
        ("constexpr int kStage = 32;", "constexpr int kStage = 64;"),
        ("constexpr int kStages = 4;", "constexpr int kStages = 2;")]),
    "count under a branch": ("this", [
        (re.compile(r'    asm volatile\("red\.global\.add\.s32 \[%0\], %1;'
                    r'\\n" ::"l"\(row \+ b\),\n.*?\);\n', re.S),
         "    if (recorded) atomicAdd(row + b, 1);\n")]),
    "shared table": ("this", _table()),
    "shared table, count under a branch": ("this", _table(
        "    if (recorded) {\n"
        '      asm volatile("red.shared.add.s32 [%0], 1;" ::"r"(word(b, '
        'lane)));\n'
        "    }\n")),
    "K4 chain, both outcomes first": ("this", [
        ("    const float x =\n"
         "        __fsub_rn(__fadd_rn(backlog, admit ? s_arr : s_none), "
         "1.0f);\n",
         "    const float x_arr = __fsub_rn(__fadd_rn(backlog, s_arr), 1.0f);\n"
         "    const float x_none = __fsub_rn(__fadd_rn(backlog, s_none), "
         "1.0f);\n"
         "    const float x = admit ? x_arr : x_none;\n")]),
    "K5 chain as written": ("this", [
        ("    wc = positive ? w_d : w_0;\n",
         "    {\n"
         "      const float w = d <= 0.0f ? 0.0f : d;\n"
         "      wc = w <= bound ? __fadd_rn(w, s) : __fadd_rn(w, 0.0f);\n"
         "    }\n")]),
    "K4 max.NaN": ("this", [
        ("    backlog = x < 0.0f ? 0.0f : x;\n",
         '    asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(backlog) : '
         '"f"(x));\n')]),
    "parent": ("parent", []),
    "parent, 32-thread blocks": ("parent", [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 32;")]),
}

_NO_COPIES = [
    ("      c.template fetch<true>(t, kStage);\n", ""),
    ("      c.template fetch<false>(t, m);\n", "")]
_NO_COUNT = [
    (re.compile(r"  __device__ __forceinline__ void add\(bool recorded.*?\n"
                r"  }\n", re.S),
     "  __device__ __forceinline__ void add(bool, float) const {}\n")]

#: What-if probes: builds with work taken out, timed to see what the work
#: costs; their results are not the scans' and are not checked.
PROBES = {
    "probe: no copies": ("this", _NO_COPIES),
    "probe: no count": ("this", _NO_COUNT),
    "probe: no copies, no count": ("this", _NO_COPIES + _NO_COUNT),
}


def variant_source(name: str, parent: Path | None) -> str:
    where, patches = {**VARIANTS, **PROBES}[name]
    src = (ms.LIBRARY.source if where == "this" else parent).read_text()
    for old, new in patches:
        pattern = old if isinstance(old, re.Pattern) else \
            re.compile(re.escape(old))
        src, hits = pattern.subn(new if callable(new) else lambda _: new,
                                 src)
        if not hits:
            raise RuntimeError(f"{name}: the source no longer holds "
                               f"{pattern.pattern[:60]!r}")
    return src


def variant_kernels(name: str, parent: Path | None) -> dict:
    """Launchers of ``name``'s build, in the shape of ``ms.KERNELS``."""
    lib = build.CudaLibrary("memsim_scan")
    slug = re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
    lib.source = OUT / f"memsim_scan_{slug}.cu"
    lib.source.parent.mkdir(parents=True, exist_ok=True)
    lib.source.write_text(variant_source(name, parent))
    return {k: build.Kernel(k, v.argtypes, lib)
            for k, v in ms.KERNELS.items()}


@contextlib.contextmanager
def launching(kernels: dict):
    """``ms.ts_scan`` / ``ms.event_scan`` go through ``kernels`` inside."""
    saved = dict(ms.KERNELS)
    ms.KERNELS.update(kernels)
    try:
        yield
    finally:
        ms.KERNELS.update(saved)


def events_ms(fn, iters: int, warmup: int = 2) -> float:
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


def shapes():
    """{label: (engine, terms, carry, args after the carry, args with
    nothing recorded, iters)} at the three shapes."""
    out = {}
    reps = 48
    cfgs = [memsim.ChannelConfig(rho=r) for r in coaxial.CALIBRATION_RHOS]
    c = memsim.stack_channels(cfgs * reps, device="cuda")
    t = memsim._channel_terms(c)
    lanes = len(cfgs) * reps
    ids = torch.arange(lanes, device="cuda")
    key = threefry.split(threefry.prng_key(0, "cuda"), 2)[1]
    steps = memsim._ts_chunk_len(lanes)
    draws = memsim._ts_draws(c, t, ids, key, steps)
    carry = torch.stack([torch.zeros(lanes), torch.ones(lanes),
                         torch.zeros(lanes)]).cuda()
    out[f"K4 {steps} x {lanes}"] = (
        "timestep", memsim._ts_terms(c, t), carry,
        (*draws, None, 0, steps), (*draws, None, 0, 0), 20)
    ev_steps = memsim._event_chunk_len(lanes)
    tabs = memsim._event_tables(c, t, ids, key, 64)
    zeros = torch.zeros(lanes, device="cuda")
    _, gaps, svc, rec = memsim._event_arrivals(
        c, t, (zeros, zeros), ids, key, tabs, 0, ev_steps)
    out[f"K5 {ev_steps} x {lanes}"] = (
        "event", memsim._event_terms(c, t), zeros.clone(),
        (gaps, svc, rec), (gaps, svc, torch.zeros_like(rec)), 20)
    cells = chip_smoke.lut_cells(4032)
    c = memsim.stack_channels([memsim.ChannelConfig(
        rho=r, kappa=k, outstanding=o, eta=e) for r, k, o, e in cells],
        device="cuda")
    t = memsim._channel_terms(c)
    lanes = len(cells)
    ids = torch.arange(lanes, device="cuda")
    chunk = memsim.canonical_chunk("event")
    tabs = memsim._event_tables(c, t, ids, key, 64)
    zeros = torch.zeros(lanes, device="cuda")
    _, gaps, svc, rec = memsim._event_arrivals(
        c, t, (zeros, zeros), ids, key, tabs, 0, chunk)
    out[f"K5 {chunk} x {lanes}"] = (
        "event", memsim._event_terms(c, t), zeros.clone(),
        (gaps, svc, rec), (gaps, svc, torch.zeros_like(rec)), 50)
    return out


def scan_fns(engine):
    if engine == "timestep":
        return ms.ts_scan, ref.ts_scan_ref
    return ms.event_scan, ref.event_scan_ref


def run_once(fn, terms, carry, args):
    n = terms.shape[1]
    c = carry.clone()
    h = torch.zeros((n, ms.N_BINS), dtype=torch.int32, device="cuda")
    fn(terms, c, *args, h)
    torch.cuda.synchronize()
    return c, h


# --- SASS -----------------------------------------------------------------

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)\s*(.*?);")
_KINDS = ("LDGSTS", "LDG", "LDS", "STS", "STG", "RED", "ATOM", "ATOMS",
          "DEPBAR", "LDGDEPBAR", "BAR", "FADD", "FMUL", "FFMA", "FSETP",
          "FSEL", "FMNMX", "SEL", "ISETP", "IMAD", "IADD3", "LEA", "F2I",
          "VIMNMX", "IMNMX", "PRMT", "SHF", "LOP3", "PLOP3", "BRA", "BSSY")


def sass_summary(text: str) -> dict:
    """Per kernel function of ``cuobjdump -sass`` output: its instruction
    count and, for each backward branch (a loop), the loop's length and
    its instructions by kind."""
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        insns = [(int(m.group(1), 16), m.group(2), m.group(4))
                 for m in _INSN.finditer(block)]
        loops = []
        for addr, op, rest in insns:
            tgt = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and tgt and int(tgt.group(1), 16) < addr:
                lo = int(tgt.group(1), 16)
                body = [o for a, o, _ in insns if lo <= a <= addr]
                cnt = Counter(body)
                loops.append({"from": hex(lo), "to": hex(addr),
                              "instructions": len(body),
                              "kinds": {k: cnt[k] for k in _KINDS
                                        if cnt[k]}})
        out[name] = {"instructions": len(insns), "loops": loops}
    return out


def dump_sass(label: str, lib: build.CudaLibrary) -> dict:
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" /
        "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib.target())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    slug = re.sub(r"[^a-z0-9]+", "_", label.lower()).strip("_")
    (OUT / f"sass_memsim_scan_{slug}.txt").write_text(text)
    summary = sass_summary(text)
    for fn, row in summary.items():
        print(f"SASS {label}: {fn}: {row['instructions']} instructions",
              flush=True)
        for loop in row["loops"]:
            print(f"  loop {loop['from']}..{loop['to']}: "
                  f"{loop['instructions']} instructions {loop['kinds']}",
                  flush=True)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier memsim_scan.cu to time beside")
    ap.add_argument("--sass", action="store_true",
                    help="dump and summarise the SASS of the builds")
    ap.add_argument("--probes", action="store_true",
                    help="also time the what-if probes (unchecked)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="timing rounds, each forward then back")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("memsim_scan_levers: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    names = [v for v, (where, _) in VARIANTS.items()
             if where == "this" or args.parent is not None]
    probes = list(PROBES) if args.probes else []
    kernels = {v: variant_kernels(v, args.parent) for v in names + probes}
    build.load_all({k["memsim_ts_scan"].library for k in kernels.values()})
    for v in names:
        for line in kernels[v]["memsim_ts_scan"].library.ptxas_log \
                .splitlines():
            if any(w in line for w in ("registers", "spill", "smem")):
                print(f"{v} ptxas: {line.strip()}", flush=True)
    sass = {}
    if args.sass:
        for v in names:
            if v in ("source (ring 128)", "parent"):
                sass[v] = dump_sass(v, kernels[v]["memsim_ts_scan"].library)

    cases = shapes()
    # Each build against the plain version, once a shape.
    for label, (engine, terms, carry, full, _, _) in cases.items():
        kfn, pfn = scan_fns(engine)
        want = run_once(pfn, terms, carry, full)
        if int(want[1].sum()) == 0:
            sys.exit(f"{label}: the plain version recorded nothing")
        for v in names:
            with launching(kernels[v]):
                got = run_once(kfn, terms, carry, full)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                sys.exit(f"{v}: differs from the plain version at {label}")
        print(f"{label}: every build equals the plain version "
              f"(torch.equal, carries and histograms)", flush=True)

    timed = names + probes
    res = {v: {label: [] for label in cases} for v in timed}
    norec = {label: [] for label in cases}
    order = timed + timed[::-1]
    for _ in range(args.rounds):
        for v in order:
            with launching(kernels[v]):
                for label, (engine, terms, carry, full, empty, iters) in \
                        cases.items():
                    kfn, _ = scan_fns(engine)
                    n = terms.shape[1]
                    hist = torch.zeros((n, ms.N_BINS), dtype=torch.int32,
                                       device="cuda")
                    c = carry.clone()
                    res[v][label].append(events_ms(
                        lambda: kfn(terms, c, *full, hist), iters))
                    if v == names[0]:
                        c = carry.clone()
                        norec[label].append(events_ms(
                            lambda: kfn(terms, c, *empty, hist), iters))
    for v in timed:
        print(f"{v}: " + "; ".join(
            f"{label} {min(ts):.5f} ms (all {[round(x, 5) for x in ts]})"
            for label, ts in res[v].items()), flush=True)
    print(f"{names[0]}, nothing recorded: " + "; ".join(
        f"{label} {min(ts):.5f} ms" for label, ts in norec.items()),
        flush=True)
    out = {"card": smi, "ms": res, "no_record_ms": norec,
           "sass": {v: {fn: {"instructions": r["instructions"],
                             "loops": r["loops"]}
                        for fn, r in s.items()} for v, s in sass.items()}}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "memsim_scan_levers.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": smi, "ms": {v: {k: min(t) for k, t in r.items()}
                                          for v, r in res.items()},
                      "no_record_ms": {k: min(t) for k, t in
                                       norec.items()}}), flush=True)
    return out


if __name__ == "__main__":
    main()
