#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and no phase swallows one:
  1. print the card (nvidia-smi name, power limit) and build every kernel
     of the serving path from ``src/repro_torch/kernels/csrc``;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the path gives it and at a GQA shape, in bf16 and f32, with
     lengths that are not tile multiples, and with poisoned cache tails;
  3. drive the serving path once through ``repro_torch.launch.serve.main``:
     stablelm-1.6b at full width, bf16, batch 8, prompt 1024, 32 new
     tokens, random weights from a seed; every kernel's launch count must
     be exactly what the path implies (decode_attn: gen x n_layers);
  4. path check: the first decode step's logits through the kernel and
     through the plain ``decode_attention`` must agree; time decode steps
     on both paths and profile the device's busy share;
  5. time each kernel at the path's shape beside its bound, its plain
     version and the PyTorch library call that computes the same function.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card, nvcc, and
nothing of JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

ARCH = "stablelm-1.6b"
BATCH, PROMPT, GEN, SEED = 8, 1024, 32, 0
# float32: the reference's own kernel-test tolerance.  bfloat16: kernel and
# plain version both compute in fp32 and round once to bf16, so they may
# sit one bf16 rounding step apart (spacing <= 2**-6 for |x| < 4).
KERNEL_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-3),
              torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
# Logits of the first decode step, kernel path against plain path, in
# bf16.  The paths differ only in the decode attention of one token: the
# plain one rounds q*scale and the probabilities to bf16 (as the reference
# does), the kernel keeps fp32.  Per layer that moves the attention output
# by about one bf16 step (2**-8 relative); through 24 layers and the head
# the logits (|logit| ~ 1..5) may move by a few bf16 steps at most.
LOGIT_TOL = 0.125
# Published peaks of the H100 parts (NVIDIA data sheets, dense): HBM
# bytes/s and bf16 tensor-core FLOP/s, picked by the card's name.
PEAKS = {"PCIe": (2.0e12, 756e12),
         "NVL": (3.9e12, 835e12),
         "SXM": (3.35e12, 989e12)}


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
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


def rand_qkv(b, hq, hk, d, s, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=gen,
                                    dtype=torch.float32).to(dtype)
    return mk(b, hq, d), mk(b, s, hk, d), mk(b, s, hk, d)


def check_kernel(da, ref, shape, dtype, lengths, seed):
    """Kernel against plain on the card; returns the max |error|."""
    b, hq, hk, d, s = shape
    q, k, v = rand_qkv(b, hq, hk, d, s, dtype, seed)
    tol = KERNEL_TOL[dtype]
    worst = 0.0
    for length in lengths:
        got = da.decode_attn(q, k, v, length)
        want = ref.decode_attn_ref(q, k, v, length)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        ok = torch.allclose(got.float(), want.float(), **tol)
        log(f"  decode_attn {dtype} B{b} Hq{hq} Hk{hk} D{d} S{s} "
            f"length {length}: max|err| {err:.3e} (atol {tol['atol']}, "
            f"rtol {tol['rtol']}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"decode_attn disagrees with decode_attn_ref at {shape}, "
                 f"{dtype}, length {length}")
    # Poisoned tail: entries past `length` must not move the output.
    length = s // 2 + 3
    clean = da.decode_attn(q, k, v, length)
    k[:, length:], v[:, length:] = 1e4, -1e4
    poisoned = da.decode_attn(q, k, v, length)
    if not torch.equal(clean, poisoned):
        fail(f"decode_attn read past length {length} at {shape}, {dtype}")
    log(f"  poisoned tail past length {length}: output unchanged")
    return worst


def profile(fn):
    """Device time of the kernels one call of ``fn`` ran (ms, or None if
    the profiler saw none) and the eight largest kernels by time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # Kernels only: a CPU op's device time repeats its kernels'.
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.self_device_time_total / 1e3, ev.key, ev.count))
    if not rows:
        return None, []
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows[:8]


def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card; this script runs only on one")

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attn as da
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    # -- phase 1: the card and the build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    part, (peak_bw, peak_bf16) = peaks(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} card {name} "
        f"({part} peaks: {peak_bw / 1e12} TB/s, {peak_bf16 / 1e12} TFLOP/s "
        f"bf16)")
    t0 = time.time()
    kernels = [da.KERNEL]
    build.load_all([kern.library for kern in kernels])
    log(f"built the kernels in {time.time() - t0:.1f} s")
    for kern in kernels:
        for line in kern.library.ptxas_log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  ptxas {kern.library.name}: {line.strip()}")
        kern.fn()

    # -- phase 2: each kernel against its plain version -------------------
    cfg = get_config(ARCH)
    d = cfg.resolved_head_dim
    s_max = PROMPT + GEN
    slice_shape = (BATCH, cfg.n_heads, cfg.n_kv_heads, d, s_max)
    gqa_shape = (8, 24, 2, 128, 4096)       # starcoder2-3b's attention
    path_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        err = check_kernel(da, ref, slice_shape, dtype,
                           [1, 333, PROMPT + 1, PROMPT + 17, s_max], seed=1)
        if dtype == torch.bfloat16:
            path_err = err
        check_kernel(da, ref, gqa_shape, dtype, [1, 1000, 4095, 4096],
                     seed=2)

    # -- phase 3: the serving path at full width --------------------------
    for kern in kernels:
        kern.launches = 0
    toks = serve.main(["--arch", ARCH, "--batch", str(BATCH),
                       "--prompt-len", str(PROMPT), "--gen", str(GEN),
                       "--seed", str(SEED)])
    launches = {"decode_attn": da.KERNEL.launches}
    expected = {"decode_attn": GEN * cfg.n_layers}
    log(f"kernel launches on the serving path: {launches} "
        f"(expected {expected})")
    if launches != expected:
        fail(f"launch counts {launches} != {expected}")
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"bad generated tokens: shape {toks.shape}, range "
             f"[{toks.min()}, {toks.max()}]")

    # -- phase 4: path check and decode-step timing -----------------------
    with torch.inference_mode():
        model = Model(cfg)
        params = model.init(SEED)
        prompt = {k: v for k, v in SyntheticDataset(
            cfg, BATCH, PROMPT, seed=SEED + 1).batch_at(0).items()
            if k in ("tokens", "positions")}
        cache = model.make_cache(BATCH, s_max)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits0, cache = model.prefill(params, prompt, cache)
        torch.cuda.synchronize()
        log(f"prefill {BATCH}x{PROMPT} tokens (warm): "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        tok = logits0.argmax(-1).to(torch.int32)
        step_batch = dict(tokens=tok[:, None], positions=torch.full(
            (BATCH, 1), cache["len"], dtype=torch.int32, device="cuda"))
        lk, _ = model.decode_step(params, step_batch, cache)
        lp, _ = model.decode_step(params, step_batch, cache,
                                  plain_decode=True)
        torch.cuda.synchronize()
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            fail("non-finite logits on the decode step")
        if lk.shape != (BATCH, cfg.vocab):
            fail(f"logits shape {tuple(lk.shape)}")
        dlogit = (lk - lp).abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        log(f"path check: max|logit| {lk.abs().max().item():.3f}, "
            f"max|dlogit| kernel vs plain {dlogit:.4e} (tol {LOGIT_TOL}); "
            f"greedy-token agreement {agree * 100:.1f}% of {BATCH}")
        if dlogit > LOGIT_TOL:
            fail(f"kernel path logits differ from plain path by {dlogit}")

        n_steps = 8

        def decode_run(plain: bool):
            c, t = cache, tok
            for _ in range(n_steps):
                sb = dict(tokens=t[:, None], positions=torch.full(
                    (BATCH, 1), c["len"], dtype=torch.int32, device="cuda"))
                lg, c = model.decode_step(params, sb, c, plain_decode=plain)
                t = lg.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()

        step_ms = {}
        for plain in (True, False, False, True):
            decode_run(plain)                      # warm
            t0 = time.perf_counter()
            decode_run(plain)
            ms = (time.perf_counter() - t0) * 1e3 / n_steps
            step_ms.setdefault("plain" if plain else "kernel", []).append(ms)
        for key, vals in step_ms.items():
            log(f"decode step ({key} attention), batch {BATCH}, context "
                f"{PROMPT}..{PROMPT + n_steps}: "
                f"{', '.join(f'{v:.3f}' for v in vals)} ms/step -> "
                f"{BATCH * 1e3 / min(vals):.1f} tok/s")
        dev_ms, top = profile(lambda: decode_run(False))
        if dev_ms is None:
            log("device busy share: not measured (profiler gave no device "
                "time)")
        else:
            wall = min(step_ms["kernel"]) * n_steps
            log(f"device kernel time over {n_steps} kernel-path decode "
                f"steps: {dev_ms:.3f} ms of {wall:.3f} ms unprofiled wall "
                f"-> busy share {dev_ms / wall:.3f}")
            for ms, key, count in top:
                log(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
        del params, cache, model

    # -- phase 5: kernel time, bound, plain and library ----------------------
    b, hq, hk, d, s = slice_shape
    length = PROMPT + GEN // 2
    q, k, v = rand_qkv(b, hq, hk, d, s, torch.bfloat16, seed=3)
    item = q.element_size()
    kv_bytes = 2 * b * length * hk * d * item
    io_bytes = kv_bytes + 2 * b * hq * d * item
    flops = 4 * b * hq * length * d
    bound_ms = max(io_bytes / peak_bw, flops / peak_bf16) * 1e3
    bound_by = "bytes" if io_bytes / peak_bw >= flops / peak_bf16 \
        else "operations"
    # The library call reads the same cache through (B, Hk, L, D) views.
    sq, sk, sv = q[:, :, None, :], k[:, :length].transpose(1, 2), \
        v[:, :length].transpose(1, 2)
    lib_out = F.scaled_dot_product_attention(sq, sk, sv, enable_gqa=True)
    lib_err = (lib_out[:, :, 0].float() - ref.decode_attn_ref(
        q, k, v, length).float()).abs().max().item()
    times = {}
    for key, fn in (
            ("plain", lambda: ref.decode_attn_ref(q, k, v, length)),
            ("kernel", lambda: da.decode_attn(q, k, v, length)),
            ("library", lambda: F.scaled_dot_product_attention(
                sq, sk, sv, enable_gqa=True)),
            ("kernel", lambda: da.decode_attn(q, k, v, length)),
            ("plain", lambda: ref.decode_attn_ref(q, k, v, length))):
        times.setdefault(key, []).append(time_ms(fn))
    ms = min(times["kernel"])
    log(f"decode_attn bf16 B{b} Hq{hq} Hk{hk} D{d} S{s} length {length}: "
        f"kernel {times['kernel']} ms, plain {times['plain']} ms, "
        f"SDPA {times['library']} ms (SDPA vs plain max|err| {lib_err:.3e}); "
        f"bound {bound_ms:.5f} ms by {bound_by} ({io_bytes} B, {flops} "
        f"FLOP) -> {bound_ms / ms:.3f} of roofline, "
        f"{io_bytes / ms / 1e6:.1f} GB/s")
    gb, ghq, ghk, gd, gs = gqa_shape
    gq, gk, gv = rand_qkv(gb, ghq, ghk, gd, gs, torch.bfloat16, seed=4)
    g_ms = time_ms(lambda: da.decode_attn(gq, gk, gv, gs))
    g_bytes = 2 * gb * gs * ghk * gd * 2 + 2 * gb * ghq * gd * 2
    log(f"decode_attn bf16 B{gb} Hq{ghq} Hk{ghk} D{gd} length {gs}: kernel "
        f"{g_ms:.5f} ms, bound {g_bytes / peak_bw * 1e3:.5f} ms by bytes "
        f"({gb * ghk} blocks on {torch.cuda.get_device_properties(0).multi_processor_count} SMs)")

    print(json.dumps({"kernels": [{
        "name": "decode_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn.py:34",
        "launches": launches["decode_attn"], "max_abs_err": path_err,
        "ms": ms, "plain_ms": min(times["plain"]), "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": min(times["library"])}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
