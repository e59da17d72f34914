#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and no phase swallows one:
  1. print the card (nvidia-smi name, power limit) and build every kernel
     of the paths from ``src/repro_torch/kernels/csrc`` (one nvcc per
     source, all started together);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the paths give it and beyond, in bf16 and f32: decode_attn at
     lengths that are not tile multiples and with poisoned cache tails, at
     stablelm-1.6b's, olmoe-1b-7b's and zamba2-2.7b's decode shapes (D 64,
     128 and 80, G 1), qwen2-vl-72b's (D 128, G 8 over Hk 8),
     starcoder2-3b's (G 12 over Hk 2) and one mistral-large-123b layer at
     32k context (D 128, G 12, the decode plan's shape); lengths 1, 2 and
     65 at 32k in 16 parts (most parts
     empty), lengths one either side of a tile and of a part boundary in
     the parts the full cache is split into, the same and more lengths
     with the keys either side of each boundary dominant (so that one key
     dropped or counted twice shows), and calls at alternating shapes
     queued back to back, each held again; decode_attn_partials (K2's
     partial build, a rank's slice of a channelized cache) at each served
     decode shape, one rank's slice of the mistral layer on (32, 8) and the
     layer itself, lengths 0 (no key: m -1e30, l 0, acc 0 exactly) to S, m
     and acc / l within the kernel tolerance and l within its rtol; then
     the layer cut into 2, 4 and 8 slices, each slice's partials merged by
     ``ops.merge_partials``, against one decode_attn launch over the whole
     cache (at 20,000 of 32,768 keys the last three of 8 slices are empty);
     wkv at ragged lengths and at the edges of its chunk of steps, both
     decay ranges, and chained bit-exactly, cut inside a chunk and at its
     edge; wkv_bwd (K3b, wkv's backward) against ``wkv_bwd_ref`` at ragged
     lengths and the edges of its segment, both decay ranges, the final
     state's gradient zero and not, D 16/32/64, f32 and bf16, at one
     (batch, head) (a single block) either side of a segment at each
     D, and at the training shape (B 8, T 1,024, H 32, D 64), each output
     within ``WKV_BWD_TOL`` of its largest element;
     the four STREAM kernels bit for bit (torch.equal) at the reference's
     test shapes, at ragged n and at the probe's size;
  3. drive each path once through its entry point, with every kernel's
     launch count set to 0 just before and read just after; each count
     must be exactly what the path implies:
       stablelm-1.6b, rwkv6-1.6b, olmoe-1b-7b, zamba2-2.7b, qwen2-vl-72b:
         ``repro_torch.launch.serve.main`` at full width, bf16, batch 8,
         prompt 1024, 32 new tokens, random weights from a seed
         (qwen2-vl-72b at 8 of its 80 layers: 145 GB in bf16 do not fit
         one card; its prompt carries the pipeline's 64 vision rows and
         M-RoPE positions); decode_attn gen x attention layers for
         stablelm (768), olmoe (512), zamba2 (288: one shared block a
         group of 6 Mamba layers, 9 groups) and qwen2-vl (256); wkv
         (gen + 2) x n_layers for rwkv6 (serve's timed prefill,
         greedy_generate's prefill and gen steps); no other kernel (the
         JSON line's decode_attn launches are the sum of the four);
       the STREAM probe (run after phase 4 of the serving paths):
         ``repro_torch.launch.stream.main`` at 2**26 float32 elements an
         array; each stream kernel 2 x (warm-up + iters) (the probe's
         size, then the reference's L2-resident shape); no other kernel;
  4. per serving path (``serve_phase`` runs phases 3 and 4 of the
     serving paths; alone for the hybrid and vlm paths: ``python3 -c
     "import chip_smoke; chip_smoke.serve_phase(['zamba2-2.7b',
     'qwen2-vl-72b'])"``): prefill and first-decode-step logits through the
     kernels and through their plain versions must agree (stablelm in
     bf16, rwkv6, olmoe, zamba2 and qwen2-vl in float32; for olmoe the
     routing decisions of both paths are counted and the gate holds on the
     rows whose routes agree); time prefills and decode steps on both
     paths in bf16 and profile the device's busy share and the kernel's
     time a launch;
  5. time each kernel at the paths' shapes beside its bound, its plain
     version and the PyTorch library call that computes the same function
     (none for wkv); decode_attn (SDPA with enable_gqa beside it) at
     stablelm's, starcoder2's, olmoe's, zamba2's and qwen2-vl's decode
     shapes and at the planner's mistral-large layer, each call on a cold
     copy of the
     cache, in a CUDA graph (the card's time, no host) and by CUDA events
     around back-to-back calls (the call's), with the launch it made
     (parts = cluster size, blocks, threads, the ring's stages, tile and
     bytes), and decode_attn_partials on one rank's 4,096-key slice of
     the mistral layer beside SDPA over the same keys and the whole-cache
     decode_attn; wkv's lines give the launch it made (blocks x
     threads, steps a chunk, the tile of key groups x columns, shared
     bytes) and the profiler's share of the bound at the prefill and the
     decode shape;
  6. the design-space engine (``repro_torch.core``, no kernel of its own):
     ``repro_torch.launch.coaxial_study.main`` on the card, every number
     it prints held to the same code run with ``device="cpu"``; each of
     three grids (``default_sweep``'s 40 cells, the 110 cells of
     ``benchmarks/sweep_grid.py``, and that grid x 8 LLC sizes x 8 kappa
     x 16 eta = 112,640 cells) solved warm and timed by the host clock,
     with the CUDA launches a solve makes, the device's busy share
     (profiler) and the peak device memory; 1,000 cells of the dense grid
     solved on the CPU and held to the card's (where the fixed point has
     not settled, within the span of the card's orbit over steps 118 to
     122; such elements are counted), and
     ``design_gradient`` at coaxial-4x over every field held to its CPU
     run; the study's H100 decode-plan line (``core/planner``, the card's
     part) held to the CPU run with the same spec, and the planner's
     per-layer memory term for mistral-large at 32k printed beside K2's
     time at that layer's shape (phase 5) and their ratio;
  7. the memory-system DES (``repro_torch.core.memsim``, its scans the
     hand kernels memsim_ts_scan and memsim_event_scan, which phase 2
     holds bit for bit to their plain versions at the default LUT grid's
     4,032 lanes and at 37, chained, harvest on and off, open and closed
     loop, at the study's own launch shapes (384, 512 and 128 lanes at the
     chunk rules' lengths), at a chunk of 1021, and at the edges of their
     ring and blocks (lanes 1, 31, 32, 33, 4,032 x chunks of 1, D - 1, D,
     D + 1, 1,021 steps for a ring of D steps, record windows that start
     and end inside a ring stage), and which this phase holds again to
     their plain versions on the inputs it times):
     ``repro_torch.launch.memsim_study.main`` on the card at its
     full budget, each scan kernel launched exactly once a chunk of the
     runs it makes, the timestep engine's ``validate_calibration`` ok;
     every number of the study held to the same code on the CPU (both at
     ``MEMSIM_CHECK_STEPS``) at the histogram gates; three runs timed warm
     by the host clock, each with its launches, the device's busy share
     and peak memory: ``validate_calibration`` of both engines,
     ``crosscheck_engines``, and the default QueueLUT grid as one event
     engine sweep; the two scan kernels timed at the study's shapes.  To
     run only this phase: ``python3 -c "import chip_smoke;
     chip_smoke.memsim_phase()"``;
  8. the QueueLUT and the fixed point's memsim backend (``lut_phase``):
     the default and the harvest surface built cold through ``python -m
     repro_torch.lut prebuild`` (42 memsim_event_scan launches each) and
     alone, timed, then read warm from the store (no launch); sub-grids
     built on the CPU equal to the card's cells bit for bit; the memsim
     ``default_sweep``, its tail frontier and ``design_gradient`` held to
     the CPU;
  9. the designer and the capacity planner (``serving_phase``):
     ``repro_torch.designer.main`` at the reference's defaults (area 1.2,
     SLO 500 ms, stablelm-1.6b, 40 iterations, the 120,000-step default
     surface read warm), its memsim_event_scan launches exactly those of
     the one verification run (1 lane, 3 chunks); ``optimize_design`` on
     the CPU with the same tables: the same start, iterations and
     ``converged``, the fields within ``DESIGN_RTOL``; value-and-grad at
     the knee and at the optimum, and the verification DES, held to the
     CPU; ``repro_torch.serving.plan.main`` at its documented example
     (mistral-large-123b, SLO 60 ms, the diurnal trace): every one of the
     plan's DES cells, and a 54-cell sample run alone, bit for bit to the
     CPU, the launches of its one DES run exact, the verdicts of the
     ``des`` and the ``lut`` source held to the CPU's; then
     ``queuelut.headline_metrics``; the optimize, one value-and-grad
     (launches, busy share), the verification run and both plans timed.
     Alone: ``python3 -c "import chip_smoke; chip_smoke.serving_phase()"``;
 10. training (``train_phase``): rwkv6-1.6b at full width (24 layers,
     bf16, batch 8 x 1,024, remat "full", the CLI's AdamW) through
     ``repro_torch.launch.train.main`` for 4 steps, launches exact (48
     wkv and 24 wkv_bwd a step: each layer's forward and its recompute,
     and its backward), losses finite; one float32 value-and-grad at full
     width cut to 4 layers through K3/K3b and through their plain
     versions, the loss, the gradient norm and every leaf held
     (``TRAIN_PATH_TOL``); stablelm-1.6b and hubert-xlarge at full width
     through train.main for 2 steps each (flash_attention's two KV chunks
     at 1,024; no hand kernel), each held to the CPU in float32 at 2
     layers and batch 1; a checkpoint save, a crash and a resume on the
     card (smoke rwkv6) reproducing the uninterrupted losses; a train step
     of each model timed (ms, tokens/s, busy share, peak memory, K3/K3b a
     launch) and K3b timed at the training shape beside its bound and its
     plain version.  Alone: ``python3 -c "import chip_smoke;
     chip_smoke.train_phase()"``;
 11. the multi-device layer (``mesh_phase``; ``partials_phase`` runs
     K2's partial build's part of phases 2 and 5 alone): the DES through
     ``core/shardsim`` with ``devices="auto"`` (every card torch sees)
     against ``devices=None``, both engines, 74 lanes, histograms bit for
     bit and each run's scan launches exact (one a chunk a shard); a
     one-rank NCCL world's (1, 1) mesh (``launch/mesh.make_host_mesh``):
     stablelm-1.6b at full width in bf16 (batch 8, prompt 1,024, 32
     steps) with its parameters DTensors by ``decode_rules``, its cache
     placed by ``cache_shardings`` and the batch activation rule active,
     through ``distributed/step.make_prefill`` and ``make_serve_step``:
     exactly 768 decode_attn launches (K2 on each rank's local shards),
     greedy tokens equal to the same serve on ordinary tensors and logits
     within the bf16 gate; ``int8_all_reduce`` on that world equal to its
     own quantize round trip; then, beside the dry-run cells below, four
     two-rank serves (``world_serves``, ``WORLD_SERVES``), two at a time
     (``WORLD_WAVES``), each two gloo ranks, each rank a process on the
     one card, at full layer width (batch 8, prompt 256,
     8 steps), the ordinary serve's tokens fed through ``make_prefill``
     and ``make_serve_step``, logits within the path gate of the ordinary
     serve's and rank 0's K2 launches exact: stablelm-1.6b bf16 on (1, 2)
     with its cache's sequence over ``model`` (the channelized decode:
     192 decode_attn_partials launches, 8 steps x 24 layers, each rank's
     slice merged by two all-reduces, and none of decode_attn);
     olmoe-1b-7b float32 at 8 of 16 layers on (2, 1), each rank routing
     its own tokens with the other's counts as offsets and computing its
     half of the expert buffers' capacity (64 decode_attn launches; the
     gate on the batch rows whose routing decisions agree with the
     ordinary serve's, and moe_overflow equal to its where all do);
     zamba2-2.7b float32 at 18 of 54 layers on (1, 2) with the SSM heads
     over ``model`` (24 decode_attn_partials launches, 8 x 3 shared
     blocks); starcoder2-3b bf16 on (1, 2), 12 query heads a rank and K2
     against its group's KV head, G 12 (240 decode_attn launches, 8 x 30
     layers); the split train step (``SPLIT_TRAIN``, a wave of its own):
     rwkv6-1.6b at full width and depth, batch 1 x 2,048, each sequence
     split in halves over a (pod 2, data 1, model 1) mesh of two gloo
     ranks (folded to (2, 1)), each rank running K3 on its half from the
     state the other hands over and K3b in the reverse order, against one
     process's whole-sequence step (``SPLIT_RUNS``): in float64 on the
     plain path (:func:`float64_witness`), loss and gradients as one
     process's to float64's rounding; in bf16 each rank's launches equal
     one process's (48 K3, 24 K3b), the loss and norm within
     ``TRAIN_PATH_TOL``'s, and its gradients no farther from the float64
     step's than ``SPLIT_ROUNDING`` x the one-process step's; after K3's
     and K3b's
     two-launch chains at that shape are held to one launch (``WKV_TOL``,
     bit-equality reported); and seven dry-run cells, five on the fake
     256-rank (32, 8) world (stablelm-1.6b decode_32k, channelized, and
     train_4k, olmoe-1b-7b and rwkv6-1.6b train_4k, zamba2-2.7b
     decode_32k) and rwkv6-1.6b's and stablelm-1.6b's prefill_32k on the
     512-rank (2, 32, 8) one, sequences split over ``pod``, each in a
     process of its own, their FLOPs, collective bytes and argument GiB
     a chip printed and held to the CPU's torch 2.13 (``DRYRUN_TORCH_213``:
     FLOPs and collective bytes within 1e-4).  Alone:
     ``python3 -c "import chip_smoke; chip_smoke.mesh_phase()"``; one
     serve:
     ``chip_smoke.world_serve("olmoe")``; the split sequences alone:
     ``chip_smoke.split_phase()``.

The card's nvidia-smi line is printed again just before the JSON object
``{"kernels": [...]}``, the line before the last; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card, nvcc, and nothing
of JAX.
"""

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

DENSE_ARCH, SSM_ARCH, MOE_ARCH = "stablelm-1.6b", "rwkv6-1.6b", "olmoe-1b-7b"
# zamba2-2.7b serves at full width (9 groups of 6 Mamba layers, a shared
# attention block of head dim 80 after each); qwen2-vl-72b at full layer
# width but 8 of its 80 layers (72.7 B parameters, 145 GB in bf16, do not
# fit one card; 8 layers hold ~9.5 B, 19 GB in bf16, 38 GB in float32).
HYBRID_ARCH, VLM_ARCH, VLM_LAYERS = "zamba2-2.7b", "qwen2-vl-72b", 8
BATCH, PROMPT, GEN, SEED = 8, 1024, 32, 0
# float32: the reference's own kernel-test tolerance.  bfloat16: kernel and
# plain version both compute in fp32 and round once to bf16, so they may
# sit one bf16 rounding step apart (spacing <= 2**-6 for |x| < 4).
KERNEL_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-3),
              torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
# wkv: the reference's own kernel-test tolerance (tests/test_kernels.py).
# It holds for bf16 r/k/v too: kernel and plain version read the same bf16
# values and compute in fp32; only the order of the fp32 sums differs.
WKV_TOL = dict(atol=1e-4, rtol=1e-4)
# Logits, kernel path against plain path (phase 4), by path: the dtype the
# check runs in and the largest max|dlogit| it allows.
#  * stablelm-1.6b, bf16 (the served dtype): the paths differ only in the
#    decode attention of one token: the plain one rounds q*scale and the
#    probabilities to bf16 (as the reference does), the kernel keeps fp32.
#    Per layer that moves the attention output by about one bf16 step
#    (2**-8 relative); through 24 layers and the head the logits
#    (|logit| ~ 1..5) may move by a few bf16 steps at most.
#  * rwkv6-1.6b, float32: in bf16 a change in the order of wkv's fp32 sums
#    flips bf16 roundings of y that every later step of a 1024-token
#    prefill and every later layer carry, and moves the logits by as much
#    as a faulty kernel would.  In float32 the paths differ only in that
#    order (~1e-6 relative on y and the state); amplified even a hundred
#    times through 24 layers, logits of |logit| <= 5 move by ~5e-4.  A
#    kernel that kept its state in bf16 (2**-9 relative a step, carried
#    over the ~20-step memory of the model's decay) would move them by
#    ~1e-1.  The gate sits between the two.
#  * olmoe-1b-7b, float32: in bf16 the paths' one-bf16-step difference in
#    the decode attention can flip a router decision (64 experts, gates a
#    bf16 step apart are common), and a flipped expert moves the logits
#    more than a faulty kernel would.  In float32 the attention differs by
#    ~1e-6 relative a layer; through 16 layers logits of |logit| <= 5 move
#    by ~1e-4, while a kernel that dropped or repeated one key of ~1,000
#    moves them by ~1e-2 or more.  The routing decisions of both paths are
#    counted; the gate holds on the batch rows whose routes all agree.
#  * zamba2-2.7b, float32: in bf16 each of the 9 shared blocks' K2 call
#    moves its attention output by a bf16 step, and 54 Mamba layers, each
#    rounding its gated norm and projections to bf16, carry and re-round
#    it; the logits would then move by as much as a faulty kernel's.  In
#    float32 the paths differ by ~1e-6 relative a K2 call; through 54
#    layers logits of |logit| <= 5 move by ~1e-4, while a kernel that
#    dropped or repeated one key of ~1,000 moves them by ~1e-2 or more.
#  * qwen2-vl-72b (8 layers), float32: in bf16 the decode step's K2 call
#    and the plain attention's bf16 roundings of q*scale and the
#    probabilities sit a bf16 step apart a layer, and through 8 layers of
#    d_model 8,192 the logits move by up to ~7e-2 (read on the card), more
#    than a kernel that dropped or repeated one key of ~1,000 (~1e-2)
#    would.  In float32 the prefills of both paths are the same code (the
#    prompt's vision rows make the bf16 pass float32 as well) and the step
#    differs by ~1e-6 relative a K2 call; through 8 layers logits of
#    |logit| <= 5 move by ~1e-5, so a gate of 1e-2 sees such a fault.
PATH_CHECK = {DENSE_ARCH: (torch.bfloat16, 0.125),
              SSM_ARCH: (torch.float32, 1e-2),
              MOE_ARCH: (torch.float32, 1e-2),
              HYBRID_ARCH: (torch.float32, 1e-2),
              VLM_ARCH: (torch.float32, 1e-2)}
# K2 at the planner's shape (phases 2, 5, 6): one mistral-large-123b layer
# decoding at 32k context, batch 8, 96 query heads over 8 KV heads of 128
# (G 12), the study's decode plan (launch/coaxial_study.DECODE_PLAN).
PLAN_LAYER_SHAPE = (8, 96, 8, 128, 32768)
# One model rank's slice of that layer's cache when its sequence is split
# over the 8 ranks of (32, 8) (the channelized cache): K2's partial build
# reads it (phases 2 and 5).
PIECE_SHAPE = PLAN_LAYER_SHAPE[:-1] + (PLAN_LAYER_SHAPE[-1] // 8,)
# STREAM: the probe's elements an array (268 MB in float32, more than 4x
# the 50 MB L2), its timed launches, and a scalar that bf16 cannot hold
# exactly, so that the kernels must round it as the plain versions do.
STREAM_N, STREAM_ITERS, STREAM_ALPHA = 2**26, 20, 0.1
# Each op, and the line of the TPU kernel it replaces in
# src/repro/kernels/stream.py.
STREAM_OPS = {"copy": 35, "scale": 39, "add": 43, "triad": 47}
# The design-space engine (phase 6), card against CPU, the same port code
# in float32: only the libraries' pow/exp/log/sqrt may differ in their last
# bits, which the 120-step fixed point carries to 1e-7..5e-6 (measured on
# an H100; the port sits within 1.1e-6 of the JAX reference on the CPU);
# a wrong operation moves results by far more.  Gradient fields that are 0 on both sides (the
# harvest fields, a link floor that does not bind) meet the atol.
ENGINE_RTOL, ENGINE_GRAD_ATOL = 1e-5, 1e-8
# Timed solves of each grid after a warm one, and dense cells held to a
# CPU solve.
ENGINE_REPEATS, ENGINE_SAMPLE = 5, 1000
# The memory-system DES (phases 2 and 7).  The reference's default QueueLUT
# grid (repro/core/queuelut.py: DEFAULT_{RHO,KAPPA,OUTSTANDING,ETA}_GRID,
# DEFAULT_STEPS, DEFAULT_REPS, built by the event engine): 14 x 6 x 6 x 4
# cells x 2 replicas = 4,032 lanes.
LUT_RHO = (0.05, 0.15, 0.25, 0.35, 0.45, 0.55, 0.62, 0.68, 0.74, 0.79,
           0.84, 0.88, 0.91, 0.93)
LUT_KAPPA = (1.0, 1.3, 1.6, 2.2, 2.7, 3.2)
LUT_OUTSTANDING = (2.0, 4.0, 8.0, 24.0, 64.0, 192.0)
LUT_ETA = (0.05, 0.30, 0.60, 1.0)
LUT_STEPS, LUT_REPS = 120_000, 2
# The study's budget on the card (its gates' own), and the budget at which
# card and CPU both run it to be compared: on the CPU (8 cores of the H100
# host) the study takes ~50 s at 60,000 steps, nearly all of it the plain
# scans' per-step loops, so ~170 s at the full budget; the comparison is
# cut to keep the CPU side near 100 s.
MEMSIM_STEPS, MEMSIM_CHECK_STEPS = 200_000, 120_000
# Card against CPU, the histogram gates of tests/test_torch_memsim.py:
# quantiles within one 4-ns bin, means and stdevs within 1e-4 relative.
# (Stage A is the same integer hash and emulated float32 math on both, and
# the scans agree bit for bit, so the measured difference is 0.)
MEMSIM_MEAN_RTOL = 1e-4
# Warm timed repeats of each of phase 7's three runs.
MEMSIM_REPEATS = 2
# Dependent float32 operations a step in the shortest carried chain the
# reference's scan bodies allow (scan_line), for K4 and K5 alike.
CHAIN_OPS = 4
# Phase 8: the sub-grid of the default QueueLUT built again on the CPU (24
# cells x LUT_REPS at LUT_STEPS), and of the harvest surface at two of its
# duties (48 cells), each held bit for bit to the card's cells; warm store
# reads timed.
LUT_CPU_GRID = dict(rho=(0.35, 0.74, 0.91), kappa=(1.0, 2.7),
                    outstanding=(8.0, 64.0), eta=(0.3, 1.0))
LUT_CPU_HARVEST = (0.0, 0.5)
LUT_WARM_READS = 5
# Cold builds of each surface alone, timed after the counted one.
LUT_COLD_REPEATS = 3
# Phase 9: the designer CLI at the reference's defaults (full width: the
# Table-4 mix plus stablelm-1.6b's decode workload, the 8-channel x 4-LLC
# frontier, 40 iterations, the 120,000-step default surface, the event
# engine) and the capacity planner CLI at its documented example (8
# diurnal epochs, every registry, generated and measured design, pure and
# 50/50 tiered, 60,000 DES steps a cell).
DESIGN_ARGV = ["--area-budget", "1.2", "--slo-ms", "500", "--arch",
               "stablelm-1.6b", "--batch", "32", "--context", "2048",
               "--iters", "40", "--steps", "120000", "--engine", "event"]
PLAN_ARGV = ["--arch", "mistral-large-123b", "--slo-p99-ms", "60",
             "--trace", "synthetic-diurnal"]
# Card against CPU, the same port code in float32.  A value-and-grad at a
# fixed point: phase 6's engine tolerance (the solves differ only in the
# libraries' last bits).  The ascent's end: each step moves the fields by
# lr * g * width**2 (~15 x g for the channels), so a gradient 5e-6 apart
# moves an iterate by ~1e-5 of its value, and the bisection onto the
# budget surface carries that; the fields, gm and token p99 are held at
# 1e-4.  The DES runs are bit for bit (phase 7).
DESIGN_RTOL = 1e-4
# Every third-and-a-bit cell of the plan's DES batch run again alone on
# both devices: 54 lanes, not a multiple of the kernels' 32-lane blocks.
PLAN_SAMPLE_STRIDE = 6
# Warm timed repeats of the optimize and of each plan.
SERVING_REPEATS = 2
# Phase 10, training at full width, batch 8 x 1,024 tokens (the CLI's
# AdamW, remat "full"): rwkv6-1.6b through K3 and K3b, stablelm-1.6b and
# hubert-xlarge through flash_attention (two KV chunks at 1,024), steps
# through train.main each; then TRAIN_TIMED warm steps of each timed.
AUDIO_ARCH = "hubert-xlarge"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 8, 1024, 2
TRAIN_STEPS = {SSM_ARCH: 4, DENSE_ARCH: 2, AUDIO_ARCH: 2}
# K3b's inputs at that shape: rwkv6-1.6b's 32 heads of 64.
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 32, 64)
# K3b against wkv_bwd_ref: every output within 1e-4 of its largest
# element.  Both compute in fp32 and walk the same recurrence over T;
# only the order of the sums over D differs (measured in the CPU tests
# against jax.vjp: <= 2.3e-7 of the largest).  A missing bonus term, a
# state one step off or a segment edge dropped moves an output by 1e-2 of
# its largest or more.
WKV_BWD_TOL = 1e-4
# rwkv6 at full width cut to 4 layers, float32, one value-and-grad through
# K3/K3b and through their plain versions.  Only the order of fp32 sums in
# the two kernels differs (~1e-6 relative a call, phase 2), but the
# model's gradients carry the recurrence's rounding far: measured on the
# card (H100, 700 W) the loss is bit-equal, the global gradient norm
# 3.0e-4 relative apart and the worst leaf (cm_mix) 4.7e-4 of its largest
# element.  Gates: loss 1e-5, norm 2e-3, leaves 5e-3.  A wiring fault (a
# gradient dropped, swapped or given to the wrong input: du, dw) moves a
# leaf by its own size.
TRAIN_CHECK_LAYERS = 4
TRAIN_PATH_TOL = dict(loss=1e-5, gnorm=2e-3, leaf=5e-3)
# stablelm-1.6b and hubert-xlarge at full width cut to 2 layers, float32,
# batch 1 x 1,024 (the CPU side within about a minute), card against CPU:
# the same port code, cuBLAS and the CPU's BLAS summing in other orders.
# Measured: losses equal, norms 1.2e-7 apart, leaves within 1.3e-5 of
# their largest.  Gates: loss and norm 1e-5, leaves 1e-4.
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH = 2, 1
TRAIN_CPU_TOL = dict(loss=1e-5, gnorm=1e-5, leaf=1e-4)


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


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


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed ``replays`` times between CUDA events, so that
    the calls' kernels run back to back and no host time is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def rand_qkv(b, hq, hk, d, s, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=gen,
                                    dtype=torch.float32).to(dtype)
    return mk(b, hq, d), mk(b, s, hk, d), mk(b, s, hk, d)


def launch_split(da, q, k, v, length, parts=None):
    """``da.decode_attn``, split by ``da.partition``, or its launch forced
    into ``parts`` parts."""
    if parts is None:
        return da.decode_attn(q, k, v, length)
    return da._launch(q, k, v, length, da.split(parts, length))


def check_boundary_keys(da, ref, shape, dtype, lengths, seed, parts=None):
    """Kernel against plain where one key more or less shows: at each
    length the keys either side of every part boundary of the split taken
    there, of the first tile boundary and of the length itself dominate.
    Every query head of a KV head is one vector q0; those keys are 4 q0
    (a score of ~4 sqrt(D), ~45 at D 128, against ~N(0, 1) for the rest,
    whose exponentials then add < 1e-10 of the weight); the i-th carries 4
    in dimension i of its value and 0 elsewhere.  The output is the mean of
    the n such values within length, 4/n in each of their dimensions, and a
    key dropped, counted twice or read past length moves it by >= 4/(n+1)
    (n <= 34), far past ``KERNEL_TOL``.  With random inputs a one-key error
    at 16k keys moves the output by ~1e-3, inside it."""
    b, hq, hk, d, s = shape
    g = hq // hk
    q, k, v = rand_qkv(b, hq, hk, d, s, dtype, seed)
    q0 = q.view(b, hk, g, d)[:, :, 0]
    q = q0[:, :, None].expand(b, hk, g, d).reshape(b, hq, d).contiguous()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tol = KERNEL_TOL[dtype]
    for length in lengths:
        cut = (da.partition(b, hk, length, sms) if parts is None
               else da.split(parts, length))
        edges = [da.TILE_KEYS, length] + [
            p * cut.part_keys for p in range(1, cut.parts)
            if p * cut.part_keys < length]
        keys = sorted({x + dx for x in edges for dx in (-1, 0)
                       if 0 <= x + dx < s})
        saved = k[:, keys].clone(), v[:, keys].clone()
        k[:, keys] = 4 * q0[:, None]
        v[:, keys] = 0
        for i, n in enumerate(keys):
            v[:, n, :, i % d] = 4
        got = launch_split(da, q, k, v, length, parts).float()
        want = ref.decode_attn_ref(q, k, v, length).float()
        k[:, keys], v[:, keys] = saved
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, **tol)
        inside = sum(n < length for n in keys)
        log(f"  decode_attn {dtype} {shape} length {length} in "
            f"{cut.parts} parts of {cut.part_keys}: {inside} dominant keys "
            f"{keys} inside: max|err| {err:.3e} (output up to "
            f"{want.abs().max().item():.3g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"decode_attn miscounts a boundary key at {shape}, {dtype},"
                 f" length {length} in {cut.parts} parts")


def check_decode_attn(da, ref, shape, dtype, lengths, seed, parts=None):
    """Kernel against plain on the card, split by ``da.partition`` or into
    ``parts``; returns the max |error|."""
    b, hq, hk, d, s = shape
    q, k, v = rand_qkv(b, hq, hk, d, s, dtype, seed)
    tol = KERNEL_TOL[dtype]
    split = "" if parts is None else f" in {parts} parts"
    worst = 0.0
    for length in lengths:
        got = launch_split(da, q, k, v, length, parts)
        want = ref.decode_attn_ref(q, k, v, length)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        ok = torch.allclose(got.float(), want.float(), **tol)
        log(f"  decode_attn {dtype} B{b} Hq{hq} Hk{hk} D{d} S{s} "
            f"length {length}{split}: max|err| {err:.3e} (atol "
            f"{tol['atol']}, rtol {tol['rtol']}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"decode_attn disagrees with decode_attn_ref at {shape}, "
                 f"{dtype}, length {length}{split}")
    # Poisoned tail: entries past `length` must not move the output.
    length = s // 2 + 3
    clean = launch_split(da, q, k, v, length, parts)
    k[:, length:], v[:, length:] = 1e4, -1e4
    poisoned = launch_split(da, q, k, v, length, parts)
    if not torch.equal(clean, poisoned):
        fail(f"decode_attn read past length {length} at {shape}, "
             f"{dtype}{split}")
    log(f"  poisoned tail past length {length}{split}: output unchanged")
    return worst


def split_edges(da, shape):
    """The split ``da.partition`` makes at the full cache of ``shape``, and
    lengths one either side of its first tile and part boundaries."""
    b, _, hk, _, s = shape
    cut = da.partition(b, hk, s, torch.cuda.get_device_properties(
        0).multi_processor_count)
    edges = {x + dx for x in (da.TILE_KEYS, cut.part_keys,
                              (cut.parts - 1) * cut.part_keys)
             for dx in (-1, 0, 1)}
    return cut, sorted(n for n in edges if 1 <= n <= s)


def check_partials(da, ref, shape, dtype, lengths, seed):
    """K2's partial build against ``decode_attn_partials_ref`` on the card,
    at each length (0 included: no key).  m is held within ``KERNEL_TOL``,
    l within its rtol of the plain l, and acc through the output it
    normalizes to, acc / l, within ``KERNEL_TOL``: the bf16 build rounds
    the probabilities to bf16 before P V (as the ordinary build does), so
    acc, a sum of up to ``length`` terms, moves by a share of its own size
    that the output's tolerance bounds.  At length 0 the terms must be
    exactly m -1e30, l 0, acc 0.  Returns the largest |error| of the
    normalized output."""
    b, hq, hk, d, s = shape
    q, k, v = rand_qkv(b, hq, hk, d, s, dtype, seed)
    tol = KERNEL_TOL[dtype]
    worst = 0.0
    for length in lengths:
        m, l, acc = da.decode_attn_partials(q, k, v, length)
        wm, wl, wacc = ref.decode_attn_partials_ref(q, k, v, length)
        torch.cuda.synchronize()
        if length == 0:
            ok = (torch.equal(m, torch.full_like(m, -1e30)) and
                  not l.any().item() and not acc.any().item())
            err = 0.0
        else:
            out, want = acc / l[..., None], wacc / wl[..., None]
            err = (out - want).abs().max().item()
            ok = (torch.allclose(m, wm, **tol) and
                  torch.allclose(l, wl, rtol=tol["rtol"], atol=0.0) and
                  torch.allclose(out, want, **tol))
        worst = max(worst, err)
        log(f"  decode_attn_partials {dtype} B{b} Hq{hq} Hk{hk} D{d} S{s} "
            f"length {length}: max|dm| {(m - wm).abs().max().item():.3e}, "
            f"max|dl|/l {((l - wl).abs() / wl.clamp(min=1e-30)).max().item():.3e},"
            f" max|d(acc/l)| {err:.3e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"decode_attn_partials disagrees with its plain version at "
                 f"{shape}, {dtype}, length {length}")
    return worst


def check_partial_merge(da, ops, shape, dtype, pieces, lengths, seed):
    """The cache cut into ``pieces`` sequence slices, K2's partial build run
    on each (a slice past the length gets length 0) and the terms merged by
    ``ops.merge_partials`` over the stacked slices: equal to one K2 launch
    over the whole cache within ``KERNEL_TOL``, as the ranks of a
    channelized cache merge by all-reduce.  Returns the largest |error|."""
    b, hq, hk, d, s = shape
    q, k, v = rand_qkv(b, hq, hk, d, s, dtype, seed)
    w = s // pieces
    slices = [(k[:, i * w:(i + 1) * w].contiguous(),
               v[:, i * w:(i + 1) * w].contiguous()) for i in range(pieces)]
    worst = 0.0
    for length in lengths:
        local = [min(max(length - i * w, 0), w) for i in range(pieces)]
        terms = [da.decode_attn_partials(q, ks, vs, n)
                 for (ks, vs), n in zip(slices, local)]
        m, l, acc = (torch.stack(x) for x in zip(*terms))
        got = ops.merge_partials(m, l, acc, q.dtype,
                                 lambda x: x.amax(0, keepdim=True),
                                 lambda x: x.sum(0))
        want = da.decode_attn(q, k, v, length)
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        ok = torch.allclose(got.float(), want.float(), **KERNEL_TOL[dtype])
        log(f"  {pieces} slices of {w} keys, lengths {local}, merged, against "
            f"one K2 launch over {s} keys at length {length}, {dtype}: "
            f"max|err| {err:.3e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"the merge of {pieces} slices' partials disagrees with one "
                 f"K2 launch at {shape}, {dtype}, length {length}")
    return worst


def check_all_partials(da, ops, ref, served):
    """Phase 2 for K2's partial build, bf16 and f32: each served decode
    shape, one rank's slice of the mistral layer on (32, 8) and the layer
    itself, from no key to all of them; then the layer cut into 2, 4 and 8
    slices and merged, against one launch over it, at the whole cache and
    at 20,000 keys (at 8 slices the last three are empty).  Returns the
    largest bf16 |error| of the normalized output."""
    plan_s = PLAN_LAYER_SHAPE[-1]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for seed, shape in enumerate(served + [PIECE_SHAPE,
                                               PLAN_LAYER_SHAPE], 31):
            err = check_partials(da, ref, shape, dtype,
                                 [0, 1, 333, shape[-1] - 1, shape[-1]], seed)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
        for pieces in (2, 4, 8):
            check_partial_merge(da, ops, PLAN_LAYER_SHAPE, dtype, pieces,
                                [plan_s, 20_000], seed=40 + pieces)
    return worst


def check_back_to_back(da, ref, cases, dtype, seed):
    """Calls at alternating shapes and lengths queued with no synchronize
    between them, then each held to the plain version again: no merge
    state may carry from one launch to the next."""
    inputs = [rand_qkv(*shape, dtype, seed + i)
              for i, (shape, _) in enumerate(cases)]
    calls = [(i, n) for i, (_, lengths) in enumerate(cases) for n in lengths]
    calls = calls[0::2] + calls[1::2]
    outs = [da.decode_attn(*inputs[i], n) for i, n in calls]
    worst = 0.0
    for (i, n), got in zip(calls, outs):
        want = ref.decode_attn_ref(*inputs[i], n)
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        if not torch.allclose(got.float(), want.float(), **KERNEL_TOL[dtype]):
            fail(f"decode_attn back to back: {cases[i][0]}, length {n}, "
                 f"{dtype} disagrees with decode_attn_ref")
    log(f"  {len(calls)} calls back to back at {len(cases)} alternating "
        f"shapes, {dtype}: each within tolerance (max|err| {worst:.3e})")


def rand_wkv(b, t, h, d, dtype, decay, seed):
    """r, k, v in ``dtype``; w, u, s0 in fp32.  ``decay`` "model" is
    time_mix's exp(-exp(N(0,1) - 3)); "sigmoid" is the reference test's
    sigmoid(N(0,1)) * 0.5 + 0.5."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    r, k, v = (mk(b, t, h, d).to(dtype) for _ in range(3))
    z = mk(b, t, h, d)
    w = torch.exp(-torch.exp(z - 3.0)) if decay == "model" else \
        torch.sigmoid(z) * 0.5 + 0.5
    return r, k, v, w, mk(h, d), mk(b, h, d, d)


def check_wkv(kw, ref, shape, dtype, decay, seed, cuts=()):
    """wkv against wkv_ref on the card, then wkv over T against two
    chained pieces (bit-exact), cut at t // 3 + 1 and at each of ``cuts``
    below t; returns the max |error| against plain."""
    b, t, h, d = shape
    r, k, v, w, u, s0 = rand_wkv(b, t, h, d, dtype, decay, seed)
    y, s = kw.wkv(r, k, v, w, u, s0)
    y_ref, s_ref = ref.wkv_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    err = max((y - y_ref).abs().max().item(), (s - s_ref).abs().max().item())
    ok = torch.allclose(y, y_ref, **WKV_TOL) and \
        torch.allclose(s, s_ref, **WKV_TOL)
    log(f"  wkv {dtype} w~{decay} B{b} T{t} H{h} D{d}: max|err| {err:.3e} "
        f"(|y| <= {y_ref.abs().max().item():.1f}, atol {WKV_TOL['atol']}, "
        f"rtol {WKV_TOL['rtol']}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"wkv disagrees with wkv_ref at {shape}, {dtype}, w~{decay}")
    piece = lambda x, sl: x[:, sl].contiguous()
    for cut in dict.fromkeys(c for c in (t // 3 + 1, *cuts) if 0 < c < t):
        y1, s1 = kw.wkv(*(piece(x, slice(0, cut)) for x in (r, k, v, w)),
                        u, s0)
        y2, s2 = kw.wkv(*(piece(x, slice(cut, None)) for x in (r, k, v, w)),
                        u, s1)
        if not (torch.equal(torch.cat([y1, y2], dim=1), y) and
                torch.equal(s2, s)):
            fail(f"wkv over T != two chained pieces (cut {cut}) at {shape}, "
                 f"{dtype}")
        log(f"    chained at {cut}: bit-exact")
    return err


def wkv_cost(b, t, h, d, itemsize):
    """(bytes, FLOP) the function needs: each input read once, y and the
    state written once; per step and head, r . S (an FMA per state
    element) and S * w + k v (a multiply and an FMA), plus O(D) for the
    bonus term, which factors out: sum_i r_i u_i k_i v_j = v_j c."""
    nbytes = b * t * h * d * (3 * itemsize + 4 + 4) + 2 * b * h * d * d * 4
    return nbytes, 5 * b * t * h * d * d + 5 * b * t * h * d


def profile(fn):
    """Device time of the kernels one call of ``fn`` ran (ms, or None if
    the profiler saw none) and the kernels as (ms, name, count), largest
    first."""
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
    return sum(r[0] for r in rows), rows


def launch_counts(rows):
    """(kernel launches, copies and sets) in ``profile``'s rows."""
    copies = sum(r[2] for r in rows if r[1].startswith(("Memcpy", "Memset")))
    return sum(r[2] for r in rows) - copies, copies


def stream_args(op, a, b, alpha):
    """The arguments of STREAM ``op`` on arrays a, b."""
    return {"copy": (a,), "scale": (a, alpha), "add": (a, b),
            "triad": (a, b, alpha)}[op]


def stream_library(op, a, b, alpha):
    """The one PyTorch call that computes STREAM ``op`` (alpha already
    rounded to a's type); timed beside the kernel, used nowhere in the
    port."""
    return {"copy": lambda: torch.empty_like(a).copy_(a),
            "scale": lambda: torch.mul(a, alpha),
            "add": lambda: torch.add(a, b),
            "triad": lambda: torch.add(a, b, alpha=alpha)}[op]


def check_stream(ks, ref, shape, dtype, seed):
    """The four STREAM kernels against their plain versions on the card,
    bit for bit; copy also against its input's bits.  Returns {op: max
    |error|} (0.0 when equal)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a, b = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    errs = {}
    for op in STREAM_OPS:
        args = stream_args(op, a, b, STREAM_ALPHA)
        got = getattr(ks, f"stream_{op}")(*args)
        want = getattr(ref, f"stream_{op}_ref")(*args)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"stream_{op} differs from its plain version at {shape}, "
                 f"{dtype}")
        errs[op] = (got.float() - want.float()).abs().max().item()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    if not torch.equal(ks.stream_copy(a).view(bits), a.view(bits)):
        fail(f"stream_copy changed the bits of its input at {shape}, {dtype}")
    log(f"  stream copy/scale/add/triad {dtype} {shape} (alpha "
        f"{STREAM_ALPHA}): equal to plain (torch.equal), copy bit-exact")
    return errs


def engine_close(what, card, cpu, atol=0.0, orbit=None):
    """Phase 6: hold the card's numbers to the CPU's, elementwise within
    ``atol + ENGINE_RTOL * |cpu|`` of the card's value or, where ``orbit``
    (the card's values at the steps around it, stacked on a leading axis)
    is given, of the span those values cover; returns the largest relative
    difference from the card's value (NaN on both sides counts as
    equal)."""
    import numpy as np
    card = np.asarray(card, np.float64)
    cpu = np.asarray(cpu, np.float64)
    span = card[None] if orbit is None else np.concatenate(
        [card[None], np.asarray(orbit, np.float64)])
    lo, hi = span.min(0), span.max(0)
    pad = atol + ENGINE_RTOL * np.abs(cpu)
    ok = card.shape == cpu.shape and bool(np.all(
        (np.isnan(card) & np.isnan(cpu)) | (card == cpu)
        | ((cpu >= lo - pad) & (cpu <= hi + pad))))
    both = ~(np.isnan(card) & np.isnan(cpu)) & (cpu != 0)
    rel = float(np.max(np.abs(card - cpu)[both] / np.abs(cpu[both]),
                       initial=0.0)) if card.shape == cpu.shape else np.inf
    if not ok:
        fail(f"engine: {what} differs between card and CPU (max rel "
             f"{rel:.3e}, rtol {ENGINE_RTOL}, atol {atol}"
             f"{'' if orbit is None else ', beyond the orbit'})")
    return rel


def steps_further(cpu_model, k, solve):
    """``solve()`` with the fixed point run ``k`` steps longer (shorter
    where ``k`` < 0)."""
    cpu_model.FP_ITERS += k
    try:
        return solve()
    finally:
        cpu_model.FP_ITERS -= k


def engine_grid(label, solve, cells, cpu_model):
    """Phase 6 for one grid: a warm solve, ``ENGINE_REPEATS`` timed ones
    (host clock, ending in a synchronise), one profiled (kernel launches,
    copies, device time) and one under the peak-memory counter (less what
    was allocated before it).  Each solve must be one call of the cell
    solver.  Returns the last result and the kernel launches and median
    ms of a solve."""
    calls = cpu_model.solve_trace_count()
    res = solve()
    if cpu_model.solve_trace_count() != calls + 1:
        fail(f"engine {label}: one solve made "
             f"{cpu_model.solve_trace_count() - calls} cell-solver calls")
    ms = []
    for _ in range(ENGINE_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    dev_ms, rows = profile(solve)
    launches, copies = launch_counts(rows)
    # The solve's own peak: what earlier phases left allocated is not its.
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    solve()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    wall = sorted(ms)[len(ms) // 2]
    busy = "not measured" if dev_ms is None else \
        f"{dev_ms:.3f} ms -> busy share {dev_ms / wall:.3f}"
    log(f"engine {label} ({cells} cells x 35 workloads): solve "
        f"{', '.join(f'{m:.3f}' for m in ms)} ms (median {wall:.3f}); "
        f"{launches} kernel launches and {copies} "
        f"copies a solve; device time {busy}; peak device memory of a "
        f"solve {peak / 2**20:.1f} MiB")
    for dms, key, count in rows[:4]:
        log(f"  {dms:9.3f} ms  x{count:<5d} {key[:80]}")
    return res, launches, wall


def engine_phase(plan_k2_ms=None):
    """Phase 6: the design-space engine on the card, against the CPU, and
    the decode plan's per-layer memory term beside K2's time at that
    layer's shape (``plan_k2_ms``, phase 5's; "not measured" alone)."""
    import numpy as np

    from repro_torch.core import coaxial, cpu_model, hw, planner
    from repro_torch.core.sweepspec import build_flat
    from repro_torch.launch import coaxial_study

    spec = hw.spec_for(torch.cuda.get_device_name(0))
    card = coaxial_study.main([])
    cpu = coaxial_study.main(["--device", "cpu"], spec=spec)
    worst = 0.0
    for key, want in cpu.items():
        if isinstance(want, str) or isinstance(want, int):
            if card[key] != want:
                fail(f"engine: study {key} {card[key]!r} on the card, "
                     f"{want!r} on the CPU")
        else:
            worst = max(worst, engine_close(f"study {key}", card[key], want))
    log(f"engine: coaxial_study on the card equals its CPU run: {len(cpu)} "
        f"numbers, max rel diff {worst:.3e} (rtol {ENGINE_RTOL})")
    layer_s = planner.effective_hbm_time(
        coaxial_study.DECODE_PLAN["kv_bytes"] / coaxial_study.DECODE_LAYERS,
        spec)
    log(f"engine: decode plan on H100 {card['plan_part']}: "
        f"{card['plan_n_channels']} KV channels -> "
        f"{card['plan_speedup']:.4f}x (step "
        f"{card['plan_step_s'] * 1e3:.4f} ms, one card "
        f"{card['plan_baseline_s'] * 1e3:.4f} ms, {card['plan_dominant']}"
        f"-bound); equal on the card and the CPU")
    log("engine: planner memory term a mistral-large layer at 32k "
        f"(effective_hbm_time(kv_bytes / {coaxial_study.DECODE_LAYERS})): "
        f"{layer_s * 1e3:.5f} ms; K2 at that layer's shape "
        + ("not measured" if plan_k2_ms is None else
           f"{plan_k2_ms:.5f} ms -> planner / K2 "
           f"{layer_s * 1e3 / plan_k2_ms:.4f}"))

    # benchmarks/sweep_grid.py's grid: the baseline + 10 CXL channel counts
    # x 10 premiums; the dense grid crosses it with three more axes.
    designs = [cpu_model.DDR_BASELINE] + [cpu_model.MemSystem(
        f"grid-cxl-{ch}x", dram_channels=ch, links=ch,
        link_rd_gbps=hw.CXL_X8_RD_GBPS, link_wr_gbps=hw.CXL_X8_WR_GBPS,
        iface_lat_ns=hw.CXL_LAT_NS, llc_mb_per_core=1.0)
        for ch in range(1, 11)]
    lats = tuple(float(x) for x in np.linspace(10.0, 100.0, 10))
    grid = coaxial.sweep_spec(design=designs, iface_lat_ns=lats)
    dense = coaxial.sweep_spec(
        design=designs, iface_lat_ns=lats,
        llc_mb_per_core=np.linspace(0.5, 4.0, 8),
        kappa=np.linspace(1.0, 3.2, 8), eta=np.linspace(0.4, 1.0, 16))
    n = int(np.prod(dense.shape))
    engine_grid("default_sweep", lambda: coaxial.default_sweep.__wrapped__(
        "cuda"), 40, cpu_model)
    engine_grid("sweep_grid", lambda: coaxial.solve_spec(grid), 110,
                cpu_model)
    sw, _, _ = engine_grid("dense", lambda: coaxial.solve_spec(dense), n,
                           cpu_model)

    # Where the damped fixed point has not settled in FP_ITERS steps (its
    # last step moves ipc by more than ENGINE_RTOL), its value is a point of
    # a period-2 or chaotic orbit that rounding alone moves: such (cell,
    # workload) elements are counted, and the CPU's value must lie within
    # the span of the card's orbit over steps FP_ITERS - 2 .. FP_ITERS + 2
    # (plus ENGINE_RTOL).  One step's move is not enough: on an H100 one
    # unsettled element of the sample differs from the CPU by 1.22 of it.
    nxt = steps_further(
        cpu_model, 1, lambda: coaxial.solve_spec(dense).results.ipc)
    ipc = sw.results.ipc
    moving = np.abs(nxt - ipc) > ENGINE_RTOL * np.abs(ipc)
    log(f"engine dense: the fixed point has not settled after "
        f"{cpu_model.FP_ITERS} steps in {int(moving.sum())} of {moving.size} "
        f"(cell, workload) elements ({moving.mean():.4f}; "
        f"{int(moving.any(-1).sum())} of {n} cells); its last step moves "
        f"ipc by up to {float(np.max(np.abs(nxt - ipc) / ipc)):.3e}")
    if not (np.isfinite(ipc).all() and (ipc > 0).all()):
        fail("engine dense: ipc not finite and positive everywhere")

    flat = build_flat(dense)
    idx = np.unique(np.linspace(0, n - 1, ENGINE_SAMPLE).round().astype(int))
    pick = lambda d: {k: v[idx] for k, v in d.items()}
    sample = lambda device: cpu_model.solve_cells(
        cpu_model.MemSystemArrays(*(leaf[idx] for leaf in flat["sysa"])),
        n_active=flat["n_active"][idx],
        iface_override_ns=flat["iface_override_ns"][idx],
        design_overrides=pick(flat["design_overrides"]),
        workload_overrides=pick(flat["workload_overrides"]), device=device)
    ref = sample("cpu")
    got = sw.results.reshape(n)[idx]
    unsettled = moving.reshape(n, -1)[idx]
    around = [steps_further(cpu_model, k, lambda: sample("cuda"))
              for k in (-2, -1, 1, 2)]
    orbit = lambda f: [np.where(unsettled, getattr(r, f), getattr(got, f))
                       for r in around]
    worst = max(engine_close(f"dense grid {f.name}", getattr(got, f.name),
                             getattr(ref, f.name), orbit=orbit(f.name))
                for f in dataclasses.fields(ref))
    step = np.abs(nxt.reshape(n, -1)[idx] - got.ipc)[unsettled]
    steps = np.abs(got.ipc - ref.ipc)[unsettled] / step
    log(f"engine: {len(idx)} cells of the dense grid on the CPU equal the "
        f"card's in every ModelResult field (max rel diff {worst:.3e}; rtol "
        f"{ENGINE_RTOL}, and for the {int(unsettled.sum())} unsettled "
        f"elements the span of the card's orbit over steps "
        f"{cpu_model.FP_ITERS - 2}..{cpu_model.FP_ITERS + 2}); the "
        f"unsettled ones differ by up to {float(np.max(steps, initial=0)):.3f}"
        f" of the card's last step")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_card = cpu_model.design_gradient(cpu_model.COAXIAL_4X, device="cuda")
    g_ms = (time.perf_counter() - t0) * 1e3
    g_cpu = cpu_model.design_gradient(cpu_model.COAXIAL_4X, device="cpu")
    worst = max(engine_close(f"design_gradient {k}", g_card[k], g_cpu[k],
                             atol=ENGINE_GRAD_ATOL) for k in g_cpu)
    log(f"engine: design_gradient(coaxial-4x) on the card ({g_ms:.1f} ms) "
        f"equals the CPU's over {list(g_cpu)}: max rel diff {worst:.3e} "
        f"(rtol {ENGINE_RTOL}, atol {ENGINE_GRAD_ATOL}); "
        + ", ".join(f"{k}={v:+.6g}" for k, v in g_card.items()))


def lut_cells(lanes: int):
    """``lanes`` cells of the default QueueLUT grid (its 2,016 cells twice
    over for 4,032; an even spread of it for fewer)."""
    grid = [(r, k, o, e) for r in LUT_RHO for k in LUT_KAPPA
            for o in LUT_OUTSTANDING for e in LUT_ETA] * LUT_REPS
    step = max(1, len(grid) // lanes)
    return grid[::step][:lanes]


def record_window(chunk: int):
    """Phase 2's timestep record window over two chained chunks of
    ``chunk`` steps: from step ``lo`` of the first chunk to step ``hi`` of
    the second.  300 and 517 for long chunks, a third and two thirds in
    for the shorter ones; each inside a stage of the kernels' ring (a
    chunk of 1 records its second step only)."""
    if chunk > 600:
        return 300, 517
    return chunk // 3 + 3, 2 * chunk // 3 + 1


def memsim_scan_inputs(memsim, threefry, lanes, ts_chunk, ev_chunk, harvest,
                       open_loop, seed):
    """Stage A of both engines on the card for ``lanes`` cells of the LUT
    grid, two chained chunks each, of ``ts_chunk`` steps and ``ev_chunk``
    requests (no event chunks if it is None): yields ``(engine, terms,
    chunks)`` with each chunk's scan arguments."""
    cfgs = [memsim.ChannelConfig(
        rho=r, kappa=k, outstanding=float("inf") if open_loop else o, eta=e,
        harvest_duty=0.3 if harvest else 0.0,
        harvest_bw_gbps=20.0 if harvest else 0.0, harvest_sojourn_ns=400.0)
        for r, k, o, e in lut_cells(lanes)]
    c = memsim.stack_channels(cfgs, device="cuda")
    t = memsim._channel_terms(c)
    ids = torch.arange(lanes, device="cuda")
    keys = threefry.split(threefry.prng_key(seed, "cuda"), 3)
    ts = []
    lo, hi = record_window(ts_chunk)
    for k in range(2):
        sw, au, jit_ns, svc = memsim._ts_draws(c, t, ids, keys[k], ts_chunk)
        hu = (memsim._ts_harvest_u(ids, keys[k], ts_chunk) if harvest
              else None)
        ts.append((sw, au, jit_ns, svc, hu, lo if k == 0 else 0,
                   ts_chunk if k == 0 else hi))
    yield "timestep", memsim._ts_terms(c, t), ts
    if ev_chunk is None:
        return
    tabs = memsim._event_tables(c, t, ids, keys[2], 64)
    if harvest:
        htabs = memsim._event_harvest_tabs(c, ids, keys[2], 64)
        h_scale = memsim._harvest_terms(c)["h_scale"]
    state = (torch.zeros(lanes, device="cuda"),
             torch.zeros(lanes, device="cuda"))
    ev = []
    for k in range(2):
        t_prev = state[1]
        state, gaps, svc, rec = memsim._event_arrivals(
            c, t, state, ids, keys[k], tabs, 200, ev_chunk)
        if harvest:
            svc = memsim._event_harvest_scale(svc, gaps, t_prev, htabs,
                                              h_scale)
        ev.append((gaps, svc, rec))
    yield "event", memsim._event_terms(c, t), ev


def scan_error(kernel, plain) -> float:
    """Largest |kernel - plain| over the pairs of carries and histograms
    ``kernel`` and ``plain``."""
    return max(float((k.double() - p.double()).abs().max())
               for k, p in zip(kernel, plain))


def run_scans(ms, ref, engine, terms, chunks):
    """Each chunk of ``chunks`` through the kernel and through its plain
    version, chained from zero carries; returns ``{"kernel": (carry,
    hist), "plain": (carry, hist)}``."""
    n = terms.shape[1]
    out = {}
    for path in ("kernel", "plain"):
        hist = torch.zeros((n, ms.N_BINS), dtype=torch.int32, device="cuda")
        if engine == "timestep":
            carry = torch.stack([torch.zeros(n), torch.ones(n),
                                 torch.zeros(n)]).cuda()
            fn = ms.ts_scan if path == "kernel" else ref.ts_scan_ref
        else:
            carry = torch.zeros(n, device="cuda")
            fn = ms.event_scan if path == "kernel" else ref.event_scan_ref
        for args in chunks:
            fn(terms, carry, *args, hist)
        out[path] = (carry, hist)
    torch.cuda.synchronize()
    return out


# Phase 2's cases for K4/K5: (lanes, timestep chunk, event chunk, harvest,
# open loop).  The default LUT grid's 4,032 lanes and a ragged 37 at the
# canonical chunk, harvest on and off, outstanding finite and infinite;
# the study's own launch shapes (validate_calibration's 384 lanes,
# crosscheck_engines' 512 and the worked example's 128, timestep only, at
# the chunk rules' lengths); a chunk of 1021, not a multiple of the
# kernels' stage of steps.
MEMSIM_SCAN_CASES = (
    [(lanes, 1024, 1024, harvest, open_loop) for lanes in (4032, 37)
     for harvest in (False, True) for open_loop in (False, True)]
    + [(384, 8192, 8192, False, False), (512, 8192, 8192, False, True),
       (128, 8192, None, False, False), (37, 1021, 1021, True, False)])


def ring_cases(depth: int):
    """Phase 2's cases at the edges of the kernels' ring of ``depth``
    steps and of their 32-lane blocks: lanes 1, 31, 32, 33 and 4,032 x
    chunks of 1, depth - 1, depth, depth + 1 and 1,021 steps, harvest and
    outstanding alternating (record windows by ``record_window``)."""
    shapes = [(lanes, chunk) for lanes in (1, 31, 32, 33, 4032)
              for chunk in (1, depth - 1, depth, depth + 1, 1021)]
    return [(lanes, chunk, chunk, i % 2 == 1, (i // 2) % 2 == 1)
            for i, (lanes, chunk) in enumerate(shapes)]


def check_memsim_scans(ms, ref, memsim, threefry, seed):
    """Phase 2 for K4/K5: each against its plain version on the card, bit
    for bit (torch.equal on carries and histograms after two chained
    chunks) over ``MEMSIM_SCAN_CASES`` and ``ring_cases``.  Returns each
    kernel's largest |kernel - plain| over its carries and histograms."""
    err = {"memsim_ts_scan": 0.0, "memsim_event_scan": 0.0}
    cases = MEMSIM_SCAN_CASES + ring_cases(ms.ring_steps())
    recorded = {"memsim_ts_scan": 0, "memsim_event_scan": 0}
    for lanes, ts_chunk, ev_chunk, harvest, open_loop in cases:
        seed += 1
        for engine, terms, chunks in memsim_scan_inputs(
                memsim, threefry, lanes, ts_chunk, ev_chunk, harvest,
                open_loop, seed):
            name = "memsim_ts_scan" if engine == "timestep" else \
                "memsim_event_scan"
            out = run_scans(ms, ref, engine, terms, chunks)
            err[name] = max(err[name], scan_error(out["kernel"],
                                                  out["plain"]))
            if not all(torch.equal(k, p)
                       for k, p in zip(out["kernel"], out["plain"])):
                fail(f"{name} differs from its plain version at {lanes} "
                     f"lanes, chunks of {len(chunks[0][0])}, harvest "
                     f"{harvest}, open loop {open_loop}: max |err| "
                     f"{err[name]}")
            counted = int(out["plain"][1].sum())
            # A lane or two over two short chunks may record nothing; the
            # wide and long cases must.
            if counted == 0 and lanes * ts_chunk >= 4096:
                fail(f"{name} recorded nothing at {lanes} lanes")
            recorded[name] += counted
        lo, hi = record_window(ts_chunk)
        log(f"  memsim_ts_scan / memsim_event_scan, {lanes} lanes, chunks "
            f"of {ts_chunk} / {ev_chunk}, harvest "
            f"{'on' if harvest else 'off'}, outstanding "
            f"{'inf' if open_loop else 'finite'}: 2 chained chunks "
            f"(timestep record window step {lo} to step {hi} of the "
            f"second), carries and histograms equal to plain (torch.equal)")
    log(f"  memsim scans: {len(cases)} cases, {recorded} latencies "
        f"recorded in all")
    return err


def memsim_launches(memsim, runs):
    """Launches of each scan kernel that ``runs`` make by the chunk rules:
    ``runs`` holds (engine, lanes, steps) of each simulation."""
    out = {"memsim_ts_scan": 0, "memsim_event_scan": 0}
    for engine, lanes, steps in runs:
        if engine == "timestep":
            out["memsim_ts_scan"] += -(-steps // memsim._ts_chunk_len(lanes))
        else:
            out["memsim_event_scan"] += -(-memsim.events_for_steps(steps) //
                                          memsim._event_chunk_len(lanes))
    return out


def study_runs(study, steps):
    """(engine, lanes, steps) of each simulation ``memsim_study`` makes."""
    cal = 8 * study.CALIBRATION_REPS
    cc = 8 * study.CROSSCHECK_REPS
    return [("timestep", cal, steps), ("event", cal, steps),
            ("timestep", cc, steps), ("event", cc, steps),
            ("timestep", 4 * study.EXAMPLE_REPS, steps)]


def memsim_close(card: dict, cpu: dict) -> float:
    """Phase 7: every number of the study on the card against the CPU's at
    the histogram gates; returns the largest difference found, as a share
    of its gate."""
    import numpy as np

    from repro_torch.core.memsim import BIN_NS
    p90_floor = min(v for k, v in card.items()
                    if "p90_ns" in k and not isinstance(v, bool))
    worst = 0.0
    for key, want in cpu.items():
        got = card[key]
        if isinstance(want, bool):
            if got != want:
                fail(f"memsim: study {key} {got} on the card, {want} on "
                     f"the CPU")
            continue
        if key.endswith("_ns"):
            tol = (BIN_NS if any(q in key for q in ("p50", "p90", "p99"))
                   else MEMSIM_MEAN_RTOL * abs(want))
        elif "p90" in key:      # a ratio of p90s
            tol = (1.0 + abs(want)) * BIN_NS / p90_floor
        else:                   # a ratio of means or stdevs
            tol = (1.0 + abs(want)) * 2 * MEMSIM_MEAN_RTOL
        diff = abs(got - want)
        if not np.isfinite(got) or diff > tol:
            fail(f"memsim: study {key} {got!r} on the card, {want!r} on the "
                 f"CPU (gate {tol:.3e})")
        worst = max(worst, diff / tol if tol > 0 else 0.0)
    return worst


def memsim_run(label, fn, kernels, expected, lanes):
    """Phase 7 for one timed run: a warm call (its launches counted), then
    ``MEMSIM_REPEATS`` timed ones (host clock, ending in a synchronise, the
    stats on the host), one profiled (device time, kernel launches) and one
    under the peak-memory counter (less what was allocated before it)."""
    for kern in kernels.values():
        kern.launches = 0
    fn()
    counts = {k: v.launches for k, v in kernels.items()}
    if counts != expected:
        fail(f"memsim {label}: scan launches {counts} != {expected}")
    ms_ = []
    for _ in range(MEMSIM_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms_.append((time.perf_counter() - t0) * 1e3)
    dev_ms, rows = profile(fn)
    launches, copies = launch_counts(rows)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    wall = min(ms_)
    busy = "not measured" if dev_ms is None else \
        f"{dev_ms:.3f} ms -> busy share {dev_ms / wall:.3f}"
    log(f"memsim {label} ({lanes} lanes): "
        f"{', '.join(f'{m:.3f}' for m in ms_)} ms a run; scan launches "
        f"{counts}; {launches} kernel launches and "
        f"{copies} copies a run; device time {busy}; "
        f"peak device memory of a run {peak / 2**20:.1f} MiB")
    for dms, key, count in rows[:6]:
        log(f"  {dms:9.3f} ms  x{count:<5d} {key[:80]}")
    return rows


def scan_line(name, ms, ref, args, plain_args, norec_args, steps, lanes,
              peak_bw, peak_f32, launch_rows):
    """One scan kernel at a launch shape of the study: first the kernel and
    its plain version once each on the same inputs from fresh carries and
    histograms, which must be equal (torch.equal); then timed (the kernel
    over many launches, its plain version once, and the kernel with
    nothing to record, whose adds to the histogram are then all of 0).
    Returns the JSON fields and the largest |kernel - plain|."""
    kfn = getattr(ms, name.removeprefix("memsim_"))
    pfn = getattr(ref, name.removeprefix("memsim_") + "_ref")
    carry, hist = args[1], args[-1]
    pair = {}
    for path, fn, inputs in (("kernel", kfn, args), ("plain", pfn, plain_args)):
        c, h = carry.clone(), torch.zeros_like(hist)
        fn(inputs[0], c, *inputs[2:-1], h)
        pair[path] = (c, h)
    torch.cuda.synchronize()
    err = scan_error(pair["kernel"], pair["plain"])
    if not all(torch.equal(k, p) for k, p in zip(pair["kernel"],
                                                 pair["plain"])):
        fail(f"{name} differs from its plain version at the study's shape "
             f"{steps} x {lanes}: max |err| {err}")
    if int(pair["plain"][1].sum()) == 0:
        fail(f"{name} recorded nothing at the study's shape")
    times = {}
    for key, fn, it in (("plain", lambda: pfn(*plain_args), 1),
                        ("kernel", lambda: kfn(*args), 20),
                        ("no record", lambda: kfn(*norec_args), 20),
                        ("kernel", lambda: kfn(*args), 20),
                        ("plain", lambda: pfn(*plain_args), 1)):
        times.setdefault(key, []).append(time_ms(fn, iters=it,
                                                 warmup=min(it, 2)))
    nbytes = ms.scan_bytes(name, steps, lanes)
    # ~15 float32 operations a lane-step (K4: 4 compares and selects of
    # the two chains, the admission test, 2 adds of the latency, the
    # service scale, 3 of the backlog update, the binning); K5: 6.
    flops = (15 if name == "memsim_ts_scan" else 6) * steps * lanes
    # The serial chain: dependent float32 operations a step at ~4 cycles
    # each, at the H100 SXM's 1.98 GHz boost clock (data sheet): a lane's
    # steps cannot go faster, however many lanes run beside it.  The
    # shortest chain the reference's semantics allow is 4 operations for
    # each kernel: K4 (backlog + s_arr) - 1 and (backlog + s_none) - 1 side
    # by side with the admission test, the select, a NaN-keeping max; K5
    # W - gap, then + svc and + 0 side by side with the tests, two
    # selects.  (K5's build runs that 4; K4's runs 6, the admission test,
    # the select of the service as a multiply by 0, two adds, the max as a
    # compare and a select: forming both outcomes first measured slower.)
    t_bytes, t_ops = nbytes / peak_bw, flops / peak_f32
    t_chain = steps * CHAIN_OPS * 4 / 1.98e9
    bound = max(t_bytes, t_ops, t_chain) * 1e3
    by = "bytes" if t_bytes >= max(t_ops, t_chain) else "operations"
    what = ("the serial chain" if t_chain >= max(t_bytes, t_ops) else by)
    dev = [(d, c) for d, key, c in launch_rows if "scan_kernel" in key
           and ("ts_scan" in key) == (name == "memsim_ts_scan")]
    dev_txt = "not measured" if not dev else \
        f"{dev[0][0] / dev[0][1]:.5f} ms a launch (x{dev[0][1]})"
    ms_k = min(times["kernel"])
    log(f"{name} {steps} steps x {lanes} lanes: equal to plain "
        f"(torch.equal) on the same inputs; kernel {times['kernel']} ms "
        f"by events (in the timed run, profiler: {dev_txt}), with nothing "
        f"recorded {times['no record']} ms, plain {times['plain']} ms; "
        f"bound {bound:.5f} ms by {what} (bytes {t_bytes * 1e3:.5f} ms for "
        f"{nbytes} B, FLOPs {t_ops * 1e3:.5f} ms for {flops}, the serial "
        f"chain of {CHAIN_OPS} dependent float32 operations a step "
        f"{t_chain * 1e3:.5f} ms) -> {bound / ms_k:.3f} of it")
    return {"ms": ms_k, "plain_ms": min(times["plain"]), "bound_ms": bound,
            "bound_by": by}, err


def memsim_phase(scan_err=None):
    """Phase 7: the memory-system DES on the card, against the CPU; returns
    the kernel JSON entries of the two scan kernels.  ``scan_err`` holds
    each scan kernel's largest |kernel - plain| from phase 2."""
    from repro_torch.core import coaxial, hw, memsim, threefry
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import memsim_scan as ms
    from repro_torch.launch import memsim_study as study

    kernels = ms.KERNELS
    build.load_all([ms.LIBRARY])
    spec = hw.spec_for(torch.cuda.get_device_name(0))
    # The main path: the study on the card at its full budget.
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    card = study.main(["--steps", str(MEMSIM_STEPS)])
    torch.cuda.synchronize()
    study_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.items()}
    runs = study_runs(study, MEMSIM_STEPS)
    expected = memsim_launches(memsim, runs)
    each = ", ".join(
        f"{e} at {n} lanes {sum(memsim_launches(memsim, [(e, n, st)]).values())}"
        for e, n, st in runs)
    log(f"memsim_study on the card ({MEMSIM_STEPS} steps, {study_s:.1f} s, "
        f"first run): scan launches {launches} (expected {expected} by the "
        f"chunk rules: {each})")
    if launches != expected:
        fail(f"memsim_study: scan launches {launches} != {expected}")
    if not card["timestep_calibration_ok"]:
        fail("memsim_study: the timestep engine's validate_calibration is "
             "not ok on the card at its gate settings")
    log(f"memsim: timestep validate_calibration ok (max |err| mean "
        f"{card['timestep_max_abs_mean_err']:.4f}, p90 "
        f"{card['timestep_max_abs_p90_err']:.4f}, stdev "
        f"{card['timestep_max_abs_stdev_err']:.4f}); event engine "
        f"(printed, not gated: the reference itself misses its p90 gate): "
        f"mean {card['event_max_abs_mean_err']:.4f}, p90 "
        f"{card['event_max_abs_p90_err']:.4f}, stdev "
        f"{card['event_max_abs_stdev_err']:.4f}, ok "
        f"{card['event_calibration_ok']}")

    # Card against CPU, both at the comparison budget.
    log(f"memsim: card vs CPU at {MEMSIM_CHECK_STEPS} steps, cut from "
        f"{MEMSIM_STEPS} to keep the CPU side near 100 s")
    t0 = time.perf_counter()
    cpu = study.main(["--device", "cpu", "--steps", str(MEMSIM_CHECK_STEPS)])
    cpu_s = time.perf_counter() - t0
    card_cut = study.main(["--steps", str(MEMSIM_CHECK_STEPS)])
    worst = memsim_close(card_cut, cpu)
    equal = sum(card_cut[k] == v for k, v in cpu.items())
    log(f"memsim: the study on the card equals its CPU run ({cpu_s:.1f} s "
        f"on the CPU): {len(cpu)} numbers, {equal} identical, largest "
        f"difference {worst:.3e} of its gate")

    # The three timed runs.
    calib = [(e, 8 * study.CALIBRATION_REPS, MEMSIM_STEPS)
             for e in memsim.ENGINES]
    rows_cal = memsim_run(
        "validate_calibration, both engines",
        lambda: [coaxial.validate_calibration(
            steps=MEMSIM_STEPS, seed=study.CALIBRATION_SEED,
            reps=study.CALIBRATION_REPS, engine=e) for e in memsim.ENGINES],
        kernels, memsim_launches(memsim, calib), 8 * study.CALIBRATION_REPS)
    cross = [(e, 8 * study.CROSSCHECK_REPS, MEMSIM_STEPS)
             for e in memsim.ENGINES]
    memsim_run("crosscheck_engines",
               lambda: coaxial.crosscheck_engines(
                   steps=MEMSIM_STEPS, seed=study.CROSSCHECK_SEED,
                   reps=study.CROSSCHECK_REPS),
               kernels, memsim_launches(memsim, cross),
               8 * study.CROSSCHECK_REPS)
    lut_lanes = len(lut_cells(4032))
    chunk = memsim.canonical_chunk("event")
    lut_expected = {"memsim_ts_scan": 0, "memsim_event_scan": -(
        -memsim.events_for_steps(LUT_STEPS) // chunk)}
    rows_lut = memsim_run(
        "default QueueLUT grid, event engine",
        lambda: coaxial.distribution_sweep(
            rho=LUT_RHO, kappa=LUT_KAPPA, outstanding=LUT_OUTSTANDING,
            eta=LUT_ETA, steps=LUT_STEPS, reps=LUT_REPS, engine="event",
            chunk=chunk),
        kernels, lut_expected, lut_lanes)

    # The scan kernels at the study's shape: validate_calibration's 384
    # lanes, 8192 steps a chunk (both engines' chunk at that width).
    lanes = 8 * study.CALIBRATION_REPS
    cfgs = [memsim.ChannelConfig(rho=r) for r in coaxial.CALIBRATION_RHOS]
    c = memsim.stack_channels(cfgs * study.CALIBRATION_REPS, device="cuda")
    t = memsim._channel_terms(c)
    ids = torch.arange(lanes, device="cuda")
    key = threefry.split(threefry.prng_key(0, "cuda"), 2)[1]
    steps = memsim._ts_chunk_len(lanes)
    draws = memsim._ts_draws(c, t, ids, key, steps)
    terms = memsim._ts_terms(c, t)
    carry = torch.stack([torch.zeros(lanes), torch.ones(lanes),
                         torch.zeros(lanes)]).cuda()
    hist = torch.zeros((lanes, ms.N_BINS), dtype=torch.int32, device="cuda")
    args = (terms, carry, *draws, None, 0, steps, hist)
    plain = (terms, carry.clone(), *draws, None, 0, steps, hist.clone())
    norec = (terms, carry.clone(), *draws, None, 0, 0, hist.clone())
    err = dict(scan_err or {})
    fields, e = scan_line("memsim_ts_scan", ms, ref, args, plain, norec,
                          steps, lanes, spec.hbm_bw, spec.peak_fp32_flops,
                          rows_cal)
    entries = [{
        "name": "memsim_ts_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/memsim_scan.cu",
        "replaces": "src/repro/core/memsim.py:639",
        "launches": launches["memsim_ts_scan"],
        "max_abs_err": max(err.get("memsim_ts_scan", 0.0), e),
        **fields, "library_ms": None}]
    ev_steps = memsim._event_chunk_len(lanes)
    tabs = memsim._event_tables(c, t, ids, key, 64)
    _, gaps, svc, rec = memsim._event_arrivals(
        c, t, (torch.zeros(lanes, device="cuda"),
               torch.zeros(lanes, device="cuda")), ids, key, tabs, 0, ev_steps)
    ev_terms = memsim._event_terms(c, t)
    W = torch.zeros(lanes, device="cuda")
    args = (ev_terms, W, gaps, svc, rec, hist)
    plain = (ev_terms, W.clone(), gaps, svc, rec, hist.clone())
    norec = (ev_terms, W.clone(), gaps, svc, torch.zeros_like(rec),
             hist.clone())
    fields, e = scan_line("memsim_event_scan", ms, ref, args, plain, norec,
                          ev_steps, lanes, spec.hbm_bw, spec.peak_fp32_flops,
                          rows_cal)
    entries.append({
        "name": "memsim_event_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/memsim_scan.cu",
        "replaces": "src/repro/core/memsim.py:887",
        "launches": launches["memsim_event_scan"],
        "max_abs_err": max(err.get("memsim_event_scan", 0.0), e),
        **fields, "library_ms": None})
    dev = [(d, n) for d, key, n in rows_lut if "event_scan_kernel" in key]
    if dev:
        log(f"memsim_event_scan at the LUT grid's shape ({chunk} requests x "
            f"{lut_lanes} lanes): {dev[0][0] / dev[0][1]:.5f} ms a launch "
            f"(profiler, x{dev[0][1]}); bound "
            f"{ms.scan_bytes('memsim_event_scan', chunk, lut_lanes) / spec.hbm_bw * 1e3:.5f}"
            f" ms by bytes")
    return entries


def lut_store_entries(lutstore, harvest):
    """The store's entries of the default (``harvest`` False) or the
    harvest surface."""
    return [e for e in lutstore.entries()
            if bool(e.get("harvest")) == harvest]


def lut_build(label, run, harvest, kernels, expected, lutstore, queuelut):
    """Phase 8 for one surface: ``run`` (the CLI's prebuild) from cold
    (the surface's store entry deleted, the in-process layer emptied),
    with every scan count set to 0 just before and read just after, which
    must be ``expected``, timed by the host clock.  Then the surface alone
    (``default_queue_lut``: the harvest surface without the CLI's warm
    read of the default one), each from cold: ``LUT_COLD_REPEATS`` builds
    timed by the host clock, one under the profiler (device time,
    launches) and one under the peak-memory counter.  Each rebuild must
    equal the first bit for bit.  Returns the surface, the host ms of the
    CLI's build and of each timed build alone, the device ms and the peak
    bytes."""
    def cold():
        lutstore.clear_lut_cache()
        for e in lut_store_entries(lutstore, harvest):
            Path(e["path"]).unlink()

    def surface():
        return queuelut.default_queue_lut(harvest=harvest, device="cuda")

    def timed(fn):
        cold()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    for kern in kernels.values():
        kern.launches = 0
    cli_ms, _ = timed(run)
    counts = {k: v.launches for k, v in kernels.items()}
    if counts != expected:
        fail(f"lut {label}: scan launches {counts} != {expected}")
    lut = surface()
    if len(lut_store_entries(lutstore, harvest)) != 1:
        fail(f"lut {label}: the build did not land in the store")
    host_ms, rebuilt = [], []
    for _ in range(LUT_COLD_REPEATS):
        ms_, got = timed(surface)
        host_ms.append(ms_)
        rebuilt.append(got)
    cold()
    dev_ms, rows = profile(lambda: rebuilt.append(surface()))
    launches, copies = launch_counts(rows)
    cold()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rebuilt.append(surface())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    for other in rebuilt:
        if not all(torch.equal(a, b) for a, b in zip(lut, other)
                   if a is not None):
            fail(f"lut {label}: a rebuild differs from the first build")
    wall = sorted(host_ms)[len(host_ms) // 2]
    busy = "not measured" if dev_ms is None else \
        f"{dev_ms:.3f} ms -> busy share {dev_ms / wall:.3f}"
    log(f"lut {label}: counted cold build through the CLI {cli_ms:.3f} ms, "
        f"scan launches {counts}; cold builds of the surface alone "
        f"{', '.join(f'{t:.3f}' for t in host_ms)} ms (host clock, median "
        f"{wall:.3f}); {launches} kernel launches and {copies} copies a "
        f"build; device time {busy}; peak device memory of a build "
        f"{peak / 2**20:.1f} MiB; tables {tuple(lut.wait_ns.shape)}, rebuilt "
        f"{len(rebuilt)} times bit for bit")
    for dms, key, count in rows[:4]:
        log(f"  {dms:9.3f} ms  x{count:<5d} {key[:80]}")
    return lut, cli_ms, wall, dev_ms, peak


def lut_phase():
    """Phase 8: the QueueLUT (``core/queuelut`` + ``core/lutstore``) and
    the fixed point's memsim backend on the card, against the CPU."""
    import os
    import tempfile

    import numpy as np

    from repro_torch import lut as lut_cli
    from repro_torch.core import (coaxial, cpu_model, hw, lutstore, memsim,
                                  queuelut)
    from repro_torch.kernels import build
    from repro_torch.kernels import memsim_scan as ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 8 on {smi}")
    kernels = ms.KERNELS
    build.load_all([ms.LIBRARY])
    # One K5 launch per canonical chunk of the event budget, whatever the
    # lanes: the harvest surface (x 4 duties) runs as many chunks.
    chunks = -(-memsim.events_for_steps(queuelut.DEFAULT_STEPS)
               // memsim.canonical_chunk(queuelut.DEFAULT_ENGINE))
    expected = {"memsim_ts_scan": 0, "memsim_event_scan": chunks}
    saved = os.environ.get(lutstore.ENV_VAR)
    with tempfile.TemporaryDirectory() as store:
        os.environ[lutstore.ENV_VAR] = store
        try:
            lutstore.clear_lut_cache()
            # (a) the default and the harvest surface, cold, through the CLI.
            lut, d_cli, d_ms, d_dev, d_peak = lut_build(
                "default surface (14 x 6 x 6 x 4 x 2 reps = 4,032 lanes)",
                lambda: lut_cli.main(["prebuild"]), False, kernels,
                expected, lutstore, queuelut)
            hlut, h_cli, h_ms, h_dev, h_peak = lut_build(
                "harvest surface (x 4 duties = 16,128 lanes)",
                lambda: lut_cli.main(["prebuild", "--harvest"]), True,
                kernels, expected, lutstore, queuelut)
            # (b) warm store reads: no DES, the cold build's bits.
            warm = {}
            for harvest, want in ((False, lut), (True, hlut)):
                times = []
                for _ in range(LUT_WARM_READS):
                    lutstore.clear_lut_cache()
                    for kern in kernels.values():
                        kern.launches = 0
                    calls = memsim.sim_call_count()
                    t0 = time.perf_counter()
                    got = queuelut.default_queue_lut(harvest=harvest,
                                                     device="cuda")
                    times.append((time.perf_counter() - t0) * 1e3)
                    if memsim.sim_call_count() != calls or any(
                            k.launches for k in kernels.values()):
                        fail("lut: a warm store read ran the DES")
                    if not all(torch.equal(a, b) for a, b in zip(want, got)
                               if a is not None):
                        fail("lut: a warm store read differs from the "
                             "cold build")
                warm[harvest] = times
            log(f"lut warm store reads ({LUT_WARM_READS} each, host clock): "
                f"default {', '.join(f'{t:.3f}' for t in warm[False])} ms; "
                f"harvest {', '.join(f'{t:.3f}' for t in warm[True])} ms; "
                f"0 scan launches, 0 DES runs, tables equal to the cold "
                f"builds (torch.equal)")
            # Leave the default surface in the in-process layer too (a warm
            # read): phase 9's designer starts from it.
            queuelut.default_queue_lut(device="cuda")
        finally:
            if saved is None:
                os.environ.pop(lutstore.ENV_VAR, None)
            else:
                os.environ[lutstore.ENV_VAR] = saved

    # (c) sub-grids on the CPU, at the same budget: equal to the card's
    # cells bit for bit (card = CPU, and a cell independent of its batch:
    # the harvest surface's cells ran in its 16,128-lane launches).
    grids = (("rho", LUT_RHO), ("kappa", LUT_KAPPA),
             ("outstanding", LUT_OUTSTANDING), ("eta", LUT_ETA),
             ("harvest", queuelut.DEFAULT_HARVEST_GRID))
    cpu_s = {}
    for label, surf, harvest in (("default", lut, None),
                                 ("harvest", hlut, LUT_CPU_HARVEST)):
        t0 = time.perf_counter()
        sub = queuelut.build_queue_lut(**LUT_CPU_GRID, harvest=harvest,
                                       steps=LUT_STEPS, reps=LUT_REPS,
                                       device="cpu")
        cpu_s[label] = time.perf_counter() - t0
        want = dict(LUT_CPU_GRID, harvest=harvest)
        pos = [[list(g).index(v) for v in want[name]] for name, g in grids
               if want[name] is not None]
        cells = tuple(torch.as_tensor(ix) for ix in np.ix_(*pos))
        for f in ("wait_ns", "p90_wait_ns", "p99_wait_ns", "sigma_ns"):
            if not torch.equal(getattr(sub, f), getattr(surf, f)[cells]):
                fail(f"lut: the CPU's {label} sub-grid {f} differs from "
                     f"the card's cells")
    n_sub = int(np.prod([len(v) for v in LUT_CPU_GRID.values()]))
    log(f"lut: {n_sub} cells (default, {cpu_s['default']:.1f} s) and "
        f"{n_sub} x {len(LUT_CPU_HARVEST)} duties {LUT_CPU_HARVEST} "
        f"(harvest, {cpu_s['harvest']:.1f} s), x {LUT_REPS} reps, built on "
        f"the CPU at {LUT_STEPS} steps, equal the card's cells of the "
        f"default and the harvest surface bit for bit, all four tables "
        f"(torch.equal)")

    # (d) the memsim-backed solve: card against CPU, timed as phase 6.
    solve = lambda device: coaxial.default_sweep(device, queue_model="memsim",
                                                 lut=lut)
    card, launches, solve_ms = engine_grid(
        "default_sweep, memsim backend", lambda: solve("cuda"), 40,
        cpu_model)
    cpu = solve("cpu")
    nxt = steps_further(cpu_model, 1, lambda: solve("cuda").results.ipc)
    ipc = card.results.ipc
    moving = np.abs(nxt - ipc) > ENGINE_RTOL * np.abs(ipc)
    around = [steps_further(cpu_model, k, lambda: solve("cuda").results)
              for k in (-2, -1, 1, 2)]
    worst = 0.0
    for f in dataclasses.fields(cpu.results):
        orbit = [np.where(moving, getattr(r, f.name),
                          getattr(card.results, f.name)) for r in around]
        worst = max(worst, engine_close(
            f"memsim default_sweep {f.name}", getattr(card.results, f.name),
            getattr(cpu.results, f.name), orbit=orbit))
    if not (np.isfinite(card.results.latency_p99_ns).all()
            and np.isfinite(card.results.cpi_mem_p99).all()):
        fail("lut: memsim p99 outputs not finite")
    log(f"lut: memsim default_sweep on the card equals the CPU's in every "
        f"ModelResult field (max rel diff {worst:.3e}; rtol {ENGINE_RTOL}; "
        f"{int(moving.sum())} of {moving.size} elements unsettled after "
        f"{cpu_model.FP_ITERS} steps, held within the card's orbit)")
    key = lambda p: (p["design"], p["iface_lat_ns"], p["n_active"])
    for cost in ("rel_area", "rel_pins"):
        fc, fp = card.pareto(cost=cost, tail=True), cpu.pareto(cost=cost,
                                                               tail=True)
        if [key(p) for p in fc] != [key(p) for p in fp]:
            fail(f"lut: pareto(tail=True, cost={cost}) differs: card "
                 f"{[key(p) for p in fc]}, CPU {[key(p) for p in fp]}")
        engine_close(f"tail frontier {cost}",
                     [[p["geomean_speedup"], p["latency_p99_ns"]] for p in fc],
                     [[p["geomean_speedup"], p["latency_p99_ns"]] for p in fp])
    log(f"lut: pareto(tail=True) on the card equals the CPU's: "
        f"{[key(p) for p in fc]} (by rel_pins)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_card = cpu_model.design_gradient(cpu_model.COAXIAL_4X,
                                       queue_model="memsim", device="cuda")
    g_ms = (time.perf_counter() - t0) * 1e3
    g_cpu = cpu_model.design_gradient(cpu_model.COAXIAL_4X,
                                      queue_model="memsim", device="cpu")
    worst = max(engine_close(f"memsim design_gradient {k}", g_card[k],
                             g_cpu[k], atol=ENGINE_GRAD_ATOL) for k in g_cpu)
    log(f"lut: design_gradient(coaxial-4x, memsim, the default harvest "
        f"surface) on the card ({g_ms:.1f} ms) equals the CPU's: max rel "
        f"diff {worst:.3e}; "
        + ", ".join(f"{k}={v:+.6g}" for k, v in g_card.items()))
    cf = coaxial.default_sweep("cuda")
    rows = []
    for label, sys, lat in (("4x", cpu_model.COAXIAL_4X, None),
                            ("2x", cpu_model.COAXIAL_2X, None),
                            ("asym", cpu_model.COAXIAL_ASYM, None),
                            ("50 ns", cpu_model.COAXIAL_4X,
                             hw.CXL_LAT_PESSIMISTIC_NS)):
        kw = {} if lat is None else {"iface_lat": lat}
        m = card.comparison(sys, **kw).geomean_speedup
        c = cf.comparison(sys, **kw).geomean_speedup
        rows.append(f"{label} {m:.4f} vs {c:.4f} ({m / c - 1.0:+.1%})")
    log(f"lut: geomean speedup, memsim vs closed form (the reference's "
        f"drift experiment): {'; '.join(rows)}")
    cf_launches, _ = launch_counts(profile(
        lambda: coaxial.default_sweep.__wrapped__("cuda"))[1])
    med = lambda xs: sorted(xs)[len(xs) // 2]
    not_measured = lambda x: "not measured" if x is None else f"{x:.3f}"
    log(f"lut summary on {smi}: default build {d_ms:.3f} ms host (median "
        f"of {LUT_COLD_REPEATS}; {d_cli:.3f} through the CLI), "
        f"{not_measured(d_dev)} ms device, peak {d_peak / 2**20:.1f} MiB; "
        f"harvest build {h_ms:.3f} ms host ({h_cli:.3f} through the CLI, "
        f"with its warm read of the default surface), "
        f"{not_measured(h_dev)} ms device, peak {h_peak / 2**20:.1f} MiB; "
        f"warm read {med(warm[False]):.3f} / {med(warm[True]):.3f} ms "
        f"(median); memsim default_sweep {solve_ms:.3f} ms a solve, "
        f"{launches} launches a solve ({launches / cf_launches:.2f} x) "
        f"against the closed form's {cf_launches}")


def run_cli(main, argv):
    """``main(argv)`` with its standard output captured and echoed;
    returns the exit code and the text."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    return rc, text


def host_ms(fn):
    """Host-clock ms of one call of ``fn`` ending in a synchronise, and
    its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def scan_launches(kernels):
    return {k: v.launches for k, v in kernels.items()}


def zero_launches(kernels):
    for kern in kernels.values():
        kern.launches = 0


def event_chunks(memsim, steps, lanes, chunk=None):
    """K5 launches of one event-engine run: one a chunk of the request
    budget, the chunk the engine's rule for ``lanes`` (or ``chunk``)."""
    chunk = memsim._event_chunk_len(lanes) if chunk is None else chunk
    return -(-memsim.events_for_steps(steps) // chunk)


def vg_close(what, card, cpu):
    """Phase 9: a value-and-grad ``((value, aux), grad)`` of the card held
    to the CPU's at ENGINE_RTOL (gradients also at ENGINE_GRAD_ATOL)."""
    (cv, ca), cg = card
    (pv, pa), pg = cpu
    worst = engine_close(f"{what} value", float(cv), float(pv))
    for k in pa:
        worst = max(worst, engine_close(f"{what} {k}", float(ca[k]),
                                        float(pa[k])))
    for k in pg:
        worst = max(worst, engine_close(f"{what} d/d{k}", float(cg[k]),
                                        float(pg[k]),
                                        atol=ENGINE_GRAD_ATOL))
    return worst


def serving_phase():
    """Phase 9: the gradient designer (``core/designer`` through
    ``python -m repro_torch.designer``) and the serving capacity planner
    (``serving`` through ``python -m repro_torch.serving.plan``) on the
    card, against the CPU; then ``queuelut.headline_metrics``."""
    import dataclasses as dc

    import numpy as np

    from repro_torch import designer as design_cli
    from repro_torch.core import designer, memsim, queuelut
    from repro_torch.core.workloads import WORKLOADS
    from repro_torch.kernels import build
    from repro_torch.kernels import memsim_scan as ms
    from repro_torch.serving import capacity, plan as plan_cli, traffic
    from repro_torch.serving.demand import llm_workload

    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 9 on {smi}")
    kernels = ms.KERNELS
    build.load_all([ms.LIBRARY])

    # (a) the designer.  The default surface: phase 8 leaves it in the
    # in-process store (a warm read); alone, this phase builds it here.
    steps = int(DESIGN_ARGV[DESIGN_ARGV.index("--steps") + 1])
    zero_launches(kernels)
    lut = queuelut.default_queue_lut(steps=steps, device="cuda")
    log(f"designer: default surface read with scan launches "
        f"{scan_launches(kernels)} "
        f"({'warm' if not any(scan_launches(kernels).values()) else 'built'})")
    verify_k5 = event_chunks(memsim, steps, 1)
    expected = {"memsim_ts_scan": 0, "memsim_event_scan": verify_k5}
    zero_launches(kernels)
    cli_ms, (rc, text) = host_ms(lambda: run_cli(
        design_cli.main, DESIGN_ARGV + ["--device", "cuda"]))
    counts = scan_launches(kernels)
    if counts != expected:
        fail(f"designer: scan launches {counts} != {expected} (the warm "
             f"surface, then one verification run of 1 lane x {steps} "
             f"steps)")
    line = [ln for ln in text.splitlines() if ln.startswith("DESIGN ")]
    if len(line) != 1 or rc != (0 if line[0].startswith("DESIGN OK")
                                else 1):
        fail(f"designer CLI: exit {rc} with {line}")
    kw = dict(area_budget=1.2, slo_ms=500.0, arch="stablelm-1.6b",
              batch=32, context=2048, iters=40, steps=steps,
              engine="event", lut=lut)
    opt_ms = []
    for _ in range(SERVING_REPEATS):
        t, card = host_ms(lambda: designer.optimize_design(**kw,
                                                           device="cuda"))
        opt_ms.append(t)
    if card.summary() not in text:
        fail("designer: optimize_design on the card differs from its CLI run")
    t0 = time.perf_counter()
    cpu = designer.optimize_design(**kw, device="cpu")
    cpu_s = time.perf_counter() - t0
    if (dc.asdict(card.start), card.iters, card.converged) != (
            dc.asdict(cpu.start), cpu.iters, cpu.converged):
        fail(f"designer: card start/iters/converged "
             f"{card.start.name} {card.iters} {card.converged} != CPU "
             f"{cpu.start.name} {cpu.iters} {cpu.converged}")
    if [p["design"] for p in card.frontier] != \
            [p["design"] for p in cpu.frontier]:
        fail("designer: the tail frontier differs between card and CPU")
    worst_field = 0.0
    for f, a, b in [(f, float(getattr(card.design, f)),
                     float(getattr(cpu.design, f)))
                    for f in ("dram_channels", "links", "llc_mb_per_core",
                              "rel_area", "rel_pins")] + [
            (f, getattr(card, f), getattr(cpu, f))
            for f in ("gm_speedup", "token_p99_ms", "latency_p99_ns")]:
        rel = abs(a - b) / abs(b)
        worst_field = max(worst_field, rel)
        if rel > DESIGN_RTOL:
            fail(f"designer: {f} card {a!r} vs CPU {b!r} (rel {rel:.3e} > "
                 f"{DESIGN_RTOL})")
    if (card.meets_budget, card.meets_slo, card.verify["ok"]) != (
            cpu.meets_budget, cpu.meets_slo, cpu.verify["ok"]):
        fail("designer: the verdicts differ between card and CPU")
    # The objective at fixed points: the knee and the card's optimum.
    wls = tuple(WORKLOADS) + (llm_workload("stablelm-1.6b", batch=32,
                                           context=2048),)
    obj = {dev: designer.ascent_objective(
        card.start, wls, lut, arch="stablelm-1.6b", batch=32, context=2048,
        slo_ms=500.0, device=dev) for dev in ("cuda", "cpu")}
    knee = {"dram_channels": float(card.start.dram_channels),
            "llc_mb_per_core": float(card.start.llc_mb_per_core)}
    opt = {"dram_channels": float(card.design.dram_channels),
           "llc_mb_per_core": float(card.design.llc_mb_per_core)}
    worst_vg = max(vg_close(f"value_and_grad at the {label}",
                            obj["cuda"](x), obj["cpu"](x))
                   for label, x in (("knee", knee), ("optimum", opt)))
    vg_ms = [host_ms(lambda: obj["cuda"](knee))[0] for _ in range(3)]
    vg_dev, rows = profile(lambda: obj["cuda"](knee))
    vg_launches, vg_copies = launch_counts(rows)
    vg_wall = sorted(vg_ms)[1]
    vg_busy = "not measured" if vg_dev is None else \
        f"{vg_dev:.3f} ms -> busy share {vg_dev / vg_wall:.3f}"
    # The verification DES at the card's operating point: the CPU's equal.
    v = card.verify
    vargs = dict(rho=v["rho"], kappa=v["kappa"], eta=v["eta"],
                 outstanding=v["outstanding"], premium_ns=v["premium_ns"],
                 model_p99_ns=v["model_p99_ns"], steps=v["steps"], seed=0,
                 harvest_duty=v["harvest_duty"],
                 harvest_bw_gbps=v["harvest_bw_gbps"])
    zero_launches(kernels)
    ver_ms, ver_card = host_ms(lambda: designer._verify_optimum(
        **vargs, device="cuda"))
    if scan_launches(kernels) != expected:
        fail(f"designer: the verification run launched "
             f"{scan_launches(kernels)} != {expected}")
    ver_cpu = designer._verify_optimum(**vargs, device="cpu")
    if not (ver_card == v == ver_cpu):
        fail(f"designer: verification DES card {ver_card['des_p99_ns']} / "
             f"optimize {v['des_p99_ns']} / CPU {ver_cpu['des_p99_ns']} "
             f"differ")
    if abs(card.verify["des_p99_ns"] - cpu.verify["des_p99_ns"]) > 4.0:
        fail("designer: the two runs' verification p99s are more than one "
             "4-ns bin apart")
    log(f"designer on the card equals the CPU: start {card.start.name} "
        f"(ch {card.start.dram_channels:g}, llc "
        f"{card.start.llc_mb_per_core:g} MB), {card.iters} iterations, "
        f"converged {card.converged}; fields, gm and token p99 within "
        f"{worst_field:.3e} (rtol {DESIGN_RTOL}); value_and_grad at the knee "
        f"and the optimum within {worst_vg:.3e} (rtol {ENGINE_RTOL}); "
        f"verification DES p99 {ver_card['des_p99_ns']:g} ns on both "
        f"(card run {card.verify['des_p99_ns']:g}, CPU run "
        f"{cpu.verify['des_p99_ns']:g}); CPU optimize {cpu_s:.1f} s")
    log(f"designer timing on {smi}: CLI run (counted) {cli_ms:.1f} ms; "
        f"optimize warm {', '.join(f'{t:.1f}' for t in opt_ms)} ms "
        f"({card.iters} value-and-grads); one value-and-grad "
        f"{', '.join(f'{t:.1f}' for t in vg_ms)} ms host, {vg_launches} "
        f"kernel launches and {vg_copies} copies, device time {vg_busy}; "
        f"verification run {ver_ms:.1f} ms host, {verify_k5} "
        f"memsim_event_scan launches (1 lane x {steps} steps)")
    for dms, key, count in rows[:4]:
        log(f"  {dms:9.3f} ms  x{count:<5d} {key[:80]}")

    # (b) the capacity planner.  Every DES run is captured (configs and
    # stats) to hold the card's cells to the CPU's.
    args = plan_cli.build_parser().parse_args(PLAN_ARGV)
    trace = traffic.get_trace(args.trace)
    designs = capacity.candidate_designs(
        channels=tuple(args.channels), llc_mb=tuple(args.llc_mb),
        premium_ns=tuple(args.premium_ns))
    cells = len(trace.epochs) * sum(
        len(v.lanes) for v in capacity._variants(designs,
                                                 tuple(args.tier_splits)))
    psteps = capacity.default_steps()
    plan_k5 = event_chunks(memsim, psteps, cells)
    expected = {"memsim_ts_scan": 0, "memsim_event_scan": plan_k5}
    runs = []
    simulate = memsim.simulate

    def captured(configs, *a, **k):
        stats = simulate(configs, *a, **k)
        runs.append((list(configs), stats))
        return stats

    memsim.simulate = captured
    try:
        zero_launches(kernels)
        plan_ms, (rc, text) = host_ms(lambda: run_cli(
            plan_cli.main, PLAN_ARGV + ["--device", "cuda"]))
        if scan_launches(kernels) != expected:
            fail(f"plan: scan launches {scan_launches(kernels)} != "
                 f"{expected} ({cells} cells x {psteps} steps)")
        rc_cpu, text_cpu = run_cli(plan_cli.main,
                                   PLAN_ARGV + ["--device", "cpu"])
    finally:
        memsim.simulate = simulate
    (cfg, card_stats), (cfg_cpu, cpu_stats) = runs
    if len(cfg) != cells or cfg != cfg_cpu:
        fail(f"plan: {len(cfg)} DES cells, expected {cells}, or the CPU "
             f"ran others")
    for f in ("hist", "mean_ns", "p90_ns", "p99_ns", "stdev_ns"):
        if not np.array_equal(getattr(card_stats, f), getattr(cpu_stats, f)):
            fail(f"plan: the card's DES {f} differs from the CPU's")
    if rc != rc_cpu:
        fail(f"plan CLI: exit {rc} on the card, {rc_cpu} on the CPU")
    sample = cfg[::PLAN_SAMPLE_STRIDE]
    s_card = memsim.simulate(sample, steps=psteps, engine="event",
                             device="cuda")
    s_cpu = memsim.simulate(sample, steps=psteps, engine="event",
                            device="cpu")
    if not np.array_equal(s_card.hist, s_cpu.hist):
        fail(f"plan: the {len(sample)}-cell sample's histograms differ")
    kwargs = dict(slo_p99_ms=args.slo_p99_ms, batch=args.batch,
                  context=args.context, tokens_per_req=args.tokens_per_req,
                  channels=tuple(args.channels), llc_mb=tuple(args.llc_mb),
                  premium_ns=tuple(args.premium_ns),
                  tier_splits=tuple(args.tier_splits),
                  peak_util=args.peak_util, steps=psteps, engine="event")

    def plans(source, lut=None):
        """The plan on the card (SERVING_REPEATS timed runs) and on the
        CPU, held together: the same verdicts and pick, access p99 bit
        for bit (des) or within ENGINE_RTOL (lut), token p99s within
        ENGINE_RTOL."""
        archs = tuple(args.arch)
        t = []
        for _ in range(SERVING_REPEATS):
            ms_, got = host_ms(lambda: capacity.plan_capacity(
                archs, trace, **kwargs, p99_source=source, lut=lut,
                device="cuda"))
            t.append(ms_)
        want = capacity.plan_capacity(archs, trace, **kwargs,
                                      p99_source=source, lut=lut,
                                      device="cpu")
        key = lambda p: [(v.name, v.rel_area, v.rel_pins, v.peak_rho,
                          v.meets_slo) for v in p.verdicts]
        if key(got) != key(want):
            fail(f"plan {source}: the verdicts differ between card and CPU")
        pick = lambda p: (None if p.best is None else p.best.name,
                          p.closest.name)
        if pick(got) != pick(want):
            fail(f"plan {source}: pick {pick(got)} != CPU {pick(want)}")
        acc = [v.access_p99_ns for v in got.verdicts]
        acc_cpu = [v.access_p99_ns for v in want.verdicts]
        if source == "des" and acc != acc_cpu:
            fail("plan des: access p99s differ between card and CPU")
        worst = max(engine_close(f"plan {source} access p99", acc, acc_cpu),
                    engine_close(f"plan {source} token p99",
                                 [v.token_p99_ms for v in got.verdicts],
                                 [v.token_p99_ms for v in want.verdicts]))
        return got, t, worst, pick(got)

    des, des_ms, des_worst, des_pick = plans("des")
    # The LUT source reads the default surface at the plan's budget: built
    # here on first use, one memsim_event_scan launch a canonical chunk.
    zero_launches(kernels)
    plut = queuelut.default_queue_lut(steps=psteps, device="cuda")
    lut_k5 = 0 if psteps == steps else event_chunks(
        memsim, psteps, 0, chunk=memsim.canonical_chunk("event"))
    if scan_launches(kernels) != {"memsim_ts_scan": 0,
                                  "memsim_event_scan": lut_k5}:
        fail(f"plan lut: the {psteps}-step surface made "
             f"{scan_launches(kernels)} launches, not {lut_k5} K5")
    zero_launches(kernels)
    lut_cli_ms, (rc_lut, _) = host_ms(lambda: run_cli(
        plan_cli.main, PLAN_ARGV + ["--p99-source", "lut", "--device",
                                    "cuda"]))
    if any(scan_launches(kernels).values()):
        fail("plan lut: the LUT plan ran the DES")
    lut_plan, lut_ms, lut_worst, lut_pick = plans("lut", plut)
    log(f"plan on the card equals the CPU: {cells} DES cells "
        f"({len(trace.epochs)} epochs) bit for bit, and a {len(sample)}-cell "
        f"sample alone; exit {rc} on both; des pick/closest {des_pick} "
        f"(access and token p99 within {des_worst:.3e}); lut pick/closest "
        f"{lut_pick} (within {lut_worst:.3e}), CLI exit {rc_lut}")
    log(f"plan timing on {smi}: des CLI run (counted) {plan_ms:.1f} ms, "
        f"{plan_k5} memsim_event_scan launches ({cells} lanes x {psteps} "
        f"steps); des plan warm {', '.join(f'{t:.1f}' for t in des_ms)} ms; "
        f"lut CLI run {lut_cli_ms:.1f} ms; lut plan warm "
        f"{', '.join(f'{t:.1f}' for t in lut_ms)} ms")

    # (c) the QueueLUT's headline metrics on the default surface.
    hm_ms, hm = host_ms(lambda: queuelut.headline_metrics(lut,
                                                          device="cuda"))
    hm_cpu = queuelut.headline_metrics(lut, device="cpu")
    worst = max(engine_close(f"headline_metrics {k}", hm[k], hm_cpu[k])
                for k in hm_cpu)
    log(f"headline_metrics on the card ({hm_ms:.1f} ms) equal the CPU's "
        f"within {worst:.3e}: "
        + ", ".join(f"{k}={v:.6g}" for k, v in hm.items()))
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s (host clock)")


def decode_attn_timing(da, ref, shape, length, seed, spec, partials=False):
    """Phase 5 for K2 at one shape (B, Hq, Hk, D, S) in bf16, attending
    ``length`` keys: the kernel, its plain version and SDPA (with
    ``enable_gqa``, on (B, Hk, L, D) views of the same cache) in turns,
    and the bound.  Each call takes the next of as many copies of the
    cache as exceed twice the L2 together, so that it finds its cache cold
    as a decode step finds a layer's.  With ``partials`` the kernel is
    K2's partial build and the plain version its own (SDPA computes the
    normalized output of the same keys), and the bound counts the float32
    terms written.  Returns the JSON line's time fields."""
    b, hq, hk, d, s = shape
    item = torch.finfo(torch.bfloat16).bits // 8
    cache_bytes = 2 * b * s * hk * d * item
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    n_copies = max(1, -(-2 * l2 // cache_bytes))
    copies = [rand_qkv(b, hq, hk, d, s, torch.bfloat16, seed=seed + i)
              for i in range(n_copies)]
    out_bytes = 4 * b * hq * (d + 2) if partials else b * hq * d * item
    io_bytes = 2 * b * length * hk * d * item + b * hq * d * item + out_bytes
    flops = 4 * b * hq * length * d
    t_bytes, t_ops = io_bytes / spec.hbm_bw, flops / spec.peak_bf16_flops
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    views = [(q[:, :, None, :], k[:, :length].transpose(1, 2),
              v[:, :length].transpose(1, 2)) for q, k, v in copies]

    def turns(fn):
        """``fn`` on copy i at its i-th call, cycling."""
        calls = iter(range(1 << 62))
        return lambda: fn(next(calls) % n_copies)

    library = turns(lambda i: F.scaled_dot_product_attention(
        *views[i], enable_gqa=True))
    plain_fn, kernel_fn, name = (
        (ref.decode_attn_partials_ref, da.decode_attn_partials,
         "decode_attn_partials") if partials else
        (ref.decode_attn_ref, da.decode_attn, "decode_attn"))
    plain = turns(lambda i: plain_fn(*copies[i], length))
    kernel = turns(lambda i: kernel_fn(*copies[i], length))
    want = ref.decode_attn_ref(*copies[0], length).float()
    lib_err = (F.scaled_dot_product_attention(*views[0], enable_gqa=True)[
        :, :, 0].float() - want).abs().max().item()
    # Events around back-to-back calls time the host's call at the small
    # shapes; a CUDA graph of the calls times the card alone, and is what
    # the JSON line and the ratios take.
    times, dev = {}, {}
    for key, fn in (("plain", plain), ("kernel", kernel),
                    ("library", library), ("kernel", kernel),
                    ("plain", plain)):
        times.setdefault(key, []).append(time_ms(fn))
        dev.setdefault(key, []).append(graph_ms(fn))
    best = {key: min(dev[key]) for key in dev}
    ms = best["kernel"]
    geo = da.geometry(torch.bfloat16, shape, length)
    log(f"{name} bf16 B{b} Hq{hq} Hk{hk} D{d} G{hq // hk} S{s} length "
        f"{length}: in a CUDA graph kernel {dev['kernel']} ms, plain "
        f"{dev['plain']} ms, SDPA {dev['library']} ms; by events a call "
        f"kernel {times['kernel']} ms, plain {times['plain']} ms, SDPA "
        f"{times['library']} ms (SDPA vs plain max|err| {lib_err:.3e}); "
        f"bound {bound_ms:.5f} ms by {bound_by} ({io_bytes} B, {flops} "
        f"FLOP) -> {bound_ms / ms:.3f} of roofline, "
        f"{io_bytes / ms / 1e6:.1f} GB/s; kernel / SDPA "
        f"{ms / best['library']:.3f}; {n_copies} cache copies in turn")
    log(f"  launch: {geo['parts']} parts of {geo['part_keys']} keys (cluster "
        f"{geo['cluster']}), {geo['blocks']} blocks x {geo['threads']} "
        f"threads, ring {geo['stages']} stages x {geo['tile_keys']} keys "
        f"({geo['ring_bytes']} B), {geo['smem_bytes']} B shared a block, "
        f"{geo['blocks_per_sm']} blocks an SM, {geo['clusters']} clusters at "
        f"once")
    del copies, views
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": best["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": best["library"]}


@contextlib.contextmanager
def depth_cut(serve, n_layers):
    """``serve.main`` builds its model from ``serve.get_config``: with
    ``n_layers``, the named config cut to that many layers (full layer
    width); serve has no flag for it, as the reference's has none."""
    if n_layers is None:
        yield
        return
    orig = serve.get_config
    serve.get_config = lambda arch: dataclasses.replace(
        orig(arch), n_layers=n_layers)
    try:
        yield
    finally:
        serve.get_config = orig


def serve_path(serve, kernels, arch, expected, n_layers=None):
    """Phase 3 for one path: counts to 0, serve once, read the counts."""
    for kern in kernels.values():
        kern.launches = 0
    with depth_cut(serve, n_layers):
        toks = serve.main(["--arch", arch, "--batch", str(BATCH),
                           "--prompt-len", str(PROMPT), "--gen", str(GEN),
                           "--seed", str(SEED)])
    launches = {name: kern.launches for name, kern in kernels.items()}
    log(f"{arch}: kernel launches on the serving path: {launches} "
        f"(expected {expected})")
    if launches != expected:
        fail(f"{arch}: launch counts {launches} != {expected}")
    return toks, launches


#: The serving paths of phases 3 and 4: arch -> (layers served, None for
#: all of them; the hand kernel the path launches; its symbol in the
#: profiler's rows of a bf16 decode step).
SERVE_PATHS = {DENSE_ARCH: (None, "decode_attn", "decode_attn_mma"),
               SSM_ARCH: (None, "wkv", "wkv_kernel"),
               MOE_ARCH: (None, "decode_attn", "decode_attn_mma"),
               HYBRID_ARCH: (None, "decode_attn", "decode_attn_mma"),
               VLM_ARCH: (VLM_LAYERS, "decode_attn", "decode_attn_mma")}


def path_launches(cfg, kname) -> int:
    """The launches of ``kname`` one serve.main run implies: wkv every
    layer on both prefills and every step; decode_attn every attention
    layer on every step (a hybrid model's shared block once a group)."""
    if kname == "wkv":
        return (GEN + 2) * cfg.n_layers
    if cfg.family == "hybrid":
        return GEN * (cfg.n_layers // cfg.attn_every)
    return GEN * cfg.n_layers


def serve_phase(archs=tuple(SERVE_PATHS)):
    """Phases 3 and 4 for the serving paths ``archs``: each through
    ``serve.main`` with every kernel's count at 0 just before and the
    exact counts just after, then its logits kernel path against plain
    path (``PATH_CHECK``) and its prefill and decode steps timed.  Returns
    (launches a kernel, summed over the paths; the profiler's time a
    launch of each path's kernel on its decode steps, by arch).  Alone,
    the hybrid and vlm paths: ``python3 -c "import chip_smoke;
    chip_smoke.serve_phase(['zamba2-2.7b', 'qwen2-vl-72b'])"``."""
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card; this script runs only on one")
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.kernels import build
    from repro_torch.kernels import memsim_scan as ms
    from repro_torch.kernels import stream as ks
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    kernels = {kname: kern for family in serve.PATH_KERNELS.values()
               for kname, kern in family.items()}
    build.load_all([kern.library for kern in kernels.values()])
    kernels.update(ks.KERNELS)
    kernels.update(ms.KERNELS)
    none = dict.fromkeys(kernels, 0)
    cfgs = {}
    for arch in archs:
        n_layers = SERVE_PATHS[arch][0]
        cfg = get_config(arch)
        cfgs[arch] = cfg if n_layers is None else dataclasses.replace(
            cfg, n_layers=n_layers)
    launches = {}
    for arch, cfg in cfgs.items():
        n_layers, kname, _ = SERVE_PATHS[arch]
        expected = {**none, kname: path_launches(cfg, kname)}
        toks, counts = serve_path(serve, kernels, arch, expected, n_layers)
        launches[kname] = launches.get(kname, 0) + counts[kname]
        if toks.shape != (BATCH, GEN) or toks.min() < 0 or \
                toks.max() >= cfg.vocab:
            fail(f"{arch}: bad generated tokens: shape {toks.shape}, "
                 f"range [{toks.min()}, {toks.max()}]")
    step_launch_ms = {}
    s_max = PROMPT + GEN
    for arch, cfg in cfgs.items():
        dtype, tol = PATH_CHECK[arch]
        path_check(Model, SyntheticDataset, dataclasses.replace(
            cfg, dtype=str(dtype).removeprefix("torch.")), s_max, tol,
            moe=moe if cfg.family == "moe" else None)
        step_launch_ms[arch] = decode_timing(
            Model, SyntheticDataset, cfg, s_max, SERVE_PATHS[arch][2])
    return launches, step_launch_ms


def clone_cache(cache):
    """A copy of a decode cache: a pass writes its cache in place."""
    return {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in cache.items()}


def prompt_of(SyntheticDataset, cfg):
    """serve's prompt: the pipeline's batch without its training keys
    (for qwen2-vl its vision rows and (B, S, 3) M-RoPE positions)."""
    return {k: v for k, v in SyntheticDataset(
        cfg, BATCH, PROMPT, seed=SEED + 1).batch_at(0).items()
        if k not in ("targets", "loss_mask")}


def step_of(tok, cache, cfg):
    pos = torch.full((BATCH, 1), cache["len"], dtype=torch.int32,
                     device=tok.device)
    if cfg.mrope_sections:
        pos = pos[..., None].expand(-1, -1, 3)
    return dict(tokens=tok[:, None], positions=pos)


class RouteLog:
    """Records the top-k experts of every moe layer a pass routes
    (``models.moe.route``), by label: ``with log.collect("prefill kernel"):
    ...``.  A no-op for families without experts."""

    def __init__(self, moe=None):
        self.moe, self.calls = moe, {}

    @contextlib.contextmanager
    def collect(self, label):
        if self.moe is None:
            yield
            return
        orig, calls = self.moe.route, self.calls.setdefault(label, [])

        def route(*args):
            out = orig(*args)
            calls.append(out[3].clone())
            return out
        self.moe.route = route
        try:
            yield
        finally:
            self.moe.route = orig

    def differing_rows(self, what, tokens_a_row):
        """(differing (layer, token) decisions, decisions, batch rows with
        a differing decision) between the kernel and the plain path."""
        a, b = self.calls[f"{what} kernel"], self.calls[f"{what} plain"]
        if len(a) != len(b):
            fail(f"route log: {len(a)} moe layers on the kernel path, "
                 f"{len(b)} on the plain path ({what})")
        n_diff, n_all, rows = 0, 0, set()
        for x, y in zip(a, b):
            diff = (x != y).any(-1)
            n_diff += int(diff.sum())
            n_all += diff.numel()
            rows.update((diff.nonzero()[:, 0] // tokens_a_row).tolist())
        return n_diff, n_all, rows


def path_check(Model, SyntheticDataset, cfg, s_max, tol, moe=None):
    """Phase 4's check for one path, at ``cfg``'s dtype: prefill and
    first-step logits, kernels against their plain versions.  With
    ``moe`` (the module), the routing decisions of both paths are
    counted and the gate holds on the rows whose routes agree."""
    arch = cfg.name
    routes = RouteLog(moe)
    with torch.inference_mode():
        model = Model(cfg)
        params = model.init(SEED)
        prompt = prompt_of(SyntheticDataset, cfg)
        prefill, caches = {}, {}
        for path in ("kernel", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with routes.collect(f"prefill {path}"):
                prefill[path], caches[path] = model.prefill(
                    params, prompt, model.make_cache(BATCH, s_max),
                    plain_kernels=path != "kernel")
            torch.cuda.synchronize()
            log(f"{arch} {cfg.dtype}: prefill {BATCH}x{PROMPT} tokens "
                f"({path} path, warm): "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        # Both steps from the kernel path's prefill; each from its copy.
        cache = caches.pop("kernel")
        tok = prefill["kernel"].argmax(-1).to(torch.int32)
        step = {}
        for path in ("kernel", "plain"):
            with routes.collect(f"step {path}"):
                step[path] = model.decode_step(
                    params, step_of(tok, cache, cfg), clone_cache(cache),
                    plain_kernels=path != "kernel")[0]
        torch.cuda.synchronize()
        worst = 0.0
        for what, lg, key, per_row in (("prefill", prefill, "prefill", PROMPT),
                                       ("first decode step", step, "step", 1)):
            for path, x in lg.items():
                if not torch.isfinite(x).all():
                    fail(f"{arch}: non-finite logits on the {what} ({path})")
                if x.shape != (BATCH, cfg.vocab):
                    fail(f"{arch}: logits shape {tuple(x.shape)}")
            rows = list(range(BATCH))
            if moe is not None:
                n_diff, n_all, bad = routes.differing_rows(key, per_row)
                rows = [r for r in rows if r not in bad]
                log(f"{arch} {cfg.dtype}: {what}: {n_diff} of {n_all} "
                    f"(layer, token) routing decisions differ kernel vs "
                    f"plain, in batch rows {sorted(bad)}; the gate holds on "
                    f"the other {len(rows)} rows")
                if not rows:
                    fail(f"{arch}: every batch row routes differently on "
                         f"the kernel and the plain path ({what})")
            kl, pl = lg["kernel"][rows], lg["plain"][rows]
            dlogit = (kl - pl).abs().max().item()
            agree = (kl.argmax(-1) == pl.argmax(-1)).float().mean().item()
            log(f"{arch} {cfg.dtype}: path check, {what}: max|logit| "
                f"{kl.abs().max().item():.3f}, max|dlogit| kernel "
                f"vs plain {dlogit:.4e} (tol {tol:.4e}); greedy-token "
                f"agreement {agree * 100:.1f}% of {len(rows)}")
            if dlogit > tol:
                fail(f"{arch}: kernel path logits differ from plain path by "
                     f"{dlogit} on the {what} (tol {tol})")
            worst = max(worst, dlogit)
        del params, model, caches, cache
    torch.cuda.empty_cache()
    return worst


def decode_timing(Model, SyntheticDataset, cfg, s_max, symbol):
    """Phase 4's timing for one path: decode steps on both paths, the
    device's busy share, and the device time a launch of the path's kernel
    (``symbol``) over those steps, in ms (None if the profiler saw none)."""
    arch = cfg.name
    with torch.inference_mode():
        model = Model(cfg)
        params = model.init(SEED)
        prompt = prompt_of(SyntheticDataset, cfg)
        pre_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, prompt,
                                          model.make_cache(BATCH, s_max))
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"{arch} {cfg.dtype}: prefill {BATCH}x{PROMPT} tokens (kernel "
            f"path): {', '.join(f'{v:.3f}' for v in pre_ms)} ms")
        dev_ms, top = profile(lambda: model.prefill(
            params, prompt, model.make_cache(BATCH, s_max)))
        if dev_ms is not None:
            log(f"{arch}: device kernel time of a prefill: {dev_ms:.3f} ms "
                f"of {min(pre_ms):.3f} ms unprofiled wall -> busy share "
                f"{dev_ms / min(pre_ms):.3f}")
            for ms, key, count in top[:8]:
                log(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
        tok = logits.argmax(-1).to(torch.int32)
        n_steps = 8

        def decode_run(plain: bool, c):
            t = tok
            for _ in range(n_steps):
                lg, c = model.decode_step(params, step_of(t, c, cfg), c,
                                          plain_kernels=plain)
                t = lg.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()

        step_ms = {}
        for plain in (True, False, False, True):
            decode_run(plain, clone_cache(cache))              # warm
            c = clone_cache(cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode_run(plain, c)
            ms = (time.perf_counter() - t0) * 1e3 / n_steps
            step_ms.setdefault("plain" if plain else "kernel", []).append(ms)
        for key, vals in step_ms.items():
            log(f"{arch}: decode step ({key} path), batch {BATCH}, "
                f"context {PROMPT}..{PROMPT + n_steps}: "
                f"{', '.join(f'{v:.3f}' for v in vals)} ms/step -> "
                f"{BATCH * 1e3 / min(vals):.1f} tok/s")
        c = clone_cache(cache)
        torch.cuda.synchronize()
        dev_ms, top = profile(lambda: decode_run(False, c))
        per_launch = None
        if dev_ms is None:
            log(f"{arch}: device busy share: not measured (profiler gave no "
                f"device time)")
        else:
            wall = min(step_ms["kernel"]) * n_steps
            n_launch, n_copy = launch_counts(top)
            log(f"{arch}: device kernel time over {n_steps} kernel-path "
                f"decode steps: {dev_ms:.3f} ms of {wall:.3f} ms unprofiled "
                f"wall -> busy share {dev_ms / wall:.3f}; "
                f"{n_launch / n_steps:.0f} kernel launches and "
                f"{n_copy / n_steps:.0f} copies a step")
            for ms, key, count in top[:8]:
                log(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
            mine = [(ms, n) for ms, key, n in top if symbol in key]
            if mine:
                per_launch = mine[0][0] / mine[0][1]
                log(f"{arch}: {symbol} on the decode steps: "
                    f"{per_launch:.5f} ms a launch (x{mine[0][1]})")
        del params, cache, model
    torch.cuda.empty_cache()
    return per_launch


# --- phase 10: training -----------------------------------------------------

def wkv_bwd_cost(b, t, h, d, itemsize):
    """(bytes, FLOP) wkv's backward needs: r, k, v (itemsize), w and dy
    (fp32), u and the initial state read once; dr, dk, dv (itemsize), dw,
    du and the initial state's gradient written once (no final-state
    gradient, as in training).  Per step and state element 14 fp32
    operations (the states recomputed, S * w + k v: 3; r.S.dy, dS.v,
    <dS, S>, k.dS: 2 each; dS * w + r dy: 3), and per step, head and key
    15 for the bonus terms (v.dy 2, r.u.k 3, dr 3, dk 2, dv 2, du 3)."""
    n = b * t * h * d
    nbytes = n * (3 * itemsize + 8) + h * d * 4 + b * h * d * d * 4 + \
        n * (3 * itemsize + 4) + h * d * 4 + b * h * d * d * 4
    return nbytes, 14 * n * d + 15 * n


WKV_BWD_OUTPUTS = ("dr", "dk", "dv", "dw", "du", "ds0")


def check_wkv_bwd(kw, ref, shape, dtype, decay, ds_t, seed):
    """K3b against wkv_bwd_ref on the card: every output within
    WKV_BWD_TOL of its largest element (bf16 dr, dk, dv also within 1e-2
    of themselves: both round once to bf16).  Returns the largest
    absolute error over the outputs."""
    b, t, h, d = shape
    r, k, v, w, u, s0 = rand_wkv(b, t, h, d, dtype, decay, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(b, t, h, d, device="cuda", generator=gen)
    dst = torch.randn(b, h, d, d, device="cuda", generator=gen) \
        if ds_t else None
    got = kw.wkv_bwd(r, k, v, w, u, s0, dy, dst)
    want = ref.wkv_bwd_ref(r, k, v, w, u, s0, dy, dst)
    torch.cuda.synchronize()
    errs, worst = [], 0.0
    for name, g, x in zip(WKV_BWD_OUTPUTS, got, want):
        if g.dtype != x.dtype or g.shape != x.shape:
            fail(f"wkv_bwd {name}: {g.dtype} {tuple(g.shape)}, plain "
                 f"{x.dtype} {tuple(x.shape)}")
        g, x = g.float(), x.float()
        scale = x.abs().max().item()
        diff = (g - x).abs()
        rtol = 1e-2 if name in ("dr", "dk", "dv") and \
            dtype == torch.bfloat16 else 0.0
        if not bool((diff <= WKV_BWD_TOL * scale + rtol * x.abs()).all()):
            fail(f"wkv_bwd {name} disagrees with wkv_bwd_ref at {shape}, "
                 f"{dtype}, w~{decay}, ds_t {ds_t}: max|err| "
                 f"{diff.max().item():.3e} of max|grad| {scale:.3e}")
        errs.append(f"{name} {diff.max().item():.2e}/{scale:.1e}")
        worst = max(worst, diff.max().item())
    log(f"  wkv_bwd {dtype} w~{decay} ds_T {'N(0,1)' if ds_t else '0'} "
        f"B{b} T{t} H{h} D{d}: max|err|/max|grad| {', '.join(errs)} "
        f"(tol {WKV_BWD_TOL} of max|grad|) ok")
    return worst


def check_wkv_bwd_cases(kw, ref):
    """Phase 2 for K3b: ragged lengths and the edges of its segment (the
    checkpoint interval), both decay ranges, ds_T zero and not, f32 and
    bf16, D 16/32/64, and the training shape.  Returns the largest error
    at the training shape in bf16 (the JSON line's)."""
    seg = kw.geometry_bwd(torch.bfloat16, TRAIN_SHAPE)["segment"]
    if seg != kw.SEGMENT:
        fail(f"wkv_bwd: the library's segment {seg} != {kw.SEGMENT}")
    h, d = TRAIN_SHAPE[2:]
    seed, path_err = 300, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for decay in ("model", "sigmoid"):
            for i, t in enumerate((1, 7, seg - 1, seg, seg + 1, 2 * seg + 1,
                                   100)):
                seed += 1
                check_wkv_bwd(kw, ref, (BATCH, t, h, d), dtype, decay,
                              i % 2 == 1, seed)
            # One (batch, head), one block, at each D, below, at and one
            # above a segment.
            for hd in kw.HEAD_DIMS_BWD:
                for i, t in enumerate((seg - 1, seg, seg + 1)):
                    seed += 1
                    check_wkv_bwd(kw, ref, (1, t, 1, hd), dtype, decay,
                                  i == 1, seed)
            check_wkv_bwd(kw, ref, (2, 40, 4, 16), dtype, decay, True,
                          seed + 1)
            check_wkv_bwd(kw, ref, (3, 50, 5, 32), dtype, decay, False,
                          seed + 2)
        for ds_t in (False, True):
            seed += 3
            err = check_wkv_bwd(kw, ref, TRAIN_SHAPE, dtype, "model", ds_t,
                                seed)
            if dtype == torch.bfloat16 and not ds_t:
                path_err = err
    return path_err


def grads_close(what, got, want, tol):
    """Hold (loss, grad norm, gradient tree) to another run's: the loss and
    the norm within ``tol`` relative, each leaf within tol["leaf"] of its
    largest element.  Logs the largest share."""
    from repro_torch.models.layers import flatten_tree
    (loss, gnorm, grads), (wloss, wgnorm, wgrads) = got, want
    wl = dict(flatten_tree(wgrads, torch.is_tensor))
    shares = []
    for path, g in flatten_tree(grads, torch.is_tensor):
        x = wl[path].to(g.device)
        share = ((g - x).abs().max() / x.abs().max().clamp(min=1e-30)).item()
        if not share <= tol["leaf"]:
            fail(f"{what}: gradient {path} differs by {share:.3e} of its "
                 f"largest element (tol {tol['leaf']})")
        shares.append((share, path))
    shares.sort(reverse=True)
    dl, dn = abs(loss / wloss - 1), abs(gnorm / wgnorm - 1)
    log(f"{what}: loss {loss:.6f} vs {wloss:.6f} (rel {dl:.2e}, tol "
        f"{tol['loss']}), grad norm {gnorm:.6f} vs {wgnorm:.6f} (rel "
        f"{dn:.2e}, tol {tol['gnorm']}); every gradient leaf within "
        f"{shares[0][0]:.2e} of its largest element (tol {tol['leaf']}; "
        f"worst {', '.join(f'{p} {x:.1e}' for x, p in shares[:4])})")
    if not (dl <= tol["loss"] and dn <= tol["gnorm"]):
        fail(f"{what}: loss or grad norm out of tolerance")


def loss_and_grads(model, params, batch, plain=False):
    """(loss, global grad norm, gradient tree) of one value-and-grad."""
    from repro_torch.distributed import step as pstep
    from repro_torch.models.layers import flatten_tree
    from repro_torch.optim import adamw
    for _, p in flatten_tree(params, torch.is_tensor):
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch, plain_kernels=plain)
    grads = pstep._grads(loss, params)
    return loss.item(), adamw.global_norm(grads).item(), grads


def train_path(train, kernels, arch, steps, expected):
    """Counts to 0, ``train.main`` at full width, read the counts; the
    losses must be finite.  Returns (launches, losses, peak GiB)."""
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train.main(["--arch", arch, "--batch", str(TRAIN_BATCH),
                         "--seq", str(TRAIN_SEQ), "--steps", str(steps),
                         "--log-every", "1", "--seed", str(SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{arch}: train.main {steps} steps at B{TRAIN_BATCH} S{TRAIN_SEQ} "
        f"in {wall:.1f} s (model init, the kernels' load and the first "
        f"step included), peak {peak:.2f} GiB; launches {launches} "
        f"(expected {expected}); losses {losses}")
    if launches != expected:
        fail(f"{arch}: training launch counts {launches} != {expected}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"{arch}: training losses {losses}")
    torch.cuda.empty_cache()
    return launches, losses, peak


def train_timing(arch, smi):
    """A train step at full width (B TRAIN_BATCH, S TRAIN_SEQ, the CLI's
    AdamW) timed warm by the host clock ending in a synchronise, the peak
    memory, the profiler's busy share and the K3/K3b time a launch (None
    if the profiler saw none)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed import step as pstep
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config(arch)
    model = Model(cfg)
    step_cfg = pstep.TrainStepConfig(
        opt=AdamWConfig(lr=3e-3, total_steps=4, warmup_steps=5),
        param_dtype=cfg.dtype)
    fn = pstep.make_train_step(model, step_cfg)
    torch.cuda.reset_peak_memory_stats()
    state = pstep.init_train_state(model, SEED, step_cfg)
    ds = SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 1)
    state, _ = fn(state, ds.batch_at(0))                       # warm
    torch.cuda.synchronize()
    step_ms = []
    for i in range(1, 1 + TRAIN_TIMED):
        t0 = time.perf_counter()
        state, met = fn(state, ds.batch_at(i))
        loss = met["loss"].item()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch = ds.batch_at(TRAIN_TIMED + 1)
    dev_ms, rows = profile(lambda: fn(state, batch))
    best = min(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"{arch} {cfg.dtype} train step B{TRAIN_BATCH} S{TRAIN_SEQ} on "
        f"{smi}: {', '.join(f'{x:.1f}' for x in step_ms)} ms -> "
        f"{tokens * 1e3 / best:.0f} tokens/s; peak {peak:.2f} GiB; last "
        f"loss {loss:.4f}")
    per_launch = {}
    if dev_ms is None:
        log(f"{arch}: train step busy share not measured (the profiler "
            f"gave no device time)")
    else:
        n_launch, n_copy = launch_counts(rows)
        log(f"{arch}: device kernel time of a train step {dev_ms:.1f} ms of "
            f"{best:.1f} ms unprofiled wall -> busy share "
            f"{dev_ms / best:.3f}; {n_launch} kernel launches, {n_copy} "
            f"copies")
        for ms, key, count in rows[:8]:
            log(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
        for name, symbol in (("wkv", "wkv_kernel"),
                             ("wkv_bwd", "wkv_bwd_kernel")):
            mine = [(ms, n) for ms, key, n in rows if symbol in key]
            if mine:
                per_launch[name] = mine[0][0] / mine[0][1]
                log(f"{arch}: {name} in the train step {per_launch[name]:.4f}"
                    f" ms a launch (x{mine[0][1]})")
    del state, fn, model
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, peak_gib=peak, busy=None if dev_ms is None
                else dev_ms / best, per_launch=per_launch)


def train_path_check(arch, n_layers, kernels):
    """rwkv6 at full width, depth cut to ``n_layers``, float32: one
    value-and-grad through K3/K3b and through their plain versions; the
    loss, the grad norm and every gradient leaf held (TRAIN_PATH_TOL), and
    the kernel path's launches exact."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype="float32")
    model = Model(cfg)
    params = model.init(SEED)
    batch = SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ,
                             seed=SEED + 1).batch_at(0)
    runs = {}
    for plain in (False, True):
        for kern in kernels.values():
            kern.launches = 0
        t0 = time.perf_counter()
        runs[plain] = loss_and_grads(model, params, batch, plain)
        torch.cuda.synchronize()
        counts = {name: kern.launches for name, kern in kernels.items()}
        want = dict.fromkeys(kernels, 0)
        if not plain:
            want.update(wkv=2 * n_layers, wkv_bwd=n_layers)
        log(f"{arch} f32 {n_layers} layers, B{TRAIN_BATCH} S{TRAIN_SEQ}: "
            f"value-and-grad ({'plain' if plain else 'kernel'} path) "
            f"{(time.perf_counter() - t0) * 1e3:.0f} ms, launches {counts}")
        if counts != want:
            fail(f"{arch}: launches {counts} != {want}")
    grads_close(f"{arch} f32 {n_layers} layers, kernel path vs plain path",
                runs[False], runs[True], TRAIN_PATH_TOL)
    del runs, params, model
    torch.cuda.empty_cache()


def train_cpu_check(arch, n_layers, kernels):
    """One float32 value-and-grad at full width, depth cut to ``n_layers``,
    batch TRAIN_CPU_BATCH x TRAIN_SEQ (flash_attention's two chunks), on
    the card and on the CPU from the same weights: held (TRAIN_CPU_TOL);
    no hand kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models.layers import map_tree
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype="float32")
    batch = SyntheticDataset(cfg, TRAIN_CPU_BATCH, TRAIN_SEQ,
                             seed=SEED + 1).batch_at(0)
    cpu_model = Model(cfg, device="cpu")
    cpu_params = cpu_model.init(SEED)
    card_params = map_tree(lambda p: p.to("cuda"), cpu_params)
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    card = loss_and_grads(Model(cfg), card_params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = loss_and_grads(cpu_model, cpu_params, batch)
    t2 = time.perf_counter()
    counts = {name: kern.launches for name, kern in kernels.items()}
    log(f"{arch} f32 {n_layers} layers, B{TRAIN_CPU_BATCH} S{TRAIN_SEQ}: "
        f"value-and-grad card {(t1 - t0) * 1e3:.0f} ms, CPU "
        f"{(t2 - t1) * 1e3:.0f} ms (host clock); hand-kernel launches "
        f"{counts}")
    if any(counts.values()):
        fail(f"{arch}: a hand kernel launched on the attention path")
    grads_close(f"{arch} f32 {n_layers} layers, card vs CPU", card, cpu,
                TRAIN_CPU_TOL)
    del card, cpu, card_params, cpu_params
    torch.cuda.empty_cache()


def train_resume_check(train):
    """Checkpoint save, crash and resume on the card at the smoke config of
    rwkv6 (K3 and K3b in the loop): a run crashed in step 3 and run again
    from its checkpoint of step 2 gives the uninterrupted run's losses."""
    import tempfile
    from repro_torch.checkpoint import ckpt
    argv = ["--arch", SSM_ARCH, "--smoke", "--steps", "5", "--batch", "2",
            "--seq", "64", "--ckpt-every", "2", "--seed", str(SEED)]
    whole = train.main(argv)
    make = train.make_train_step

    def crashing(model, step_cfg):
        step = make(model, step_cfg)

        def run(state, batch):
            if int(state["step"]) == 3:
                raise RuntimeError("injected crash")
            return step(state, batch)
        return run
    with tempfile.TemporaryDirectory() as tmp:
        train.make_train_step = crashing
        try:
            train.main(argv + ["--ckpt-dir", tmp])
            fail("the injected crash did not stop the run")
        except RuntimeError as err:
            if "injected crash" not in str(err):
                raise
        finally:
            train.make_train_step = make
        at = ckpt.latest_step(tmp)
        resumed = train.main(argv + ["--ckpt-dir", tmp])
        final = ckpt.latest_step(tmp)
    log(f"checkpoint on the card: crashed in step 3, restored step {at}, "
        f"resumed losses {resumed} vs uninterrupted {whole[at:]}; final "
        f"checkpoint step {final}")
    if at != 2 or final != 5 or resumed != whole[at:]:
        fail("crash and resume on the card did not reproduce the "
             "uninterrupted run")


def wkv_bwd_timing(kw, ref, spec, smi):
    """Phase 5 for K3b at the training shape, bf16: the kernel by events
    (plain, kernel, kernel, plain), the profiler's time a launch, the
    bound and the launch it makes.  No single PyTorch call computes the
    function: library none."""
    b, t, h, d = TRAIN_SHAPE
    r, k, v, w, u, s0 = rand_wkv(b, t, h, d, torch.bfloat16, "model", 77)
    dy = torch.randn(b, t, h, d, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(78))
    args = (r, k, v, w, u, s0, dy)
    wt = {}
    for key, fn, it in (("plain", lambda: ref.wkv_bwd_ref(*args), 1),
                        ("kernel", lambda: kw.wkv_bwd(*args), 20),
                        ("kernel", lambda: kw.wkv_bwd(*args), 20),
                        ("plain", lambda: ref.wkv_bwd_ref(*args), 1)):
        wt.setdefault(key, []).append(time_ms(fn, iters=it,
                                              warmup=min(it, 2)))
    _, rows = profile(lambda: [kw.wkv_bwd(*args) for _ in range(5)])
    dev = [(ms, c) for ms, key, c in rows if "wkv_bwd_kernel" in key]
    dev_ms = dev[0][0] / dev[0][1] if dev else None
    nbytes, flops = wkv_bwd_cost(b, t, h, d, 2)
    t_bytes, t_ops = nbytes / spec.hbm_bw, flops / spec.peak_fp32_flops
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    geo = kw.geometry_bwd(torch.bfloat16, TRAIN_SHAPE)
    ckpt = 4 * b * h * d * d * kw.checkpoint_shape(TRAIN_SHAPE)[1]
    ms = min(wt["kernel"])
    log(f"wkv_bwd bf16 B{b} T{t} H{h} D{d} on {smi}: kernel {wt['kernel']} "
        f"ms by events (profiler: "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} a "
        f"launch), plain {wt['plain']} ms; bound {bound:.5f} ms by {by} "
        f"({nbytes} B, {flops} FLOP at {spec.peak_fp32_flops / 1e12} "
        f"TFLOP/s fp32) -> {bound / ms:.3f} of the bound; launch "
        f"{geo['blocks']} blocks (one a (batch, head)) x {geo['threads']} "
        f"threads, segments of {geo['segment']} steps in shared memory, "
        f"{geo['keys']} keys x {geo['columns']} columns a thread, "
        f"{geo['registers']} registers, {geo['smem_bytes']} B shared "
        f"memory a block, {geo['blocks_per_sm']} blocks an SM; checkpoints "
        f"{ckpt / 2**20:.0f} MiB (a state at every segment start but the "
        f"last, fp32)")
    del args, r, k, v, w, u, s0, dy
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": min(wt["plain"]), "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def train_phase(k3b_err=None):
    """Phase 10, training on the card.  K3b held to its plain version
    (unless ``k3b_err`` says phase 2 did); rwkv6-1.6b at full width
    through ``repro_torch.launch.train.main`` (bf16, batch 8, seq 1,024,
    remat "full", the CLI's AdamW) for TRAIN_STEPS[rwkv6] steps with exact
    launch counts (2 wkv and 1 wkv_bwd a layer a step); its kernel path
    held to the plain path at 4 layers in float32; stablelm-1.6b and
    hubert-xlarge at full width through train.main with no hand kernel,
    each held to the CPU in float32 at 2 layers; a checkpoint save, crash
    and resume; a train step of each timed (ms, tokens/s, busy share, peak
    memory, K3/K3b a launch), and K3b timed at the training shape.
    Returns (launches by kernel over the three runs, K3b's JSON row).
    Alone: ``python3 -c "import chip_smoke; chip_smoke.train_phase()"``."""
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card; this script runs only on one")
    from repro_torch.configs import get_config
    from repro_torch.core import hw
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import memsim_scan as ms
    from repro_torch.kernels import rwkv_wkv as kw
    from repro_torch.kernels import stream as ks
    from repro_torch.launch import serve, train
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 10 on {smi}; matmul TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32} (float32 products in "
        f"full float32)")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("float32 products would run in TF32")
    spec = hw.spec_for(torch.cuda.get_device_name(0))
    kernels = {kname: kern for family in serve.PATH_KERNELS.values()
               for kname, kern in family.items()}
    for family in train.PATH_KERNELS.values():
        kernels.update(family)
    build.load_all([kern.library for kern in kernels.values()])
    kernels.update(ks.KERNELS)
    kernels.update(ms.KERNELS)
    if k3b_err is None:
        k3b_err = check_wkv_bwd_cases(kw, ref)
    none = dict.fromkeys(kernels, 0)
    n_layers = get_config(SSM_ARCH).n_layers
    steps = TRAIN_STEPS[SSM_ARCH]
    launches, _, _ = train_path(
        train, kernels, SSM_ARCH, steps,
        {**none, "wkv": 2 * n_layers * steps, "wkv_bwd": n_layers * steps})
    train_path_check(SSM_ARCH, TRAIN_CHECK_LAYERS, kernels)
    for arch in (DENSE_ARCH, AUDIO_ARCH):
        train_path(train, kernels, arch, TRAIN_STEPS[arch], none)
        train_cpu_check(arch, TRAIN_CPU_LAYERS, kernels)
    train_resume_check(train)
    timing = {arch: train_timing(arch, smi) for arch in TRAIN_STEPS}
    row = wkv_bwd_timing(kw, ref, spec, smi)
    for name in ("wkv", "wkv_bwd"):
        dev = timing[SSM_ARCH]["per_launch"].get(name)
        log(f"{name} in the rwkv6 train step: "
            f"{'not measured' if dev is None else f'{dev:.4f} ms a launch'}")
    summary = []
    for arch, t in timing.items():
        best = min(t["step_ms"])
        busy = "not measured" if t["busy"] is None else f"{t['busy']:.3f}"
        summary.append(f"{arch} {best:.1f} ms a step, "
                       f"{TRAIN_BATCH * TRAIN_SEQ * 1e3 / best:.0f} "
                       f"tokens/s, busy {busy}, peak {t['peak_gib']:.2f} GiB")
    log(f"training summary on {smi}: {'; '.join(summary)}")
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s (host clock)")
    return ({"wkv": launches["wkv"], "wkv_bwd": launches["wkv_bwd"]},
            {"max_abs_err": k3b_err, **row})


# --- phase 11: the multi-device layer ---------------------------------------

# The sharded DES: 37 cells x 2 replicas (74 lanes: not a multiple of a
# card count above 1, nor of the scans' 32-lane blocks) at a budget of a
# few chunks, each engine with ``devices="auto"`` and with ``devices=None``.
MESH_DES_CELLS, MESH_DES_REPS, MESH_DES_STEPS = 37, 2, 40_000


def world_of_one(backend):
    """This process as rank 0 of a one-rank world (its store on a port
    the kernel picks)."""
    import datetime

    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, world_size=1, is_master=True,
                          timeout=datetime.timedelta(seconds=120))
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    return store


def mesh_des_check(kernels, device="cuda"):
    """The DES through ``core/shardsim``: ``devices="auto"`` (the cards
    torch sees) against ``devices=None``, both engines, histograms bit for
    bit, each run's scan launches exact (one a chunk a shard)."""
    import numpy as np

    from repro_torch.core import memsim, shardsim
    ndev = shardsim.resolve_devices("auto", device=device)
    cfgs = [memsim.ChannelConfig(rho=float(r))
            for r in np.linspace(0.05, 0.93, MESH_DES_CELLS)]
    lanes = MESH_DES_CELLS * MESH_DES_REPS
    total = {"memsim_ts_scan": 0, "memsim_event_scan": 0}
    for engine in memsim.ENGINES:
        hists = {}
        for devices, shards in ((None, 1), ("auto", ndev)):
            for kern in kernels.values():
                kern.launches = 0
            t0 = time.perf_counter()
            stats = memsim.simulate(cfgs, steps=MESH_DES_STEPS, seed=SEED,
                                    reps=MESH_DES_REPS, engine=engine,
                                    devices=devices, device=device)
            ms = (time.perf_counter() - t0) * 1e3
            got = {k: kern.launches for k, kern in kernels.items()
                   if k in total}
            want = {k: v * shards for k, v in memsim_launches(
                memsim, [(engine, lanes, MESH_DES_STEPS)]).items()}
            if device == "cuda" and got != want:
                fail(f"sharded DES ({engine}, devices={devices!r}): scan "
                     f"launches {got} != {want}")
            for k in total:
                total[k] += got.get(k, 0)
            hists[devices] = stats.hist
            log(f"sharded DES {engine}, devices={devices!r} ({shards} "
                f"shard(s)), {lanes} lanes x {MESH_DES_STEPS} steps: "
                f"{ms:.1f} ms (host clock), launches {got}")
        if not np.array_equal(hists[None], hists["auto"]):
            fail(f"sharded DES ({engine}): devices='auto' histograms differ "
                 f"from devices=None")
    log(f"sharded DES: devices='auto' is {ndev} device(s); histograms "
        f"bit-equal to devices=None for both engines")
    return total


def _serve_loop(model, step, prefill, params, prompt, cache, gen, cfg):
    """Greedy serve: logits of the prefill and of each step, tokens."""
    logits, tokens = [], []
    lg, cache = prefill(params, prompt, cache)
    for _ in range(gen):
        logits.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        tokens.append(tok)
        pos = torch.full((tok.shape[0], 1), cache["len"], dtype=torch.int32,
                         device=model.device)
        lg, cache = step(params, dict(tokens=tok[:, None], positions=pos),
                         cache)
    logits.append(lg)
    return logits, torch.stack(tokens, dim=1)


def mesh_serve(cfg, kernels, device="cuda", backend="nccl", batch=BATCH,
               prompt_len=PROMPT, gen=GEN, tol=PATH_CHECK[DENSE_ARCH][1]):
    """``cfg`` served on a one-rank world's (1, 1) host mesh: parameters
    as DTensors by ``decode_rules``, the cache by ``cache_shardings``, the
    batch activation rule active, through ``make_prefill`` and
    ``make_serve_step``; K2's launches counted (exactly ``gen`` x layers),
    the greedy tokens equal to the same serve on ordinary tensors and the
    logits within ``tol``.  Then ``int8_all_reduce`` over the world
    against its own quantize round trip.  Returns the K2 launches."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed import context
    from repro_torch.distributed import int8_collectives as i8
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.step import make_prefill, make_serve_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model

    store = world_of_one(backend)
    try:
        mesh = make_host_mesh(1, device_type=device)
        with torch.inference_mode():
            model = Model(cfg, device=device)
            params = model.init(SEED)
            prompt = {k: torch.as_tensor(v, device=device)
                      for k, v in SyntheticDataset(
                          cfg, batch, prompt_len, seed=SEED + 1).batch_at(0)
                      .items() if k not in ("targets", "loss_mask")}
            s_max = prompt_len + gen
            runs, wall = {}, {}
            for how in ("ordinary", "mesh"):
                for kern in kernels.values():
                    kern.launches = 0
                if how == "ordinary":
                    p, c, b = params, model.make_cache(batch, s_max), prompt
                    rules = contextlib.nullcontext()
                else:
                    p = shd.distribute(params, shd.param_shardings(
                        model, mesh, shd.decode_rules(mesh, cfg)))
                    c = model.make_cache(batch, s_max)
                    c = shd.distribute(c, shd.cache_shardings(cfg, mesh, c))
                    b = shd.distribute(prompt, shd.batch_shardings(mesh,
                                                                   prompt))
                    rules = context.activation_rules(
                        mesh, {"batch": shd.fsdp_axes(mesh)})
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                with rules:
                    logits, toks = _serve_loop(
                        model, make_serve_step(model), make_prefill(model),
                        p, b, c, gen, cfg)
                    logits, toks = [whole(x) for x in logits], whole(toks)
                if device == "cuda":
                    torch.cuda.synchronize()
                wall[how] = time.perf_counter() - t0
                runs[how] = (logits, toks, {k: kern.launches for k, kern in
                                            kernels.items()})
                del p, c, b
            k2 = runs["mesh"][2].get("decode_attn", 0)
            want_k2 = gen * cfg.n_layers if device == "cuda" else 0
            log(f"{cfg.name} {cfg.dtype} on a (1, 1) {backend} mesh: "
                f"{batch}x{prompt_len} prompt, {gen} steps: kernel launches "
                f"{runs['mesh'][2]} (expected decode_attn {want_k2}); "
                f"{wall['mesh']:.2f} s, ordinary tensors {wall['ordinary']:.2f}"
                f" s, {wall['mesh'] / wall['ordinary']:.2f}x (host clock, "
                f"prefill and steps; {_then('mesh_serve')})")
            if k2 != want_k2 or runs["ordinary"][2] != runs["mesh"][2]:
                fail(f"mesh serve: launches {runs['mesh'][2]}, ordinary "
                     f"{runs['ordinary'][2]}, want decode_attn {want_k2}")
            if not torch.equal(runs["mesh"][1], runs["ordinary"][1]):
                fail("mesh serve: greedy tokens differ from the ordinary "
                     "serve's")
            worst = max((a.float() - o.float()).abs().max().item()
                        for a, o in zip(runs["mesh"][0], runs["ordinary"][0]))
            log(f"mesh serve: tokens equal the ordinary serve's; max|dlogit| "
                f"{worst:.4e} over the prefill and {gen} steps (tol {tol})")
            if not worst <= tol:
                fail(f"mesh serve: logits differ by {worst} (tol {tol})")
            gen_ = torch.Generator(device=device).manual_seed(SEED + 11)
            x = torch.randn((4096, 1031), generator=gen_, device=device)
            got = i8.int8_all_reduce(x, mesh.get_group("data"))
            q, scale = i8._quantize(x.reshape(-1))
            q2, scale2 = i8._quantize(q.float() * scale)
            want = (q2.float() * scale2).reshape(x.shape)
            if not torch.equal(got, want):
                fail(f"int8_all_reduce on one rank differs from its quantize "
                     f"round trip by {(got - want).abs().max().item()}")
            log("int8_all_reduce on the one-rank world equals its own "
                "quantize round trip bit for bit")
        return k2
    finally:
        dist.destroy_process_group()
        del store


#: Phase 11's wall times in seconds (host clock) when DTensor still
#: propagated the models' ops, as this script read them on an NVIDIA H100
#: 80GB HBM3 at 700.00 W (torch 2.11) in the call that first ran the
#: layer on local tensors: the (1, 1) mesh serve, the two-rank serves
#: (each with the other of its wave), the split train step's runs and
#: the phase.
DTENSOR_LAYER_SECONDS = {
    "mesh_serve": 8.25, "olmoe": 6.83, "starcoder2": 14.79,
    "stablelm": 12.34, "zamba2": 8.12, "split float64": 68.04,
    "split bfloat16": 19.61, "phase 11": 281.0}


def _then(what: str) -> str:
    """The wall time of ``what`` when DTensor propagated the models' ops
    (:data:`DTENSOR_LAYER_SECONDS`), for the log."""
    then = DTENSOR_LAYER_SECONDS.get(what)
    return "through DTensor's propagation: not measured" if then is None \
        else f"through DTensor's propagation {then:.2f} s"


# The two-rank serves on the card: gloo worlds of this many ranks, each
# rank a process on the one card; a shorter prompt and fewer steps than
# phase 3's serve, so that the phase keeps within the script's time.
CHANNEL_RANKS, CHANNEL_PROMPT, CHANNEL_GEN = 2, 256, 8
STARCODER_ARCH = "starcoder2-3b"
#: Phase 11's two-rank serves, by name: (arch, (data, model) mesh, the
#: cache's sequence over model (the channelized cache) or its heads whole,
#: the K2 build each decode step launches, layers served, None for all,
#: dtype).  The serves run two at a time (``WORLD_WAVES``), their four
#: ranks sharing the card, and olmoe at 8 of its 16 layers (float32, ~14
#: GB a rank) and zamba2 at 18 of its 54 (3 of its 9 shared-block
#: groups), so that each pair fits and the phase stays within the
#: script's time (the host's clock ran 1.4x slower in one call than in
#: another, and all four at once ran out of card memory: read on the
#: card).  olmoe and zamba2 serve in float32, as phase 4 checks them
#: (``PATH_CHECK``): in bf16 the two layouts' products round a bf16 step
#: apart, and
#:  * among olmoe's 64 experts gates a step apart are common, so every
#:    batch row of a 256-token prompt had some routing decision that the
#:    layouts took differently (read on the card), and a flipped expert
#:    moves the logits more than a faulty layout would;
#:  * zamba2's 54 Mamba layers carry and re-round such a step: its
#:    logits moved by 4.1, argmax equal in none of 9 steps (read on the
#:    card), where float32 holds them within 1e-2.
#:  * stablelm: the channelized decode: each rank K2's partial
#:    build over its half of every layer's keys, merged by all-reduces;
#:  * olmoe: the batch over data, each rank routing its own tokens with
#:    the other rank's counts as offsets, its half of the expert buffer's
#:    capacity, and K2 on its own batch rows;
#:  * zamba2: the SSM heads over model (a Mamba layer's gated norm summed
#:    over the ranks), the shared block's cache channelized;
#:  * starcoder2: its 24 query heads over model, 12 a rank, each rank's
#:    K2 against its group's KV head (G 12), the cache's heads whole.
WORLD_SERVES = {
    "stablelm": (DENSE_ARCH, (1, 2), True, "decode_attn_partials", None,
                 torch.bfloat16),
    "olmoe": (MOE_ARCH, (2, 1), True, "decode_attn", 8, torch.float32),
    "zamba2": (HYBRID_ARCH, (1, 2), True, "decode_attn_partials", 18,
               torch.float32),
    "starcoder2": (STARCODER_ARCH, (1, 2), False, "decode_attn", None,
                   torch.bfloat16),
}
#: The split train step: rwkv6-1.6b at full width and depth, batch 1 x
#: 2,048, each sequence split in halves over ``pod`` (the multi-pod
#: ``prefill_32k`` cells' layout: ``sharding.split_sequences``) on a
#: (pod 2, data 1, model 1) mesh of two gloo ranks on the card, folded to
#: (2, 1) for the step; loss and gradients only (no AdamW state), so that
#: the two ranks and the one-process step fit the card.  Each rank runs
#: K3 on its half from the state the first half's rank hands over, K3b in
#: the reverse order (``ops._WkvParts``).
SPLIT_TRAIN = "rwkv6-split"
SPLIT_BATCH, SPLIT_SEQ = 1, 2048
#: The split train step's runs, each at all 24 layers and against one
#: process's whole-sequence step on the same weights (bf16's values, which
#: float32 and float64 hold exactly) and tokens: (dtype, plain versions,
#: the split's bounds against one process: loss and gradient norm
#: relative, every leaf as a share of its largest element, None where
#: not gated).
#:   * float64 on the plain path, under :func:`float64_witness`: the split
#:     is exact math, so only float64's rounding can part the steps, where
#:     a fault (a gradient dropped or handed to the wrong half) moves a
#:     leaf by its own size (0.237 in a copy whose shift dropped the
#:     gradient it hands back, on the CPU).  Read on the card (H100,
#:     700 W): loss 1.1e-16, norm 6.8e-13, leaves 1.9e-12 at T 2,048;
#:     loss 1.1e-15, norm 1.8e-10, leaves 1.9e-10 at T 256 (a shorter
#:     sequence carries float64's rounding further).  The bounds lie 50x
#:     above the larger reading and seven orders below a fault.
#:   * bf16, the deployment's dtype, through K3 and K3b: each rank
#:     launches what one process does (48 K3, 24 K3b); loss and norm
#:     within ``TRAIN_PATH_TOL``'s.
#:     Its leaves are reported against ``TRAIN_PATH_TOL``'s 5e-3 (read
#:     6.7e-3; a bf16 step at a leaf's largest element is 3.9e-3 to 7.8e-3
#:     of it).
#:   * float32 through K3 and K3b, in :func:`split_phase` only.
#: Below float64, where a float64 run of the same length came first, the
#: gradients are also held to that truth: the split step's leaves (the
#: largest share) and norm may lie no farther from it than
#: ``SPLIT_ROUNDING`` x the one-process step's.  At 24 layers of random
#: weights rounding itself moves the gradients far: on the card one
#: process's float32 step read 13% from the truth (the split's 8%, the
#: two 19% apart), its bf16 step's norm 6.7x the truth's.
SPLIT_RUNS = {
    "float64": (True, dict(loss=1e-12, gnorm=1e-8, leaf=1e-8)),
    "bfloat16": (False, dict(loss=1e-5, gnorm=2e-3, leaf=None)),
    "float32": (False, dict(loss=1e-5, gnorm=None, leaf=None)),
}
SPLIT_ROUNDING = 2.0
#: The runs (dtype, sequence length) of each split train step: the
#: script's, whose float64 witness takes an eighth of the sequence (the
#: plain WKV's per-token loop is launch-bound, and the split's exchanges
#: do not depend on the length), and :func:`split_phase`'s, which reads
#: bf16 and float32 against a float64 truth of their own length.
SPLIT_TRAINS = {
    SPLIT_TRAIN: (("float64", SPLIT_SEQ // 8), ("bfloat16", SPLIT_SEQ)),
    "rwkv6-split-all": (("float64", SPLIT_SEQ), ("bfloat16", SPLIT_SEQ),
                        ("float32", SPLIT_SEQ)),
}
#: The serves that share the card at once (the largest with the smallest),
#: and the split train step, whose float64 run wants the card alone.
WORLD_WAVES = (("olmoe", "starcoder2"), ("stablelm", "zamba2"),
               (SPLIT_TRAIN,))
#: The MoE serve's routing against the one-process serve's: in float32
#: the two layouts' router products round apart, so a gate within a step
#: of its neighbour may pick another expert (3 of 33,792, 4 and 5 of
#: 16,896 (token, layer) decisions in three card runs: at most 3.0e-4 of
#: them).  More than this share of differing decisions fails; so does a
#: data rank none of whose batch rows route as the one-process serve's.
ROUTE_FLIP_MAX = 1e-3


def whole(x):
    """A DTensor result whole on this rank: its shards joined, its pending
    sums summed, by the port's own collectives (``distributed/layout``,
    whose all-gather is the blocking one gloo runs on CUDA tensors); a
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import layout
    if not isinstance(x, DTensor):
        return x
    local, mesh = x.to_local(), x.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if p.is_shard():
            local = layout.gather_local(local, mesh, [i], p.dim)
        elif p.is_partial():
            local = layout.all_reduce_local(local, mesh, [i])
    return local


@contextlib.contextmanager
def moe_record(moe, log):
    """Inside the block every MoE layer appends (its routed top-k experts,
    its ``moe_overflow``) to ``log``; a no-op for ``moe`` None."""
    if moe is None:
        yield
        return
    apply, route = moe.moe_apply, moe.route
    picks = []

    def routed(*args):
        out = route(*args)
        picks.append(out[3].cpu())
        return out

    def applied(cfg, p, x, return_aux=False):
        y, aux = apply(cfg, p, x, return_aux=True)
        over = aux["moe_overflow"]
        over = over.to_local() if hasattr(over, "to_local") else over
        log.append((picks.pop(), float(over)))
        return (y, aux) if return_aux else y
    moe.moe_apply, moe.route = applied, routed
    try:
        yield
    finally:
        moe.moe_apply, moe.route = apply, route


def own_shard(t, sharding):
    """This rank's shard of ``t`` laid out by ``sharding``, as a DTensor,
    with no collective (every rank made the same ``t``) and no copy where
    the shard is contiguous (``distribute_tensor`` clones every shard,
    which a float32 olmoe-1b-7b on two ranks of one card has no room
    for)."""
    from torch.distributed.tensor import DTensor
    mesh, placements = sharding.mesh, sharding.placements
    coord, local = mesh.get_coordinate(), t
    for i, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(mesh.size(i), p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _world_serve(rank, world, name):
    """One rank of :func:`world_serve`: the ordinary serve's greedy tokens,
    then the same prompt and tokens through the multi-device layer on the
    world's mesh; returns this rank's record."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.step import make_prefill, make_serve_step
    from repro_torch.kernels import decode_attn as da
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    arch, (_, model_ranks), channels, _, n_layers, dtype = WORLD_SERVES[name]
    cfg = dataclasses.replace(get_config(arch),
                              dtype=str(dtype).removeprefix("torch."))
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    moe = moe if cfg.family == "moe" else None
    mesh = make_host_mesh(model_ranks, device_type="cuda")
    # Every rank makes the same weights from the seed, so each takes its
    # own shard of them with no scatter.
    local = lambda tree, sh: L.map_tree(
        lambda t, h: t if h is None else own_shard(t, h), tree, sh)
    with torch.inference_mode():
        model = Model(cfg, device="cuda")
        params = model.init(SEED)
        prompt = {k: torch.as_tensor(v, device="cuda") for k, v in
                  SyntheticDataset(cfg, BATCH, CHANNEL_PROMPT, seed=SEED + 1)
                  .batch_at(0).items() if k not in ("targets", "loss_mask")}
        s_max = CHANNEL_PROMPT + CHANNEL_GEN
        one = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with moe_record(moe, one):
            want, toks = _serve_loop(model, make_serve_step(model),
                                     make_prefill(model), params, prompt,
                                     model.make_cache(BATCH, s_max),
                                     CHANNEL_GEN, cfg)
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t0
        p = local(params, shd.param_shardings(model, mesh,
                                              shd.decode_rules(mesh, cfg)))
        del params
        cache = model.make_cache(BATCH, s_max)
        c = local(cache, shd.cache_shardings(cfg, mesh, cache,
                                             kv_channels=channels))
        del cache
        rules = {"batch": shd.fsdp_axes(mesh)}
        mine = []
        da.KERNEL.launches = da.PARTIALS.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with context.activation_rules(mesh, rules), moe_record(moe, mine):
            lg, c = make_prefill(model)(
                p, local(prompt, shd.batch_shardings(mesh, prompt)), c)
            got = [whole(lg)]
            for i in range(CHANNEL_GEN):
                sb = dict(tokens=toks[:, i:i + 1], positions=torch.full(
                    (BATCH, 1), c["len"], dtype=torch.int32, device="cuda"))
                lg, c = make_serve_step(model)(
                    p, local(sb, shd.batch_shardings(mesh, sb)), c)
                got.append(whole(lg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = dict(decode_attn=da.KERNEL.launches,
                   decode_attn_partials=da.PARTIALS.launches, wall=wall,
                   one_wall=one_wall,
                   cache=str(c["k"].placements), mesh=str(mesh),
                   layers=cfg.n_layers)
        rows = list(range(BATCH))
        if moe is not None:
            # Each rank routed its own batch rows: their tokens' decisions
            # against the same tokens of the one-process serve's, a count a
            # MoE layer call, every rank's gathered.  The logits gate holds
            # on the rows whose routes all agree (a flipped expert moves a
            # row's logits more than the gate).
            lo = dist.get_rank() * (BATCH // world)
            bad, diffs = set(), []
            for (one_top, _), (top, _) in zip(one, mine):
                per_row = one_top.shape[0] // BATCH
                ref_top = one_top[lo * per_row:lo * per_row + top.shape[0]]
                diff = (ref_top != top).any(-1)
                diffs.append(int(diff.sum()))
                bad.update((lo + diff.nonzero()[:, 0] // per_row).tolist())
            every = [None] * world
            dist.all_gather_object(every, (sorted(bad), diffs))
            bad = set().union(*(set(b) for b, _ in every))
            rows = [r for r in rows if r not in bad]
            rec.update(layer_diff=[sum(d) for d in zip(*(e[1]
                                                         for e in every))],
                       layer_tokens=[t.shape[0] for t, _ in one],
                       bad_rows=sorted(bad),
                       overflow=[o for _, o in mine],
                       overflow_one=[o for _, o in one])
        rec["rows"] = rows
        rec["worst"] = max(((a.float() - b.float())[rows].abs().max().item()
                            for a, b in zip(got, want)), default=0.0) \
            if rows else float("nan")
        rec["agree"] = sum(torch.equal(a[rows].argmax(-1), b[rows].argmax(-1))
                           for a, b in zip(got, want))
        rec["steps"] = len(got)
        rec["finite"] = all(bool(torch.isfinite(a).all()) for a in got)
        return rec


def _world_entry(rank, world, port, out, name):
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=datetime.timedelta(seconds=600))
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        res = (_world_train if name in SPLIT_TRAINS else _world_serve)(
            rank, world, name)
        dist.barrier()
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def world_serve(name):
    """The two-rank serve ``name`` of :data:`WORLD_SERVES` alone:
    :func:`world_serves` of it."""
    return world_serves((name,))[name]


def _start_world(name, tmp):
    """Spawn the ranks of the two-rank serve ``name`` (rank 0 writes its
    record under ``tmp``); returns what :func:`_finish_world` needs."""
    import datetime
    import multiprocessing

    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=600))
    out = Path(tmp) / f"{name}.json"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_world_entry,
                         args=(r, CHANNEL_RANKS, store.port, str(out), name))
             for r in range(CHANNEL_RANKS)]
    for proc in procs:
        proc.start()
    return name, store, procs, out


def world_serves(names):
    """The two-rank serves ``names`` of :data:`WORLD_SERVES` on the card,
    all at once (their ranks share the card and the host; each world's
    wall time is its own under that load): each ``CHANNEL_RANKS`` processes on
    the one card joined by gloo, the named (data, model) mesh, the arch
    at full layer width in its dtype (batch 8, a ``CHANNEL_PROMPT``-token
    prompt, ``CHANNEL_GEN`` steps), parameters by ``decode_rules``, cache
    by ``cache_shardings``, the reference's decode activation rules.  The
    prompt and the ordinary serve's greedy tokens go through
    ``make_prefill`` and ``make_serve_step``.  Rank 0's launches of the
    named K2 build must be exactly steps x attention layers (and none of
    the other), its logits finite and within the path gate of the
    ordinary serve's (``PATH_CHECK``'s gate of the arch in its dtype,
    else stablelm's bf16 gate).  The MoE's logits are held on the batch
    rows whose routing decisions all agree with the ordinary serve's; at
    most ``ROUTE_FLIP_MAX`` of its decisions may differ, every data rank
    keeps a row, and each layer call's ``moe_overflow`` lies within what
    its differing decisions can move (:func:`_check_world`).
    Returns {name: ({kernel: rank 0's launches}, seconds with the
    processes)}."""
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import rwkv_wkv as kw
    # The ranks load what it built.
    build.load_all([da.KERNEL.library, kw.KERNEL.library,
                    kw.KERNEL_BWD.library])
    # The ranks' models need the card: hand back what this process's
    # allocator keeps cached.
    torch.cuda.empty_cache()
    log(f"two-rank serves {list(names)}: this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of the card "
        f"({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        worlds = [_start_world(name, tmp) for name in names]
        try:
            for _, _, procs, _ in worlds:
                for proc in procs:
                    proc.join(900)
        finally:
            for _, _, procs, _ in worlds:
                for proc in procs:
                    if proc.is_alive():
                        proc.kill()
                        proc.join(10)
        seconds = time.perf_counter() - t0
        records = {}
        for name, _, procs, out in worlds:
            codes = [proc.exitcode for proc in procs]
            if codes != [0] * CHANNEL_RANKS or not out.exists():
                fail(f"{name} two-rank serve: ranks exited {codes}")
            records[name] = json.loads(out.read_text())
    log(f"two-rank serves {list(names)}: {seconds:.1f} s with their "
        f"processes, all at once")
    return {name: (_check_world(name, res), seconds)
            for name, res in records.items()}


def _check_world(name, res):
    """:func:`world_serves`' checks of one serve's rank-0 record; returns
    its launches."""
    if name in SPLIT_TRAINS:
        return _check_split_train(res)
    arch, mesh, _, kname, _, dtype = WORLD_SERVES[name]
    tol = PATH_CHECK[arch if PATH_CHECK.get(arch, (None,))[0] == dtype
                     else DENSE_ARCH][1]
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    attn = res["layers"] // cfg.attn_every if cfg.family == "hybrid" \
        else res["layers"]
    want = {"decode_attn": 0, "decode_attn_partials": 0}
    want[kname] = CHANNEL_GEN * attn
    got = {k: res[k] for k in want}
    cut = "" if res["layers"] == cfg.n_layers else \
        f" (depth cut to {res['layers']} of {cfg.n_layers} layers)"
    log(f"{name} two-rank serve: {arch}{cut} {str(dtype)[6:]} on "
        f"{CHANNEL_RANKS} "
        f"gloo ranks of "
        f"one card, mesh {res['mesh']}, cache {res['cache']}: "
        f"{BATCH}x{CHANNEL_PROMPT} prompt and {CHANNEL_GEN} steps on the "
        f"ordinary serve's tokens: rank 0 launched {got} (expected {want}); "
        f"max|dlogit| {res['worst']:.4e} against the ordinary serve on "
        f"{len(res['rows'])} of {BATCH} batch rows (tol {tol}), argmax "
        f"equal in {res['agree']} of {res['steps']} steps; "
        f"{res['wall']:.2f} s, one process on ordinary tensors "
        f"{res['one_wall']:.2f} s, {res['wall'] / res['one_wall']:.2f}x "
        f"(host clock, prefill and steps, the other serve of its wave "
        f"sharing the card; {_then(name)})")
    if got != want:
        fail(f"{name} two-rank serve: launches {got}, want {want}")
    if not res["finite"]:
        fail(f"{name} two-rank serve: non-finite logits")
    if "overflow" in res:
        _check_routes(name, res, mesh[0])
    if not res["worst"] <= tol:
        fail(f"{name} two-rank serve: logits differ by {res['worst']} "
             f"(tol {tol})")
    return got


def _check_routes(name, res, data_ranks):
    """The MoE serve's routing against the one-process serve's.  A fault
    of one rank's tokens either moves their routes in the layers after it
    (more than ``ROUTE_FLIP_MAX`` of the decisions, or every row of that
    data rank) or leaves their routes and moves their logits, which the
    logits gate reads on the rows that route alike.  ``moe_overflow`` is
    held in every layer call: a (token, slot) moved from expert a to b
    changes the dropped slots by at most one (a's count above the capacity
    falls by at most one, b's rises by at most one), so a token whose k
    choices differ moves the dropped share of the t x k slots by at most
    k / (t k) = 1 / t; the two layouts' means may round one float32 step
    apart."""
    n_diff, n_all = sum(res["layer_diff"]), sum(res["layer_tokens"])
    if len(res["layer_diff"]) != len(res["layer_tokens"]) or \
            len(res["overflow"]) != len(res["overflow_one"]):
        fail(f"{name} two-rank serve: {len(res['overflow'])} MoE layer calls "
             f"against the ordinary serve's {len(res['overflow_one'])}")
    moved = [abs(a - b) for a, b in zip(res["overflow"], res["overflow_one"])]
    worst = max(m - d / t for m, d, t in zip(moved, res["layer_diff"],
                                             res["layer_tokens"]))
    per_rank = BATCH // data_ranks
    kept = sorted({r // per_rank for r in res["rows"]})
    log(f"{name} two-rank serve: {n_diff} of {n_all} (token, layer) routing "
        f"decisions differ from the ordinary serve's ({n_diff / n_all:.3e}, "
        f"max {ROUTE_FLIP_MAX}), in batch rows {res['bad_rows']}; data ranks "
        f"with rows held to its logits {kept} of {data_ranks}; moe_overflow "
        f"of {len(moved)} layer calls within {max(moved):.3e} of the "
        f"ordinary serve's (|difference| less its bound at most "
        f"{worst:.3e})")
    if n_diff > ROUTE_FLIP_MAX * n_all:
        fail(f"{name} two-rank serve: {n_diff} of {n_all} routing decisions "
             f"differ from the ordinary serve's (max {ROUTE_FLIP_MAX})")
    if kept != list(range(data_ranks)):
        fail(f"{name} two-rank serve: every batch row of data ranks "
             f"{sorted(set(range(data_ranks)) - set(kept))} routes otherwise "
             f"than the ordinary serve")
    if worst > 1e-6:
        fail(f"{name} two-rank serve: moe_overflow {res['overflow']} against "
             f"{res['overflow_one']}, more than its differing decisions "
             f"{res['layer_diff']} of {res['layer_tokens']} tokens allow")


@contextlib.contextmanager
def float64_witness():
    """Inside the block a model may be float64 (``dtype="float64"``), and
    ``Tensor.float()`` of a floating tensor gives float64: the port's
    float32 math (the norms, the WKV's states, the loss) then runs in
    float64 too, so two orders of the same sums agree to float64's
    rounding.  Only the plain versions run there (K3 and K3b take bf16
    and float32)."""
    from repro_torch.models import model as M
    own = "float" in vars(torch.Tensor)
    saved = torch.Tensor.float

    def wide(self, *args, **kwargs):
        return self.double() if self.is_floating_point() else \
            saved(self, *args, **kwargs)
    torch.Tensor.float = wide
    M.DTYPES["float64"] = torch.float64
    try:
        yield
    finally:
        if own:
            torch.Tensor.float = saved
        else:
            del torch.Tensor.float
        del M.DTYPES["float64"]


def _world_train(rank, world, name):
    """One rank of the split train step ``name`` (:data:`SPLIT_TRAINS`),
    each of its runs at full depth: rank 0 first runs one process's step on
    the whole sequences (loss and gradients, its K3/K3b launches counted);
    then every rank runs its half of each sequence through ``Model.loss``
    and the gradients under the ``seq_pair`` rule, its launches counted,
    and rank 0 compares the loss, the gradient norm and every gradient
    leaf (gathered whole, one at a time) with the one-process step's, and
    both steps' with the float64 one-process step's.  Returns rank 0's
    records, a list in run order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed import context, layout
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step as pstep
    from repro_torch.kernels import rwkv_wkv as kw
    from repro_torch.launch.dryrun import fold_pod
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model

    full = init_device_mesh("cuda", (world, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    mesh = fold_pod(full)
    pair = layout.SeqPair.over(full)
    kernels = {"wkv": kw.KERNEL, "wkv_bwd": kw.KERNEL_BWD}
    counts = lambda: {k: kern.launches for k, kern in kernels.items()}
    # |a - b| over b's largest element, and the sum of squares, in float64.
    share = lambda a, b: ((a.double() - b.double()).abs().max() /
                          b.double().abs().max().clamp(min=1e-300)).item()
    sq = lambda t: t.double().square().sum().item()
    runs = SPLIT_TRAINS[name]
    truth, known, out = {}, {}, []
    for i, (dtype, seq) in enumerate(runs):
        plain = SPLIT_RUNS[dtype][0]
        with float64_witness() if dtype == "float64" else \
                contextlib.nullcontext():
            cfg = dataclasses.replace(get_config(SSM_ARCH), dtype=dtype)
            model = Model(cfg)
            # The same weights in every run: bf16's values, which float32
            # and float64 hold exactly, so that the float64 step is the
            # truth of each run's own rounding.
            params = L.map_tree(lambda t: t.to(model.dtype), Model(
                dataclasses.replace(cfg, dtype="bfloat16")).init(SEED))
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                     SyntheticDataset(cfg, SPLIT_BATCH, seq,
                                      seed=SEED + 1).batch_at(0).items()}
            rec = {"dtype": dtype, "seq": seq, "mesh": str(mesh),
                   "pair": repr(pair), "layers": cfg.n_layers}
            held = dtype != "float64" and known.get("seq") == seq
            torch.cuda.reset_peak_memory_stats()
            if rank == 0:
                for kern in kernels.values():
                    kern.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want_loss, _, want = loss_and_grads(model, params, batch,
                                                    plain)
                torch.cuda.synchronize()
                rec.update(one_wall=time.perf_counter() - t0,
                           one=counts())
                want = dict(L.flatten_tree(want, torch.is_tensor))
                for _, t in L.flatten_tree(params, torch.is_tensor):
                    t.requires_grad_(False)
            dist.barrier()
            p = L.map_tree(own_shard, params, shd.param_shardings(
                model, mesh, shd.train_rules(mesh, cfg)))
            del params
            for _, t in L.flatten_tree(p, torch.is_tensor):
                t.requires_grad_(True)
            split = shd.split_sequences(full, batch, world)
            b = L.map_tree(own_shard, split,
                           shd.batch_shardings(mesh, split))
            rules = {"batch": shd.fsdp_axes(mesh), "seq_pair": pair}
            for kern in kernels.values():
                kern.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with context.activation_rules(mesh, rules):
                loss, _ = model.loss(p, b, plain_kernels=plain)
                grads = pstep._grads(loss, p)
            torch.cuda.synchronize()
            rec["wall"] = time.perf_counter() - t0
            every = [None] * world
            dist.all_gather_object(every, counts())
            rec.update(split=every, loss=whole(loss).item(),
                       peak=torch.cuda.max_memory_allocated() / 2**30)
            del p, b, loss
            shares, equal, norm_sq, want_sq = {}, 0, 0.0, 0.0
            far, one_far = {}, {}
            for path, g in L.flatten_tree(grads, torch.is_tensor):
                g = whole(g)
                if rank == 0:
                    w = want.pop(path)
                    shares[path] = share(g, w)
                    equal += torch.equal(g, w)
                    norm_sq, want_sq = norm_sq + sq(g), want_sq + sq(w)
                    if dtype == "float64" and any(
                            s == seq for _, s in runs[i + 1:]):
                        truth[path] = w
                    elif held:
                        far[path] = share(g, truth[path])
                        one_far[path] = share(w, truth[path])
                del g
            del grads
        if rank == 0:
            rec.update(want_loss=want_loss, finite=math.isfinite(rec["loss"]),
                       gnorm=math.sqrt(norm_sq), want_gnorm=math.sqrt(want_sq),
                       shares=shares, equal_leaves=equal, far=far,
                       one_far=one_far)
            if dtype == "float64":
                known = dict(seq=seq, loss=want_loss,
                             gnorm=math.sqrt(want_sq))
            elif held:
                rec.update(truth_loss=known["loss"],
                           truth_gnorm=known["gnorm"])
        out.append(rec)
        del model
        torch.cuda.empty_cache()
    return out


def _check_split_train(res):
    """The split train step's checks of rank 0's records
    (:func:`_world_train`), each run at full depth (``SPLIT_RUNS``): each
    rank's K3 and K3b launches equal the one-process step's (2 and 1 a
    layer under remat "full", each layer's forward and its recompute, and
    its backward: 48 and 24; none on the plain path); the loss, the
    gradient norm and every gradient leaf within the run's bounds of the
    one-process step's; and, below float64 where a float64 run of the same
    length came first, the split step's leaves and norm no farther from
    that truth than ``SPLIT_ROUNDING`` times the one-process step's.  ``TRAIN_PATH_TOL`` is reported against.
    Returns the launches of rank 0 summed over the runs."""
    launched = {"wkv": 0, "wkv_bwd": 0}
    for rec in res:
        n, (plain, tol) = rec["layers"], SPLIT_RUNS[rec["dtype"]]
        want = {"wkv": 0, "wkv_bwd": 0} if plain else \
            {"wkv": 2 * n, "wkv_bwd": n}
        worst = sorted(((x, p) for p, x in rec["shares"].items()),
                       reverse=True)
        rel = {"loss": abs(rec["loss"] / rec["want_loss"] - 1),
               "gnorm": abs(rec["gnorm"] / rec["want_gnorm"] - 1),
               "leaf": worst[0][0]}
        bounds = ", ".join(
            f"{k} {rel[k]:.2e} (tol {tol[k]}"
            f"{'' if plain else ', TRAIN_PATH_TOL ' + str(TRAIN_PATH_TOL[k])})"
            for k in rel)
        line = (f"split train step: {SSM_ARCH} {rec['dtype']} "
                f"({'plain path' if plain else 'K3/K3b'}) at full width and "
                f"depth ({n} layers), B{SPLIT_BATCH} x T{rec['seq']} split in "
                f"halves over {rec['mesh']} ({rec['pair']} on rank 0) of "
                f"{CHANNEL_RANKS} gloo ranks of one card: launches by rank "
                f"{rec['split']}, the one-process step's {rec['one']} "
                f"(expected {want} each); loss {rec['loss']:.9g} vs "
                f"{rec['want_loss']:.9g}, grad norm {rec['gnorm']:.9g} vs "
                f"{rec['want_gnorm']:.9g}; against one process: {bounds}; "
                f"worst leaves "
                f"{', '.join(f'{p} {x:.1e}' for x, p in worst[:3])}, "
                f"{rec['equal_leaves']} of {len(worst)} bit-equal")
        far = None
        if rec["far"]:
            far = {
                "leaf": (max(rec["far"].values()),
                         max(rec["one_far"].values())),
                "gnorm": (abs(rec["gnorm"] / rec["truth_gnorm"] - 1),
                          abs(rec["want_gnorm"] / rec["truth_gnorm"] - 1))}
            line += ("; from the float64 truth (split / one process, at "
                     f"most {SPLIT_ROUNDING}x): " + ", ".join(
                         f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in
                         far.items()) + ", loss "
                     f"{abs(rec['loss'] / rec['truth_loss'] - 1):.2e} / "
                     f"{abs(rec['want_loss'] / rec['truth_loss'] - 1):.2e}")
        log(f"{line}; {rec['wall']:.2f} s the split step, "
            f"{rec['one_wall']:.2f} s the one-process step, "
            f"{rec['wall'] / rec['one_wall']:.2f}x (host clock; "
            f"{_then('split ' + rec['dtype'])}), peak {rec['peak']:.2f} GiB "
            f"on rank 0")
        if rec["one"] != want or any(r != want for r in rec["split"]):
            fail(f"split train step ({rec['dtype']}): launches "
                 f"{rec['split']} (one process {rec['one']}), want {want} "
                 f"on every rank")
        if not rec["finite"] or any(
                tol[k] is not None and rel[k] > tol[k] for k in rel):
            fail(f"split train step ({rec['dtype']}): loss, grad norm or a "
                 f"gradient leaf out of its bound against the one-process "
                 f"step")
        if far and any(a > SPLIT_ROUNDING * b for a, b in far.values()):
            fail(f"split train step ({rec['dtype']}): farther from the "
                 f"float64 truth than {SPLIT_ROUNDING} x the one-process "
                 f"step")
        for k in launched:
            launched[k] += rec["split"][0][k]
    return launched


def wkv_split_check(kw):
    """In bf16 and in float32: K3 over the split train step's T in two
    launches (the first half from s0, the second from its final state)
    against one launch over T, y and the final state, each element within
    ``WKV_TOL``; K3b in two
    launches in the reverse order (the second half's initial-state
    gradient handed to the first as its final-state gradient) against one
    launch, every output within ``WKV_TOL``'s atol plus its rtol of the
    output's largest element (du, a sum over time of terms of both signs,
    is the halves' two sums added: the order moves its small elements by
    more than their own 1e-4, read on the card at 6.7e-4 against a
    largest element of 1.27e3).  Bit-equality is reported.  Returns the
    largest |difference|."""
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst = max(worst, _wkv_split_check(kw, dtype))
    return worst


def _wkv_split_check(kw, dtype):
    shape = (SPLIT_BATCH, SPLIT_SEQ) + TRAIN_SHAPE[2:]
    half = SPLIT_SEQ // 2
    r, k, v, w, u, s0 = rand_wkv(*shape, dtype, "model", seed=31)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    dy = torch.randn(shape, generator=gen, device="cuda")
    ds_t = torch.randn(s0.shape, generator=gen, device="cuda")
    part = lambda x, sl: x[:, sl].contiguous()
    first, second = slice(0, half), slice(half, None)
    y, s = kw.wkv(r, k, v, w, u, s0)
    y0, s_mid = kw.wkv(*(part(x, first) for x in (r, k, v, w)), u, s0)
    y1, s_end = kw.wkv(*(part(x, second) for x in (r, k, v, w)), u, s_mid)
    g = kw.wkv_bwd(r, k, v, w, u, s0, dy, ds_t)
    g1 = kw.wkv_bwd(*(part(x, second) for x in (r, k, v, w)), u, s_mid,
                    part(dy, second), ds_t)
    g0 = kw.wkv_bwd(*(part(x, first) for x in (r, k, v, w)), u, s0,
                    part(dy, first), g1[5])
    torch.cuda.synchronize()
    pairs = {"y": (torch.cat([y0, y1], dim=1), y), "state": (s_end, s)}
    for i, name in enumerate(WKV_BWD_OUTPUTS[:4]):
        pairs[name] = (torch.cat([g0[i], g1[i]], dim=1), g[i])
    pairs["du"] = (g0[4] + g1[4], g[4])
    pairs["ds0"] = (g0[5], g[5])
    worst = 0.0
    for name, (a, b) in pairs.items():
        err = (a.float() - b.float()).abs().max().item()
        worst = max(worst, err)
        top = b.float().abs().max().item()
        ok = torch.allclose(a.float(), b.float(), **WKV_TOL) if name in (
            "y", "state") else err <= WKV_TOL["atol"] + WKV_TOL["rtol"] * top
        log(f"  {'K3' if name in ('y', 'state') else 'K3b'} {name} over "
            f"{shape} {str(dtype)[6:]} in two launches at {half} vs one: "
            f"max|diff| {err:.3e} "
            f"(|x| <= {top:.3g}), "
            f"{'bit-equal' if torch.equal(a, b) else 'not bit-equal'}"
            f"{'' if ok else ' MISMATCH'}")
        if not ok:
            fail(f"the two-launch chain's {name} differs from one launch "
                 f"(atol {WKV_TOL['atol']}, rtol {WKV_TOL['rtol']})")
    return worst


#: Phase 11's dry-run cells, each on the fake (32, 8) world (or, marked
#: multi-pod, (2, 32, 8)) in a process of its own, all at once.
MESH_DRYRUN_CELLS = ((DENSE_ARCH, "decode_32k", False),
                     (DENSE_ARCH, "train_4k", False),
                     (MOE_ARCH, "train_4k", False),
                     (SSM_ARCH, "train_4k", False),
                     (HYBRID_ARCH, "decode_32k", False),
                     (SSM_ARCH, "prefill_32k", True),
                     (DENSE_ARCH, "prefill_32k", True))
#: Each dry-run cell's FLOPs and collective bytes a chip on the CPU's torch
#: 2.13 (``tools/dryrun_products.py --all``).  The models run on local
#: tensors with the port's own splits and collectives
#: (``distributed/context``) and the optimizer's norm on local shards, so
#: the card's torch 2.11 must read the same counts, within
#: ``DRYRUN_FLOPS_BAND`` and ``DRYRUN_COLL_BAND``.
DRYRUN_TORCH_213 = {
    (DENSE_ARCH, "decode_32k", False): (4659871744.0, 2793472.0),
    (DENSE_ARCH, "train_4k", False): (56384330661888.0, 17107527828.0),
    (MOE_ARCH, "train_4k", False): (53659173912576.0, 227631083668.0),
    (SSM_ARCH, "train_4k", False): (47004122087424.0, 56082765972.0),
    (HYBRID_ARCH, "decode_32k", False): (4829265920.0, 9088160.0),
    (SSM_ARCH, "prefill_32k", True): (23502061043712.0, 28446331988.0),
    (DENSE_ARCH, "prefill_32k", True): (74371653697536.0, 10926890068.0)}
DRYRUN_FLOPS_BAND = (0.9999, 1.0001)
DRYRUN_COLL_BAND = (0.9999, 1.0001)


def start_dryrun_cells(cells=MESH_DRYRUN_CELLS):
    """Start dry-run cells (arch, shape, multi-pod) on the (32, 8) mesh of
    a fake 256-rank world or the (2, 32, 8) mesh of a 512-rank one, each
    in a process of its own (the fake world never shares a process with
    NCCL; no card), all at once; decode cells lay the cache out
    channelized.  :func:`finish_dryrun_cells` reads them."""
    import os
    out = HERE / "dryrun_out"
    return time.perf_counter(), out, [(arch, shape, multi, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out)] +
        (["--multi-pod"] if multi else []), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=HERE,
        env={**os.environ, "PYTHONPATH": str(HERE / "src")}))
        for arch, shape, multi in cells]


def finish_dryrun_cells(started):
    """Wait for the cells :func:`start_dryrun_cells` started; each must
    read ``ok``, and its FLOP, collective and argument line is printed;
    its FLOPs and collective bytes a chip must lie within
    ``DRYRUN_FLOPS_BAND`` and ``DRYRUN_COLL_BAND`` of the CPU's torch 2.13
    (``DRYRUN_TORCH_213``)."""
    t0, out, runs = started
    results = []
    for arch, shape, multi, run in runs:
        mesh = "2x32x8" if multi else "32x8"
        try:
            _, err = run.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            run.kill()
            run.communicate()
            fail(f"dry run {arch} {shape} {mesh}: no result in 600 s")
        path = out / f"{arch}__{shape}__{mesh}__baseline.json"
        res = json.loads(path.read_text()) if path.exists() else {
            "status": "missing", "error": ""}
        if run.returncode != 0 or res["status"] != "ok":
            fail(f"dry run {arch} {shape} {mesh}: exit {run.returncode}, "
                 f"{res['status']}: {res['error']}\n{err[-2000:]}")
        flops, coll = DRYRUN_TORCH_213[(arch, shape, multi)]
        got = (res["flops_per_chip"] / flops,
               res["collectives"]["total"] / coll)
        log(f"dry run {arch} {shape} on the fake {mesh.replace('x', ', ')} "
            f"world: {res['flops_per_chip']:.4e} FLOP a chip ({got[0]:.6f} "
            f"of torch 2.13's {flops:.4e}), collectives "
            f"{res['collectives']['total']:.4e} B a chip ({got[1]:.6f} of "
            f"{coll:.4e}), argument bytes "
            f"{res['memory']['argument_bytes'] / 2**30:.2f} GiB a chip, "
            f"sequences in {res.get('seq_parts', 1)} part(s), "
            f"{res['seconds']:.1f} s in the cell")
        for what, ratio, (lo, hi) in (("FLOP", got[0], DRYRUN_FLOPS_BAND),
                                      ("collective B", got[1],
                                       DRYRUN_COLL_BAND)):
            if not lo <= ratio <= hi:
                fail(f"dry run {arch} {shape} {mesh}: {what} a chip "
                     f"{ratio:.4f} of torch 2.13's, outside {lo}-{hi}")
        results.append(res)
    log(f"dry run: {len(runs)} cells in {time.perf_counter() - t0:.1f} s "
        f"with their processes")
    return results


def partials_phase():
    """K2's partial build alone: its phase-2 checks (:func:`check_all_partials`
    at the served decode shapes) and its phase-5 time on one rank's slice
    of the mistral layer beside the whole-cache K2.  Alone: ``python3 -c
    "import chip_smoke; chip_smoke.partials_phase()"``."""
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card; this script runs only on one")
    from repro_torch.configs import get_config
    from repro_torch.core import hw
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ops, ref
    served = []
    for arch in (DENSE_ARCH, MOE_ARCH, HYBRID_ARCH, VLM_ARCH):
        cfg = get_config(arch)
        served.append((BATCH, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, PROMPT + GEN))
    err = check_all_partials(da, ops, ref, served + [(8, 24, 2, 128, 4096)])
    spec = hw.spec_for(torch.cuda.get_device_name(0))
    whole = decode_attn_timing(da, ref, PLAN_LAYER_SHAPE,
                               PLAN_LAYER_SHAPE[-1], 9, spec)
    piece = decode_attn_timing(da, ref, PIECE_SHAPE, PIECE_SHAPE[-1], 19,
                               spec, partials=True)
    log(f"decode_attn_partials on one rank's slice ({PIECE_SHAPE[-1]} keys): "
        f"{piece['ms']:.5f} ms against the whole-cache K2's "
        f"{whole['ms']:.5f} ms, {piece['bound_ms'] / piece['ms']:.3f} of its "
        f"bound; max|err| {err:.3e}")
    return err, piece


def mesh_phase():
    """Phase 11, the multi-device layer on the card: the DES through
    ``core/shardsim`` (``devices="auto"`` against ``None``); stablelm-1.6b
    served through DTensor on a one-rank NCCL world's (1, 1) mesh against
    the same serve on ordinary tensors, 768 K2 launches; int8_all_reduce
    on that world; the two-rank serves of :data:`WORLD_SERVES` on gloo
    ranks of the card (:func:`world_serves`), two at a time
    (``WORLD_WAVES``), while the dry-run cells run, each in a process of its
    own.  Returns the launches by kernel.  Alone:
    ``python3 -c "import chip_smoke; chip_smoke.mesh_phase()"``; one
    two-rank serve alone: ``chip_smoke.world_serve("olmoe")``."""
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card; this script runs only on one")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import memsim_scan as ms
    from repro_torch.kernels import rwkv_wkv as kw
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    kernels = dict(serve.PATH_KERNELS["dense"])
    kernels.update(ms.KERNELS)
    build.load_all([kern.library for kern in kernels.values()] +
                   [kw.KERNEL.library, kw.KERNEL_BWD.library])
    launches = mesh_des_check(kernels)
    launches["decode_attn"] = mesh_serve(get_config(DENSE_ARCH), kernels)
    launches.update(decode_attn_partials=0, wkv=0, wkv_bwd=0)
    wkv_split_check(kw)
    # The dry-run cells (host only) and the two-rank serves and the split
    # train step run at once.
    dry = start_dryrun_cells()
    for wave in WORLD_WAVES:
        for got, _ in world_serves(wave).values():
            for kname, n in got.items():
                launches[kname] += n
    finish_dryrun_cells(dry)
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s (host clock; "
        f"{_then('phase 11')})")
    return launches


def split_phase():
    """Phase 11's split sequences alone: K3's and K3b's two-launch chains
    against one launch (:func:`wkv_split_check`), the split train step
    (:data:`SPLIT_TRAIN`) while the multi-pod ``prefill_32k`` dry-run
    cells run.  Returns rank 0's launches.  Alone: ``python3 -c "import
    chip_smoke; chip_smoke.split_phase()"``."""
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card; this script runs only on one")
    from repro_torch.kernels import build
    from repro_torch.kernels import rwkv_wkv as kw
    t_phase = time.perf_counter()
    build.load_all([kw.KERNEL.library, kw.KERNEL_BWD.library])
    wkv_split_check(kw)
    dry = start_dryrun_cells([c for c in MESH_DRYRUN_CELLS if c[2]])
    got, _ = world_serves(("rwkv6-split-all",))["rwkv6-split-all"]
    finish_dryrun_cells(dry)
    log(f"split phase took {time.perf_counter() - t_phase:.1f} s (host "
        f"clock)")
    return got


def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card; this script runs only on one")

    from repro_torch.configs import get_config
    from repro_torch.core import hw
    from repro_torch.kernels import build, ops, ref
    from repro_torch.core import memsim, threefry
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import memsim_scan as ms
    from repro_torch.kernels import rwkv_wkv as kw
    from repro_torch.kernels import stream as ks
    from repro_torch.launch import serve, train
    from repro_torch.launch import stream as probe

    # -- phase 1: the card and the build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    spec = hw.spec_for(name)
    peak_bw, peak_bf16, peak_f32 = \
        spec.hbm_bw, spec.peak_bf16_flops, spec.peak_fp32_flops
    log(f"torch {torch.__version__} cuda {torch.version.cuda} card {name} "
        f"({spec.part} peaks: {peak_bw / 1e12} TB/s, {peak_bf16 / 1e12} "
        f"TFLOP/s bf16 tensor cores, {peak_f32 / 1e12} TFLOP/s fp32)")
    kernels = {kname: kern for family in serve.PATH_KERNELS.values()
               for kname, kern in family.items()}
    for family in train.PATH_KERNELS.values():
        kernels.update(family)
    kernels.update(ks.KERNELS)
    kernels.update(ms.KERNELS)
    kernels["decode_attn_partials"] = da.PARTIALS
    t0 = time.time()
    build.load_all([kern.library for kern in kernels.values()])
    log(f"built the kernels {sorted(kernels)} in {time.time() - t0:.1f} s")
    for lib in dict.fromkeys(kern.library for kern in kernels.values()):
        for line in lib.ptxas_log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  ptxas {lib.name}: {line.strip()}")
    for kern in kernels.values():
        kern.fn()

    # -- phase 2: each kernel against its plain version -------------------
    dense = get_config(DENSE_ARCH)
    ssm = get_config(SSM_ARCH)
    moe_cfg = get_config(MOE_ARCH)
    d = dense.resolved_head_dim
    s_max = PROMPT + GEN
    slice_shape = (BATCH, dense.n_heads, dense.n_kv_heads, d, s_max)
    moe_shape = (BATCH, moe_cfg.n_heads, moe_cfg.n_kv_heads,
                 moe_cfg.resolved_head_dim, s_max)
    gqa_shape = (8, 24, 2, 128, 4096)       # starcoder2-3b's attention
    hybrid = get_config(HYBRID_ARCH)        # zamba2-2.7b: head dim 80
    hybrid_shape = (BATCH, hybrid.n_heads, hybrid.n_kv_heads,
                    hybrid.resolved_head_dim, s_max)
    vlm = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    vlm_shape = (BATCH, vlm.n_heads, vlm.n_kv_heads, vlm.resolved_head_dim,
                 s_max)                     # qwen2-vl-72b: G 8, D 128
    plan_s = PLAN_LAYER_SHAPE[-1]
    path_err = {"decode_attn": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, seed in ((slice_shape, 1), (moe_shape, 6),
                            (hybrid_shape, 11), (vlm_shape, 21)):
            err = check_decode_attn(
                da, ref, shape, dtype,
                [1, 333, PROMPT + 1, PROMPT + 17, s_max], seed=seed)
            if dtype == torch.bfloat16:
                path_err["decode_attn"] = max(path_err["decode_attn"], err)
        check_decode_attn(da, ref, gqa_shape, dtype, [1, 1000, 4095, 4096],
                          seed=2)
        check_decode_attn(da, ref, PLAN_LAYER_SHAPE, dtype,
                          [1, 2, 4097, plan_s - 1001, plan_s], seed=7)
        # Most parts empty: lengths 1 and 2 at 32k in all 16 parts.
        check_decode_attn(da, ref, PLAN_LAYER_SHAPE, dtype, [1, 2, 65],
                          seed=12, parts=da.MAX_PARTS)
        # One either side of a tile and of a part boundary, in the parts
        # the full cache is split into.
        for shape, seed in ((gqa_shape, 13), (PLAN_LAYER_SHAPE, 14),
                            (vlm_shape, 23)):
            cut, edges = split_edges(da, shape)
            log(f"  {shape}: full cache split into {cut.parts} parts of "
                f"{cut.part_keys} keys; edges {edges}")
            check_decode_attn(da, ref, shape, dtype, edges, seed=seed,
                              parts=cut.parts)
            # The same lengths, then lengths that leave the last part one
            # key or end a part, with the boundary keys dominant.
            t = da.TILE_KEYS
            check_boundary_keys(
                da, ref, shape, dtype,
                edges + [(cut.parts - 1) * t + 1, cut.parts * t - 1,
                         cut.parts * t, cut.parts * t + 1, shape[-1]],
                seed=seed + 2, parts=cut.parts)
        check_boundary_keys(da, ref, PLAN_LAYER_SHAPE, dtype,
                            [1, 65, 961, 1024, 1025, plan_s // 2 + 1, plan_s],
                            seed=17, parts=da.MAX_PARTS)
        check_boundary_keys(da, ref, PLAN_LAYER_SHAPE, dtype,
                            [1000, plan_s // 2 + 1, plan_s - 1, plan_s],
                            seed=18)
        check_back_to_back(da, ref, [
            (gqa_shape, [4096, 1, 1000]), (slice_shape, [PROMPT + 16, 7]),
            (PLAN_LAYER_SHAPE, [plan_s, 2]),
            (hybrid_shape, [PROMPT + 16, 65]),
            (vlm_shape, [PROMPT + 16, 300])], dtype, seed=20)

    path_err["decode_attn_partials"] = check_all_partials(
        da, ops, ref, [slice_shape, moe_shape, hybrid_shape, vlm_shape,
                       gqa_shape])
    h, hd = ssm.rwkv_heads, ssm.rwkv_head_dim
    path_err["wkv"] = 0.0
    seed = 10
    for dtype in (torch.bfloat16, torch.float32):
        # The kernel's chunk of tc steps: lengths at its edges, and cuts
        # exactly at a chunk's edge.
        tc = kw.geometry(dtype, (BATCH, PROMPT, h, hd))["chunk_steps"]
        for decay in ("model", "sigmoid"):
            for t in (1, 7, tc - 1, tc, tc + 1, 2 * tc + 1, 128, 1000,
                      PROMPT):
                seed += 1
                err = check_wkv(kw, ref, (BATCH, t, h, hd), dtype, decay,
                                seed, cuts=(tc, 2 * tc))
                if dtype == torch.bfloat16 and decay == "model":
                    path_err["wkv"] = max(path_err["wkv"], err)
            seed += 1
            check_wkv(kw, ref, (2, 40, 4, 16), dtype, decay, seed)  # smoke
    # wkv's backward (K3b): segment edges, both decays, ds_T 0 and not.
    path_err["wkv_bwd"] = check_wkv_bwd_cases(kw, ref)
    # STREAM: the reference's test shapes, ragged n (not a multiple of the
    # 16-byte vector, and shorter than one), and the probe's size.
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((128, 128), (512, 256), (1024, 384), (2048, 128),
                      (300, 128), (1,), (7,), (4099,), (2**20 + 3,),
                      (1000003,), (STREAM_N,)):
            seed += 1
            errs = check_stream(ks, ref, shape, dtype, seed)
            if shape == (STREAM_N,) and dtype == torch.float32:
                path_err.update({f"stream_{op}": e for op, e in errs.items()})
    # memsim's two scans, bit for bit, on stage-A draws made on the card.
    path_err["memsim"] = check_memsim_scans(ms, ref, memsim, threefry, seed)

    # -- phases 3 and 4: each serving path through serve.main, then held
    # kernel path against plain path and timed ------------------------------
    launches, step_launch_ms = serve_phase()

    # The STREAM probe: its own size, then the reference's shape in L2.
    none = dict.fromkeys(kernels, 0)
    for kern in kernels.values():
        kern.launches = 0
    probed = probe.main(["--n", str(STREAM_N), "--iters", str(STREAM_ITERS),
                         "--seed", str(SEED)])
    counts = {kname: kern.launches for kname, kern in kernels.items()}
    per_op = 2 * (probe.WARMUP + STREAM_ITERS)
    expected = {**none, **{f"stream_{op}": per_op for op in STREAM_OPS}}
    log(f"STREAM probe: kernel launches {counts} (expected {expected})")
    if counts != expected:
        fail(f"STREAM probe: launch counts {counts} != {expected}")
    for op in STREAM_OPS:
        launches[f"stream_{op}"] = counts[f"stream_{op}"]
        frac = probed[op]["hbm_fraction"]
        if frac is None or not 0.0 < frac <= 1.0:
            fail(f"STREAM probe {op}: HBM fraction {frac} outside (0, 1]")
        log(f"STREAM probe {op}: {probed[op]['gbps']:.1f} GB/s best of "
            f"{STREAM_ITERS}, {frac:.4f} of {peak_bw / 1e12} TB/s (mean "
            f"{probed[op]['mean_ms']:.5f} ms, best "
            f"{probed[op]['best_ms']:.5f} ms, L2-resident reference shape "
            f"{probed[op]['l2_mean_ms']:.5f} ms)")

    # -- phase 5: kernel time, bound, plain and library ----------------------
    # K2 at stablelm-1.6b's decode (the JSON line's numbers), starcoder2-3b's
    # (G 12 over Hk 2), olmoe-1b-7b's (D 128, G 1), zamba2-2.7b's (D 80),
    # qwen2-vl-72b's (D 128, G 8) and the planner's mistral-large layer at
    # 32k (G 12): phase 6 holds the planner's memory term to the last.
    k2 = decode_attn_timing(da, ref, slice_shape, PROMPT + GEN // 2, 3,
                            spec)
    dev = step_launch_ms[DENSE_ARCH]
    log(f"decode_attn on the decode steps of phase 4 (context "
        f"{PROMPT + 1}..{PROMPT + 8}): "
        f"{'not measured' if dev is None else f'{dev:.5f} ms a launch'}")
    decode_attn_timing(da, ref, gqa_shape, gqa_shape[-1], 4, spec)
    decode_attn_timing(da, ref, moe_shape, PROMPT + GEN // 2, 8, spec)
    dev = step_launch_ms[MOE_ARCH]
    log(f"decode_attn on olmoe-1b-7b's decode steps of phase 4: "
        f"{'not measured' if dev is None else f'{dev:.5f} ms a launch'}")
    for shape, arch, seed in ((hybrid_shape, HYBRID_ARCH, 10),
                              (vlm_shape, VLM_ARCH, 22)):
        decode_attn_timing(da, ref, shape, PROMPT + GEN // 2, seed, spec)
        dev = step_launch_ms[arch]
        log(f"decode_attn on {arch}'s decode steps of phase 4: "
            f"{'not measured' if dev is None else f'{dev:.5f} ms a launch'}")
    plan_k2 = decode_attn_timing(da, ref, PLAN_LAYER_SHAPE, plan_s, 9, spec)
    # The partial build on one rank's slice of that layer: what each of the
    # 8 model ranks of (32, 8) reads of a channelized cache.
    piece = decode_attn_timing(da, ref, PIECE_SHAPE, PIECE_SHAPE[-1], 19,
                               spec, partials=True)
    log(f"decode_attn_partials on one rank's slice ({PIECE_SHAPE[-1]} keys): "
        f"{piece['ms']:.5f} ms against the whole-cache K2's "
        f"{plan_k2['ms']:.5f} ms ({plan_k2['ms'] / piece['ms']:.2f}x), "
        f"{piece['bound_ms'] / piece['ms']:.3f} of its bound")
    entries = [{
        "name": "decode_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn.py:34",
        "launches": launches["decode_attn"],
        "max_abs_err": path_err["decode_attn"],
        **k2}, {
        "name": "decode_attn_partials", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn.py:34",
        "launches": 0, "max_abs_err": path_err["decode_attn_partials"],
        **piece}]

    # wkv at the prefill shape (the JSON line's numbers) and at a decode
    # step.  The plain version at T = PROMPT is a Python loop over time:
    # fewer iterations.  No single PyTorch call computes the recurrence.
    # Events time back-to-back calls, so a launch shorter than the
    # wrapper's host time reads as the host time; the profiler's kernel
    # time is the device's own.
    def wkv_line(t, w_ms, dev_ms, plain_ms, note):
        geo = kw.geometry(torch.bfloat16, (BATCH, t, h, hd))
        nbytes, wflops = wkv_cost(BATCH, t, h, hd, 2)
        t_bytes, t_ops = nbytes / peak_bw, wflops / peak_f32
        w_bound = max(t_bytes, t_ops) * 1e3
        w_by = "bytes" if t_bytes >= t_ops else "operations"
        dev_txt = "not measured" if dev_ms is None else (
            f"{dev_ms:.5f} ms a launch, {w_bound / dev_ms:.3f} of the bound")
        log(f"wkv bf16 B{BATCH} T{t} H{h} D{hd}{note}: kernel {w_ms} ms by "
            f"events (profiler: {dev_txt}), plain {plain_ms} ms; bound "
            f"{w_bound:.5f} ms by {w_by} ({nbytes} B, {wflops} FLOP at "
            f"{peak_f32 / 1e12} TFLOP/s fp32) -> {w_bound / min(w_ms):.3f} "
            f"of the bound by events; launch {geo['blocks']} blocks x "
            f"{geo['threads']} threads, {geo['chunk_steps']} steps a chunk, "
            f"{geo['key_groups']} key groups of {geo['columns']} columns a "
            f"thread, {geo['smem_bytes']} B dynamic shared memory a block, "
            f"{geo['blocks_per_sm']} blocks an SM")
        return w_bound, w_by

    def wkv_dev_ms(fn, n):
        _, rows = profile(fn)
        dev = [(ms, c) for ms, key, c in rows if "wkv_kernel" in key]
        if not dev:
            return None
        if dev[0][1] != n:
            log(f"  the profiler saw {dev[0][1]} wkv launches of {n}")
        return dev[0][0] / dev[0][1]

    args = rand_wkv(BATCH, PROMPT, h, hd, torch.bfloat16, "model", seed=5)
    wt = {}
    for key, fn, it in (("plain", lambda: ref.wkv_ref(*args), 3),
                        ("kernel", lambda: kw.wkv(*args), 50),
                        ("kernel", lambda: kw.wkv(*args), 50),
                        ("plain", lambda: ref.wkv_ref(*args), 3)):
        wt.setdefault(key, []).append(time_ms(fn, iters=it, warmup=min(it, 3)))
    w_bound, w_by = wkv_line(
        PROMPT, wt["kernel"],
        wkv_dev_ms(lambda: [kw.wkv(*args) for _ in range(5)], 5),
        wt["plain"], "")
    wkv_row = {"ms": min(wt["kernel"]), "plain_ms": min(wt["plain"]),
               "bound_ms": w_bound, "bound_by": w_by}
    del args
    # T = 1: one state per layer, updated in place, as a decode step has
    # them (24 x 4.2 MB, more than L2 holds).
    layer_args = [rand_wkv(BATCH, 1, h, hd, torch.bfloat16, "model",
                           seed=100 + i) for i in range(ssm.n_layers)]
    one_pass = lambda: [kw.wkv(*a, state_out=a[5]) for a in layer_args]
    pass_ms = [time_ms(one_pass, iters=10, warmup=2) / ssm.n_layers
               for _ in range(2)]
    plain_ms = [time_ms(lambda: ref.wkv_ref(*layer_args[0]))]
    wkv_line(1, pass_ms, wkv_dev_ms(one_pass, ssm.n_layers), plain_ms,
             f", {ssm.n_layers} distinct states in place")
    dev = step_launch_ms[SSM_ARCH]
    log(f"wkv at T1 on the decode steps of phase 4: "
        f"{'not measured' if dev is None else f'{dev:.5f} ms a launch'}")
    del layer_args
    entries.append({
        "name": "wkv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_wkv.cu",
        "replaces": "src/repro/kernels/rwkv_wkv.py:31",
        "launches": launches["wkv"], "max_abs_err": path_err["wkv"],
        **wkv_row, "library_ms": None})

    # STREAM at the probe's size: plain version, kernel and the one PyTorch
    # call for the same function, in turns; each allocates its output.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    a, b = (torch.randn(STREAM_N, device="cuda", generator=gen)
            for _ in range(2))
    alpha = ref.round_to(STREAM_ALPHA, a.dtype)
    for op in STREAM_OPS:
        kfn = getattr(ks, f"stream_{op}")
        pfn = getattr(ref, f"stream_{op}_ref")
        args = stream_args(op, a, b, alpha)
        st = {}
        for key, fn in (("plain", lambda: pfn(*args)),
                        ("kernel", lambda: kfn(*args)),
                        ("library", stream_library(op, a, b, alpha)),
                        ("kernel", lambda: kfn(*args)),
                        ("plain", lambda: pfn(*args))):
            st.setdefault(key, []).append(time_ms(fn))
        nbytes = ks.stream_bytes(op, (STREAM_N,), a.dtype)
        flops = {"copy": 0, "scale": 1, "add": 1, "triad": 2}[op] * STREAM_N
        t_bytes, t_ops = nbytes / peak_bw, flops / peak_f32
        s_bound = max(t_bytes, t_ops) * 1e3
        s_by = "bytes" if t_bytes >= t_ops else "operations"
        s_ms = min(st["kernel"])
        log(f"stream_{op} f32 n {STREAM_N}: kernel {st['kernel']} ms, plain "
            f"{st['plain']} ms, library {st['library']} ms; bound "
            f"{s_bound:.5f} ms by {s_by} ({nbytes} B) -> "
            f"{s_bound / s_ms:.4f} of roofline, {nbytes / s_ms / 1e6:.1f} "
            f"GB/s")
        entries.append({
            "name": f"stream_{op}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/stream.cu",
            "replaces": f"src/repro/kernels/stream.py:{STREAM_OPS[op]}",
            "launches": launches[f"stream_{op}"],
            "max_abs_err": path_err[f"stream_{op}"],
            "ms": s_ms, "plain_ms": min(st["plain"]), "bound_ms": s_bound,
            "bound_by": s_by, "library_ms": min(st["library"])})
    del a, b
    # At the reference's (2048, 512) shape back-to-back calls are as fast
    # as the host issues them: events time the host side (the kernel's and
    # the library call's); the profiler gives the kernel's device time.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    a, b = (torch.randn(probe.REF_SHAPE, device="cuda", generator=gen)
            for _ in range(2))
    for op in STREAM_OPS:
        args = stream_args(op, a, b, alpha)
        kfn = getattr(ks, f"stream_{op}")
        _, rows = profile(lambda: [kfn(*args) for _ in range(20)])
        dev = [(ms, c) for ms, key, c in rows if "stream_kernel" in key]
        call_ms = time_ms(lambda: kfn(*args), iters=20, warmup=3)
        lib_ms = time_ms(stream_library(op, a, b, alpha), iters=20,
                         warmup=3)
        dev_txt = "device time not measured" if not dev else \
            f"{dev[0][0] / dev[0][1]:.5f} ms device time a launch " \
            f"(x{dev[0][1]})"
        log(f"stream_{op} f32 {probe.REF_SHAPE} (in L2): {dev_txt}; by "
            f"events {call_ms:.5f} ms a call, library {lib_ms:.5f} ms")
    del a, b

    # -- phase 6: the design-space engine -------------------------------------
    engine_phase(plan_k2["ms"])

    # -- phase 7: the memory-system DES --------------------------------------
    entries.extend(memsim_phase(path_err["memsim"]))

    # -- phase 8: the QueueLUT and the memsim backend ---------------------------
    lut_phase()

    # -- phase 9: the designer and the capacity planner ---------------------
    serving_phase()

    # -- phase 10: training --------------------------------------------------
    trained, k3b_row = train_phase(path_err["wkv_bwd"])
    for entry in entries:
        if entry["name"] == "wkv":
            entry["launches"] += trained["wkv"]
    entries.insert(3, {
        "name": "wkv_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_wkv_bwd.cu",
        "replaces": "src/repro/models/rwkv.py:60",
        "launches": trained["wkv_bwd"], **k3b_row})

    # -- phase 11: the multi-device layer -----------------------------------
    for kname, n in mesh_phase().items():
        for entry in entries:
            if entry["name"] == kname:
                entry["launches"] += n

    # The card's line again, so that it stands in the output's tail.
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
