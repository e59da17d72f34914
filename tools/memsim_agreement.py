"""How close the port's DES comes to the JAX reference's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/memsim_agreement.py \
        [--steps 200000] [--reps 8] [--seed 3] [--plain-math]

Runs the same batch through ``repro.core.memsim.simulate_cells`` (the
reference) and ``repro_torch.core.memsim.simulate_cells`` (the port, on the
CPU) for each engine: the calibration anchors (rho 0.1..0.8, the
reference's ``validate_calibration`` channel), ``--seed``, ``--reps``
replicas.  Prints, per engine, how many cells' histograms are bit-equal and
the largest per-cell histogram L1 distance (as a fraction of the cell's
mass), |p50|/|p90|/|p99| difference (ns) and relative mean difference;
then, over the event engine's first chunks on the same lanes, how
many stage-A arrivals land in another 1-ns lattice cell than the
reference's (the partial sums of the cumulative intensity are rounded in
another order, and ``ceil`` turns a last-bit difference into a whole
cell), how many gaps, record flags and services differ, and the largest
difference of a service in ulp.  Last, a JSON object with the numbers.

``--plain-math`` measures what the port's rounding of the reference's
float32 math buys: it runs the port with torch's own float32 ``log``,
``exp``, ``log1p`` and ``pow``, unfused ``a * b + c`` and ``torch.cumsum``
in place of ``core/xlamath.py`` and ``memsim._cumsum0``.

Imports both packages, like the tests; the port itself never imports JAX.
"""

from __future__ import annotations

import argparse
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import memsim as R
from repro_torch.core import memsim as P

RHOS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)

#: torch's own float32 math, for ``--plain-math``.
PLAIN_MATH = types.SimpleNamespace(
    log=torch.log, exp=torch.exp, log1p=torch.log1p, pow=torch.pow,
    fma=lambda a, b, c: a * b + c)


def compare(want, got) -> dict:
    mass = want.hist.sum(-1)
    l1 = np.abs(want.hist - got.hist).sum(-1) / np.maximum(mass, 1.0)
    out = dict(cells=int(mass.size),
               equal_cells=int(np.sum(np.all(want.hist == got.hist, -1))),
               max_l1=float(l1.max()))
    for q in ("p50_ns", "p90_ns", "p99_ns"):
        out[f"max_d_{q}"] = float(np.max(np.abs(getattr(want, q) -
                                                getattr(got, q))))
    out["max_rel_d_mean"] = float(np.max(np.abs(got.mean_ns / want.mean_ns
                                                - 1.0)))
    return out


def ulps(want: np.ndarray, got: np.ndarray) -> int:
    """Largest distance in float32 ulp between two arrays of positive
    floats."""
    w = want.astype(np.float32).view(np.int32).astype(np.int64)
    g = got.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(w - g))) if w.size else 0


def event_stage_a(reps: int, chunks: int, chunk: int, seed: int) -> dict:
    """The event engine's stage A on the calibration lanes, the port
    against the reference, over ``chunks`` chained chunks."""
    cfg = [R.ChannelConfig(rho=r) for r in RHOS] * reps
    cha = R.stack_channels(cfg)
    n = len(cfg)
    ov = R._nan_overrides(n)
    lane_r = jnp.arange(n, dtype=jnp.int32)
    c = P._apply_channel_overrides(P.ChannelArrays(
        *(torch.from_numpy(np.array(x)) for x in cha)), P._nan_overrides(n))
    t = P._channel_terms(c)
    lanes = torch.arange(n)

    def words(key):
        return torch.from_numpy(
            np.asarray(jax.random.key_data(key)).astype(np.int64))

    phase, root = jax.random.split(jax.random.PRNGKey(seed))
    tabs = R._event_tables_jit(cha, ov, lane_r, phase, n_sojourns=512)
    p_tabs = P._event_tables(c, t, lanes, words(phase), 512)
    state = (jnp.zeros(n), jnp.zeros(n))
    p_state = (torch.zeros(n), torch.zeros(n))
    out = dict(candidates=0, arrivals_moved=0, gaps_differing=0,
               rec_time_differing=0, svc_differing=0, svc_max_ulp=0)
    for key in jax.random.split(root, chunks):
        t_prev, p_t_prev = np.asarray(state[1]), p_state[1].numpy()
        state, gaps, svc, rec = R._event_arrivals_jit(
            cha, ov, state, lane_r, key, tabs, jnp.float32(1000),
            chunk=chunk)
        p_state, p_gaps, p_svc, p_rec = P._event_arrivals(
            c, t, p_state, lanes, words(key), p_tabs, 1000, chunk)
        gaps, p_gaps = np.asarray(gaps), p_gaps.numpy()
        arr = t_prev[None] + np.cumsum(gaps.astype(np.float64), 0)
        p_arr = p_t_prev[None] + np.cumsum(p_gaps.astype(np.float64), 0)
        out["candidates"] += gaps.size
        out["arrivals_moved"] += int(np.sum(arr != p_arr))
        out["gaps_differing"] += int(np.sum(gaps != p_gaps))
        out["rec_time_differing"] += int(np.sum(np.asarray(rec) !=
                                                p_rec.numpy()))
        svc, p_svc = np.asarray(svc), p_svc.numpy()
        same_cell = (gaps > 0.5) == (p_gaps > 0.5)
        out["svc_differing"] += int(np.sum(svc != p_svc))
        out["svc_max_ulp"] = max(out["svc_max_ulp"],
                                 ulps(svc[same_cell], p_svc[same_cell]))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--plain-math", action="store_true")
    args = ap.parse_args(argv)
    if args.plain_math:
        P.xm = PLAIN_MATH
        P._cumsum0 = lambda x: torch.cumsum(x, 0)
    out = {}
    for engine in R.ENGINES:
        kw = dict(steps=args.steps, seed=args.seed, reps=args.reps,
                  engine=engine)
        t0 = time.time()
        with jax.threefry_partitionable(True):
            want = R.simulate_cells(R.stack_channels(
                [R.ChannelConfig(rho=r) for r in RHOS]), **kw)
        t1 = time.time()
        got = P.simulate_cells(P.stack_channels(
            [P.ChannelConfig(rho=r) for r in RHOS]), **kw, device="cpu")
        t2 = time.time()
        out[engine] = compare(want, got)
        print(f"{engine}: {args.steps} steps, {len(RHOS)} cells x "
              f"{args.reps} reps: {out[engine]} (reference {t1 - t0:.1f} s, "
              f"port {t2 - t1:.1f} s on the CPU)", flush=True)
    n = len(RHOS) * args.reps
    chunk = R._event_chunk_len(n)
    with jax.threefry_partitionable(True):
        out["event_stage_a"] = event_stage_a(args.reps, 4, chunk,
                                            args.seed)
    print(f"event stage A, {n} lanes x 4 chunks of {chunk}: "
          f"{out['event_stage_a']}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
