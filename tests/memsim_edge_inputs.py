"""Crafted inputs for the DES scans' edge tests (numpy only).

``ts_inputs`` and ``event_inputs`` give terms, carries and two chunks of
draws in which each lane holds one edge of the scans' semantics (the
docstrings list them).  ``tests/test_torch_memsim_edges.py`` runs them
through the reference and the plain versions on the CPU,
``tests/test_torch_cuda.py`` through the kernels and the plain versions on
the card.
"""

import numpy as np

CHUNK = 40                     # steps a chunk; two chained chunks a case
# Record windows (rec_lo, rec_hi): none, one step, chunk - 1 steps, all.
WINDOWS = [(0, 0), (7, 8), (1, CHUNK), (0, CHUNK)]

_F = np.float32
NEG0 = _F(-0.0)
INF = _F(np.inf)
NAN = _F(np.nan)

# Timestep lanes: (name, changes to the base lane).
_TS_LANES = [
    ("base", {}),
    ("backlog at bound", dict(backlog=6.0, bound=6.0, svc=3.0, arrive=True)),
    ("backlog reaches bound", dict(backlog=9.0, bound=4.0, svc=2.0,
                                   arrive=True, jit=0.0)),
    ("draws at thresholds", dict(thresholds=True)),
    ("service 0", dict(svc=0.0, arrive=True)),
    ("service -0", dict(svc=NEG0, arrive=True, h_scale=2.0)),
    ("service +inf", dict(svc_at={5: INF}, bound=8.0, arrive=True)),
    ("service +inf, bound inf", dict(svc_at={3: INF}, bound=INF,
                                     arrive=True)),
    ("service NaN", dict(svc_at={4: NAN}, bound=8.0, arrive=True)),
    ("service NaN, bound inf", dict(svc_at={2: NAN}, bound=INF,
                                    arrive=True)),
    ("bin edges", dict(lat0=8.0, svc=4.0, jit_cycle=(0.0, 4.0, 3.9999998),
                       arrive=True)),
    ("latency 4096", dict(lat0=4096.0, jit=0.0, arrive=True)),
    ("latency under 4096", dict(lat0=4092.0, jit_cycle=(0.0, 3.9999998),
                                svc=0.5, arrive=True)),
    ("latency past int32", dict(lat0=1e10, svc=0.5, arrive=True)),
    ("latency below 0", dict(lat0=-100.0, svc=0.5, arrive=True)),
    ("latency in (-4, 0)", dict(lat0=-3.0, svc=0.5, arrive=True)),
    ("bound inf", dict(bound=INF)),
    ("carry not 0/1", dict(burst=0.7, lent=0.3, backlog=NEG0)),
]
TS_LANES = len(_TS_LANES)


def ts_inputs(harvest: bool, seed: int = 17):
    """(terms, carry, chunks) for the timestep scan: ``terms`` a dict of
    (n,) float32 by the scan's term names, ``carry`` (backlog, in_burst,
    lent), ``chunks`` two tuples (switch_u, arrive_u, jitter, svc,
    harvest_u) of (CHUNK, n) float32 (harvest_u zeros when not
    ``harvest``).

    Lanes: a backlog exactly at the bound, and one that reaches it; switch,
    arrival and harvest draws exactly at p_leave, p_enter, rate_hi, rate_lo,
    h_leave and h_enter; services 0, -0, +inf (bound finite and infinite)
    and NaN; latencies on a 4-ns bin edge, at 4,096 ns, just under it,
    past int32 once scaled (1e10 ns), below 0 and in (-4, 0); bound inf; a
    carry that is not 0/1 and a backlog of -0."""
    rng = np.random.default_rng(seed)
    n = TS_LANES
    terms = dict(p_leave=np.full(n, 0.05), p_enter=np.full(n, 0.02),
                 rate_hi=np.full(n, 0.6), rate_lo=np.full(n, 0.25),
                 bound=np.full(n, 12.0), lat0=np.full(n, 30.0),
                 h_leave=np.full(n, 0.1), h_enter=np.full(n, 0.05),
                 h_scale=np.full(n, 1.5))
    terms = {k: v.astype(_F) for k, v in terms.items()}
    carry = [np.zeros(n, _F), np.ones(n, _F), np.zeros(n, _F)]
    chunks = []
    for _ in range(2):
        sw, au, hu = (rng.random((CHUNK, n), dtype=_F) for _ in range(3))
        jit = (rng.random((CHUNK, n), dtype=_F) * _F(4.0)).astype(_F)
        svc = rng.integers(1, 6, (CHUNK, n)).astype(_F)
        chunks.append([sw, au, jit, svc, hu])
    for i, (_, spec) in enumerate(_TS_LANES):
        for key in ("bound", "lat0", "h_scale"):
            if key in spec:
                terms[key][i] = spec[key]
        for key, row in (("backlog", 0), ("burst", 1), ("lent", 2)):
            if key in spec:
                carry[row][i] = spec[key]
        for sw, au, jit, svc, hu in chunks:
            if "svc" in spec:
                svc[:, i] = spec["svc"]
            for k, v in spec.get("svc_at", {}).items():
                svc[k, i] = v
            if spec.get("arrive"):
                au[:, i] = 0.0
            if "jit" in spec:
                jit[:, i] = spec["jit"]
            if "jit_cycle" in spec:
                cyc = np.asarray(spec["jit_cycle"], _F)
                jit[:, i] = cyc[np.arange(CHUNK) % len(cyc)]
            if spec.get("thresholds"):
                k = np.arange(CHUNK)
                sw[:, i] = np.where(k % 2 == 0, terms["p_leave"][i],
                                    terms["p_enter"][i])
                au[:, i] = np.where(k % 3 == 0, terms["rate_hi"][i],
                                    terms["rate_lo"][i])
                hu[:, i] = np.where(k % 2 == 1, terms["h_leave"][i],
                                    terms["h_enter"][i])
    for c in chunks:
        if not harvest:
            c[4] = np.zeros((CHUNK, n), _F)
    return terms, carry, [tuple(np.ascontiguousarray(a) for a in c)
                          for c in chunks]


# Event lanes: (name, changes to the base lane).
_EVENT_LANES = [
    ("base", {}),
    ("wait at bound", dict(w0=6.0, bound=6.0, gap=3.0, svc=3.0)),
    ("service 0", dict(svc=0.0)),
    ("service -0", dict(svc=NEG0)),
    ("service +inf", dict(svc_at={4: INF}, bound=8.0)),
    ("service +inf, bound inf", dict(svc_at={3: INF}, bound=INF)),
    ("service NaN", dict(svc_at={5: NAN})),
    ("wait -0, gap 0, service -0", dict(w0=NEG0, gap=0.0, svc=NEG0)),
    ("bin edges", dict(lat0=8.0, gap=1.0, svc=4.0)),
    ("latency 4096", dict(lat0=4096.0, gap=2.0, svc=2.0)),
    ("latency past int32", dict(lat0=1e10)),
    ("latency below 0", dict(lat0=-100.0)),
    ("latency in (-4, 0)", dict(lat0=-3.0, gap=5.0, svc=1.0)),
    ("bound inf", dict(bound=INF)),
]
EVENT_LANES = len(_EVENT_LANES)


def event_inputs(window, seed: int = 23):
    """(terms, W, chunks) for the Lindley scan: ``terms`` a dict of (n,)
    float32 (bound, lat0), ``W`` the (n,) wait carry, ``chunks`` two tuples
    (gaps, svc, rec_time) of (CHUNK, n); ``rec_time`` is set on the steps of
    ``window`` (rec_lo, rec_hi) only.

    Lanes: a wait exactly at the bound; services 0, -0, +inf (bound finite
    and infinite) and NaN; a wait of -0 with a gap of 0 and a service of -0;
    latencies on a 4-ns bin edge, at 4,096 ns, past int32 once scaled, below
    0 and in (-4, 0); bound inf."""
    rng = np.random.default_rng(seed)
    n = EVENT_LANES
    terms = dict(bound=np.full(n, 20.0, _F), lat0=np.full(n, 30.0, _F))
    w0 = np.zeros(n, _F)
    lo, hi = window
    chunks = []
    for _ in range(2):
        gaps = rng.integers(0, 6, (CHUNK, n)).astype(_F)
        svc = rng.integers(1, 6, (CHUNK, n)).astype(_F)
        rec = np.zeros((CHUNK, n), bool)
        rec[lo:hi] = True
        chunks.append((gaps, svc, rec))
    for i, (_, spec) in enumerate(_EVENT_LANES):
        for key in ("bound", "lat0"):
            if key in spec:
                terms[key][i] = spec[key]
        if "w0" in spec:
            w0[i] = spec["w0"]
        for gaps, svc, _ in chunks:
            if "gap" in spec:
                gaps[:, i] = spec["gap"]
            if "svc" in spec:
                svc[:, i] = spec["svc"]
            for k, v in spec.get("svc_at", {}).items():
                svc[k, i] = v
    return terms, w0, chunks
