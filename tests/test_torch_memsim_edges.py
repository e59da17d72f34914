"""The DES scans' edge semantics: the port's ``ops.ts_scan`` /
``ops.event_scan`` on the CPU (the plain versions ``ref.ts_scan_ref`` /
``ref.event_scan_ref``) against the reference's ``_ts_chunk_core`` /
``_event_chunk_core`` on crafted terms and draws.

Each lane of a batch is one edge: a backlog or wait exactly at the
admission bound; draws exactly at ``p_leave``, ``p_enter``, the rates,
``h_leave`` and ``h_enter``; services of 0, -0, +inf and NaN; latencies on
a 4-ns bin edge, at and above 4,096 ns (past int32 after the scale) and
below 0; ``bound = inf``.  Each case runs two chained chunks under a record
window of 0, 1, ``chunk - 1`` or ``chunk`` steps (the event engine's
``rec_time`` set on as many steps), and holds the carries to the
reference's by bit pattern and the histograms exactly.  The same inputs
run through the kernels on the card in ``tests/test_torch_cuda.py``
(``memsim_edge_inputs`` is shared).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memsim as R
from repro_torch.core.memsim import TS_TERMS
from repro_torch.kernels import ops

from memsim_edge_inputs import (CHUNK, EVENT_LANES, TS_LANES, WINDOWS,
                                event_inputs, ts_inputs)


def ref_hist(flat, n) -> np.ndarray:
    return np.bincount(np.asarray(flat).reshape(-1),
                       minlength=n * R.N_BINS + 1)[:-1].reshape(n, R.N_BINS)


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("harvest", [False, True], ids=["plain", "harvest"])
@pytest.mark.parametrize("window", WINDOWS)
def test_ts_scan_edges_equal_reference(window, harvest):
    terms, carry, chunks = ts_inputs(harvest)
    n = TS_LANES
    lo, hi = window
    record = np.zeros(CHUNK, np.float32)
    record[lo:hi] = 1.0
    r_terms = {k: jnp.asarray(v) for k, v in terms.items()}
    state = tuple(jnp.asarray(c) for c in carry)
    p_terms = torch.from_numpy(np.stack([terms[k] for k in TS_TERMS]))
    p_carry = torch.from_numpy(np.stack(carry))
    want = np.zeros((n, R.N_BINS), np.int64)
    hist = torch.zeros((n, R.N_BINS), dtype=torch.int32)
    lanes = jnp.arange(n, dtype=jnp.int32)
    for sw, au, jit_ns, svc, hu in chunks:
        state, flat = R._ts_chunk_core(
            r_terms, state, lanes, jnp.asarray(sw), jnp.asarray(au),
            jnp.asarray(jit_ns), jnp.asarray(svc), jnp.asarray(hu),
            jnp.asarray(record), n)
        want += ref_hist(flat, n)
        t = torch.from_numpy
        ops.ts_scan(p_terms, p_carry, t(sw), t(au), t(jit_ns), t(svc),
                    t(hu) if harvest else None, lo, hi, hist)
        np.testing.assert_array_equal(
            bits(p_carry.numpy()), np.stack([bits(s) for s in state]))
        np.testing.assert_array_equal(hist.numpy(), want)
    if hi > lo:
        # The edges are reached: saturated and zero bins both hold counts.
        assert want[:, 0].sum() > 0 and want[:, -1].sum() > 0


@pytest.mark.parametrize("window", WINDOWS)
def test_event_scan_edges_equal_reference(window):
    terms, w0, chunks = event_inputs(window)
    n = EVENT_LANES
    r_terms = {k: jnp.asarray(v) for k, v in terms.items()}
    W = jnp.asarray(w0)
    p_terms = torch.from_numpy(np.stack([terms["bound"], terms["lat0"]]))
    p_W = torch.from_numpy(w0.copy())
    want = np.zeros((n, R.N_BINS), np.int64)
    hist = torch.zeros((n, R.N_BINS), dtype=torch.int32)
    lanes = jnp.arange(n, dtype=jnp.int32)
    for gaps, svc, rec in chunks:
        W, flat = R._event_chunk_core(r_terms, W, lanes, jnp.asarray(gaps),
                                      jnp.asarray(svc), jnp.asarray(rec), n)
        want += ref_hist(flat, n)
        t = torch.from_numpy
        ops.event_scan(p_terms, p_W, t(gaps), t(svc), t(rec), hist)
        np.testing.assert_array_equal(bits(p_W.numpy()), bits(W))
        np.testing.assert_array_equal(hist.numpy(), want)
    if window[1] > window[0]:
        assert want[:, 0].sum() > 0 and want[:, -1].sum() > 0


def test_edge_inputs_hold_their_edges():
    """The crafted inputs do reach the edges they are named for."""
    terms, carry, chunks = ts_inputs(True)
    sw, au, _, svc, hu = chunks[0]
    assert (sw == terms["p_leave"]).any() and (sw == terms["p_enter"]).any()
    assert (au == terms["rate_hi"]).any() and (au == terms["rate_lo"]).any()
    assert (hu == terms["h_leave"]).any() and (hu == terms["h_enter"]).any()
    assert np.isinf(terms["bound"]).any()
    assert (carry[0] == terms["bound"]).any()
    for v in (0.0, np.inf):
        assert (svc == v).any()
    assert (np.signbit(svc) & (svc == 0)).any() and np.isnan(svc).any()
    ev_terms, w0, ev_chunks = event_inputs((0, CHUNK))
    assert (w0 == ev_terms["bound"]).any()
    assert np.signbit(w0).any()
    gaps, esvc, _ = ev_chunks[0]
    assert np.isnan(esvc).any() and np.isinf(esvc).any()
