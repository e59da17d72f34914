"""The port's memory-system DES (``repro_torch.core.memsim``) against the
reference (``repro.core.memsim``), on the CPU.

* Stage A (draws and transcendental laws): the port's uniforms equal the
  reference's bit for bit; its derived arrays equal the reference's up to
  the mismatch counts measured and stated here (all 0: the port reproduces
  the reference's Threefry streams, XLA's order of cumulative sums and
  XLA's CPU ``log``/``exp``/``log1p``/``powf``), and its transcendental
  outputs lie within 4 ulp (rtol 5e-7) in any case.
* Stage B (the scans): the plain versions ``ref.ts_scan_ref`` /
  ``ref.event_scan_ref``, fed the reference's OWN stage-A arrays and terms,
  equal ``_ts_chunk_core`` / ``_event_chunk_core`` bit for bit:
  histograms and carries, over chained chunks.
* Full engines: ``simulate_cells`` per cell against the reference, under
  the histogram gates below.
* The port's own contracts and the host-side statistics.

The reference runs under ``jax.threefry_partitionable(True)``, the scheme
the port reproduces.  Batch widths here avoid the reference's
trace-count tests' widths (12, 56 lanes), whose jit caches they must find
cold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memsim as R
from repro_torch.core import memsim as P
from repro_torch.core import shardsim
from repro_torch.kernels import ops

# Stage-A arrays that are not bit-equal to the reference's, measured on
# this CPU over the inputs of these tests: none.  (The port draws the
# reference's streams and rounds its transcendentals as XLA's CPU code
# does; what is left is float64 rounding of an emulated FMA or powf, which
# these inputs never hit.)
STAGE_A_MISMATCHES = 0
# Transcendental outputs must in any case lie within 4 ulp.
TRANSCENDENTAL_RTOL = 5e-7
# Full-engine gates per cell: histogram L1 distance as a fraction of the
# cell's mass, quantiles within one bin, mean within 1e-4 relative.  Both
# engines meet them with a measured L1 of exactly 0 on these inputs.
HIST_L1_TOL = 1e-3
QUANTILE_TOL_NS = R.BIN_NS
MEAN_RTOL = 1e-4
STATS_FIELDS = ("mean_ns", "stdev_ns", "p50_ns", "p90_ns", "p99_ns", "hist")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The suite runs in several worker processes at once: this module's
    torch work keeps to one thread so that it does not crowd the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _cells(n, seed=0, harvest=True):
    rng = np.random.default_rng(seed)
    kw = [dict(rho=float(r), kappa=float(k), eta=float(e),
               outstanding=float(o), cxl_lat_ns=float(cx),
               harvest_duty=float(hd) if harvest else 0.0,
               harvest_bw_gbps=float(hb) if harvest else 0.0)
          for r, k, e, o, cx, hd, hb in zip(
              rng.uniform(0.05, 0.9, n), rng.choice([1.0, 1.6, 3.2], n),
              rng.uniform(0.4, 1.2, n), rng.choice([4.0, 16.0, np.inf], n),
              rng.choice([0.0, 30.0], n), rng.choice([0.0, 0.3], n),
              rng.choice([0.0, 20.0], n))]
    return kw


class Batch:
    """The same cells as the reference's jitted inputs and the port's
    overridden channel arrays and terms."""

    def __init__(self, kw, overrides=None):
        n = len(kw)
        self.n = n
        self.cha = R.stack_channels([R.ChannelConfig(**k) for k in kw])
        self.ov = R._nan_overrides(n)
        p_ov = P._nan_overrides(n)
        for f, v in (overrides or {}).items():
            self.ov[f] = jnp.asarray(np.asarray(v, np.float32))
            p_ov[f] = torch.from_numpy(np.asarray(v, np.float32))
        self.lane_r = jnp.arange(n, dtype=jnp.int32)
        self.lanes = torch.arange(n)
        p_cha = P.ChannelArrays(*(torch.from_numpy(np.array(x))
                                  for x in self.cha))
        self.c = P._apply_channel_overrides(p_cha, p_ov)
        self.t = P._channel_terms(self.c)


def key_words(key) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(jax.random.key_data(key)).astype(np.int64))


def mismatches(want, got) -> int:
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.shape == got.shape
    return int(np.sum(~((want == got) | (np.isnan(want) & np.isnan(got)))))


def assert_stage_a(name, want, got, transcendental=False):
    assert mismatches(want, got) <= STAGE_A_MISMATCHES, name
    if transcendental:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TRANSCENDENTAL_RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# Stage A.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("minval", [0.0, 1e-12])
def test_lane_uniforms_bit_exact(minval):
    b = Batch(_cells(9))
    key = jax.random.split(jax.random.PRNGKey(2), 3)[2]
    kw = {"minval": minval} if minval else {}
    want = np.asarray(R._lane_uniforms(key, b.lane_r, (300, 2), **kw))
    got = P.threefry.lane_uniform(key_words(key), b.lanes, (300, 2),
                                  minval=minval).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("overrides", [False, True])
def test_channel_terms(overrides):
    kw = _cells(13, seed=1)
    ov = None
    if overrides:       # a distribution-sweep batch: NaN = keep the base
        rng = np.random.default_rng(7)
        ov = {"rho": np.where(rng.uniform(size=13) < 0.5, np.nan,
                              rng.uniform(0.05, 0.9, 13)),
              "stall_alpha": np.where(np.arange(13) % 3 == 0, 1.00005,
                                      np.nan),
              "burst_duty": np.full(13, 0.2)}
    b = Batch(kw, ov)
    want = jax.jit(lambda cha, o: R._channel_terms(
        R._apply_channel_overrides(cha, o)))(b.cha, b.ov)
    for k, v in want.items():
        assert_stage_a(k, v, b.t[k], transcendental=True)
    scan = R._scan_terms_jit(b.cha, b.ov)
    for k, v in P._scan_terms(b.c, b.t).items():
        assert_stage_a(k, scan[k], v, transcendental=True)
    harvest = R._harvest_scan_terms_jit(b.cha, b.ov)
    for k, v in P._harvest_terms(b.c).items():
        assert_stage_a(k, harvest[k], v, transcendental=True)


def test_ts_draws():
    b = Batch(_cells(11, seed=2))
    for k, key in enumerate(jax.random.split(jax.random.PRNGKey(4), 2)):
        want = R._ts_draws_jit(b.cha, b.ov, b.lane_r, key, chunk=1024)
        got = P._ts_draws(b.c, b.t, b.lanes, key_words(key), 1024)
        for name, w, g in zip(("switch_u", "arrive_u"), want[:2], got[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert_stage_a("jitter", want[2], got[2])
        assert_stage_a("svc", want[3], got[3], transcendental=True)
        assert all(g.is_contiguous() for g in got)
        hu = R._ts_harvest_u_jit(b.lane_r, key, chunk=1024)
        np.testing.assert_array_equal(
            P._ts_harvest_u(b.lanes, key_words(key), 1024).numpy(),
            np.asarray(hu))


def test_event_stage_a_over_chunks():
    """The sojourn tables, then four chained chunks of arrivals (gaps,
    services, record flags and the (u_last, t_last) carry), the harvest
    tables and the harvest scaling."""
    b = Batch(_cells(11, seed=3))
    chunk, m = 2048, 200
    phase, root = jax.random.split(jax.random.PRNGKey(1))
    tabs = R._event_tables_jit(b.cha, b.ov, b.lane_r, phase, n_sojourns=m)
    p_tabs = P._event_tables(b.c, b.t, b.lanes, key_words(phase), m)
    assert_stage_a("Lt", tabs[0], p_tabs[0], transcendental=True)
    assert_stage_a("packed", tabs[1], p_tabs[1], transcendental=True)
    htabs = R._event_harvest_tabs_jit(b.cha, b.ov, b.lane_r, phase,
                                      n_windows=m)
    p_htabs = P._event_harvest_tabs(b.c, b.lanes, key_words(phase), m)
    assert_stage_a("harvest tables", htabs, p_htabs, transcendental=True)
    h_scale = R._harvest_scan_terms_jit(b.cha, b.ov)["h_scale"]
    p_h_scale = P._harvest_terms(b.c)["h_scale"]
    state = (jnp.zeros(b.n), jnp.zeros(b.n))
    p_state = (torch.zeros(b.n), torch.zeros(b.n))
    for key in jax.random.split(root, 4):
        t_prev, p_t_prev = state[1], p_state[1]
        state, gaps, svc, rec = R._event_arrivals_jit(
            b.cha, b.ov, state, b.lane_r, key, tabs, jnp.float32(1500),
            chunk=chunk)
        p_state, p_gaps, p_svc, p_rec = P._event_arrivals(
            b.c, b.t, p_state, b.lanes, key_words(key), p_tabs, 1500, chunk)
        assert_stage_a("gaps", gaps, p_gaps)
        assert_stage_a("svc", svc, p_svc, transcendental=True)
        assert_stage_a("rec_time", rec, p_rec)
        assert_stage_a("u_last", state[0], p_state[0], transcendental=True)
        assert_stage_a("arr_t", state[1], p_state[1])
        hs = R._event_harvest_scale_jit(svc, gaps, t_prev, htabs, h_scale)
        p_hs = P._event_harvest_scale(p_svc, p_gaps, p_t_prev, p_htabs,
                                      p_h_scale)
        assert_stage_a("harvest-scaled svc", hs, p_hs, transcendental=True)


@pytest.mark.parametrize("length", [1, 5, 16, 17, 255, 256, 1000, 4099])
def test_cumsum_in_xla_order(length):
    """``_cumsum0`` gives the reference's float32 partial sums bit for bit
    (``torch.cumsum`` sums in another order)."""
    x = np.random.default_rng(length).exponential(
        size=(length, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=0))(x))
    got = P._cumsum0(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Stage B: the plain scans on the reference's own stage-A arrays.
# ---------------------------------------------------------------------------

STAGE_B_CASES = [
    # (harvest active, outstanding, steps): steps not a whole number of
    # chunks make the last chunk's record window ragged.
    pytest.param(False, np.inf, 3 * 1024, id="open-loop"),
    pytest.param(False, 4.0, 2 * 1024 + 517, id="closed-loop-ragged"),
    pytest.param(True, np.inf, 2 * 1024 + 300, id="harvest-ragged"),
    pytest.param(True, 8.0, 3 * 1024, id="harvest-closed-loop"),
]


def _stage_b_cells(harvest, outstanding):
    return [dict(rho=r, kappa=k, outstanding=outstanding,
                 harvest_duty=0.4 if harvest else 0.0,
                 harvest_bw_gbps=20.0 if harvest else 0.0,
                 harvest_sojourn_ns=300.0)
            for r in (0.3, 0.6, 0.85) for k in (1.0, 2.5, 3.2)]


def ref_hist(flat, n) -> np.ndarray:
    return np.bincount(np.asarray(flat).reshape(-1),
                       minlength=n * R.N_BINS + 1)[:-1].reshape(n, R.N_BINS)


@pytest.mark.parametrize("harvest,outstanding,steps", STAGE_B_CASES)
def test_ts_scan_ref_equals_reference_scan(harvest, outstanding, steps):
    chunk, warmup = 1024, 300
    b = Batch(_stage_b_cells(harvest, outstanding))
    n = b.n
    terms = {**R._scan_terms_jit(b.cha, b.ov),
             **R._harvest_scan_terms_jit(b.cha, b.ov)}
    p_terms = torch.from_numpy(np.stack(
        [np.asarray(terms[k]) for k in P.TS_TERMS]))
    n_chunks = -(-steps // chunk)
    record = np.zeros(n_chunks * chunk, np.float32)
    record[warmup:steps] = 1.0
    state = (jnp.zeros(n), jnp.ones(n), jnp.zeros(n))
    carry = torch.stack([torch.zeros(n), torch.ones(n), torch.zeros(n)])
    want = np.zeros((n, R.N_BINS), np.int64)
    hist = torch.zeros((n, R.N_BINS), dtype=torch.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), n_chunks)
    for k in range(n_chunks):
        sw, au, jit_ns, svc = R._ts_draws_jit(b.cha, b.ov, b.lane_r, keys[k],
                                              chunk=chunk)
        hu = (R._ts_harvest_u_jit(b.lane_r, keys[k], chunk=chunk) if harvest
              else jnp.zeros((chunk, n), jnp.float32))
        rec = record[k * chunk:(k + 1) * chunk]
        state, flat = R._ts_chunk_core(terms, state, b.lane_r, sw, au, jit_ns,
                                       svc, hu, jnp.asarray(rec), n)
        want += ref_hist(flat, n)
        lo = min(max(warmup - k * chunk, 0), chunk)
        hi = min(max(steps - k * chunk, 0), chunk)
        t = lambda a: torch.from_numpy(np.array(a))
        ops.ts_scan(p_terms, carry, t(sw), t(au), t(jit_ns), t(svc),
                    t(hu) if harvest else None, lo, hi, hist)
        np.testing.assert_array_equal(carry.numpy(),
                                      np.stack([np.asarray(s)
                                                for s in state]))
        np.testing.assert_array_equal(hist.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("harvest,outstanding,steps", STAGE_B_CASES)
def test_event_scan_ref_equals_reference_scan(harvest, outstanding, steps):
    chunk = 1024
    b = Batch(_stage_b_cells(harvest, outstanding))
    n = b.n
    events = steps
    n_chunks = -(-events // chunk)
    phase, root = jax.random.split(jax.random.PRNGKey(6))
    keys = jax.random.split(root, n_chunks)
    tabs = R._event_tables_jit(b.cha, b.ov, b.lane_r, phase, n_sojourns=64)
    terms = R._scan_terms_jit(b.cha, b.ov)
    p_terms = torch.from_numpy(np.stack(
        [np.asarray(terms[k]) for k in P.EVENT_TERMS]))
    if harvest:
        htabs = R._event_harvest_tabs_jit(b.cha, b.ov, b.lane_r, phase,
                                          n_windows=64)
        h_scale = R._harvest_scan_terms_jit(b.cha, b.ov)["h_scale"]
    state_a = (jnp.zeros(n), jnp.zeros(n))
    W = jnp.zeros(n)
    p_W = torch.zeros(n)
    want = np.zeros((n, R.N_BINS), np.int64)
    hist = torch.zeros((n, R.N_BINS), dtype=torch.int32)
    for k in range(n_chunks):
        t_prev = state_a[1]
        state_a, gaps, svc, rec = R._event_arrivals_jit(
            b.cha, b.ov, state_a, b.lane_r, keys[k], tabs,
            jnp.float32(400), chunk=chunk)
        if harvest:
            svc = R._event_harvest_scale_jit(svc, gaps, t_prev, htabs,
                                             h_scale)
        W, flat = R._event_chunk_core(terms, W, b.lane_r, gaps, svc, rec, n)
        want += ref_hist(flat, n)
        t = lambda a: torch.from_numpy(np.array(a))
        ops.event_scan(p_terms, p_W, t(gaps), t(svc), t(rec), hist)
        np.testing.assert_array_equal(p_W.numpy(), np.asarray(W))
        np.testing.assert_array_equal(hist.numpy(), want)
    assert want.sum() > 0


def test_scan_dispatch_refuses_mixed_devices():
    n = 3
    terms = torch.zeros(2, n)
    with pytest.raises(ValueError, match="mixed or unsupported"):
        ops.event_scan(terms, torch.zeros(n, device="meta"),
                       torch.zeros(4, n), torch.zeros(4, n),
                       torch.zeros(4, n, dtype=torch.bool),
                       torch.zeros(n, R.N_BINS, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Full engines.
# ---------------------------------------------------------------------------

def assert_stats_close(want, got):
    """The histogram gates, per cell."""
    mass = want.hist.sum(-1)
    assert np.all(mass > 0)
    l1 = np.abs(want.hist - got.hist).sum(-1) / mass
    assert l1.max() <= HIST_L1_TOL, l1.max()
    for q in ("p50_ns", "p90_ns", "p99_ns"):
        assert np.max(np.abs(getattr(want, q) - getattr(got, q))) \
            <= QUANTILE_TOL_NS, q
    np.testing.assert_allclose(got.mean_ns, want.mean_ns, rtol=MEAN_RTOL)


@pytest.mark.parametrize("engine", P.ENGINES)
def test_simulate_cells_matches_reference(engine):
    kw = _cells(10, seed=4)
    kwargs = dict(steps=30_000, seed=3, reps=2, engine=engine)
    want = R.simulate_cells(
        R.stack_channels([R.ChannelConfig(**k) for k in kw]), **kwargs)
    got = P.simulate_cells(
        P.stack_channels([P.ChannelConfig(**k) for k in kw]), **kwargs,
        device="cpu")
    assert got.hist.shape == want.hist.shape == (10, P.N_BINS)
    assert_stats_close(want, got)


@pytest.mark.parametrize("engine", P.ENGINES)
def test_simulate_cells_overrides_match_reference(engine):
    """A distribution-sweep batch: base channel plus NaN-masked per-cell
    overrides, kept replicas."""
    base = dict(rho=0.5, kappa=1.3)
    n = 7
    ov = {"rho": np.linspace(0.1, 0.85, n),
          "stall_ns": np.where(np.arange(n) % 2 == 0, 30.0, np.nan),
          "service_jitter_ns": np.where(np.arange(n) < 3, 0.0, np.nan)}
    kwargs = dict(overrides=ov, steps=25_000, seed=8, reps=3, engine=engine,
                  keep_reps=True, warmup=2_000)
    want = R.simulate_cells(R.stack_channels([R.ChannelConfig(**base)] * n),
                            **kwargs)
    got = P.simulate_cells(P.stack_channels([P.ChannelConfig(**base)] * n),
                           **kwargs, device="cpu")
    assert got.hist.shape == want.hist.shape == (3, n, P.N_BINS)
    assert_stats_close(want.reshape(3 * n), got.reshape(3 * n))


# ---------------------------------------------------------------------------
# The port's own contracts.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", P.ENGINES)
def test_stream_ids_and_canonical_chunk_make_cells_independent(engine):
    """With ``stream_ids`` and ``chunk=canonical_chunk(engine)`` a cell's
    histogram is the same alone and inside a wider batch, bit for bit."""
    kw = [dict(rho=r) for r in (0.2, 0.45, 0.7, 0.8, 0.35)]
    ids = np.array([17, 2**31 + 3, 5, 99, 2**32 - 2], np.uint32)
    common = dict(steps=9_000, seed=2, reps=2, engine=engine,
                  chunk=P.canonical_chunk(engine), device="cpu")
    wide = P.simulate_cells(P.stack_channels(
        [P.ChannelConfig(**k) for k in kw]), stream_ids=ids, **common)
    alone = P.simulate_cells(P.stack_channels([P.ChannelConfig(**kw[1])]),
                             stream_ids=ids[1:2], **common)
    np.testing.assert_array_equal(alone.hist[0], wide.hist[1])


@pytest.mark.parametrize("engine", P.ENGINES)
def test_harvest_duty_zero_is_bit_identical(engine):
    kw = [dict(rho=r, kappa=1.5) for r in (0.3, 0.6, 0.8)]
    common = dict(steps=12_000, seed=4, reps=2, engine=engine, device="cpu")
    plain = P.simulate_cells(P.stack_channels(
        [P.ChannelConfig(**k) for k in kw]), **common)
    duty0 = P.simulate_cells(P.stack_channels(
        [P.ChannelConfig(**k, harvest_duty=0.0, harvest_bw_gbps=25.0)
         for k in kw]), **common)
    np.testing.assert_array_equal(plain.hist, duty0.hist)


@pytest.mark.parametrize("engine", P.ENGINES)
def test_keep_reps_merge_equals_merged(engine):
    cha = P.stack_channels([P.ChannelConfig(rho=r) for r in (0.25, 0.65)])
    common = dict(steps=8_000, seed=1, reps=3, engine=engine, device="cpu")
    merged = P.simulate_cells(cha, **common)
    kept = P.simulate_cells(cha, keep_reps=True, **common)
    assert kept.hist.shape == (3, 2, P.N_BINS)
    again = P.merge_reps(kept)
    for f in STATS_FIELDS:
        np.testing.assert_array_equal(getattr(again, f), getattr(merged, f))


@pytest.mark.parametrize("kwargs", [
    dict(reps=0), dict(warmup=5_000), dict(warmup=-1),
    dict(events=500), dict(stream_ids=np.arange(3, dtype=np.uint32)),
    dict(chunk=0), dict(engine="warp"),
])
def test_validation_errors_as_reference(kwargs):
    """The reference's ValueErrors, message for message."""
    args = dict(steps=5_000)
    args.update(kwargs)
    cha_r = R.stack_channels([R.ChannelConfig(rho=0.5)] * 2)
    cha_p = P.stack_channels([P.ChannelConfig(rho=0.5)] * 2)
    with pytest.raises(ValueError) as want:
        R.simulate_cells(cha_r, **args)
    with pytest.raises(ValueError) as got:
        P.simulate_cells(cha_p, **args, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("devices", [2, 4, "auto"])
def test_several_devices_raise(devices, monkeypatch):
    """More devices than the CPU's logical host devices raise, as the
    reference's "exceeds" ("auto": one more than it resolves to)."""
    monkeypatch.setenv(shardsim.ENV_HOST_DEVICES, "1")
    if devices == "auto":
        devices = shardsim.resolve_devices("auto", device="cpu") + 1
    with pytest.raises(ValueError, match="exceeds"):
        P.simulate([P.ChannelConfig(rho=0.5)], steps=2_000, devices=devices,
                   device="cpu")


def test_devices_one_is_the_default():
    cfg = [P.ChannelConfig(rho=0.5)]
    a = P.simulate(cfg, steps=3_000, devices=1, device="cpu")
    b = P.simulate(cfg, steps=3_000, device="cpu")
    np.testing.assert_array_equal(a.hist, b.hist)


def test_load_latency_curve_matches_reference():
    rhos = (0.2, 0.5, 0.75)
    want = R.load_latency_curve(rhos, steps=15_000, reps=3)
    got = P.load_latency_curve(rhos, steps=15_000, reps=3, device="cpu")
    for k in ("mean_ns", "p90_ns", "p99_ns", "stdev_ns"):
        np.testing.assert_allclose(got[k], want[k], rtol=MEAN_RTOL,
                                   atol=QUANTILE_TOL_NS * (k != "mean_ns"))


def test_chunk_rules_and_budgets_as_reference():
    for n in (1, 7, 384, 512, 4032, 100_000):
        assert P._ts_chunk_len(n) == R._ts_chunk_len(n)
        assert P._event_chunk_len(n) == R._event_chunk_len(n)
    for steps in (1, 2_000, 120_000, 200_000):
        assert P.events_for_steps(steps) == R.events_for_steps(steps)
        assert P.default_warmup(steps) == R.default_warmup(steps)
    for e in P.ENGINES:
        assert P.canonical_chunk(e) == R.canonical_chunk(e)
    ids = np.array([0, 5, 2**31, 2**32 - 1], np.uint32)
    np.testing.assert_array_equal(
        P._lane_streams(4, 3, ids).numpy(),
        np.asarray(R._lane_streams(4, 3, ids)).astype(np.int64))
    assert P.CHANNEL_FIELDS == R.CHANNEL_FIELDS
    for f in P.CHANNEL_FIELDS:
        assert getattr(P.ChannelConfig(rho=0.3), f) == \
            getattr(R.ChannelConfig(rho=0.3), f)


# ---------------------------------------------------------------------------
# Host side.
# ---------------------------------------------------------------------------

def test_host_statistics_equal_reference():
    rng = np.random.default_rng(0)
    hist = rng.poisson(rng.uniform(0, 40, size=(6, P.N_BINS))).astype(
        np.float64)
    hist[0] = 0.0                       # an empty cell
    hist[1, :3] = 0.0
    hist[1, -2:] = 50.0                 # mass at both edges
    width = np.array([0.0, 13.5, 2.0, 40.0, 5000.0, 1e-10])
    np.testing.assert_array_equal(P._jitter_kernel(width),
                                  R._jitter_kernel(width))
    conv = P._convolve_jitter(hist, width)
    np.testing.assert_array_equal(conv, R._convolve_jitter(hist, width))
    want, got = R._stats_from_hist(conv), P._stats_from_hist(conv)
    for f in STATS_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    x, c = got[3].cdf()
    wx, wc = want[3].cdf()
    np.testing.assert_array_equal(x, wx)
    np.testing.assert_array_equal(c, wc)
    with pytest.raises(ValueError, match="one cell"):
        got.cdf()
