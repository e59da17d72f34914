"""The port's QueueLUT builds and store against the JAX reference, on the CPU.

* **Builds, bit for bit.**  The port's DES draws the reference's streams
  and its scans equal the reference's, so a port-built QueueLUT equals a
  reference-built one exactly (``np.array_equal`` on every float32 leaf)
  on ``tests/test_lutstore.py``'s grids: both engines, with and without a
  2-point harvest axis, and grown by ``base_lut=`` from the sub-grid.  A
  cell whose draws met the one known rounding difference (XLA's fused
  log of a tiny argument, ``ROADMAP.md``) would show here as a mismatch:
  none does at these sizes.
* **The store** (``core/lutstore``): warm reads are bit-identical and
  run no DES (``memsim.sim_call_count`` flat, the builder patched to
  fail); a fingerprint change rebuilds; a corrupt artifact is
  quarantined; ``gc``; a disabled store still builds; the bounded
  in-process layer; and the port's entries live in
  ``$REPRO_LUT_CACHE/torch``, so both packages' ``gc`` leave each
  other's surfaces alone in one shared directory.
* **The CLI** ``python -m repro_torch.lut`` on the CPU.

Budgets are tiny (3,000 steps, 1 replica): the contract is bitwise, not
statistical.  Batch widths avoid the 12 and 56 lanes of the reference's
trace-count tests, whose jit caches must be cold in their worker.
"""

import numpy as np
import pytest
import torch

from repro.core import lutstore as jstore
from repro.core import queuelut as jq
from repro_torch import lut as cli
from repro_torch.core import lutstore, memsim, queuelut
from repro_torch.core.memsim import ChannelConfig

STEPS, SEED, REPS = 3_000, 0, 1
GRID = dict(rho=(0.2, 0.5, 0.8), kappa=(1.0, 2.0),
            outstanding=(8.0, 64.0), eta=(0.3, 1.0))
SUBGRID = dict(rho=(0.2, 0.8), kappa=(1.0, 2.0),
               outstanding=(8.0, 64.0), eta=(0.3, 1.0))
HARVESTS = [None, (0.0, 0.5)]


def leaves(lut):
    """A QueueLUT of either package as numpy arrays (None kept)."""
    return [None if x is None else
            (x.numpy() if torch.is_tensor(x) else np.asarray(x))
            for x in lut]


def lut_equal(a, b) -> bool:
    return all((x is None) == (y is None)
               and (x is None or (x.dtype == y.dtype
                                  and np.array_equal(x, y)))
               for x, y in zip(leaves(a), leaves(b)))


@pytest.fixture(scope="module")
def ref_builds():
    """Reference builds on GRID, made once per (engine, harvest)."""
    cache = {}

    def get(engine, harvest):
        key = (engine, harvest)
        if key not in cache:
            cache[key] = jq.build_queue_lut(
                **GRID, steps=STEPS, seed=SEED, reps=REPS, engine=engine,
                harvest=harvest)
        return cache[key]
    return get


@pytest.fixture()
def store(tmp_path, monkeypatch):
    """A fresh shared store root and empty in-process layers."""
    monkeypatch.setenv(lutstore.ENV_VAR, str(tmp_path / "lut"))
    lutstore.clear_lut_cache()
    jstore.clear_lut_cache()
    yield tmp_path / "lut"
    lutstore.clear_lut_cache()
    jstore.clear_lut_cache()


def port_build(grid=GRID, **kw):
    kw = dict(dict(steps=STEPS, seed=SEED, reps=REPS, device="cpu"), **kw)
    return queuelut.build_queue_lut(**grid, **kw)


# --- builds -------------------------------------------------------------------

@pytest.mark.parametrize("engine", memsim.ENGINES)
@pytest.mark.parametrize("harvest", HARVESTS, ids=["4d", "harvest"])
def test_build_equals_reference_bit_for_bit(ref_builds, engine, harvest):
    got = port_build(engine=engine, harvest=harvest)
    want = ref_builds(engine, harvest)
    assert lut_equal(got, want)
    assert got.wait_ns.dtype == torch.float32
    assert got.wait_ns.device.type == "cpu"


@pytest.mark.parametrize("engine", memsim.ENGINES)
@pytest.mark.parametrize("harvest", HARVESTS, ids=["4d", "harvest"])
def test_merge_equals_scratch_and_reference(ref_builds, engine, harvest):
    base = port_build(SUBGRID, engine=engine, harvest=harvest)
    calls = memsim.sim_call_count()
    grown = port_build(engine=engine, harvest=harvest, base_lut=base)
    assert memsim.sim_call_count() == calls + 1     # the missing cells only
    assert lut_equal(grown, port_build(engine=engine, harvest=harvest))
    assert lut_equal(grown, ref_builds(engine, harvest))


def test_merge_of_a_covering_base_runs_no_des():
    full = port_build(engine="event")
    calls = memsim.sim_call_count()
    again = port_build(SUBGRID, engine="event", base_lut=full)
    assert memsim.sim_call_count() == calls
    assert lut_equal(again, port_build(SUBGRID, engine="event"))


def test_cell_stream_ids_equal_reference():
    rng = np.random.default_rng(7)
    names = ("rho", "kappa", "outstanding", "eta", "harvest_duty")
    coords = np.column_stack([rng.uniform(0, 1, 64), rng.uniform(1, 4, 64),
                              rng.uniform(1, 200, 64), rng.uniform(0, 1, 64),
                              rng.uniform(0, 0.9, 64)])
    got = queuelut.cell_stream_ids(names, coords)
    assert got.dtype == np.uint32
    assert np.array_equal(got, jq.cell_stream_ids(names, coords))
    assert np.array_equal(queuelut.cell_stream_ids(names[:4], coords[:, :4]),
                          jq.cell_stream_ids(names[:4], coords[:, :4]))
    # Keyed by coordinates, not order.
    rev = queuelut.cell_stream_ids(names, coords[::-1])
    assert np.array_equal(rev, got[::-1])


@pytest.mark.parametrize("engine", memsim.ENGINES)
def test_subset_batch_reproduces_superset_cells(engine):
    cfgs = [ChannelConfig(rho=r, kappa=k)
            for r in (0.3, 0.6, 0.85) for k in (1.0, 2.2)]
    coords = np.asarray([[c.rho, c.kappa] for c in cfgs])
    sids = queuelut.cell_stream_ids(("rho", "kappa"), coords)
    kw = dict(steps=STEPS, seed=SEED, reps=2, engine=engine,
              chunk=memsim.canonical_chunk(engine), device="cpu")
    full = memsim.simulate_cells(memsim.stack_channels(cfgs),
                                 stream_ids=sids, **kw)
    pick = np.asarray([1, 4, 5])
    sub = memsim.simulate_cells(
        memsim.stack_channels([cfgs[i] for i in pick]),
        stream_ids=sids[pick], **kw)
    assert np.array_equal(sub.hist, full.hist[pick])


def test_grid_validation_and_axis_count_mismatch_match_reference():
    base = port_build(SUBGRID, engine="event")
    with pytest.raises(ValueError, match="harvest"):
        port_build(engine="event", harvest=(0.0, 0.5), base_lut=base)
    for bad in (dict(GRID, rho=(0.5,)), dict(GRID, kappa=(2.0, 1.0)),
                dict(GRID, outstanding=(0.0, 8.0))):
        with pytest.raises(ValueError) as e_port:
            port_build(bad)
        with pytest.raises(ValueError) as e_ref:
            jq.build_queue_lut(**bad, steps=STEPS, reps=REPS)
        assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        port_build(harvest=(0.0, 1.0))


# --- the store ----------------------------------------------------------------

@pytest.mark.parametrize("engine", memsim.ENGINES)
@pytest.mark.parametrize("harvest", HARVESTS, ids=["4d", "harvest"])
def test_warm_read_bit_identical_zero_des(store, monkeypatch, engine,
                                          harvest):
    kw = dict(steps=STEPS, seed=SEED, reps=REPS, engine=engine,
              harvest=harvest, device="cpu")
    cold = queuelut.resolve_lut(**GRID, **kw)
    assert list(store.glob("torch/qlut-*.npz"))
    lutstore.clear_lut_cache()
    monkeypatch.setattr(
        queuelut, "build_queue_lut",
        lambda *a, **k: pytest.fail("warm read ran the DES"))
    calls = memsim.sim_call_count()
    warm = queuelut.resolve_lut(**GRID, **kw)
    assert memsim.sim_call_count() == calls
    assert lut_equal(cold, warm)
    assert all(x is None or x.device.type == "cpu" for x in warm)


def test_mem_layer_serves_without_disk(store):
    a = queuelut.resolve_lut(**GRID, steps=STEPS, reps=REPS, device="cpu")
    for f in store.glob("torch/qlut-*.npz"):
        f.unlink()
    assert queuelut.resolve_lut(**GRID, steps=STEPS, reps=REPS,
                                device="cpu") is a


def test_fingerprint_mismatch_forces_rebuild(store, monkeypatch):
    kw = dict(steps=STEPS, reps=REPS, device="cpu")
    cold = queuelut.resolve_lut(**GRID, **kw)
    lutstore.clear_lut_cache()
    monkeypatch.setattr(lutstore, "_fingerprint_memo", "f" * 64)
    calls = memsim.sim_call_count()
    again = queuelut.resolve_lut(**GRID, **kw)
    assert memsim.sim_call_count() == calls + 1     # a miss: rebuilt
    assert lut_equal(cold, again)
    assert len(list(store.glob("torch/qlut-*.npz"))) == 2


def test_fingerprint_hashes_the_ports_simulator_sources():
    names = lutstore._FINGERPRINT_SOURCES
    assert "kernels/csrc/memsim_scan.cu" in names
    assert {"core/memsim.py", "core/threefry.py", "core/xlamath.py",
            "core/queuelut.py", "kernels/memsim_scan.py",
            "kernels/ref.py"} <= set(names)
    assert lutstore.mechanism_fingerprint() != \
        jstore.mechanism_fingerprint()


def test_corrupt_artifact_quarantined_not_crashed(store):
    kw = dict(steps=STEPS, reps=REPS, device="cpu")
    cold = queuelut.resolve_lut(**GRID, **kw)
    (path,) = store.glob("torch/qlut-*.npz")
    path.write_bytes(path.read_bytes()[:100])
    lutstore.clear_lut_cache()
    again = queuelut.resolve_lut(**GRID, **kw)
    assert lut_equal(cold, again)
    assert list(store.glob("torch/*.corrupt"))


def test_gc_drops_stale_and_aged(store, monkeypatch):
    queuelut.resolve_lut(**GRID, steps=STEPS, reps=REPS, device="cpu")
    (store / "torch" / "junk.npz.corrupt").write_bytes(b"x")
    assert lutstore.gc() == dict(removed=1, bytes=1)
    assert len(lutstore.entries()) == 1
    assert lutstore.gc(max_age_days=1.0)["removed"] == 0
    assert lutstore.gc(max_age_days=-1.0)["removed"] == 1
    queuelut.resolve_lut(**SUBGRID, steps=STEPS, reps=REPS, device="cpu")
    monkeypatch.setattr(lutstore, "_fingerprint_memo", "f" * 64)
    assert lutstore.gc()["removed"] == 1             # stale fingerprint
    assert lutstore.entries() == []


def test_store_disabled_still_builds(monkeypatch):
    monkeypatch.delenv(lutstore.ENV_VAR, raising=False)
    lutstore.clear_lut_cache()
    assert lutstore.cache_dir() is None and lutstore.entries() == []
    lut = queuelut.resolve_lut(**GRID, steps=STEPS, reps=REPS, device="cpu")
    assert tuple(lut.wait_ns.shape) == (3, 2, 2, 2)
    assert lutstore.gc() == dict(removed=0, bytes=0)
    lutstore.clear_lut_cache()


def test_bounded_and_clearable():
    lutstore.clear_lut_cache()
    for i in range(lutstore.MEM_CACHE_MAX + 3):
        lutstore.cache_put(f"k{i}", i)
    assert len(lutstore._mem_cache) == lutstore.MEM_CACHE_MAX
    assert lutstore.cache_get("k0") is None
    assert lutstore.cache_get(f"k{lutstore.MEM_CACHE_MAX + 2}") == \
        lutstore.MEM_CACHE_MAX + 2
    queuelut.clear_lut_cache()
    assert len(lutstore._mem_cache) == 0


def test_shared_directory_keeps_both_packages_surfaces(store):
    kw = dict(steps=STEPS, seed=SEED, reps=REPS)
    ref = jq.resolve_lut(**GRID, **kw)
    port = queuelut.resolve_lut(**GRID, **kw, device="cpu")
    assert lut_equal(port, ref)
    ref_files = sorted(store.glob("qlut-*.npz"))
    port_files = sorted(store.glob("torch/qlut-*.npz"))
    assert len(ref_files) == 1 and len(port_files) == 1
    assert jstore.gc()["removed"] == 0
    assert lutstore.gc()["removed"] == 0
    assert sorted(store.glob("qlut-*.npz")) == ref_files
    assert sorted(store.glob("torch/qlut-*.npz")) == port_files
    # Each package still reads its own surface warm.
    lutstore.clear_lut_cache()
    jstore.clear_lut_cache()
    calls = memsim.sim_call_count()
    assert lut_equal(queuelut.resolve_lut(**GRID, **kw, device="cpu"), ref)
    assert memsim.sim_call_count() == calls
    assert lut_equal(jq.resolve_lut(**GRID, **kw), ref)


def test_key_leaves_out_the_device(store, monkeypatch):
    kw = dict(steps=STEPS, reps=REPS)
    cold = queuelut.resolve_lut(**GRID, **kw, device="cpu")
    lutstore.clear_lut_cache()
    monkeypatch.setattr(
        queuelut, "build_queue_lut",
        lambda *a, **k: pytest.fail("a device change rebuilt the surface"))
    # A surface built on one device serves another without a build.
    assert lut_equal(queuelut.resolve_lut(**GRID, **kw, device="cuda"), cold)


# --- the CLI ------------------------------------------------------------------

def test_lut_cli_prebuild_inspect_gc(store, capsys):
    args = ["prebuild", "--device", "cpu", "--steps", str(STEPS),
            "--reps", "1"]
    assert cli.main(args) == 0
    first = capsys.readouterr().out
    assert "sim_calls=1" in first and "(warm)" not in first
    assert "shape=(14, 6, 6, 4)" in first
    lutstore.clear_lut_cache()
    assert cli.main(args) == 0
    assert "sim_calls=0" in capsys.readouterr().out
    assert cli.main(["inspect"]) == 0
    out = capsys.readouterr().out
    assert "1 surface(s)" in out and "engine=event" in out
    assert "[STALE]" not in out
    # Refinement stores every round's grown grid beside the surface.
    assert cli.main(["prebuild", "--refine", "--device", "cpu", "--steps",
                     str(STEPS), "--reps", "1"]) == 0
    assert "refine[event]: " in capsys.readouterr().out
    n = len(lutstore.entries())
    assert n > 1
    assert cli.main(["gc", "--all"]) == 0
    assert f"removed {n} file(s)" in capsys.readouterr().out
    assert lutstore.entries() == []


def test_lut_cli_without_a_store(monkeypatch, capsys):
    monkeypatch.delenv(lutstore.ENV_VAR, raising=False)
    assert cli.main(["inspect"]) == 1
    assert "unset" in capsys.readouterr().out
