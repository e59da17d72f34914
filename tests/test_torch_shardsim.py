"""The port's lane-sharded DES (``repro_torch.core.shardsim``) against the
reference (``repro.core.shardsim``), on the CPU.

The contract: lane-keyed streams, chunk budgets from the unpadded width,
NaN-padded lanes and global-lane histogram rows make a run split over
devices BIT-IDENTICAL to one device, for both engines, at any device
count, divisible or not.  Here the CPU counts as several logical host
devices (``$REPRO_DES_HOST_DEVICES``), whose shards run one after
another; the reference runs on the 4 host devices the root
``conftest.py`` forces.  Every histogram below is held with
``assert_array_equal``: against the port's one-device run and against
the reference's sharded run.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import memsim as R
from repro.core import queuelut as RQ
from repro_torch.core import coaxial, memsim, queuelut, shardsim
from repro_torch.core.memsim import ChannelConfig

#: Five heterogeneous cells (test_shardsim's): 5 lanes do not divide 2, 3
#: or 4 devices, so the NaN-padding path runs at every count.
CELLS = [dict(rho=0.3), dict(rho=0.6, kappa=2.0),
         dict(rho=0.8, outstanding=8.0), dict(rho=0.5, cxl_lat_ns=60.0),
         dict(rho=0.7, eta=0.3)]
STEPS = 4_000
HOST_DEVICES = 4


@pytest.fixture(autouse=True)
def host_devices(monkeypatch):
    """The CPU as 4 logical host devices, one torch thread (the suite runs
    in several worker processes at once)."""
    monkeypatch.setenv(shardsim.ENV_HOST_DEVICES, str(HOST_DEVICES))
    monkeypatch.delenv(shardsim.ENV_DEVICES, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(cells, **kw):
    return memsim.simulate_cells(memsim.stack_channels(
        [ChannelConfig(**c) for c in cells]), device="cpu", **kw)


def _reference(cells, **kw):
    assert len(jax.devices()) >= 4, "conftest forces 4 host devices"
    return R.simulate_cells(R.stack_channels(
        [R.ChannelConfig(**c) for c in cells]), devices=4, **kw)


class TestResolveDevices:
    def test_default_is_one(self):
        assert shardsim.resolve_devices(device="cpu") == 1

    def test_env_knob(self, monkeypatch):
        monkeypatch.setenv(shardsim.ENV_DEVICES, "2")
        assert shardsim.resolve_devices(device="cpu") == 2
        monkeypatch.setenv(shardsim.ENV_DEVICES, "auto")
        assert shardsim.resolve_devices(device="cpu") == HOST_DEVICES

    def test_explicit_wins_over_env(self, monkeypatch):
        monkeypatch.setenv(shardsim.ENV_DEVICES, "2")
        assert shardsim.resolve_devices(1, device="cpu") == 1
        assert shardsim.resolve_devices("auto", device="cpu") == HOST_DEVICES

    def test_rejects_bad_values(self, monkeypatch):
        with pytest.raises(ValueError, match=">= 1"):
            shardsim.resolve_devices(0, device="cpu")
        with pytest.raises(ValueError, match="exceeds"):
            shardsim.resolve_devices(HOST_DEVICES + 1, device="cpu")
        with pytest.raises(ValueError, match="int, 'auto' or None"):
            shardsim.resolve_devices("fast", device="cpu")
        monkeypatch.setenv(shardsim.ENV_HOST_DEVICES, "0")
        with pytest.raises(ValueError, match=">= 1"):
            shardsim.resolve_devices(2, device="cpu")

    def test_pad_width(self):
        assert shardsim.pad_width(5, 4) == 3
        assert shardsim.pad_width(8, 4) == 0
        assert shardsim.pad_width(1, 1) == 0

    def test_cuda_counts_cards_and_never_reads_host_devices(
            self, monkeypatch):
        """On CUDA the count is the cards'; asking for more raises, and the
        CPU's logical host devices play no part."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setenv(shardsim.ENV_HOST_DEVICES, "8")
        assert shardsim.resolve_devices("auto", device="cuda") == 2
        assert shardsim.resolve_devices(2, device="cuda") == 2
        with pytest.raises(ValueError, match="exceeds the 2 CUDA card"):
            shardsim.resolve_devices(3, device="cuda")
        assert [str(d) for d, in zip(shardsim.local_devices("cuda"))] == [
            "cuda:0", "cuda:1"]

    def test_shards_split_lanes_in_order(self):
        parts = shardsim.shards(8, 4, "cpu")
        assert [(sl.start, sl.stop) for sl, _ in parts] == [
            (0, 2), (2, 4), (4, 6), (6, 8)]


@pytest.mark.parametrize("engine", memsim.ENGINES)
def test_nondivisible_cells_bit_identical(engine):
    """5 lanes over 2, 3 and 4 devices (3, 1 and 3 NaN pad lanes)."""
    kw = dict(steps=STEPS, seed=7, engine=engine)
    one = _port(CELLS, devices=1, **kw)
    want = _reference(CELLS, **kw)
    np.testing.assert_array_equal(one.hist, want.hist)
    for ndev in (2, 3, 4):
        got = _port(CELLS, devices=ndev, **kw)
        np.testing.assert_array_equal(got.hist, one.hist, err_msg=ndev)
        np.testing.assert_array_equal(got.mean_ns, one.mean_ns)


@pytest.mark.parametrize("engine", memsim.ENGINES)
def test_reps_and_keep_reps_bit_identical(engine):
    """5 cells x 3 reps = 15 lanes (reps-tiled lanes keep their global
    indices), merged and kept per replica."""
    kw = dict(steps=4_000, seed=3, reps=3, engine=engine)
    want = _reference(CELLS, **kw)
    for ndev in (1, 3):
        got = _port(CELLS, devices=ndev, **kw)
        np.testing.assert_array_equal(got.hist, want.hist, err_msg=ndev)
    kept_ref = _reference(CELLS[:2], keep_reps=True, **kw)
    for ndev in (1, 2, 4):
        kept = _port(CELLS[:2], devices=ndev, keep_reps=True, **kw)
        assert kept.hist.shape == (3, 2, memsim.N_BINS)
        np.testing.assert_array_equal(kept.hist, kept_ref.hist,
                                      err_msg=ndev)


def test_devices_none_honours_env(monkeypatch):
    monkeypatch.setenv(shardsim.ENV_DEVICES, "3")
    a = _port(CELLS[:3], steps=3_000, seed=1)
    monkeypatch.delenv(shardsim.ENV_DEVICES)
    b = _port(CELLS[:3], steps=3_000, seed=1)
    np.testing.assert_array_equal(a.hist, b.hist)


def test_distribution_sweep_device_invariant():
    kw = dict(rho=(0.3, 0.7), outstanding=(8.0, 256.0), steps=3_000,
              reps=2, device="cpu")
    a = coaxial.distribution_sweep(devices=1, **kw)
    b = coaxial.distribution_sweep(devices=3, **kw)
    np.testing.assert_array_equal(a.stats.hist, b.stats.hist)
    np.testing.assert_array_equal(a.stats.mean_ns, b.stats.mean_ns)


def test_build_queue_lut_device_invariant_and_equal_to_reference():
    kw = dict(rho=(0.3, 0.7), kappa=(1.0, 2.0), outstanding=(8.0, 256.0),
              eta=(0.3, 1.0), steps=3_000, reps=1)
    a = queuelut.build_queue_lut(devices=1, device="cpu", **kw)
    b = queuelut.build_queue_lut(devices=4, device="cpu", **kw)
    want = RQ.build_queue_lut(devices=4, **kw)
    for field in ("wait_ns", "sigma_ns"):
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      np.asarray(getattr(b, field)))
        np.testing.assert_array_equal(np.asarray(getattr(b, field)),
                                      np.asarray(getattr(want, field)))


def test_validate_calibration_device_invariant():
    kw = dict(rhos=(0.4,), steps=3_000, reps=4, device="cpu")
    a = coaxial.validate_calibration(devices=1, **kw)
    b = coaxial.validate_calibration(devices=3, **kw)
    assert a["anchors"][0]["des_mean_ns"] == b["anchors"][0]["des_mean_ns"]
