"""The port's ``core/workloads`` against the JAX reference.

The Table-4 data is the port's own copy: every workload is held equal to
``repro.core.workloads`` field by field, and ``as_arrays`` to the
reference's float64 table rounded once to float32 (what the reference's
solver computes on without x64).  Registry semantics are the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import workloads as jw
from repro_torch.core import coaxial, workloads


@pytest.mark.parametrize("name", jw.NAMES)
def test_workload_equals_reference(name):
    got = dataclasses.asdict(workloads.by_name(name))
    want = dataclasses.asdict(jw.by_name(name))
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_table_and_names_equal_reference():
    assert workloads.NAMES == jw.NAMES
    assert workloads.SUITES == jw.SUITES
    assert workloads.SWEEPABLE_FIELDS == jw.SWEEPABLE_FIELDS
    assert len(workloads.WORKLOADS) == 35
    assert [dataclasses.asdict(w) for w in workloads.WORKLOADS] == \
        [dataclasses.asdict(w) for w in jw.WORKLOADS]


def test_as_arrays_is_the_reference_table_in_float32():
    got = workloads.as_arrays(device="cpu")
    want = jw.as_arrays()
    assert got.name == want.name and len(got) == len(want) == 35
    for f in workloads.SWEEPABLE_FIELDS:
        t = getattr(got, f)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(
            t.numpy(), getattr(want, f).astype(np.float32))
    sub = workloads.as_arrays(workloads.WORKLOADS[:3], device="cpu",
                              dtype=torch.float64)
    np.testing.assert_array_equal(sub.mpki.numpy(), want.mpki[:3])


def test_the_card_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        workloads.as_arrays()
    assert workloads.resolve_device("cpu") == torch.device("cpu")


def test_registry_semantics():
    w0 = workloads.by_name("lbm")
    with coaxial.scoped_registry():
        # Re-registering the same workload is a no-op returning the entry.
        assert workloads.register_workload(
            dataclasses.replace(w0)) is w0
        other = dataclasses.replace(w0, mpki=65.0)
        with pytest.raises(ValueError, match="already registered"):
            workloads.register_workload(other)
        assert workloads.register_workload(other, overwrite=True) is other
        new = dataclasses.replace(w0, name="lbm-copy")
        workloads.register_workload(new)
        assert workloads.all_workloads()[-1] is new
        assert workloads.unregister_workload("lbm-copy") is new
        with pytest.raises(KeyError, match="unknown workload"):
            workloads.by_name("lbm-copy")
    assert workloads.by_name("lbm") is w0
    assert workloads.all_workloads() == workloads.WORKLOADS


def test_registering_a_workload_clears_the_sweep_cache():
    coaxial.default_sweep("cpu")
    assert coaxial.default_sweep.cache_info().currsize >= 1
    with coaxial.scoped_registry():
        workloads.register_workload(
            dataclasses.replace(workloads.by_name("mcf"), name="mcf-2"))
        assert coaxial.default_sweep.cache_info().currsize == 0
