"""The port's int8 gradient all-reduce (``distributed/int8_collectives``)
against the reference's, and the cost meter's collective bytes
(``core/hloparse``) against the reference's HLO analysis, on the CPU.

The port runs on a real 4-rank gloo world (spawned once,
``torch_mesh_worker``), the reference under ``shard_map`` on the 4 host
devices the root ``conftest.py`` forces.  Quantization rounds half to
even on both sides (``torch.round``, ``jnp.round``).  The reduced values
are held within one output quantum (the step of the requantized slice,
``s2``): the dequantized float32 sum adds its four terms in each
library's own order, so a term one float32 step apart can move a code by
one.  Measured on these inputs: the same tree on every rank bit-equal;
each rank its own, max |d| 2.38e-7 (a requantization scale one float32
step apart; no code moved).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_mesh_worker
from repro.core import hloparse as jhloparse
from repro.distributed import int8_collectives as ji8
from repro_torch.core import hloparse
from repro_torch.distributed import int8_collectives as i8

#: Sizes: one that divides 4 ranks and one that pads (130 -> 132).
SHAPES = {"a": (64, 33), "b": (130,)}
MEASURED_MAX_ABS = {"same": 0.0, "distinct": 2.4e-7}
BYTES_RTOL = 0.01


def _mesh():
    assert len(jax.devices()) >= 4, "conftest forces 4 host devices"
    return Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))


def _inputs():
    gen = np.random.default_rng(11)
    same = {k: gen.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    distinct = {k: gen.standard_normal((4,) + s).astype(np.float32)
                for k, s in SHAPES.items()}
    return dict(same=same, distinct=distinct)


def _reference(case, trees, int8):
    """The reference's reduction and its collective bytes by op."""
    mesh = _mesh()
    if case == "same":
        fn = ji8.make_reducer(mesh, axis="data", int8=int8)
        args = {k: jnp.asarray(x) for k, x in trees.items()}
    else:
        one = ji8.int8_all_reduce if int8 else ji8.f32_all_reduce
        fn = shard_map(
            lambda t: jax.tree_util.tree_map(
                lambda x: one(x[0], "data")[None], t),
            mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
            check_rep=False)
        args = {k: jnp.asarray(x) for k, x in trees.items()}
    jitted = jax.jit(fn)
    out = jax.tree_util.tree_map(np.asarray, jitted(args))
    if case == "distinct":
        out = {k: x[0] for k, x in out.items()}      # every row is the same
    cost = jhloparse.analyze(jitted.lower(args).compile().as_text())
    return out, cost.coll


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    return inputs, torch_mesh_worker.run_world("int8", 4, inputs)


def _quantum(x):
    """Each 1/4 slice's requantization step, spread over the slice."""
    flat = x.reshape(-1)
    n = -(-flat.size // 4)
    pad = np.pad(flat, (0, 4 * n - flat.size)).reshape(4, n)
    s2 = np.abs(pad).max(axis=1) / 127.0 + 1e-12
    return np.repeat(s2, n)[:flat.size].reshape(x.shape)


@pytest.mark.parametrize("case", ["same", "distinct"])
def test_int8_reducer_within_one_quantum_of_reference(world, case):
    inputs, got = world
    want, _ = _reference(case, inputs[case], int8=True)
    worst = 0.0
    for name, x in got[case, "int8"]["tree"].items():
        d = np.abs(x - want[name])
        assert np.all(d <= _quantum(want[name]) * 1.0001), name
        worst = max(worst, float(d.max()))
    assert worst <= MEASURED_MAX_ABS[case], worst


@pytest.mark.parametrize("case", ["same", "distinct"])
def test_f32_reducer_equals_reference(world, case):
    inputs, got = world
    want, _ = _reference(case, inputs[case], int8=False)
    for name, x in got[case, "f32"]["tree"].items():
        np.testing.assert_allclose(x, want[name], rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["int8", "f32"])
def test_collective_bytes_per_op_equal_reference(world, mode):
    inputs, got = world
    _, want = _reference("same", inputs["same"], int8=(mode == "int8"))
    coll = got["same", mode]["coll"]
    assert set(coll) == set(hloparse.COLLECTIVES)
    for op in hloparse.COLLECTIVES:
        np.testing.assert_allclose(coll[op], want[op], rtol=BYTES_RTOL,
                                   err_msg=op)
    # int8 moves all-to-all and all-gather bytes, f32 one all-reduce.
    assert (coll["all-to-all"] > 0) == (mode == "int8")
    assert (coll["all-reduce"] > 0) == (mode == "f32")


def test_quantize_equals_reference_bit_for_bit():
    x = np.concatenate([_inputs()["same"]["a"].reshape(-1),
                        # exact halves of the step: round half to even
                        np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0],
                                 np.float32) * (3.0 / 127.0)])
    q, s = i8._quantize(torch.from_numpy(x))
    jq, js = ji8._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
