"""The port's STREAM ops (K1a-d) against the reference's Pallas kernels.

On the CPU, ``repro_torch.kernels.ops.stream_*`` run the plain versions
``ref.stream_*_ref``; the same numpy inputs go through the JAX kernels of
``repro.kernels.stream`` in interpret mode (as the reference's own tests
run them) and the outputs are held EQUAL (tolerance 0): the plain versions
round alpha to the arrays' type, round the float32 triad once and round
alpha * b to bfloat16 before the bfloat16 triad's add, as the reference
does.  The hand CUDA kernels are held to the plain versions in
``test_torch_cuda.py``, which runs only where there is a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import stream as jstream
from repro_torch.kernels import ops, ref
from repro_torch.kernels import stream as ks
from repro_torch.launch import stream as probe

# tests/test_kernels.py's shapes and dtypes, and its ragged-row shape.
SHAPES = [(128, 128), (512, 256), (1024, 384), (2048, 128), (300, 128)]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _inputs(seed, shape, dtypes):
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tdt, jdt = dtypes
    return ((torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)),
            (jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)))


def _assert_equal(got, want):
    """Bit for bit, compared in float32 (both types widen exactly)."""
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("alpha", [0.1, 2.5])
def test_stream_ops_equal_reference_kernels(shape, dtypes, alpha):
    (a, b), (ja, jb) = _inputs(0, shape, dtypes)
    outs = {"copy": (ops.stream_copy(a), jstream.stream_copy(
                ja, interpret=True)),
            "scale": (ops.stream_scale(a, alpha), jstream.stream_scale(
                ja, alpha, interpret=True)),
            "add": (ops.stream_add(a, b), jstream.stream_add(
                ja, jb, interpret=True)),
            "triad": (ops.stream_triad(a, b, alpha), jstream.stream_triad(
                ja, jb, alpha, interpret=True))}
    for name, (got, want) in outs.items():
        assert got.dtype == a.dtype and got.shape == a.shape, name
        _assert_equal(got, want)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_rounding_that_a_naive_version_misses(dtypes):
    """The reference rounds alpha to the arrays' type (bf16 scale) and
    rounds the f32 triad once; keeping alpha in f32, or rounding the f32
    product before the add, differs from it in many elements."""
    (a, b), (ja, jb) = _inputs(1, (512, 256), dtypes)
    want_scale = np.asarray(jstream.stream_scale(ja, 0.1, interpret=True)
                            .astype(jnp.float32))
    want_triad = np.asarray(jstream.stream_triad(ja, jb, 0.1, interpret=True)
                            .astype(jnp.float32))
    if a.dtype == torch.bfloat16:
        naive = (a * torch.tensor(0.1)).to(a.dtype)   # alpha kept in f32
        assert (naive.float().numpy() != want_scale).sum() > 1000
    else:
        naive = a + b * 0.1                           # two roundings
        assert (naive.numpy() != want_triad).sum() > 1000
    np.testing.assert_array_equal(ops.stream_scale(a, 0.1).float().numpy(),
                                  want_scale)
    np.testing.assert_array_equal(
        ops.stream_triad(a, b, 0.1).float().numpy(), want_triad)


def test_stream_copy_keeps_every_bit():
    a = torch.tensor([0.0, -0.0, float("inf"), -1.5, float("nan")])
    out = ops.stream_copy(a)
    assert out.data_ptr() != a.data_ptr()
    assert torch.equal(out.view(torch.int32), a.view(torch.int32))


@pytest.mark.parametrize("name", ["copy", "scale", "add", "triad"])
@pytest.mark.parametrize("shape", SHAPES + [(2048, 512), (7,)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_stream_bytes_equals_reference(name, shape, dtypes):
    tdt, jdt = dtypes
    assert ks.stream_bytes(name, shape, tdt) == \
        jstream.stream_bytes(name, shape, jdt)


def test_ops_raise_on_mixed_devices():
    """A CUDA tensor beside a CPU one is refused before any kernel runs
    (the meta device stands in for the card, which this host lacks)."""
    a = torch.ones(64)
    other = torch.ones(64, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        ops.stream_add(a, other)
    with pytest.raises(ValueError, match="mixed"):
        ops.stream_triad(other, a, 2.0)
    with pytest.raises(ValueError, match="mixed|unsupported"):
        ops.stream_copy(other)


def test_round_to_matches_the_reference_cast():
    for alpha in (0.1, 2.5, 1 / 3, 1e-8, 3e38):
        for tdt, jdt in DTYPES:
            assert ref.round_to(alpha, tdt) == float(
                jnp.asarray([alpha], jdt)[0])


def test_probe_smoke_on_cpu(capsys):
    kernels = list(ks.KERNELS.values())
    before = [k.launches for k in kernels]
    res = probe.main(["--device", "cpu", "--smoke", "--iters", "2"])
    out = capsys.readouterr().out
    assert set(res) == {"copy", "scale", "add", "triad"}
    for name, row in res.items():
        assert f"stream.{name}.bytes," in out
        assert row["bytes"] == ks.stream_bytes(name, probe.REF_SHAPE)
        # No device metric from a CPU run.
        assert row["gbps"] is row["bound_ms"] is row["hbm_fraction"] is None
    assert "hbm_fraction" not in out
    assert [k.launches for k in kernels] == before


def test_probe_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        probe.main(["--n", "64"])
