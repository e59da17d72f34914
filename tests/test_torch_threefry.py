"""The port's Threefry generator against ``jax.random``, bit for bit.

``repro_torch.core.threefry`` reproduces JAX's partitionable Threefry
scheme in integer torch ops; every draw here must equal JAX's exactly.
The reference runs under ``jax.threefry_partitionable(True)``, the scheme
the port reproduces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memsim as ref_memsim
from repro_torch.core import threefry

SEEDS = (0, 1, 3, 42, 2**31 - 1, 2**32 - 1)
LANES = np.array([0, 1, 2, 7, 1000, 2**31 - 1, 2**31, 2**31 + 12345,
                  0x9E3779B9, 2**32 - 1], np.uint32)


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


def jax_key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


def as_words(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def torch_key(words) -> torch.Tensor:
    return torch.from_numpy(as_words(words))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(threefry.prng_key(seed).numpy(),
                                  as_words(jax_key(seed)))


@pytest.mark.parametrize("n", [1, 2, 7, 8, 25, 64])
def test_split(n):
    key = jax.random.PRNGKey(3)
    want = as_words(jax.random.key_data(jax.random.split(key, n)))
    got = threefry.split(torch_key(jax.random.key_data(key)), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_split_of_split():
    phase, root = jax.random.split(jax.random.PRNGKey(9))
    want = as_words(jax.random.key_data(jax.random.split(root, 5)))
    p_phase, p_root = threefry.split(threefry.prng_key(9), 2)
    np.testing.assert_array_equal(as_words(jax.random.key_data(phase)),
                                  p_phase.numpy())
    np.testing.assert_array_equal(threefry.split(p_root, 5).numpy(), want)


@pytest.mark.parametrize("seed", [0, 5])
def test_fold_in_over_lanes(seed):
    """Lane ids as the memsim streams carry them, including uint32 values
    at and above 2**31."""
    key = jax.random.PRNGKey(seed)
    want = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        key, jnp.asarray(LANES))
    got = threefry.fold_in(torch_key(jax.random.key_data(key)),
                           torch.from_numpy(LANES.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(),
                                  as_words(jax.random.key_data(want)))


@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (3, 5), (1025, 2)])
def test_random_bits(shape):
    key = jax.random.PRNGKey(11)
    want = as_words(jax.random.bits(key, shape, dtype=jnp.uint32))
    got = threefry.random_bits(torch_key(jax.random.key_data(key)), shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("minval", [0.0, 1e-12])
@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (3, 5), (1025, 2),
                                   (2, 333)])
def test_uniform(shape, minval):
    key = jax.random.split(jax.random.PRNGKey(4), 3)[1]
    want = np.asarray(jax.random.uniform(key, shape, minval=minval))
    got = threefry.uniform(torch_key(jax.random.key_data(key)), shape,
                           minval=minval).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("minval", [0.0, 1e-12])
@pytest.mark.parametrize("lanes", ["positional", "stream_ids"])
def test_lane_uniform_equals_reference_lane_uniforms(lanes, minval):
    """One stream per lane (``fold_in(key, lane)``), shape + (n,), as the
    reference's ``memsim._lane_uniforms``, for positional int32 lane ids
    and for uint32 stream ids."""
    ids = (np.arange(9, dtype=np.int32) if lanes == "positional"
           else LANES)
    key = jax.random.split(jax.random.PRNGKey(0), 4)[3]
    kw = {"minval": minval} if minval else {}
    want = np.asarray(ref_memsim._lane_uniforms(key, jnp.asarray(ids),
                                                (64, 5), **kw))
    got = threefry.lane_uniform(torch_key(jax.random.key_data(key)),
                                torch.from_numpy(ids.astype(np.int64)),
                                (64, 5), minval=minval).numpy()
    assert got.shape == want.shape == (64, 5, ids.size)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # The draw-major layout of the timestep engine: the same draws.
    major = threefry.lane_uniform(torch_key(jax.random.key_data(key)),
                                  torch.from_numpy(ids.astype(np.int64)),
                                  (64, 5), minval=minval, dims=(1, 0))
    assert major.is_contiguous()
    np.testing.assert_array_equal(major.numpy(),
                                  np.moveaxis(want, 1, 0))
