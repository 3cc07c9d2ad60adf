"""fava_tpu_torch's Threefry PRNG held to fava_tpu's, on the CPU.

The draws must be bit-exact: the structure functions and the increment
PDFs of both packages sample the same point pairs only if every word
agrees. Tolerance: none (words, uniforms and integers compared exactly).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fava_tpu.utils import prng as jprng
from fava_tpu_torch.utils import prng

SEEDS = [0, 2**40 + 5, 2**64 - 1]
STREAMS = [0, 29, 1 << 17]


def test_random123_known_answer():
    x0, x1 = prng.threefry2x32(0, 0, 0, 0)
    assert (hex(int(x0)), hex(int(x1))) == ("0x6b200159", "0x99ba4efe")


def test_threefry_words_equal_fava_tpu_on_random_keys_and_counters():
    rng = np.random.default_rng(0)
    k0, k1 = (int(k) for k in rng.integers(0, 2**32, 2))
    x0, x1 = rng.integers(0, 2**32, (2, 64), dtype=np.uint64)
    ref = jprng.threefry2x32(np.uint32(k0), np.uint32(k1), x0.astype(np.uint32), x1.astype(np.uint32))
    got = prng.threefry2x32(k0, k1, torch.from_numpy(x0.astype(np.int64)),
                            torch.from_numpy(x1.astype(np.int64)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stream", STREAMS)
def test_draws_equal_fava_tpu(seed, stream):
    shape = (7, 5, 3)
    np.testing.assert_array_equal(prng.random_bits(seed, stream, shape).numpy(),
                                  np.asarray(jprng.random_bits(seed, stream, shape)).astype(np.int64))
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        got = prng.uniform(seed, stream, shape, tdt)
        ref = np.asarray(jprng.uniform(seed, stream, shape, jdt))
        assert got.dtype == tdt and got.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(got.numpy(), ref)
        assert (got >= 0).all() and (got < 1).all()
    for maxval in (1, 12, 1000003):
        got = prng.randint(seed, stream, shape, maxval)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jprng.randint(seed, stream, shape, maxval)))


def test_split_seed_equals_the_int_seed():
    seed = (3 << 32) + 17
    assert prng._key(seed) == (3, 17) == prng._key((3, 17))
    np.testing.assert_array_equal(prng.random_bits((3, 17), 4, (9,)).numpy(),
                                  prng.random_bits(seed, 4, (9,)).numpy())
    assert prng._key(-1) == (2**32 - 1, 2**32 - 1)  # taken mod 2^64, as fava_tpu
    with pytest.raises(TypeError):
        prng._key(1.5)


def test_stream_tensor_broadcasts_like_fava_tpu():
    streams = np.array([[0], [1], [29]], dtype=np.int64)
    got = prng.random_bits(5, torch.from_numpy(streams), (3, 4))
    ref = jprng.random_bits(5, jnp.asarray(streams, dtype=jnp.uint32), (3, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("shape", [(1 << 32,), (1 << 16, 1 << 16), (3, 1 << 31)])
def test_counter_guard(shape):
    with pytest.raises(ValueError, match="2\\^32 counter space"):
        prng.random_bits(0, 0, shape)


def test_structure_draws_use_only_the_threefry_module():
    src = (Path(prng.__file__).resolve().parent.parent / "ops" / "structure.py").read_text()
    assert "prng." in src
    assert not re.search(r"torch\.(rand|randn|randint|Generator|manual_seed)\b", src)
