"""Port parity: word-map helpers (gunrockinst_tpu_torch.ops.words)
against the JAX package's pack_bitmap/unpack_bitmap, bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrockinst_tpu.ops.pallas_advance import pack_bitmap as ref_pack
from gunrockinst_tpu.ops.pallas_advance import unpack_bitmap as ref_unpack
from gunrockinst_tpu.ops.pallas_advance_v3 import build_pull_plan_v3

from gunrockinst_tpu_torch.ops.words import (host_unpack_words,
                                             pack_bitmap, start_words,
                                             unpack_bitmap, word_rows)


@pytest.mark.parametrize("n,density,seed", [
    (5, 0.5, 0), (1000, 0.3, 1), (32767, 0.01, 2), (70000, 0.5, 3),
    (4096, 1.0, 4),
])
def test_pack_unpack_match_reference(n, density, seed):
    rows = word_rows(n)
    n_words = rows * 128
    mask = np.random.default_rng(seed).random(n) < density
    got = pack_bitmap(torch.from_numpy(mask), n_words)
    want = np.asarray(ref_pack(jnp.asarray(mask), n_words))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    n_pad = ((n + 128) // 128) * 128
    np.testing.assert_array_equal(
        unpack_bitmap(got, n_pad).numpy(),
        np.asarray(ref_unpack(jnp.asarray(want), n_pad)))
    np.testing.assert_array_equal(host_unpack_words(want, n),
                                  mask.astype(np.uint8))


@pytest.mark.parametrize("n", [1, 5, 32767, 32768, 70000])
def test_word_rows_match_reference_plan(n):
    """rows = 8 * ceil((n+1)/32768), as the reference's plans lay out
    their word maps."""
    plan = build_pull_plan_v3(np.zeros(n + 1, np.int64),
                              np.zeros(0, np.int32), n)
    assert word_rows(n) * 128 == plan.n_words


def test_word_rows_at_bench_scale():
    assert word_rows(1 << 20) == 264     # rmat-s20


def test_pack_rejects_overflow():
    with pytest.raises(ValueError):
        pack_bitmap(torch.ones(32 * 128 + 1, dtype=torch.bool), 128)


@pytest.mark.parametrize("v", [0, 31, 32, 40000, 65535])
def test_start_words_match_reference_pack(v):
    """The one-vertex map the searches start from, bit 31 included,
    equals the reference's pack of a one-hot mask."""
    rows = word_rows(65536)
    mask = np.zeros(rows * 128 * 32, bool)
    mask[v] = True
    want = np.asarray(ref_pack(jnp.asarray(mask), rows * 128))
    np.testing.assert_array_equal(start_words(v, rows, "cpu").numpy(), want)
