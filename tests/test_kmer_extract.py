"""XLA extraction (ops.kmer_jax.extract_canonical_flat) vs the NumPy
reference (ops.kmer_ref): key words, the valid mask, row masking, batch
shapes and ambiguous-base masking, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from genome_assembler_tpu.ops import kmer_ref
from genome_assembler_tpu.ops.kmer_jax import SENTINEL, extract_canonical_flat
from genome_assembler_tpu.utils.dna import INVALID_CODE


def _reads(seed, b, length):
    return np.random.default_rng(seed).integers(
        0, 4, size=(b, length), dtype=np.uint8
    )


@pytest.mark.parametrize("k", [21, 31, 41])
def test_extract_matches_ref(k):
    reads = _reads(1, 256, 100)
    keys, valid = extract_canonical_flat(jnp.asarray(reads), k)
    want = kmer_ref.extract_canonical_np(reads, k)
    np.testing.assert_array_equal(np.asarray(keys), want)
    assert np.asarray(valid).all()


def test_extract_masks_rows_past_n_valid():
    reads = _reads(2, 512, 60)
    k = 25
    keys, valid = extract_canonical_flat(jnp.asarray(reads), k, np.int32(300))
    keys, valid = np.asarray(keys), np.asarray(valid)
    wc = 60 - k + 1
    want = kmer_ref.extract_canonical_np(reads[:300], k)
    np.testing.assert_array_equal(keys[: 300 * wc], want)
    assert (keys[300 * wc :] == SENTINEL).all()
    assert valid[: 300 * wc].all() and not valid[300 * wc :].any()


@pytest.mark.parametrize("b", [1, 997])
def test_extract_any_batch_size(b):
    """No tile alignment: a single read and a prime batch both extract."""
    reads = _reads(3, b, 50)
    k = 21
    keys, valid = extract_canonical_flat(jnp.asarray(reads), k)
    want = kmer_ref.extract_canonical_np(reads, k)
    np.testing.assert_array_equal(np.asarray(keys), want)
    assert np.asarray(valid).shape == (b * (50 - k + 1),)


def test_extract_raw_invalid_codes_masked():
    """Raw codes carrying INVALID_CODE: every window touching one is the
    sentinel and invalid; every other window equals the reference."""
    rng = np.random.default_rng(17)
    reads = rng.integers(0, 4, size=(256, 40), dtype=np.uint8)
    reads[rng.random(reads.shape) < 0.05] = INVALID_CODE
    k = 21
    keys, valid = extract_canonical_flat(jnp.asarray(reads), k, np.int32(200))
    keys, valid = np.asarray(keys), np.asarray(valid)
    wc = 40 - k + 1
    ok = kmer_ref.window_valid_np(reads, k)
    ok[200 * wc :] = False
    want = kmer_ref.extract_canonical_np(reads & 3, k)
    np.testing.assert_array_equal(keys[ok], want[ok])
    assert (keys[~ok] == SENTINEL).all()
    np.testing.assert_array_equal(valid, ok)
    assert ok.any() and (~ok).any()
