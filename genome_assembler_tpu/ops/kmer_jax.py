"""JAX k-mer extraction + canonicalization (jittable, XLA-compiled).

The array-native replacement for the reference's per-window Python loop
(SURVEY.md §3.3 hot loop): a rolling multi-word shift over the k window
positions, entirely as fixed-shape elementwise ops —
    fwd <- (fwd << 2) | base             (append base at the low end)
    rc  <- (rc  >> 2) | comp << 2(k-1)   (prepend complement at the top)
k is static (compile-time), so the k-step roll unrolls into a straight-line
fused elementwise graph that XLA compiles into one loop fusion feeding
the counting sort. Bit-identical to ops/kmer_ref.py (the NumPy oracle) by
construction.

Key layout: ``utils.dna`` big-endian uint32 words, W = 2k//32 + 1, spare
high bits zero; the all-ones tuple is the +inf padding sentinel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.dna import key_words

# A numpy scalar, NOT a jnp one: a module-level jnp constant would
# initialize the default JAX backend at import time, before a
# multi-process launch can initialize jax.distributed (utils.jaxenv.
# setup). np.uint32 promotes identically inside every jnp expression.
SENTINEL = np.uint32(0xFFFFFFFF)


def _shift_left2_or(words: list[jax.Array], low: jax.Array) -> list[jax.Array]:
    """(key << 2) | low across the big-endian word list."""
    out = [
        (words[i] << jnp.uint32(2)) | (words[i + 1] >> jnp.uint32(30))
        for i in range(len(words) - 1)
    ]
    out.append((words[-1] << jnp.uint32(2)) | low)
    return out


def _shift_right2_or_top(
    words: list[jax.Array], top: jax.Array, k: int
) -> list[jax.Array]:
    """(key >> 2) | top << 2(k-1) across the big-endian word list."""
    w = len(words)
    out = [words[0] >> jnp.uint32(2)]
    out.extend(
        (words[i] >> jnp.uint32(2)) | (words[i - 1] << jnp.uint32(30))
        for i in range(1, w)
    )
    pos = 2 * (k - 1)
    widx = w - 1 - pos // 32
    out[widx] = out[widx] | (top << jnp.uint32(pos % 32))
    return out


def lex_min(a: list[jax.Array], b: list[jax.Array]) -> list[jax.Array]:
    """Elementwise lexicographic min of two word lists."""
    a_less = jnp.zeros_like(a[0], dtype=bool)
    undecided = jnp.ones_like(a[0], dtype=bool)
    for ai, bi in zip(a, b):
        a_less = a_less | (undecided & (ai < bi))
        undecided = undecided & (ai == bi)
    pick_a = a_less | undecided
    return [jnp.where(pick_a, ai, bi) for ai, bi in zip(a, b)]


@functools.partial(jax.jit, static_argnames=("read_len",))
def unpack_codes(packed: jax.Array, read_len: int) -> jax.Array:
    """[B, ceil(L/4)] packed bytes -> [B, L] 2-bit codes (see
    utils.dna.pack_codes). One elementwise pass."""
    parts = [
        (packed >> jnp.uint8(2 * i)) & jnp.uint8(3) for i in range(4)
    ]
    codes = jnp.stack(parts, axis=-1).reshape(packed.shape[0], -1)
    return codes[:, :read_len]


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def extract_kmers(
    reads: jax.Array, k: int, canonical: bool = True,
    bad: jax.Array | None = None,
) -> jax.Array:
    """[B, L] uint8 reads -> packed k-mer keys [B, L-k+1, W] uint32.

    canonical=True returns min(kmer, revcomp(kmer)) per window.

    Windows touching an ambiguous base come back as the sentinel key
    (masked, never counted): a base is ambiguous when its code > 3 or when
    ``bad`` [B, L] flags it (codes arriving 2-bit packed lose the
    INVALID_CODE value, so the invalid-mask bits travel separately —
    utils.dna.pack_invalid_mask).
    """
    b, length = reads.shape
    wc = length - k + 1
    w = key_words(k)
    zeros = jnp.zeros((b, wc), dtype=jnp.uint32)
    fwd = [zeros] * w
    rc = [zeros] * w
    window_bad = jnp.zeros((b, wc), dtype=bool)
    for j in range(k):
        base = jax.lax.dynamic_slice_in_dim(reads, j, wc, axis=1)
        base = base.astype(jnp.uint32)
        window_bad = window_bad | (base > 3)
        base = base & jnp.uint32(3)
        if bad is not None:
            window_bad = window_bad | jax.lax.dynamic_slice_in_dim(
                bad, j, wc, axis=1
            )
        fwd = _shift_left2_or(fwd, base)
        rc = _shift_right2_or_top(rc, jnp.uint32(3) - base, k)
    out = lex_min(fwd, rc) if canonical else fwd
    keys = jnp.stack(out, axis=-1)
    return jnp.where(window_bad[..., None], SENTINEL, keys)


@functools.partial(jax.jit, static_argnames=("read_len",))
def unpack_invalid_mask(packed: jax.Array, read_len: int) -> jax.Array:
    """[B, ceil(L/8)] packed bits -> [B, L] bool (see pack_invalid_mask)."""
    bits = [
        (packed >> jnp.uint8(i)) & jnp.uint8(1) for i in range(8)
    ]
    bad = jnp.stack(bits, axis=-1).reshape(packed.shape[0], -1)
    return bad[:, :read_len].astype(bool)


@functools.partial(jax.jit, static_argnames=("k",))
def extract_canonical_flat(
    reads: jax.Array,
    k: int,
    num_valid_reads: jax.Array | None = None,
    bad: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """[B, L] reads -> (keys [B*(L-k+1), W], valid [B*(L-k+1)]).

    Rows >= num_valid_reads (batch padding) are marked invalid; their keys
    are replaced by the all-ones sentinel so they sort to the end. ``bad``
    [B, L] flags ambiguous bases whose windows mask the same way. The
    valid mask matches the key mask exactly: ambiguous-base windows are
    invalid too (a real canonical key can never be the all-ones sentinel —
    an all-T forward word implies an all-A reverse complement, and min
    picks the smaller).
    """
    b, length = reads.shape
    wc = length - k + 1
    keys = extract_kmers(reads, k, canonical=True, bad=bad)
    if num_valid_reads is None:
        valid = jnp.ones((b, wc), dtype=bool)
    else:
        row_ok = jnp.arange(b, dtype=jnp.int32) < num_valid_reads
        valid = jnp.broadcast_to(row_ok[:, None], (b, wc))
    keys = jnp.where(valid[..., None], keys, SENTINEL)
    flat = keys.reshape(b * wc, -1)
    return flat, valid.reshape(b * wc) & ~jnp.all(flat == SENTINEL, axis=-1)
