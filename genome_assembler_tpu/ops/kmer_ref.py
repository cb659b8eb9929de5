"""NumPy reference implementation of k-mer extraction / canonicalization.

Role (SURVEY.md §4): the pure-NumPy oracle for the XLA extraction in
``ops/kmer_jax.py`` — bit-exact on the same multi-word key layout
(``utils.dna``: big-endian uint32 words, W = 2k//32 + 1), and fast enough to
power the host oracle assembler's counting stage on multi-Mb read sets.

Algorithm (mirrors the device kernel, SURVEY.md §7 M2): rolling multi-word shift
over the k window positions —
    fwd  <- (fwd << 2) | base            (base appended at the low end)
    rc   <- (rc  >> 2) | comp << 2(k-1)  (complement prepended at the high end)
so after k steps, lane p holds the packed k-mer starting at read position p.
Canonical key = lexicographic min(fwd, rc) over the word tuple.
"""

from __future__ import annotations

import numpy as np

from ..utils.dna import key_words

_SENTINEL = np.uint32(0xFFFFFFFF)


def _shift_left2_or(words: np.ndarray, low_bits: np.ndarray) -> np.ndarray:
    """(key << 2) | low_bits on big-endian word-array [..., W] uint32."""
    out = np.empty_like(words)
    out[..., :-1] = (words[..., :-1] << np.uint32(2)) | (
        words[..., 1:] >> np.uint32(30)
    )
    out[..., -1] = (words[..., -1] << np.uint32(2)) | low_bits
    return out


def _shift_right2_or_top(
    words: np.ndarray, top_bits: np.ndarray, k: int
) -> np.ndarray:
    """(key >> 2) | top_bits << 2(k-1) on big-endian word-array [..., W]."""
    w = words.shape[-1]
    out = np.empty_like(words)
    out[..., 1:] = (words[..., 1:] >> np.uint32(2)) | (
        words[..., :-1] << np.uint32(30)
    )
    out[..., 0] = words[..., 0] >> np.uint32(2)
    pos = 2 * (k - 1)  # bit position of the top base within the 2k-bit key
    widx = w - 1 - pos // 32
    shift = np.uint32(pos % 32)
    out[..., widx] |= top_bits.astype(np.uint32) << shift
    return out


def extract_kmer_words_np(
    reads: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """All k-windows of [B, L] reads -> (fwd, rc) packed keys [B, L-k+1, W].

    Ambiguous bases (code > 3) are clamped for the bit path; use
    window_valid_np to mask the windows they touch (mirroring the device
    kernels' sentinel masking).
    """
    reads = np.asarray(reads)
    b, length = reads.shape
    wc = length - k + 1
    w = key_words(k)
    fwd = np.zeros((b, wc, w), dtype=np.uint32)
    rc = np.zeros((b, wc, w), dtype=np.uint32)
    for j in range(k):
        base = reads[:, j : j + wc].astype(np.uint32) & np.uint32(3)
        fwd = _shift_left2_or(fwd, base)
        rc = _shift_right2_or_top(rc, np.uint32(3) - base, k)
    return fwd, rc


def window_valid_np(reads: np.ndarray, k: int) -> np.ndarray:
    """[B, L] codes -> [B*(L-k+1)] bool: window touches no invalid base."""
    reads = np.asarray(reads)
    bad = (reads > 3).astype(np.int32)
    cum = np.cumsum(bad, axis=1)
    wc = reads.shape[1] - k + 1
    in_window = cum[:, k - 1 :].copy()
    in_window[:, 1:] -= cum[:, : wc - 1]
    return (in_window == 0).reshape(-1)


def canonical_min_np(fwd: np.ndarray, rc: np.ndarray) -> np.ndarray:
    """Elementwise lexicographic min over the last (word) axis."""
    w = fwd.shape[-1]
    fwd_less = np.zeros(fwd.shape[:-1], dtype=bool)
    undecided = np.ones(fwd.shape[:-1], dtype=bool)
    for i in range(w):
        fwd_less |= undecided & (fwd[..., i] < rc[..., i])
        undecided &= fwd[..., i] == rc[..., i]
    return np.where(fwd_less[..., None] | undecided[..., None], fwd, rc)


def extract_canonical_np(reads: np.ndarray, k: int) -> np.ndarray:
    """[B, L] reads -> canonical keys [B*(L-k+1), W] uint32."""
    fwd, rc = extract_kmer_words_np(reads, k)
    canon = canonical_min_np(fwd, rc)
    return canon.reshape(-1, canon.shape[-1])


def _to_u64_cols(words: np.ndarray) -> np.ndarray:
    """[N, W] uint32 -> [N, ceil(W/2)] uint64 preserving lexicographic order."""
    n, w = words.shape
    if w % 2:
        words = np.concatenate(
            [np.zeros((n, 1), dtype=np.uint32), words], axis=1
        )
        w += 1
    cols = words.astype(np.uint64)
    return (cols[:, 0::2] << np.uint64(32)) | cols[:, 1::2]


def count_unique_np(
    keys: np.ndarray, valid: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Unique rows + counts of [N, W] uint32 keys (optionally masked).

    Returns (unique [U, W] uint32 sorted lexicographically, counts [U] int64).
    """
    if valid is not None:
        keys = keys[valid]
    w = keys.shape[1]
    u64 = _to_u64_cols(keys)
    if u64.shape[1] == 1:
        uniq, counts = np.unique(u64[:, 0], return_counts=True)
        u64u = uniq[:, None]
    else:
        order = np.lexsort(u64.T[::-1])
        s = u64[order]
        new = np.empty(len(s), dtype=bool)
        new[0:1] = True
        new[1:] = (s[1:] != s[:-1]).any(axis=1)
        idx = np.flatnonzero(new)
        u64u = s[idx]
        counts = np.diff(np.append(idx, len(s)))
    # back to uint32 word columns
    out = np.empty((len(u64u), 2 * u64u.shape[1]), dtype=np.uint32)
    out[:, 0::2] = (u64u >> np.uint64(32)).astype(np.uint32)
    out[:, 1::2] = (u64u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out[:, out.shape[1] - w :], counts


def count_canonical_np(
    reads: np.ndarray, k: int, min_count: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """[B, L] reads -> (unique canonical keys [U, W], counts [U]) filtered.

    Windows containing ambiguous bases are masked, not counted."""
    from ..utils.dna import has_ambiguous

    canon = extract_canonical_np(reads, k)
    valid = None
    if has_ambiguous(reads):
        valid = window_valid_np(reads, k)
    uniq, counts = count_unique_np(canon, valid)
    keep = counts >= min_count
    return uniq[keep], counts[keep]
