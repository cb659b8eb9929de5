"""Sort/segment-reduce k-mer counting in HBM (SURVEY.md §7 M3).

The array-native replacement for the reference's dict-upsert hot loop
(SURVEY.md §3.3): multi-operand lexicographic ``lax.sort`` over the uint32
key-word columns (handles 2k > 64, e.g. k=41 -> 82-bit keys, the §7 hard
part), then run-length segmentation entirely with fixed-shape scatter/cumsum
ops. All outputs are capacity-bounded with a scalar ``num_unique``; padding
lanes carry the all-ones sentinel key, which sorts last and forms a
zero-count group.

Also provides the streaming table: counted batches merge into a running
capacity-bounded table via concat + sort + segment-sum, so arbitrarily large
read sets count in bounded HBM (SURVEY.md §6 CFG 2-3 scale).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .kmer_jax import SENTINEL


class CountTable(NamedTuple):
    """Sorted unique canonical k-mers + multiplicities (capacity-bounded).

    words:  [C, W] uint32, lexicographically sorted; sentinel rows padding.
    counts: [C] int32, 0 on padding rows.
    num_unique: scalar int32 (<= C).
    overflow: scalar bool — True if a merge/count exceeded capacity C and
        entries were dropped (a checked error, SURVEY.md §7 hard parts).
    """

    words: jax.Array
    counts: jax.Array
    num_unique: jax.Array
    overflow: jax.Array


def _is_sentinel(words: jax.Array) -> jax.Array:
    mask = words[:, 0] == SENTINEL
    for i in range(1, words.shape[1]):
        mask &= words[:, i] == SENTINEL
    return mask


def sort_by_words(words: jax.Array, *payloads: jax.Array) -> tuple[jax.Array, ...]:
    """Lexicographic sort of [N, W] keys (+ payload columns)."""
    w = words.shape[1]
    operands = tuple(words[:, i] for i in range(w)) + payloads
    out = jax.lax.sort(operands, num_keys=w)
    return (jnp.stack(out[:w], axis=1),) + tuple(out[w:])


def _segment_reduce(
    words_sorted: jax.Array, weights: jax.Array | None
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Run-length reduce of sorted keys — scatter-free.

    Segmentation uses only scans, shifts, and one compacting re-sort
    (no duplicate-index scatters; whether a scatter-add counter beats
    this on the GPU is ROADMAP A5):
      * group starts: lane differs from its predecessor;
      * each start lane finds the next start via a reversed cummin scan;
        its group count is the index difference (or a cumsum difference
        when merging weighted tables);
      * compaction: non-start lanes are masked to the sentinel key and
        re-sorted — distinct start keys keep their order, padding sinks.

    weights=None means every lane weighs 1 (raw extraction stream), which
    skips the cumsum + gather entirely.

    Returns (unique_words [N, W] compact-front sorted, counts [N],
    num_unique).
    """
    n, w = words_sorted.shape
    prev = jnp.concatenate(
        [jnp.full((1, w), SENTINEL, jnp.uint32), words_sorted[:-1]], axis=0
    )
    is_start = jnp.any(words_sorted != prev, axis=1).at[0].set(True)
    idx = jnp.arange(n, dtype=jnp.int32)
    sent = _is_sentinel(words_sorted)
    real_start = is_start & ~sent
    num_unique = jnp.sum(real_start.astype(jnp.int32))
    unique = jnp.where(real_start[:, None], words_sorted, SENTINEL)
    if weights is None:
        # run lengths fall out of the compaction: carry each start's
        # position through the compaction sort and diff neighbors
        # (the runs are contiguous, sentinels sorted last) — no
        # reversed-cummin scan pass needed on the raw extraction stream.
        # Starts ascend and are distinct, so the masked-key compaction
        # (compact_front_sorted) drops the flag column: 3 sort operands
        # with 2 keys instead of 4 operands with 1 key.
        unique, pos = compact_front_sorted(real_start, unique, idx)
        total_valid = jnp.sum((~sent).astype(jnp.int32))
        nxt = jnp.concatenate([pos[1:], jnp.zeros(1, jnp.int32)])
        nxt = jnp.where(idx == num_unique - 1, total_valid, nxt)
        counts = jnp.where(idx < num_unique, nxt - pos, 0)
        return unique, counts, num_unique
    # weighted (merge) path: per-run sums via neighbor-diff of the
    # EXCLUSIVE weight cumsum carried through the compaction sort — the
    # weighted mirror of the unweighted position trick above. Only real
    # starts are kept: row i < num_unique-1 reads the next real start's
    # exclusive sum, and the last real run's boundary is overridden with
    # the explicit total valid weight, so no reversed-cummin scan and no
    # boundary gather are needed (those two were measured to dominate
    # the merge reduce at CFG-2 scale).
    weights = weights.astype(jnp.int32)
    excl = jnp.cumsum(weights) - weights  # exclusive cumsum per lane
    total_w = jnp.sum(jnp.where(sent, 0, weights))
    unique, excl_c = compact_front_sorted(real_start, unique, excl)
    nxt = jnp.concatenate([excl_c[1:], jnp.zeros(1, jnp.int32)])
    nxt = jnp.where(idx == num_unique - 1, total_w, nxt)
    counts = jnp.where(idx < num_unique, nxt - excl_c, 0)
    return unique, counts, num_unique


def compact_front(
    keep: jax.Array, words: jax.Array, *payloads: jax.Array
) -> tuple[jax.Array, ...]:
    """Stable-compact kept rows to the front (drop rows sink, order kept).

    A single-key stable sort on the drop flag: kept rows keep their
    relative (already lexicographic) order, dropped rows sink. Works for
    ANY kept-row order; when kept rows are already ascending and distinct
    use :func:`compact_front_sorted`, which drops the flag column
    (3 sort operands with 2 keys instead of 4 with 1).
    """
    w = words.shape[1]
    drop = (~keep).astype(jnp.uint32)
    out = jax.lax.sort(
        (drop,) + tuple(words[:, i] for i in range(w)) + payloads,
        num_keys=1,
    )
    return (jnp.stack(out[1 : 1 + w], axis=1),) + tuple(out[1 + w :])


def compact_front_sorted(
    keep: jax.Array, words: jax.Array, *payloads: jax.Array
) -> tuple[jax.Array, ...]:
    """Compact kept rows to the front when kept rows are ALREADY in
    ascending lexicographic order (duplicates allowed only among rows
    masked to the sentinel).

    Dropped rows are masked to the all-ones sentinel, which sorts last,
    so sorting on the masked words themselves reproduces compact_front's
    output with one fewer sort operand — the words must ride the sort
    anyway, so the drop flag was a pure extra column. Callers in the
    counting pipeline satisfy the precondition by construction: segment
    starts / unique-table rows ascend.
    """
    w = words.shape[1]
    masked = jnp.where(keep[:, None], words, SENTINEL)
    out = jax.lax.sort(
        tuple(masked[:, i] for i in range(w)) + payloads,
        num_keys=w,
    )
    return (jnp.stack(out[:w], axis=1),) + tuple(out[w:])


@jax.jit
def count_keys(keys: jax.Array, weights: jax.Array | None = None) -> CountTable:
    """[N, W] canonical keys (sentinel = invalid) -> CountTable of capacity N.

    weights=None (the raw extraction stream) takes the fast path: keys-only
    sort, counts from run lengths — no payload column, no scatter.
    """
    if weights is None:
        (words_sorted,) = sort_by_words(keys)
        unique, counts, num_unique = _segment_reduce(words_sorted, None)
    else:
        words_sorted, weights_sorted = sort_by_words(keys, weights)
        unique, counts, num_unique = _segment_reduce(
            words_sorted, weights_sorted
        )
    return CountTable(
        words=unique,
        counts=counts,
        num_unique=num_unique,
        overflow=jnp.asarray(False),
    )


def empty_table(capacity: int, w: int) -> CountTable:
    return CountTable(
        words=jnp.full((capacity, w), SENTINEL, dtype=jnp.uint32),
        counts=jnp.zeros(capacity, dtype=jnp.int32),
        num_unique=jnp.asarray(0, dtype=jnp.int32),
        overflow=jnp.asarray(False),
    )


@jax.jit
def merge_tables(table: CountTable, batch: CountTable) -> CountTable:
    """Merge a counted batch into the running table (same W, capacities differ).

    Result capacity == table capacity; overflow flags entries dropped when
    the merged unique count exceeds it. O((C+N) log(C+N)) sort — the
    array-native analog of the reference's dict upsert merge.
    """
    cap = table.words.shape[0]
    words = jnp.concatenate([table.words, batch.words], axis=0)
    weights = jnp.concatenate([table.counts, batch.counts], axis=0)
    words_sorted, weights_sorted = sort_by_words(words, weights)
    unique, counts, num_unique = _segment_reduce(words_sorted, weights_sorted)
    overflow = table.overflow | batch.overflow | (num_unique > cap)
    return CountTable(
        words=unique[:cap],
        counts=counts[:cap],
        num_unique=jnp.minimum(num_unique, cap),
        overflow=overflow,
    )


@jax.jit
def merge_raw_keys(table: CountTable, keys: jax.Array) -> CountTable:
    """Merge a raw (unsorted, uncounted) key stream into the running table.

    Instead of sort-counting the batch first and then merging the two
    counted tables, the raw [N, W] extraction stream rides one weighted
    sort next to the table rows — table lanes weigh their counts, stream
    lanes weigh 1, sentinel (invalid-window) lanes are excluded by the
    segment reduce. Bit-identical to count_keys + merge_tables (tested).

    One weighted sort + neighbor-diff reduce over C + N rows — fewer
    rows than count-then-merge at every scale
    (models.pipeline._stream_step keeps both formulations).
    """
    cap = table.words.shape[0]
    words = jnp.concatenate([table.words, keys], axis=0)
    weights = jnp.concatenate(
        [table.counts, jnp.ones(keys.shape[0], jnp.int32)], axis=0
    )
    words_sorted, weights_sorted = sort_by_words(words, weights)
    unique, counts, num_unique = _segment_reduce(words_sorted, weights_sorted)
    return CountTable(
        words=unique[:cap],
        counts=counts[:cap],
        num_unique=jnp.minimum(num_unique, cap),
        overflow=table.overflow | (num_unique > cap),
    )


@jax.jit
def multiplicity_histogram(table: CountTable) -> jax.Array:
    """[1001] histogram of clamped multiplicities min(count, 1000).

    The automatic coverage-threshold heuristic (models.pipeline.
    auto_min_count) needs only this histogram; computing it on device
    (one 1-operand sort + a 1002-point searchsorted) replaces pulling
    the whole counts column to the host with a 4 KB transfer. Padding rows (count 0) land in bin 0,
    which the heuristic ignores; rows past num_unique are pinned to an
    out-of-range bin and dropped by the final diff.
    """
    n = table.counts.shape[0]
    lane = jnp.arange(n, dtype=jnp.int32)
    c = jnp.where(
        lane < table.num_unique,
        jnp.minimum(table.counts, 1000),
        jnp.int32(1001),
    )
    s = jax.lax.sort(c)
    edges = jnp.arange(1002, dtype=jnp.int32)
    pos = jnp.searchsorted(s, edges)
    return (pos[1:] - pos[:-1]).astype(jnp.int32)


def snug_capacity(n: int, floor: int = 1 << 16, fine: bool = False) -> int:
    """Smallest grid capacity >= n, grid = {1, 1.25, 1.5, 1.75} x 2^k.

    Table capacities are compile-time shapes and each new shape is a
    new compile, so capacities snap to a coarse geometric grid: at most
    4 variants per power of two, <= 25% padding overhead.

    fine=True switches to a 1/16-step grid (<= 6.25% padding, 16
    variants per octave) — for the POST-count compacted table, whose
    padding rows ride every graph-stage sort and doubling gather
    (coarse-grid CFG-2: 5.24M rows carrying 4.64M uniques = 13% dead
    work in compress/spell). Counting capacities stay coarse: they are
    chosen before the data is seen, so reuse across runs matters more.
    """
    if n <= floor:
        return floor
    p = 1 << (n - 1).bit_length() - 1  # largest power of two < n (n > 1)
    denom, nums = (16, range(17, 33)) if fine else (4, (5, 6, 7, 8))
    for num in nums:
        if n <= p * num // denom:
            return p * num // denom
    return 2 * p


def compact_table(table: CountTable) -> CountTable:
    """Slice a compact-front table down to a snug capacity (host-driven).

    Counting capacities are sized for the read stream (window counts),
    but the surviving unique k-mers are genome-sized — often 10x smaller.
    Every downstream sort/gather/doubling pass scales with capacity, so
    compacting once here (one scalar pull + a device slice) cuts the whole
    graph stage proportionally. No-op when already snug.
    """
    num = int(table.num_unique)
    cap = snug_capacity(num, fine=True)
    if cap >= table.words.shape[0]:
        return table
    return CountTable(
        words=table.words[:cap],
        counts=table.counts[:cap],
        num_unique=table.num_unique,
        overflow=table.overflow,
    )


@functools.partial(jax.jit, static_argnames=("min_count",))
def filter_table(table: CountTable, min_count: int) -> CountTable:
    """Coverage filter (reference C4): drop counts < min_count, recompact.

    min_count <= 1 is an exact no-op: count_keys/merge output is already
    compact-front sorted with every real row's count >= 1, so the
    compaction sort (and its whole dispatch) is skipped.

    Compaction keeps the survivors sorted at the front (table rows are
    distinct and ascending, so the masked-key compact_front_sorted
    applies), so downstream graph building sees a dense sorted table.
    """
    if min_count <= 1:
        return table
    keep = table.counts >= min_count
    n = table.words.shape[0]
    w = table.words.shape[1]
    words = jnp.where(keep[:, None], table.words, SENTINEL)
    counts = jnp.where(keep, table.counts, 0)
    words_sorted, counts_sorted = compact_front_sorted(keep, words, counts)
    num = jnp.sum(keep.astype(jnp.int32))
    return CountTable(
        words=words_sorted.reshape(n, w),
        counts=counts_sorted,
        num_unique=num,
        overflow=table.overflow,
    )
