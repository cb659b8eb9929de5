"""Hash-bucketed streaming k-mer table: batched sorts for large merges.

The streaming counter's per-batch merge (count_jax.merge_raw_keys) is
two ~(cap+batch)-row monolithic sorts. Past BUCKETED_MIN_MERGE_ROWS
(models.pipeline; tens-of-Mb genomes, SURVEY.md §5 long-context row)
the merge instead sorts BATCHED [B, rows/B] shapes, whose per-row cost
does not grow with the table. Whether the GPU's sort needs this at all
is ROADMAP A7.

This module keeps the running table PARTITIONED into ``nb`` hash buckets
so every merge runs as batched [nb, cb+m] sorts instead:

  * bucket(key) = top bits of a multiplicative mix of the key words —
    uniform for any key distribution (canonical k-mer keys are NOT
    uniform in their own top bits), no quantile bootstrapping, and the
    bucket of a key never changes, so equal keys always meet in the
    same bucket and per-bucket merges aggregate exactly;
  * a batch is routed with ONE monolithic (bucket, key) sort of just the
    batch rows (batch-sized, whatever the table), then
    static-shape dynamic slices pack each bucket's segment;
  * per-bucket merge + segment reduce are the bit-exact batched mirrors
    of count_jax.merge_raw_keys (same neighbor-diff weighted reduce;
    runs can never span buckets because bucket id is a function of the
    key);
  * flatten_bucketed() re-sorts once at the end of the stream into the
    standard compact-front sorted CountTable, so everything downstream
    (filter, compaction, graph build, checkpoints, equality tests) is
    untouched and the final table is bit-identical to the flat path
    (tested, including under Hypothesis).

Capacity semantics: per-bucket capacity ``cb`` and per-bucket batch
segment capacity ``m`` carry slack over the uniform expectation
(models.pipeline sizes them); a skewed load — in practice only extreme
per-key multiplicity, e.g. a poly-A run putting one key's thousands of
batch copies into a single bucket — trips the same checked ``overflow``
flag as a too-small table, never silent truncation. GA_BUCKETED=0
falls back to the flat merge path for such inputs.

Blueprint: SURVEY.md §3.3 (counting), §5 long-context scaling;
BASELINE.md throughput bar. The reference mount is empty this session
(SURVEY.md §0), so citations go to the blueprint.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .count_jax import CountTable, _is_sentinel
from .kmer_jax import SENTINEL


class BucketedTable(NamedTuple):
    """Running count table partitioned into hash buckets.

    words:  [nb, cb, W] uint32 — per-bucket lexicographically sorted,
            compact-front, SENTINEL on padding rows.
    counts: [nb, cb] int32 — 0 on padding rows.
    num_unique: [nb] int32 per-bucket unique count (<= cb).
    overflow: scalar bool — a bucket exceeded cb, or a batch segment
            exceeded m; checked error semantics as CountTable.overflow.
    """

    words: jax.Array
    counts: jax.Array
    num_unique: jax.Array
    overflow: jax.Array


def _mix_words(words: jax.Array) -> jax.Array:
    """[N, W] key words -> [N] uint32 hash (Knuth multiplicative + fmix).

    Only used to pick buckets: must be uniform-ish for distinct keys and
    a pure function of the key. Never affects the final flat table
    (flatten_bucketed re-sorts lexicographically).
    """
    a = jnp.uint32(2654435761)
    h = words[..., 0] * a
    for i in range(1, words.shape[-1]):
        h = (h ^ words[..., i]) * a
    h ^= h >> jnp.uint32(16)
    h *= jnp.uint32(0x7FEB352D)
    h ^= h >> jnp.uint32(15)
    return h


def _bucket_of(words: jax.Array, nb: int) -> jax.Array:
    """[N, W] -> [N] uint32 bucket id in [0, nb); sentinel rows get nb
    (they sort past every real bucket and are never packed)."""
    shift = jnp.uint32(32 - (nb.bit_length() - 1))
    b = _mix_words(words) >> shift
    return jnp.where(_is_sentinel(words), jnp.uint32(nb), b)


def _route_and_pack(
    keys: jax.Array,
    nb: int,
    m: int,
    payload: jax.Array | None = None,
    full_order: bool = True,
):
    """Sort rows by (bucket, key) and pack each bucket's segment.

    Returns (packed_words [nb, m, W], packed_payload [nb, m] | None,
    seg_lens [nb], over_m scalar bool). Padding rows are SENTINEL
    (payload 0). The monolithic sort runs over just the batch rows and
    is the only non-batched sort in the merge.

    full_order=False sorts by the bucket column ONLY (num_keys=1, same
    operand count, 1-word comparator instead of 1+W): rows group by
    bucket in stable batch order instead of key order. Correctness
    never needs within-bucket key order here — the downstream batched
    merge re-sorts every bucket's rows lexicographically before the
    run-length reduce — so the staged/accumulated path uses the cheap
    route. The full order is kept for ``bucketize`` (table rows stay
    per-bucket sorted, the documented BucketedTable layout).
    """
    n, w = keys.shape
    bkt = _bucket_of(keys, nb)
    operands = (bkt,) + tuple(keys[:, i] for i in range(w))
    if payload is not None:
        operands = operands + (payload,)
    out = jax.lax.sort(operands, num_keys=(1 + w) if full_order else 1)
    ks = jnp.stack(out[1 : 1 + w], axis=1)
    pay_s = out[1 + w] if payload is not None else None
    # starts per bucket over the sorted bucket column; bucket nb
    # (sentinels) caps the last segment
    targets = jnp.arange(nb + 1, dtype=jnp.uint32)
    starts = jnp.searchsorted(out[0], targets, side="left").astype(
        jnp.int32
    )
    lens = starts[1:] - starts[:-1]
    over_m = jnp.max(lens) > m
    # pad m rows so dynamic_slice never clamps (starts <= n)
    ks_pad = jnp.concatenate(
        [ks, jnp.full((m, w), SENTINEL, jnp.uint32)], axis=0
    )
    if pay_s is not None:
        pay_pad = jnp.concatenate([pay_s, jnp.zeros(m, pay_s.dtype)])
    j = jnp.arange(m, dtype=jnp.int32)

    def pack_one(b):
        s = starts[b]
        seg = jax.lax.dynamic_slice(ks_pad, (s, jnp.int32(0)), (m, w))
        valid = j < lens[b]
        seg = jnp.where(valid[:, None], seg, SENTINEL)
        if pay_s is None:
            return seg
        p = jax.lax.dynamic_slice(pay_pad, (s,), (m,))
        return seg, jnp.where(valid, p, 0)

    packed = jax.lax.map(pack_one, jnp.arange(nb, dtype=jnp.int32))
    if pay_s is None:
        return packed, None, lens, over_m
    return packed[0], packed[1], lens, over_m


def _batched_weighted_reduce(words: jax.Array, weights: jax.Array):
    """Per-bucket run-length weighted reduce, batched along axis 0.

    The bit-exact batched mirror of count_jax._segment_reduce's weighted
    path: neighbor-diff of the exclusive weight cumsum carried through a
    masked-key compaction sort, all along the last axis. Inputs are
    [nb, rows, W] words SORTED per bucket and [nb, rows] weights.
    Returns (unique [nb, rows, W] compact-front, counts [nb, rows],
    num_unique [nb]).
    """
    nb, rows, w = words.shape
    prev = jnp.concatenate(
        [jnp.full((nb, 1, w), SENTINEL, jnp.uint32), words[:, :-1]], axis=1
    )
    is_start = jnp.any(words != prev, axis=2).at[:, 0].set(True)
    sent = words[:, :, 0] == SENTINEL
    for i in range(1, w):
        sent &= words[:, :, i] == SENTINEL
    real = is_start & ~sent
    num_u = jnp.sum(real.astype(jnp.int32), axis=1)
    weights = weights.astype(jnp.int32)
    excl = jnp.cumsum(weights, axis=1) - weights
    total_w = jnp.sum(jnp.where(sent, 0, weights), axis=1)
    masked = jnp.where(real[:, :, None], words, SENTINEL)
    out = jax.lax.sort(
        tuple(masked[:, :, i] for i in range(w)) + (excl,), num_keys=w
    )
    unique = jnp.stack(out[:w], axis=2)
    excl_c = out[w]
    idx = jnp.arange(rows, dtype=jnp.int32)[None, :]
    nxt = jnp.concatenate(
        [excl_c[:, 1:], jnp.zeros((nb, 1), jnp.int32)], axis=1
    )
    nxt = jnp.where(idx == num_u[:, None] - 1, total_w[:, None], nxt)
    counts = jnp.where(idx < num_u[:, None], nxt - excl_c, 0)
    return unique, counts, num_u


def empty_bucketed(nb: int, cb: int, w: int) -> BucketedTable:
    return BucketedTable(
        words=jnp.full((nb, cb, w), SENTINEL, dtype=jnp.uint32),
        counts=jnp.zeros((nb, cb), dtype=jnp.int32),
        num_unique=jnp.zeros(nb, dtype=jnp.int32),
        overflow=jnp.asarray(False),
    )


def merge_packed_bucketed_impl(
    bt: BucketedTable,
    packed: jax.Array,
    extra_overflow: jax.Array | None = None,
) -> BucketedTable:
    """Merge pre-routed per-bucket rows into the bucketed table.

    ``packed`` is [nb, S, W] with each row already in its key's bucket
    (SENTINEL rows anywhere are ignored by the reduce; within-bucket
    order is irrelevant — the batched merge sort orders them). One
    batched [nb, cb+S] weighted sort + batched reduce; every bulk sort
    runs at batched-shape throughput regardless of total table size.

    This is the merge half of merge_raw_keys_bucketed, split out so the
    accumulated streaming path (models.pipeline GA_BUCKET_ACCUM /
    extraction-side pre-packing) can stage R routed batches and pay the
    cb-row table re-sort once per R batches instead of per batch.
    """
    nb, cb, w = bt.words.shape
    s = packed.shape[1]
    merged = jnp.concatenate([bt.words, packed], axis=1)
    wts = jnp.concatenate(
        [bt.counts, jnp.ones((nb, s), jnp.int32)], axis=1
    )
    out = jax.lax.sort(
        tuple(merged[:, :, i] for i in range(w)) + (wts,), num_keys=w
    )
    words_s = jnp.stack(out[:w], axis=2)
    unique, counts, num_u = _batched_weighted_reduce(words_s, out[w])
    overflow = bt.overflow | jnp.any(num_u > cb)
    if extra_overflow is not None:
        overflow = overflow | extra_overflow
    return BucketedTable(
        words=unique[:, :cb],
        counts=counts[:, :cb],
        num_unique=jnp.minimum(num_u, cb),
        overflow=overflow,
    )


merge_packed_bucketed = functools.partial(
    jax.jit, donate_argnums=(0,)
)(merge_packed_bucketed_impl)


def route_pack_keys_impl(
    keys: jax.Array, *, nb: int, m: int
) -> tuple[jax.Array, jax.Array]:
    """Route a raw [N, W] key stream into per-bucket segments without
    merging: ([nb, m, W] packed rows, over_m flag).

    The route sorts by the bucket column only (num_keys=1): the batched
    merge re-sorts each bucket lexicographically anyway, so paying a
    (1+W)-word comparator here is pure waste. This is the
    extraction-side pre-packing step of the accumulated streaming
    counter (one fused dispatch with extraction in models.pipeline).
    """
    packed, _, _, over_m = _route_and_pack(keys, nb, m, full_order=False)
    return packed, over_m


def merge_raw_keys_bucketed_impl(
    bt: BucketedTable, keys: jax.Array, *, m: int
) -> BucketedTable:
    """Merge a raw (unsorted, uncounted) key stream into the bucketed
    table: the batched mirror of count_jax.merge_raw_keys.

    One bucket-column sort of the batch rows routes them; each bucket
    then merges its segment against its table rows with ONE batched
    [nb, cb+m] weighted sort + batched reduce — every bulk sort runs at
    batched-shape throughput regardless of total table size.

    This is the un-jitted body; call it from inside an enclosing jit /
    ``shard_map`` (parallel.pipeline's per-shard streaming merge). The
    top-level entry point is :func:`merge_raw_keys_bucketed`.
    """
    packed, over_m = route_pack_keys_impl(keys, nb=bt.words.shape[0], m=m)
    return merge_packed_bucketed_impl(bt, packed, over_m)


merge_raw_keys_bucketed = functools.partial(
    jax.jit, static_argnames=("m",), donate_argnums=(0,)
)(merge_raw_keys_bucketed_impl)


@functools.partial(jax.jit, static_argnames=("nb", "cb"))
def bucketize(table: CountTable, *, nb: int, cb: int) -> BucketedTable:
    """Partition a flat compact-front CountTable into hash buckets
    (stream resume / mixing flat and bucketed stages)."""
    c, w = table.words.shape
    lane = jnp.arange(c, dtype=jnp.int32)
    is_real = lane < table.num_unique
    words = jnp.where(is_real[:, None], table.words, SENTINEL)
    counts = jnp.where(is_real, table.counts, 0)
    packed_w, packed_c, lens, over = _route_and_pack(
        words, nb, cb, payload=counts
    )
    return BucketedTable(
        words=packed_w,
        counts=packed_c,
        num_unique=jnp.minimum(lens, cb),
        overflow=table.overflow | over,
    )


def flatten_bucketed_impl(bt: BucketedTable, *, capacity: int) -> CountTable:
    """Bucketed -> standard compact-front lexicographically sorted
    CountTable of the given capacity (one monolithic sort, paid once
    per stream). Bit-identical to the flat streaming path's table.

    Un-jitted body for enclosing jit / ``shard_map`` callers; the
    top-level entry point is :func:`flatten_bucketed`."""
    nb, cb, w = bt.words.shape
    words2 = bt.words.reshape(nb * cb, w)
    counts2 = bt.counts.reshape(nb * cb)
    out = jax.lax.sort(
        tuple(words2[:, i] for i in range(w)) + (counts2,), num_keys=w
    )
    words_s = jnp.stack(out[:w], axis=1)
    counts_s = out[w]
    num = jnp.sum(bt.num_unique)
    if capacity <= nb * cb:
        words_s = words_s[:capacity]
        counts_s = counts_s[:capacity]
    else:
        words_s = jnp.concatenate(
            [
                words_s,
                jnp.full((capacity - nb * cb, w), SENTINEL, jnp.uint32),
            ],
            axis=0,
        )
        counts_s = jnp.concatenate(
            [counts_s, jnp.zeros(capacity - nb * cb, jnp.int32)]
        )
    overflow = bt.overflow | (num > capacity)
    return CountTable(
        words=words_s,
        counts=counts_s,
        num_unique=jnp.minimum(num, capacity),
        overflow=overflow,
    )


flatten_bucketed = functools.partial(
    jax.jit, static_argnames=("capacity",)
)(flatten_bucketed_impl)


# Target per-bucket rows per merge for the auto bucket count: a tuning
# constant (ROADMAP A7); any value gives bit-identical tables.
# GA_BUCKETS overrides the rule outright.
BUCKET_TARGET_SEG = 96 * 1024


def auto_buckets(
    capacity: int, merge_windows: int, accum: int = 1,
    cb_slack: float = 1.25, m_slack: float = 1.5,
) -> int:
    """Power-of-two bucket count that lands per-merge bucket rows
    (cb + accum*m ~= (cb_slack*capacity + m_slack*accum*merge_windows)/nb)
    near BUCKET_TARGET_SEG, clamped to [256, 4096].

    More buckets = smaller batched-sort segments but a smaller
    per-bucket multiplicity cap
    (a single k-mer with > m copies in one batch overflows its segment —
    checked, never silent, GA_BUCKETS=256 the conservative fallback for
    homopolymer-heavy data). The clamp keeps both effects bounded.
    """
    per_merge = cb_slack * capacity + m_slack * accum * merge_windows
    nb = 256
    while nb < 4096 and per_merge / nb > BUCKET_TARGET_SEG:
        nb *= 2
    return nb


def bucket_geometry(
    capacity: int, merge_windows: int, *, nb: int, cb_slack: float,
    m_slack: float,
) -> tuple[int, int]:
    """Static per-bucket capacities (cb, m) for a stream.

    cb holds capacity/nb expected uniques, m holds merge_windows/nb
    expected batch rows; both carry slack over the uniform expectation
    (hash-bucket load is Poisson-concentrated for distinct keys; the
    slack absorbs it plus moderate per-key multiplicity skew) and round
    up to a lane-aligned multiple of 128.
    """

    def up128(x: int) -> int:
        return -(-x // 128) * 128

    cb = up128(int(-(-capacity * cb_slack // nb)))
    m = up128(int(-(-merge_windows * m_slack // nb)))
    return cb, m
