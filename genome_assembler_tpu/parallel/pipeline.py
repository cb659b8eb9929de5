"""Multi-device distributed counting pipeline (SURVEY.md §7 M5).

The long-context / sequence-parallel analog for this workload (SURVEY.md §5):
the global k-mer space is sharded by a mixing hash across devices, so no
device ever holds the whole table — capacity scales linearly with devices.

Per ``shard_map``-mapped device step:
  1. extract + canonicalize local read shard (DP over reads);
  2. route each k-mer to its owner: bucket = mix_hash(key) % D
     (an EP/Ulysses-style all-to-all resharding, not a ring);
  3. pack buckets into a fixed [D, Bcap, W] send buffer (capacity-bounded,
     overflow-checked) and ``lax.all_to_all`` it over the mesh axis;
  4. sort/segment-reduce the received keys into the local table shard.

Each canonical k-mer's occurrences all land on one owner device, so local
counts are already global counts; the coverage filter is local. The host
gathers the (genome-sized, not read-sized) surviving tables for the branchy
residue, per SURVEY.md §7 M4/M5.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..host.dbg import counts_to_dict
from ..host.simplify import simplify_counts
from ..host.traverse import emit_contigs
from ..ops import count_jax
from ..ops.hash import mix_words
from ..ops.kmer_jax import SENTINEL, unpack_codes
from ..utils.config import AssemblyConfig
from ..utils.dna import key_words, pack_codes


def _local_extract(
    reads: jax.Array, k: int, n_valid: jax.Array, bad: jax.Array | None = None
):
    """[B, L] local shard -> ([N, W] canonical keys, [N] valid).

    Alias of ops.kmer_jax.extract_canonical_flat, whose valid mask
    matches the key mask exactly: padding rows AND N-masked windows are
    invalid, so masked lanes never route (they would all hash into one
    bucket and blow its capacity)."""
    from ..ops.kmer_jax import extract_canonical_flat

    return extract_canonical_flat(reads, k, n_valid, bad)


def _route_to_buckets(
    keys: jax.Array, valid: jax.Array, num_buckets: int, bucket_cap: int
):
    """Pack keys into a [num_buckets, bucket_cap, W] send buffer.

    Thin uint32 view over the shared scatter-free bucket packer
    (parallel.compress._bucket_pack, also used by the minimizer routing):
    bucket = mix_hash(key) % D; the int32 round trip is a bit
    reinterpretation, and _bucket_pack's -1 fill IS the all-ones
    sentinel as uint32 key words. Returns (send_buffer, overflow).
    """
    from .compress import _bucket_pack

    bucket = (mix_words(keys) % jnp.uint32(num_buckets)).astype(jnp.int32)
    send, overflow = _bucket_pack(
        keys.astype(jnp.int32), bucket, valid, num_buckets, bucket_cap
    )
    return send.astype(jnp.uint32), overflow


def _make_owned_keys(
    d: int, k: int, read_len: int, bucket_cap: int, axis,
    minimizer_len: int | None,
):
    """Build the per-device "read batch -> keys this shard owns" body.

    The shared front half of both distributed counting formulations
    (one-shot and streamed): extract + canonicalize the local read shard,
    route every k-mer (or minimizer super-k-mer record) to its hash owner
    via a bucket-packed ``all_to_all``, and return the received raw keys
    (sentinel = empty lane) plus the routing-overflow flag. Runs inside
    ``shard_map``.
    """

    def window_bad(bad_plane):
        wc = read_len - k + 1
        out = None
        for j in range(k):
            s = jax.lax.dynamic_slice_in_dim(bad_plane, j, wc, axis=1)
            out = s if out is None else (out | s)
        return out

    def owned_keys_minimizer(reads, n_valid, inv_mask=None):
        from ..ops.superkmer import (
            extract_from_records,
            span_words,
            superkmer_records,
            window_minimizers,
        )
        from .compress import _bucket_pack

        unpacked = unpack_codes(reads[0], read_len)
        b = unpacked.shape[0]
        wc = read_len - k + 1
        row_ok = jnp.arange(b, dtype=jnp.int32) < n_valid[0]
        wv = jnp.broadcast_to(row_ok[:, None], (b, wc))
        if inv_mask is not None:
            from ..ops.kmer_jax import unpack_invalid_mask

            wv = wv & ~window_bad(unpack_invalid_mask(inv_mask[0], read_len))
        hmin, mpos = window_minimizers(unpacked, k, minimizer_len)
        brk, run, sub, _ = superkmer_records(unpacked, k, hmin, mpos, wv)
        sw = span_words(k)
        n = b * wc
        rec = jnp.concatenate(
            [
                sub.reshape(n, sw).astype(jnp.int32),
                run.reshape(n, 1),
            ],
            axis=1,
        )
        owner = (hmin.reshape(n) % jnp.uint32(d)).astype(jnp.int32)
        send, overflow = _bucket_pack(
            rec, owner, brk.reshape(n), d, bucket_cap
        )
        recv = jax.lax.all_to_all(
            send, axis, split_axis=0, concat_axis=0, tiled=False
        ).reshape(d * bucket_cap, sw + 1)
        keys, _ = extract_from_records(
            recv[:, :sw].astype(jnp.uint32), recv[:, sw], k
        )
        return keys, overflow

    def owned_keys(reads, n_valid, inv_mask=None):
        if minimizer_len is not None:
            return owned_keys_minimizer(reads, n_valid, inv_mask)
        # reads arrive 2-bit packed (4x smaller host->device transfer)
        w = key_words(k)
        unpacked = unpack_codes(reads[0], read_len)
        bad = None
        if inv_mask is not None:
            from ..ops.kmer_jax import unpack_invalid_mask

            bad = unpack_invalid_mask(inv_mask[0], read_len)
        keys, valid = _local_extract(unpacked, k, n_valid[0], bad)
        if d == 1:
            # single-owner mesh: every key is already home — skip the
            # bucket sort + all_to_all and their 1.5x slack lanes
            # entirely (sentinel lanes are excluded downstream anyway)
            keys = jnp.where(valid[:, None], keys, SENTINEL)
            return keys, jnp.asarray(False)
        send, overflow = _route_to_buckets(keys, valid, d, bucket_cap)
        recv = jax.lax.all_to_all(
            send, axis, split_axis=0, concat_axis=0, tiled=False
        )
        return recv.reshape(d * bucket_cap, w), overflow

    return owned_keys


def make_distributed_count(
    mesh: Mesh, k: int, batch_per_device: int, read_len: int, bucket_cap: int,
    axis="d", with_mask: bool = False, minimizer_len: int | None = None,
):
    """Build the jitted multi-device counting step.

    Returns fn(reads [D*B, L] u8, n_valid [D] i32[, inv_mask]) ->
      (words [D*C, W] row-sharded, counts [D*C], num_unique [D], overflow []).
    C is each device's table capacity. with_mask adds a packed
    invalid-base bitmask operand (reads with Ns; see
    utils.dna.pack_invalid_mask) whose windows are masked before routing.

    axis: one mesh axis name, or a tuple of axis names — a 2-level
    ('host', 'chip') mesh flattens into one logical all-to-all axis.

    minimizer_len set routes minimizer super-k-mer records instead of
    per-window keys (ops/superkmer.py): ~3-6x less all-to-all volume for
    k=31/m=15; owners re-extract the windows from the packed substrings.
    Identical counts either way (a k-mer's minimizer is a function of the
    k-mer, so all its occurrences share one owner).
    """
    from .mesh import axis_size

    d = axis_size(mesh, axis)
    owned = _make_owned_keys(d, k, read_len, bucket_cap, axis, minimizer_len)

    def local_step(reads, n_valid, inv_mask=None):
        keys, overflow = owned(reads, n_valid, inv_mask)
        table = count_jax.count_keys(keys)
        if minimizer_len is not None:
            # the record lanes over-allocate ~RUN_CAP/mean_run x; truncate
            # the (compact-front) table to a window-scale capacity so
            # downstream shards and host pulls don't inherit the padding
            # (overflow flagged, never silent). Each owner receives ~1/D
            # of the global windows = one device's window count, plus
            # skew slack.
            out_cap = min(
                keys.shape[0],
                int(batch_per_device * (read_len - k + 1) * 1.5) + 256,
            )
            if out_cap < table.words.shape[0]:
                table = count_jax.CountTable(
                    words=table.words[:out_cap],
                    counts=table.counts[:out_cap],
                    num_unique=jnp.minimum(table.num_unique, out_cap),
                    overflow=table.overflow | (table.num_unique > out_cap),
                )
        overflow = jax.lax.pmax(
            (overflow | table.overflow).astype(jnp.int32), axis
        )
        return (
            table.words,
            table.counts,
            table.num_unique[None],
            overflow > 0,
        )

    in_specs = (P(axis, None, None), P(axis))
    if with_mask:
        in_specs = in_specs + (P(axis, None, None),)
    mapped = shard_map(
        local_step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(axis, None), P(axis), P(axis), P()),
        check_vma=False,
    )

    @jax.jit
    def step(reads, n_valid, inv_mask=None):
        # reads arrive [D, B, L] row-sharded; local shard is [1, B, L]
        if with_mask:
            return mapped(reads, n_valid, inv_mask)
        return mapped(reads, n_valid)

    return step


def make_distributed_stream_count(
    mesh: Mesh, k: int, batch_per_device: int, read_len: int,
    bucket_cap: int, axis="d", with_mask: bool = False,
    minimizer_len: int | None = None,
):
    """Streamed variant of :func:`make_distributed_count`.

    One fused step routes a read *batch* to its hash owners and
    weighted-merges the received raw keys straight into the carried
    per-shard running table (count_jax.merge_raw_keys) — the distributed
    mirror of models.pipeline._stream_step, so arbitrarily large read
    sets count in bounded per-device memory with bounded compile shapes
    (one fused step over the whole read set scales its compile time and
    memory with the read count).

    Returns fn(words [D*C, W], counts [D*C], num [D], ovf [D],
               reads [D, B, L/4] packed, n_valid [D][, inv_mask])
      -> the table quadruple, updated (inputs donated). ovf accumulates
      routing-bucket and table overflow per shard; check after the last
      batch.
    """
    import functools

    from .mesh import axis_size

    d = axis_size(mesh, axis)
    owned = _make_owned_keys(d, k, read_len, bucket_cap, axis, minimizer_len)

    def local_step(tw, tc, tn, tov, reads, n_valid, inv_mask=None):
        keys, route_ovf = owned(reads, n_valid, inv_mask)
        table = count_jax.CountTable(
            words=tw, counts=tc, num_unique=tn[0], overflow=tov[0]
        )
        merged = count_jax.merge_raw_keys(table, keys)
        return (
            merged.words,
            merged.counts,
            merged.num_unique[None],
            (merged.overflow | route_ovf)[None],
        )

    in_specs = (
        P(axis, None), P(axis), P(axis), P(axis),
        P(axis, None, None), P(axis),
    )
    if with_mask:
        in_specs = in_specs + (P(axis, None, None),)
    mapped = shard_map(
        local_step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(axis, None), P(axis), P(axis), P(axis)),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
    def step(words, counts, num, ovf, reads, n_valid, inv_mask=None):
        if with_mask:
            return mapped(words, counts, num, ovf, reads, n_valid, inv_mask)
        return mapped(words, counts, num, ovf, reads, n_valid)

    return step


def _recv_rows(d: int, k: int, read_len: int, batch_per_device: int,
               bucket_cap: int, minimizer_len: int | None) -> int:
    """Rows of the per-shard key stream one _make_owned_keys call emits
    (the pending-buffer slot size for deferred-merge streaming)."""
    if minimizer_len is not None:
        from ..ops.superkmer import RUN_CAP

        return d * bucket_cap * RUN_CAP
    if d == 1:
        return batch_per_device * (read_len - k + 1)
    return d * bucket_cap


def make_distributed_stream_append(
    mesh: Mesh, k: int, batch_per_device: int, read_len: int,
    bucket_cap: int, axis="d", with_mask: bool = False,
    minimizer_len: int | None = None,
):
    """Routing-only streaming step for the deferred-merge cadence (the
    distributed mirror of models.pipeline._extract_append): one fused
    dispatch routes a read batch to its hash owners and lands the
    received raw keys in slot ``slot`` of a carried per-shard pending
    buffer (donated, in-place). The two cap-row merge sorts then run
    once per merge_stride batches (make_distributed_pending_merge)
    instead of every batch — bit-identical, merge_raw_keys is
    associative over key streams and ignores sentinel lanes.

    Returns fn(pending [D*S*R, W], ovf [D], reads [D, B, L/4] packed,
               n_valid [D], slot scalar i32[, inv_mask])
      -> (pending updated, ovf | routing overflow).
    """
    import functools

    from .mesh import axis_size

    d = axis_size(mesh, axis)
    owned = _make_owned_keys(d, k, read_len, bucket_cap, axis, minimizer_len)

    def local_append(pend, tov, reads, n_valid, slot, inv_mask=None):
        keys, route_ovf = owned(reads, n_valid, inv_mask)
        pend2 = jax.lax.dynamic_update_slice(
            pend, keys, (slot * keys.shape[0], jnp.int32(0))
        )
        return pend2, (tov[0] | route_ovf)[None]

    in_specs = (
        P(axis, None), P(axis),
        P(axis, None, None), P(axis), P(),
    )
    if with_mask:
        in_specs = in_specs + (P(axis, None, None),)
    mapped = shard_map(
        local_append,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(axis, None), P(axis)),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(pend, ovf, reads, n_valid, slot, inv_mask=None):
        if with_mask:
            return mapped(pend, ovf, reads, n_valid, slot, inv_mask)
        return mapped(pend, ovf, reads, n_valid, slot)

    return step


def make_distributed_pending_merge(mesh: Mesh, rows: int, axis="d"):
    """Merge the first ``rows`` rows of each shard's pending key buffer
    into the carried table shards. Tail flushes pass rows < the full
    buffer so stale keys from a previous merge round are never
    re-merged. Table quadruple donated; the pending buffer is not (it is
    reused by the next append round)."""
    import functools

    def local_merge(tw, tc, tn, tov, pend):
        table = count_jax.CountTable(
            words=tw, counts=tc, num_unique=tn[0], overflow=tov[0]
        )
        merged = count_jax.merge_raw_keys(table, pend[:rows])
        return (
            merged.words,
            merged.counts,
            merged.num_unique[None],
            merged.overflow[None],
        )

    mapped = shard_map(
        local_merge,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(axis), P(axis, None)),
        out_specs=(P(axis, None), P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0, 1, 2, 3))


def make_distributed_stream_count_bucketed(
    mesh: Mesh, k: int, batch_per_device: int, read_len: int,
    bucket_cap: int, axis="d", with_mask: bool = False,
    minimizer_len: int | None = None, *, m_seg: int,
):
    """Bucketed-table variant of :func:`make_distributed_stream_count`.

    Each shard carries its running table in the hash-bucketed layout
    (ops.bucketed.BucketedTable), so the per-batch merge runs as batched
    [nb, cb+m] sorts instead of two monolithic (c_shard + recv)-row sorts
    once a shard's merge reaches BUCKETED_MIN_MERGE_ROWS (SURVEY.md §5
    long-context row). Global array shapes:
    words [D*nb, cb, W], counts [D*nb, cb], num [D*nb], ovf [D], all
    row-sharded on ``axis``. m_seg is the per-bucket batch segment
    capacity (ops.bucketed.bucket_geometry).

    The shard-local bucket hash (ops.bucketed._mix_words) is independent
    of the owner-routing hash (ops.hash.mix_words), so per-shard bucket
    loads stay Poisson-uniform even though every key on a shard already
    shares owner = mix_words(key) % D.
    """
    import functools

    from ..ops.bucketed import BucketedTable, merge_raw_keys_bucketed_impl
    from .mesh import axis_size

    d = axis_size(mesh, axis)
    owned = _make_owned_keys(d, k, read_len, bucket_cap, axis, minimizer_len)

    def local_step(tw, tc, tn, tov, reads, n_valid, inv_mask=None):
        keys, route_ovf = owned(reads, n_valid, inv_mask)
        bt = BucketedTable(
            words=tw, counts=tc, num_unique=tn, overflow=tov[0]
        )
        merged = merge_raw_keys_bucketed_impl(bt, keys, m=m_seg)
        return (
            merged.words,
            merged.counts,
            merged.num_unique,
            (merged.overflow | route_ovf)[None],
        )

    in_specs = (
        P(axis, None, None), P(axis, None), P(axis), P(axis),
        P(axis, None, None), P(axis),
    )
    if with_mask:
        in_specs = in_specs + (P(axis, None, None),)
    mapped = shard_map(
        local_step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(axis, None, None), P(axis, None), P(axis), P(axis)),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
    def step(words, counts, num, ovf, reads, n_valid, inv_mask=None):
        if with_mask:
            return mapped(words, counts, num, ovf, reads, n_valid, inv_mask)
        return mapped(words, counts, num, ovf, reads, n_valid)

    return step


def make_distributed_stream_route_append_bucketed(
    mesh: Mesh, k: int, batch_per_device: int, read_len: int,
    bucket_cap: int, axis="d", with_mask: bool = False,
    minimizer_len: int | None = None, *, m_seg: int, nb_buckets: int,
):
    """Accumulated-staging variant of the per-shard bucketed stream step
    (the distributed mirror of models.pipeline._route_append_step /
    GA_BUCKET_ACCUM).

    Per batch each shard only routes its owned keys (all-to-all) and
    bucket-packs them into slot ``slot`` of its carried staging buffer
    (a num_keys=1 bucket sort of just the batch rows); the [nb, cb+S]
    table merge sorts run once per GA_BUCKET_ACCUM batches via
    make_distributed_staged_merge_bucketed — bit-identical, since
    merge_packed aggregates weighted rows associatively and a key's
    shard-local bucket never changes. Staging shape per shard:
    [nb, accum*m_seg, W]; route/bucket overflow carries in a per-shard
    pending flag folded into the table overflow at the next merge.
    """
    import functools

    from ..ops.bucketed import route_pack_keys_impl
    from .mesh import axis_size

    d = axis_size(mesh, axis)
    owned = _make_owned_keys(d, k, read_len, bucket_cap, axis, minimizer_len)

    def local_step(staging, pov, reads, n_valid, slot, inv_mask=None):
        keys, route_ovf = owned(reads, n_valid, inv_mask)
        packed, over_m = route_pack_keys_impl(keys, nb=nb_buckets, m=m_seg)
        staging = jax.lax.dynamic_update_slice(
            staging, packed, (jnp.int32(0), slot * m_seg, jnp.int32(0))
        )
        return staging, (pov[0] | route_ovf | over_m)[None]

    in_specs = (
        P(axis, None, None), P(axis),
        P(axis, None, None), P(axis), P(),
    )
    if with_mask:
        in_specs = in_specs + (P(axis, None, None),)
    mapped = shard_map(
        local_step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(axis, None, None), P(axis)),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(staging, pov, reads, n_valid, slot, inv_mask=None):
        if with_mask:
            return mapped(staging, pov, reads, n_valid, slot, inv_mask)
        return mapped(staging, pov, reads, n_valid, slot)

    return step


def make_distributed_staged_merge_bucketed(
    mesh: Mesh, rows: int, axis="d"
):
    """Merge the first ``rows`` staged pre-routed columns of each
    shard's staging buffer into its bucketed table shard (the merge half
    of the accumulated streaming step; ``rows < accum*m_seg`` only for
    the static tail flush). The per-shard pending-overflow flag folds
    into the table overflow here."""
    from ..ops.bucketed import BucketedTable, merge_packed_bucketed_impl

    def local_merge(tw, tc, tn, tov, staging, pov):
        bt = BucketedTable(
            words=tw, counts=tc, num_unique=tn, overflow=tov[0]
        )
        merged = merge_packed_bucketed_impl(
            bt, staging[:, :rows], pov[0]
        )
        return (
            merged.words,
            merged.counts,
            merged.num_unique,
            merged.overflow[None],
        )

    mapped = shard_map(
        local_merge,
        mesh=mesh,
        in_specs=(
            P(axis, None, None), P(axis, None), P(axis), P(axis),
            P(axis, None, None), P(axis),
        ),
        out_specs=(P(axis, None, None), P(axis, None), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0, 1, 2, 3))


def make_distributed_pending_merge_bucketed(
    mesh: Mesh, rows: int, axis="d", *, m_seg: int
):
    """Bucketed counterpart of :func:`make_distributed_pending_merge`:
    merge the first ``rows`` rows of each shard's pending raw-key buffer
    into its bucketed table shard (deferred-merge cadence)."""
    from ..ops.bucketed import BucketedTable, merge_raw_keys_bucketed_impl

    def local_merge(tw, tc, tn, tov, pend):
        bt = BucketedTable(
            words=tw, counts=tc, num_unique=tn, overflow=tov[0]
        )
        merged = merge_raw_keys_bucketed_impl(bt, pend[:rows], m=m_seg)
        return (
            merged.words,
            merged.counts,
            merged.num_unique,
            merged.overflow[None],
        )

    mapped = shard_map(
        local_merge,
        mesh=mesh,
        in_specs=(
            P(axis, None, None), P(axis, None), P(axis), P(axis),
            P(axis, None),
        ),
        out_specs=(P(axis, None, None), P(axis, None), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0, 1, 2, 3))


def make_distributed_flatten_bucketed(mesh: Mesh, c_shard: int, axis="d"):
    """Per-shard bucketed -> flat compact-front table (one monolithic
    sort per shard, paid once at stream end): the sharded mirror of
    ops.bucketed.flatten_bucketed, so everything downstream of the
    streaming counter (filter, compress, host pulls, checkpoints) sees
    the exact flat-table layout the non-bucketed path produces."""
    from ..ops.bucketed import BucketedTable, flatten_bucketed_impl

    def local_flatten(tw, tc, tn, tov):
        bt = BucketedTable(
            words=tw, counts=tc, num_unique=tn, overflow=tov[0]
        )
        t = flatten_bucketed_impl(bt, capacity=c_shard)
        return t.words, t.counts, t.num_unique[None], t.overflow[None]

    mapped = shard_map(
        local_flatten,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None), P(axis), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0, 1, 2, 3))


# Above this many windows per device, the distributed counter streams
# read batches into carried table shards instead of running one fused
# step over the whole read set (whose compile time and memory scale with
# its shape). A tuning constant (ROADMAP A7).
DIST_STREAM_WINDOWS = int(os.environ.get("GA_DIST_STREAM_WINDOWS", 1 << 24))


def _a2a_count_bytes_per_step(
    d: int, k: int, bucket_cap: int, minimizer_len: int | None
) -> int:
    """All-to-all volume of one counting routing step: the static send
    buffer is [D, bucket_cap, cols] int32 per device, exchanged once, so
    the logical wire volume summed across devices is D x that (SURVEY.md
    §5 metrics row; VERDICT r2 item 6). Zero when d == 1 (routing is
    skipped entirely). The minimizer path's smaller record buffer is what
    makes its >2.5x wire saving observable in run metrics.
    """
    if d == 1:
        return 0
    if minimizer_len is not None:
        from ..ops.superkmer import span_words

        cols = span_words(k) + 1
    else:
        cols = key_words(k)
    return d * d * bucket_cap * cols * 4


def save_sharded_stream_checkpoint(
    words, counts, num, ovf, path: str, *, next_batch: int,
    params: dict[str, int],
) -> None:
    """Mid-stream checkpoint of the sharded streaming counter: per-shard
    table quadruple + the batch cursor (VERDICT r2 item 7). ``params``
    pins everything byte-identity depends on; resume refuses a mismatch.
    """
    from ..utils.jaxenv import to_host

    np.savez_compressed(
        path,
        words=to_host(words),
        counts=to_host(counts),
        num=to_host(num),
        ovf=to_host(ovf),
        next_batch=np.asarray(next_batch),
        layout=np.asarray("hash_shards_stream"),
        **{k: np.asarray(v) for k, v in params.items()},
    )


def is_sharded_stream_checkpoint(path: str) -> bool:
    with np.load(path) as z:
        return (
            "layout" in z.files and str(z["layout"]) == "hash_shards_stream"
        )


def load_sharded_stream_checkpoint(path: str):
    with np.load(path) as z:
        arrays = {k: z[k] for k in ("words", "counts", "num", "ovf")}
        params = {
            k: int(z[k])
            for k in z.files
            if k not in ("words", "counts", "num", "ovf", "next_batch",
                         "layout")
        }
        return arrays, int(z["next_batch"]), params


def reshard_sharded_stream_checkpoint(
    path_in: str, path_out: str, reads_shape: tuple[int, int],
    cfg: AssemblyConfig, new_d: int, *,
    bucket_cap: int | None = None, minimizer_len: int | None = None,
    table_capacity: int | None = None, merge_stride: int | None = None,
) -> None:
    """Elastic recovery: rewrite a mid-stream sharded checkpoint for a
    DIFFERENT mesh size, so a preempted pod-scale count resumes on
    however many devices are left (SURVEY.md §5 failure/elastic row —
    beyond same-shape restart, which load_sharded_stream_checkpoint
    already gives).

    Shard ownership is a pure function of the key (owner =
    mix_words(key) % D), so resharding is a host-side repartition of the
    already-counted (key, count) rows — no device work, no recounting:
    collect every shard's valid rows, recompute owners for ``new_d``,
    re-sort each new shard (keys are globally unique, so a sort IS the
    merge), and write a snapshot whose params/layout/geometry match
    exactly what a ``new_d``-mesh resume of the same read set will
    compute (same cfg/capacity/stride args and GA_* env as that resume —
    the plan is env-sensitive, and the params equality check on resume
    is the guarantee). The batch cursor carries over as consumed reads:
    cfg.batch_reads divisible by both mesh sizes keeps the global batch
    size identical, else the cursor would split a batch (checked error).

    reads_shape: (num_reads, read_len) of the ORIGINAL read set.
    """
    from ..ops.count_jax import CountTable
    from ..ops.hash import mix_words
    from ..ops.kmer_jax import SENTINEL

    if minimizer_len is not None:
        raise ValueError(
            "resharding a minimizer-routed stream is unsupported: under "
            "super-k-mer routing a key's owner is its MINIMIZER's hash "
            "% d, not mix_words(key) % d, so a host-side repartition by "
            "key hash would split keys across shards; resume on the "
            "original mesh size instead"
        )
    b, length = reads_shape
    arrays, next_batch, got = load_sharded_stream_checkpoint(path_in)
    if got.get("minimizer", 0):
        raise ValueError(
            "checkpoint was written by a minimizer-routed stream; "
            "resharding is unsupported for it (see docstring)"
        )
    if got.get("k") != cfg.k or got.get("total_reads") != b:
        raise ValueError(
            f"checkpoint {path_in} is for k={got.get('k')}, "
            f"total_reads={got.get('total_reads')}; this read set has "
            f"k={cfg.k}, total_reads={b}"
        )
    old_d = got["d"]
    new_plan = _StreamPlan(
        b, length, cfg, new_d, bucket_cap, minimizer_len, table_capacity,
        merge_stride,
    )
    consumed = next_batch * got["batch_total"]
    if consumed % new_plan.batch_total:
        raise ValueError(
            f"cursor at {consumed} consumed reads does not align with the "
            f"new global batch of {new_plan.batch_total} (old batch "
            f"{got['batch_total']}); pick batch_reads divisible by both "
            "mesh sizes"
        )

    w = key_words(cfg.k)
    # collect every shard's valid (key, count) rows, either layout
    if got.get("bucketed"):
        nbo, cbo = got["nb"], got["cb"]
        words3 = arrays["words"].reshape(old_d * nbo, cbo, w)
        counts2 = arrays["counts"].reshape(old_d * nbo, cbo)
        num = arrays["num"].reshape(old_d * nbo)
    else:
        c_old = got["c_shard"]
        words3 = arrays["words"].reshape(old_d, c_old, w)
        counts2 = arrays["counts"].reshape(old_d, c_old)
        num = arrays["num"].reshape(old_d)
    lane = np.arange(words3.shape[1])
    valid = lane[None, :] < num[:, None]
    keys_all = words3[valid]
    counts_all = counts2[valid]
    if bool(np.any(arrays["ovf"])):
        raise ValueError(
            f"checkpoint {path_in} carries an overflow flag; it cannot be "
            "resharded (the counts are already unreliable)"
        )

    owner = mix_words(np.ascontiguousarray(keys_all)) % np.uint32(new_d)
    new_words = np.full(
        (new_d, new_plan.c_shard, w), int(SENTINEL), dtype=np.uint32
    )
    new_counts = np.zeros((new_d, new_plan.c_shard), dtype=np.int32)
    new_num = np.zeros(new_d, dtype=np.int32)
    new_ovf = np.zeros(new_d, dtype=bool)
    for s in range(new_d):
        sel = owner == s
        ks = keys_all[sel]
        cs = counts_all[sel]
        # big-endian word order: column 0 is the primary sort key
        order = np.lexsort(tuple(ks[:, i] for i in range(w - 1, -1, -1)))
        n = ks.shape[0]
        if n > new_plan.c_shard:
            new_ovf[s] = True
            n = new_plan.c_shard
            order = order[:n]
        new_words[s, :n] = ks[order]
        new_counts[s, :n] = cs[order]
        new_num[s] = n

    if new_plan.use_bucketed:
        # the resumed run expects the bucketed layout: bucketize each
        # shard with the exact production routine (ops.bucketed)
        from ..ops import bucketed as bucketed_mod

        bw = np.empty(
            (new_d * new_plan.nbk, new_plan.cb, w), dtype=np.uint32
        )
        bc = np.empty((new_d * new_plan.nbk, new_plan.cb), dtype=np.int32)
        bn = np.empty(new_d * new_plan.nbk, dtype=np.int32)
        for s in range(new_d):
            bt = bucketed_mod.bucketize(
                CountTable(
                    words=new_words[s],
                    counts=new_counts[s],
                    num_unique=new_num[s],
                    overflow=new_ovf[s],
                ),
                nb=new_plan.nbk,
                cb=new_plan.cb,
            )
            sl = slice(s * new_plan.nbk, (s + 1) * new_plan.nbk)
            bw[sl] = np.asarray(bt.words)
            bc[sl] = np.asarray(bt.counts)
            bn[sl] = np.asarray(bt.num_unique)
            new_ovf[s] = new_ovf[s] or bool(bt.overflow)
        out = (bw, bc, bn, new_ovf)
    else:
        out = (
            new_words.reshape(new_d * new_plan.c_shard, w),
            new_counts.reshape(-1),
            new_num,
            new_ovf,
        )
    if bool(np.any(new_ovf)):
        raise ValueError(
            f"resharding to d={new_d} overflows a shard "
            f"(c_shard={new_plan.c_shard}); pass a larger table_capacity"
        )
    save_sharded_stream_checkpoint(
        *out, path_out,
        next_batch=consumed // new_plan.batch_total,
        params=new_plan.ck_params,
    )


def _bucket_cap_for(windows: int, d: int, k: int,
                    minimizer_len: int | None) -> int:
    """Routing-bucket capacity for one device's window count + skew slack."""
    if minimizer_len is not None:
        from ..ops.superkmer import mean_run

        # records per device ~ windows / expected run length
        # (~(k-m+2)/2, variance-discounted) plus skew slack
        return int(windows / mean_run(k, minimizer_len) / d * 1.6) + 128
    # expected windows/bucket plus generous skew slack
    return int(windows / d * 1.5) + 64


class _StreamPlan:
    """Every shape/geometry decision of one distributed streaming run,
    derived deterministically from (read-set shape, cfg, mesh size,
    knobs + env). Factored out of _run_distributed_stream so the elastic
    resharder (reshard_sharded_stream_checkpoint) reproduces EXACTLY the
    plan a resumed run will compute — the checkpoint-params equality
    check then guarantees the rewritten snapshot is acceptable."""

    def __init__(self, b, length, cfg, d, bucket_cap, minimizer_len,
                 table_capacity, merge_stride):
        from ..ops.count_jax import snug_capacity

        self.d = d
        self.b = b
        self.length = length
        wc = length - cfg.k + 1
        self.per_dev = max(1, cfg.batch_reads // d)
        self.batch_total = self.per_dev * d
        self.num_batches = -(-b // self.batch_total)
        cap_global = table_capacity or min(b * wc, 1 << 26)
        self.c_shard = snug_capacity(int(cap_global / d * 1.3) + 64)
        self.bucket_cap = (
            bucket_cap
            if bucket_cap is not None
            else _bucket_cap_for(self.per_dev * wc, d, cfg.k, minimizer_len)
        )
        stride = merge_stride or int(os.environ.get("GA_MERGE_STRIDE", "1"))
        self.strided = stride > 1 and self.num_batches > 1
        self.stride = stride if self.strided else 1
        self.recv = _recv_rows(
            d, cfg.k, length, self.per_dev, self.bucket_cap, minimizer_len
        )
        from ..models.pipeline import BUCKETED_MIN_MERGE_ROWS

        merge_rows_shard = self.c_shard + self.stride * self.recv
        env_bucketed = os.environ.get("GA_BUCKETED", "auto")
        if env_bucketed == "auto":
            self.use_bucketed = merge_rows_shard >= BUCKETED_MIN_MERGE_ROWS
        else:
            self.use_bucketed = env_bucketed == "1"
        self.nbk = self.cb = self.m_seg = None
        self.accum = 1
        if self.use_bucketed:
            from ..ops import bucketed as bucketed_mod

            # Accumulated staging (GA_BUCKET_ACCUM), the distributed
            # mirror of the single-device default: per batch only
            # route+pack; pay the cb-row table merge every accum
            # batches. Incompatible with merge_stride (both defer
            # merges — stride takes precedence when set).
            if not self.strided:
                self.accum = max(
                    1, int(os.environ.get("GA_BUCKET_ACCUM", "4"))
                )
            cb_slack = float(os.environ.get("GA_BUCKET_SLACK", "1.25"))
            m_slack = float(
                os.environ.get("GA_BUCKET_BATCH_SLACK", "1.5")
            )
            env_nb = os.environ.get("GA_BUCKETS")
            self.nbk = (
                int(env_nb) if env_nb
                else bucketed_mod.auto_buckets(
                    self.c_shard, self.stride * self.recv, self.accum,
                    cb_slack, m_slack,
                )
            )
            self.cb, self.m_seg = bucketed_mod.bucket_geometry(
                self.c_shard,
                self.stride * self.recv,
                nb=self.nbk,
                cb_slack=cb_slack,
                m_slack=m_slack,
            )
        self.ck_params = {
            "d": d,
            "k": cfg.k,
            "batch_total": self.batch_total,
            "c_shard": self.c_shard,
            "stride": self.stride,
            "total_reads": b,
            "bucket_cap": self.bucket_cap,
            "bucketed": int(self.use_bucketed),
            # routing function identity: a key's owner is mix_words(key)%d
            # per-window but its MINIMIZER's hash % d under super-k-mer
            # routing — resuming with a different routing would split
            # keys across shards, so it is pinned like every other
            # byte-identity parameter
            "minimizer": 0 if minimizer_len is None else minimizer_len,
        }
        if self.use_bucketed:
            self.ck_params.update(
                {
                    "nb": self.nbk,
                    "cb": self.cb,
                    "m": self.m_seg,
                    "accum": self.accum,
                }
            )


def _run_distributed_stream(
    reads: np.ndarray, cfg: AssemblyConfig, mesh: Mesh,
    bucket_cap: int | None, axis, minimizer_len: int | None,
    table_capacity: int | None, merge_stride: int | None = None,
    metrics=None, stream_checkpoint: str | None = None,
    stream_checkpoint_every: int = 0,
    resume_stream_from: str | None = None,
):
    """Streamed counterpart of _run_distributed_step: batches of
    cfg.batch_reads global reads stream through
    make_distributed_stream_count with double-buffered uploads.

    table_capacity bounds GLOBAL unique k-mers (genome-scale, like the
    single-device streaming path); each shard gets capacity/d with hash
    -skew slack, snapped to the snug grid. Overflow (bucket or shard
    table) raises after the last batch — flagged, never silent.

    merge_stride > 1 (GA_MERGE_STRIDE is the env fallback) defers the
    per-shard table merge: routing-only steps append raw keys to a
    pending buffer and the two cap-row merge sorts run once per stride
    batches (bit-identical; see models.pipeline.count_reads_device).

    metrics records wire/link volume per run: a2a_bytes_count (the
    all-to-all routing volume, all devices) and h2d_bytes_reads.

    stream_checkpoint + stream_checkpoint_every=N snapshot the per-shard
    table quadruple and batch cursor every N batches at merge boundaries;
    resume_stream_from continues a killed run byte-identically (same
    mesh size / k / batching / capacity / stride — enforced).
    GA_STREAM_ABORT_AFTER_BATCH=<n> injects a failure after n batches.
    """
    from ..utils.dna import has_ambiguous, pack_invalid_mask
    from ..utils.jaxenv import to_host
    from .mesh import axis_size

    d = axis_size(mesh, axis)
    b, length = reads.shape
    w = key_words(cfg.k)
    # Per-shard bucketed-merge auto-switch lives in the plan: the same
    # BUCKETED_MIN_MERGE_ROWS bound as the single-device streaming path
    # (models.pipeline), keyed off the PER-SHARD merge rows.
    plan = _StreamPlan(
        b, length, cfg, d, bucket_cap, minimizer_len, table_capacity,
        merge_stride,
    )
    per_dev, batch_total, nb = plan.per_dev, plan.batch_total, plan.num_batches
    c_shard, bucket_cap = plan.c_shard, plan.bucket_cap
    stride, strided, recv = plan.stride, plan.strided, plan.recv
    use_bucketed = plan.use_bucketed
    nbk, cb, m_seg = plan.nbk, plan.cb, plan.m_seg
    any_invalid = has_ambiguous(reads)
    a2a_step = _a2a_count_bytes_per_step(d, cfg.k, bucket_cap, minimizer_len)
    ck_params = plan.ck_params
    row_sharding = NamedSharding(mesh, P(axis))
    sharding3 = NamedSharding(mesh, P(axis, None, None))
    if strided:
        append = make_distributed_stream_append(
            mesh, cfg.k, per_dev, length, bucket_cap, axis,
            with_mask=any_invalid, minimizer_len=minimizer_len,
        )
        if use_bucketed:
            merge_full = make_distributed_pending_merge_bucketed(
                mesh, stride * recv, axis, m_seg=m_seg
            )
        else:
            merge_full = make_distributed_pending_merge(
                mesh, stride * recv, axis
            )
        pend = jax.device_put(
            np.full((d * stride * recv, w), int(SENTINEL), dtype=np.uint32),
            NamedSharding(mesh, P(axis, None)),
        )
        slot = 0
    elif use_bucketed and plan.accum > 1:
        append_staged = make_distributed_stream_route_append_bucketed(
            mesh, cfg.k, per_dev, length, bucket_cap, axis,
            with_mask=any_invalid, minimizer_len=minimizer_len,
            m_seg=m_seg, nb_buckets=nbk,
        )
        merge_staged = make_distributed_staged_merge_bucketed(
            mesh, plan.accum * m_seg, axis
        )
        staging = jax.device_put(
            np.full(
                (d * nbk, plan.accum * m_seg, w), int(SENTINEL),
                dtype=np.uint32,
            ),
            NamedSharding(mesh, P(axis, None, None)),
        )
        pov = jax.device_put(np.zeros(d, bool), row_sharding)
        slot = 0
    elif use_bucketed:
        step = make_distributed_stream_count_bucketed(
            mesh, cfg.k, per_dev, length, bucket_cap, axis,
            with_mask=any_invalid, minimizer_len=minimizer_len,
            m_seg=m_seg,
        )
    else:
        step = make_distributed_stream_count(
            mesh, cfg.k, per_dev, length, bucket_cap, axis,
            with_mask=any_invalid, minimizer_len=minimizer_len,
        )
    start_batch = 0
    if resume_stream_from is not None:
        arrays, start_batch, got = load_sharded_stream_checkpoint(
            resume_stream_from
        )
        if got != ck_params:
            raise ValueError(
                f"sharded mid-stream checkpoint mismatch: saved {got}, "
                f"this run has {ck_params} — resume requires identical "
                "mesh size/k/batching/capacity/stride/read-set"
            )
        w_spec = P(axis, None, None) if use_bucketed else P(axis, None)
        c_spec = P(axis, None) if use_bucketed else P(axis)
        words = jax.device_put(
            arrays["words"], NamedSharding(mesh, w_spec)
        )
        counts = jax.device_put(arrays["counts"], NamedSharding(mesh, c_spec))
        num = jax.device_put(arrays["num"], row_sharding)
        ovf = jax.device_put(arrays["ovf"], row_sharding)
    elif use_bucketed:
        words = jax.device_put(
            np.full((d * nbk, cb, w), 0xFFFFFFFF, dtype=np.uint32),
            NamedSharding(mesh, P(axis, None, None)),
        )
        counts = jax.device_put(
            np.zeros((d * nbk, cb), np.int32),
            NamedSharding(mesh, P(axis, None)),
        )
        num = jax.device_put(np.zeros(d * nbk, np.int32), row_sharding)
        ovf = jax.device_put(np.zeros(d, bool), row_sharding)
    else:
        words = jax.device_put(
            np.full((d * c_shard, w), 0xFFFFFFFF, dtype=np.uint32),
            NamedSharding(mesh, P(axis, None)),
        )
        counts = jax.device_put(np.zeros(d * c_shard, np.int32), row_sharding)
        num = jax.device_put(np.zeros(d, np.int32), row_sharding)
        ovf = jax.device_put(np.zeros(d, bool), row_sharding)

    def upload(i):
        start = i * batch_total
        rows = reads[start : start + batch_total]
        if rows.shape[0] < batch_total:
            # pad only the short tail batch (page-fault pricing:
            # utils.dna.has_ambiguous)
            rows = np.concatenate(
                [rows,
                 np.zeros((batch_total - rows.shape[0], length), np.uint8)],
                axis=0,
            )
        packed = pack_codes(rows)
        nv = np.clip(
            b - start - per_dev * np.arange(d), 0, per_dev
        ).astype(np.int32)
        mask_dev = None
        h2d = packed.nbytes + nv.nbytes
        if any_invalid:
            m_ = pack_invalid_mask(rows)
            if m_ is None:  # locally clean batch: constant jit signature
                m_ = np.zeros((rows.shape[0], (length + 7) // 8), np.uint8)
            h2d += m_.nbytes
            mask_dev = jax.device_put(
                m_.reshape(d, per_dev, -1), sharding3
            )
        if metrics is not None:
            metrics.count("h2d_bytes_reads", h2d)
        return (
            jax.device_put(packed.reshape(d, per_dev, -1), sharding3),
            jax.device_put(nv, row_sharding),
            mask_dev,
        )

    abort_after = int(os.environ.get("GA_STREAM_ABORT_AFTER_BATCH", "0"))
    since_ckpt = 0
    pending = upload(start_batch)
    for i in range(start_batch, nb):
        reads_dev, nv_dev, mask_dev = pending
        if i + 1 < nb:
            pending = upload(i + 1)  # DMA rides under batch i's compute
        if strided:
            args = (pend, ovf, reads_dev, nv_dev, jnp.int32(slot))
            if any_invalid:
                args = args + (mask_dev,)
            pend, ovf = append(*args)
            slot += 1
            if slot == stride:
                words, counts, num, ovf = merge_full(
                    words, counts, num, ovf, pend
                )
                slot = 0
        elif use_bucketed and plan.accum > 1:
            args = (staging, pov, reads_dev, nv_dev, jnp.int32(slot))
            if any_invalid:
                args = args + (mask_dev,)
            staging, pov = append_staged(*args)
            slot += 1
            if slot == plan.accum:
                # pov folds into the table overflow inside the merge
                words, counts, num, ovf = merge_staged(
                    words, counts, num, ovf, staging, pov
                )
                pov = jax.device_put(np.zeros(d, bool), row_sharding)
                slot = 0
        elif any_invalid:
            words, counts, num, ovf = step(
                words, counts, num, ovf, reads_dev, nv_dev, mask_dev
            )
        else:
            words, counts, num, ovf = step(
                words, counts, num, ovf, reads_dev, nv_dev
            )
        if metrics is not None:
            metrics.count("a2a_bytes_count", a2a_step)
        since_ckpt += 1
        at_merge_boundary = (
            slot == 0
            if (strided or (use_bucketed and plan.accum > 1))
            else True
        )
        if (
            stream_checkpoint is not None
            and stream_checkpoint_every > 0
            and since_ckpt >= stream_checkpoint_every
            and at_merge_boundary
            and i + 1 < nb
        ):
            save_sharded_stream_checkpoint(
                words, counts, num, ovf, stream_checkpoint,
                next_batch=i + 1, params=ck_params,
            )
            since_ckpt = 0
        if abort_after and (i + 1 - start_batch) >= abort_after:
            raise RuntimeError(
                f"fault injection: GA_STREAM_ABORT_AFTER_BATCH="
                f"{abort_after} reached at batch {i + 1}/{nb}"
            )
    if strided and slot:
        if use_bucketed:
            merge_tail = make_distributed_pending_merge_bucketed(
                mesh, slot * recv, axis, m_seg=m_seg
            )
        else:
            merge_tail = make_distributed_pending_merge(
                mesh, slot * recv, axis
            )
        words, counts, num, ovf = merge_tail(words, counts, num, ovf, pend)
    elif use_bucketed and plan.accum > 1 and slot:
        # tail flush: only the filled slots (static slice — one extra
        # compile per distinct tail length, same as strided)
        merge_tail = make_distributed_staged_merge_bucketed(
            mesh, slot * m_seg, axis
        )
        words, counts, num, ovf = merge_tail(
            words, counts, num, ovf, staging, pov
        )
    if use_bucketed:
        # one monolithic sort per shard, paid once at stream end: back to
        # the exact flat compact-front layout downstream expects
        words, counts, num, ovf = make_distributed_flatten_bucketed(
            mesh, c_shard, axis
        )(words, counts, num, ovf)
    if bool(np.any(to_host(ovf))):
        raise RuntimeError(
            "distributed streaming overflow (routing bucket or table "
            "shard); increase table_capacity / bucket_cap (under the "
            "bucketed per-shard merge: GA_BUCKETED=0 or a larger "
            "GA_BUCKET_SLACK / GA_BUCKET_BATCH_SLACK)"
        )
    return words, counts, num


def _run_distributed_step(
    reads: np.ndarray, cfg: AssemblyConfig, mesh: Mesh,
    bucket_cap: int | None, axis, minimizer_len: int | None = None,
    table_capacity: int | None = None, merge_stride: int | None = None,
    metrics=None, stream_checkpoint: str | None = None,
    stream_checkpoint_every: int = 0,
    resume_stream_from: str | None = None,
):
    """Shared front half of the distributed counters: pad + shard + pack
    the reads, build/run the jitted step, check routing overflow.

    Streams (bounded per-device HBM and compile shapes) once the
    per-device window count exceeds DIST_STREAM_WINDOWS; one fused step
    below it. Returns (words, counts, num_unique) device arrays (see
    make_distributed_count). metrics/stream_checkpoint*: see
    _run_distributed_stream (the one-shot path records its wire volume
    but has no mid-stream state to checkpoint).
    """
    from .mesh import axis_size

    d = axis_size(mesh, axis)
    b, length = reads.shape
    if (
        -(-b // d) * (length - cfg.k + 1) > DIST_STREAM_WINDOWS
        or resume_stream_from is not None
    ):
        return _run_distributed_stream(
            reads, cfg, mesh, bucket_cap, axis, minimizer_len,
            table_capacity, merge_stride, metrics=metrics,
            stream_checkpoint=stream_checkpoint,
            stream_checkpoint_every=stream_checkpoint_every,
            resume_stream_from=resume_stream_from,
        )
    per_dev = -(-b // d)
    padded = per_dev * d
    if padded != b:
        reads = np.concatenate(
            [reads, np.zeros((padded - b, length), dtype=np.uint8)], axis=0
        )
    n_valid = np.clip(b - per_dev * np.arange(d), 0, per_dev).astype(np.int32)
    windows = per_dev * (length - cfg.k + 1)
    if bucket_cap is None:
        bucket_cap = _bucket_cap_for(windows, d, cfg.k, minimizer_len)
    from ..utils.dna import has_ambiguous, pack_invalid_mask

    inv_mask = pack_invalid_mask(reads) if has_ambiguous(reads) else None
    step = make_distributed_count(
        mesh, cfg.k, per_dev, length, bucket_cap, axis,
        with_mask=inv_mask is not None, minimizer_len=minimizer_len,
    )
    sharding = NamedSharding(mesh, P(axis, None, None))
    packed = pack_codes(reads)
    reads_dev = jax.device_put(
        packed.reshape(d, per_dev, packed.shape[1]), sharding
    )
    mask_dev = None
    if inv_mask is not None:
        mask_dev = jax.device_put(
            inv_mask.reshape(d, per_dev, inv_mask.shape[1]), sharding
        )
    if metrics is not None:
        metrics.count(
            "a2a_bytes_count",
            _a2a_count_bytes_per_step(d, cfg.k, bucket_cap, minimizer_len),
        )
        metrics.count(
            "h2d_bytes_reads",
            packed.nbytes + (inv_mask.nbytes if inv_mask is not None else 0),
        )
    words, counts, num_unique, overflow = step(reads_dev, n_valid, mask_dev)
    if bool(overflow):
        raise RuntimeError(
            "bucket overflow during all-to-all routing; increase bucket_cap"
        )
    return words, counts, num_unique


def distributed_count_to_host(
    reads: np.ndarray, cfg: AssemblyConfig, mesh: Mesh, *,
    bucket_cap: int | None = None, axis=None,
    minimizer_len: int | None = None, table_capacity: int | None = None,
    merge_stride: int | None = None, metrics=None,
) -> dict[str, int]:
    """Count reads over the mesh; gather the global table as a host dict."""
    from .mesh import axis_size, mesh_axes

    axis = axis if axis is not None else mesh_axes(mesh)
    d = axis_size(mesh, axis)
    words, counts, num_unique = _run_distributed_step(
        reads, cfg, mesh, bucket_cap, axis, minimizer_len,
        table_capacity=table_capacity, merge_stride=merge_stride,
        metrics=metrics,
    )
    from ..utils.jaxenv import to_host

    words = to_host(words).reshape(d, -1, key_words(cfg.k))
    counts = to_host(counts).reshape(d, -1)
    num_unique = to_host(num_unique)
    if metrics is not None:
        metrics.count("d2h_bytes_table", words.nbytes + counts.nbytes)
    merged: dict[str, int] = {}
    for dev in range(d):
        n = int(num_unique[dev])
        merged.update(counts_to_dict(words[dev, :n], counts[dev, :n], cfg.k))
    return merged


def distributed_count_table(
    reads: np.ndarray, cfg: AssemblyConfig, mesh: Mesh, *,
    bucket_cap: int | None = None, axis=None,
    minimizer_len: int | None = None, table_capacity: int | None = None,
    merge_stride: int | None = None, metrics=None,
    stream_checkpoint: str | None = None,
    stream_checkpoint_every: int = 0,
    resume_stream_from: str | None = None,
) -> "count_jax.CountTable":
    """Count reads over the mesh; merge shard tables into one CountTable.

    Shards own disjoint hash buckets (not lexicographic ranges), so the
    gathered table re-sorts once with counts as weights — the
    reduce-scatter-then-gather step of the north-star design, sized by the
    genome (unique k-mers), not the read stream.
    """
    from .mesh import mesh_axes

    axis = axis if axis is not None else mesh_axes(mesh)
    words, counts, _ = _run_distributed_step(
        reads, cfg, mesh, bucket_cap, axis, minimizer_len,
        table_capacity=table_capacity, merge_stride=merge_stride,
        metrics=metrics, stream_checkpoint=stream_checkpoint,
        stream_checkpoint_every=stream_checkpoint_every,
        resume_stream_from=resume_stream_from,
    )
    # Gather shard tables and re-count with multiplicity weights: shard
    # keys are disjoint, so this is a pure re-sort into global order.
    # (Multi-process: every host assembles the same global table and the
    # back half runs replicated — correct, if wasteful; the sharded-graph
    # path is the scalable alternative.)
    from ..utils.jaxenv import to_host

    words_h = np.ascontiguousarray(to_host(words))
    counts_h = np.ascontiguousarray(to_host(counts))
    if metrics is not None:
        metrics.count("d2h_bytes_table", words_h.nbytes + counts_h.nbytes)
    return count_jax.count_keys(words_h, counts_h)


def _shard_filter_compact(mesh, axis, min_count: int):
    """Per-shard coverage filter + front-compaction (zero comms)."""
    from ..ops.count_jax import compact_front_sorted

    def local(words, counts):
        keep = counts >= min_count
        words2 = jnp.where(keep[:, None], words, SENTINEL)
        counts2 = jnp.where(keep, counts, 0)
        words2, counts2 = compact_front_sorted(keep, words2, counts2)
        return words2, counts2, jnp.sum(keep.astype(jnp.int32))[None]

    return jax.jit(shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis)),
        check_vma=False,
    ))


def _shard_hist(mesh, axis, cap: int = 1000):
    """Per-shard multiplicity histogram (sort + boundary search), summed
    across shards on the host — the auto-threshold input without pulling
    any count column off-device."""
    def local(counts):
        c = jnp.sort(jnp.minimum(counts, cap).astype(jnp.uint32))
        edges = jnp.arange(cap + 2, dtype=jnp.uint32)
        bounds = jnp.searchsorted(c, edges)
        return (bounds[1:] - bounds[:-1])[None].astype(jnp.int32)

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis, None),
        check_vma=False,
    ))


def save_sharded_table(words, counts, d: int, k: int, path: str) -> None:
    """Checkpoint the row-sharded (hash-owned) count table (.npz)."""
    from ..utils.jaxenv import to_host

    np.savez_compressed(
        path,
        words=to_host(words),
        counts=to_host(counts),
        d=np.asarray(d),
        k=np.asarray(k),
        layout=np.asarray("hash_shards"),
    )


def load_sharded_table(path: str, mesh: Mesh, axis, d: int, k: int):
    """Restore a sharded-table checkpoint onto the mesh (same D and k)."""
    with np.load(path) as z:
        if str(z["layout"]) != "hash_shards":
            raise ValueError(f"{path}: not a sharded-table checkpoint")
        if int(z["d"]) != d or int(z["k"]) != k:
            raise ValueError(
                f"{path}: checkpoint is for d={int(z['d'])}, k={int(z['k'])};"
                f" this run has d={d}, k={k}"
            )
        sharding = NamedSharding(mesh, P(axis, None))
        words = jax.device_put(z["words"], sharding)
        counts = jax.device_put(z["counts"], NamedSharding(mesh, P(axis)))
    return words, counts


def assemble_distributed_sharded(
    reads: np.ndarray,
    cfg: AssemblyConfig,
    mesh: Mesh | None = None,
    *,
    metrics=None,
    emit: str = "unitigs",
    bucket_cap: int | None = None,
    checkpoint: str | None = None,
    resume_from: str | None = None,
    return_graph: bool = False,
    minimizer_len: int | None = None,
    table_capacity: int | None = None,
    merge_stride: int | None = None,
    stream_checkpoint_every: int = 0,
) -> list[str]:
    """Fully sharded assembly: the graph never gathers onto one device.

    Counting, filtering, edge building, successor linking, pointer
    doubling, and unitig numbering all run shard-wise over the mesh
    (parallel.compress); per-device memory scales ~1/D. The host receives
    only fixed-size per-edge spell quads and the branchy residue. Requires
    odd k (device compression invariant, ops.unitig_jax).

    checkpoint/resume_from: the pre-filter hash-sharded count table as
    .npz (mesh size and k must match on resume). With
    stream_checkpoint_every=N > 0, the streaming counter also snapshots
    the table shards + batch cursor to ``checkpoint`` every N batches;
    resume_from detects a cursor-carrying snapshot and continues counting
    from it (VERDICT r2 item 7).
    """
    from ..host.simplify_arrays import simplify_arrays_to_graph
    from ..models.pipeline import auto_min_count
    from ..ops.count_jax import snug_capacity
    from ..utils.metrics import Metrics
    from .compress import (
        make_sharded_compress,
        spell_quads_arrays,
        spell_sharded_arrays,
    )
    from .mesh import axis_size, build_mesh, mesh_axes, num_hosts

    if cfg.k % 2 == 0:
        raise ValueError("sharded compression requires odd k")

    m = metrics or Metrics()
    mesh = mesh or build_mesh()
    axis = mesh_axes(mesh)
    d = axis_size(mesh, axis)
    m.count("reads", reads.shape[0])
    m.count("kmers", reads.shape[0] * (reads.shape[1] - cfg.k + 1))
    m.count("hosts", num_hosts(mesh))

    resume_stream = (
        resume_from is not None
        and is_sharded_stream_checkpoint(resume_from)
    )
    if resume_from is not None and not resume_stream:
        words, counts = load_sharded_table(
            resume_from, mesh, axis, d, cfg.k
        )
    else:
        with m.stage("count"):
            words, counts, num_unique = _run_distributed_step(
                reads, cfg, mesh, bucket_cap, axis, minimizer_len,
                table_capacity=table_capacity, merge_stride=merge_stride,
                metrics=m,
                stream_checkpoint=(
                    checkpoint if stream_checkpoint_every > 0 else None
                ),
                stream_checkpoint_every=stream_checkpoint_every,
                resume_stream_from=resume_from if resume_stream else None,
            )
            jax.block_until_ready(counts)
    if checkpoint is not None:
        save_sharded_table(words, counts, d, cfg.k, checkpoint)
    w = key_words(cfg.k)
    c_shard = words.shape[0] // d

    with m.stage("filter"):
        from ..utils.jaxenv import to_host

        min_count = cfg.min_count
        if min_count == 0:
            hist = to_host(_shard_hist(mesh, axis)(counts)).reshape(
                d, -1
            ).sum(axis=0)
            nz = np.nonzero(hist)[0]
            vals = np.repeat(nz, hist[nz])
            min_count = auto_min_count(vals)
        words, counts, kept = _shard_filter_compact(
            mesh, axis, min_count
        )(words, counts)
        # shrink every shard to one snug uniform capacity
        new_c = min(
            c_shard, snug_capacity(int(to_host(kept).max()))
        )
        if new_c < c_shard:
            words = words.reshape(d, c_shard, w)[:, :new_c].reshape(
                d * new_c, w
            )
            counts = counts.reshape(d, c_shard)[:, :new_c].reshape(-1)
            c_shard = new_c

    with m.stage("compress"):
        from .compress import comm_bytes_estimate

        est = comm_bytes_estimate(d, cfg.k, c_shard)
        m.count("a2a_bytes_compress_link", est["link"])
        m.count("a2a_bytes_compress_query_round", est["query_round"])
        m.count("a2a_compress_query_rounds_max", est["query_rounds_max"])
        m.count("a2a_bytes_spell", est["spell"])
        compress = make_sharded_compress(mesh, cfg.k, c_shard, axis)
        (
            valid, uid, pos, cov, last_base, heads,
            edge_words, num_unitigs, overflow,
        ) = compress(words, counts)
        jax.block_until_ready(num_unitigs)
        ovf_bits = int(np.asarray(to_host(overflow)).reshape(-1)[0])
        if ovf_bits:
            which = [
                name
                for bit, name in (
                    (1, "link-join"), (2, "link-pair"),
                    (4, "rank-query"), (8, "uid-query"),
                )
                if ovf_bits & bit
            ]
            raise RuntimeError(
                "sharded compression routing overflow in "
                f"{'+'.join(which)} (bits {ovf_bits}); increase the "
                "corresponding slack cap (parallel/compress.py)"
            )
    with m.stage("spell"):
        if os.environ.get("GA_SPELL_QUADS") == "1":
            # gathered-quads fallback (O(E) host pull; debug/comparison)
            ua = spell_quads_arrays(
                valid, uid, pos, cov, last_base, heads, edge_words,
                int(to_host(num_unitigs)[0]), cfg.k,
            )
        else:
            # range-sort spelling: the host pulls E/4 bytes of packed
            # bases + O(U) per-unitig rows (parallel.compress)
            ua = spell_sharded_arrays(
                mesh, cfg.k, c_shard, int(to_host(num_unitigs)[0]),
                valid, uid, pos, cov, heads, edge_words, axis,
            )
    with m.stage("simplify"):
        graph = simplify_arrays_to_graph(
            ua, cfg.resolved_tip_len, cfg.resolved_bubble_len, min_count
        )
    with m.stage("traverse"):
        contigs = _emit(graph, emit)
    if return_graph:
        return contigs, graph
    return contigs


def assemble_distributed(
    reads: np.ndarray,
    cfg: AssemblyConfig,
    mesh: Mesh | None = None,
    *,
    metrics=None,
    emit: str = "unitigs",
    checkpoint: str | None = None,
    resume_from: str | None = None,
    return_graph: bool = False,
    minimizer_len: int | None = None,
    table_capacity: int | None = None,
    merge_stride: int | None = None,
    stream_checkpoint_every: int = 0,
) -> list[str]:
    """End-to-end multi-device assembly: reads -> canonical contigs.

    Counting/filtering shards across the mesh (1-level, or a 2-level
    ('host','chip') mesh — collectives flatten over every mesh axis);
    the surviving genome-sized table compresses on a single device by
    pointer jumping, and only the branchy residue is stitched on host 0
    (SURVEY.md §7 M5 + north star). min_count=0 resolves automatically
    from the multiplicity histogram, exactly as on the single-device and
    oracle paths. Even k falls back to the host-dict graph.

    checkpoint/resume_from: stage-boundary .npz checkpoint of the merged
    counted table — the preemption-resume point for long runs (SURVEY.md §5
    checkpoint row; VERDICT r1 item 9). Odd-k path only.
    """
    from ..models.pipeline import auto_min_count, load_table, save_table
    from ..utils.metrics import Metrics
    from .mesh import build_mesh, num_hosts

    m = metrics or Metrics()
    mesh = mesh or build_mesh()
    m.count("reads", reads.shape[0])
    m.count("kmers", reads.shape[0] * (reads.shape[1] - cfg.k + 1))
    m.count("hosts", num_hosts(mesh))
    if cfg.k % 2 == 1:
        from ..host.dbg import spell_device_arrays
        from ..host.simplify_arrays import simplify_arrays_to_graph
        from ..ops.unitig_jax import compress_unitigs_device

        resume_stream = (
            resume_from is not None
            and is_sharded_stream_checkpoint(resume_from)
        )
        if resume_from is not None and not resume_stream:
            table = load_table(resume_from)
        else:
            with m.stage("count"):
                table = distributed_count_table(
                    reads, cfg, mesh, minimizer_len=minimizer_len,
                    table_capacity=table_capacity,
                    merge_stride=merge_stride, metrics=m,
                    stream_checkpoint=(
                        checkpoint if stream_checkpoint_every > 0 else None
                    ),
                    stream_checkpoint_every=stream_checkpoint_every,
                    resume_stream_from=(
                        resume_from if resume_stream else None
                    ),
                )
                jax.block_until_ready(table)
        if checkpoint is not None:
            save_table(table, checkpoint)
        min_count = cfg.min_count or auto_min_count(table)
        with m.stage("filter"):
            if not bool(table.overflow):
                table = count_jax.compact_table(table)
            table = count_jax.filter_table(table, min_count)
            table = count_jax.compact_table(table)
        with m.stage("compress"):
            dev = compress_unitigs_device(table, cfg.k)
            jax.block_until_ready(dev)
        with m.stage("spell"):
            ua = spell_device_arrays(dev, cfg.k)
        with m.stage("simplify"):
            graph = simplify_arrays_to_graph(
                ua, cfg.resolved_tip_len, cfg.resolved_bubble_len,
                min_count,
            )
        with m.stage("traverse"):
            contigs = _emit(graph, emit)
        return (contigs, graph) if return_graph else contigs
    with m.stage("count"):
        counts = distributed_count_to_host(
            reads, cfg, mesh, minimizer_len=minimizer_len,
            table_capacity=table_capacity, merge_stride=merge_stride,
            metrics=m,
        )
    min_count = cfg.min_count
    if min_count == 0:
        min_count = auto_min_count(
            np.fromiter(counts.values(), dtype=np.int64, count=len(counts))
        )
    with m.stage("filter"):
        kept = {km: c for km, c in counts.items() if c >= min_count}
    with m.stage("simplify"):
        graph = simplify_counts(
            kept, cfg.k, cfg.resolved_tip_len, cfg.resolved_bubble_len,
            min_count,
        )
    with m.stage("traverse"):
        contigs = _emit(graph, emit)
    return (contigs, graph) if return_graph else contigs


def _emit(graph, emit: str) -> list[str]:
    if emit == "euler":
        from ..host.traverse import emit_contigs_euler

        return emit_contigs_euler(graph)
    return emit_contigs(graph)
