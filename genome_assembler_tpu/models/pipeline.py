"""Single-device assembly pipeline (SURVEY.md §7 minimum slice -> M3).

Stage map vs the reference pipeline (SURVEY.md §3.1):
  extract_kmers + canonical  -> ops.kmer_jax (XLA-compiled)
  count + filter             -> ops.count_jax sort/segment-reduce in HBM
  graph/tips/bubbles/Euler   -> host modules shared with the oracle
so oracle-vs-device contig equality reduces to the counting stage, which is
bit-checked against ops.kmer_ref in tests.

Reads stream through the device in fixed-shape batches; counted batches
merge into a capacity-bounded running table (bounded HBM for CFG 2-3 scale
read sets). The multi-host version of this driver lives in
``parallel.pipeline``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..host.dbg import counts_to_dict
from ..host.simplify import simplify_counts
from ..host.traverse import emit_contigs
from ..ops import count_jax
from ..ops.kmer_jax import extract_canonical_flat
from ..utils.config import AssemblyConfig
from ..utils.dna import key_words

import os

# Above this many windows, fall back to batched streaming + table merges.
# Single-shot counts the whole read set in one extract+sort+count
# program; streaming bounds device memory by the table capacity plus one
# batch. Override via GA_SINGLE_SHOT_WINDOWS.
SINGLE_SHOT_WINDOWS = int(os.environ.get("GA_SINGLE_SHOT_WINDOWS", 1 << 27))

# Streaming merges switch to the hash-bucketed table (ops.bucketed) when
# the per-merge monolithic sort would exceed this many rows: past it,
# every merge sorts [nb, seg] bucket rows instead of one cap+batch
# column. Bit-identical either way; the value is a tuning constant
# (ROADMAP A7) and CFG-3's 24.6M-row merge stays below it.
# GA_BUCKETED=1/0 forces it on/off; "auto" (default) applies this bound.
BUCKETED_MIN_MERGE_ROWS = int(
    os.environ.get("GA_BUCKETED_MIN_MERGE_ROWS", 25 * (1 << 20))
)


def _extract_keys(reads, k, n_valid, read_len, inv_mask):
    """Shared extraction preamble of _count_batch and _stream_step: unpack
    2-bit codes and ambiguity bits, then extract canonical keys.

    read_len set means ``reads`` arrived 2-bit packed (utils.dna.pack_codes)
    — a 4x smaller host->device transfer, unpacked here in one
    elementwise pass.

    inv_mask ([B, ceil(L/8)] packed bits, utils.dna.pack_invalid_mask)
    flags ambiguous bases (Ns); windows touching one are masked to the
    sentinel, never counted. Ambiguity can't ride the 2-bit packing, hence
    the separate bits.
    """
    from ..ops.kmer_jax import unpack_codes, unpack_invalid_mask

    # one stable scope name: trace reductions attribute device time to
    # extraction by it (tools/measure_extract.py)
    with jax.named_scope("extract"):
        bad = None
        if inv_mask is not None:
            bad = unpack_invalid_mask(inv_mask, read_len or reads.shape[1])
        if read_len is not None:
            reads = unpack_codes(reads, read_len)
        keys, _ = extract_canonical_flat(reads, k, n_valid, bad)
    return keys


@functools.partial(
    jax.jit, static_argnames=("k", "out_cap", "read_len")
)
def _count_batch(
    reads, k, n_valid, out_cap=None, read_len=None, inv_mask=None,
):
    """One dispatch: extract + canonicalize + sort-count a read batch.

    One jit call per batch lets XLA fuse the extraction elementwise graph
    into the sort's input, and pays one dispatch per batch instead of one
    per stage.

    out_cap truncates the (compact-front) result table so streaming merges
    move table-capacity rows instead of window-count rows; truncation
    overflow is flagged, not silent. read_len/inv_mask: see _extract_keys.
    """
    keys = _extract_keys(reads, k, n_valid, read_len, inv_mask)
    table = count_jax.count_keys(keys)
    if out_cap is not None and out_cap < table.words.shape[0]:
        table = count_jax.CountTable(
            words=table.words[:out_cap],
            counts=table.counts[:out_cap],
            num_unique=jnp.minimum(table.num_unique, out_cap),
            overflow=table.overflow | (table.num_unique > out_cap),
        )
    elif out_cap is not None and out_cap > table.words.shape[0]:
        # pad to the exact streaming-table capacity: the first streamed
        # batch counts directly into the table (no empty-table merge —
        # that merge's two capacity-row sorts are pure sentinel work)
        from ..ops.kmer_jax import SENTINEL

        pad = out_cap - table.words.shape[0]
        table = count_jax.CountTable(
            words=jnp.concatenate(
                [
                    table.words,
                    jnp.full((pad, table.words.shape[1]), SENTINEL,
                             jnp.uint32),
                ],
                axis=0,
            ),
            counts=jnp.concatenate(
                [table.counts, jnp.zeros(pad, jnp.int32)]
            ),
            num_unique=table.num_unique,
            overflow=table.overflow,
        )
    return table


@jax.jit
def _merge_step(table, batch_table):
    return count_jax.merge_tables(table, batch_table)


@functools.partial(
    jax.jit,
    static_argnames=("k", "read_len"),
    donate_argnums=(0,),
)
def _extract_append(
    pending, reads, k, n_valid, slot, read_len=None, inv_mask=None,
):
    """Extraction-only streaming step: the batch's canonical key stream
    lands in slot ``slot`` of the carried pending buffer (donated, so the
    write is in place and XLA fuses extraction straight into it).

    Deferring the table merge until merge_stride batches are pending
    pays the two cap-row merge sorts 1/stride as often:
    rows(stride) = 2*(windows + (nb/stride)*cap) — see _merge_pending.
    """
    keys = _extract_keys(reads, k, n_valid, read_len, inv_mask)
    return jax.lax.dynamic_update_slice(
        pending, keys, (slot * keys.shape[0], jnp.int32(0))
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def _merge_pending(table, pending):
    """Weighted-merge a pending raw key stream into the running table
    (sentinel rows — invalid windows, read padding, an unfilled tail
    slice — are excluded by the segment reduce)."""
    return count_jax.merge_raw_keys(table, pending)


@functools.partial(
    jax.jit,
    static_argnames=("k", "read_len", "merge_raw", "out_cap"),
    donate_argnums=(0,),
)
def _stream_step(
    table, reads, k, n_valid, read_len=None, inv_mask=None, merge_raw=True,
    out_cap=None,
):
    """Fused streaming step: one dispatch counts a batch into the running
    table (donating the old table's buffers), in one of two formulations:

    merge_raw=True (default): the raw canonical key stream
    weighted-merges straight into the table (count_jax.merge_raw_keys) —
    one weighted sort + reduce over cap + batch_windows rows.
    merge_raw=False: sort-count the batch first, truncate to out_cap,
    then merge two counted tables — 2*batch + 4*cap reduced rows, kept
    as a tested fallback formulation.

    merge_raw sorts cap + batch_windows rows once; the fallback sorts
    the batch, then merges two tables, so merge_raw always touches fewer
    rows.
    """
    keys = _extract_keys(reads, k, n_valid, read_len, inv_mask)
    if merge_raw:
        return count_jax.merge_raw_keys(table, keys)
    batch = count_jax.count_keys(keys)
    if out_cap is not None and out_cap < batch.words.shape[0]:
        batch = count_jax.CountTable(
            words=batch.words[:out_cap],
            counts=batch.counts[:out_cap],
            num_unique=jnp.minimum(batch.num_unique, out_cap),
            overflow=batch.overflow | (batch.num_unique > out_cap),
        )
    return count_jax.merge_tables(table, batch)


@functools.partial(
    jax.jit,
    static_argnames=("k", "read_len", "m"),
    donate_argnums=(0,),
)
def _stream_step_bucketed(
    bt, reads, k, n_valid, read_len=None, inv_mask=None, *, m,
):
    """Fused bucketed streaming step: extract + route + batched merge in
    one dispatch (ops.bucketed.merge_raw_keys_bucketed). Same semantics
    as _stream_step with merge_raw=True; the running table keeps the
    hash-bucketed layout, so every bulk sort is a batched [nb, seg] sort
    whatever the table capacity."""
    from ..ops import bucketed

    keys = _extract_keys(reads, k, n_valid, read_len, inv_mask)
    return bucketed.merge_raw_keys_bucketed(bt, keys, m=m)


@functools.partial(
    jax.jit,
    static_argnames=("k", "read_len", "nb", "m"),
    donate_argnums=(0,),
)
def _route_append_step(
    staging, over, reads, k, n_valid, slot, read_len=None, inv_mask=None,
    *, nb, m,
):
    """Extraction-side bucket pre-packing step (one fused dispatch):
    extract + canonicalize the batch, route its keys by hash bucket
    (num_keys=1 bucket sort of just the batch rows), and land the packed
    [nb, m, W] segments in slot ``slot`` of the donated staging buffer.

    Deferring the batched table merge until GA_BUCKET_ACCUM slots are
    staged pays the two [nb, cb+S]-row batched sorts once per R batches
    instead of per batch — the cap-proportional term of the bucketed
    merge (cb*nb rows) shrinks by R. Bit-identical to per-batch merging: merge_packed aggregates
    weighted rows associatively and ignores SENTINEL rows, and each
    key's bucket never changes (VERDICT r4 item 1)."""
    from ..ops import bucketed

    keys = _extract_keys(reads, k, n_valid, read_len, inv_mask)
    packed, over_m = bucketed.route_pack_keys_impl(keys, nb=nb, m=m)
    staging = jax.lax.dynamic_update_slice(
        staging, packed, (jnp.int32(0), slot * m, jnp.int32(0))
    )
    return staging, over | over_m


@functools.partial(jax.jit, donate_argnums=(0,))
def _merge_staged(table, staged, extra_over):
    """Batched merge of pre-routed staged rows into the bucketed table
    (the merge half of the accumulated streaming step)."""
    from ..ops import bucketed

    return bucketed.merge_packed_bucketed_impl(table, staged, extra_over)


def save_stream_checkpoint(
    table: count_jax.CountTable, path: str, *, next_start: int,
    params: dict[str, int],
) -> None:
    """Mid-stream checkpoint: the carried table AND the batch cursor.

    SURVEY.md §5 failure/elastic + checkpoint rows (VERDICT r2 item 7): a
    preempted pod-scale counting run restarts from the last merge boundary
    instead of from zero. ``params`` pins everything byte-identity depends
    on (k, batch size, capacity, merge stride, total reads) — resume
    refuses a mismatched run rather than silently diverging.
    """
    np.savez_compressed(
        path,
        words=np.asarray(table.words),
        counts=np.asarray(table.counts),
        num_unique=np.asarray(table.num_unique),
        overflow=np.asarray(table.overflow),
        next_start=np.asarray(next_start),
        **{k: np.asarray(v) for k, v in params.items()},
    )


def is_stream_checkpoint(path: str) -> bool:
    """True if ``path`` is a mid-stream (cursor-carrying) checkpoint."""
    with np.load(path) as z:
        return "next_start" in z.files


def load_stream_checkpoint(path: str) -> tuple[count_jax.CountTable, int, dict]:
    with np.load(path) as z:
        table = count_jax.CountTable(
            words=z["words"],
            counts=z["counts"],
            num_unique=z["num_unique"],
            overflow=z["overflow"],
        )
        params = {
            k: int(z[k])
            for k in z.files
            if k not in ("words", "counts", "num_unique", "overflow",
                         "next_start")
        }
        return table, int(z["next_start"]), params


def stream_merge_rows(
    num_reads: int,
    read_len: int,
    cfg: AssemblyConfig,
    *,
    table_capacity: int | None = None,
    merge_stride: int | None = None,
) -> int:
    """Rows one streaming table merge of count_reads_device sorts: the
    table capacity plus the windows merged at once. The bucketed merge
    is auto-selected when this reaches BUCKETED_MIN_MERGE_ROWS."""
    wpr = read_len - cfg.k + 1
    capacity = table_capacity or min(num_reads * wpr, SINGLE_SHOT_WINDOWS)
    stride = merge_stride or int(os.environ.get("GA_MERGE_STRIDE", "1"))
    if -(-num_reads // cfg.batch_reads) < 2:
        stride = 1
    return capacity + stride * cfg.batch_reads * wpr


def count_reads_device(
    reads: np.ndarray,
    cfg: AssemblyConfig,
    *,
    table_capacity: int | None = None,
    merge_stride: int | None = None,
    stream_checkpoint: str | None = None,
    stream_checkpoint_every: int = 0,
    resume_stream_from: str | None = None,
) -> count_jax.CountTable:
    """Count canonical k-mers of [B, L] reads on the device.

    table_capacity: unique-k-mer capacity for the streaming table; defaults
    to the total window count (always sufficient, single-shot when small).

    merge_stride: streaming merge cadence — extraction appends this many
    batches of raw keys to a device pending buffer before each table
    merge (bit-identical for any value; GA_MERGE_STRIDE is the env
    fallback, default 1 = merge every batch).

    stream_checkpoint + stream_checkpoint_every=N: every N streamed
    batches (at merge boundaries — snapped up to the next one under a
    merge stride), snapshot the carried table and the batch cursor to
    ``stream_checkpoint``; ``resume_stream_from`` continues a killed run
    from that snapshot, byte-identically (same k/batch/capacity/stride
    required — enforced). The table pull costs one capacity-sized
    device->host read, so N trades recovery granularity against
    checkpoint overhead. GA_STREAM_ABORT_AFTER_BATCH=<n> is the fault
    -injection hook: the loop raises after n batches (tests kill/resume
    without killing the process).
    """
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    b, length = reads.shape
    wpr = length - cfg.k + 1
    total_windows = b * wpr

    from ..utils.dna import has_ambiguous, pack_codes, pack_invalid_mask

    has_invalid = has_ambiguous(reads)
    if table_capacity is None and total_windows <= SINGLE_SHOT_WINDOWS:
        if resume_stream_from is not None:
            raise ValueError(
                "resume_stream_from requires the streaming path; pass the "
                "table_capacity the checkpointed run used"
            )
        return _count_batch(
            pack_codes(reads), cfg.k, np.int32(b), read_len=length,
            inv_mask=pack_invalid_mask(reads) if has_invalid else None,
        )

    # Bounded default: unique k-mers are genome-sized, far below the window
    # count; SINGLE_SHOT_WINDOWS rows comfortably hold any genome this
    # single-device path targets, and the overflow flag turns a too-small
    # table into an actionable error instead of silent truncation.
    capacity = table_capacity or min(total_windows, SINGLE_SHOT_WINDOWS)
    batch = cfg.batch_reads
    padded = -(-reads.shape[0] // batch) * batch

    def host_prep(start):
        # pad only the final short batch — padding the whole read array
        # would re-allocate it (hundreds of MB at bacterial scale)
        rows = reads[start : start + batch]
        if rows.shape[0] < batch:
            rows = np.concatenate(
                [rows,
                 np.zeros((batch - rows.shape[0], length), dtype=np.uint8)],
                axis=0,
            )
        chunk = pack_codes(rows)
        if not has_invalid:
            bm = None
        else:
            # Ns anywhere in the read set: every batch carries mask bits
            # (zeros when locally clean) so the jit signature, and with it
            # the compiled program, stays constant.
            bm = pack_invalid_mask(rows)
            if bm is None:
                bm = np.zeros((rows.shape[0], (length + 7) // 8), np.uint8)
        return chunk, bm

    def upload(start):
        # async device_put: the copy for batch i+1 rides under batch i's
        # compute
        chunk, bm = host_prep(start)
        return (
            jax.device_put(chunk),
            None if bm is None else jax.device_put(bm),
        )

    starts = list(range(0, padded, batch))
    stride = merge_stride or int(os.environ.get("GA_MERGE_STRIDE", "1"))
    strided = stride > 1 and len(starts) > 1
    bw = batch * (length - cfg.k + 1)
    merge_windows = (stride if strided else 1) * bw
    env_bucketed = os.environ.get("GA_BUCKETED", "auto")
    if env_bucketed == "auto":
        use_bucketed = stream_merge_rows(
            b, length, cfg, table_capacity=capacity, merge_stride=stride
        ) >= BUCKETED_MIN_MERGE_ROWS
    else:
        use_bucketed = env_bucketed == "1"
    w = key_words(cfg.k)

    accum = 1
    if use_bucketed:
        from ..ops import bucketed as bucketed_mod

        # Accumulated staging (extraction-side pre-packing, VERDICT
        # r4 item 1): per batch only route+pack (cheap, batch-row
        # sized); merge the staged [nb, accum*m] rows every accum
        # batches, so the cb-row table re-sort is paid 1/accum as
        # often. accum=1 restores the per-batch merge. Incompatible
        # with the flat-path merge_stride (both defer merges —
        # stride takes precedence when explicitly set).
        if not strided:
            accum = max(1, int(os.environ.get("GA_BUCKET_ACCUM", "4")))
        cb_slack = float(os.environ.get("GA_BUCKET_SLACK", "1.25"))
        m_slack = float(os.environ.get("GA_BUCKET_BATCH_SLACK", "1.5"))
        env_nb = os.environ.get("GA_BUCKETS")
        nb = (
            int(env_nb) if env_nb
            else bucketed_mod.auto_buckets(
                capacity, merge_windows, accum, cb_slack, m_slack
            )
        )
        cb, m_seg = bucketed_mod.bucket_geometry(
            capacity,
            merge_windows,
            nb=nb,
            cb_slack=cb_slack,
            m_slack=m_slack,
        )
        table = bucketed_mod.empty_bucketed(nb, cb, w)
    else:
        table = count_jax.empty_table(capacity, w)
    # everything byte-identity depends on, pinned into mid-stream ckpts
    ck_params = {
        "k": cfg.k,
        "batch": batch,
        "capacity": capacity,
        "stride": stride if strided else 1,
        "total_reads": b,
        "bucketed": int(use_bucketed),
    }
    if use_bucketed:
        ck_params.update(
            {"nb": nb, "cb": cb, "m": m_seg, "accum": accum}
        )
    start_idx = 0
    if resume_stream_from is not None:
        ck_table, next_start, got = load_stream_checkpoint(resume_stream_from)
        if got != ck_params:
            raise ValueError(
                f"mid-stream checkpoint mismatch: saved {got}, this run "
                f"has {ck_params} — resume requires identical k/batch/"
                "capacity/stride/read-set"
            )
        if use_bucketed:
            table = bucketed_mod.BucketedTable(
                words=jnp.asarray(ck_table.words),
                counts=jnp.asarray(ck_table.counts),
                num_unique=jnp.asarray(ck_table.num_unique),
                overflow=jnp.asarray(ck_table.overflow),
            )
        else:
            table = count_jax.CountTable(
                words=jnp.asarray(ck_table.words),
                counts=jnp.asarray(ck_table.counts),
                num_unique=jnp.asarray(ck_table.num_unique),
                overflow=jnp.asarray(ck_table.overflow),
            )
        start_idx = next_start // batch
    abort_after = int(os.environ.get("GA_STREAM_ABORT_AFTER_BATCH", "0"))
    since_ckpt = 0
    if strided:
        # Deferred merges: extraction appends raw keys to a device pending
        # buffer; the two cap-row merge sorts run once per ``stride``
        # batches. Bit-identical to stride=1 (merge_raw_keys is
        # associative over key streams and ignores sentinel rows; tested).
        # The tail flush slices the filled prefix, so stale keys from a
        # previous merge round are never re-merged.
        from ..ops.kmer_jax import SENTINEL

        pending_buf = jnp.full(
            (stride * bw, w), SENTINEL, dtype=jnp.uint32
        )
        slot = 0
    elif accum > 1:
        from ..ops.kmer_jax import SENTINEL

        # staged pre-packed buffer: slot r of the second axis holds
        # batch r's routed [nb, m_seg] segments; every slot is
        # overwritten before its next merge, so no clearing pass
        staging_buf = jnp.full(
            (nb, accum * m_seg, w), SENTINEL, dtype=jnp.uint32
        )
        pending_over = jnp.asarray(False)
        slot = 0
    # upload prefetch depth: batch i's DMA rides under batch i-1's (and
    # i-2's) compute; depth 2 also hides the host-side pack_codes of the
    # next batch behind the queued device work (GA_UPLOAD_PREFETCH=1
    # restores the r2 single-buffer behavior)
    prefetch = max(1, int(os.environ.get("GA_UPLOAD_PREFETCH", "2")))
    uploads: dict[int, tuple] = {}

    def ensure_uploaded(j):
        if j < len(starts) and j not in uploads:
            uploads[j] = upload(starts[j])

    for j in range(start_idx, min(start_idx + prefetch, len(starts))):
        ensure_uploaded(j)
    for i in range(start_idx, len(starts)):
        start = starts[i]
        chunk_dev, bm_dev = uploads.pop(i)
        ensure_uploaded(i + prefetch)
        if i + 1 < len(starts):
            ensure_uploaded(i + 1)
        n_valid = np.int32(min(max(b - start, 0), batch))
        if strided:
            pending_buf = _extract_append(
                pending_buf, chunk_dev, cfg.k, n_valid, np.int32(slot),
                read_len=length, inv_mask=bm_dev,
            )
            slot += 1
            if slot == stride:
                if use_bucketed:
                    table = bucketed_mod.merge_raw_keys_bucketed(
                        table, pending_buf, m=m_seg
                    )
                else:
                    table = _merge_pending(table, pending_buf)
                slot = 0
        elif accum > 1:
            staging_buf, pending_over = _route_append_step(
                staging_buf, pending_over, chunk_dev, cfg.k, n_valid,
                jnp.int32(slot), read_len=length,
                inv_mask=bm_dev, nb=nb, m=m_seg,
            )
            slot += 1
            if slot == accum:
                table = _merge_staged(table, staging_buf, pending_over)
                pending_over = jnp.asarray(False)
                slot = 0
        elif use_bucketed:
            table = _stream_step_bucketed(
                table, chunk_dev, cfg.k, n_valid,
                read_len=length, inv_mask=bm_dev, m=m_seg,
            )
        elif i == start_idx and resume_stream_from is None:
            # batch-1 fast path: the first batch counts straight into a
            # fresh table (padded to capacity) — merging into an all-
            # sentinel table would pay two capacity-row sorts for
            # nothing (bit-identical; merge_raw_keys of an empty table
            # IS count + truncate)
            table = _count_batch(
                chunk_dev, cfg.k, n_valid, out_cap=capacity, read_len=length, inv_mask=bm_dev,
            )
        else:
            table = _stream_step(
                table, chunk_dev, cfg.k, n_valid,
                read_len=length, inv_mask=bm_dev,
                merge_raw=True,
                out_cap=capacity,
            )
        since_ckpt += 1
        at_merge_boundary = (
            slot == 0 if (strided or accum > 1) else True
        )
        if (
            stream_checkpoint is not None
            and stream_checkpoint_every > 0
            and since_ckpt >= stream_checkpoint_every
            and at_merge_boundary
            and i + 1 < len(starts)
        ):
            save_stream_checkpoint(
                table, stream_checkpoint,
                next_start=starts[i + 1], params=ck_params,
            )
            since_ckpt = 0
        if abort_after and (i + 1 - start_idx) >= abort_after:
            raise RuntimeError(
                f"fault injection: GA_STREAM_ABORT_AFTER_BATCH="
                f"{abort_after} reached at batch {i + 1}/{len(starts)}"
            )
    if strided and slot:
        if use_bucketed:
            table = bucketed_mod.merge_raw_keys_bucketed(
                table, pending_buf[: slot * bw], m=m_seg
            )
        else:
            table = _merge_pending(table, pending_buf[: slot * bw])
    elif accum > 1 and slot:
        # tail flush: only the filled slots (a static slice — one
        # extra compile per distinct tail length, same as strided)
        table = _merge_staged(
            table, staging_buf[:, : slot * m_seg], pending_over
        )
    if use_bucketed:
        table = bucketed_mod.flatten_bucketed(table, capacity=capacity)
    return table


def table_to_host_counts(
    table: count_jax.CountTable, k: int
) -> dict[str, int]:
    """Pull the device table to the host as {canonical k-mer: count}."""
    if bool(table.overflow):
        raise RuntimeError(
            "k-mer table overflow: unique k-mers exceeded table capacity; "
            "rerun with a larger table_capacity (under the bucketed "
            "streaming merge, extreme per-key multiplicity skew can also "
            "overflow one hash bucket — GA_BUCKETED=0 or a larger "
            "GA_BUCKET_SLACK / GA_BUCKET_BATCH_SLACK)"
        )
    num = int(table.num_unique)
    words = np.asarray(table.words)[:num]
    counts = np.asarray(table.counts)[:num]
    return counts_to_dict(words, counts, k)


def auto_min_count(table_or_counts) -> int:
    """Pick the coverage-filter threshold from the multiplicity histogram.

    Sequencing errors put a spike of unique/low-multiplicity k-mers near 1;
    true genomic k-mers cluster around the effective coverage. The standard
    heuristic: threshold at the histogram valley between the error peak and
    the coverage peak. Falls back to 1 (keep everything) when the histogram
    is monotonic (error-free data has no valley).

    Accepts a CountTable or a plain array of multiplicities (the oracle
    passes its dict values so both paths pick identical thresholds). For
    a CountTable the histogram is computed on device
    (ops.count_jax.multiplicity_histogram) so only ~4 KB crosses to the
    host instead of the whole counts column.
    """
    if isinstance(table_or_counts, count_jax.CountTable):
        table = table_or_counts
        if int(table.num_unique) == 0:
            return 1
        full = np.asarray(count_jax.multiplicity_histogram(table))
        nz = np.nonzero(full)[0]
        if nz.size == 0:
            return 1
        # trim trailing zero bins so the length-sensitive heuristic below
        # sees exactly what np.bincount of the pulled counts produced
        hist = full[: int(nz[-1]) + 1]
    else:
        counts = np.asarray(table_or_counts)
        if counts.size == 0:
            return 1
        hist = np.bincount(np.minimum(counts, 1000))
    if len(hist) < 4:
        return 1
    # coverage peak: the strongest bin past multiplicity 2
    peak = int(np.argmax(hist[3:])) + 3 if len(hist) > 3 else 0
    if peak <= 2 or hist[peak] < 4:
        return 1
    valley = int(np.argmin(hist[1:peak])) + 1
    if hist[valley] >= hist[peak]:
        return 1
    return valley + 1  # drop everything at or below the valley bin


def save_table(table: count_jax.CountTable, path: str) -> None:
    """Stage-boundary checkpoint (SURVEY.md §5): the merged canonical k-mer
    table as .npz — the pipeline is restartable from here, skipping
    extraction/counting entirely."""
    np.savez_compressed(
        path,
        words=np.asarray(table.words),
        counts=np.asarray(table.counts),
        num_unique=np.asarray(table.num_unique),
        overflow=np.asarray(table.overflow),
    )


def load_table(path: str) -> count_jax.CountTable:
    with np.load(path) as z:
        return count_jax.CountTable(
            words=z["words"],
            counts=z["counts"],
            num_unique=z["num_unique"],
            overflow=z["overflow"],
        )


def assemble_tpu(
    reads: np.ndarray,
    cfg: AssemblyConfig,
    *,
    table_capacity: int | None = None,
    device_unitigs: bool = True,
    metrics: "Metrics | None" = None,
    checkpoint: str | None = None,
    resume_from: str | None = None,
    return_graph: bool = False,
    emit: str = "unitigs",
    merge_stride: int | None = None,
    stream_checkpoint_every: int = 0,
) -> list[str] | tuple[list[str], "object"]:
    """End-to-end single-device assembly: reads -> canonical contigs.

    device_unitigs=True (default): compress non-branching chains on device
    by pointer jumping (ops.unitig_jax) and spell them vectorized on host —
    the host never touches a per-k-mer dict. False falls back to the
    dict-based host graph (debug/oracle-equivalence path). Device
    compression requires odd k.

    checkpoint/resume_from: stage-boundary .npz checkpoint of the counted
    k-mer table (SURVEY.md §5 checkpoint/resume). With
    stream_checkpoint_every=N > 0, the streaming counter also snapshots
    the carried table + batch cursor to ``checkpoint`` every N batches
    (mid-stream checkpointing, VERDICT r2 item 7); resume_from detects a
    cursor-carrying snapshot and continues counting from it instead of
    skipping the stage.

    emit: "unitigs" (default) stops contigs at branching junctions;
    "euler" spells them from Eulerian walks (reference-parity mode,
    host/traverse.emit_contigs_euler_with_cov).
    """
    from ..utils.metrics import Metrics

    m = metrics or Metrics()
    wc = reads.shape[1] - cfg.k + 1
    m.count("reads", reads.shape[0])
    m.count("kmers", reads.shape[0] * wc)
    from ..utils.dna import has_ambiguous

    if has_ambiguous(reads):
        from ..ops.kmer_ref import window_valid_np

        m.count(
            "masked_windows",
            int((~window_valid_np(reads, cfg.k)).sum()),
        )
    resume_stream = (
        resume_from is not None and is_stream_checkpoint(resume_from)
    )
    if resume_from is not None and not resume_stream:
        table = load_table(resume_from)
    else:
        with m.stage("count"):
            table = count_reads_device(
                reads,
                cfg,
                table_capacity=table_capacity,
                merge_stride=merge_stride,
                stream_checkpoint=(
                    checkpoint if stream_checkpoint_every > 0 else None
                ),
                stream_checkpoint_every=stream_checkpoint_every,
                resume_stream_from=resume_from if resume_stream else None,
            )
            jax.block_until_ready(table)
        m.count(
            "count_bytes",
            reads.size + 2 * reads.shape[0] * wc * table.words.shape[1] * 4,
        )
    if checkpoint is not None:
        save_table(table, checkpoint)
    min_count = cfg.min_count or auto_min_count(table)
    with m.stage("filter"):
        # compact first: unique k-mers are genome-sized, the counting
        # capacity is read-stream-sized; every pass below scales with it
        if not bool(table.overflow):
            table = count_jax.compact_table(table)
        table = count_jax.filter_table(table, min_count)
        table = count_jax.compact_table(table)
    if device_unitigs and cfg.k % 2 == 1:
        from ..host.dbg import spell_device_arrays
        from ..host.simplify_arrays import simplify_arrays_to_graph
        from ..ops.unitig_jax import compress_unitigs_device

        if bool(table.overflow):
            raise RuntimeError(
                "k-mer table overflow: rerun with a larger table_capacity "
                "(or GA_BUCKETED=0 / larger GA_BUCKET_SLACK if the "
                "bucketed streaming merge was active)"
            )
        with m.stage("compress"):
            dev = compress_unitigs_device(table, cfg.k)
            jax.block_until_ready(dev)
        with m.stage("spell"):
            ua = spell_device_arrays(dev, cfg.k)
        with m.stage("simplify"):
            # array-native path (host.simplify_arrays): vectorized NumPy
            # over packed codes, property-tested equal to the normative
            # host.simplify rules; strings materialize only here, for the
            # final simplified graph
            graph = simplify_arrays_to_graph(
                ua, cfg.resolved_tip_len,
                cfg.resolved_bubble_len, min_count,
            )
    else:
        with m.stage("host_graph"):
            counts = table_to_host_counts(table, cfg.k)
            graph = simplify_counts(
                counts, cfg.k, cfg.resolved_tip_len,
                cfg.resolved_bubble_len, min_count,
            )
    with m.stage("traverse"):
        if emit == "euler":
            from ..host.traverse import emit_contigs_euler

            contigs = emit_contigs_euler(graph)
        else:
            contigs = emit_contigs(graph)
    if return_graph:
        return contigs, graph
    return contigs
