"""Hash-bucketed streaming merge == flat streaming merge, bit for bit.

The bucketed table (ops.bucketed) is a pure layout change of the
running count table: for any batch stream, flatten_bucketed of the
bucketed stream must reproduce the flat path's CountTable exactly —
words, counts, num_unique — including sentinel routing, multi-word
keys, multiplicity skew, and resume-from-checkpoint.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from genome_assembler_tpu.ops import bucketed, count_jax
from genome_assembler_tpu.ops.kmer_jax import SENTINEL


def _keys_from_ints(vals, w):
    """Small ints -> [N, w] uint32 key rows (None -> sentinel row)."""
    out = np.zeros((len(vals), w), dtype=np.uint32)
    for i, v in enumerate(vals):
        if v is None:
            out[i] = 0xFFFFFFFF
        else:
            for j in range(w):
                out[i, w - 1 - j] = (v >> (32 * j)) & 0xFFFFFFFF
    return out


def _flat_stream(batches, cap, w):
    table = count_jax.empty_table(cap, w)
    for b in batches:
        table = count_jax.merge_raw_keys(table, b)
    return table


def _bucketed_stream(batches, cap, w, nb, cb, m):
    bt = bucketed.empty_bucketed(nb, cb, w)
    for b in batches:
        bt = bucketed.merge_raw_keys_bucketed(bt, b, m=m)
    return bucketed.flatten_bucketed(bt, capacity=cap)


def _assert_tables_equal(flat, bkt):
    assert bool(flat.overflow) == bool(bkt.overflow)
    if bool(flat.overflow):
        return
    assert int(flat.num_unique) == int(bkt.num_unique)
    np.testing.assert_array_equal(
        np.asarray(flat.words), np.asarray(bkt.words)
    )
    np.testing.assert_array_equal(
        np.asarray(flat.counts), np.asarray(bkt.counts)
    )


@settings(deadline=None, max_examples=25)
@given(
    st.integers(0, 2**32 - 1),
    st.sampled_from([1, 2, 3]),
    st.integers(1, 4),
)
def test_bucketed_equals_flat_hypothesis(seed, w, nbatches):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(nbatches):
        n = int(rng.integers(1, 200))
        vals = rng.integers(0, 50, size=n).astype(object)
        # sprinkle sentinels (invalid windows)
        for i in range(n):
            if rng.random() < 0.15:
                vals[i] = None
        batches.append(_keys_from_ints(list(vals), w))
    cap = 256
    flat = _flat_stream(batches, cap, w)
    bkt = _bucketed_stream(batches, cap, w, nb=8, cb=64, m=256)
    _assert_tables_equal(flat, bkt)


def test_bucketed_multiword_large_values():
    rng = np.random.default_rng(0)
    w = 2
    batches = [
        np.ascontiguousarray(
            rng.integers(0, 2**32 - 1, size=(500, w), dtype=np.uint64)
        ).astype(np.uint32)
        for _ in range(3)
    ]
    cap = 2048
    flat = _flat_stream(batches, cap, w)
    bkt = _bucketed_stream(batches, cap, w, nb=16, cb=256, m=512)
    _assert_tables_equal(flat, bkt)


def test_bucketed_all_sentinel_batch():
    w = 2
    batches = [
        _keys_from_ints([None] * 32, w),
        _keys_from_ints([1, 2, 3, 1, None, 2], w),
    ]
    flat = _flat_stream(batches, 64, w)
    bkt = _bucketed_stream(batches, 64, w, nb=4, cb=32, m=64)
    _assert_tables_equal(flat, bkt)
    assert int(bkt.num_unique) == 3


def test_bucket_segment_overflow_is_flagged():
    # one hot key repeated far past m lands in a single bucket
    w = 1
    batch = _keys_from_ints([7] * 100 + [1, 2, 3], w)
    bt = bucketed.empty_bucketed(4, 64, w)
    bt = bucketed.merge_raw_keys_bucketed(bt, batch, m=16)
    assert bool(bt.overflow)


def test_bucket_capacity_overflow_is_flagged():
    w = 1
    batch = _keys_from_ints(list(range(200)), w)
    bt = bucketed.empty_bucketed(2, 16, w)  # 32 slots for ~200 uniques
    bt = bucketed.merge_raw_keys_bucketed(bt, batch, m=256)
    assert bool(bt.overflow)


def test_bucketize_roundtrip():
    rng = np.random.default_rng(3)
    w = 2
    keys = np.ascontiguousarray(
        rng.integers(0, 1000, size=(300, w), dtype=np.uint64)
    ).astype(np.uint32)
    flat = count_jax.count_keys(keys)
    bt = bucketed.bucketize(flat, nb=8, cb=128)
    assert not bool(bt.overflow)
    back = bucketed.flatten_bucketed(bt, capacity=flat.words.shape[0])
    _assert_tables_equal(flat, back)
    # merging after bucketize keeps aggregating correctly
    more = keys[:50]
    bt2 = bucketed.merge_raw_keys_bucketed(bt, more, m=64)
    flat2 = count_jax.merge_raw_keys(flat, more)
    back2 = bucketed.flatten_bucketed(bt2, capacity=flat2.words.shape[0])
    _assert_tables_equal(flat2, back2)


def test_flatten_pads_when_capacity_exceeds_slots():
    w = 1
    batch = _keys_from_ints([1, 2, 3], w)
    bt = bucketed.empty_bucketed(2, 8, w)
    bt = bucketed.merge_raw_keys_bucketed(bt, batch, m=8)
    flat = bucketed.flatten_bucketed(bt, capacity=64)
    assert flat.words.shape == (64, w)
    assert int(flat.num_unique) == 3
    assert (np.asarray(flat.words)[3:] == 0xFFFFFFFF).all()


def test_bucket_geometry_alignment():
    cb, m = bucketed.bucket_geometry(
        7_340_032, 18_350_000, nb=256, cb_slack=1.25, m_slack=1.5
    )
    assert cb % 128 == 0 and m % 128 == 0
    assert cb * 256 >= 7_340_032 * 1.25 - 256 * 128
    assert m * 256 >= 18_350_000 * 1.5 - 256 * 128


def test_sentinel_rows_never_packed():
    w = 1
    batch = _keys_from_ints([None, 5, None, 5, 9], w)
    bt = bucketed.empty_bucketed(4, 8, w)
    bt = bucketed.merge_raw_keys_bucketed(bt, batch, m=8)
    assert int(bt.num_unique.sum()) == 2
    flat = bucketed.flatten_bucketed(bt, capacity=16)
    got = {
        int(np.asarray(flat.words)[i, 0]): int(np.asarray(flat.counts)[i])
        for i in range(2)
    }
    assert got == {5: 2, 9: 1}


# ---- pipeline integration (GA_BUCKETED forced on small workloads) ----

from genome_assembler_tpu.models.pipeline import (  # noqa: E402
    assemble_tpu,
    count_reads_device,
    is_stream_checkpoint,
)
from genome_assembler_tpu.utils.config import AssemblyConfig  # noqa: E402
from genome_assembler_tpu.utils.simulate import (  # noqa: E402
    simulate_genome,
    simulate_reads,
)


def _reads(genome_len=2000, coverage=12, read_len=60, seed=91):
    genome = simulate_genome(genome_len, seed=seed)
    rs = simulate_reads(
        genome, coverage=coverage, read_len=read_len, seed=seed + 1
    )
    return rs.codes, genome


def _count_both(reads, cfg, cap, monkeypatch, **kw):
    monkeypatch.setenv("GA_BUCKETED", "0")
    flat = count_reads_device(reads, cfg, table_capacity=cap, **kw)
    monkeypatch.setenv("GA_BUCKETED", "1")
    monkeypatch.setenv("GA_BUCKETS", "8")
    bkt = count_reads_device(reads, cfg, table_capacity=cap, **kw)
    monkeypatch.setenv("GA_BUCKETED", "auto")
    return flat, bkt


@pytest.mark.parametrize("stride", [1, 2])
def test_pipeline_bucketed_equals_flat(monkeypatch, stride):
    reads, _ = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    flat, bkt = _count_both(
        reads, cfg, 8192, monkeypatch, merge_stride=stride
    )
    assert int(flat.num_unique) == int(bkt.num_unique)
    np.testing.assert_array_equal(
        np.asarray(flat.words), np.asarray(bkt.words)
    )
    np.testing.assert_array_equal(
        np.asarray(flat.counts), np.asarray(bkt.counts)
    )
    assert bool(flat.overflow) == bool(bkt.overflow)


@pytest.mark.parametrize("accum", [1, 2, 4, 5])
def test_pipeline_bucketed_accum_equals_flat(monkeypatch, accum):
    """The accumulated staged merge (GA_BUCKET_ACCUM, extraction-side
    pre-packing) is bit-identical to the flat path for every cadence,
    including tail flushes of 1..accum-1 staged slots (7 batches here:
    accum=4 leaves a 3-slot tail, accum=5 a 2-slot tail)."""
    reads, _ = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    monkeypatch.setenv("GA_BUCKET_ACCUM", str(accum))
    flat, bkt = _count_both(reads, cfg, 8192, monkeypatch)
    assert int(flat.num_unique) == int(bkt.num_unique)
    np.testing.assert_array_equal(
        np.asarray(flat.words), np.asarray(bkt.words)
    )
    np.testing.assert_array_equal(
        np.asarray(flat.counts), np.asarray(bkt.counts)
    )
    assert bool(flat.overflow) == bool(bkt.overflow)


def test_pipeline_bucketed_with_n_bases(monkeypatch):
    reads, _ = _reads()
    reads = reads.copy()
    rng = np.random.default_rng(5)
    mask = rng.random(reads.shape) < 0.01
    reads[mask] = 4  # ambiguous base code
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    flat, bkt = _count_both(reads, cfg, 8192, monkeypatch)
    assert int(flat.num_unique) == int(bkt.num_unique)
    np.testing.assert_array_equal(
        np.asarray(flat.words), np.asarray(bkt.words)
    )


def test_pipeline_bucketed_assembles_genome(monkeypatch):
    reads, genome = _reads(genome_len=3000, coverage=15)
    cfg = AssemblyConfig(k=21, read_len=60, batch_reads=64)
    monkeypatch.setenv("GA_BUCKETED", "1")
    monkeypatch.setenv("GA_BUCKETS", "8")
    contigs = assemble_tpu(reads, cfg, table_capacity=8192)
    monkeypatch.setenv("GA_BUCKETED", "auto")
    from genome_assembler_tpu.host.traverse import contigs_equal
    from genome_assembler_tpu.utils.dna import decode_seq

    assert contigs_equal(contigs, [decode_seq(genome)])


def test_bucketed_kill_and_resume(tmp_path, monkeypatch):
    # accum=2: merge boundaries (the only legal checkpoint points) fall
    # after every 2nd batch, so the every-2-batches checkpoint below is
    # written before the batch-3 abort
    monkeypatch.setenv("GA_BUCKET_ACCUM", "2")
    reads, _ = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    cap = 8192
    monkeypatch.setenv("GA_BUCKETED", "1")
    monkeypatch.setenv("GA_BUCKETS", "8")
    full = count_reads_device(reads, cfg, table_capacity=cap)

    ck = str(tmp_path / "mid_bucketed.npz")
    monkeypatch.setenv("GA_STREAM_ABORT_AFTER_BATCH", "3")
    with pytest.raises(RuntimeError, match="fault injection"):
        count_reads_device(
            reads, cfg, table_capacity=cap,
            stream_checkpoint=ck, stream_checkpoint_every=2,
        )
    monkeypatch.delenv("GA_STREAM_ABORT_AFTER_BATCH")
    assert is_stream_checkpoint(ck)
    resumed = count_reads_device(
        reads, cfg, table_capacity=cap, resume_stream_from=ck
    )
    monkeypatch.setenv("GA_BUCKETED", "auto")
    assert int(full.num_unique) == int(resumed.num_unique)
    np.testing.assert_array_equal(
        np.asarray(full.words), np.asarray(resumed.words)
    )
    np.testing.assert_array_equal(
        np.asarray(full.counts), np.asarray(resumed.counts)
    )


def test_bucketed_resume_rejects_flat_checkpoint(tmp_path, monkeypatch):
    reads, _ = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    cap = 8192
    ck = str(tmp_path / "mid_flat.npz")
    monkeypatch.setenv("GA_BUCKETED", "0")
    monkeypatch.setenv("GA_STREAM_ABORT_AFTER_BATCH", "3")
    with pytest.raises(RuntimeError, match="fault injection"):
        count_reads_device(
            reads, cfg, table_capacity=cap,
            stream_checkpoint=ck, stream_checkpoint_every=2,
        )
    monkeypatch.delenv("GA_STREAM_ABORT_AFTER_BATCH")
    monkeypatch.setenv("GA_BUCKETED", "1")
    monkeypatch.setenv("GA_BUCKETS", "8")
    with pytest.raises(ValueError, match="mismatch"):
        count_reads_device(
            reads, cfg, table_capacity=cap, resume_stream_from=ck
        )
    monkeypatch.setenv("GA_BUCKETED", "auto")


def _boom(*a, **k):
    import jax

    raise jax.errors.JaxRuntimeError(
        "INTERNAL: simulated backend failure"
    )


@pytest.mark.parametrize("stride", [1, 2])
def test_bucketed_auto_backend_error_propagates(monkeypatch, stride):
    """An AUTO-selected bucketed merge that fails at compile/run time
    raises: no retry with the flat merge hides it as a slow pass."""
    import jax

    from genome_assembler_tpu.models import pipeline

    reads, _ = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    monkeypatch.setenv("GA_BUCKETED", "auto")
    monkeypatch.setattr(pipeline, "BUCKETED_MIN_MERGE_ROWS", 1)
    # All bucketed entry points: the jitted fused steps resolve at the
    # pipeline module level (per-batch, accum route/merge), the
    # strided/tail merges at the ops module.
    monkeypatch.setattr(pipeline, "_stream_step_bucketed", _boom)
    monkeypatch.setattr(pipeline, "_route_append_step", _boom)
    monkeypatch.setattr(pipeline, "_merge_staged", _boom)
    monkeypatch.setattr(bucketed, "merge_raw_keys_bucketed", _boom)
    with pytest.raises(jax.errors.JaxRuntimeError):
        count_reads_device(
            reads, cfg, table_capacity=8192, merge_stride=stride
        )


def test_bucketed_explicit_backend_error_propagates(monkeypatch):
    """GA_BUCKETED=1 is an explicit user choice — no silent fallback."""
    import jax
    import pytest as _pytest

    from genome_assembler_tpu.models import pipeline

    reads, _ = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    monkeypatch.setenv("GA_BUCKETED", "1")
    monkeypatch.setenv("GA_BUCKETS", "8")
    monkeypatch.setattr(pipeline, "_stream_step_bucketed", _boom)
    monkeypatch.setattr(pipeline, "_route_append_step", _boom)
    monkeypatch.setattr(pipeline, "_merge_staged", _boom)
    monkeypatch.setattr(bucketed, "merge_raw_keys_bucketed", _boom)
    with _pytest.raises(jax.errors.JaxRuntimeError):
        count_reads_device(reads, cfg, table_capacity=8192)


def test_auto_buckets_rule():
    """nb lands per-merge bucket rows near BUCKET_TARGET_SEG, clamped."""
    from genome_assembler_tpu.ops.bucketed import (
        BUCKET_TARGET_SEG,
        auto_buckets,
    )

    # 40 Mb shape: 173M per-merge rows -> first nb with rows/nb <= target
    nb = auto_buckets(50331648, 18350080, 4)
    per = (1.25 * 50331648 + 1.5 * 4 * 18350080) / nb
    assert per <= BUCKET_TARGET_SEG < per * 2
    # tiny shapes clamp at the 256 floor
    assert auto_buckets(8192, 4096, 4) == 256
    # absurd shapes clamp at the 4096 ceiling
    assert auto_buckets(1 << 31, 1 << 30, 8) == 4096
    # accum=1 (per-batch) sees smaller merges -> fewer buckets than accum=4
    assert auto_buckets(50331648, 18350080, 1) <= nb
