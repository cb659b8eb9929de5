"""Bucketed per-shard streaming merge == flat sharded merge == oracle.

The distributed streaming counter (parallel.pipeline._run_distributed_
stream) can carry each shard's running table in the hash-bucketed layout
(ops.bucketed) so per-batch merges run as batched sorts — the pod-scale
mirror of the single-device bucketed path (VERDICT r3 item 4: at scale
each shard's flat cap+batch merge re-enters the monolithic-sort cliff).
These tests pin bit-identity against the flat sharded path and the host
oracle across mesh sizes, strides, Ns, minimizer routing, and
kill/resume, exactly as tests/test_bucketed.py does single-device.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import genome_assembler_tpu.models.pipeline as mp
import genome_assembler_tpu.parallel.pipeline as pp
from genome_assembler_tpu.models.oracle import (
    assemble_oracle,
    count_canonical_fast,
)
from genome_assembler_tpu.parallel.mesh import build_mesh
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.simulate import (
    simulate_genome,
    simulate_reads,
)


@pytest.fixture
def force_stream(monkeypatch):
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    monkeypatch.setenv("GA_BUCKETS", "8")  # small buckets: fast CPU tests


def _reads(genome_len=900, coverage=12, seed=5, read_len=60, with_n=False):
    genome = simulate_genome(genome_len, seed=seed)
    rs = simulate_reads(
        genome, coverage=coverage, read_len=read_len, seed=seed + 1
    )
    codes = rs.codes
    if with_n:
        codes = codes.copy()
        rng = np.random.default_rng(seed + 2)
        rows = rng.integers(0, codes.shape[0], size=codes.shape[0] // 20)
        cols = rng.integers(0, codes.shape[1], size=rows.size)
        codes[rows, cols] = 4
    return codes


@pytest.mark.parametrize("d", [1, 2, 8])
def test_bucketed_sharded_counts_match_flat_and_host(
    force_stream, monkeypatch, d
):
    codes = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    mesh = build_mesh(d)
    monkeypatch.setenv("GA_BUCKETED", "0")
    flat = pp.distributed_count_to_host(
        codes, cfg, mesh, table_capacity=4096
    )
    monkeypatch.setenv("GA_BUCKETED", "1")
    bkt = pp.distributed_count_to_host(
        codes, cfg, mesh, table_capacity=4096
    )
    assert bkt == flat == count_canonical_fast(codes, cfg.k)


@pytest.mark.parametrize("d,stride,n_drop", [(2, 2, 3), (8, 3, 1)])
def test_bucketed_sharded_strided(force_stream, monkeypatch, d, stride,
                                  n_drop):
    """Deferred-merge cadence with the bucketed per-shard table: partial
    final strides and tail batches merge bit-identically."""
    codes = _reads()[:-n_drop]
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    mesh = build_mesh(d)
    monkeypatch.setenv("GA_BUCKETED", "1")
    got = pp.distributed_count_to_host(
        codes, cfg, mesh, table_capacity=4096, merge_stride=stride
    )
    assert got == count_canonical_fast(codes, cfg.k)


def test_bucketed_sharded_ns_minimizer_uneven(force_stream, monkeypatch):
    codes = _reads(with_n=True)[:-3]
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=56)
    want = count_canonical_fast(codes, cfg.k)
    monkeypatch.setenv("GA_BUCKETED", "1")
    got = pp.distributed_count_to_host(
        codes, cfg, build_mesh(4), table_capacity=4096
    )
    assert got == want
    got_m = pp.distributed_count_to_host(
        codes, cfg, build_mesh(4), table_capacity=4096, minimizer_len=7
    )
    assert got_m == want


def test_bucketed_sharded_assembly_both_paths(force_stream, monkeypatch):
    codes = _reads(genome_len=1200, coverage=15)
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=128)
    oracle = assemble_oracle(codes, cfg)
    monkeypatch.setenv("GA_BUCKETED", "1")
    mesh = build_mesh(4)
    assert pp.assemble_distributed(
        codes, cfg, mesh, table_capacity=4096
    ) == oracle
    assert pp.assemble_distributed_sharded(
        codes, cfg, mesh, table_capacity=4096
    ) == oracle


@settings(deadline=None, max_examples=10)
@given(st.integers(0, 2**32 - 1), st.sampled_from([2, 4]))
def test_bucketed_sharded_hypothesis(seed, d):
    """Random read sets: bucketed sharded streamed counts == host counts
    bit for bit (the distributed mirror of test_bucketed's Hypothesis
    invariant)."""
    import os

    rng = np.random.default_rng(seed)
    codes = rng.integers(
        0, 5, size=(int(rng.integers(8, 60)), 40)
    ).astype(np.uint8)  # 4 = N
    cfg = AssemblyConfig(k=11, read_len=40, batch_reads=16)
    old_thresh = pp.DIST_STREAM_WINDOWS
    old_env = {
        k: os.environ.get(k) for k in ("GA_BUCKETED", "GA_BUCKETS")
    }
    pp.DIST_STREAM_WINDOWS = 0
    os.environ["GA_BUCKETED"] = "1"
    os.environ["GA_BUCKETS"] = "8"
    try:
        got = pp.distributed_count_to_host(
            codes, cfg, build_mesh(d), table_capacity=4096
        )
    finally:
        pp.DIST_STREAM_WINDOWS = old_thresh
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert got == count_canonical_fast(codes, cfg.k)


@pytest.mark.parametrize("d", [2, 8])
def test_bucketed_kill_and_resume_sharded(
    force_stream, tmp_path, monkeypatch, d
):
    """Mid-stream checkpoint carries the bucketed layout: kill at batch 3,
    resume, identical global table (VERDICT r3 item 4 'layout carried by
    the sharded mid-stream checkpoint'). GA_BUCKET_ACCUM=2 keeps batch 2
    a merge boundary (the staged-merge cadence gates snapshot saves)."""
    monkeypatch.setenv("GA_BUCKETED", "1")
    monkeypatch.setenv("GA_BUCKET_ACCUM", "2")
    reads = _reads(genome_len=2000)
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    mesh = build_mesh(d)
    full = pp.distributed_count_to_host(
        reads, cfg, mesh, table_capacity=8192
    )

    ck = str(tmp_path / "mid_bkt.npz")
    monkeypatch.setenv("GA_STREAM_ABORT_AFTER_BATCH", "3")
    with pytest.raises(RuntimeError, match="fault injection"):
        pp.distributed_count_table(
            reads, cfg, mesh, table_capacity=8192,
            stream_checkpoint=ck, stream_checkpoint_every=2,
        )
    monkeypatch.delenv("GA_STREAM_ABORT_AFTER_BATCH")
    assert pp.is_sharded_stream_checkpoint(ck)
    # the snapshot records the bucketed layout + geometry
    _, _, params = pp.load_sharded_stream_checkpoint(ck)
    assert params["bucketed"] == 1 and "nb" in params

    table = pp.distributed_count_table(
        reads, cfg, mesh, table_capacity=8192, resume_stream_from=ck
    )
    from genome_assembler_tpu.models.pipeline import table_to_host_counts

    assert table_to_host_counts(table, cfg.k) == full


def test_bucketed_resume_rejects_flat_run(force_stream, tmp_path,
                                          monkeypatch):
    """A bucketed-layout snapshot cannot resume a flat run (and the
    mismatch is a loud error, never silent divergence)."""
    reads = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    mesh = build_mesh(2)
    ck = str(tmp_path / "mid_bkt.npz")
    monkeypatch.setenv("GA_BUCKETED", "1")
    monkeypatch.setenv("GA_BUCKET_ACCUM", "2")
    monkeypatch.setenv("GA_STREAM_ABORT_AFTER_BATCH", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        pp.distributed_count_table(
            reads, cfg, mesh, table_capacity=8192,
            stream_checkpoint=ck, stream_checkpoint_every=1,
        )
    monkeypatch.delenv("GA_STREAM_ABORT_AFTER_BATCH")
    monkeypatch.setenv("GA_BUCKETED", "0")
    with pytest.raises(ValueError, match="mismatch"):
        pp.distributed_count_table(
            reads, cfg, mesh, table_capacity=8192, resume_stream_from=ck
        )


def test_bucketed_auto_switch_keys_off_per_shard_merge_rows(
    force_stream, monkeypatch, tmp_path
):
    """GA_BUCKETED=auto engages when c_shard + stride*recv exceeds the
    threshold — verified through the checkpoint params, which record the
    layout the run actually used."""
    reads = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    mesh = build_mesh(2)
    monkeypatch.delenv("GA_BUCKETED", raising=False)
    monkeypatch.setenv("GA_BUCKET_ACCUM", "2")
    monkeypatch.setattr(mp, "BUCKETED_MIN_MERGE_ROWS", 1)
    ck = str(tmp_path / "auto_bkt.npz")
    monkeypatch.setenv("GA_STREAM_ABORT_AFTER_BATCH", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        pp.distributed_count_table(
            reads, cfg, mesh, table_capacity=8192,
            stream_checkpoint=ck, stream_checkpoint_every=1,
        )
    monkeypatch.delenv("GA_STREAM_ABORT_AFTER_BATCH")
    _, _, params = pp.load_sharded_stream_checkpoint(ck)
    assert params["bucketed"] == 1
    # and far above the threshold it stays flat
    monkeypatch.setattr(mp, "BUCKETED_MIN_MERGE_ROWS", 1 << 40)
    monkeypatch.setenv("GA_STREAM_ABORT_AFTER_BATCH", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        pp.distributed_count_table(
            reads, cfg, mesh, table_capacity=8192,
            stream_checkpoint=ck, stream_checkpoint_every=1,
        )
    monkeypatch.delenv("GA_STREAM_ABORT_AFTER_BATCH")
    _, _, params = pp.load_sharded_stream_checkpoint(ck)
    assert params["bucketed"] == 0


def _boom_factory(*a, **k):
    def _boom(*aa, **kk):
        import jax

        raise jax.errors.JaxRuntimeError(
            "INTERNAL: simulated backend failure"
        )

    return _boom


@pytest.mark.parametrize("stride", [1, 2])
def test_bucketed_auto_distributed_error_propagates(
    force_stream, monkeypatch, stride
):
    """An AUTO-selected per-shard bucketed merge that fails at
    compile/run time raises, as the single-device stream does."""
    import jax

    codes = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    mesh = build_mesh(4)
    monkeypatch.setenv("GA_BUCKETED", "auto")
    monkeypatch.setattr(mp, "BUCKETED_MIN_MERGE_ROWS", 1)
    monkeypatch.setattr(
        pp, "make_distributed_stream_count_bucketed", _boom_factory
    )
    monkeypatch.setattr(
        pp, "make_distributed_pending_merge_bucketed", _boom_factory
    )
    monkeypatch.setattr(
        pp, "make_distributed_stream_route_append_bucketed", _boom_factory
    )
    monkeypatch.setattr(
        pp, "make_distributed_staged_merge_bucketed", _boom_factory
    )
    with pytest.raises(jax.errors.JaxRuntimeError):
        pp.distributed_count_to_host(
            codes, cfg, mesh, table_capacity=4096, merge_stride=stride
        )


def test_bucketed_explicit_distributed_failure_propagates(
    force_stream, monkeypatch
):
    """GA_BUCKETED=1 on the distributed stream: no silent fallback."""
    import jax

    codes = _reads()
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    mesh = build_mesh(2)
    monkeypatch.setenv("GA_BUCKETED", "1")
    monkeypatch.setattr(
        pp, "make_distributed_stream_count_bucketed", _boom_factory
    )
    monkeypatch.setattr(
        pp, "make_distributed_pending_merge_bucketed", _boom_factory
    )
    monkeypatch.setattr(
        pp, "make_distributed_stream_route_append_bucketed", _boom_factory
    )
    monkeypatch.setattr(
        pp, "make_distributed_staged_merge_bucketed", _boom_factory
    )
    with pytest.raises(jax.errors.JaxRuntimeError):
        pp.distributed_count_to_host(codes, cfg, mesh, table_capacity=4096)


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_distributed_accum_bit_identical(force_stream, monkeypatch, accum):
    """The accumulated staged per-shard merge (GA_BUCKET_ACCUM, the
    distributed mirror of the single-device default) is bit-identical to
    per-batch merging at every accum, including the tail-flush batch
    counts that don't divide accum."""
    monkeypatch.setenv("GA_BUCKETED", "1")
    reads = _reads(genome_len=2300)
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    mesh = build_mesh(2)
    monkeypatch.setenv("GA_BUCKET_ACCUM", "1")
    want = pp.distributed_count_to_host(reads, cfg, mesh, table_capacity=8192)
    monkeypatch.setenv("GA_BUCKET_ACCUM", str(accum))
    got = pp.distributed_count_to_host(reads, cfg, mesh, table_capacity=8192)
    assert got == want
