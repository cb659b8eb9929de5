"""Deferred-merge streaming (GA_MERGE_STRIDE): extraction appends raw
canonical keys to a device pending buffer and the table merge runs once
per stride batches. Must be bit-identical to the per-batch merge
(stride=1) and to the host oracle for every tail shape, including
partial final batches, partial final strides, and N-masked windows.
"""

from __future__ import annotations

import numpy as np
import pytest

from genome_assembler_tpu.models.oracle import count_canonical_dict
from genome_assembler_tpu.models.pipeline import (
    count_reads_device,
    table_to_host_counts,
)
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads


def _counts(reads, cfg, monkeypatch, stride, cap):
    monkeypatch.setenv("GA_MERGE_STRIDE", str(stride))
    table = count_reads_device(reads, cfg, table_capacity=cap)
    return table_to_host_counts(table, cfg.k)


# n_reads chosen so batches-of-50 leave: an exact stride (300), a
# partial final stride (350: 7 batches = 2*3 + 1), and a partial final
# batch + partial stride (427).
@pytest.mark.parametrize("n_reads", [300, 350, 427])
def test_strided_equals_per_batch(monkeypatch, n_reads):
    genome = simulate_genome(3000, seed=91)
    rs = simulate_reads(genome, coverage=20, read_len=60, seed=92)
    reads = rs.codes[:n_reads]
    cfg = AssemblyConfig(k=21, read_len=60, batch_reads=50)
    cap = 1 << 13

    base = _counts(reads, cfg, monkeypatch, 1, cap)
    strided = _counts(reads, cfg, monkeypatch, 3, cap)
    assert strided == base
    assert strided == count_canonical_dict(reads, cfg.k)


def test_strided_with_n_bases(monkeypatch):
    genome = simulate_genome(2000, seed=93)
    rs = simulate_reads(genome, coverage=15, read_len=60, seed=94)
    reads = rs.codes.copy()
    # sprinkle ambiguous bases (code 4) over ~1% of positions
    rng = np.random.default_rng(5)
    bad = rng.random(reads.shape) < 0.01
    reads[bad] = 4
    cfg = AssemblyConfig(k=21, read_len=60, batch_reads=64)
    cap = 1 << 13

    base = _counts(reads, cfg, monkeypatch, 1, cap)
    strided = _counts(reads, cfg, monkeypatch, 2, cap)
    assert strided == base
    assert strided == count_canonical_dict(reads, cfg.k)


def test_strided_overflow_flagged(monkeypatch):
    genome = simulate_genome(3000, seed=95)
    rs = simulate_reads(genome, coverage=10, read_len=60, seed=96)
    cfg = AssemblyConfig(k=21, read_len=60, batch_reads=50)
    monkeypatch.setenv("GA_MERGE_STRIDE", "3")
    table = count_reads_device(rs.codes, cfg, table_capacity=128)
    with pytest.raises(RuntimeError, match="overflow"):
        table_to_host_counts(table, cfg.k)


from hypothesis import given, settings
from hypothesis import strategies as st


@settings(max_examples=15, deadline=None)
@given(
    stride=st.integers(min_value=2, max_value=5),
    n_reads=st.integers(min_value=1, max_value=90),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_strided_property(stride, n_reads, seed):
    """Any (stride, read count, content) combination counts identically to
    the host dict counter — covers every batch/stride tail alignment."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(n_reads, 30), dtype=np.uint8)
    # ~2% ambiguous bases
    reads[rng.random(reads.shape) < 0.02] = 4
    cfg = AssemblyConfig(k=11, read_len=30, batch_reads=16)
    import os

    old = os.environ.get("GA_MERGE_STRIDE")
    os.environ["GA_MERGE_STRIDE"] = str(stride)
    try:
        table = count_reads_device(reads, cfg, table_capacity=1 << 12)
        got = table_to_host_counts(table, cfg.k)
    finally:
        if old is None:
            os.environ.pop("GA_MERGE_STRIDE", None)
        else:
            os.environ["GA_MERGE_STRIDE"] = old
    assert got == count_canonical_dict(reads, cfg.k)


def test_strided_padded_final_batch_masked(monkeypatch):
    """600 reads in batches of 256 leave a zero-padded final batch; the
    strided path must mask its padding rows by the real read count
    (padded zero rows would otherwise count as poly-A k-mers)."""
    genome = simulate_genome(2000, seed=97)
    rs = simulate_reads(genome, coverage=30, read_len=60, seed=98)
    reads = rs.codes[:600]
    cfg = AssemblyConfig(k=21, read_len=60, batch_reads=256)
    monkeypatch.setenv("GA_MERGE_STRIDE", "2")
    table = count_reads_device(reads, cfg, table_capacity=1 << 14)
    assert table_to_host_counts(table, cfg.k) == count_canonical_dict(
        reads, cfg.k
    )


def test_merge_stride_param_overrides_env(monkeypatch):
    """The explicit merge_stride argument wins over GA_MERGE_STRIDE and
    is bit-identical to the default cadence."""
    genome = simulate_genome(2500, seed=99)
    rs = simulate_reads(genome, coverage=15, read_len=60, seed=100)
    cfg = AssemblyConfig(k=21, read_len=60, batch_reads=64)
    monkeypatch.delenv("GA_MERGE_STRIDE", raising=False)
    base = table_to_host_counts(
        count_reads_device(rs.codes, cfg, table_capacity=1 << 13), cfg.k
    )
    monkeypatch.setenv("GA_MERGE_STRIDE", "1")
    got = table_to_host_counts(
        count_reads_device(
            rs.codes, cfg, table_capacity=1 << 13, merge_stride=4
        ),
        cfg.k,
    )
    assert got == base == count_canonical_dict(rs.codes, cfg.k)
