"""Single-device pipeline vs oracle: contig equality (SURVEY.md §4)."""

import numpy as np
import pytest

from genome_assembler_tpu.host.traverse import contigs_equal
from genome_assembler_tpu.models.oracle import assemble_oracle
from genome_assembler_tpu.models.pipeline import assemble_tpu, count_reads_device, table_to_host_counts
from genome_assembler_tpu.models.oracle import count_canonical_fast
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import decode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads


def _readset(genome_len, *, seed, coverage=30, read_len=80, error_rate=0.0):
    genome = simulate_genome(genome_len, seed=seed)
    return simulate_reads(
        genome,
        coverage=coverage,
        read_len=read_len,
        seed=seed + 1,
        error_rate=error_rate,
    )


def test_device_counts_equal_host_counts():
    rs = _readset(1200, seed=21)
    cfg = AssemblyConfig(k=25, read_len=rs.read_len)
    table = count_reads_device(rs.codes, cfg)
    got = table_to_host_counts(table, cfg.k)
    want = count_canonical_fast(rs.codes, cfg.k)
    assert got == want


def test_streaming_counts_equal_single_shot():
    rs = _readset(1500, seed=22)
    cfg = AssemblyConfig(k=21, read_len=rs.read_len, batch_reads=128)
    single = table_to_host_counts(
        count_reads_device(rs.codes, cfg), cfg.k
    )
    total_windows = rs.num_reads * (rs.read_len - cfg.k + 1)
    streamed = table_to_host_counts(
        count_reads_device(rs.codes, cfg, table_capacity=total_windows),
        cfg.k,
    )
    assert single == streamed


def test_stream_step_formulations_identical():
    """merge_raw and count-then-merge streaming steps are bit-identical
    (the caller picks by the measured sort-size cliff, so both run in
    production depending on scale)."""
    import numpy as np

    from genome_assembler_tpu.models.pipeline import _stream_step
    from genome_assembler_tpu.ops import count_jax
    from genome_assembler_tpu.utils.dna import key_words, pack_codes

    rs = _readset(400, seed=23)
    cfg = AssemblyConfig(k=21, read_len=rs.read_len)
    packed = pack_codes(rs.codes)
    cap = 1 << 16
    tables = []
    for merge_raw in (True, False):
        t = count_jax.empty_table(cap, key_words(cfg.k))
        t = _stream_step(
            t, packed, cfg.k, np.int32(rs.num_reads),
            read_len=rs.read_len, merge_raw=merge_raw, out_cap=cap,
        )
        tables.append(t)
    a, b = tables
    np.testing.assert_array_equal(np.asarray(a.words), np.asarray(b.words))
    np.testing.assert_array_equal(np.asarray(a.counts), np.asarray(b.counts))
    assert int(a.num_unique) == int(b.num_unique)
    assert bool(a.overflow) == bool(b.overflow)


def test_assemble_tpu_equals_oracle_error_free():
    """CFG 0 shape: device pipeline == oracle == genome."""
    genome = simulate_genome(4000, seed=23)
    rs = simulate_reads(genome, coverage=40, read_len=100, seed=24)
    cfg = AssemblyConfig(k=25, read_len=100)
    tpu_contigs = assemble_tpu(rs.codes, cfg)
    oracle_contigs = assemble_oracle(rs.codes, cfg)
    assert tpu_contigs == oracle_contigs
    assert contigs_equal(tpu_contigs, [decode_seq(genome)])


def test_assemble_tpu_equals_oracle_with_errors():
    """CFG 1 shape: errors + coverage filter + simplification agree."""
    genome = simulate_genome(3000, seed=25)
    rs = simulate_reads(
        genome, coverage=60, read_len=100, seed=26, error_rate=0.01
    )
    cfg = AssemblyConfig(k=25, min_count=5, read_len=100)
    assert assemble_tpu(rs.codes, cfg) == assemble_oracle(rs.codes, cfg)


@pytest.mark.parametrize("k", [21, 31, 41])
def test_assemble_tpu_multi_k(k):
    """CFG 3 shape: the multi-k sweep incl. 82-bit keys (k=41)."""
    genome = simulate_genome(2000, seed=27)
    rs = simulate_reads(genome, coverage=25, read_len=100, seed=28)
    cfg = AssemblyConfig(k=k, read_len=100)
    tpu_contigs = assemble_tpu(rs.codes, cfg)
    assert contigs_equal(tpu_contigs, [decode_seq(genome)])
