"""N-base masking + FASTQ ingestion (reference C1 tolerance, VERDICT r1 #7).

Windows touching an ambiguous base are masked — never counted — on every
path: dict oracle, NumPy kernel, XLA single-device, and the sharded
distributed counter. FASTQ quality lines are skipped.
"""

from __future__ import annotations

import numpy as np
import pytest

from genome_assembler_tpu.models.oracle import (
    count_canonical_dict,
    count_canonical_fast,
)
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import (
    INVALID_CODE,
    decode_seq,
    encode_seq,
    pack_invalid_mask,
)
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads


def _reads_with_ns(n_frac: float, seed: int = 31, genome_len: int = 2000):
    genome = simulate_genome(genome_len, seed=seed)
    rs = simulate_reads(genome, coverage=15, read_len=100, seed=seed + 1)
    codes = rs.codes.copy()
    rng = np.random.default_rng(seed + 2)
    hit = rng.random(codes.shape) < n_frac
    codes[hit] = INVALID_CODE
    return codes, genome


def test_encode_seq_masked_and_strict():
    with pytest.raises(ValueError):
        encode_seq("ACGTN")
    codes = encode_seq("ACGTN", mask_invalid=True)
    assert list(codes) == [0, 1, 2, 3, INVALID_CODE]
    assert decode_seq(codes) == "ACGTN"


def test_pack_invalid_mask_roundtrip():
    codes, _ = _reads_with_ns(0.01)
    mask = pack_invalid_mask(codes)
    assert mask is not None
    unpacked = np.unpackbits(mask, axis=1, bitorder="little")[
        :, : codes.shape[1]
    ]
    np.testing.assert_array_equal(unpacked.astype(bool), codes > 3)
    assert pack_invalid_mask(np.zeros((3, 8), np.uint8)) is None


def test_dict_and_numpy_counters_agree_with_ns():
    codes, _ = _reads_with_ns(0.02)
    k = 21
    want = count_canonical_dict(codes, k)
    got = count_canonical_fast(codes, k)
    assert got == want
    # masking really dropped something vs pretending Ns were 'A'
    clean = codes.copy()
    clean[clean > 3] = 0
    assert count_canonical_fast(clean, k) != got


def test_device_counting_masks_ns_single_shot_and_streaming():
    from genome_assembler_tpu.models.pipeline import (
        count_reads_device,
        table_to_host_counts,
    )

    codes, _ = _reads_with_ns(0.01)
    k = 25
    cfg = AssemblyConfig(k=k, read_len=100, batch_reads=128)
    want = count_canonical_dict(codes, k)
    got = table_to_host_counts(count_reads_device(codes, cfg), k)
    assert got == want
    # force the streaming/merge path with a small capacity table
    got_stream = table_to_host_counts(
        count_reads_device(codes, cfg, table_capacity=len(want) + 64), k
    )
    assert got_stream == want


def test_distributed_counting_masks_ns():
    from genome_assembler_tpu.parallel.mesh import build_mesh
    from genome_assembler_tpu.parallel.pipeline import (
        distributed_count_to_host,
    )

    codes, _ = _reads_with_ns(0.01, seed=77)
    cfg = AssemblyConfig(k=21, read_len=100)
    want = count_canonical_dict(codes, cfg.k)
    got = distributed_count_to_host(codes, cfg, build_mesh(4))
    assert got == want


def test_assembly_with_ns_reconstructs_genome():
    """1% N bases: the assembly still succeeds (VERDICT r1 'done' bar)."""
    from genome_assembler_tpu.host.traverse import contigs_equal
    from genome_assembler_tpu.models.pipeline import assemble_tpu
    from genome_assembler_tpu.utils.metrics import Metrics

    genome = simulate_genome(3000, seed=91)
    rs = simulate_reads(genome, coverage=30, read_len=100, seed=92)
    codes = rs.codes.copy()
    rng = np.random.default_rng(93)
    hit = rng.random(codes.shape) < 0.01
    codes[hit] = INVALID_CODE
    cfg = AssemblyConfig(k=25, read_len=100)
    m = Metrics()
    contigs = assemble_tpu(codes, cfg, metrics=m)
    assert m.counters["masked_windows"] > 0
    assert contigs_equal(contigs, [decode_seq(genome)])


def test_read_sequences_fastq(tmp_path):
    from genome_assembler_tpu.cli import read_sequences

    fq = tmp_path / "reads.fastq"
    fq.write_text(
        "@r1 desc\nACGTNACGT\n+\n!!!!!!!!!\n"
        "@r2\nTTTTGGGGA\n+r2\nIIIIIIIII\n"
    )
    assert read_sequences(str(fq)) == ["ACGTNACGT", "TTTTGGGGA"]
    bad = tmp_path / "trunc.fastq"
    bad.write_text("@r1\nACGT\n+\n")
    with pytest.raises(ValueError):
        read_sequences(str(bad))


def test_native_loader_fastq_and_ns(tmp_path):
    from genome_assembler_tpu.utils import io_native

    if not io_native.available():
        pytest.skip("native toolchain unavailable")
    fq = tmp_path / "reads.fastq"
    fq.write_text(
        "@r1\nACGTNACG\n+\n!!!!!!!!\n"
        "@r2\nTTTTGGGG\n+\nIIIIIIII\n"
    )
    out = io_native.load_reads(str(fq))
    assert out is not None
    assert out.shape == (2, 8)
    assert list(out[0]) == [0, 1, 2, 3, INVALID_CODE, 0, 1, 2]
    assert list(out[1]) == [3, 3, 3, 3, 2, 2, 2, 2]


def test_native_loader_fasta_with_ns(tmp_path):
    from genome_assembler_tpu.utils import io_native

    if not io_native.available():
        pytest.skip("native toolchain unavailable")
    fa = tmp_path / "reads.fa"
    fa.write_text(">a\nACGTN\n>b\nGGGTC\n")
    out = io_native.load_reads(str(fa))
    assert out is not None
    assert list(out[0]) == [0, 1, 2, 3, INVALID_CODE]
    assert list(out[1]) == [2, 2, 2, 3, 1]


def test_extraction_n_plane_matches_raw_codes():
    """The separate ambiguous-base plane (how Ns travel beside 2-bit
    packed codes) masks exactly the windows raw INVALID_CODE bases do."""
    import jax.numpy as jnp

    from genome_assembler_tpu.ops.kmer_jax import extract_canonical_flat

    codes, _ = _reads_with_ns(0.02, seed=55, genome_len=800)
    bad = jnp.asarray(codes > 3)
    clamped = jnp.asarray(codes & 3)
    k = 21
    nv = np.int32(codes.shape[0] - 3)
    want_k, want_v = extract_canonical_flat(jnp.asarray(codes), k, nv)
    got_k, got_v = extract_canonical_flat(clamped, k, nv, bad)
    np.testing.assert_array_equal(np.asarray(got_k), np.asarray(want_k))
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))


def test_streamed_pipeline_with_ns():
    """Streamed batches carry the packed N bits: counts equal the dict
    oracle, including the zero-padded final batch."""
    from genome_assembler_tpu.models.pipeline import (
        count_reads_device,
        table_to_host_counts,
    )

    codes, _ = _reads_with_ns(0.01, seed=57)
    cfg = AssemblyConfig(k=25, read_len=100, batch_reads=128)
    got = table_to_host_counts(
        count_reads_device(codes, cfg, table_capacity=1 << 13), cfg.k
    )
    assert got == count_canonical_dict(codes, cfg.k)
