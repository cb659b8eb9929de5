"""GPU smoke tests (skipped without a GPU).

Run on a GPU machine: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import pytest

pytestmark = pytest.mark.gpu


def test_count_on_chip_matches_reference(gpu):
    from genome_assembler_tpu.models.oracle import count_canonical_fast
    from genome_assembler_tpu.models.pipeline import (
        count_reads_device,
        table_to_host_counts,
    )
    from genome_assembler_tpu.utils.config import AssemblyConfig
    from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads

    genome = simulate_genome(2000, seed=301)
    rs = simulate_reads(genome, coverage=15, read_len=100, seed=302)
    cfg = AssemblyConfig(k=31, read_len=100)
    got = table_to_host_counts(count_reads_device(rs.codes, cfg), cfg.k)
    assert got == count_canonical_fast(rs.codes, cfg.k)


def test_assemble_on_chip(gpu):
    from genome_assembler_tpu.host.traverse import contigs_equal
    from genome_assembler_tpu.models.pipeline import assemble_tpu
    from genome_assembler_tpu.utils.config import AssemblyConfig
    from genome_assembler_tpu.utils.dna import decode_seq
    from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads

    genome = simulate_genome(3000, seed=303)
    rs = simulate_reads(genome, coverage=25, read_len=100, seed=304)
    contigs = assemble_tpu(rs.codes, AssemblyConfig(k=25, read_len=100))
    assert contigs_equal(contigs, [decode_seq(genome)])
