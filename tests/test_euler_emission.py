"""Reference-parity Eulerian emission mode (VERDICT r1 item 5).

The default emission stops contigs at branching junctions; --emit euler
spells contigs from full edge-covering Eulerian walks, as the reference's
``eulerian_path -> contigs`` stack does (SURVEY.md §3.1/§3.4). Both modes
must agree between the oracle and the device path, and on branch-free graphs
they must coincide.
"""

from __future__ import annotations

import numpy as np
import pytest

from genome_assembler_tpu.host.traverse import contigs_equal
from genome_assembler_tpu.models.oracle import assemble_oracle
from genome_assembler_tpu.models.pipeline import assemble_tpu
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import decode_seq, encode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads


def _tile_reads(genome_str: str, read_len: int, k: int) -> np.ndarray:
    """Every read_len window at stride 1 over the genome (full coverage)."""
    rows = [
        encode_seq(genome_str[i : i + read_len])
        for i in range(len(genome_str) - read_len + 1)
    ]
    return np.stack(rows)


def test_euler_equals_unitigs_on_branch_free_genome():
    genome = simulate_genome(1200, seed=11)
    rs = simulate_reads(genome, coverage=20, read_len=80, seed=12)
    cfg = AssemblyConfig(k=25, read_len=80)
    uni = assemble_tpu(rs.codes, cfg)
    eul = assemble_tpu(rs.codes, cfg, emit="euler")
    assert uni == eul
    assert contigs_equal(eul, [decode_seq(genome)])


def _branchy_case(k: int = 21):
    """Genome with an exact interior repeat longer than k-1 -> a junction."""
    rng = np.random.default_rng(5)
    piece = lambda n: decode_seq(rng.integers(0, 4, n).astype(np.uint8))  # noqa: E731
    rep = piece(30)  # repeat length 30 > k-1 = 20
    genome = piece(200) + rep + piece(180) + rep + piece(220)
    reads = _tile_reads(genome, 61, k)
    return genome, reads, AssemblyConfig(k=k, read_len=61)


def test_euler_walks_through_junctions():
    genome, reads, cfg = _branchy_case()
    uni = assemble_tpu(reads, cfg)
    eul = assemble_tpu(reads, cfg, emit="euler")
    # the repeat fragments the unitig emission but not the euler walk
    assert len(uni) > 1
    assert len(eul) < len(uni)
    assert max(len(c) for c in eul) > max(len(c) for c in uni)
    # every euler contig is still assembled from real graph edges: its
    # k-mer multiset is a subset of the genome's (walks reuse repeat edges
    # once per multiplicity, so the union matches exactly)
    from genome_assembler_tpu.models.oracle import count_canonical_dict

    genome_kmers = count_canonical_dict([genome], cfg.k)
    for c in eul:
        for km, n in count_canonical_dict([c], cfg.k).items():
            assert km in genome_kmers


def test_euler_walks_are_contiguous_and_edge_covering():
    """Every walk chains end->start; every unitig appears exactly once."""
    from genome_assembler_tpu.host.traverse import euler_walks

    _, reads, cfg = _branchy_case()
    _, graph = assemble_tpu(reads, cfg, return_graph=True)
    walks = euler_walks(graph)
    used: list[int] = []
    for w in walks:
        assert w
        for a, b in zip(w, w[1:]):
            assert graph.unitigs[a].end == graph.unitigs[b].start
        used.extend(w)
    assert sorted(used) == list(range(len(graph.unitigs)))


def test_euler_oracle_equals_tpu_on_branchy_graph():
    _, reads, cfg = _branchy_case()
    assert assemble_tpu(reads, cfg, emit="euler") == assemble_oracle(
        reads, cfg, emit="euler"
    )


def test_euler_cli_flag(tmp_path):
    from genome_assembler_tpu.cli import main

    genome, reads, cfg = _branchy_case()
    reads_path = tmp_path / "reads.txt"
    with open(reads_path, "w") as fh:
        for row in reads:
            fh.write(decode_seq(row) + "\n")
    out_u = tmp_path / "u.fa"
    out_e = tmp_path / "e.fa"
    base = ["assemble", "--reads", str(reads_path), "-k", str(cfg.k)]
    assert main(base + ["--out", str(out_u)]) == 0
    assert main(base + ["--emit", "euler", "--out", str(out_e)]) == 0
    from genome_assembler_tpu.cli import read_sequences

    assert len(read_sequences(str(out_e))) < len(read_sequences(str(out_u)))


def test_euler_circular_genome_canonical():
    """A purely cyclic graph emits one rotation-canonical contig."""
    rng = np.random.default_rng(9)
    core = decode_seq(rng.integers(0, 4, 300).astype(np.uint8))
    k = 21
    circ = core + core[: k + 40]  # reads tile across the wrap point
    reads = _tile_reads(circ, 61, k)
    cfg = AssemblyConfig(k=k, read_len=61)
    uni = assemble_tpu(reads, cfg)
    eul = assemble_tpu(reads, cfg, emit="euler")
    assert uni == eul  # single cycle: both modes canonicalize identically
    assert len(eul) == 1


def test_euler_emission_distributed_paths():
    """--emit euler produces identical contigs on the gathered and fully
    sharded distributed paths as on the single-device path and the
    oracle, including on a branchy (junction-bearing) graph."""
    from genome_assembler_tpu.parallel.mesh import build_mesh
    from genome_assembler_tpu.parallel.pipeline import (
        assemble_distributed,
        assemble_distributed_sharded,
    )

    genome, reads, cfg = _branchy_case()
    want = assemble_tpu(reads, cfg, emit="euler")
    assert want == assemble_oracle(reads, cfg, emit="euler")
    mesh = build_mesh(4)
    assert assemble_distributed(reads, cfg, mesh, emit="euler") == want
    assert assemble_distributed_sharded(reads, cfg, mesh, emit="euler") == want
