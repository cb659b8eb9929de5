"""Acceptance-config harness (BASELINE.md configs 0-4, SURVEY.md §7 M6).

One runner per driver acceptance config; each simulates its read set
(synthesized stand-in genomes — no genome data ships offline, SURVEY.md §6),
runs the device pipeline, checks the config's correctness bar, and emits the
§6 metrics JSON (k-mers/s, reads/s, roofline fraction, weak scaling).

  0: error-free 10 kb, 100x, len-100, k=25 — exact contig match vs oracle.
  1: lambda 48.5 kb, 1% errors, k=31      — tips + coverage filter.
  2: E. coli 4.6 Mb, 50x, k=31            — single-chip table, roofline.
  3: E. coli, 200x, k in {21,31,41}       — sort/dedup stress, >64-bit keys.
  4: yeast 12 Mb, 100x, multi-device      — sharded table, all-to-all,
                                            weak-scaling efficiency.
  5: circular E. coli variant of 2        — origin-wrapping reads, one
                                            closed contig up to rotation.
  6: 16-chromosome yeast variant of 4     — pooled multi-chromosome
                                            stream, per-chromosome exact
                                            contigs, island handling.

Scale overrides (GA_ACCEPT_SCALE in (0,1]) shrink genomes/coverage for CI;
the full-size runs are what BENCH/acceptance report.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable

from ..host.traverse import contigs_equal
from ..ops.count_jax import snug_capacity
from ..utils.config import AssemblyConfig
from ..utils.dna import decode_seq
from ..utils.metrics import Metrics
from ..utils.simulate import simulate_genome, simulate_reads
from .oracle import assemble_oracle
from .pipeline import assemble_tpu


@dataclass
class AcceptResult:
    config: int
    passed: bool
    detail: dict

    def to_json(self) -> str:
        return json.dumps(
            {"config": self.config, "passed": self.passed, **self.detail}
        )


def _scale() -> float:
    return float(os.environ.get("GA_ACCEPT_SCALE", "1.0"))


def errored_run_ok(
    contigs: list[str], genome: str, k: int, coverage: float | None = None
) -> bool:
    """Genome-level bar for error-rate configs (CFG 1).

    Strict at every scale: every surviving contig must spell genomic
    sequence exactly (substring of the genome or its reverse complement —
    no chimeras, no residual error bases) and the assembly must be
    near-complete in total bases.

    Contiguity bounds depend on the effective clean-window coverage
    (coverage * 0.99^k for 1% substitutions): at full CFG-1 scale
    (eff >= 40) the observed behavior is one end-trimmed contig, so
    the bar demands a dominant contig and <= 5 pieces;
    at scaled-down CI coverage, occasional zero-clean-coverage breakpoints
    are statistically expected, so only gross shattering fails.
    """
    from ..utils.dna import revcomp_str

    if not contigs:
        return False
    both = genome + "#" + revcomp_str(genome)
    if any(c not in both for c in contigs):
        return False
    total = sum(len(c) for c in contigs)
    eff = coverage * 0.99**k if coverage is not None else None
    if eff is None or eff >= 40:
        return (
            len(contigs) <= 5
            and total >= 0.95 * len(genome)
            and max(len(c) for c in contigs) >= 0.90 * len(genome)
        )
    return (
        len(contigs) <= 10
        and total >= 0.85 * len(genome)
        and max(len(c) for c in contigs) >= 0.20 * len(genome)
    )


def weak_scaling_efficiency(rates: dict[int, float]) -> dict[int, float]:
    """Efficiency of reads/s rates measured at several device counts.

    eff(d) = rate(d) / (rate(d0) * d / d0), with d0 the smallest measured
    device count — 1.0 means throughput grew linearly with devices.
    (Unit-tested; the r1 arithmetic relied on dict-iteration semantics of
    ``min`` over a dict, VERDICT r1 weak item 7.)
    """
    if not rates:
        return {}
    d0 = min(rates.keys())
    base = rates[d0]
    return {d: r / (base * d / d0) for d, r in rates.items()}


def _run_single(
    genome_len: int,
    coverage: float,
    k: int,
    *,
    error_rate: float = 0.0,
    min_count: int = 1,
    seed: int = 1000,
    check_oracle: bool = True,
) -> tuple[bool, dict]:
    s = _scale()
    genome_len = max(int(genome_len * s), 50 * k)
    coverage = max(coverage * max(s, 0.2), 8)
    genome = simulate_genome(genome_len, seed=seed)
    rs = simulate_reads(
        genome,
        coverage=coverage,
        read_len=100,
        seed=seed + 1,
        error_rate=error_rate,
        tile_k=k,
    )
    cfg = AssemblyConfig(k=k, min_count=min_count, read_len=100)
    # Streaming capacity for beyond-single-shot runs: unique k-mers are
    # bounded by the genome plus error-induced novel k-mers.
    from .pipeline import SINGLE_SHOT_WINDOWS

    total_windows = rs.num_reads * (100 - k + 1)
    if total_windows <= SINGLE_SHOT_WINDOWS:
        capacity = None
    else:
        err_kmers = int(total_windows * min(1.0, error_rate * k) * 1.2)
        # error-free unique canonical k-mers <= genome_len - k + 1 by
        # construction; 1.1x covers simulator edge effects with margin
        # (the snug grid adds its own headroom on top). Every streaming
        # merge sort scales with this capacity, so tight matters
        # (overflow is a flagged error, never silent, if the bound is
        # ever wrong).
        capacity = snug_capacity(int(1.1 * genome_len) + err_kmers + 4096)
    if os.environ.get("GA_ACCEPT_WARM") == "1":
        # untimed compile pass: compiles are shape-keyed, so the timed
        # run below then reports steady state
        assemble_tpu(rs.codes, cfg, table_capacity=capacity)
    m = Metrics()
    t0 = time.perf_counter()
    contigs = assemble_tpu(
        rs.codes,
        cfg,
        metrics=m,
        table_capacity=capacity,
    )
    wall = time.perf_counter() - t0

    genome_str = decode_seq(genome)
    if error_rate == 0.0:
        passed = contigs_equal(contigs, [genome_str])
        if not passed:
            # repeats > k-1 bases make one-contig reconstruction ambiguous
            # (CFG 3, small k): accept exact k-mer-content equality instead
            from ..host.traverse import kmer_content_equal

            passed = kmer_content_equal(contigs, genome_str, k)
    else:
        # Errored reads: end-trimming (coverage dips at genome ends) and
        # rare error-cluster breaks are legitimate, but the result must
        # still be genome-faithful — enforced, not assumed (VERDICT r1).
        passed = errored_run_ok(contigs, genome_str, k, coverage=coverage)
    if check_oracle:
        oracle = assemble_oracle(rs.codes, cfg)
        passed = passed and contigs == oracle
    detail = {
        "genome_len": genome_len,
        "coverage": round(coverage, 1),
        "k": k,
        "reads": rs.num_reads,
        "contigs": len(contigs),
        "contig_bases": sum(len(c) for c in contigs),
        "wall_s": round(wall, 2),
        "metrics": m.report(),
    }
    return passed, detail


def accept_cfg0() -> AcceptResult:
    passed, detail = _run_single(10_000, 100, 25, seed=1010)
    return AcceptResult(0, passed, detail)


def accept_cfg1() -> AcceptResult:
    passed, detail = _run_single(
        48_502, 100, 31, error_rate=0.01, min_count=5, seed=1020
    )
    return AcceptResult(1, passed, detail)


def accept_cfg2() -> AcceptResult:
    # The oracle cross-check defaults off at full scale (the host dict
    # pipeline is minutes-slow at 2.3M reads); GA_FORCE_ORACLE_CHECK=1
    # runs it anyway (the full-scale equality run).
    force = os.environ.get("GA_FORCE_ORACLE_CHECK") == "1"
    passed, detail = _run_single(
        4_641_652, 50, 31, seed=1030, check_oracle=force or _scale() < 0.2
    )
    return AcceptResult(2, passed, detail)


def accept_cfg3() -> AcceptResult:
    # GA_FORCE_ORACLE_CHECK=1 pins the contig set to the dict oracle at
    # any scale (the one-time full-scale k=21 equality run, VERDICT r4
    # weak item 5 — tools/pin_cfg3_k21_oracle.py records it standalone).
    force = os.environ.get("GA_FORCE_ORACLE_CHECK") == "1"
    details = {}
    ok = True
    for k in (21, 31, 41):
        passed, detail = _run_single(
            4_641_652,
            200,
            k,
            seed=1040,
            check_oracle=force or _scale() < 0.2,
        )
        ok = ok and passed
        details[f"k{k}"] = detail
    return AcceptResult(3, ok, details)


def accept_cfg4() -> AcceptResult:
    """Multi-device sharded counting + full sharded assembly + weak scaling.

    Bars (each enforced in-runner, VERDICT r1 item 3):
      * sharded counts == host reference counts, bit for bit (the
        vectorized count_canonical_fast — scale-feasible at every size);
      * the distributed assembly is genome-exact, and the gathered and
        fully-sharded graph paths agree; below the scale cutoff (or under
        GA_FORCE_ORACLE_CHECK=1) both are additionally pinned to the
        Python-dict oracle's contigs. Above it the dict oracle is hours
        of dict churn (VERDICT r3 missing item 5) while the genome bar is
        strictly stronger for error-free reads — one exact contig — so
        full-scale runs get real provenance instead of an unrunnable
        check;
      * weak-scaling efficiency at the largest mesh >= GA_WEAK_SCALING_MIN
        when GA_ENFORCE_WEAK_SCALING=1 (real devices only — virtual CPU
        devices share host cores, so their efficiency is reported but
        meaningless as a bar).
    """
    import datetime
    import jax

    from ..host.traverse import contigs_equal
    from ..parallel.mesh import build_mesh
    from ..parallel.pipeline import (
        assemble_distributed,
        distributed_count_to_host,
    )
    from .oracle import assemble_oracle, count_canonical_fast

    s = _scale()
    genome_len = max(int(12_000_000 * s), 2000)
    coverage = max(100 * max(s, 0.2), 8)
    genome = simulate_genome(genome_len, seed=1050)
    rs = simulate_reads(genome, coverage=coverage, read_len=100, seed=1051)
    cfg = AssemblyConfig(k=31, read_len=100)

    # genome-scale unique-k-mer bound: the streamed distributed counter
    # (beyond DIST_STREAM_WINDOWS per device) sizes its table shards from
    # this instead of the read stream
    capacity = snug_capacity(int(1.5 * genome_len) + 4096)
    n_dev = len(jax.devices())
    sizes = sorted({d for d in (1, 2, n_dev) if d <= n_dev})
    rates: dict[int, float] = {}
    counts_ok = True
    want_counts = count_canonical_fast(rs.codes, cfg.k)
    warm = (
        os.environ.get("GA_ACCEPT_WARM") == "1"
        or os.environ.get("GA_ENFORCE_WEAK_SCALING") == "1"
    )
    for d in sizes:
        mesh = build_mesh(d)
        if warm:
            # untimed compile pass per mesh size: the enforced efficiency
            # bar must measure steady-state throughput, not the per-shape
            # jit compiles
            distributed_count_to_host(
                rs.codes, cfg, mesh, table_capacity=capacity
            )
        t0 = time.perf_counter()
        counts = distributed_count_to_host(
            rs.codes, cfg, mesh, table_capacity=capacity
        )
        dt = time.perf_counter() - t0
        rates[d] = rs.num_reads / dt
        counts_ok = counts_ok and counts == want_counts
    eff = weak_scaling_efficiency(rates)

    # Full sharded assembly end-to-end on the largest mesh — both the
    # gathered path and the fully sharded graph path. The dict-oracle
    # cross-check runs below the scale cutoff (CI scale) or on demand
    # (GA_FORCE_ORACLE_CHECK=1); the genome bar + cross-path equality
    # always run, at every scale.
    from ..parallel.pipeline import assemble_distributed_sharded

    check_oracle = (
        os.environ.get("GA_FORCE_ORACLE_CHECK") == "1" or s < 0.2
    )
    m_sharded = Metrics()
    t_asm = time.perf_counter()
    contigs = assemble_distributed(
        rs.codes, cfg, build_mesh(n_dev), table_capacity=capacity
    )
    sharded = assemble_distributed_sharded(
        rs.codes, cfg, build_mesh(n_dev), table_capacity=capacity,
        metrics=m_sharded,
    )
    asm_wall = time.perf_counter() - t_asm
    assembly_ok = sharded == contigs and contigs_equal(
        contigs, [decode_seq(genome)]
    )
    if check_oracle:
        oracle = assemble_oracle(rs.codes, cfg)
        assembly_ok = assembly_ok and contigs == oracle

    passed = counts_ok and assembly_ok
    eff_bar = None
    if os.environ.get("GA_ENFORCE_WEAK_SCALING") == "1":
        eff_bar = float(os.environ.get("GA_WEAK_SCALING_MIN", "0.8"))
        passed = passed and eff[max(rates.keys())] >= eff_bar
    return AcceptResult(
        4,
        passed,
        {
            "genome_len": genome_len,
            "reads": rs.num_reads,
            "scale": s,
            "date": datetime.date.today().isoformat(),
            "devices": sizes,
            "counts_match_host": counts_ok,
            "assembly_genome_exact_and_paths_agree": assembly_ok,
            "oracle_cross_checked": check_oracle,
            "assembly_wall_s": round(asm_wall, 1),
            "contigs": len(contigs),
            "reads_per_s": {str(d): round(r, 1) for d, r in rates.items()},
            "weak_scaling_eff": {str(d): round(e, 3) for d, e in eff.items()},
            "weak_scaling_bar": eff_bar,
            "unique_kmers": len(counts),
            # wire/link volume of the sharded run (SURVEY.md §5 metrics
            # row: all-to-all volume observable per run, VERDICT r2 item 6)
            "sharded_run_metrics": m_sharded.report(),
        },
    )


def accept_cfg5() -> AcceptResult:
    """Circular-genome CFG-2 variant (VERDICT r4 item 5).

    The real CFG-2/3 organism is a circular E. coli (SURVEY.md §6);
    the linear runner never exercises origin-spanning k-mers or the
    closed-walk emission at acceptance scale. Reads wrap across the
    origin, the de Bruijn graph closes into one cycle, and the bar is
    the SURVEY.md §4 circular round-trip: exactly one contig equal to
    the genome at the Booth least rotation over both strands
    (expected_contigs_multi). Oracle cross-check below the scale cutoff
    or on demand, as CFG-2.
    """
    from ..host.traverse import expected_contigs_multi

    s = _scale()
    genome_len = max(int(4_641_652 * s), 2000)
    coverage = max(50 * max(s, 0.2), 8)
    genome = simulate_genome(genome_len, seed=1060)
    rs = simulate_reads(
        genome, coverage=coverage, read_len=100, seed=1061, tile_k=31,
        circular=True,
    )
    cfg = AssemblyConfig(k=31, read_len=100)
    from .pipeline import SINGLE_SHOT_WINDOWS

    total_windows = rs.num_reads * (100 - 31 + 1)
    capacity = (
        None if total_windows <= SINGLE_SHOT_WINDOWS
        else snug_capacity(int(1.1 * genome_len) + 4096)
    )
    if os.environ.get("GA_ACCEPT_WARM") == "1":
        assemble_tpu(rs.codes, cfg, table_capacity=capacity)
    m = Metrics()
    t0 = time.perf_counter()
    contigs = assemble_tpu(rs.codes, cfg, metrics=m, table_capacity=capacity)
    wall = time.perf_counter() - t0
    want = expected_contigs_multi([decode_seq(genome)], 31, circular=True)
    passed = contigs_equal(contigs, want)
    if os.environ.get("GA_FORCE_ORACLE_CHECK") == "1" or s < 0.2:
        oracle = assemble_oracle(rs.codes, cfg)
        passed = passed and contigs == oracle
    return AcceptResult(
        5,
        passed,
        {
            "variant": "cfg2_circular",
            "genome_len": genome_len,
            "coverage": round(coverage, 1),
            "reads": rs.num_reads,
            "contigs": len(contigs),
            "contig_bases": sum(len(c) for c in contigs),
            "rotation_exact": passed,
            "wall_s": round(wall, 2),
            "metrics": m.report(),
        },
    )


def _yeast_chromosome_lengths(total: int, n: int = 16) -> list[int]:
    """Deterministic yeast-like chromosome size spread summing to
    ``total``: real S. cerevisiae chromosomes span ~230 kb to ~1.5 Mb
    (a ~6.5x spread); a fixed geometric-ish ramp reproduces that shape
    at any acceptance scale."""
    w = [1.0 + 5.5 * i / (n - 1) for i in range(n)]
    sw = sum(w)
    lens = [max(int(total * wi / sw), 200) for wi in w]
    lens[-1] += total - sum(lens)  # exact total
    return lens


def accept_cfg6() -> AcceptResult:
    """Multi-chromosome CFG-4 variant: 16-chromosome yeast-like 12 Mb
    (VERDICT r4 item 5 — the first acceptance-scale exercise of
    multi-contig emission and island handling).

    Reads from all chromosomes pool into one shuffled stream; the
    distributed gathered and fully-sharded graph paths must agree, the
    sharded counts must equal the host reference bit-for-bit, and the
    contig set must be per-chromosome exact (each chromosome one
    contig, expected_contigs_multi).
    """
    import datetime
    import jax

    from ..host.traverse import expected_contigs_multi
    from ..parallel.mesh import build_mesh
    from ..parallel.pipeline import (
        assemble_distributed,
        assemble_distributed_sharded,
        distributed_count_to_host,
    )
    from ..utils.simulate import simulate_genome_multi, simulate_reads_multi
    from .oracle import count_canonical_fast

    s = _scale()
    total = max(int(12_000_000 * s), 32_000)
    coverage = max(100 * max(s, 0.2), 8)
    lens = _yeast_chromosome_lengths(total)
    genomes = simulate_genome_multi(lens, seed=1070)
    rs = simulate_reads_multi(
        genomes, coverage=coverage, read_len=100, seed=1071, tile_k=31
    )
    cfg = AssemblyConfig(k=31, read_len=100)
    capacity = snug_capacity(int(1.5 * total) + 4096)
    n_dev = len(jax.devices())
    mesh = build_mesh(n_dev)
    counts = distributed_count_to_host(
        rs.codes, cfg, mesh, table_capacity=capacity
    )
    counts_ok = counts == count_canonical_fast(rs.codes, cfg.k)
    m_sharded = Metrics()
    t0 = time.perf_counter()
    contigs = assemble_distributed(
        rs.codes, cfg, mesh, table_capacity=capacity
    )
    sharded = assemble_distributed_sharded(
        rs.codes, cfg, mesh, table_capacity=capacity, metrics=m_sharded
    )
    wall = time.perf_counter() - t0
    want = expected_contigs_multi([decode_seq(g) for g in genomes], 31)
    per_chrom = contigs_equal(contigs, want)
    paths_agree = sharded == contigs
    passed = counts_ok and per_chrom and paths_agree
    if os.environ.get("GA_FORCE_ORACLE_CHECK") == "1" or s < 0.2:
        oracle = assemble_oracle(rs.codes, cfg)
        passed = passed and contigs == oracle
    return AcceptResult(
        6,
        passed,
        {
            "variant": "cfg4_multichromosome",
            "chromosomes": len(lens),
            "chromosome_lens": lens,
            "total_len": total,
            "coverage": round(coverage, 1),
            "reads": rs.num_reads,
            "scale": s,
            "date": datetime.date.today().isoformat(),
            "devices": n_dev,
            "counts_match_host": counts_ok,
            "per_chromosome_exact": per_chrom,
            "paths_agree": paths_agree,
            "contigs": len(contigs),
            "assembly_wall_s": round(wall, 1),
            "sharded_run_metrics": m_sharded.report(),
        },
    )


RUNNERS: dict[int, Callable[[], AcceptResult]] = {
    0: accept_cfg0,
    1: accept_cfg1,
    2: accept_cfg2,
    3: accept_cfg3,
    4: accept_cfg4,
    5: accept_cfg5,
    6: accept_cfg6,
}


def run(
    config_ids: list[int], on_result: Callable[[AcceptResult], None] | None = None
) -> list[AcceptResult]:
    from ..utils.jaxenv import setup

    setup()  # persistent compile cache; multi-process wiring
    results = []
    for cid in config_ids:
        r = RUNNERS[cid]()
        if on_result is not None:
            on_result(r)  # stream results: configs can run for minutes
        results.append(r)
    return results
