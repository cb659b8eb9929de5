"""Command-line front-end (reference C1 read ingestion / C9 contig emission).

Capability parity with the reference's CLI entry (SURVEY.md §1 "CLI / entry":
read input reads, select k, run pipeline, print contigs), plus the simulator
front-end the acceptance configs need (no genome data ships offline,
SURVEY.md §6).

  ga-tpu simulate --preset lambda --coverage 100 --out reads.txt
  ga-tpu assemble --reads reads.txt -k 31 --min-count 3 > contigs.fa
  ga-tpu assemble --preset toy10k --coverage 100 -k 25   # simulate + assemble
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .utils.config import AssemblyConfig
from .utils.dna import decode_seq, encode_seq
from .utils.simulate import GENOME_PRESETS, preset_genome, simulate_genome, simulate_reads


def read_sequences(path: str) -> list[str]:
    """Load reads: FASTA if the first record starts with '>', FASTQ if it
    starts with '@' (sequence lines kept, quality lines skipped), else one
    sequence per line (multi-line joining only applies to FASTA records).
    path '-' reads stdin (reference CLI parity: assemble < reads)."""
    if path == "-":
        lines = [ln.strip() for ln in sys.stdin]
    else:
        with open(path) as fh:
            lines = [ln.strip() for ln in fh]
    lines = [ln for ln in lines if ln]
    if not lines:
        return []
    if lines[0].startswith("@"):
        # FASTQ: 4-line records (@header, sequence, +separator, quality)
        if len(lines) % 4 != 0:
            raise ValueError(
                f"{path}: malformed FASTQ ({len(lines)} non-empty lines, "
                "expected a multiple of 4)"
            )
        return [lines[i + 1].upper() for i in range(0, len(lines), 4)]
    if not lines[0].startswith(">"):
        return [ln.upper() for ln in lines]
    seqs: list[str] = []
    current: list[str] = []
    for line in lines:
        if line.startswith(">"):
            if current:
                seqs.append("".join(current))
                current = []
        else:
            current.append(line.upper())
    if current:
        seqs.append("".join(current))
    return seqs


def write_fasta(
    contigs: list[str],
    fh,
    prefix: str = "contig",
    coverages: list[float] | None = None,
) -> None:
    for i, seq in enumerate(contigs):
        cov = f" cov={coverages[i]:.1f}" if coverages else ""
        fh.write(f">{prefix}_{i} len={len(seq)}{cov}\n")
        for j in range(0, len(seq), 80):
            fh.write(seq[j : j + 80] + "\n")


def _add_sim_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(GENOME_PRESETS), default=None,
                   help="synthesized stand-in genome (BASELINE.md configs)")
    p.add_argument("--genome-len", type=int, default=None,
                   help="random genome length (alternative to --preset)")
    p.add_argument("--genome-seed", type=int, default=101)
    p.add_argument("--coverage", type=float, default=100.0)
    p.add_argument("--read-len", type=int, default=100)
    p.add_argument("--error-rate", type=float, default=0.0)
    p.add_argument("--read-seed", type=int, default=1)
    p.add_argument("--single-strand", action="store_true",
                   help="forward-strand reads only")
    p.add_argument("--chromosomes", type=int, default=1,
                   help="split --genome-len across N independent "
                   "chromosomes (multi-contig ground truth)")
    p.add_argument("--circular", action="store_true",
                   help="circular chromosome(s): reads wrap the origin")


def _simulated_reads(args) -> tuple[np.ndarray, list[np.ndarray]]:
    n_chrom = getattr(args, "chromosomes", 1)
    circular = getattr(args, "circular", False)
    if args.preset:
        genomes = [preset_genome(args.preset)]
    elif args.genome_len:
        if n_chrom > 1:
            from .utils.simulate import simulate_genome_multi

            per = args.genome_len // n_chrom
            lens = [per] * (n_chrom - 1) + [args.genome_len - per * (n_chrom - 1)]
            genomes = simulate_genome_multi(lens, seed=args.genome_seed)
        else:
            genomes = [simulate_genome(args.genome_len, seed=args.genome_seed)]
    else:
        raise SystemExit("need --preset or --genome-len (or --reads)")
    if len(genomes) > 1:
        from .utils.simulate import simulate_reads_multi

        rs = simulate_reads_multi(
            genomes,
            coverage=args.coverage,
            read_len=args.read_len,
            seed=args.read_seed,
            error_rate=args.error_rate,
            circular=circular,
        )
    else:
        rs = simulate_reads(
            genomes[0],
            coverage=args.coverage,
            read_len=args.read_len,
            seed=args.read_seed,
            error_rate=args.error_rate,
            both_strands=not args.single_strand,
            circular=circular,
        )
    return rs.codes, genomes


def cmd_simulate(args) -> int:
    codes, genomes = _simulated_reads(args)
    out = open(args.out, "w") if args.out else sys.stdout
    for row in codes:
        out.write(decode_seq(row) + "\n")
    if args.out:
        out.close()
    if args.genome_out:
        with open(args.genome_out, "w") as fh:
            write_fasta([decode_seq(g) for g in genomes], fh, prefix="genome")
    total = sum(len(g) for g in genomes)
    chrom = f" in {len(genomes)} chromosomes" if len(genomes) > 1 else ""
    print(
        f"simulated {len(codes)} reads x {codes.shape[1]} bp"
        f" (genome {total} bp{chrom})",
        file=sys.stderr,
    )
    return 0


def _graph_outputs(args, graph) -> tuple[list[str], list[float]]:
    """Shared graph-based outputs for graph-producing backends:
    optional GFA 1.0 export + (contigs, per-contig mean k-mer coverage).
    One traversal serves both (emit_contigs is the seq column of the
    with-coverage emitters), so callers drop their own emitted list."""
    if args.gfa:
        from .host.stats import write_gfa

        with open(args.gfa, "w") as fh:
            write_gfa(graph, fh)
    from .host.traverse import (
        emit_contigs_euler_with_cov,
        emit_contigs_with_cov,
    )

    with_cov = (
        emit_contigs_euler_with_cov(graph)
        if args.emit == "euler"
        else emit_contigs_with_cov(graph)
    )
    return [s for s, _ in with_cov], [c for _, c in with_cov]


def cmd_assemble(args) -> int:
    from .models.oracle import assemble_oracle

    if getattr(args, "merge_stride", None) is not None and args.merge_stride < 1:
        raise SystemExit("--merge-stride must be >= 1")
    if getattr(args, "bucketed", None) is not None:
        # the streaming counter reads GA_BUCKETED at call time
        os.environ["GA_BUCKETED"] = {
            "auto": "auto", "on": "1", "off": "0"
        }[args.bucketed]
    if args.backend != "oracle":
        from .utils.jaxenv import setup

        setup()
    t0 = time.perf_counter()
    if args.reads:
        from .utils.io_native import load_reads

        native = load_reads(args.reads)  # C++ mmap fast path
        if native is not None:
            reads: list[str] | np.ndarray = native
            n_reads = native.shape[0]
        else:
            seqs = read_sequences(args.reads)
            if not seqs:
                raise SystemExit(f"no reads found in {args.reads}")
            lens = {len(s) for s in seqs}
            if len(lens) == 1:
                # mask_invalid: Ns in real read data mask their windows
                # instead of aborting the run
                reads = np.stack(
                    [encode_seq(s, mask_invalid=True) for s in seqs]
                )
            elif args.backend == "oracle":
                reads = seqs  # ragged: dict counting path
            else:
                # ragged reads pad to the max length with INVALID_CODE:
                # padding windows mask to the sentinel exactly like Ns, so
                # the fixed-shape device batch counts precisely the real
                # windows (no dict fallback needed)
                from .utils.dna import INVALID_CODE

                max_len = max(lens)
                reads = np.full(
                    (len(seqs), max_len), INVALID_CODE, dtype=np.uint8
                )
                for i, s in enumerate(seqs):
                    reads[i, : len(s)] = encode_seq(s, mask_invalid=True)
            n_reads = len(seqs)
    else:
        reads, _ = _simulated_reads(args)
        n_reads = reads.shape[0]

    cfg = AssemblyConfig(
        k=args.k,
        min_count=args.min_count,
        tip_len=args.tip_len,
        bubble_len=args.bubble_len,
        read_len=(
            reads.shape[1] if isinstance(reads, np.ndarray) else args.read_len
        ),
        **(
            {"batch_reads": args.batch_reads}
            if getattr(args, "batch_reads", None)
            else {}
        ),
    )
    coverages = None
    if args.backend == "oracle":
        contigs = assemble_oracle(reads, cfg, emit=args.emit)
        metrics = None
    elif args.backend == "dist":
        from .parallel.mesh import build_mesh, init_distributed
        from .parallel.pipeline import assemble_distributed
        from .utils.metrics import Metrics

        if not isinstance(reads, np.ndarray):
            raise SystemExit("--backend dist requires uniform-length reads")
        multiproc = init_distributed()  # multi-process launch (GA_DIST=1)
        metrics = Metrics()
        hosts = args.hosts
        if multiproc and hosts is None:
            import jax

            # multi-process default: one 'host' mesh row per process
            hosts = jax.process_count()
        mesh = build_mesh(args.devices, hosts=hosts)
        if args.sharded_graph:
            from .parallel.pipeline import assemble_distributed_sharded

            contigs, graph = assemble_distributed_sharded(
                reads, cfg, mesh, metrics=metrics, emit=args.emit,
                checkpoint=args.checkpoint, resume_from=args.resume_from,
                return_graph=True, minimizer_len=args.minimizer_len,
                table_capacity=args.table_capacity,
                merge_stride=args.merge_stride,
                stream_checkpoint_every=args.stream_checkpoint_every,
            )
        else:
            contigs, graph = assemble_distributed(
                reads, cfg, mesh, metrics=metrics, emit=args.emit,
                checkpoint=args.checkpoint, resume_from=args.resume_from,
                return_graph=True, minimizer_len=args.minimizer_len,
                table_capacity=args.table_capacity,
                merge_stride=args.merge_stride,
                stream_checkpoint_every=args.stream_checkpoint_every,
            )
        contigs, coverages = _graph_outputs(args, graph)
    else:  # tpu
        from .models.pipeline import assemble_tpu
        from .utils.metrics import Metrics

        if not isinstance(reads, np.ndarray):
            raise SystemExit("--backend tpu requires uniform-length reads")
        metrics = Metrics()
        contigs, graph = assemble_tpu(
            reads,
            cfg,
            metrics=metrics,
            checkpoint=args.checkpoint,
            resume_from=args.resume_from,
            table_capacity=args.table_capacity,
            return_graph=True,
            emit=args.emit,
            merge_stride=args.merge_stride,
            stream_checkpoint_every=args.stream_checkpoint_every,
        )
        contigs, coverages = _graph_outputs(args, graph)
    dt = time.perf_counter() - t0
    if args.metrics_out and metrics is not None:
        metrics.dump(args.metrics_out)
    if args.stats:
        from .host.stats import stats_json

        print(stats_json(contigs), file=sys.stderr)

    out = open(args.out, "w") if args.out else sys.stdout
    write_fasta(contigs, out, coverages=coverages)
    if args.out:
        out.close()
    total = sum(len(c) for c in contigs)
    print(
        f"assembled {n_reads} reads -> {len(contigs)} contig(s),"
        f" {total} bp total in {dt:.2f}s [{args.backend}]",
        file=sys.stderr,
    )
    return 0


def cmd_reshard(args) -> int:
    """Rewrite a mid-stream sharded checkpoint for a different mesh size
    (elastic recovery: a preempted count resumes on however many
    devices remain). Host-side only — no device work, no recounting."""
    from .parallel.pipeline import reshard_sharded_stream_checkpoint

    seqs = read_sequences(args.reads)
    if not seqs:
        raise SystemExit(f"no reads found in {args.reads}")
    lens = {len(s) for s in seqs}
    if len(lens) != 1:
        raise SystemExit("resharding requires fixed-length reads")
    cfg = AssemblyConfig(
        k=args.k, read_len=next(iter(lens)),
        batch_reads=args.batch_reads or AssemblyConfig.batch_reads,
    )
    reshard_sharded_stream_checkpoint(
        args.infile, args.out, (len(seqs), cfg.read_len), cfg,
        args.devices, table_capacity=args.table_capacity,
        merge_stride=args.merge_stride,
    )
    print(
        f"resharded {args.infile} -> {args.out} for {args.devices} devices",
        file=sys.stderr,
    )
    return 0


def cmd_stats(args) -> int:
    """Contig statistics of an existing FASTA/lines file (the reference
    workflow's post-assembly inspection step — SURVEY.md §1 output row —
    without re-running assembly)."""
    from .host.stats import stats_json

    print(stats_json(read_sequences(args.contigs)))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ga-tpu", description=__doc__)
    p.add_argument("-v", "--verbose", action="store_true",
                   help="debug logging (per-stage timings)")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("simulate", help="simulate reads from a genome")
    _add_sim_args(ps)
    ps.add_argument("--out", default=None, help="reads output (default stdout)")
    ps.add_argument("--genome-out", default=None, help="write genome FASTA")
    ps.set_defaults(fn=cmd_simulate)

    pa = sub.add_parser("assemble", help="assemble reads into contigs")
    pa.add_argument("--reads", default=None, help="reads file (lines or FASTA)")
    _add_sim_args(pa)
    pa.add_argument("-k", type=int, default=31)
    pa.add_argument("--min-count", type=int, default=1)
    pa.add_argument("--tip-len", type=int, default=None)
    pa.add_argument("--bubble-len", type=int, default=None)
    pa.add_argument(
        "--backend",
        choices=["oracle", "tpu", "dist"],
        default="oracle",
        help="oracle = reference-equivalent host; tpu = single device; "
        "dist = sharded over all devices (or --devices)",
    )
    pa.add_argument("--devices", type=int, default=None,
                    help="mesh size for --backend dist (default: all)")
    pa.add_argument("--hosts", type=int, default=None,
                    help="build a 2-level (host, chip) mesh with this many "
                    "hosts (--backend dist; multi-node launches only, "
                    "paired with GA_DIST=1)")
    pa.add_argument("--minimizer-len", type=int, default=None,
                    help="route minimizer super-k-mer records over the "
                    "all-to-all instead of per-window keys (~3-6x less "
                    "cross-chip volume; --backend dist; try 15 for k=31)")
    pa.add_argument("--sharded-graph", action="store_true",
                    help="keep the graph sharded through compression "
                    "(per-device memory ~1/D; --backend dist, odd k)")
    pa.add_argument("--out", default=None, help="contigs FASTA (default stdout)")
    pa.add_argument("--metrics-out", default=None,
                    help="write per-stage metrics JSON here")
    pa.add_argument("--stats", action="store_true",
                    help="print contig summary stats (N50 etc.) to stderr")
    pa.add_argument("--gfa", default=None,
                    help="write the simplified unitig graph as GFA 1.0 "
                    "(tpu and dist backends)")
    pa.add_argument(
        "--emit",
        choices=["unitigs", "euler"],
        default="unitigs",
        help="contig emission: unitigs stop at branching junctions "
        "(default); euler spells full Eulerian walks (reference-parity "
        "mode, walks through junctions)",
    )
    pa.add_argument("--table-capacity", type=int, default=None,
                    help="unique-k-mer capacity of the streaming count "
                    "table (tpu backend). Default sizes it from the window "
                    "count; a snug genome-scale bound keeps every streaming "
                    "merge sort small (overflow is a flagged error, never "
                    "silent)")
    pa.add_argument("--batch-reads", type=int, default=None,
                    help="reads per device batch for the streaming counter "
                    "(default 262144)")
    pa.add_argument("--bucketed", choices=["auto", "on", "off"],
                    default=None,
                    help="hash-bucketed streaming merge (tpu backend): "
                    "batched bucket sorts replace the monolithic merge "
                    "sort. auto (default) enables it when a merge would "
                    "exceed BUCKETED_MIN_MERGE_ROWS; equivalent env: "
                    "GA_BUCKETED")
    pa.add_argument("--merge-stride", type=int, default=None,
                    help="streaming counter merge cadence: extraction/"
                    "routing appends this many batches of raw keys to a "
                    "device pending buffer before each table merge (tpu "
                    "and dist backends; GA_MERGE_STRIDE is the env "
                    "fallback; bit-identical for any value)")
    pa.add_argument("--checkpoint", default=None,
                    help="save the counted k-mer table (.npz) here")
    pa.add_argument("--resume-from", default=None,
                    help="restart from a table checkpoint: a stage-boundary "
                    "one skips counting; a mid-stream one (see "
                    "--stream-checkpoint-every) continues counting from "
                    "its batch cursor")
    pa.add_argument("--stream-checkpoint-every", type=int, default=0,
                    help="with --checkpoint: also snapshot the streaming "
                    "counter's carried table + batch cursor every N "
                    "batches (mid-stream preemption recovery; tpu and "
                    "dist backends)")
    pa.set_defaults(fn=cmd_assemble)

    pr = sub.add_parser(
        "reshard-checkpoint",
        help="rewrite a mid-stream sharded checkpoint for a different "
        "mesh size (resume a preempted distributed count on the devices "
        "that remain)",
    )
    pr.add_argument("infile", help="mid-stream sharded checkpoint (.npz)")
    pr.add_argument("--out", required=True, help="rewritten checkpoint")
    pr.add_argument("--devices", type=int, required=True,
                    help="mesh size the resumed run will use")
    pr.add_argument("--reads", required=True,
                    help="the ORIGINAL reads file (shape must match)")
    pr.add_argument("-k", type=int, default=31)
    pr.add_argument("--batch-reads", type=int, default=None)
    pr.add_argument("--table-capacity", type=int, default=None)
    pr.add_argument("--merge-stride", type=int, default=None)
    pr.set_defaults(fn=cmd_reshard)

    pst = sub.add_parser(
        "stats",
        help="contig statistics (count/bases/N50/longest) of a FASTA or "
        "line file, as one JSON line",
    )
    pst.add_argument("contigs", help="contigs file (FASTA or plain lines)")
    pst.set_defaults(fn=cmd_stats)

    pc = sub.add_parser(
        "accept", help="run driver acceptance configs (BASELINE.md 0-4 + variants 5: circular, 6: multi-chromosome)"
    )
    pc.add_argument("configs", nargs="*", type=int, default=None,
                    help="config ids (default: all)")
    pc.set_defaults(fn=cmd_accept)

    pv = sub.add_parser(
        "verify-reference",
        help="run the upstream reference assembler and diff contigs "
        "(SURVEY.md §0 parity harness)",
    )
    pv.add_argument("path", help="reference checkout (e.g. /root/reference)")
    pv.add_argument("--reads", default=None,
                    help="reads file to feed both assemblers "
                    "(default: simulate CFG 0)")
    pv.add_argument("--cmd", default=None,
                    help="shell template to run the reference, with {entry} "
                    "and {reads} placeholders")
    pv.add_argument("-k", type=int, default=25,
                    help="k tried first in the sweep")
    pv.add_argument("--ks", default=None,
                    help="comma-separated k sweep (default: k,25,31,21)")
    pv.add_argument("--emits", default=None,
                    help="comma-separated emission modes to sweep "
                    "(default: unitigs,euler)")
    pv.add_argument("--min-count", type=int, default=1)
    pv.add_argument("--use-ref-data", action="store_true",
                    help="run on the reference's bundled read sets")
    pv.set_defaults(fn=_cmd_verify_reference)
    return p


def _cmd_verify_reference(args) -> int:
    from .verify_reference import cmd_verify_reference

    return cmd_verify_reference(args)


def cmd_accept(args) -> int:
    from .utils.jaxenv import setup

    setup()
    from .models.acceptance import RUNNERS, run

    ids = args.configs if args.configs else sorted(RUNNERS)

    def emit(r):
        print(r.to_json(), flush=True)

    results = run(ids, on_result=emit)
    return 0 if all(r.passed for r in results) else 1


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose:
        import logging

        logging.basicConfig(
            level=logging.DEBUG,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
    try:
        return args.fn(args)
    except (ValueError, RuntimeError, FileNotFoundError) as e:
        # user-facing configuration/data errors: clean message, not a trace
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
