"""Smoke test of the assembler on NVIDIA GPUs, at the sizes users run.

Drives the main paths once, all in this one process (a JAX process
reserves most of a card's memory, so no phase starts another):

  device    the JAX backend must be a GPU; prints the card and XLA flags
  ecoli     ga-tpu simulate + assemble of CFG-2 (E. coli 4.64 Mb, 50x,
            k=31) through the CLI, cold then warm: one contig equal to
            the genome
  accept    ga-tpu accept 3 5 at full scale, cold then warm: CFG-3 (200x,
            k=21/31/41) and CFG-5 (circular E. coli) against their bars
  bucketed  assemble_tpu on 40 Mb x 25x, k=31 (tools/run_large.py), whose
            streaming merges take the bucketed table: one contig equal to
            the genome

With --four it runs only the distributed backend on four GPUs:
__graft_entry__.dryrun_multichip(4) against the oracle, a check that
every shard of a sharded table lives on its own card, and ga-tpu accept
4 6 (GA_ACCEPT_SCALE, when set, cuts their genome size).

Every comparison is exact: the pipeline is integer-only. Any failure
raises, and the script exits non-zero without printing a result line.
The last line of stdout is one JSON object naming the device.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs of one host
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def _say(msg: str) -> None:
    print(msg, flush=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _peak_gib(dev) -> str:
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "n/a" if peak is None else f"{peak / 2**30:.2f}"


def phase_device(want: int):
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(
            f"chip_smoke: no GPU found (JAX backend is {backend!r}); this "
            "script measures nothing elsewhere",
            file=sys.stderr,
        )
        sys.exit(1)
    devs = jax.devices()
    _check(len(devs) >= want, f"need {want} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        _say(f"gpu: {line}")
    _say(f"device_kind: {devs[0].device_kind}  count: {len(devs)}")
    _say(f"jax: {jax.__version__}")
    for var in ("XLA_FLAGS", "XLA_PYTHON_CLIENT_MEM_FRACTION",
                "XLA_PYTHON_CLIENT_PREALLOCATE", "JAX_COMPILATION_CACHE_DIR"):
        _say(f"{var}={os.environ.get(var, '')}")
    from genome_assembler_tpu.utils import io_native
    from genome_assembler_tpu.utils.jaxenv import cache_dir, setup

    setup()
    _say(f"compile cache: {cache_dir()}")
    # built from native/ with make on first use; the CLI falls back to
    # the Python parser without it
    _say(f"native read loader: {io_native.available()}")
    return devs


def _timed_cli(argv: list[str]) -> float:
    from genome_assembler_tpu import cli

    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    _check(rc == 0, f"ga-tpu {' '.join(argv)} exited {rc}")
    return wall


def phase_ecoli(tmp: str, dev) -> None:
    from genome_assembler_tpu.cli import read_sequences
    from genome_assembler_tpu.host.traverse import contigs_equal

    reads, genome = f"{tmp}/reads.txt", f"{tmp}/genome.fa"
    contigs_fa, metrics = f"{tmp}/contigs.fa", f"{tmp}/m.json"
    sim_s = _timed_cli(["simulate", "--preset", "ecoli", "--coverage", "50",
                        "--out", reads, "--genome-out", genome])
    want = read_sequences(genome)
    walls = {}
    for run in ("cold", "warm"):
        walls[run] = _timed_cli([
            "assemble", "--reads", reads, "-k", "31", "--backend", "tpu",
            "--out", contigs_fa, "--metrics-out", metrics,
        ])
        got = read_sequences(contigs_fa)
        _check(len(got) == 1, f"ecoli {run}: {len(got)} contigs, want 1")
        _check(contigs_equal(got, want), f"ecoli {run}: contig != genome")
    with open(metrics) as fh:
        m = json.load(fh)
    n_reads = int(m["counters"]["reads"])
    _say(
        f"phase ecoli: ok  reads={n_reads} simulate_s={sim_s:.2f} "
        f"cold_s={walls['cold']:.2f} warm_s={walls['warm']:.2f} "
        f"reads_per_s={n_reads / walls['warm']:.0f} "
        f"stages_s={json.dumps(m['stages_s'])} peak_gib={_peak_gib(dev)}"
    )


def phase_accept(dev) -> None:
    walls = {}
    for run in ("cold", "warm"):
        _say(f"# accept 3 5 ({run})")
        walls[run] = _timed_cli(["accept", "3", "5"])
    _say(
        f"phase accept: ok  configs=3,5 cold_s={walls['cold']:.2f} "
        f"warm_s={walls['warm']:.2f} peak_gib={_peak_gib(dev)}"
    )


def phase_bucketed(dev, genome_len: int = 40_000_000) -> None:
    from genome_assembler_tpu.host.traverse import contigs_equal
    from genome_assembler_tpu.models.pipeline import (
        BUCKETED_MIN_MERGE_ROWS,
        assemble_tpu,
        stream_merge_rows,
    )
    from genome_assembler_tpu.ops.count_jax import snug_capacity
    from genome_assembler_tpu.utils.config import AssemblyConfig
    from genome_assembler_tpu.utils.dna import decode_seq
    from genome_assembler_tpu.utils.metrics import Metrics
    from genome_assembler_tpu.utils.simulate import (
        simulate_genome,
        simulate_reads,
    )

    k, coverage = 31, 25.0
    _check(os.environ.get("GA_BUCKETED", "auto") == "auto",
           "GA_BUCKETED must be unset: this phase checks the auto choice")
    t0 = time.perf_counter()
    genome = simulate_genome(genome_len, seed=7001)
    rs = simulate_reads(genome, coverage=coverage, read_len=100, seed=7002,
                        tile_k=k)
    sim_s = time.perf_counter() - t0
    cfg = AssemblyConfig(k=k, read_len=100)
    cap = snug_capacity(int(1.2 * genome_len) + 4096)
    rows = stream_merge_rows(rs.num_reads, 100, cfg, table_capacity=cap)
    _check(rows >= BUCKETED_MIN_MERGE_ROWS,
           f"merge rows {rows} < {BUCKETED_MIN_MERGE_ROWS}: flat merge")
    want = [decode_seq(genome)]
    walls = {}
    for run in ("cold", "warm"):
        m = Metrics()
        t0 = time.perf_counter()
        contigs = assemble_tpu(rs.codes, cfg, table_capacity=cap, metrics=m)
        walls[run] = time.perf_counter() - t0
        _check(len(contigs) == 1,
               f"bucketed {run}: {len(contigs)} contigs, want 1")
        _check(contigs_equal(contigs, want),
               f"bucketed {run}: contig != genome")
    stages = {n: round(v, 3) for n, v in m.stages.items()}
    _say(
        f"phase bucketed: ok  genome_mb={genome_len / 1e6:g} "
        f"coverage={coverage:g} reads={rs.num_reads} merge_rows={rows} "
        f"threshold={BUCKETED_MIN_MERGE_ROWS} capacity={cap} "
        f"simulate_s={sim_s:.2f} cold_s={walls['cold']:.2f} "
        f"warm_s={walls['warm']:.2f} "
        f"reads_per_s={rs.num_reads / walls['warm']:.0f} "
        f"stages_s={json.dumps(stages)} peak_gib={_peak_gib(dev)}"
    )


def phase_four(devs) -> None:
    import numpy as np

    import __graft_entry__
    from genome_assembler_tpu.parallel.mesh import build_mesh, mesh_axes
    from genome_assembler_tpu.parallel.pipeline import _run_distributed_step
    from genome_assembler_tpu.utils.config import AssemblyConfig
    from genome_assembler_tpu.utils.simulate import (
        simulate_genome,
        simulate_reads,
    )

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    _say(f"phase dryrun_multichip(4): ok  wall_s={time.perf_counter() - t0:.2f}")

    # each shard of the sharded count table on its own card, each owning
    # a share of the windows that adds up to all of them
    genome = simulate_genome(200_000, seed=11)
    rs = simulate_reads(genome, coverage=20, read_len=100, seed=12)
    cfg = AssemblyConfig(k=31, read_len=100)
    mesh = build_mesh(4)
    _, counts, _ = _run_distributed_step(
        rs.codes, cfg, mesh, None, mesh_axes(mesh), None,
        table_capacity=None,
    )
    shards = counts.addressable_shards
    homes = sorted({s.device.id for s in shards})
    owned = [int(np.asarray(s.data, np.int64).sum()) for s in shards]
    _check(len(homes) == 4, f"sharded table spans devices {homes}")
    _check(min(owned) > 0 and sum(owned) == rs.num_reads * (100 - 31 + 1),
           f"windows owned per card {owned}")
    _say(f"phase placement: ok  devices={homes} windows_owned={owned}")

    scale = os.environ.get("GA_ACCEPT_SCALE", "1.0")
    _say(f"# accept 4 6 (GA_ACCEPT_SCALE={scale})")
    wall = _timed_cli(["accept", "4", "6"])
    _say(
        f"phase accept46: ok  scale={scale} wall_s={wall:.2f} peak_gib="
        + ",".join(_peak_gib(d) for d in devs[:4])
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU distributed path")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    devs = phase_device(4 if args.four else 1)
    if args.four:
        phase_four(devs)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_ecoli(tmp, devs[0])
        phase_accept(devs[0])
        phase_bucketed(devs[0])
    import jax

    _say(f"total_s={time.perf_counter() - t_start:.1f}")
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
