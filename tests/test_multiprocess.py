"""True multi-process launch validation (SURVEY.md §5 distributed
backend): two coordinated processes x 2 CPU devices each run the FULL
distributed pipeline over a 2-level ('host','chip') mesh with gloo
cross-process collectives — the CPU stand-in for a multi-node
launch — and must reproduce the oracle contigs bit for bit.

This is the end-to-end check of the GA_DIST wiring: coordinator
bring-up before any backend touch (utils.jaxenv.setup), global-array
staging via per-process addressable shards (jax.device_put), and
process_allgather host pulls (utils.jaxenv.to_host).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

from genome_assembler_tpu.host.traverse import contigs_equal
from genome_assembler_tpu.models.oracle import assemble_oracle
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import decode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(tmp_path, reads_file, pid, nproc, port, extra):
    env = dict(os.environ)
    env.update(
        GA_DIST="1",
        GA_COORD_ADDR=f"localhost:{port}",
        GA_NUM_PROCESSES=str(nproc),
        GA_PROCESS_ID=str(pid),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
    )
    out = tmp_path / f"contigs_p{pid}.fa"
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "genome_assembler_tpu.cli", "assemble",
            "--reads", str(reads_file), "-k", "25", "--backend", "dist",
            "--out", str(out), *extra,
        ],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )
    return proc, out


def test_two_process_pod_launch_matches_oracle(tmp_path):
    genome = simulate_genome(4000, seed=71)
    rs = simulate_reads(genome, coverage=12, read_len=80, seed=72)
    reads_file = tmp_path / "reads.txt"
    reads_file.write_text(
        "\n".join(decode_seq(r) for r in rs.codes) + "\n"
    )

    port = _free_port()
    nproc = 2
    # --hosts defaults to jax.process_count() under GA_DIST, so this
    # exercises the 2-level ('host','chip') mesh with the host axis on
    # real process boundaries; --sharded-graph keeps the graph sharded
    # end to end (the flagship pod configuration).
    procs = [
        _launch(tmp_path, reads_file, p, nproc, port, ["--sharded-graph"])
        for p in range(nproc)
    ]
    outs = []
    for proc, out in procs:
        try:
            _, err = proc.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for p2, _ in procs:
                p2.kill()
            raise
        assert proc.returncode == 0, err[-3000:]
        outs.append(out)

    from genome_assembler_tpu.cli import read_sequences

    contig_sets = [read_sequences(str(o)) for o in outs]
    assert contig_sets[0] == contig_sets[1]  # every host writes the same
    cfg = AssemblyConfig(k=25, read_len=80)
    assert contig_sets[0] == assemble_oracle(rs.codes, cfg)
    assert contigs_equal(contig_sets[0], [decode_seq(genome)])
