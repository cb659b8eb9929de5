"""Benchmark harness: canonical k-mer counting throughput on one GPU.

Prints ONE JSON line:
  {"metric": "kmer_count_throughput", "value": <kmers/s>, "unit": "kmers/s",
   "vs_baseline": <speedup vs the reference-style Python dict counter>, ...}

The primary metric is the north-star inner loop (BASELINE.json: "k-mers
counted/s/chip"): extraction + canonicalization + sort/segment-reduce
counting of a CFG-2-shaped simulated read set on one device. ``vs_baseline``
is the measured speedup over the reference assembler's counting hot loop
(a straight Python dict-upsert per window, SURVEY.md §3.3) on the same
machine — the reference publishes no numbers of its own (BASELINE.md), so
its own implementation is the baseline to beat.

Fails, printing no number, when JAX finds no GPU.

Env knobs: GA_BENCH_GENOME (bases), GA_BENCH_COVERAGE, GA_BENCH_K,
GA_BENCH_REPS, GA_BENCH_BASELINE_WINDOWS.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        print(
            f"bench: no GPU found (JAX backend is {jax.default_backend()!r});"
            " the benchmark measures the GPU only",
            file=sys.stderr,
        )
        return 1

    from genome_assembler_tpu.utils.jaxenv import setup

    setup()

    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from genome_assembler_tpu.models.oracle import count_canonical_dict
    from genome_assembler_tpu.models.pipeline import (
        _count_batch,
        count_reads_device,
    )
    from genome_assembler_tpu.utils.config import AssemblyConfig
    from genome_assembler_tpu.utils.dna import key_words, pack_codes
    from genome_assembler_tpu.utils.metrics import hbm_peak_bytes_s
    from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads

    dev = jax.devices()[0]
    genome_len = int(os.environ.get("GA_BENCH_GENOME", 1_000_000))
    coverage = float(os.environ.get("GA_BENCH_COVERAGE", 25))
    k = int(os.environ.get("GA_BENCH_K", 31))
    reps = int(os.environ.get("GA_BENCH_REPS", 3))
    read_len = 100

    genome = simulate_genome(genome_len, seed=11)
    rs = simulate_reads(
        genome, coverage=coverage, read_len=read_len, seed=12
    )
    reads = rs.codes
    n_windows = reads.shape[0] * (read_len - k + 1)
    cfg = AssemblyConfig(k=k, read_len=read_len)

    # The counting metric is k-mers counted/s/device (BASELINE.md): reads
    # are staged on device before the timed region; the host-to-device
    # copy is reported separately.
    packed = pack_codes(reads)
    jax.block_until_ready(jax.device_put(np.zeros(8, np.int32)))
    t0 = time.perf_counter()
    reads_dev = jax.block_until_ready(jax.device_put(packed))
    transfer_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    table = jax.block_until_ready(
        _count_batch(reads_dev, k, np.int32(reads.shape[0]),
                     read_len=read_len)
    )
    warmup_s = time.perf_counter() - t0

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        table = jax.block_until_ready(
            _count_batch(reads_dev, k, np.int32(reads.shape[0]),
                         read_len=read_len)
        )
        times.append(time.perf_counter() - t0)
    best = min(times)
    kmers_per_s = n_windows / best

    def _timed_once(f, init):
        t0 = time.perf_counter()
        jax.block_until_ready(f(init))
        return time.perf_counter() - t0

    def _slope(body, init, i1, i2):
        """Per-iteration seconds from the slope between two loop lengths:
        carry-dependent iterations inside one jitted fori_loop, so any
        fixed per-dispatch cost cancels."""
        t = []
        for iters in (i1, i2):
            f = jax.jit(
                lambda c, n=iters: lax.fori_loop(0, n, body, c)
            )
            jax.block_until_ready(f(init))
            t.append(min(_timed_once(f, init) for _ in range(max(2, reps))))
        return (t[1] - t[0]) / (i2 - i1)

    # Achievable stream bandwidth: a data-dependent xor-shift pass (an
    # affine c+1 gets unrolled and algebraically collapsed by XLA).
    w = key_words(k)
    big = jnp.zeros((n_windows, w), jnp.uint32)

    def _mix_body(i, c):
        return c ^ ((c >> jnp.uint32(15)) + jnp.uint32(1))

    stream_amortized_s = _slope(_mix_body, big, 8, 64)
    measured_bw_amortized = 2 * n_windows * w * 4 / max(
        stream_amortized_s, 1e-9
    )

    # Sort floor: count_jax.count_keys is two lax.sort calls on this
    # volume (a W-key sort of the key stream + the masked-key compaction
    # sort, W keys + 1 position payload) plus elementwise scans that fuse
    # into them. Timing those two sorts alone on identical shapes gives
    # the achievable bound for any sort-based counter.
    rng_np = np.random.default_rng(3)
    acols = [
        jnp.asarray(
            rng_np.integers(0, 2**32, n_windows, dtype=np.uint64).astype(
                np.uint32
            )
        )
        for _ in range(w + 1)
    ]
    mixc = jnp.uint32(2654435761)

    def _sort_body(i, cs):
        xs = (cs[0] ^ (i.astype(jnp.uint32) * mixc),) + cs[1:]
        return jax.lax.sort(xs, num_keys=w)

    sort1_am = _slope(_sort_body, tuple(acols[:w]), 2, 6)
    sort2_am = _slope(_sort_body, tuple(acols), 2, 6)
    sort_floor_amortized_s = sort1_am + sort2_am

    # Streaming-mode counting on the same workload: batches stream through
    # merge_raw_keys with prefetched uploads. Timed host-to-table (pack +
    # transfer included) for both modes. Capacity is genome-sized (snug),
    # forcing the real streamed path; two batches exercise the merge.
    from genome_assembler_tpu.ops.count_jax import snug_capacity

    stream_batch = max(256, -(-reads.shape[0] // 512) * 256)
    stream_cfg = AssemblyConfig(
        k=k, read_len=read_len, batch_reads=stream_batch
    )
    stream_cap = snug_capacity(int(table.num_unique))

    def timed_count(fn):
        jax.block_until_ready(fn())  # warm (compile)
        return min(_timed_once(lambda _: fn(), None) for _ in range(reps))

    stream_count_s = timed_count(
        lambda: count_reads_device(
            reads, stream_cfg, table_capacity=stream_cap
        )
    )
    single_s = timed_count(
        lambda: _count_batch(
            jax.device_put(pack_codes(reads)), k,
            np.int32(reads.shape[0]), read_len=read_len,
        )
    )

    # Reference-style Python dict counting rate on a subsample.
    base_windows = int(os.environ.get("GA_BENCH_BASELINE_WINDOWS", 200_000))
    wpr = read_len - k + 1
    n_base_reads = max(1, base_windows // wpr)
    t0 = time.perf_counter()
    count_canonical_dict(reads[:n_base_reads], k)
    base_s = time.perf_counter() - t0
    base_rate = (n_base_reads * wpr) / base_s

    # End-to-end assembly on the same workload (count + filter + device
    # unitig compression + host residue): one cold pass compiles every
    # stage's shapes; the best of `reps` warm passes is the steady state.
    from genome_assembler_tpu.host.stats import contig_stats
    from genome_assembler_tpu.host.traverse import contigs_equal
    from genome_assembler_tpu.models.pipeline import assemble_tpu
    from genome_assembler_tpu.utils.dna import decode_seq
    from genome_assembler_tpu.utils.metrics import Metrics

    mm_cold = Metrics()
    t0 = time.perf_counter()
    contigs = assemble_tpu(reads, cfg, metrics=mm_cold)
    asm_cold_s = time.perf_counter() - t0
    asm_s = None
    for _ in range(reps):
        mm_i = Metrics()
        t0 = time.perf_counter()
        contigs = assemble_tpu(reads, cfg, metrics=mm_i)
        dt = time.perf_counter() - t0
        if asm_s is None or dt < asm_s:
            asm_s, mm = dt, mm_i
    stats = contig_stats(contigs)
    exact = contigs_equal(contigs, [decode_seq(genome)])

    # Minimal-traffic HBM model for the roofline share: read bytes in +
    # one key-stream write + one sorted read-back.
    min_bytes = packed.size + 2 * n_windows * w * 4
    achieved_bw = min_bytes / best

    result = {
        "metric": "kmer_count_throughput",
        "value": kmers_per_s,
        "unit": "kmers/s",
        "vs_baseline": kmers_per_s / base_rate,
        "detail": {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "k": k,
            "reads": int(reads.shape[0]),
            "windows": int(n_windows),
            "best_s": best,
            "warmup_s": warmup_s,
            "host_to_device_s": transfer_s,
            "reference_python_kmers_per_s": base_rate,
            "min_traffic_roofline_frac": (
                achieved_bw / hbm_peak_bytes_s(dev.device_kind)
            ),
            "measured_stream_bw_amortized_gb_s": measured_bw_amortized / 1e9,
            "frac_of_amortized_bw": achieved_bw / measured_bw_amortized,
            "sort_floor_amortized_s": sort_floor_amortized_s,
            "sort_ns_per_row_amortized": (
                sort_floor_amortized_s / n_windows * 1e9
            ),
            "frac_of_amortized_sort_floor": sort_floor_amortized_s / best,
            "stream_count_s": stream_count_s,
            "single_shot_with_transfer_s": single_s,
            "stream_vs_single_shot": stream_count_s / single_s,
            "assemble_s": asm_s,
            "assemble_reads_per_s": reads.shape[0] / asm_s,
            "assemble_stages_s": dict(mm.stages),
            "assemble_cold_s": asm_cold_s,
            "assemble_cold_stages_s": dict(mm_cold.stages),
            "contigs": stats["contigs"],
            "n50": stats["n50"],
            "exact_match": exact,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
