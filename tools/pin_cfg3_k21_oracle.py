"""One-off provenance run: pin CFG-3 k=21 to the oracle at FULL scale
(VERDICT r4 weak item 5 / r5 item 6).

CFG-3 k=21 is the one acceptance cell where assembly is genuinely
ambiguous (repeats longer than k-1 induce branching, 41 contigs at full
scale) — and therefore the one whose pass previously rested on the
weaker exact-k-mer-content bar. This tool reproduces the exact CFG-3
read set (acceptance._run_single: genome seed 1040, read seed 1041,
4,641,652 bases x 200x, len-100, tile_k), assembles with the production
pipeline AND the host oracle, and records whether the contig SETS are
equal — converting the cell's provenance from "k-mer content equal" to
"reference-equivalent contig set equal" (BASELINE.md:13).

Run: python tools/pin_cfg3_k21_oracle.py [k]   (default 21)
Writes tools/pin_cfg3_k21_oracle_result.json.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from genome_assembler_tpu.utils import jaxenv

jaxenv.setup()


def main() -> int:
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 21
    import jax

    from genome_assembler_tpu.host.traverse import kmer_content_equal
    from genome_assembler_tpu.models.oracle import assemble_oracle
    from genome_assembler_tpu.models.pipeline import (
        SINGLE_SHOT_WINDOWS,
        assemble_tpu,
    )
    from genome_assembler_tpu.ops.count_jax import snug_capacity
    from genome_assembler_tpu.utils.config import AssemblyConfig
    from genome_assembler_tpu.utils.dna import decode_seq
    from genome_assembler_tpu.utils.simulate import (
        simulate_genome,
        simulate_reads,
    )

    genome_len, coverage = 4_641_652, 200
    genome = simulate_genome(genome_len, seed=1040)
    rs = simulate_reads(
        genome, coverage=coverage, read_len=100, seed=1041, tile_k=k
    )
    cfg = AssemblyConfig(k=k, min_count=1, read_len=100)
    total_windows = rs.num_reads * (100 - k + 1)
    capacity = (
        None if total_windows <= SINGLE_SHOT_WINDOWS
        else snug_capacity(int(1.1 * genome_len) + 4096)
    )
    t0 = time.time()
    contigs = assemble_tpu(rs.codes, cfg, table_capacity=capacity)
    pipeline_s = time.time() - t0
    print(f"# pipeline: {len(contigs)} contigs in {pipeline_s:.0f}s "
          f"[{jax.devices()[0].platform}]", file=sys.stderr, flush=True)
    t0 = time.time()
    oracle = assemble_oracle(rs.codes, cfg)
    oracle_s = time.time() - t0
    result = {
        "what": "CFG-3 k=%d full-scale contig-set equality vs oracle" % k,
        "date": datetime.date.today().isoformat(),
        "k": k,
        "genome_len": genome_len,
        "coverage": coverage,
        "reads": rs.num_reads,
        "platform": jax.devices()[0].platform,
        "pipeline_contigs": len(contigs),
        "oracle_contigs": len(oracle),
        "contig_sets_equal": contigs == oracle,
        "kmer_content_equal_vs_genome": kmer_content_equal(
            contigs, decode_seq(genome), k
        ),
        "pipeline_wall_s": round(pipeline_s, 1),
        "oracle_wall_s": round(oracle_s, 1),
    }
    out = os.path.join(os.path.dirname(__file__),
                       f"pin_cfg3_k{k}_oracle_result.json")
    with open(out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)
    return 0 if result["contig_sets_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
