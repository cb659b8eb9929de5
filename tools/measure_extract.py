"""Extraction's share of the single-batch counting program, on the GPU.

Decides whether k-mer extraction deserves a hand-written kernel: it times
XLA's ``extract_canonical_flat`` alone and the whole ``_count_batch``
program (extract + sort + segment-reduce) at the CFG-2 single-batch shape
(262,144 reads x 100 bp, k=31), then takes extraction's share of the
program's device time from a profiler trace. Device events are attributed
through the compiled HLO: an event whose ``hlo_op`` instruction carries the
``extract`` name scope (models.pipeline._extract_keys) counts as
extraction. Also records which sort implementation each counting program's
HLO got (XLA's own ``sort`` or a CUB radix-sort custom call) and the
program's scratch memory.

Run from the repo root on a GPU machine:
    python tools/measure_extract.py [out.json]
Prints one JSON object; fails without a GPU.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Per-kernel device events: by default XLA replays a program as one CUDA
# graph, which the profiler shows as a single command_buffer event.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
).strip()

_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*op_name=\"([^\"]*)\""
)


def hlo_op_names(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> its metadata op_name (name-scope path)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def sort_kinds(hlo_text: str) -> dict[str, int]:
    """How the program's sorts were lowered: XLA sort ops vs CUB calls."""
    return {
        "xla_sort": len(re.findall(r"=\s*\([^=]*\)\s*sort\(|=\s*\S+\s+sort\(",
                                   hlo_text)),
        "cub_radix_sort": len(re.findall(r"DeviceRadixSort", hlo_text)),
    }


def device_op_times(trace_dir: str) -> dict[str, float]:
    """Summed device nanoseconds per hlo_op over every GPU plane."""
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    times: dict[str, float] = defaultdict(float)
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                times[str(stats.get("hlo_op", ev.name))] += ev.duration_ns
    return dict(times)


def _best(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        print(f"measure_extract: no GPU (JAX backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    from genome_assembler_tpu.utils.jaxenv import setup

    setup()
    import numpy as np

    from genome_assembler_tpu.models.pipeline import _count_batch, _stream_step
    from genome_assembler_tpu.ops import count_jax
    from genome_assembler_tpu.ops.kmer_jax import (
        extract_canonical_flat,
        unpack_codes,
    )
    from genome_assembler_tpu.utils.config import AssemblyConfig
    from genome_assembler_tpu.utils.dna import key_words, pack_codes
    from genome_assembler_tpu.utils.simulate import (
        preset_genome,
        simulate_reads,
    )

    k, read_len = 31, 100
    batch = AssemblyConfig(k=k, read_len=read_len).batch_reads
    rs = simulate_reads(preset_genome("ecoli"), coverage=6, read_len=read_len,
                        seed=1)
    reads = rs.codes[:batch]
    assert reads.shape[0] == batch, reads.shape
    packed = jax.device_put(pack_codes(reads))
    nv = np.int32(batch)
    windows = batch * (read_len - k + 1)

    extract = jax.jit(
        lambda p: extract_canonical_flat(unpack_codes(p, read_len), k, nv)[0]
    )
    def count(p):
        # the jitted program itself, so trace events carry its HLO names
        return _count_batch(p, k, nv, read_len=read_len)

    extract_s = _best(extract, packed)
    count_s = _best(count, packed)

    lowered = _count_batch.lower(packed, k, nv, read_len=read_len)
    compiled = lowered.compile()
    hlo = compiled.as_text()
    mem = compiled.memory_analysis()

    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for _ in range(3):
                jax.block_until_ready(count(packed))
        op_ns = device_op_times(td)
    names = hlo_op_names(hlo)
    total_ns = sum(op_ns.values())
    extract_ns = sum(
        t for op, t in op_ns.items() if "/extract/" in names.get(op, "")
    )
    top = sorted(op_ns.items(), key=lambda kv: -kv[1])[:12]

    cap = count_jax.snug_capacity(int(1.1 * 4_641_652) + 4096)
    table = count_jax.empty_table(cap, key_words(k))
    step_hlo = _stream_step.lower(
        table, packed, k, nv, read_len=read_len, out_cap=cap
    ).compile().as_text()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    result = {
        "gpu": smi,
        "xla_flags": os.environ["XLA_FLAGS"],
        "device_kind": jax.devices()[0].device_kind,
        "shape": {"reads": batch, "read_len": read_len, "k": k,
                  "windows": windows},
        "extract_xla_s": extract_s,
        "count_batch_s": count_s,
        "extract_over_count_batch_wall": extract_s / count_s,
        "trace_device_ns_count_batch_x3": total_ns,
        "trace_extract_ns": extract_ns,
        "extract_share_of_device_time": (
            extract_ns / total_ns if total_ns else None
        ),
        "top_device_ops": [
            {"hlo_op": op, "ns": t, "op_name": names.get(op, "")[-120:]}
            for op, t in top
        ],
        "sort_kinds": {
            "count_batch": sort_kinds(hlo),
            "stream_step_merge": sort_kinds(step_hlo),
        },
        "count_batch_temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "count_batch_argument_bytes": getattr(
            mem, "argument_size_in_bytes", None
        ),
        "count_batch_output_bytes": getattr(mem, "output_size_in_bytes", None),
    }
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])),
                    exist_ok=True)
        with open(sys.argv[1], "w") as fh:
            json.dump(result, fh, indent=1)
        with open(sys.argv[1] + ".hlo.txt", "w") as fh:
            fh.write(hlo)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
