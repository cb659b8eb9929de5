"""Latency-amortized primitive microbenchmarks on the GPU.

Timing ONE dispatch per case folds the fixed per-dispatch cost into the
measurement. This tool removes it two ways at once:
  * every case runs ITERS carry-dependent iterations inside ONE jitted
    ``lax.fori_loop`` (XLA cannot elide the body: each iteration's input is
    the previous iteration's output, and sorts are re-perturbed per
    iteration so no iteration is a no-op on already-sorted data);
  * the per-iteration cost is the SLOPE between two iteration counts
    (t(I2) - t(I1)) / (I2 - I1), so any fixed per-dispatch cost — however
    large — cancels exactly.

Cases mirror the counting pipeline's primitives (SURVEY.md §7 M2/M3):
elementwise stream pass (the bandwidth yardstick), cumsum (the scan shape),
lax.sort at the exact operand/key shapes count_jax.count_keys dispatches,
and the data-dependent gather of the pointer-doubling loop.

Run on a GPU machine:
    python tools/microbench_amortized.py [N_log2] [out.json]
(default 1<<24 rows). Prints one JSON line per case and a summary, and
writes them to out.json when given. Fails without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        print(f"microbench_amortized: no GPU (JAX backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    from genome_assembler_tpu.utils.jaxenv import setup

    setup()
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    n = 1 << int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 24
    reps = int(os.environ.get("GA_MB_REPS", 3))
    rng = np.random.default_rng(0)
    results = {}

    def u32():
        return jnp.asarray(
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        )

    def timed_loop(body, init, iters):
        """Best-of-reps wall time of ITERS fori_loop iterations in one jit."""

        def run(c):
            return lax.fori_loop(0, iters, body, c)

        f = jax.jit(run)
        out = f(init)
        jax.block_until_ready(out)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = f(init)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        return min(times)

    def bench(name, body, init, i1, i2, bytes_per_iter=None):
        """Slope-based per-iteration cost between iteration counts i1 < i2."""
        t1 = timed_loop(body, init, i1)
        t2 = timed_loop(body, init, i2)
        per_iter = (t2 - t1) / (i2 - i1)
        rec = {
            "case": name,
            "n": n,
            "iters": [i1, i2],
            "t_i1_s": round(t1, 4),
            "t_i2_s": round(t2, 4),
            "per_iter_s": round(per_iter, 6),
            "ns_per_row": round(per_iter / n * 1e9, 3),
        }
        if bytes_per_iter is not None:
            rec["gb_s"] = round(bytes_per_iter / max(per_iter, 1e-12) / 1e9, 1)
        results[name] = rec
        print(json.dumps(rec))
        return per_iter

    mix = jnp.uint32(2654435761)  # odd multiplier: distinct perturbation/iter

    # --- elementwise stream pass: the bandwidth yardstick (read + write).
    # The body is a data-dependent xor-shift, NOT an affine c+1: an affine
    # body measured an impossible 7 TB/s (XLA unrolls the counted loop and
    # algebraically collapses the add chain), so only a non-collapsible
    # mix measures real HBM traffic.
    def mix_body(i, c):
        return c ^ ((c >> jnp.uint32(15)) + jnp.uint32(1))

    a = u32()
    bench("stream_1op", mix_body, a, 16, 256, bytes_per_iter=2 * 4 * n)
    a2 = jnp.stack([u32(), u32()], axis=1)  # [n,2]: the k=31 key width
    bench("stream_2col", mix_body, a2, 16, 256, bytes_per_iter=2 * 8 * n)

    # --- cumsum: the scan shape behind segment ids / unique compaction
    bench(
        "cumsum_1op",
        lambda i, c: jnp.cumsum(c ^ mix, dtype=jnp.uint32),
        a,
        8,
        64,
        bytes_per_iter=2 * 4 * n,
    )

    # --- sorts at count_keys' exact dispatch shapes. The carry is
    # re-perturbed with a per-iteration odd-multiplier xor so iteration
    # j never sorts already-sorted data.
    def sort1_body(i, c):
        return lax.sort((c ^ (i.astype(jnp.uint32) * mix),), num_keys=1)[0]

    bench("sort_1op_1key", sort1_body, a, 2, 8)

    b = u32()
    c0 = u32()

    def sort2_body(i, cs):
        x, y = cs
        x = x ^ (i.astype(jnp.uint32) * mix)
        x, y = lax.sort((x, y), num_keys=2)
        return x, y

    bench("sort_2op_2key", sort2_body, (a, b), 2, 8)

    def sort3_body(i, cs):
        x, y, z = cs
        x = x ^ (i.astype(jnp.uint32) * mix)
        x, y, z = lax.sort((x, y, z), num_keys=2)
        return x, y, z

    bench("sort_3op_2key", sort3_body, (a, b, c0), 2, 8)

    d0 = u32()

    def sort4_body(i, cs):
        w, x, y, z = cs
        w = w ^ (i.astype(jnp.uint32) * mix)
        return lax.sort((w, x, y, z), num_keys=1)

    bench("sort_4op_1key", sort4_body, (a, b, c0, d0), 2, 8)

    # --- random gather: the pointer-doubling inner loop. Indices derive
    # from the carry itself, so every iteration gathers a fresh pattern.
    assert n & (n - 1) == 0, "gather case assumes power-of-two n"
    nm1 = jnp.uint32(n - 1)

    def gather_body(i, c):
        idx = ((c + i.astype(jnp.uint32)) & nm1).astype(jnp.int32)
        return c[idx]

    bench("gather_rand_1col", gather_body, a, 4, 32,
          bytes_per_iter=3 * 4 * n)

    # Derived comparisons: the sort's cost in stream passes.
    stream_per = results["stream_1op"]["per_iter_s"]
    sort3_per = results["sort_3op_2key"]["per_iter_s"]
    summary = {
        "n": n,
        "stream_bw_gb_s": results["stream_1op"]["gb_s"],
        "sort_3op_2key_ns_per_row": results["sort_3op_2key"]["ns_per_row"],
        "sort_equals_stream_passes": round(sort3_per / max(stream_per, 1e-12), 1),
    }
    print(json.dumps({"summary": summary}))
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as fh:
            json.dump({"n": n, "results": results, "summary": summary}, fh,
                      indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
