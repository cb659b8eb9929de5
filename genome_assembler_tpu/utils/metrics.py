"""Structured per-stage metrics and tracing (SURVEY.md §5 observability).

The reference prints to stdout; this build emits structured per-stage
wall-clock + throughput counters consumable by the bench configs
(BASELINE.md CFG 2-4): k-mers/s, reads/s, bytes/s vs the HBM roofline,
all-to-all volume, weak-scaling efficiency. ``Metrics.stage`` wraps each
pipeline stage; ``jax.profiler.trace`` can be layered on via GA_TRACE_DIR.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field

log = logging.getLogger("genome_assembler_tpu")

# Published HBM bandwidth by JAX ``device_kind`` (NVIDIA H100 data sheet:
# SXM 3.35 TB/s, PCIe 2.0 TB/s).
HBM_PEAK_BYTES_S: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def hbm_peak_bytes_s(device_kind: str) -> float:
    """Published HBM peak of a device kind; an unknown kind is an error."""
    try:
        return HBM_PEAK_BYTES_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published HBM peak for device kind {device_kind!r}"
        ) from None


def _gpu_kind() -> str | None:
    """device_kind of the first device when it is a GPU, else None."""
    import jax

    dev = jax.devices()[0]
    return dev.device_kind if dev.platform == "gpu" else None


@dataclass
class Metrics:
    """Accumulates per-stage timings and counters for one pipeline run."""

    stages: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a pipeline stage; nested stages accumulate independently.

        If GA_TRACE_DIR is set, the stage also appears in a JAX profiler
        trace (viewable in TensorBoard / Perfetto).
        """
        trace_dir = os.environ.get("GA_TRACE_DIR")
        ctx = (
            jax_named_scope(name)
            if trace_dir
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with ctx:
            yield
        dt = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        log.debug("stage %s: %.3fs", name, dt)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def derive(self) -> dict[str, float]:
        """Throughputs derived from counters + timings."""
        out: dict[str, float] = {}
        total = sum(self.stages.values())
        if total > 0:
            if "kmers" in self.counters:
                out["kmers_per_s"] = self.counters["kmers"] / total
            if "reads" in self.counters:
                out["reads_per_s"] = self.counters["reads"] / total
        hosts = self.counters.get("hosts")
        if hosts and hosts > 0 and "reads_per_s" in out:
            # weak-scaling bookkeeping (BASELINE.md): multi-host runs report
            # per-host throughput so efficiency is a config change to read
            out["reads_per_s_per_host"] = out["reads_per_s"] / hosts
        count_s = self.stages.get("count")
        if count_s and "count_bytes" in self.counters:
            out["count_bytes_per_s"] = self.counters["count_bytes"] / count_s
            # a roofline share exists only against a device's own peak
            kind = _gpu_kind()
            if kind is not None:
                out["hbm_roofline_frac"] = (
                    out["count_bytes_per_s"] / hbm_peak_bytes_s(kind)
                )
        return out

    def report(self) -> dict:
        return {
            "stages_s": {k: round(v, 4) for k, v in self.stages.items()},
            "counters": self.counters,
            "derived": {k: round(v, 3) for k, v in self.derive().items()},
        }

    def dump(self, path: str | None = None) -> str:
        text = json.dumps(self.report(), indent=2)
        if path:
            with open(path, "w") as fh:
                fh.write(text + "\n")
        return text


@contextlib.contextmanager
def jax_named_scope(name: str):
    import jax

    with jax.named_scope(name):
        yield


@contextlib.contextmanager
def profiler_trace(trace_dir: str | None = None):
    """Whole-run JAX profiler trace (SURVEY.md §5 tracing)."""
    trace_dir = trace_dir or os.environ.get("GA_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
