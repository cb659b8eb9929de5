"""Device mesh helpers (SURVEY.md §5 distributed backend, §7 M5).

All distribution rides ``jax.sharding.Mesh`` + ``shard_map`` with XLA
collectives — no hand-written transport. Two mesh shapes:

  * 1-level ``('d',)`` over every local device (single host; the layout
    for GPUs of one host, which reach each other all to all);
  * 2-level ``('host', 'chip')`` for multi-node launches, one row per
    process. The counting step's all-to-all runs over the flattened
    ('host', 'chip') tuple axis, so the same code executes on both
    shapes.

Multi-host launch is a config change, not a code change
(``init_distributed``): run the identical command — with the SAME global
reads file; every stage stages inputs via jax.device_put onto global
shardings, which transfers only each process's addressable shards — on
every host with GA_DIST=1 plus GA_COORD_ADDR, GA_NUM_PROCESSES and
GA_PROCESS_ID, e.g.

    GA_DIST=1 ga-tpu assemble --backend dist --reads reads.txt ...

Validated end-to-end by tests/test_multiprocess.py: two coordinated
processes x N CPU devices each run the full dist pipeline (gloo
cross-process collectives) and reproduce the oracle contigs.

Tests exercise both shapes on a forced multi-device CPU platform
(``--xla_force_host_platform_device_count``), per SURVEY.md §4.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_DIST_INITIALIZED = False


def init_distributed() -> bool:
    """Wire up jax.distributed from the environment (GA_DIST=1).

    Set GA_COORD_ADDR (host:port of process 0), GA_NUM_PROCESSES and
    GA_PROCESS_ID; without them ``jax.distributed.initialize()`` relies
    on a cluster environment JAX can detect. Idempotent; returns True when running multi-process.
    """
    global _DIST_INITIALIZED
    if os.environ.get("GA_DIST") != "1":
        return False
    if not _DIST_INITIALIZED:
        try:
            # Cross-process collectives on the CPU backend need gloo
            # (GPUs use NCCL and ignore this knob); must be set before
            # the backend initializes. Validated end-to-end by tests/test_multiprocess.
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:  # pragma: no cover - option renamed/absent
            pass
        kwargs = {}
        if os.environ.get("GA_COORD_ADDR"):
            kwargs = dict(
                coordinator_address=os.environ["GA_COORD_ADDR"],
                num_processes=int(os.environ["GA_NUM_PROCESSES"]),
                process_id=int(os.environ["GA_PROCESS_ID"]),
            )
        jax.distributed.initialize(**kwargs)
        _DIST_INITIALIZED = True
    return True


def build_mesh(
    num_devices: int | None = None,
    axis: str = "d",
    hosts: int | None = None,
) -> Mesh:
    """1-level mesh over local devices, or a 2-level ('host','chip') mesh.

    hosts set: devices (global when jax.distributed is live) reshape to
    [hosts, chips_per_host]. On a multi-node launch pass
    hosts=jax.process_count() so the 'host' axis tracks process
    boundaries; on the forced CPU platform any factorization works (that
    is what the 2-host dryrun fakes).
    """
    devices = jax.devices()
    if hosts is not None:
        n = num_devices or len(devices)
        if n % hosts != 0:
            raise ValueError(
                f"{n} devices do not split evenly over {hosts} hosts"
            )
        if n > len(devices):
            raise ValueError(
                f"requested {n} devices, only {len(devices)} present"
            )
        arr = np.asarray(devices[:n]).reshape(hosts, n // hosts)
        return Mesh(arr, ("host", "chip"))
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} present"
            )
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis,))


def mesh_axes(mesh: Mesh) -> tuple[str, ...]:
    """Every mesh axis, as the tuple collectives flatten over."""
    return tuple(mesh.axis_names)


def axis_size(mesh: Mesh, axes) -> int:
    if isinstance(axes, str):
        return mesh.shape[axes]
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def num_hosts(mesh: Mesh) -> int:
    return mesh.shape["host"] if "host" in mesh.axis_names else 1


def row_sharding(mesh: Mesh, axis: str = "d") -> NamedSharding:
    """Shard the leading (read-batch) dimension across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
