"""Platform rules that hold without a GPU: the compile-cache location, the
peak table, the streaming merge-row rule, and the GPU-only entry points
refusing to run (or print a number) elsewhere."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from genome_assembler_tpu.utils import jaxenv
from genome_assembler_tpu.utils.metrics import hbm_peak_bytes_s

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture
def fresh_setup(monkeypatch):
    """jaxenv.setup() as on first use; restores JAX's cache setting."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(jaxenv, "_DONE", False)
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_honours_env(monkeypatch, fresh_setup, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    jaxenv.setup()
    assert jaxenv.cache_dir() == str(tmp_path)
    # set in the environment: JAX's own setting, no other directory
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch, fresh_setup):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxenv.setup()
    want = os.path.join(REPO, ".jax_cache")
    assert jaxenv.cache_dir() == want == jaxenv.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == want
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize(
    "kind,peak",
    [("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12)],
)
def test_peak_table_known_kinds(kind, peak):
    assert hbm_peak_bytes_s(kind) == peak


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published HBM peak"):
        hbm_peak_bytes_s(kind)


def test_stream_merge_rows_rule():
    from genome_assembler_tpu.models.pipeline import stream_merge_rows
    from genome_assembler_tpu.utils.config import AssemblyConfig

    cfg = AssemblyConfig(k=21, read_len=60, batch_reads=256)
    bw = 256 * 40
    assert stream_merge_rows(600, 60, cfg, table_capacity=1000) == 1000 + bw
    assert stream_merge_rows(
        600, 60, cfg, table_capacity=1000, merge_stride=2
    ) == 1000 + 2 * bw
    # one batch: nothing to defer, the stride does not widen the merge
    assert stream_merge_rows(
        200, 60, cfg, table_capacity=1000, merge_stride=2
    ) == 1000 + bw


def _run_without_gpu(argv, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *argv], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    out = _run_without_gpu([script], REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert out.stdout.strip() == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_without_gpu(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
