"""Acceptance harness smoke tests (scaled down) + checkpoint/metrics."""

import os

import numpy as np
import pytest

from genome_assembler_tpu.models import acceptance
from genome_assembler_tpu.models.pipeline import (
    assemble_tpu,
    count_reads_device,
    load_table,
    save_table,
)
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.metrics import Metrics
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads


@pytest.fixture(autouse=True)
def small_scale(monkeypatch):
    monkeypatch.setenv("GA_ACCEPT_SCALE", "0.01")


def test_cfg0_passes():
    r = acceptance.accept_cfg0()
    assert r.passed, r.detail


def test_cfg1_passes():
    r = acceptance.accept_cfg1()
    assert r.passed, r.detail


def test_cfg2_scaled_passes():
    r = acceptance.accept_cfg2()
    assert r.passed, r.detail
    assert r.detail["metrics"]["stages_s"]["count"] > 0


def test_cfg4_scaled_passes():
    r = acceptance.accept_cfg4()
    assert r.passed, r.detail
    assert "weak_scaling_eff" in r.detail


def test_checkpoint_resume(tmp_path):
    genome = simulate_genome(1500, seed=61)
    rs = simulate_reads(genome, coverage=20, read_len=100, seed=62)
    cfg = AssemblyConfig(k=25, read_len=100)
    ckpt = str(tmp_path / "table.npz")
    contigs = assemble_tpu(rs.codes, cfg, checkpoint=ckpt)
    assert os.path.exists(ckpt)
    # resume must skip counting and reproduce identical output
    resumed = assemble_tpu(
        np.zeros_like(rs.codes), cfg, resume_from=ckpt
    )
    assert resumed == contigs


def test_table_roundtrip(tmp_path):
    genome = simulate_genome(800, seed=63)
    rs = simulate_reads(genome, coverage=10, read_len=80, seed=64)
    cfg = AssemblyConfig(k=21, read_len=80)
    table = count_reads_device(rs.codes, cfg)
    path = str(tmp_path / "t.npz")
    save_table(table, path)
    loaded = load_table(path)
    np.testing.assert_array_equal(
        np.asarray(table.words), np.asarray(loaded.words)
    )
    np.testing.assert_array_equal(
        np.asarray(table.counts), np.asarray(loaded.counts)
    )
    assert int(table.num_unique) == int(loaded.num_unique)


def test_metrics_report():
    genome = simulate_genome(900, seed=65)
    rs = simulate_reads(genome, coverage=10, read_len=80, seed=66)
    cfg = AssemblyConfig(k=21, read_len=80)
    m = Metrics()
    assemble_tpu(rs.codes, cfg, metrics=m)
    rep = m.report()
    for stage in ("count", "filter", "compress", "spell", "traverse"):
        assert stage in rep["stages_s"], rep
    assert rep["derived"]["kmers_per_s"] > 0
    assert rep["derived"]["count_bytes_per_s"] > 0
    # no device peak on the CPU, so no roofline share
    assert "hbm_roofline_frac" not in rep["derived"]


def test_cfg5_circular_scaled_passes():
    r = acceptance.accept_cfg5()
    assert r.passed, r.detail
    assert r.detail["rotation_exact"]


def test_cfg6_multichromosome_scaled_passes():
    r = acceptance.accept_cfg6()
    assert r.passed, r.detail
    assert r.detail["chromosomes"] == 16
    assert r.detail["per_chromosome_exact"]
    assert r.detail["counts_match_host"]
