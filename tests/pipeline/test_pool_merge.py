"""Cohort-scale pool machinery: batched pool serialization round-trips, the
streaming cross-pool merge equals the in-memory merge, and a multi-pool
genotype run produces the identical VCF to the single-pool run."""

import gzip

import numpy as np
import pytest

from graphtyper_tpu.config import current_options, replace, set_options
from graphtyper_tpu.typer.vcf_out import VcfOutput
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort


def test_batched_roundtrip(tmp_path):
    from graphtyper_tpu.typer.sample_call import SampleCall
    from graphtyper_tpu.typer.variant import Variant

    vcf = VcfOutput(sample_names=["s1", "s2"])
    rng = np.random.default_rng(0)
    for i in range(137):
        v = Variant(abs_pos=100 + i, seqs=[b"A", b"C", b"G"][: 2 + i % 2])
        for _ in range(2):
            cnum = len(v.seqs)
            v.calls.append(
                SampleCall(
                    phred=rng.integers(0, 99, size=cnum * (cnum + 1) // 2),
                    coverage=rng.integers(0, 30, size=cnum),
                )
            )
        vcf.variants.append(v)
    path = str(tmp_path / "pool.vcfb")
    vcf.save_batched(path, num_alleles_in_batch=25)
    names, gen = VcfOutput.open_batched(path)
    assert names == ["s1", "s2"]
    got = [v for batch in gen for v in batch]
    assert len(got) == 137
    for a, b in zip(vcf.variants, got):
        assert a.abs_pos == b.abs_pos and a.seqs == b.seqs
        for ca, cb in zip(a.calls, b.calls):
            np.testing.assert_array_equal(ca.phred, cb.phred)


def test_streamed_merge_equals_in_memory(tmp_path):
    import copy

    from graphtyper_tpu.pipeline.vcf_operations import vcf_merge, vcf_merge_streamed
    from graphtyper_tpu.typer.sample_call import SampleCall
    from graphtyper_tpu.typer.variant import Variant

    rng = np.random.default_rng(7)
    pools = []
    for p in range(3):
        vcf = VcfOutput(sample_names=[f"p{p}s{j}" for j in range(2)])
        for i in range(61):
            v = Variant(abs_pos=50 + i, seqs=[b"A", b"T"])
            for _ in range(2):
                v.calls.append(
                    SampleCall(phred=rng.integers(0, 99, size=3), coverage=rng.integers(0, 30, size=2))
                )
            vcf.variants.append(v)
        pools.append(vcf)

    paths = []
    for p, vcf in enumerate(pools):
        path = str(tmp_path / f"p{p}.vcfb")
        vcf.save_batched(path, num_alleles_in_batch=10)
        paths.append(path)

    ref = vcf_merge(copy.deepcopy(pools))
    names, gen = vcf_merge_streamed(paths)
    got = list(gen)
    assert names == ref.sample_names
    assert len(got) == len(ref.variants)
    for a, b in zip(ref.variants, got):
        assert len(a.calls) == len(b.calls) == 6
        for ca, cb in zip(a.calls, b.calls):
            np.testing.assert_array_equal(ca.phred, cb.phred)


def test_multi_pool_genotype_identical(tmp_path):
    """6 samples forced into 3 pools (max_files_open=2) must genotype to the
    byte-identical VCF of the single-pool run (incl. merged phasing maps)."""
    from graphtyper_tpu.pipeline.genotype import genotype

    cfg = SimConfig(region_length=5000, coverage=14.0, n_samples=6, seed=51)
    sim = simulate_cohort(str(tmp_path / "sim"), cfg)

    old = current_options()
    try:
        set_options(replace(old, max_files_open=864))
        out1 = genotype(sim.fasta, sim.sams, f"{cfg.chrom}:1-5000", str(tmp_path / "o1"))
        set_options(replace(old, max_files_open=2))
        out2 = genotype(sim.fasta, sim.sams, f"{cfg.chrom}:1-5000", str(tmp_path / "o2"))
    finally:
        set_options(old)

    def body(p):
        return [l for l in gzip.open(p, "rt").read().splitlines() if not l.startswith("#")]

    b1, b2 = body(out1), body(out2)
    assert len(b1) > 0
    assert b1 == b2


def test_threaded_pools_identical(tmp_path):
    """Thread-parallel pools (opts.threads > 1) produce the byte-identical
    VCF to the serial single-pool run."""
    from graphtyper_tpu.pipeline.genotype import genotype

    cfg = SimConfig(region_length=5000, coverage=12.0, n_samples=6, seed=53, out_format="bam")
    sim = simulate_cohort(str(tmp_path / "sim"), cfg)
    old = current_options()
    try:
        set_options(replace(old, threads=1, max_files_open=864))
        out1 = genotype(sim.fasta, sim.sams, f"{cfg.chrom}:1-5000", str(tmp_path / "o1"))
        set_options(replace(old, threads=3, max_files_open=864))
        out2 = genotype(sim.fasta, sim.sams, f"{cfg.chrom}:1-5000", str(tmp_path / "o2"))
    finally:
        set_options(old)

    def body(p):
        return [l for l in gzip.open(p, "rt").read().splitlines() if not l.startswith("#")]

    b1, b2 = body(out1), body(out2)
    assert len(b1) > 0
    assert b1 == b2


def test_concurrent_pools_survive_prep_eviction(tmp_path, monkeypatch):
    """Pools called concurrently on threads share the prepared-pool cache;
    with room for one entry every insert evicts a handle that another
    thread may still be using. Output must stay byte-identical to the
    single-thread run (entries free their handle only when the last user
    lets go)."""
    from graphtyper_tpu.pipeline import native_caller
    from graphtyper_tpu.pipeline.genotype import genotype

    cfg = SimConfig(region_length=5000, coverage=12.0, n_samples=6, seed=57, out_format="bam")
    sim = simulate_cohort(str(tmp_path / "sim"), cfg)
    old = current_options()
    try:
        set_options(replace(old, threads=1, max_files_open=864))
        out1 = genotype(sim.fasta, sim.sams, f"{cfg.chrom}:1-5000", str(tmp_path / "o1"))
        monkeypatch.setattr(native_caller, "_PREP_CACHE_MAX", 1)
        set_options(replace(old, threads=3, max_files_open=2))
        out2 = genotype(sim.fasta, sim.sams, f"{cfg.chrom}:1-5000", str(tmp_path / "o2"))
    finally:
        set_options(old)

    def body(p):
        return [l for l in gzip.open(p, "rt").read().splitlines() if not l.startswith("#")]

    assert len(body(out1)) > 0
    assert body(out1) == body(out2)
