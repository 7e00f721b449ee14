"""Absolute end-to-end goldens: fixed simulated workloads must produce
byte-identical VCF record sections (headers excluded — ##fileDate moves)
run over run. The cross-path fuzz (tools/fuzz_diff.py) asserts that every
implementation path agrees; these hashes additionally pin WHAT they agree
on, so silent behavior drift in a refactor fails the suite even when all
paths drift together."""

import gzip
import hashlib
import os

from graphtyper_tpu.pipeline.genotype import genotype_regions
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu.utils.simulate_indep import IndepConfig, simulate_indep

# (records, md5-of-record-lines incl. #CHROM) — regenerate intentionally with
# tools/regen_goldens.py when output-changing behavior is ADDED on purpose.
GOLDEN_SNP = (159, "ae319c6411595f3a3a14dc6a8abd3727")
GOLDEN_INDEP = (272, "b77a4d746fc0e1e3a660eaaada72b603")


def _hash(outs):
    h = hashlib.md5()
    n = 0
    for p in outs:
        with gzip.open(p, "rt") as f:
            for line in f:
                if not line.startswith("##"):
                    h.update(line.encode())
                    n += 1
    return n, h.hexdigest()


def test_golden_snp_cohort(tmp_path):
    cfg = SimConfig(region_length=50_000, coverage=30.0, n_samples=2, seed=7, out_format="bam")
    sim = simulate_cohort(os.path.join(str(tmp_path), "m"), cfg)
    outs = genotype_regions(
        sim.fasta, sim.sams, f"{cfg.chrom}:1-50000", os.path.join(str(tmp_path), "o")
    )
    assert _hash(outs) == GOLDEN_SNP


def test_golden_indep_indel_rich(tmp_path):
    cfg = IndepConfig(region_length=40_000, coverage=25.0, seed=3)
    sim = simulate_indep(os.path.join(str(tmp_path), "i"), cfg)
    outs = genotype_regions(
        sim.fasta, sim.sams, f"{cfg.chrom}:1-40000", os.path.join(str(tmp_path), "io")
    )
    assert _hash(outs) == GOLDEN_INDEP
