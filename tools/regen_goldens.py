"""Recompute the tests/pipeline/test_golden_e2e.py hashes after an
intentional output-changing change. Prints the new (records, md5) tuples;
update the GOLDEN_* constants by hand so the change is explicit in review."""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from graphtyper_tpu.pipeline.genotype import genotype_regions
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu.utils.simulate_indep import IndepConfig, simulate_indep
from tests.pipeline.test_golden_e2e import _hash

tmp = tempfile.mkdtemp(prefix="gt_golden_")
cfg = SimConfig(region_length=50_000, coverage=30.0, n_samples=2, seed=7, out_format="bam")
sim = simulate_cohort(os.path.join(tmp, "m"), cfg)
outs = genotype_regions(sim.fasta, sim.sams, f"{cfg.chrom}:1-50000", os.path.join(tmp, "o"))
print("GOLDEN_SNP =", _hash(outs))
icfg = IndepConfig(region_length=40_000, coverage=25.0, seed=3)
ind = simulate_indep(os.path.join(tmp, "i"), icfg)
iouts = genotype_regions(ind.fasta, ind.sams, f"{icfg.chrom}:1-40000", os.path.join(tmp, "io"))
print("GOLDEN_INDEP =", _hash(iouts))
