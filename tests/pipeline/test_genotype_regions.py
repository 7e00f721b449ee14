"""genotype_regions: the 50kb split.

The reference genotypes in <=50kb units (genotype.cpp:683-741,
main.cpp:30-58); ours runs the units one after the other in the process
that owns the device. Each unit's output must equal genotyping that unit on
its own, and a second call over a prefix must agree with the first.
"""

import gzip
import os

from graphtyper_tpu.pipeline import genotype as G
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort


def _vcf_text(path):
    with gzip.open(path, "rt") as f:
        return [l for l in f if not l.startswith("##")]


def test_pooled_regions_match_serial(tmp_path):
    cfg = SimConfig(region_length=120_000, coverage=18.0, n_samples=2, seed=13, out_format="bam")
    sim = simulate_cohort(str(tmp_path / "sim"), cfg)
    region = f"{cfg.chrom}:1-{cfg.region_length}"

    split = G.genotype_regions(sim.fasta, sim.sams, region, str(tmp_path / "split"))
    assert [os.path.basename(p) for p in split] == [
        "000000001-000050000.vcf.gz",
        "000050001-000100000.vcf.gz",
        "000100001-000120000.vcf.gz",
    ]
    one = G.genotype(sim.fasta, sim.sams, f"{cfg.chrom}:50001-100000", str(tmp_path / "one"))
    assert os.path.basename(one) == os.path.basename(split[1])
    assert _vcf_text(one) == _vcf_text(split[1])

    # a second call (state left by the first: native caches, compiled
    # kernels) must still agree
    again = G.genotype_regions(
        sim.fasta, sim.sams, f"{cfg.chrom}:1-100000", str(tmp_path / "again")
    )
    assert len(again) == 2
    for a, b in zip(split, again):
        assert _vcf_text(a) == _vcf_text(b)
