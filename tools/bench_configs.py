"""BASELINE configs 2 and 4 measured driver-style.

config 2: 5Mb chr-scale 30x single-sample, full 3-iteration pipeline.
config 4: 50-sample x 1Mb x 30x cohort.

Simulated inputs cache under $TMPDIR/gt_cfg{2,4}_cache (keyed by recipe in
meta.json) so reruns skip the multi-minute simulation.

Usage: python tools/bench_configs.py [2|4|both]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cached_sim(cache: str, cfg):
    from graphtyper_tpu.utils.simulate import simulate_cohort

    meta_p = os.path.join(cache, "meta.json")
    key = dict(region_length=cfg.region_length, coverage=cfg.coverage,
               n_samples=cfg.n_samples, seed=cfg.seed)
    if os.path.exists(meta_p):
        meta = json.load(open(meta_p))
        if meta.get("key") == key:
            from types import SimpleNamespace

            return SimpleNamespace(fasta=meta["fasta"], sams=meta["sams"],
                                   n_reads=meta["n_reads"])
    os.makedirs(cache, exist_ok=True)
    t0 = time.perf_counter()
    sim = simulate_cohort(os.path.join(cache, "m"), cfg)
    print(f"sim: {time.perf_counter() - t0:.0f}s", flush=True)
    json.dump({"key": key, "fasta": sim.fasta, "sams": list(sim.sams),
               "n_reads": sim.n_reads}, open(meta_p, "w"))
    return sim


def _warm():
    """Compile the device kernels outside the timed window."""
    from graphtyper_tpu.pipeline.genotype import genotype_regions
    from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort

    tmp = tempfile.mkdtemp(prefix="gt_cfgwarm_")
    cfg = SimConfig(region_length=200_000, coverage=30.0, n_samples=1, seed=2,
                    out_format="bam")
    sim = simulate_cohort(os.path.join(tmp, "w"), cfg)
    genotype_regions(sim.fasta, sim.sams, f"{cfg.chrom}:1-200000",
                     os.path.join(tmp, "out"))


def config1():
    """BASELINE config 1: the reference's bundled test/data region
    (reference test/data/reference.fasta analog: tests/data/index_test.fa +
    index_test.vcf.gz prior sites + test.sam), single sample, CPU-runnable.
    Median-of-5 walls — the workload is tiny, so this measures fixed costs
    (graph+index build, worker-free single-process pipeline)."""
    from graphtyper_tpu.pipeline.genotype import genotype_only_with_a_vcf

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fa = os.path.join(root, "tests", "data", "index_test.fa")
    vcf = os.path.join(root, "tests", "data", "index_test.vcf.gz")
    sam = os.path.join(root, "tests", "data", "test.sam")

    walls = []
    for rep in range(5):
        out = tempfile.mkdtemp(prefix="gt_cfg1_")
        t0 = time.perf_counter()
        genotype_only_with_a_vcf(fa, [sam], vcf, "chr1:1-100000", out)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    # what a user actually sees: one cold `graphtyper-tpu genotype` process
    # including interpreter start + imports (VERDICT r4 weak #8)
    import subprocess
    import sys as _sys

    cold = []
    for rep in range(3):
        out = tempfile.mkdtemp(prefix="gt_cfg1_cold_")
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        t0 = time.perf_counter()
        subprocess.run(
            [_sys.executable, "-m", "graphtyper_tpu.cli", "genotype", fa,
             "--sam", sam, "--vcf", vcf, "--region", "chr1:1-100000",
             "--output", out],
            cwd=root, env=env, capture_output=True, timeout=300, check=True,
        )
        cold.append(time.perf_counter() - t0)
    cold.sort()
    print(json.dumps({"config": 1, "wall_s_median": round(walls[2], 3),
                      "wall_s_min": round(walls[0], 3),
                      "cold_process_wall_s_median": round(cold[1], 3)}), flush=True)


def config2():
    from graphtyper_tpu.pipeline.genotype import genotype_regions
    from graphtyper_tpu.utils.simulate import SimConfig

    cfg = SimConfig(region_length=5_000_000, coverage=30.0, n_samples=1, seed=6,
                    out_format="bam")
    sim = _cached_sim(os.path.join(tempfile.gettempdir(), "gt_cfg2_cache"), cfg)
    out = tempfile.mkdtemp(prefix="gt_cfg2_out_")
    t0 = time.perf_counter()
    genotype_regions(sim.fasta, sim.sams, f"{cfg.chrom}:1-5000000", out)
    wall = time.perf_counter() - t0
    print(json.dumps({"config": 2, "wall_s": round(wall, 1),
                      "reads_per_sec": round(sim.n_reads / wall, 1),
                      "s_per_mb": round(wall / 5.0, 2)}), flush=True)


def config4():
    from graphtyper_tpu.pipeline.genotype import genotype_regions
    from graphtyper_tpu.utils.simulate import SimConfig

    cfg = SimConfig(region_length=1_000_000, coverage=30.0, n_samples=50, seed=8,
                    out_format="bam")
    sim = _cached_sim(os.path.join(tempfile.gettempdir(), "gt_cfg4_cache"), cfg)
    out = tempfile.mkdtemp(prefix="gt_cfg4_out_")
    t0 = time.perf_counter()
    genotype_regions(sim.fasta, sim.sams, f"{cfg.chrom}:1-1000000", out)
    wall = time.perf_counter() - t0
    print(json.dumps({"config": 4, "wall_s": round(wall, 1),
                      "reads_per_sec": round(sim.n_reads / wall, 1)}), flush=True)


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    if which == "1":
        config1()  # tiny fixture workload: no warm-up needed
        return
    _warm()
    if which in ("2", "both"):
        config2()
    if which in ("4", "both"):
        config4()


if __name__ == "__main__":
    main()
