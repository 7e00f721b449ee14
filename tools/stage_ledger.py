"""Per-stage wall-clock ledger + Amdahl bound for the genotype pipeline.

Runs a single-process 200kb 30x workload under cProfile, buckets cumulative
time into pipeline stages, marks each stage host-only vs device-eligible
(has a device implementation wired in production), and prints one JSON blob
with the measured device-eligible fraction and the implied ceiling on
whole-pipeline speedup from accelerating those stages (Amdahl).

On SNP-dominated short-read workloads the hot path is the host C++ caller
loop (alignment + observation extraction), so the device's leverage is
bounded no matter how fast the kernels are. Cohort-scale scoring shifts
the fraction up.

Usage: python tools/stage_ledger.py [--indep] [--samples N] [--kb K]
(--samples N measures an N-sample cohort — the regime where scoring and
 discovery fan-out dominate; default 1 sample x 200kb)
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

# stage -> (pattern of file:func in pstats keys, device-eligible?)
STAGES = [
    ("bamshrink", [("pipeline/bamshrink.py", "run_bamshrink")], False),
    ("discovery_first_pass", [("typer/discovery.py", "streamlined_discovery")], False),
    ("fp_aggregation_device", [("ops/discovery_pileup.py", "aggregate_rows")], True),
    ("graph_build", [("graph/build.py", "construct_graph")], False),
    ("kmer_index", [("index/build.py", "index_graph")], False),
    # align+score: the native caller call; its device-eligible inner parts are
    # measured separately below and subtracted
    ("align_genotype_host", [("pipeline/caller.py", "call_pools")], False),
    ("site_scoring_device", [("ops/site_scoring.py", "finalize")], True),
    ("sw_realign", [("ops/sw", "")], False),
    ("merge_decompose", [
        ("pipeline/vcf_operations.py", "vcf_merge_and_break"),
        ("pipeline/vcf_operations.py", "vcf_merge_and_filter"),
    ], False),
    ("vcf_write", [("typer/vcf_out.py", "write")], False),
]


def _native_profile_seed_s(stderr_text: str) -> dict:
    """Parse the GT_NATIVE_PROFILE per-call lines. The seed/lattice/walk
    numbers are THREAD-SUMS, so the seed's wall-clock share is stage1's wall
    apportioned by the seed fraction of the thread-sum (valid here: the
    ledger runs its regions serially). The seed stage has a
    production device twin (ops/seed_probe.py, device_seed='on')."""
    import re

    out = {"seed_s": 0.0, "stage1_s": 0.0}
    for m in re.finditer(
        r"\[gt_native\].*?stage1=([\d.]+)s stage2=[\d.]+s "
        r"\(thread-sum: seed=([\d.]+)s lattice=([\d.]+)s walk=([\d.]+)s",
        stderr_text,
    ):
        stage1 = float(m.group(1))
        seed, lattice, walk = (float(m.group(k)) for k in (2, 3, 4))
        denom = seed + lattice + walk
        if denom > 0:
            out["seed_s"] += stage1 * (seed / denom)
        out["stage1_s"] += stage1
    return out


def _measure_clean_fraction(sim, region, tmp) -> float:
    """Fraction of rep-orientation rows the device verdict kernel resolves
    (ops/device_align.py clean tier) on this workload: one extra
    GT_DEVICE_ALIGN=on run, counters from gt_device_align_stats. The clean
    tier IS the align stage's device implementation (VERDICT r4 weak #2:
    align was scored not-device-eligible only because none existed), so the
    ledger credits stage1's non-seed wall times this fraction as
    device-eligible."""
    from graphtyper_tpu.pipeline.genotype import genotype_regions
    from graphtyper_tpu.pipeline.native_caller import device_align_stats

    os.environ["GT_DEVICE_ALIGN"] = "on"
    try:
        device_align_stats()  # reset counters
        genotype_regions(sim.fasta, sim.sams, region, os.path.join(tmp, "dal"))
        clean, fallback, _bad = device_align_stats()
    finally:
        os.environ.pop("GT_DEVICE_ALIGN", None)
    total = clean + fallback
    return clean / total if total else 0.0


def run(workload: str, n_samples: int = 1, kb: int = 200) -> dict:
    from graphtyper_tpu.pipeline.genotype import genotype_regions

    tmp = tempfile.mkdtemp(prefix="gt_ledger_")
    if workload == "indep":
        from graphtyper_tpu.utils.simulate_indep import IndepConfig, simulate_indep

        cfg = IndepConfig(region_length=120_000, coverage=30.0, seed=9)
        sim = simulate_indep(os.path.join(tmp, "m"), cfg)
        region = f"{cfg.chrom}:1-120000"
    else:
        from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort

        cfg = SimConfig(region_length=kb * 1000, coverage=30.0, seed=1,
                        n_samples=n_samples, out_format="bam")
        sim = simulate_cohort(os.path.join(tmp, "m"), cfg)
        region = f"{cfg.chrom}:1-{kb * 1000}"

    # capture the native per-stage counters (GT_NATIVE_PROFILE stderr lines)
    # alongside cProfile: the k-mer seeding share of the caller's stage 1 has
    # a production device twin (ops/seed_probe.py) and counts as
    # device-eligible, as SURVEY §7.6 specified. The env must be set BEFORE
    # the first native call — the C++ caches the check. Scoring walls come
    # from the scorer's own counters (GT_SCORING_STATS): cProfile inflates
    # Python-loop-heavy code by an order of magnitude, so the profiled cum
    # time would overstate the scoring share.
    os.environ["GT_NATIVE_PROFILE"] = "1"
    scoring_stats = os.path.join(tmp, "scoring_stats.jsonl")
    os.environ["GT_SCORING_STATS"] = scoring_stats

    # warm (compiles, worker-pool spinup equivalents); profile prints from
    # the warm go to the real stderr and are not parsed
    genotype_regions(sim.fasta, sim.sams, region, os.path.join(tmp, "w"))

    # clean wall (no cProfile): the denominator for the device-eligible
    # fraction — the profiled wall carries tracing overhead
    t0 = time.perf_counter()
    genotype_regions(sim.fasta, sim.sams, region, os.path.join(tmp, "clean"))
    wall_clean = time.perf_counter() - t0

    open(scoring_stats, "w").close()  # keep only the profiled run's deltas

    prof_path = os.path.join(tmp, "native_prof.txt")
    saved_fd = os.dup(2)
    prof_fd = os.open(prof_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    os.dup2(prof_fd, 2)
    try:
        pr.enable()
        genotype_regions(sim.fasta, sim.sams, region, os.path.join(tmp, "out"))
        pr.disable()
    finally:
        os.dup2(saved_fd, 2)
        os.close(prof_fd)
        os.close(saved_fd)
        os.environ.pop("GT_NATIVE_PROFILE", None)
        os.environ.pop("GT_SCORING_STATS", None)
    wall = time.perf_counter() - t0
    native = _native_profile_seed_s(open(prof_path).read())
    scoring_counter_s = 0.0
    if os.path.exists(scoring_stats):
        for line in open(scoring_stats):
            d = json.loads(line)
            scoring_counter_s += (
                d.get("device_wall_s", 0.0)
                + d.get("host_apply_wall_s", 0.0)
                + d.get("materialize_wall_s", 0.0)
            )

    st = pstats.Stats(pr)
    cum: dict[str, float] = {}
    for (fn, _line, name), (cc, nc, tt, ct, callers) in st.stats.items():
        for stage, pats, _dev in STAGES:
            for pat_file, pat_name in pats:
                if pat_file in fn.replace("\\", "/") and (not pat_name or pat_name == name):
                    cum[stage] = cum.get(stage, 0.0) + ct
    # the scoring stage wall comes from the scorer's own counters; the
    # cProfile cum for it (kept as scoring_cprofile_s) is inflated by
    # per-call tracing overhead on the materialize loops
    scoring_cprofile = cum.get("site_scoring_device", 0.0)
    cum["site_scoring_device"] = scoring_counter_s
    # the verdict kernel's clean tier is the align stage's device
    # implementation: credit stage1's non-seed wall times the measured
    # clean fraction as device-eligible
    clean_frac = _measure_clean_fraction(sim, region, tmp)
    align_clean = max(0.0, native["stage1_s"] - native["seed_s"]) * clean_frac
    # call_pools cum includes the device finalize; report host share net of it
    host_align = max(
        0.0,
        cum.get("align_genotype_host", 0.0)
        - scoring_cprofile
        - native["seed_s"]
        - align_clean,
    )
    # discovery total includes the aggregation twin; report host share net
    disc_host = max(
        0.0, cum.get("discovery_first_pass", 0.0) - cum.get("fp_aggregation_device", 0.0)
    )
    ledger = {}
    for stage, _p, dev in STAGES:
        if stage == "align_genotype_host":
            v = host_align
        elif stage == "discovery_first_pass":
            v = disc_host
        else:
            v = cum.get(stage, 0.0)
        ledger[stage] = {"wall_s": round(v, 3), "device_eligible": dev}
    ledger["seed_device"] = {"wall_s": round(native["seed_s"], 3), "device_eligible": True}
    ledger["align_clean_device"] = {
        "wall_s": round(align_clean, 3),
        "device_eligible": True,
        "clean_fraction": round(clean_frac, 4),
    }
    staged = sum(v["wall_s"] for v in ledger.values())
    device_s = sum(v["wall_s"] for v in ledger.values() if v["device_eligible"])
    other = max(0.0, wall - staged)
    # fraction over the CLEAN wall: profiled stage walls are close to clean
    # for native-dominated stages; the counter-based scoring wall is exact
    f_dev = device_s / wall_clean if wall_clean else 0.0
    return {
        "workload": workload,
        "n_samples": n_samples,
        "kb": kb,
        "n_reads": sim.n_reads,
        "wall_s": round(wall, 3),
        "wall_clean_s": round(wall_clean, 3),
        "stages": ledger,
        "scoring_cprofile_s": round(scoring_cprofile, 3),
        "unattributed_s": round(other, 3),
        "device_eligible_fraction": round(f_dev, 4),
        "amdahl_speedup_ceiling": round(1.0 / (1.0 - f_dev), 3) if f_dev < 1 else None,
    }


if __name__ == "__main__":
    workload = "indep" if "--indep" in sys.argv else "snp"
    n_samples = int(sys.argv[sys.argv.index("--samples") + 1]) if "--samples" in sys.argv else 1
    kb = int(sys.argv[sys.argv.index("--kb") + 1]) if "--kb" in sys.argv else 200
    print(json.dumps(run(workload, n_samples=n_samples, kb=kb)))
