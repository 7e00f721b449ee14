"""Population-scale soak (VERDICT r3 #10): 500 samples x 1Mb x 20x through
the full production pipeline, with wall + RSS ledger and parity signatures.

Simulation parallelizes across a process pool with per-sample RNG streams
(seeded by (seed, sample)), so the cohort builds in minutes instead of
hours; inputs cache under /tmp/gt_soak_cache keyed by the recipe. The
genotyping run exercises the production population path end-to-end:
bamshrink, sam_merge chunking (>max_files_open inputs collapse into merged
pool files, genotype.cpp:174-260 analog), the bounded-RSS streaming pooled
caller, cohort-size parameter tuning, and the 3-iteration loop.

RSS ledger: a monitor thread samples the whole process tree's resident
set (orchestrator + simulation workers) once a second; the peak and the
per-stage walls land in one JSON line with md5-of-record-lines as the
parity signature.

Usage: python tools/soak_population.py [--samples 500] [--kb 1000]
       [--coverage 20] [--processes 4]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _sim_one(args) -> tuple[str, int]:
    """One sample's BAM, deterministic under (seed, sample_i)."""
    import numpy as np

    (out_dir, sample_i, seed, region_length, coverage, read_length, chrom) = args
    from graphtyper_tpu.io.bam import read_alignments
    from graphtyper_tpu.io.bam_writer import write_bam
    from graphtyper_tpu.utils import simulate as sm

    rng = np.random.default_rng((seed, sample_i))
    # regenerate the SHARED reference + variants from the cohort seed (cheap
    # relative to reads; keeps workers independent)
    ref_rng = np.random.default_rng(seed)
    seq = sm._random_seq(ref_rng, region_length)
    cfg = sm.SimConfig(region_length=region_length, coverage=coverage, seed=seed,
                       read_length=read_length, chrom=chrom)
    variants = sm._make_variants(ref_rng, seq, cfg)
    gts = rng.integers(0, 2, size=(len(variants), 2))
    haps = [sm._apply_haplotype(seq, variants, gts[:, h]) for h in range(2)]
    n_pairs = int(coverage * region_length / (2 * read_length))
    sam_path = os.path.join(out_dir, f"sample{sample_i}.sam")
    sm._write_sample_sam(sam_path, cfg, rng, haps, f"sample{sample_i}", n_pairs)
    header, reads = read_alignments(sam_path, parse_tags=True)
    bam_path = sam_path[:-4] + ".bam"
    write_bam(bam_path, header, reads)
    os.remove(sam_path)
    return bam_path, 2 * n_pairs


def simulate_population(cache: str, n_samples: int, kb: int, coverage: float,
                        processes: int, seed: int = 42):
    import numpy as np

    meta_p = os.path.join(cache, "meta.json")
    key = dict(n_samples=n_samples, kb=kb, coverage=coverage, seed=seed)
    if os.path.exists(meta_p):
        meta = json.load(open(meta_p))
        if meta.get("key") == key and all(os.path.exists(p) for p in meta["sams"][:3]):
            return meta["fasta"], meta["sams"], meta["n_reads"]
    os.makedirs(cache, exist_ok=True)
    from graphtyper_tpu.utils import simulate as sm

    region_length = kb * 1000
    chrom = "chrP"
    ref_rng = np.random.default_rng(seed)
    seq = sm._random_seq(ref_rng, region_length)
    fasta = os.path.join(cache, "ref.fa")
    sm._write_fasta(fasta, chrom, seq)

    jobs = [
        (cache, i, seed, region_length, coverage, 151, chrom) for i in range(n_samples)
    ]
    t0 = time.perf_counter()
    from multiprocessing import get_context

    with get_context("spawn").Pool(processes) as pool:
        results = pool.map(_sim_one, jobs, chunksize=4)
    sams = [r[0] for r in results]
    n_reads = sum(r[1] for r in results)
    print(f"sim: {n_samples} samples, {n_reads} reads in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)
    json.dump({"key": key, "fasta": fasta, "sams": sams, "n_reads": n_reads},
              open(meta_p, "w"))
    return fasta, sams, n_reads


class TreeRssMonitor:
    """Peak RSS of this process + all descendants, sampled once a second."""

    def __init__(self):
        self.peak_mb = 0.0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _tree_rss_mb(self) -> float:
        me = os.getpid()
        children: dict[int, list[int]] = {}
        rss: dict[int, float] = {}
        for pid_s in os.listdir("/proc"):
            if not pid_s.isdigit():
                continue
            try:
                with open(f"/proc/{pid_s}/status") as f:
                    ppid = 0
                    kb = 0.0
                    for line in f:
                        if line.startswith("PPid:"):
                            ppid = int(line.split()[1])
                        elif line.startswith("VmRSS:"):
                            kb = float(line.split()[1])
                children.setdefault(ppid, []).append(int(pid_s))
                rss[int(pid_s)] = kb / 1024.0
            except OSError:
                continue
        total = 0.0
        stack = [me]
        while stack:
            p = stack.pop()
            total += rss.get(p, 0.0)
            stack.extend(children.get(p, []))
        return total

    def _run(self):
        while not self._stop.is_set():
            self.peak_mb = max(self.peak_mb, self._tree_rss_mb())
            self._stop.wait(1.0)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *a):
        self._stop.set()
        self._t.join(timeout=3)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--kb", type=int, default=1000)
    ap.add_argument("--coverage", type=float, default=20.0)
    ap.add_argument("--processes", type=int, default=4)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--max-files-open", type=int, default=0,
                    help="lower the pool-size cap so sam_merge chunking and "
                         "the multi-pool reduction engage below 864 samples "
                         "(genotype.cpp:174-260 analog)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    if args.max_files_open or args.threads:
        from dataclasses import replace

        from graphtyper_tpu.config import current_options, set_options

        kw = {}
        if args.max_files_open:
            kw["max_files_open"] = args.max_files_open
        if args.threads:
            # sam_merge chunking engages at >= 200 samples/thread
            # (genotype.cpp:174-260); lower threads to cross it below 800
            kw["threads"] = args.threads
        set_options(replace(current_options(), **kw))

    cache = f"/tmp/gt_soak_cache_{args.samples}x{args.kb}kb"
    fasta, sams, n_reads = simulate_population(
        cache, args.samples, args.kb, args.coverage, args.processes
    )

    from graphtyper_tpu.pipeline.genotype import genotype_regions

    out = os.path.join(cache, "out")
    t0 = time.perf_counter()
    with TreeRssMonitor() as mon:
        outs = genotype_regions(fasta, sams, f"chrP:1-{args.kb * 1000}", out)
        wall = time.perf_counter() - t0
        peak = mon.peak_mb

    import gzip

    h = hashlib.md5()
    n_records = 0
    for p in sorted(outs):
        for line in gzip.open(p, "rt"):
            if not line.startswith("#"):
                h.update(line.encode())
                n_records += 1
    print(json.dumps({
        "samples": args.samples, "kb": args.kb, "coverage": args.coverage,
        "n_reads": n_reads, "wall_s": round(wall, 1),
        "reads_per_sec": round(n_reads / wall, 1),
        "peak_tree_rss_mb": round(peak, 1),
        "n_records": n_records, "md5": h.hexdigest(),
    }), flush=True)


if __name__ == "__main__":
    main()
