"""Interleaved host-vs-GPU routing A/B at cohort scale.

Runs BASELINE config 4 (50 samples x 1Mb x 30x; --samples overrides) through
`genotype_regions` under these variants, interleaved to average out host
noise:

  host        JAX on its CPU backend: every stage on the host (the
              reference-style configuration; reference analog of the cohort
              loop: src/typer/caller.cpp:313-437)
  gpu         the GPU with the production "auto" routing (host applies small
              scoring flushes, native k-mer seeding)
  gpu-forced  the GPU with device_seed=on and GT_HOST_APPLY_ROWS=0 so every
              scoring flush and the 97-probe seeding run on the card
  gpu-align   the GPU with GT_DEVICE_ALIGN=on: the call iterations' align
              stage dispatches the device verdict kernel per read batch
              (ops/device_align.py) with clean rows skipping the host
              seed+lattice+walk

Each variant runs in its own child process, one after another, so one
process at a time holds the card. A child warms with one untimed full run
(compiles every kernel shape at the cohort's n_samples), then times one
run. Scoring duty-cycle telemetry (host vs device observation rows, wall
inside device launch+collect, H2D bytes) comes from GT_SCORING_STATS.
Output md5 is checked identical across all variants.

Usage: python tools/bench_ab.py [--samples 50] [--reps 2] [--kb 1000]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def _md5_records(paths: list[str]) -> tuple[str, int]:
    import gzip

    h = hashlib.md5()
    n = 0
    for p in sorted(paths):
        for line in gzip.open(p, "rt"):
            if not line.startswith("#"):
                h.update(line.encode())
                n += 1
    return h.hexdigest(), n


def child(variant: str, samples: int, kb: int) -> None:
    if variant == "host":
        import jax

        jax.config.update("jax_platforms", "cpu")
    from dataclasses import replace

    from bench_configs import _cached_sim
    from graphtyper_tpu.config import current_options, set_options
    from graphtyper_tpu.pipeline.genotype import genotype_regions
    from graphtyper_tpu.utils.simulate import SimConfig

    if variant == "gpu-forced":
        set_options(replace(current_options(), device_seed="on"))

    cfg = SimConfig(region_length=kb * 1000, coverage=30.0, n_samples=samples,
                    seed=8, out_format="bam")
    name = f"gt_ab_{samples}x{kb}kb_cache" if (samples, kb) != (50, 1000) else "gt_cfg4_cache"
    cache = os.path.join(tempfile.gettempdir(), name)
    sim = _cached_sim(cache, cfg)
    region = f"{cfg.chrom}:1-{kb * 1000}"

    tmp = tempfile.mkdtemp(prefix=f"gt_ab_{variant}_")
    stats_f = os.path.join(tmp, "scoring_stats.jsonl")
    os.environ["GT_SCORING_STATS"] = stats_f
    # warm: full-shape untimed run (compiles every kernel shape this cohort
    # size will hit)
    genotype_regions(sim.fasta, sim.sams, region, os.path.join(tmp, "warm"))
    open(stats_f, "w").close()  # drop the warm run's telemetry lines
    t0 = time.perf_counter()
    outs = genotype_regions(sim.fasta, sim.sams, region, os.path.join(tmp, "out"))
    wall = time.perf_counter() - t0
    os.environ.pop("GT_SCORING_STATS", None)

    md5, n_records = _md5_records(outs)
    agg = {"host_rows": 0, "device_rows": 0, "device_wall_s": 0.0, "h2d_bytes": 0,
           "align_rows": 0, "align_wall_s": 0.0}
    if os.path.exists(stats_f):
        for line in open(stats_f):
            d = json.loads(line)
            for k in agg:
                agg[k] += d.get(k, 0)
    print("GT_AB_RESULT " + json.dumps({
        "variant": variant, "wall_s": wall, "n_reads": sim.n_reads,
        "reads_per_sec": sim.n_reads / wall, "md5": md5, "n_records": n_records,
        **{k: round(v, 4) if isinstance(v, float) else v for k, v in agg.items()},
    }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--kb", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--variants", default="host,gpu,gpu-forced")
    args = ap.parse_args()
    variants = args.variants.split(",")

    results: list[dict] = []
    for rep in range(args.reps):
        for variant in variants:
            env = dict(os.environ)
            if variant == "gpu-forced":
                env["GT_HOST_APPLY_ROWS"] = "0"
            elif variant == "gpu-align":
                env["GT_DEVICE_ALIGN"] = "on"
            cmd = [sys.executable, os.path.abspath(__file__), "--child", variant,
                   str(args.samples), str(args.kb)]
            t0 = time.time()
            p = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                               text=True, timeout=3600)
            got = None
            for line in p.stdout.splitlines():
                if line.startswith("GT_AB_RESULT "):
                    got = json.loads(line[len("GT_AB_RESULT "):])
            if got is None:
                sys.stderr.write(f"[{variant} rep{rep}] FAILED in {time.time()-t0:.0f}s\n"
                                 + p.stdout[-1500:] + p.stderr[-1500:] + "\n")
                continue
            got["rep"] = rep
            results.append(got)
            print(f"[{variant} rep{rep}] wall={got['wall_s']:.1f}s "
                  f"reads/s={got['reads_per_sec']:.0f} "
                  f"dev_rows={got['device_rows']} host_rows={got['host_rows']} "
                  f"dev_wall={got['device_wall_s']:.2f}s "
                  f"align={got.get('align_rows', 0)}r/"
                  f"{got.get('align_wall_s', 0.0):.1f}s md5={got['md5'][:8]}",
                  flush=True)

    md5s = {r["md5"] for r in results}
    summary = {"samples": args.samples, "kb": args.kb,
               "outputs_identical": len(md5s) == 1, "n_md5": len(md5s), "variants": {}}
    for variant in variants:
        rs = [r for r in results if r["variant"] == variant]
        if not rs:
            continue
        summary["variants"][variant] = {
            "walls_s": [round(r["wall_s"], 2) for r in rs],
            "median_wall_s": round(statistics.median(r["wall_s"] for r in rs), 2),
            "median_reads_per_sec": round(statistics.median(r["reads_per_sec"] for r in rs), 1),
            "device_rows": max(r["device_rows"] for r in rs),
            "host_rows": max(r["host_rows"] for r in rs),
            "device_wall_s": round(statistics.median(r["device_wall_s"] for r in rs), 2),
            "h2d_mb": round(max(r["h2d_bytes"] for r in rs) / 1e6, 1),
            "align_rows": max(r.get("align_rows", 0) for r in rs),
            "align_wall_s": round(
                statistics.median(r.get("align_wall_s", 0.0) for r in rs), 2
            ),
        }
    print("GT_AB_SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    if "--child" in sys.argv:
        i = sys.argv.index("--child")
        child(sys.argv[i + 1], int(sys.argv[i + 2]), int(sys.argv[i + 3]))
    else:
        main()
