"""BASELINE config 5 scaling measurement (CPU stand-in for multi-host).

Two real OS processes running
the production jax.distributed cohort path (samples sharded by host,
pool/ph-map gathers over the collective, host-0 merge), each pinned to its
own half of the machine's cores — versus a single process pinned to one
half (equal per-host resources). Ideal 2-host scaling halves the wall.

Prints one JSON line: {"t1_s", "t2_s", "scaling_efficiency"} where
efficiency = t1 / (2 * t2); >= 0.8 meets the BASELINE target.

Usage: python tools/bench_distributed.py [n_samples] [region_kb]
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SINGLE = r"""
import os, sys, time, json
os.sched_setaffinity(0, set(json.loads(sys.argv[1])))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
meta = json.load(open(sys.argv[2]))
from graphtyper_tpu.pipeline.genotype import genotype
t0 = time.perf_counter()
genotype(meta["fasta"], meta["sams"], meta["region"], sys.argv[3])
print("WALL", time.perf_counter() - t0)
"""

REGION_HOST = r"""
import os, sys, time, json
host = int(sys.argv[1])
os.sched_setaffinity(0, set(json.loads(sys.argv[2])))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
meta = json.load(open(sys.argv[3]))
from graphtyper_tpu.parallel.distributed import assign_regions
from graphtyper_tpu.pipeline.genotype import genotype_regions
mine = assign_regions(meta["regions"], n_hosts=2, host=host)
t0 = time.perf_counter()
outs = []
for r in mine:
    outs.extend(genotype_regions(meta["fasta"], meta["sams"], r, sys.argv[4]))
print("WALL", time.perf_counter() - t0)
print("OUTS", json.dumps(outs))
"""

REGION_SINGLE = r"""
import os, sys, time, json
os.sched_setaffinity(0, set(json.loads(sys.argv[1])))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
meta = json.load(open(sys.argv[2]))
from graphtyper_tpu.pipeline.genotype import genotype_regions
t0 = time.perf_counter()
for r in meta["regions"]:
    genotype_regions(meta["fasta"], meta["sams"], r, sys.argv[3])
print("WALL", time.perf_counter() - t0)
"""

CHILD = r"""
import os, sys, time, json
pid = int(sys.argv[1]); port = sys.argv[2]
os.sched_setaffinity(0, set(json.loads(sys.argv[3])))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
meta = json.load(open(sys.argv[4]))
from graphtyper_tpu.parallel.distributed import genotype_distributed
t0 = time.perf_counter()
genotype_distributed(meta["fasta"], meta["sams"], meta["region"], sys.argv[5])
print("WALL", time.perf_counter() - t0)
"""


def _wall(out: str) -> float:
    for line in out.splitlines():
        if line.startswith("WALL"):
            return float(line.split()[1])
    raise RuntimeError("no WALL line:\n" + out[-2000:])


def main() -> None:
    n_samples = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    kb = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    ncpu = os.cpu_count() or 4
    half_a = list(range(0, ncpu // 2))
    half_b = list(range(ncpu // 2, ncpu))

    from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort

    tmp = tempfile.mkdtemp(prefix="gt_dbench_")
    cfg = SimConfig(region_length=kb * 1000, coverage=20.0, seed=12,
                    n_samples=n_samples, out_format="bam")
    sim = simulate_cohort(os.path.join(tmp, "c"), cfg)
    meta_p = os.path.join(tmp, "meta.json")
    json.dump({"fasta": sim.fasta, "sams": list(sim.sams),
               "region": f"{cfg.chrom}:1-{kb * 1000}"}, open(meta_p, "w"))
    sp = os.path.join(tmp, "single.py")
    open(sp, "w").write(SINGLE)
    cp = os.path.join(tmp, "child.py")
    open(cp, "w").write(CHILD)
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    def single(tag: str) -> float:
        p = subprocess.run(
            [sys.executable, sp, json.dumps(half_a), meta_p, os.path.join(tmp, tag)],
            capture_output=True, text=True, timeout=1200, env=env, cwd=repo)
        if p.returncode != 0:
            raise RuntimeError(p.stderr[-2000:])
        return _wall(p.stdout)

    def dist(tag: str) -> float:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        procs = []
        for pid, cores in ((0, half_a), (1, half_b)):
            procs.append(subprocess.Popen(
                [sys.executable, cp, str(pid), port, json.dumps(cores), meta_p,
                 os.path.join(tmp, f"{tag}{pid}")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=repo))
        outs = [p.communicate(timeout=1200) for p in procs]
        for p, (o, e) in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(e[-2000:])
        return max(_wall(o) for o, _ in outs)

    # ---- mode 2: region sharding (BASELINE config 5's stated strategy:
    # "region-sharded graph index"; hosts own disjoint regions, the final
    # reduction is the cheap byte-level vcf_concatenate) -------------------
    rs = os.path.join(tmp, "rs.py")
    open(rs, "w").write(REGION_SINGLE)
    rh = os.path.join(tmp, "rh.py")
    open(rh, "w").write(REGION_HOST)
    n_regions = 4
    step = kb * 1000 // n_regions
    regions = [f"{cfg.chrom}:{i * step + 1}-{(i + 1) * step}" for i in range(n_regions)]
    rmeta_p = os.path.join(tmp, "rmeta.json")
    json.dump({"fasta": sim.fasta, "sams": list(sim.sams), "regions": regions},
              open(rmeta_p, "w"))

    def region_single(tag: str) -> float:
        p = subprocess.run(
            [sys.executable, rs, json.dumps(half_a), rmeta_p, os.path.join(tmp, tag)],
            capture_output=True, text=True, timeout=1200, env=env, cwd=repo)
        if p.returncode != 0:
            raise RuntimeError(p.stderr[-2000:])
        return _wall(p.stdout)

    def region_dist(tag: str) -> float:
        procs = []
        for hid, cores in ((0, half_a), (1, half_b)):
            procs.append(subprocess.Popen(
                [sys.executable, rh, str(hid), json.dumps(cores), rmeta_p,
                 os.path.join(tmp, f"{tag}{hid}")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=repo))
        outs = [p.communicate(timeout=1200) for p in procs]
        for p, (o, e) in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(e[-2000:])
        wall = max(_wall(o) for o, _ in outs)
        # host-0 final reduction: concatenate the per-region VCFs
        paths = []
        for o, _ in outs:
            for line in o.splitlines():
                if line.startswith("OUTS"):
                    paths.extend(json.loads(line[5:]))
        t0 = time.perf_counter()
        from graphtyper_tpu.pipeline.vcf_operations import vcf_concatenate

        vcf_concatenate(sorted(paths), os.path.join(tmp, f"{tag}_cat.vcf.gz"))
        return wall + (time.perf_counter() - t0)

    single("w1")  # warm (compile caches, page cache)
    dist("w2")
    t1 = min(single(f"s{i}") for i in range(2))
    t2 = min(dist(f"d{i}") for i in range(2))
    region_single("rw1")
    region_dist("rw2")
    r1 = min(region_single(f"rs{i}") for i in range(2))
    r2 = min(region_dist(f"rd{i}") for i in range(2))
    print(json.dumps({
        "n_samples": n_samples, "region_kb": kb, "n_reads": sim.n_reads,
        "half_machine_cores": len(half_a),
        "region_sharded": {
            "n_regions": n_regions,
            "t1_single_host_s": round(r1, 2), "t2_two_host_s": round(r2, 2),
            "scaling_efficiency": round(r1 / (2 * r2), 3),
        },
        "sample_sharded": {
            "t1_single_host_s": round(t1, 2), "t2_two_host_s": round(t2, 2),
            "scaling_efficiency": round(t1 / (2 * t2), 3),
        },
    }))


if __name__ == "__main__":
    main()
