"""Cross-host cohort genotyping: two real processes with a local
coordinator run jax.distributed end-to-end (samples sharded by host,
per-iteration pool gather over the collective), and host 0's output must be
byte-identical to a single-process run over the whole cohort.

Reference analog: src/typer/vcf_operations.cpp:20-142 (pool-file merge),
here replaced by a cross-process allgather of the batched pool VCFs + pickled phasing
maps feeding the identical merge code."""

import gzip
import os
import socket
import subprocess
import sys

import pytest

from graphtyper_tpu.pipeline import native_caller

CHILD = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
sim_dir = sys.argv[3]; out_dir = sys.argv[4]; region = sys.argv[5]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
import json
meta = json.load(open(os.path.join(sim_dir, "meta.json")))
from graphtyper_tpu.parallel.distributed import genotype_distributed
out = genotype_distributed(meta["fasta"], meta["sams"], region, out_dir)
print("CHILD_DONE", pid, out)
"""


@pytest.mark.skipif(not native_caller.available(), reason="native lib unavailable")
def test_two_process_distributed_matches_single(tmp_path):
    from graphtyper_tpu.pipeline.genotype import genotype
    from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort

    cfg = SimConfig(region_length=50_000, coverage=14.0, seed=31, n_samples=4, out_format="bam")
    sim = simulate_cohort(str(tmp_path / "c"), cfg)
    region = f"{cfg.chrom}:1-50000"

    # single-process reference run
    single_out = genotype(sim.fasta, sim.sams, region, str(tmp_path / "single"))
    single_bytes = gzip.open(single_out, "rb").read()

    # two real processes through jax.distributed
    import json

    meta = {"fasta": sim.fasta, "sams": sim.sams}
    with open(tmp_path / "meta.json", "w") as f:
        json.dump(meta, f)
    child_py = tmp_path / "child.py"
    child_py.write_text(CHILD)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = "/root/repo" + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(child_py), str(i), str(port), str(tmp_path),
             str(tmp_path / "dist_out"), region],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd="/root/repo", env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {i} failed:\n{out[-3000:]}"

    dist_out = str(tmp_path / "dist_out" / cfg.chrom / f"{1:09d}-{50000:09d}.vcf.gz")
    assert os.path.exists(dist_out), outs[0][-2000:]
    dist_bytes = gzip.open(dist_out, "rb").read()
    assert dist_bytes == single_bytes
    assert len(dist_bytes) > 1000
