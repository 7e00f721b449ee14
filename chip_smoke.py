#!/usr/bin/env python3
"""Smoke run of the cohort genotyping path on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases setup, kernels, pipeline
    python chip_smoke.py --four-cards   # four cards: only the multi-card paths

setup     builds native/ from source (make -C native), checks that the
          package loads that build, prints the card's name and power limit
          and JAX's devices, and stops unless JAX's platform is `gpu`.
kernels   runs every device kernel of the path at a real width and compares
          it with its host twin, exactly (all arithmetic is integer):
          site-scoring apply with _apply_rows_numpy at 2^18 rows,
          A in {2, 8, 32}, 50 samples; pileup aggregation with
          _aggregate_host at 2^20 rows; the seed probe with its numpy twin;
          device alignment in verify mode on one 50 kb cohort region
          (divergences must be 0). Prints memory_analysis() per kernel.
pipeline  simulates a 50-sample x 200 kb (four 50 kb regions) x 30x cohort of
          151 bp paired BAMs from a seed and runs `graphtyper genotype`
          through graphtyper_tpu.cli.main twice in this process: every
          device kernel forced on, then everything on the host. Every device
          counter must be above 0 and the VCF bodies md5-identical.

--four-cards runs dryrun_multichip(4) on a 1-D `data` mesh of the four cards
(byte-identical to its single-card run), and the `--num_hosts 4` CLI path as
four processes, one pinned to each card, over a 16-sample cohort of the same
four regions with every device kernel forced on; the union of their outputs
must be byte-identical to a one-card run. Its parent stays off the cards.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero before that line is printed.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
N_SAMPLES = 50
N_SAMPLES_FOUR_CARDS = 16  # the --four-cards cohort: same regions, fewer samples
REGION_KB = 200
COVERAGE = 30.0
SCORING_ROWS = 1 << 18
AGG_ROWS = 1 << 20
PROBE_ROWS = 1 << 17


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def setup_package() -> None:
    """Build native/ and check the package loads that build."""
    if not os.path.exists(os.path.join(ROOT, "graphtyper_tpu", "__init__.py")):
        raise SystemExit("chip_smoke: the graphtyper_tpu package is not beside this script")
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    subprocess.run(["make", "-C", os.path.join(ROOT, "native"), f"-j{os.cpu_count() or 1}"],
                   check=True, stdout=subprocess.DEVNULL)
    from graphtyper_tpu.io import native

    lib = native.get_lib()
    built = os.path.join(ROOT, "native", "libgt_native.so")
    if lib is None or not os.path.samefile(lib._name, built):
        raise SystemExit(f"chip_smoke: native library not loaded from {built}")
    log(f"setup: native build {time.perf_counter() - t0:.1f}s -> {lib._name}")


def require_gpu():
    import jax

    devs = jax.devices()
    log(f"setup: jax {jax.__version__} devices {devs}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX platform is {devs[0].platform}, not gpu")
    return devs


def simulate(out_dir: str, n_samples: int | None = None):
    from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort

    n_samples = n_samples or N_SAMPLES
    t0 = time.perf_counter()
    cfg = SimConfig(region_length=REGION_KB * 1000, n_samples=n_samples, coverage=COVERAGE,
                    read_length=151, seed=SEED, out_format="bam")
    sim = simulate_cohort(out_dir, cfg)
    with open(os.path.join(out_dir, "sams.txt"), "w") as f:
        f.write("\n".join(sim.sams) + "\n")
    log(f"setup: simulated {n_samples} samples x {REGION_KB} kb x {COVERAGE:.0f}x, "
        f"{sim.n_reads} reads in {time.perf_counter() - t0:.1f}s")
    return sim, cfg


def genotype_args(sim, cfg, out: str, region_end: int, *extra: str) -> list[str]:
    return ["genotype", sim.fasta, "--sams", os.path.join(os.path.dirname(sim.fasta), "sams.txt"),
            "--region", f"{cfg.chrom}:1-{region_end}", "-O", out, *extra]


def region_lines(sim, cfg) -> str:
    """A --region_file of the cohort's 50 kb regions, one per line."""
    path = os.path.join(os.path.dirname(sim.fasta), "regions.txt")
    with open(path, "w") as f:
        for lo in range(0, REGION_KB * 1000, 50_000):
            f.write(f"{cfg.chrom}:{lo + 1}-{lo + 50_000}\n")
    return path


def vcf_bodies(out: str) -> list[bytes]:
    """Non-header lines of every region VCF under `out`, in region order."""
    lines: list[bytes] = []
    for root, _dirs, files in sorted(os.walk(out)):
        if os.path.basename(root) == "input_sites" or "input_sites" in root:
            continue
        for f in sorted(files):
            if f.endswith(".vcf.gz"):
                lines += [l for l in gzip.open(os.path.join(root, f), "rb") if not l.startswith(b"#")]
    return lines


def md5(lines: list[bytes]) -> str:
    return hashlib.md5(b"".join(lines)).hexdigest()


def _equal(name: str, want, got) -> None:
    import numpy as np

    want = np.asarray(want)
    got = np.asarray(got)
    if want.shape != got.shape or not np.array_equal(want, got):
        raise AssertionError(f"{name}: device result differs from its host twin")


def _memory(name: str, compiled) -> None:
    m = compiled.memory_analysis()
    log(f"kernels: {name} memory_analysis: args {m.argument_size_in_bytes} "
        f"out {m.output_size_in_bytes} temp {m.temp_size_in_bytes} bytes")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_kernels(sim, cfg, work: str, card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    # ---- site-scoring apply -------------------------------------------------
    from graphtyper_tpu.ops import site_scoring as ss

    rng = np.random.default_rng(SEED)
    n, n_sites, n_samples = SCORING_ROWS, 512, 50
    for A in (2, 8, 32):
        cols = {
            "site": rng.integers(0, n_sites, n),
            "sample": rng.integers(0, n_samples, n),
            "eps": rng.integers(1, 41, n),
            "apply_score": (rng.random(n) < 0.95).astype(np.int64),
            "bits_lo": rng.integers(1, 1 << min(A, 32), n, dtype=np.int64),
            "bits_hi": np.zeros(n, np.int64),
            "cov": rng.integers(-2, A, n),
            "clipped_scaled": rng.integers(0, 100, n),
            "clipped_flag": rng.integers(0, 2, n),
            "mapq_sq": rng.integers(0, 3601, n),
            "mm_scaled": rng.integers(0, 50, n),
            "sdiff": rng.integers(0, 30, n),
            "strand": rng.integers(0, 4, n),
            "proper": rng.integers(0, 2, n),
        }
        batcher = ss.ObsBatcher([None] * n_sites, n_samples)
        batcher.HOST_APPLY_MAX_ROWS = 0
        buf = ss._TierBuffer(A=A)
        buf.site_ids = list(range(n_sites))
        buf.blocks = [cols]
        batcher.tiers[A] = buf
        _, t_first = _timed(lambda: batcher._flush_tier(A, buf))
        batcher._totals.clear()
        buf.blocks = [cols]
        _, t_dev = _timed(lambda: batcher._flush_tier(A, buf))
        got = batcher._totals[A]
        want, t_host = _timed(lambda: ss._apply_rows_numpy(cols, n, A, n_sites, n_samples))
        for k, v in want.items():
            _equal(f"site scoring A={A} {k}", v, got[k][: v.shape[0]])
        chunk = ss._chunk_rows(A)
        mat = jnp.zeros((len(ss.OBS_FIELDS), ss._row_bucket(min(n, chunk))), jnp.int32)
        _memory(f"site scoring A={A} chunk {mat.shape[1]}",
                ss._jitted_apply_tier().lower(mat, A=A, n_sites=n_sites, n_samples=n_samples).compile())
        log(f"kernels: site scoring A={A} {n} rows equal; device {t_dev:.4f}s "
            f"(first {t_first:.2f}s) host numpy {t_host:.4f}s [{card}]")

    # ---- pileup aggregation ------------------------------------------------
    from graphtyper_tpu.ops import discovery_pileup as dp

    n, n_ev = AGG_ROWS, 40_000
    rows = (
        np.sort(rng.integers(0, n_ev, n)).astype(np.int32),
        rng.integers(-3, 4, n).astype(np.int32),
        rng.integers(-3, 4, n).astype(np.int32),
        rng.integers(0, 16, n).astype(np.int32),
        rng.integers(0, 61, n).astype(np.int32),
        rng.integers(0, 151, n).astype(np.int32),
        rng.integers(-1, 151, n).astype(np.int32),
    )
    dp.aggregate_rows(*rows, n_ev, device=True)
    got, t_dev = _timed(lambda: dp.aggregate_rows(*rows, n_ev, device=True))
    want, t_host = _timed(lambda: dp.aggregate_rows(*rows, n_ev, device=False))
    _equal("pileup aggregation", want, got)
    _memory(f"pileup aggregation {n} rows",
            dp._jitted_agg_cached().lower(jnp.zeros((6, n), jnp.int32), n_events=n_ev).compile())
    log(f"kernels: pileup aggregation {n} rows equal; device {t_dev:.4f}s host {t_host:.4f}s [{card}]")

    # ---- seed probe ----------------------------------------------------------
    from graphtyper_tpu.ops import seed_probe as sp
    from graphtyper_tpu.utils.dna import encode, pack_kmers

    ref = encode(open(sim.fasta).read().split("\n", 1)[1].replace("\n", "").encode())
    kmers, valid_k = pack_kmers(np.asarray(ref, np.uint8), 32)
    keys = np.unique(kmers[valid_k])
    n_rows, nk = PROBE_ROWS, 4
    starts = rng.integers(0, len(ref) - 151, n_rows)
    reads = np.stack([ref[s : s + 151] for s in starts]).astype(np.uint8)
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + 1) % 4
    hi = np.zeros((n_rows, nk), np.uint32)
    lo = np.zeros((n_rows, nk), np.uint32)
    valid = np.ones((n_rows, nk), np.uint8)
    for k in range(nk):
        win = reads[:, 31 * k : 31 * k + 32].astype(np.uint64)
        key = np.zeros(n_rows, np.uint64)
        for c in range(32):
            key = (key << np.uint64(2)) | win[:, c]
        hi[:, k] = (key >> np.uint64(32)).astype(np.uint32)
        lo[:, k] = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    seeder = sp.DeviceSeeder(keys)
    staged = sp.stage_kmers(hi, lo, valid)
    seeder.probe_bits(staged, n_rows, nk)
    got, t_dev = _timed(lambda: seeder.probe_bits(staged, n_rows, nk))
    want, t_host = _timed(lambda: sp.probe_bits_host(hi, lo, valid, np.asarray(seeder.bitset), nk, seeder.bits))
    _equal("seed probe", want, got)
    if not (got[:, 0] & 1).any():
        raise AssertionError("seed probe: no exact k-mer of the reads hit the index")
    _memory(f"seed probe {staged[0].shape[0]} rows",
            sp._jitted_probe_bits().lower(*staged, seeder.bitset, nk=nk, bits=seeder.bits).compile())
    log(f"kernels: seed probe {n_rows} rows equal; device {t_dev:.4f}s host numpy {t_host:.4f}s [{card}]")

    # ---- device alignment, verify mode, on one cohort region -----------------
    from graphtyper_tpu.cli import main as cli_main
    from graphtyper_tpu.pipeline.native_caller import device_align_stats

    device_align_stats()  # reset
    _, t = _timed(lambda: cli_main(genotype_args(
        sim, cfg, os.path.join(work, "verify"), 50_000, "--device_align", "verify", "--threads", "1")))
    clean, fallback, bad = device_align_stats()
    if bad != 0 or clean == 0:
        raise AssertionError(f"device align verify: clean {clean} fallback {fallback} divergences {bad}")
    from graphtyper_tpu.ops.device_align import _jitted_verdicts

    log(f"kernels: device align verify on 50 kb: clean {clean} fallback {fallback} divergences 0; "
        f"{t:.1f}s, {_jitted_verdicts.cache_info().currsize} compiled shapes [{card}]")


def phase_pipeline(sim, cfg, work: str, card: str) -> None:
    from graphtyper_tpu.cli import main as cli_main
    from graphtyper_tpu.ops import discovery_pileup as dp
    from graphtyper_tpu.ops import site_scoring as ss
    from graphtyper_tpu.pipeline.native_caller import device_align_stats

    end = REGION_KB * 1000
    threads = str(os.cpu_count() or 1)
    on = ["--device_align", "on", "--device_seed", "on", "--device_discovery", "on",
          "--threads", threads]
    off = ["--device_align", "off", "--device_seed", "off", "--device_discovery", "off",
           "--threads", threads]
    host_apply, host_agg = ss.ObsBatcher.HOST_APPLY_MAX_ROWS, dp.HOST_AGG_MAX_ROWS
    ss.ObsBatcher.HOST_APPLY_MAX_ROWS, dp.HOST_AGG_MAX_ROWS = 0, 0
    before = (ss.DEVICE_APPLY_ROWS, dp.DEVICE_AGG_ROWS)
    device_align_stats()  # reset
    try:
        rc, t_dev = _timed(lambda: cli_main(genotype_args(sim, cfg, os.path.join(work, "dev"), end, *on)))
    finally:
        ss.ObsBatcher.HOST_APPLY_MAX_ROWS, dp.HOST_AGG_MAX_ROWS = host_apply, host_agg
    clean = device_align_stats()[0]
    counters = {
        "DEVICE_APPLY_ROWS": ss.DEVICE_APPLY_ROWS - before[0],
        "DEVICE_AGG_ROWS": dp.DEVICE_AGG_ROWS - before[1],
        "device_align_clean_rows": clean,
    }
    log(f"pipeline: device-routed run rc {rc} counters {counters}")
    if rc != 0 or min(counters.values()) <= 0:
        raise AssertionError(f"pipeline: a device counter stayed at 0: {counters}")
    before = (ss.DEVICE_APPLY_ROWS, dp.DEVICE_AGG_ROWS)
    rc, t_host = _timed(lambda: cli_main(genotype_args(sim, cfg, os.path.join(work, "host"), end, *off)))
    if rc != 0 or (ss.DEVICE_APPLY_ROWS, dp.DEVICE_AGG_ROWS) != before:
        raise AssertionError("pipeline: the host-routed run used the device")
    dev_body, host_body = vcf_bodies(os.path.join(work, "dev")), vcf_bodies(os.path.join(work, "host"))
    if not dev_body or md5(dev_body) != md5(host_body):
        raise AssertionError(
            f"pipeline: VCF bodies differ ({len(dev_body)} vs {len(host_body)} records)")
    log(f"pipeline: VCF bodies md5-identical {md5(dev_body)} ({len(dev_body)} records)")
    log(f"pipeline: wall device-routed {t_dev:.1f}s ({sim.n_reads / t_dev:.0f} reads/s), "
        f"host-routed {t_host:.1f}s ({sim.n_reads / t_host:.0f} reads/s), "
        f"{threads} threads [{card}]")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def four_cards() -> dict:
    """Multi-card paths, each in child processes; this process stays off the
    cards until they have all exited."""
    card = card_line()
    work = tempfile.mkdtemp(prefix="gt_smoke4_")
    # every device kernel on, in every child: row thresholds 0, routing "on"
    env = dict(os.environ, PYTHONPATH=ROOT, GT_HOST_APPLY_ROWS="0", GT_FP_HOST_AGG_ROWS="0")
    on = ["--device_align", "on", "--device_seed", "on", "--device_discovery", "on"]
    code = ("import sys; sys.path.insert(0, %r); import __graft_entry__ as g; "
            "g.dryrun_multichip(4)" % ROOT)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
    log(f"four-cards: dryrun_multichip(4) on a 1-D data mesh byte-identical to one card "
        f"in {time.perf_counter() - t0:.1f}s [{card}]")

    sim, cfg = simulate(os.path.join(work, "sim"), N_SAMPLES_FOUR_CARDS)
    cli = [sys.executable, "-m", "graphtyper_tpu.cli"]
    end = REGION_KB * 1000
    regions = ["--region_file", region_lines(sim, cfg)]
    one = genotype_args(sim, cfg, os.path.join(work, "one"), end, *regions, *on)
    t0 = time.perf_counter()
    subprocess.run(cli + one, check=True, env=env, stdout=subprocess.DEVNULL)
    t_one = time.perf_counter() - t0
    port = _free_port()
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(cli + genotype_args(
            sim, cfg, os.path.join(work, "four"), end, *regions, *on,
            "--num_hosts", "4", "--host_id", str(i), "--coordinator", f"localhost:{port}",
            "--local_device_ids", str(i)), env=env, stdout=subprocess.DEVNULL)
        for i in range(4)
    ]
    rcs = [p.wait(timeout=1100) for p in procs]
    t_four = time.perf_counter() - t0
    if any(rcs):
        raise AssertionError(f"four-cards: --num_hosts 4 processes exited {rcs}")
    a, b = vcf_bodies(os.path.join(work, "one")), vcf_bodies(os.path.join(work, "four"))
    if not a or md5(a) != md5(b):
        raise AssertionError(f"four-cards: 4-process output differs ({len(a)} vs {len(b)} records)")
    log(f"four-cards: --num_hosts 4 (one process per card) byte-identical to one card "
        f"{md5(a)} ({len(a)} records); walls one card {t_one:.1f}s, four {t_four:.1f}s [{card}]")
    log(f"card: {card}")
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths on four cards")
    args = ap.parse_args()
    setup_package()
    if args.four_cards:
        device = four_cards()
        if device["platform"] != "gpu" or device["count"] != 4:
            raise SystemExit(f"chip_smoke: needs four GPUs, JAX sees {device}")
    else:
        card = card_line()
        devs = require_gpu()
        work = tempfile.mkdtemp(prefix="gt_smoke_")
        sim, cfg = simulate(os.path.join(work, "sim"))
        t0 = time.perf_counter()
        phase_kernels(sim, cfg, work, card)
        log(f"kernels: phase done in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_pipeline(sim, cfg, work, card)
        log(f"pipeline: phase done in {time.perf_counter() - t0:.1f}s")
        log(f"card: {card}")
        device = {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
