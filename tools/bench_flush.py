"""Micro A/B of ONE production scoring flush: device kernel vs host numpy.

A scoring flush of N observation rows (tier A alleles, S sites, P samples)
either host-applies via _apply_rows_numpy or ships to the device via
_jitted_apply_tier. This tool times both at cohort-scale shapes so the
HOST_APPLY_MAX_ROWS routing threshold is measured, not guessed.

Reference analog of the work: haplotype.cpp:462-585 explain_to_score per
read, summed over the cohort (src/typer/caller.cpp:313-437 thread loop).

Prints one JSON line per (rows, A, sites, samples) shape:
  {"rows", "A", "sites", "samples", "host_ms", "device_ms_steady",
   "device_ms_first", "h2d_mb", "winner", "speedup"}

Usage: python tools/bench_flush.py [--samples 50] [--cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_rows(n: int, A: int, n_sites: int, n_samples: int, seed: int = 0):
    """Realistic observation-row columns (production distributions: most
    reads explain one allele, eps 4-8, ~half proper pairs)."""
    from graphtyper_tpu.ops.site_scoring import COV_MULTI_ALT, COV_MULTI_REF, OBS_FIELDS

    rng = np.random.default_rng(seed)
    cols = {}
    cols["site"] = rng.integers(0, n_sites, n).astype(np.int64)
    cols["sample"] = rng.integers(0, n_samples, n).astype(np.int64)
    cols["eps"] = rng.integers(4, 9, n).astype(np.int64)
    cols["apply_score"] = (rng.random(n) < 0.98).astype(np.int64)
    which = rng.integers(0, A, n)
    lo = (1 << which.astype(np.uint64)) & 0xFFFFFFFF
    multi = rng.random(n) < 0.06
    lo = np.where(multi, lo | np.uint64(1), lo)
    cols["bits_lo"] = lo.astype(np.int64)
    cols["bits_hi"] = np.zeros(n, dtype=np.int64)
    cov = which.astype(np.int64)
    cov = np.where(multi, np.where(which > 0, COV_MULTI_ALT, COV_MULTI_REF), cov)
    cols["cov"] = cov
    cols["clipped_scaled"] = rng.integers(0, 30, n).astype(np.int64)
    cols["clipped_flag"] = (rng.random(n) < 0.08).astype(np.int64)
    cols["mapq_sq"] = (rng.integers(20, 61, n) ** 2).astype(np.int64)
    cols["mm_scaled"] = rng.integers(0, 40, n).astype(np.int64)
    cols["sdiff"] = rng.integers(0, 60, n).astype(np.int64)
    cols["strand"] = rng.integers(0, 4, n).astype(np.int64)
    cols["proper"] = (rng.random(n) < 0.5).astype(np.int64)
    return {k: cols[k] for k in OBS_FIELDS}


def main() -> None:
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    n_samples = 50
    if "--samples" in sys.argv:
        n_samples = int(sys.argv[sys.argv.index("--samples") + 1])

    import jax

    from graphtyper_tpu.ops import site_scoring as ss

    print(f"backend: {jax.default_backend()}", file=sys.stderr)
    chunk_override = None
    if "--chunk" in sys.argv:
        chunk_override = int(sys.argv[sys.argv.index("--chunk") + 1])
    A = 2
    n_sites = 512  # one 50kb unit's padded biallelic tier
    for rows in (65_536, 262_144, 1_048_576, 4_194_304):
        cols = synth_rows(rows, A, n_sites, n_samples)
        # ---- host numpy twin ------------------------------------------------
        host_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            out_h = ss._apply_rows_numpy(cols, rows, A, n_sites, n_samples)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        # ---- device kernel (chunked exactly like _flush_tier_launch) -------
        chunk = chunk_override or ss._chunk_rows(A)
        mats = []
        for lo_i in range(0, rows, chunk):
            hi_i = min(rows, lo_i + chunk)
            m = hi_i - lo_i
            n_pad = ss._row_bucket(m)
            mat = np.zeros((len(ss.OBS_FIELDS), n_pad), dtype=np.int32)
            for i, k in enumerate(ss.OBS_FIELDS):
                v = cols[k][lo_i:hi_i]
                mat[i, :m] = v.astype(np.int64).astype(np.int32)
            if n_pad > m:
                mat[ss.OBS_FIELDS.index("cov"), m:] = ss.COV_PAD
            mats.append(mat)
        h2d_mb = sum(m.nbytes for m in mats) / 1e6
        fn = ss._jitted_apply_tier()

        def device_pass():
            pend = [fn(__import__("jax.numpy", fromlist=["asarray"]).asarray(m),
                       A=A, n_sites=n_sites, n_samples=n_samples) for m in mats]
            outs = [np.asarray(v) for v in pend]
            tot = outs[0]
            for o in outs[1:]:
                tot = tot + o
            return tot

        t0 = time.perf_counter()
        out_d = device_pass()
        first_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            out_d = device_pass()
            dev_ms.append((time.perf_counter() - t0) * 1e3)

        # ---- device compute alone (scan-differenced in-jit, data resident):
        # separates the kernel's speed from the transfer cost
        compute_ms = None
        try:
            import jax
            import jax.numpy as jnp

            mat0 = jax.device_put(jnp.asarray(mats[0]))

            def make_many(n_steps: int):
                @jax.jit
                def many(m):
                    def body(c, i):
                        # roll defeats loop-invariant hoisting (same trick as
                        # bench.kernel_secondary)
                        out = ss._apply_tier_impl(
                            jnp.roll(m, i, axis=1), A=A, n_sites=n_sites,
                            n_samples=n_samples
                        )
                        return c + out.sum().astype(jnp.float32), None

                    return jax.lax.scan(body, jnp.float32(0), jnp.arange(n_steps))[0]

                return many

            small, big = make_many(2), make_many(10)
            float(small(mat0))
            float(big(mat0))
            per = []
            for _ in range(3):
                t0 = time.perf_counter()
                float(small(mat0))
                ts = time.perf_counter() - t0
                t0 = time.perf_counter()
                float(big(mat0))
                tb = time.perf_counter() - t0
                per.append((tb - ts) / 8)
            import statistics

            compute_ms = statistics.median(per) * 1e3 * len(mats)
        except Exception:
            compute_ms = None
        # ---- parity ---------------------------------------------------------
        d = ss._split_out_vec(out_d, A, n_sites, n_samples)
        for k in out_h:
            np.testing.assert_array_equal(out_h[k], d[k].astype(out_h[k].dtype))
        host = float(np.median(host_ms))
        dev = float(np.median(dev_ms))
        print(json.dumps({
            "rows": rows, "A": A, "sites": n_sites, "samples": n_samples,
            "host_ms": round(host, 1), "device_ms_steady": round(dev, 1),
            "device_ms_first": round(first_ms, 1), "h2d_mb": round(h2d_mb, 1),
            "device_compute_ms": round(compute_ms, 1) if compute_ms else None,
            "chunks": len(mats),
            "winner": "device" if dev < host else "host",
            "speedup_device_over_host": round(host / dev, 2),
        }), flush=True)


if __name__ == "__main__":
    main()
