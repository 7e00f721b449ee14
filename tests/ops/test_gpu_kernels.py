"""The device kernels compiled for the card against their host twins,
exactly (all of their arithmetic is integer). Skips without a GPU; on a
card: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("A", [2, 8, 32])
def test_site_scoring_multi_chunk_on_card(gpu, A, monkeypatch):
    from graphtyper_tpu.ops import site_scoring as ss

    monkeypatch.setattr(ss, "_chunk_rows", lambda A: 4096)
    rng = np.random.default_rng(A)
    n, n_sites, n_samples = 10_000, 300, 50
    cols = {k: rng.integers(0, 2, n) for k in ss.OBS_FIELDS}
    cols.update(
        site=rng.integers(0, n_sites, n), sample=rng.integers(0, n_samples, n),
        eps=rng.integers(1, 41, n), bits_lo=rng.integers(1, 1 << min(A, 31), n),
        bits_hi=np.zeros(n, np.int64), cov=rng.integers(-2, A, n),
        mapq_sq=rng.integers(0, 3601, n), strand=rng.integers(0, 4, n),
    )
    batcher = ss.ObsBatcher([None] * n_sites, n_samples)
    batcher.HOST_APPLY_MAX_ROWS = 0
    buf = ss._TierBuffer(A=A)
    buf.site_ids = list(range(n_sites))
    buf.blocks = [cols]
    batcher.tiers[A] = buf
    batcher._flush_tier(A, buf)
    want = ss._apply_rows_numpy(cols, n, A, n_sites, n_samples)
    for k, v in want.items():
        np.testing.assert_array_equal(batcher._totals[A][k][: v.shape[0]], v, err_msg=k)


def test_pileup_and_seed_probe_on_card(gpu):
    from graphtyper_tpu.ops import discovery_pileup as dp
    from graphtyper_tpu.ops import seed_probe as sp

    rng = np.random.default_rng(0)
    n, n_ev = 1 << 16, 5000
    rows = [np.sort(rng.integers(0, n_ev, n))] + [rng.integers(0, 60, n) for _ in range(6)]
    rows = [r.astype(np.int32) for r in rows]
    np.testing.assert_array_equal(
        dp.aggregate_rows(*rows, n_ev, device=True), dp.aggregate_rows(*rows, n_ev, device=False)
    )
    keys = np.unique(rng.integers(0, 2**63, 20_000, dtype=np.uint64))
    seeder = sp.DeviceSeeder(keys)
    S, nk = 4096, 4
    hi = rng.integers(0, 2**32, (S, nk), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, (S, nk), dtype=np.uint64).astype(np.uint32)
    valid = np.ones((S, nk), np.uint8)
    got = seeder.probe_bits(sp.stage_kmers(hi, lo, valid), S, nk)
    want = sp.probe_bits_host(hi, lo, valid, np.asarray(seeder.bitset), nk, seeder.bits)
    np.testing.assert_array_equal(got, want)
