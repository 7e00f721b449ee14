"""SW kernel tests: batched row-scan DP vs a brute-force reference DP."""

import numpy as np
import pytest

from graphtyper_tpu.ops.sw import align_batch, align_one

NEG = -(10**6)


def brute_force(q, d, match=1, mismatch=4, go=7, ge=1, clip=5):
    """Slow exact DP with the same model: db ends free, affine gaps, flat
    query clip penalties. Returns best score."""
    m, n = len(q), len(d)
    H = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    F = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    H[0, :] = 0
    best = NEG
    for i in range(1, m + 1):
        for j in range(0, n + 1):
            if j > 0:
                s = match if q[i - 1] == d[j - 1] else -mismatch
                if q[i - 1] >= 4 or d[j - 1] >= 4:
                    s = 0
                diag = H[i - 1, j - 1]
                if i - 1 > 0:
                    diag = max(diag, -clip)  # clip query head, restart
                E[i, j] = max(H[i, j - 1] - go, E[i, j - 1] - ge)
                Mv = diag + s
            else:
                Mv = NEG
            F[i, j] = max(H[i - 1, j] - go, F[i - 1, j] - ge)
            H[i, j] = max(Mv, E[i, j], F[i, j])
        if i < m:
            best = max(best, H[i, 1:].max() - clip)
    best = max(best, H[m, 1:].max())
    return int(best)


@pytest.mark.parametrize("seed", range(6))
def test_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    B = 8
    qs, ds, qlens, dlens = [], [], [], []
    for _ in range(B):
        m = int(rng.integers(8, 30))
        n = int(rng.integers(15, 60))
        qs.append(rng.integers(0, 4, size=m).astype(np.uint8))
        ds.append(rng.integers(0, 4, size=n).astype(np.uint8))
        qlens.append(m)
        dlens.append(n)
    M = max(qlens)
    N = max(dlens)
    Q = np.full((B, M), 5, dtype=np.uint8)
    D = np.full((B, N), 5, dtype=np.uint8)
    for b in range(B):
        Q[b, : qlens[b]] = qs[b]
        D[b, : dlens[b]] = ds[b]
    res = align_batch(Q, np.array(qlens), D, np.array(dlens))
    for b in range(B):
        want = brute_force(qs[b], ds[b])
        assert res.score[b] == want, f"pair {b}: got {res.score[b]}, want {want}"


def test_perfect_alignment():
    d = b"ACGTACGTAAGGCCTTACGTACGT"
    q = d[5:15]
    res = align_one(q, d)
    assert res.score[0] == len(q)  # all matches
    assert res.database_begin[0] == 5
    assert res.database_end[0] == 15


def test_alignment_with_deletion():
    d = b"AAAACCCCGGGGTTTTAAAACCCC"
    # query matches d with 4 bases deleted (db bases skipped)
    q = d[:8] + d[12:20]
    res = align_one(q, d)
    # 16 matches - gap_open(7) - 3*extend(1) = 16 - 10 = 6
    assert res.score[0] == 16 - 7 - 3
    assert res.database_begin[0] == 0
    assert res.database_end[0] == 20


def test_clip_end_better_than_mismatches():
    d = b"ACGTACGTACGTACGTGGGGCCCC"
    q = d[0:16] + b"TTTTTTTT"  # tail is garbage: clip (5) beats 8 mismatches (32)
    res = align_one(q, d)
    assert res.score[0] == 16 - 5
    assert res.clip_end[0] == 1
