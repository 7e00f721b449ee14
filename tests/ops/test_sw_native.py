"""native/gt_sw.cpp vs the numpy DP oracle (ops/sw.py): bit-parity on
score/begin/end/clip_end across random batches, degenerate lengths, and
N-base inputs. The numpy DP defines the semantics; the C twin is the
production host path."""

import numpy as np
import pytest

from graphtyper_tpu.io.native import get_lib
from graphtyper_tpu.ops import sw

pytestmark = pytest.mark.skipif(get_lib() is None, reason="native lib not built")


def _numpy_oracle(q, ql, d, dl):
    return sw._align_batch_numpy(q, ql, d, dl, 1, 4, 7, 1, 5)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.score, b.score)
    np.testing.assert_array_equal(a.database_begin, b.database_begin)
    np.testing.assert_array_equal(a.database_end, b.database_end)
    np.testing.assert_array_equal(a.clip_end, b.clip_end)


def test_sw_native_random_differential():
    rng = np.random.default_rng(0)
    for trial in range(8):
        B = int(rng.integers(1, 200))
        M = int(rng.integers(8, 180))
        N = int(rng.integers(8, 300))
        q = rng.integers(0, 6, size=(B, M)).astype(np.uint8)  # incl. N/pad codes
        d = rng.integers(0, 6, size=(B, N)).astype(np.uint8)
        # half the queries are noisy windows of their database (realistic hits)
        for i in range(0, B, 2):
            if N > M:
                off = int(rng.integers(0, N - M))
                q[i] = d[i, off : off + M] % 4
        ql = rng.integers(0, M + 1, size=B).astype(np.int32)
        dl = rng.integers(0, N + 1, size=B).astype(np.int32)
        nat = sw.align_batch(q, ql, d, dl)
        ora = _numpy_oracle(q, ql, d, dl)
        _assert_same(nat, ora)


def test_sw_native_indel_cases():
    from graphtyper_tpu.utils.dna import encode

    db = encode(b"ACGTACGTACGTAAATTTCCCGGGACGTACGTACGT")
    # deletion in the query relative to db
    qr = encode(b"ACGTACGTACGTTTCCCGGGACGTACGTACGT")
    B, M, N = 1, len(qr), len(db)
    q = qr.reshape(1, -1).astype(np.uint8)
    d = db.reshape(1, -1).astype(np.uint8)
    ql = np.array([M], np.int32)
    dl = np.array([N], np.int32)
    nat = sw.align_batch(q, ql, d, dl)
    ora = _numpy_oracle(q, ql, d, dl)
    _assert_same(nat, ora)
    assert nat.score[0] > 0


def _random_batch(seed, B=64, Mx=24, Nx=64):
    rng = np.random.default_rng(seed)
    qlens = rng.integers(6, Mx + 1, size=B).astype(np.int32)
    dlens = rng.integers(24, Nx + 1, size=B).astype(np.int32)
    Q = np.full((B, Mx), 5, dtype=np.uint8)
    D = np.full((B, Nx), 5, dtype=np.uint8)
    for b in range(B):
        Q[b, : qlens[b]] = rng.integers(0, 4, qlens[b])
        D[b, : dlens[b]] = rng.integers(0, 4, dlens[b])
    # planted noisy hits so score ties and clip races actually occur
    for b in range(0, B, 2):
        m = qlens[b]
        if dlens[b] >= m:
            st = rng.integers(0, dlens[b] - m + 1)
            Q[b, :m] = D[b, st : st + m]
            Q[b, rng.integers(0, m)] = rng.integers(0, 4)
    return Q, qlens, D, dlens


@pytest.mark.parametrize("seed", range(3))
def test_randomized_parity(seed):
    Q, ql, D, dl = _random_batch(seed)
    _assert_same(sw.align_batch(Q, ql, D, dl), _numpy_oracle(Q, ql, D, dl))


def test_adversarial_ties_and_gaps():
    """Low-entropy repeats maximize tie pressure on the begin/end rules;
    long homopolymers force the affine E/F recurrences through both the
    open and extend arms."""
    rng = np.random.default_rng(99)
    B, Mx, Nx = 32, 20, 48
    qlens = np.full(B, Mx, np.int32)
    dlens = np.full(B, Nx, np.int32)
    Q = rng.integers(0, 2, (B, Mx)).astype(np.uint8)  # AC-only alphabet
    D = rng.integers(0, 2, (B, Nx)).astype(np.uint8)
    Q[0] = 0  # poly-A query vs poly-A database: every start ties
    D[0] = 0
    Q[1, :10] = D[1, 5:15]  # exact prefix hit, garbage tail -> end clip
    Q[1, 10:] = 3
    Q[2] = D[2, :Mx][::-1]  # reversed: mostly mismatches
    # deletion shape: query skips 6 database bases mid-match
    D[3, :24] = rng.integers(0, 4, 24)
    Q[3, :10] = D[3, :10]
    Q[3, 10:20] = D[3, 16:26]
    _assert_same(sw.align_batch(Q, qlens, D, dlens), _numpy_oracle(Q, qlens, D, dlens))


def test_length_edges_and_iupac():
    """qlen shorter than every other row, N codes (>=4) scoring 0, and a
    dlen shorter than the query (forced clip/gap)."""
    Mx, Nx = 16, 32
    rng = np.random.default_rng(7)
    Q = rng.integers(0, 4, (8, Mx)).astype(np.uint8)
    D = rng.integers(0, 4, (8, Nx)).astype(np.uint8)
    qlens = np.array([16, 1, 6, 16, 16, 3, 16, 16], np.int32)
    dlens = np.array([32, 32, 32, 8, 32, 3, 32, 32], np.int32)
    Q[4, 2:9] = 4  # N run inside the query
    D[6, ::3] = 4  # Ns scattered through the database
    Q[7] = D[7, 10 : 10 + Mx]  # perfect full-length hit
    _assert_same(sw.align_batch(Q, qlens, D, dlens), _numpy_oracle(Q, qlens, D, dlens))


def test_align_batch_without_native_uses_numpy(monkeypatch):
    """With no native library the batch runs on the numpy DP, on the host."""
    Q, ql, D, dl = _random_batch(5, B=8)
    want = sw.align_batch(Q, ql, D, dl)
    monkeypatch.setattr(sw, "_align_batch_native", lambda *a, **k: None)
    _assert_same(sw.align_batch(Q, ql, D, dl), want)
