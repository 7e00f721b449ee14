"""Batched semi-global affine Smith-Waterman (host numpy reference).

Replaces the reference's paw AVX512 pairwise aligner as used for indel
realignment (caller.cpp:1855-2007): scores match=1 mismatch=-4 gap_open=7
(first gap base) gap_extend=1 clip=5 (flat per clipped query end), database
columns free on both sides (constants.hpp.in:49-53; paw AlignmentOptions
left/right_column_free + is_clip).

The DP is vectorized across a batch of (query, database) pairs and across
database positions; rows (query bases) are sequential. The within-row gap
dependency resolves with the prefix-max trick:
    E(i,j) = max_k<=j-1 (H'(i,k) + k*ge) - go - (j-1)*ge
which is exact for affine gaps when go >= ge. native/gt_sw.cpp is the
threaded host twin that production runs. Realignment stays on the host: a
GPU kernel measured slower than native/gt_sw.cpp at the pipeline's batch
sizes (tens of pairs per call), see CHANGES.md.

Returns per pair: score, database begin/end of the aligned span, and query
clip lengths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from graphtyper_tpu.constants import (
    SCORE_CLIP,
    SCORE_GAP_EXTEND,
    SCORE_GAP_OPEN,
    SCORE_MATCH,
    SCORE_MISMATCH,
)

NEG = -(10**6)


@dataclass
class SWResult:
    score: np.ndarray  # [B]
    database_begin: np.ndarray  # [B]
    database_end: np.ndarray  # [B] (exclusive-ish: index of last aligned db base + 1)
    clip_begin: np.ndarray  # [B] query bases clipped at start
    clip_end: np.ndarray  # [B] query bases clipped at end


def _running_argmax(T: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Running max and its (latest) argmax along axis 1."""
    cummax = np.maximum.accumulate(T, axis=1)
    n = T.shape[1]
    idx = np.arange(n)
    take = np.where(T >= cummax, idx[None, :], 0)
    run_arg = np.maximum.accumulate(take, axis=1)
    return cummax, run_arg


def align_batch(
    queries: np.ndarray,  # [B, M] uint8 codes, pad=5
    q_lens: np.ndarray,  # [B]
    databases: np.ndarray,  # [B, N] uint8 codes, pad=5
    d_lens: np.ndarray,  # [B]
    match: int = SCORE_MATCH,
    mismatch: int = SCORE_MISMATCH,
    gap_open: int = SCORE_GAP_OPEN,
    gap_extend: int = SCORE_GAP_EXTEND,
    clip: int = SCORE_CLIP,
) -> SWResult:
    """One realignment batch on the host: the native SW, or the numpy DP
    below when the native library is missing."""
    args = (queries, q_lens, databases, d_lens, match, mismatch, gap_open, gap_extend, clip)
    native = _align_batch_native(*args)
    return native if native is not None else _align_batch_numpy(*args)


def _align_batch_numpy(
    queries, q_lens, databases, d_lens, match, mismatch, gap_open, gap_extend, clip
) -> SWResult:
    """The DP itself, vectorized over the batch and the database row: the
    oracle the native SW must match bit for bit."""
    B, M = queries.shape
    _, N = databases.shape
    ge = gap_extend
    go = gap_open

    d_valid = np.arange(N)[None, :] < d_lens[:, None]  # [B, N]

    # H[b, j] for j in 0..N (database prefix length); start free on database
    H = np.zeros((B, N + 1), dtype=np.int32)
    F = np.full((B, N + 1), NEG, dtype=np.int32)
    start = np.tile(np.arange(N + 1)[None, :], (B, 1)).astype(np.int32)

    best_mid = np.full(B, NEG, dtype=np.int32)  # best H(i<m, j) - clip (end clip)
    best_mid_start = np.zeros(B, dtype=np.int32)
    best_mid_end = np.zeros(B, dtype=np.int32)

    jidx = np.arange(1, N + 1)

    q_valid_any = q_lens > 0
    for i in range(1, M + 1):
        row_active = i <= q_lens  # [B]
        qb = queries[:, i - 1]  # [B]
        s = np.where(qb[:, None] == databases, match, -mismatch).astype(np.int32)  # [B, N]
        s = np.where(d_valid & (qb[:, None] < 4) & (databases < 4), s, np.where(d_valid, 0, NEG))
        # N vs N or involving N: treat as 0-score match-free (no penalty)

        # diagonal candidate: continue from H(i-1, j-1) or clip-start (-clip)
        diag_val = H[:, :-1]
        diag_start = start[:, :-1]
        if i - 1 > 0:
            clip_start_val = np.int32(-clip)
            use_clip = clip_start_val > diag_val
            diag_val = np.where(use_clip, clip_start_val, diag_val)
            diag_start = np.where(use_clip, np.arange(N)[None, :], diag_start)
        M_cand = diag_val + s  # [B, N]
        M_start = diag_start

        # gap in database (query base consumed): F
        F_new = np.maximum(H - go, F - ge)  # [B, N+1]
        F_cand = F_new[:, 1:]
        F_start = start[:, 1:]

        H_tmp = np.where(M_cand >= F_cand, M_cand, F_cand)
        S_tmp = np.where(M_cand >= F_cand, M_start, F_start)

        # gap in query (database consumed): E via prefix scan over H_tmp
        T = H_tmp + jidx[None, :] * ge
        runmax, runarg = _running_argmax(T)
        E_val = runmax[:, :-1] - go - jidx[1:][None, :] * ge + ge  # E at j from k<=j-1
        # E(i,j) = max_{k<=j-1}(H_tmp(i,k) + k*ge) - go - (j-1)*ge
        E_start_idx = runarg[:, :-1]

        H_row = np.zeros((B, N + 1), dtype=np.int32)
        S_row = np.zeros((B, N + 1), dtype=np.int32)
        H_row[:, 0] = NEG  # query base consumed but no db start... only via F/clip
        S_row[:, 0] = 0
        H_row[:, 1] = H_tmp[:, 0]
        S_row[:, 1] = S_tmp[:, 0]
        use_E = np.zeros((B, N), dtype=bool)
        use_E[:, 1:] = E_val > H_tmp[:, 1:]
        H_after = np.where(use_E[:, 1:], E_val, H_tmp[:, 1:])
        gathered = np.take_along_axis(S_tmp, E_start_idx, axis=1)
        S_after = np.where(use_E[:, 1:], gathered, S_tmp[:, 1:])
        H_row[:, 2:] = H_after
        S_row[:, 2:] = S_after

        # freeze rows for finished queries
        H = np.where(row_active[:, None], H_row, H)
        start = np.where(row_active[:, None], S_row, start)
        F = np.where(row_active[:, None], F_new, F)

        # track clipped-end candidates (i < q_len): score - clip
        mid_active = row_active & (i < q_lens)
        if mid_active.any():
            jmask = np.concatenate([np.zeros((B, 1), dtype=bool), d_valid], axis=1)
            H_masked = np.where(jmask, H, NEG)
            row_best_j = np.argmax(H_masked, axis=1)
            row_best = H_masked[np.arange(B), row_best_j] - clip
            improve = mid_active & (row_best > best_mid)
            best_mid = np.where(improve, row_best, best_mid)
            best_mid_start = np.where(improve, start[np.arange(B), row_best_j], best_mid_start)
            best_mid_end = np.where(improve, row_best_j, best_mid_end)

    # final scores at full query length
    jmask = np.concatenate([np.zeros((B, 1), dtype=bool), d_valid], axis=1)
    H_masked = np.where(jmask, H, NEG)
    final_j = np.argmax(H_masked, axis=1)
    final_score = H_masked[np.arange(B), final_j]
    final_start = start[np.arange(B), final_j]

    use_clip_end = best_mid > final_score
    score = np.where(use_clip_end, best_mid, final_score)
    db_begin = np.where(use_clip_end, best_mid_start, final_start)
    db_end = np.where(use_clip_end, best_mid_end, final_j)
    score = np.where(q_valid_any, score, 0)

    # clip lengths are not tracked exactly (unused by the caller except in
    # debug); report whether an end clip was used
    clip_end_arr = use_clip_end.astype(np.int32)
    return SWResult(
        score=score.astype(np.int64),
        database_begin=db_begin.astype(np.int64),
        database_end=db_end.astype(np.int64),
        clip_begin=np.zeros(B, dtype=np.int64),
        clip_end=clip_end_arr.astype(np.int64),
    )


def _align_batch_native(
    queries, q_lens, databases, d_lens, match, mismatch, gap_open, gap_extend, clip
) -> SWResult | None:
    """Host CPU path through native/gt_sw.cpp (threaded C twin of the numpy
    DP below, bit-parity tested); returns None when the library is missing
    so the numpy oracle runs instead."""
    import os

    from graphtyper_tpu.io.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    if not getattr(lib, "_sw_ready", False):
        try:
            lib.gt_sw_batch.restype = None
            lib.gt_sw_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int32,
            ]
            lib._sw_ready = True
        except AttributeError:
            return None  # stale .so without the symbol
    B, M = queries.shape
    _, N = databases.shape
    q = np.ascontiguousarray(queries, dtype=np.uint8)
    d = np.ascontiguousarray(databases, dtype=np.uint8)
    ql = np.ascontiguousarray(q_lens, dtype=np.int32)
    dl = np.ascontiguousarray(d_lens, dtype=np.int32)
    score = np.empty(B, dtype=np.int64)
    begin = np.empty(B, dtype=np.int64)
    end = np.empty(B, dtype=np.int64)
    clip_end = np.empty(B, dtype=np.int64)
    vp = ctypes.c_void_p
    n_threads = min(os.cpu_count() or 1, 8) if B >= 64 else 1
    lib.gt_sw_batch(
        vp(q.ctypes.data), vp(ql.ctypes.data), vp(d.ctypes.data), vp(dl.ctypes.data),
        B, M, N, match, mismatch, gap_open, gap_extend, clip,
        vp(score.ctypes.data), vp(begin.ctypes.data), vp(end.ctypes.data),
        vp(clip_end.ctypes.data), n_threads,
    )
    return SWResult(score, begin, end, np.zeros(B, dtype=np.int64), clip_end)


def align_one(query: bytes | np.ndarray, database: bytes | np.ndarray, **kw) -> SWResult:
    from graphtyper_tpu.utils.dna import encode

    q = encode(query) if isinstance(query, (bytes, bytearray)) else query
    d = encode(database) if isinstance(database, (bytes, bytearray)) else database
    qq = np.full((1, len(q)), 5, dtype=np.uint8)
    qq[0, : len(q)] = q
    dd = np.full((1, len(d)), 5, dtype=np.uint8)
    dd[0, : len(d)] = d
    return align_batch(qq, np.array([len(q)]), dd, np.array([len(d)]))
