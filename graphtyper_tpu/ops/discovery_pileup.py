"""Per-event aggregation of discovery first-pass observation rows.

The native extract (`gt_fp_extract`, native/gt_first_pass.cpp) turns the
CIGAR pileup of src/typer/caller.cpp:488-1365 into one row per event
occurrence. Every per-event counter the SNP/indel gates consume is then an
exact integer segment-sum / segment-max over those rows:

    hq, lq                  sum of the row's demotion-adjusted deltas
    proper, first, rev, clip  sums of flag bits
    max_mapq, max_distance  segment maxima
    uniq_pos1/2/3           3 smallest distinct supporting read positions
                            (reads arrive position-sorted, so "first three
                            distinct" == "three smallest distinct" — an
                            order-free sort/unique, not a scan)

This module is the aggregation twin pair: a vectorized numpy host path and
a jitted device segment-sum path (engaged for cohort-scale row batches,
where rows from every sample's extract batch into ONE device dispatch). Both are
bit-identical to the monolithic native pass (tests/pipeline/test_fp_rows.py).
"""

from __future__ import annotations

import os

import numpy as np

N_COUNTERS = 11  # hq lq proper first rev clip max_mapq max_dist up1 up2 up3

#: batches of up to this many rows aggregate with the numpy twin (same
#: design as site_scoring.HOST_APPLY_MAX_ROWS; not yet measured on a GPU)
HOST_AGG_MAX_ROWS = int(os.environ.get("GT_FP_HOST_AGG_ROWS", 262144))

#: telemetry mirroring ops/site_scoring
HOST_AGG_ROWS = 0
DEVICE_AGG_ROWS = 0


def _uniq_pos3(r_ev: np.ndarray, r_readpos: np.ndarray, n_events: int) -> np.ndarray:
    """[n_events, 3] int64: the 3 smallest distinct read positions of the
    SNP rows per event, -1-padded (EvSupport.uniq_pos1/2/3 semantics)."""
    out = np.full((n_events, 3), -1, dtype=np.int64)
    mask = r_readpos >= 0
    if not mask.any():
        return out
    ev = r_ev[mask].astype(np.int64)
    pos = r_readpos[mask]
    order = np.lexsort((pos, ev))
    ev = ev[order]
    pos = pos[order]
    keep = np.ones(len(ev), dtype=bool)
    keep[1:] = (ev[1:] != ev[:-1]) | (pos[1:] != pos[:-1])
    ev = ev[keep]
    pos = pos[keep]
    starts = np.searchsorted(ev, np.arange(n_events + 1))
    for k in range(3):
        idx = starts[:-1] + k
        ok = idx < starts[1:]
        out[ok, k] = pos[idx[ok]]
    return out


def _aggregate_host(mat: np.ndarray, n_events: int) -> np.ndarray:
    """numpy twin: mat is the [8, N] int64 row matrix (ev, dhq, dlq, bits,
    mapq, dist + unused slots); returns [n_events, 8] partial counters
    (without uniq columns)."""
    ev, dhq, dlq, bits, mapq, dist = mat[0], mat[1], mat[2], mat[3], mat[4], mat[5]
    out = np.zeros((n_events, 8), dtype=np.int64)
    out[:, 0] = np.bincount(ev, weights=dhq, minlength=n_events)[:n_events]
    out[:, 1] = np.bincount(ev, weights=dlq, minlength=n_events)[:n_events]
    out[:, 2] = np.bincount(ev, weights=bits & 1, minlength=n_events)[:n_events]
    out[:, 3] = np.bincount(ev, weights=(bits >> 1) & 1, minlength=n_events)[:n_events]
    out[:, 4] = np.bincount(ev, weights=(bits >> 2) & 1, minlength=n_events)[:n_events]
    out[:, 5] = np.bincount(ev, weights=(bits >> 3) & 1, minlength=n_events)[:n_events]
    np.maximum.at(out[:, 6], ev, mapq)
    np.maximum.at(out[:, 7], ev, dist)
    return out


from functools import lru_cache


@lru_cache(maxsize=1)
def _jitted_agg_cached():
    import jax

    from graphtyper_tpu.utils.device import enable_compilation_cache

    enable_compilation_cache()

    from functools import partial

    @partial(jax.jit, static_argnames=("n_events",))
    def agg(mat, n_events: int):
        import jax.numpy as jnp

        ev = mat[0]
        sums = jnp.stack(
            [mat[1], mat[2], mat[3] & 1, (mat[3] >> 1) & 1, (mat[3] >> 2) & 1, (mat[3] >> 3) & 1],
            axis=1,
        )
        # padding rows carry ev = n_events (one overflow slot, dropped after)
        summed = jax.ops.segment_sum(sums, ev, num_segments=n_events + 1)
        maxed = jax.ops.segment_max(
            jnp.stack([mat[4], mat[5]], axis=1), ev, num_segments=n_events + 1
        )
        # empty segments return the dtype minimum from segment_max; counters
        # start at 0 in EvSupport, so clamp up (every real event has rows,
        # but padded power-of-2 tails do not)
        maxed = jnp.maximum(maxed, 0)
        return jnp.concatenate([summed, maxed], axis=1)

    return agg


def aggregate_rows(
    r_ev: np.ndarray,
    r_dhq: np.ndarray,
    r_dlq: np.ndarray,
    r_bits: np.ndarray,
    r_mapq: np.ndarray,
    r_dist: np.ndarray,
    r_readpos: np.ndarray,
    n_events: int,
    device: bool | None = None,
) -> np.ndarray:
    """Aggregate observation rows into the [n_events, 11] counter matrix the
    gates consume (gt_fp_gates counters layout). Rows may span multiple
    samples' extracts when the caller offsets event ids — the batched cohort
    form that makes the device dispatch worthwhile."""
    global HOST_AGG_ROWS, DEVICE_AGG_ROWS
    n = len(r_ev)
    out = np.zeros((n_events, N_COUNTERS), dtype=np.int64)
    if n == 0:
        out[:, 8:11] = -1
        return out
    if device is None:
        from graphtyper_tpu.utils.device import gpu_available

        device = n > HOST_AGG_MAX_ROWS and gpu_available()
    mat = np.zeros((6, n), dtype=np.int32)
    mat[0] = r_ev
    mat[1] = r_dhq
    mat[2] = r_dlq
    mat[3] = r_bits
    mat[4] = r_mapq
    mat[5] = r_dist
    if device:
        DEVICE_AGG_ROWS += n
        # pad rows to coarse power-of-two buckets so compiled shapes reuse
        n_pad = 1 << max(12, (n - 1).bit_length())
        if n_pad > n:
            pad = np.zeros((6, n_pad - n), dtype=np.int32)
            pad[0] = n_events  # overflow segment
            mat = np.concatenate([mat, pad], axis=1)
        agg = _jitted_agg_cached()(mat, n_events)
        out[:, :8] = np.asarray(agg)[:n_events].astype(np.int64)
    else:
        HOST_AGG_ROWS += n
        out[:, :8] = _aggregate_host(mat.astype(np.int64), n_events)
    out[:, 8:11] = _uniq_pos3(r_ev, r_readpos, n_events)
    return out


def count_pairs(p_a: np.ndarray, p_b: np.ndarray, n_events: int):
    """Compact raw phase-pair rows into unique (a, b) -> count arrays
    (the per-event phase maps of caller.cpp:1204-1236). Order-free."""
    if len(p_a) == 0:
        return (
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int64),
        )
    key = p_a.astype(np.int64) * np.int64(n_events) + p_b.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    return (
        (uniq // n_events).astype(np.int32),
        (uniq % n_events).astype(np.int32),
        counts.astype(np.int64),
    )
