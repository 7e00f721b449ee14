"""Batched device scoring for the production caller.

The reference applies each read to each overlapped variant site one at a
time (haplotype.cpp:462-585 explain_to_score — the diploid PL-triangle
update — plus coverage_to_gts :315-361 and the VarStats accumulators
:228-313). Every one of those updates is an integer accumulation, so summed
over a batch of (read, site) observations they decompose into exact
segment-sums and a Gram-matrix term:

    delta[x, y] = u_x + u_y + W_xy
    u = B^T (eps - 1),   W = B^T diag(2 - eps) B

over the per-observation explains bitmap B [N, A] and epsilon exponents
eps [N] (see ops/likelihood.py for the derivation). This module batches the
whole pool's observations per allele-count tier and applies them in one
jitted device pass per tier — the batched replacement for the reference's
per-read scalar loop, bit-identical to it: all sums are int32-exact and
order-independent, and the read-depth saturation gate
(haplotype.cpp:528-533) is preserved via the host-tracked `apply_score`
mask.

Observation extraction (which reads explain which alleles) happens in
typer/scoring.py; this module only turns buffered observations into site
state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

# coverage class encoding for buffered observations (host codes NO/MULTI_*
# as large sentinels; the device buffer uses small negatives so real allele
# classes can index per-allele segment sums directly)
COV_MULTI_ALT = -1
COV_MULTI_REF = -2
COV_PAD = -3

ALLELE_TIERS = (2, 4, 8, 16, 32, 64)

#: observation bytes actually shipped host->device across all flushes
#: (host-applied tiers ship nothing) — telemetry for the H2D-per-read budget
H2D_BYTES_SHIPPED = 0

#: duty-cycle telemetry (VERDICT r3 #1): observation rows applied on host vs
#: device, and wall seconds spent inside device launch+collect. Written as
#: one JSON line per finalize() to $GT_SCORING_STATS (O_APPEND, so region
#: worker processes can share one file) when that env var is set.
HOST_APPLY_ROWS = 0
DEVICE_APPLY_ROWS = 0
DEVICE_WALL_S = 0.0
HOST_APPLY_WALL_S = 0.0
MATERIALIZE_WALL_S = 0.0


_STATS_SNAPSHOT = {"host_rows": 0, "device_rows": 0, "device_wall_s": 0.0,
                   "host_apply_wall_s": 0.0, "materialize_wall_s": 0.0, "h2d_bytes": 0,
                   "align_rows": 0, "align_wall_s": 0.0}


def _write_scoring_stats() -> None:
    """Append the DELTA since the last write (one line per finalize), so
    consumers can sum lines across processes without double counting."""
    import json
    import os
    import sys

    path = os.environ.get("GT_SCORING_STATS")
    if not path:
        return
    # verdict-kernel duty (ops/device_align counters); read lazily so the
    # stats writer never forces that module (and its jax deps) to import
    da = sys.modules.get("graphtyper_tpu.ops.device_align")
    now = {
        "host_rows": HOST_APPLY_ROWS,
        "device_rows": DEVICE_APPLY_ROWS,
        "device_wall_s": DEVICE_WALL_S,
        "host_apply_wall_s": HOST_APPLY_WALL_S,
        "materialize_wall_s": MATERIALIZE_WALL_S,
        "h2d_bytes": H2D_BYTES_SHIPPED,
        "align_rows": da.ALIGN_ROWS_DISPATCHED if da else 0,
        "align_wall_s": da.ALIGN_WALL_S if da else 0.0,
    }
    delta = {k: now[k] - _STATS_SNAPSHOT[k] for k in now}
    _STATS_SNAPSHOT.update(now)
    delta = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in delta.items()}
    delta["pid"] = os.getpid()
    line = json.dumps(delta)
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, (line + "\n").encode())
    finally:
        os.close(fd)

#: columns of one observation row, in buffer order
OBS_FIELDS = (
    "site",
    "sample",
    "eps",
    "apply_score",
    "bits_lo",
    "bits_hi",
    "cov",
    "clipped_scaled",
    "clipped_flag",
    "mapq_sq",
    "mm_scaled",
    "sdiff",
    "strand",
    "proper",
)


def tier_for(cnum: int) -> int | None:
    for t in ALLELE_TIERS:
        if cnum <= t:
            return t
    return None  # host fallback for >64-allele sites (rare)


@lru_cache(maxsize=None)
def _triangle_xy(A: int) -> tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    for y in range(A):
        for x in range(y + 1):
            xs.append(x)
            ys.append(y)
    return np.asarray(xs), np.asarray(ys)


@lru_cache(maxsize=1)
def _jitted_apply_tier():
    """Build the jitted observation-application kernel (jax imported lazily
    so importing the scorer does not pull in the device runtime)."""
    from functools import partial

    import jax

    from graphtyper_tpu.utils.device import enable_compilation_cache

    enable_compilation_cache()
    return partial(jax.jit, static_argnames=("A", "n_sites", "n_samples"))(_apply_tier_impl)


def _apply_tier_impl(obs_mat, A: int, n_sites: int, n_samples: int) -> dict:
    """One chunk of observations -> segment-summed state deltas.

    `obs_mat` is one [14, N] int32 matrix (OBS_FIELDS row order) so the whole
    chunk ships to the device in a single transfer. Padding rows carry
    eps=0, bits=0, cov=COV_PAD, zero scalars and contribute nothing.
    """
    import jax
    import jax.numpy as jnp

    S = n_sites * n_samples
    xs, ys = _triangle_xy(A)

    rows = {k: obs_mat[i].astype(jnp.int32) for i, k in enumerate(OBS_FIELDS)}
    obs = rows
    site = obs["site"]
    sample = obs["sample"]
    cov = obs["cov"]
    apply_score = obs["apply_score"]

    # explains bitmap [N, A]
    bits_lo = obs_mat[OBS_FIELDS.index("bits_lo")].astype(jnp.uint32)
    bits_hi = obs_mat[OBS_FIELDS.index("bits_hi")].astype(jnp.uint32)
    lo_bits = (bits_lo[:, None] >> jnp.arange(min(A, 32), dtype=jnp.uint32)[None, :]) & 1
    if A > 32:
        hi_bits = (bits_hi[:, None] >> jnp.arange(A - 32, dtype=jnp.uint32)[None, :]) & 1
        B = jnp.concatenate([lo_bits, hi_bits], axis=1).astype(jnp.int32)
    else:
        B = lo_bits.astype(jnp.int32)

    seg = site * n_samples + sample

    # -- PL triangle (explain_to_score) --------------------------------
    e = jnp.where(apply_score > 0, obs["eps"], 0)
    Bm = B * (apply_score > 0)[:, None].astype(jnp.int32)
    u = jax.ops.segment_sum((e - 1)[:, None] * Bm, seg, num_segments=S)  # [S, A]
    BB = (Bm[:, :, None] * Bm[:, None, :]) * (2 - e)[:, None, None]  # [N, A, A]
    W = jax.ops.segment_sum(BB.reshape(-1, A * A), seg, num_segments=S).reshape(S, A, A)
    dense = u[:, :, None] + u[:, None, :] + W
    log_delta = dense[:, xs, ys]  # [S, T] triangle layout, index = x + y(y+1)/2

    # -- coverage_to_gts ------------------------------------------------
    is_allele = cov >= 0
    cov_oh = (cov[:, None] == jnp.arange(A)[None, :]).astype(jnp.int32)
    gt_cov = jax.ops.segment_sum(cov_oh, seg, num_segments=S)  # [S, A]
    is_multi = (cov == COV_MULTI_REF) | (cov == COV_MULTI_ALT)
    amb = jax.ops.segment_sum(is_multi.astype(jnp.int32), seg, num_segments=S)
    amb_alt = jax.ops.segment_sum((cov == COV_MULTI_ALT).astype(jnp.int32), seg, num_segments=S)
    alt_pp = jax.ops.segment_sum(
        (((cov == COV_MULTI_ALT) | (is_allele & (cov > 0))) & (obs["proper"] > 0)).astype(jnp.int32),
        seg,
        num_segments=S,
    )

    # -- VarStats (per site) --------------------------------------------
    # every observation has coverage != NO_COVERAGE (explains is non-empty),
    # so the site-level accumulators take every real row
    clip_reads = jax.ops.segment_sum(obs["clipped_flag"], site, num_segments=n_sites)
    site_mapq_sq = jax.ops.segment_sum(obs["mapq_sq"], site, num_segments=n_sites)

    # per-allele accumulators only when the read supports exactly one allele
    acov = jnp.where(is_allele, cov, 0)
    aseg = site * A + acov
    amask = is_allele.astype(jnp.int32)
    SA = n_sites * A
    pa_clip = jax.ops.segment_sum(obs["clipped_scaled"] * amask, aseg, num_segments=SA)
    pa_mapq = jax.ops.segment_sum(obs["mapq_sq"] * amask, aseg, num_segments=SA)
    pa_mm = jax.ops.segment_sum(obs["mm_scaled"] * amask, aseg, num_segments=SA)
    pa_sdiff = jax.ops.segment_sum(obs["sdiff"] * amask, aseg, num_segments=SA)
    strand_seg = aseg * 4 + obs["strand"]
    pa_strand = jax.ops.segment_sum(amask, strand_seg, num_segments=SA * 4)

    # single flat output vector: one D2H fetch instead of twelve
    return jnp.concatenate([
        log_delta.reshape(-1),
        gt_cov.reshape(-1),
        amb.reshape(-1),
        amb_alt.reshape(-1),
        alt_pp.reshape(-1),
        clip_reads.reshape(-1),
        site_mapq_sq.reshape(-1),
        pa_clip.reshape(-1),
        pa_mapq.reshape(-1),
        pa_mm.reshape(-1),
        pa_sdiff.reshape(-1),
        pa_strand.reshape(-1),
    ])


def _split_out_vec(vec: np.ndarray, A: int, n_sites: int, n_samples: int) -> dict:
    """Host-side split of the kernel's flat output vector."""
    S = n_sites * n_samples
    T = A * (A + 1) // 2
    sizes = [S * T, S * A, S, S, S, n_sites, n_sites, n_sites * A, n_sites * A,
             n_sites * A, n_sites * A, n_sites * A * 4]
    parts = np.split(vec, np.cumsum(sizes)[:-1])
    return dict(
        log_delta=parts[0].reshape(S, T),
        gt_cov=parts[1].reshape(S, A),
        amb=parts[2],
        amb_alt=parts[3],
        alt_pp=parts[4],
        clip_reads=parts[5],
        site_mapq_sq=parts[6],
        pa_clip=parts[7].reshape(n_sites, A),
        pa_mapq=parts[8].reshape(n_sites, A),
        pa_mm=parts[9].reshape(n_sites, A),
        pa_sdiff=parts[10].reshape(n_sites, A),
        pa_strand=parts[11].reshape(n_sites, A, 4),
    )


def _chunk_rows(A: int) -> int:
    """Rows per device call, sized so the [N, A, A] Gram tensor stays small."""
    return max(4096, min(1 << 18, (1 << 23) // (A * A)))


def _row_bucket(rows: int) -> int:
    """Pad row counts to quarter-power-of-two buckets (floor 1024): bounds
    jit recompiles to ~4 shapes per octave while capping transfer padding
    waste at 25% (plain pow2 padding wastes up to 100%)."""
    if rows <= 1024:
        return 1024
    b = 1 << (rows - 1).bit_length()
    for cand in (b * 5 // 8, b * 3 // 4, b * 7 // 8, b):
        if rows <= cand:
            return cand
    return b


@lru_cache(maxsize=None)
def _jitted_apply_tier_sharded(mesh_key):
    """Multi-device variant of the observation-application kernel:
    observation rows are data-parallel over the mesh and the per-(site,
    sample) integer state deltas are psum-reduced — the production analog of
    the reference's thread-pool merge (SURVEY §2.5 'reduction across
    threads'). Exact: integer segment-sums commute with psum."""
    from functools import partial

    import jax
    from jax.sharding import PartitionSpec as P

    mesh = _MESHES[mesh_key]
    axes = tuple(mesh.axis_names)  # observation rows shard over every axis

    def sharded(obs_mat, A, n_sites, n_samples):
        out = _apply_tier_impl(obs_mat, A, n_sites, n_samples)
        return jax.lax.psum(out, axes)

    def build(A, n_sites, n_samples):
        body = partial(sharded, A=A, n_sites=n_sites, n_samples=n_samples)
        return jax.jit(
            jax.shard_map(body, mesh=mesh, in_specs=(P(None, axes),), out_specs=P(), check_vma=False)
        )

    return lru_cache(maxsize=None)(build)


_MESHES: dict = {}


def register_mesh(mesh) -> str:
    """Make a mesh usable by ObsBatcher(mesh_key=...); returns its key."""
    key = f"mesh{id(mesh)}"
    _MESHES[key] = mesh
    return key


def _apply_rows_numpy(cols_np: dict, n: int, A: int, n_sites: int, n_samples: int) -> dict:
    """Vectorized host twin of _apply_tier_impl: the same segment sums via
    np.bincount, returning the same totals dict as _split_out_vec (so host
    and device flushes accumulate interchangeably and materialize once).
    Exact: every sum is an integer accumulation, and float64 bincount
    weights are exact far beyond these magnitudes (< 2^53)."""
    S = n_sites * n_samples
    site = cols_np["site"][:n].astype(np.int64)
    sample = cols_np["sample"][:n].astype(np.int64)
    cov = cols_np["cov"][:n].astype(np.int64)
    apply_score = cols_np["apply_score"][:n] > 0
    eps = cols_np["eps"][:n].astype(np.int64)
    seg = site * n_samples + sample

    bits_lo = cols_np["bits_lo"][:n].astype(np.uint64)
    bits_hi = cols_np["bits_hi"][:n].astype(np.uint64)
    bits = bits_lo | (bits_hi << np.uint64(32))
    B = ((bits[:, None] >> np.arange(A, dtype=np.uint64)[None, :]) & np.uint64(1)).astype(np.int64)

    def seg_sum(idx, w, size):
        return np.bincount(idx, weights=w.astype(np.float64), minlength=size).astype(np.int64)

    # -- PL triangle (explain_to_score) ---------------------------------
    e = np.where(apply_score, eps, 0)
    Bm = B * apply_score[:, None]
    xs, ys = _triangle_xy(A)
    T = len(xs)
    u = np.stack([seg_sum(seg, (e - 1) * Bm[:, a], S) for a in range(A)], axis=1)  # [S, A]
    w2 = 2 - e
    log_delta = np.empty((S, T), dtype=np.int64)
    for t in range(T):
        W_t = seg_sum(seg, Bm[:, xs[t]] * Bm[:, ys[t]] * w2, S)
        log_delta[:, t] = u[:, xs[t]] + u[:, ys[t]] + W_t

    # -- coverage_to_gts --------------------------------------------------
    is_allele = cov >= 0
    gt_cov = np.stack([seg_sum(seg, (cov == a).astype(np.int64), S) for a in range(A)], axis=1)
    is_multi = (cov == COV_MULTI_REF) | (cov == COV_MULTI_ALT)
    amb = seg_sum(seg, is_multi.astype(np.int64), S)
    amb_alt = seg_sum(seg, (cov == COV_MULTI_ALT).astype(np.int64), S)
    proper = cols_np["proper"][:n] > 0
    alt_pp_mask = ((cov == COV_MULTI_ALT) | (is_allele & (cov > 0))) & proper
    alt_pp = seg_sum(seg, alt_pp_mask.astype(np.int64), S)

    # -- VarStats ----------------------------------------------------------
    clip_reads = seg_sum(site, cols_np["clipped_flag"][:n], n_sites)
    site_mapq_sq = seg_sum(site, cols_np["mapq_sq"][:n], n_sites)
    acov = np.where(is_allele, cov, 0)
    aseg = site * A + acov
    amask = is_allele.astype(np.int64)
    SA = n_sites * A
    pa_clip = seg_sum(aseg, cols_np["clipped_scaled"][:n] * amask, SA).reshape(n_sites, A)
    pa_mapq = seg_sum(aseg, cols_np["mapq_sq"][:n] * amask, SA).reshape(n_sites, A)
    pa_mm = seg_sum(aseg, cols_np["mm_scaled"][:n] * amask, SA).reshape(n_sites, A)
    pa_sdiff = seg_sum(aseg, cols_np["sdiff"][:n] * amask, SA).reshape(n_sites, A)
    strand_seg = aseg * 4 + cols_np["strand"][:n].astype(np.int64)
    pa_strand = seg_sum(strand_seg, amask, SA * 4).reshape(n_sites, A, 4)

    return dict(
        log_delta=log_delta,
        gt_cov=gt_cov,
        amb=amb,
        amb_alt=amb_alt,
        alt_pp=alt_pp,
        clip_reads=clip_reads,
        site_mapq_sq=site_mapq_sq,
        pa_clip=pa_clip,
        pa_mapq=pa_mapq,
        pa_mm=pa_mm,
        pa_sdiff=pa_sdiff,
        pa_strand=pa_strand,
    )


def apply_obs_host(
    site,
    sample: int,
    eps: int,
    apply_score: bool,
    explains,
    cov_code: int,
    clipped_scaled: int,
    clipped_flag: int,
    mapq_sq: int,
    mm_scaled: int,
    sdiff: int,
    strand: int,
    proper: int,
) -> None:
    """Apply one observation row directly to HaplotypeSite state — the exact
    integer updates of _apply_tier, for sites whose allele count exceeds the
    device bitmask tiers (>64)."""
    cnum = site.gt.num
    vs = site.var_stats
    vs.clipped_reads += clipped_flag
    vs.mapq_squared += mapq_sq
    is_allele = cov_code >= 0
    if is_allele:
        pa = vs.per_allele[cov_code]
        pa.clipped_bp += clipped_scaled
        pa.mapq_squared += mapq_sq
        pa.mismatches += mm_scaled
        pa.score_diff += sdiff
        rs = vs.read_strand[cov_code]
        if strand == 0:
            rs.r1_forward += 1
        elif strand == 1:
            rs.r2_forward += 1
        elif strand == 2:
            rs.r1_reverse += 1
        else:
            rs.r2_reverse += 1
    hs = site.hap_samples[sample]
    if apply_score:
        ex = [a for a in explains if a < cnum]
        exset = set(ex)
        i = 0
        for y in range(cnum):
            in_y = y in exset
            for x in range(y + 1):
                in_x = x in exset
                if in_x and in_y:
                    hs.log_score[i] += eps
                elif in_x or in_y:
                    hs.log_score[i] += eps - 1
                i += 1
        hs.max_log_score += eps
    if cov_code == COV_MULTI_REF:
        hs.ambiguous_depth = min(hs.ambiguous_depth + 1, 0xFF)
    elif cov_code == COV_MULTI_ALT:
        hs.ambiguous_depth = min(hs.ambiguous_depth + 1, 0xFF)
        hs.ambiguous_depth_alt = min(hs.ambiguous_depth_alt + 1, 0xFF)
        if proper:
            hs.alt_proper_pair_depth = min(hs.alt_proper_pair_depth + 1, 0xFF)
    else:
        if hs.gt_coverage[cov_code] < 0xFFFF:
            hs.gt_coverage[cov_code] += 1
        if cov_code > 0 and proper:
            hs.alt_proper_pair_depth = min(hs.alt_proper_pair_depth + 1, 0xFF)


@dataclass
class _TierBuffer:
    A: int
    site_ids: list[int] = field(default_factory=list)  # global site index per slot
    slot_of: dict[int, int] = field(default_factory=dict)
    cols: dict[str, list] = field(default_factory=lambda: {k: [] for k in OBS_FIELDS})
    # bulk numpy blocks (native caller feed) — concatenated with `cols` at
    # finalize; avoids per-element Python list churn for large pools
    blocks: list[dict] = field(default_factory=list)

    def slot(self, global_site: int) -> int:
        s = self.slot_of.get(global_site)
        if s is None:
            s = len(self.site_ids)
            self.slot_of[global_site] = s
            self.site_ids.append(global_site)
        return s

    def materialize_cols(self) -> tuple[dict, int]:
        """Concatenate list-cols and numpy blocks into one array per field."""
        out = {}
        n = 0
        for k in OBS_FIELDS:
            parts = [np.asarray(b[k], dtype=np.int64) for b in self.blocks]
            if self.cols[k]:
                parts.append(np.asarray(self.cols[k], dtype=np.int64))
            out[k] = np.concatenate(parts) if parts else np.zeros(0, np.int64)
            n = len(out[k])
        return out, n


class ObsBatcher:
    """Accumulates per-(read, site) observations and applies them to the
    HaplotypeSite states in chunked device passes per allele tier."""

    def __init__(self, sites, n_samples: int, mesh_key: str | None = None):
        self.sites = sites
        self.n_samples = n_samples
        self.tiers: dict[int, _TierBuffer] = {}
        self.mesh_key = mesh_key  # set -> multi-chip sharded application
        self._totals: dict = {}  # tier -> running flush totals (site-major)
        # exact saturation tracking (haplotype.cpp:528-533): max_log_score is
        # the running sum of applied eps; a read is skipped for scoring once
        # the sum reaches 0xFFFF - eps
        self._eps_sum = np.zeros((len(sites), n_samples), dtype=np.int64)

    def add(
        self,
        site_idx: int,
        cnum: int,
        sample: int,
        eps: int,
        explains,
        cov_code: int,
        clipped_scaled: int,
        clipped_flag: int,
        mapq_sq: int,
        mm_scaled: int,
        sdiff: int,
        strand: int,
        proper: int,
    ) -> None:
        tier = tier_for(cnum)
        buf = self.tiers.get(tier)
        if buf is None:
            buf = self.tiers[tier] = _TierBuffer(A=tier)
        apply_score = self._eps_sum[site_idx, sample] < 0xFFFF - eps
        if apply_score:
            self._eps_sum[site_idx, sample] += eps
        lo = 0
        hi = 0
        for a in explains:
            if a < cnum:
                if a < 32:
                    lo |= 1 << a
                else:
                    hi |= 1 << (a - 32)
        c = buf.cols
        c["site"].append(buf.slot(site_idx))
        c["sample"].append(sample)
        c["eps"].append(eps)
        c["apply_score"].append(1 if apply_score else 0)
        c["bits_lo"].append(lo)
        c["bits_hi"].append(hi)
        c["cov"].append(cov_code)
        c["clipped_scaled"].append(clipped_scaled)
        c["clipped_flag"].append(clipped_flag)
        c["mapq_sq"].append(mapq_sq)
        c["mm_scaled"].append(mm_scaled)
        c["sdiff"].append(sdiff)
        c["strand"].append(strand)
        c["proper"].append(proper)

    # ------------------------------------------------------------------

    def maybe_flush(self, max_rows: int = 2_000_000) -> None:
        """Apply buffered observations to the device-side running totals if
        the buffer grew past `max_rows` — keeps host memory flat when the
        streaming caller feeds millions of rows per pool."""
        for tier, buf in self.tiers.items():
            n = sum(len(np.atleast_1d(b["site"])) for b in buf.blocks) + len(buf.cols["site"])
            if n >= max_rows:
                self._flush_tier(tier, buf)

    def finalize(self) -> None:
        """Run the device passes and materialize all accumulated site state.

        All tiers and chunks are dispatched first (jax dispatch is
        asynchronous, so the H2D + kernel launches queue without blocking),
        and results are fetched afterwards, so transfers overlap across
        tiers instead of serializing."""
        pending = [
            (tier, buf, self._flush_tier_launch(tier, buf))
            for tier, buf in self.tiers.items()
        ]
        global MATERIALIZE_WALL_S
        for tier, buf, launched in pending:
            self._flush_tier_collect(tier, launched)
            totals = self._totals.pop(tier, None)
            if totals is not None:
                _t_m0 = __import__("time").perf_counter()
                self._materialize(buf, totals, buf.A)
                MATERIALIZE_WALL_S += __import__("time").perf_counter() - _t_m0
        _write_scoring_stats()

    def _accumulate(self, tier: int, out: dict) -> None:
        """Add one flush's outputs into the running totals, growing the
        site-major arrays when the padded site bucket grew between flushes."""
        prev = self._totals.get(tier)
        if prev is None:
            self._totals[tier] = out
            return
        for k, v in out.items():
            p = prev[k]
            if p.shape[0] < v.shape[0]:
                widths = [(0, v.shape[0] - p.shape[0])] + [(0, 0)] * (p.ndim - 1)
                p = np.pad(p, widths)
            p[: v.shape[0]] += v
            prev[k] = p

    # rows up to this apply on host via the vectorized numpy twin of the
    # device kernel (_apply_rows_numpy). The value sits at the 2M
    # streaming-flush boundary (maybe_flush) and has not been measured on a
    # GPU; GT_HOST_APPLY_ROWS overrides it (0 = always device).
    HOST_APPLY_MAX_ROWS = int(__import__("os").environ.get("GT_HOST_APPLY_ROWS", 2_000_000))

    # running telemetry: observation bytes actually shipped host->device
    # (host-applied tiers ship nothing); read by tools/stats and STATUS

    def _flush_tier(self, tier: int, buf: "_TierBuffer") -> None:
        self._flush_tier_collect(tier, self._flush_tier_launch(tier, buf))

    def _flush_tier_launch(self, tier: int, buf: "_TierBuffer"):
        """Stage + dispatch this tier's chunks (non-blocking); returns the
        pending device vectors for _flush_tier_collect. Tiny tiers are
        applied on host immediately and return no pending work."""
        cols_np, n = buf.materialize_cols()
        buf.blocks = []
        buf.cols = {k: [] for k in OBS_FIELDS}
        if n == 0:
            return []
        A = buf.A
        if n <= self.HOST_APPLY_MAX_ROWS and self.mesh_key is None:
            global HOST_APPLY_ROWS, HOST_APPLY_WALL_S
            HOST_APPLY_ROWS += n
            _t_h0 = __import__("time").perf_counter()
            self._accumulate(tier, _apply_rows_numpy(cols_np, n, A, len(buf.site_ids), self.n_samples))
            HOST_APPLY_WALL_S += __import__("time").perf_counter() - _t_h0
            return []
        global DEVICE_APPLY_ROWS, DEVICE_WALL_S
        DEVICE_APPLY_ROWS += n
        _t_launch0 = __import__("time").perf_counter()
        # pad the site count to coarse power-of-two buckets (floor 256) so
        # the jitted kernel shape is reused across regions and iterations
        # (site ids stay < len(site_ids); pad slots read back as zeros)
        real_sites = len(buf.site_ids)
        n_sites = 1 << max(8, (real_sites - 1).bit_length())
        chunk = _chunk_rows(A)
        import jax.numpy as jnp

        def make_chunk(lo_i: int) -> np.ndarray:
            hi_i = min(n, lo_i + chunk)
            rows = hi_i - lo_i
            n_pad = _row_bucket(rows)
            # int32 halves the transfer bytes; every column fits (the
            # uint32 explain bitmaps ride as their int32 bit patterns and
            # are bitcast back on device)
            mat = np.zeros((len(OBS_FIELDS), n_pad), dtype=np.int32)
            for i, k in enumerate(OBS_FIELDS):
                v = cols_np[k][lo_i:hi_i]
                if k in ("bits_lo", "bits_hi"):
                    mat[i, :rows] = v.astype(np.uint32).view(np.int32)
                else:
                    mat[i, :rows] = v.astype(np.int32)
            if n_pad > rows:
                mat[OBS_FIELDS.index("cov"), rows:] = COV_PAD
            return mat

        launched = []
        for lo_i in range(0, n, chunk):
            mat = make_chunk(lo_i)
            global H2D_BYTES_SHIPPED
            H2D_BYTES_SHIPPED += mat.nbytes
            if self.mesh_key is not None:
                mesh = _MESHES[self.mesh_key]
                n_dev = mesh.devices.size
                n_pad = mat.shape[1]
                if n_pad % n_dev:
                    extra = n_dev - n_pad % n_dev
                    pad = np.zeros((mat.shape[0], extra), dtype=mat.dtype)
                    pad[OBS_FIELDS.index("cov"), :] = COV_PAD
                    mat = np.concatenate([mat, pad], axis=1)
                fn = _jitted_apply_tier_sharded(self.mesh_key)(A, n_sites, self.n_samples)
                vec = fn(jnp.asarray(mat))
            else:
                vec = _jitted_apply_tier()(
                    jnp.asarray(mat),
                    A=A,
                    n_sites=n_sites,
                    n_samples=self.n_samples,
                )
            launched.append((vec, n_sites))
        DEVICE_WALL_S += __import__("time").perf_counter() - _t_launch0
        return launched

    def _flush_tier_collect(self, tier: int, launched) -> None:
        """Block on the dispatched chunks and fold them into the running
        totals."""
        if not launched:
            return
        global DEVICE_WALL_S
        _t_collect0 = __import__("time").perf_counter()
        A = self.tiers[tier].A
        totals: dict[str, np.ndarray] | None = None
        for vec, n_sites in launched:
            # np.array copies: a device array's host view is read-only, and
            # the chunk sums below add into the first chunk's arrays
            out = _split_out_vec(np.array(vec), A, n_sites, self.n_samples)
            if totals is None:
                totals = out
            else:
                for k in totals:
                    totals[k] += out[k]
        if totals is not None:
            self._accumulate(tier, totals)
        DEVICE_WALL_S += __import__("time").perf_counter() - _t_collect0

    def _materialize(self, buf: _TierBuffer, out: dict, A: int) -> None:
        P = self.n_samples
        for slot, gsite in enumerate(buf.site_ids):
            site = self.sites[gsite]
            cnum = site.gt.num
            T = cnum * (cnum + 1) // 2
            vs = site.var_stats
            vs.clipped_reads += int(out["clip_reads"][slot])
            vs.mapq_squared += int(out["site_mapq_sq"][slot])
            for a in range(cnum):
                pa = vs.per_allele[a]
                pa.clipped_bp += int(out["pa_clip"][slot, a])
                pa.mapq_squared += int(out["pa_mapq"][slot, a])
                pa.mismatches += int(out["pa_mm"][slot, a])
                pa.score_diff += int(out["pa_sdiff"][slot, a])
                rs = vs.read_strand[a]
                rs.r1_forward += int(out["pa_strand"][slot, a, 0])
                rs.r2_forward += int(out["pa_strand"][slot, a, 1])
                rs.r1_reverse += int(out["pa_strand"][slot, a, 2])
                rs.r2_reverse += int(out["pa_strand"][slot, a, 3])
            ls_mat = getattr(site, "log_scores", None)
            batched_ls = ls_mat is not None and len(site.hap_samples) == P
            lo = slot * P
            if batched_ls:
                # one add per site: every hap_sample's log_score is a row
                # view of this matrix. The padded-A triangle enumerates
                # (x<=y, y ascending), so the first T entries are exactly
                # the cnum-allele triangle
                ls_mat[:, :T] += out["log_delta"][lo : lo + P, :T]
            cov_mat = getattr(site, "gt_coverages", None)
            batched_cov = cov_mat is not None and len(site.hap_samples) == P
            if batched_cov:
                # gt_coverage rows are views of this matrix too: one clamped
                # add per site replaces P per-sample numpy calls (the scalar
                # twin sums the full delta then clamps — identical)
                np.minimum(
                    cov_mat[:, :cnum] + out["gt_cov"][lo : lo + P, :cnum],
                    0xFFFF,
                    out=cov_mat[:, :cnum],
                )
            # scalar fields: compute the saturating adds vectorized, assign
            # per object (they are plain attributes, not matrix-backed)
            amb_blk = out["amb"][lo : lo + P]
            amba_blk = out["amb_alt"][lo : lo + P]
            apd_blk = out["alt_pp"][lo : lo + P]
            eps_blk = self._eps_sum[gsite]
            for p in range(P):
                hs = site.hap_samples[p]
                if not batched_ls:
                    hs.log_score[:T] += out["log_delta"][lo + p][:T]
                if not batched_cov:
                    hs.gt_coverage[:cnum] = np.minimum(
                        hs.gt_coverage[:cnum] + out["gt_cov"][lo + p][:cnum], 0xFFFF
                    )
                hs.max_log_score += int(eps_blk[p])
                hs.ambiguous_depth = min(hs.ambiguous_depth + int(amb_blk[p]), 0xFF)
                hs.ambiguous_depth_alt = min(hs.ambiguous_depth_alt + int(amba_blk[p]), 0xFF)
                hs.alt_proper_pair_depth = min(hs.alt_proper_pair_depth + int(apd_blk[p]), 0xFF)
