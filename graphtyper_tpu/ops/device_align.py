"""Device-resident read alignment: the call iteration's align stage on the GPU.

This is the "ship reads, not observations" architecture (the BASELINE north
star): the k-mer index (sorted keys + label arrays) and the graph's reference
arena live in HBM for the lifetime of a call iteration; 2-bit-packed read
batches stream up once (and are cached across call iterations — the reads do
not change, only the graph/index do), and ONE jitted dispatch per batch
resolves, for every read-orientation row, either a complete graph alignment
(a "clean" verdict: placement, mismatches, crossed variant alleles) or a
host-fallback mark. The host C++ engine (native/gt_align.cpp) synthesizes
the exact `Geno` path set for clean rows — skipping its seed+lattice+walk
pipeline entirely — and runs the full `find_genotype_paths` only for
fallback rows. Byte parity with the host algorithm is the contract, enforced
by a verify mode that runs both and compares (GT_DEVICE_ALIGN=verify).

Reference semantics being reproduced (the clean tier): the read's
stride-(K-1) exact k-mer seeds all hit the index at ONE placement whose
labels chain (src/typer/alignment.cpp:23-103 seeding + path-lattice merge;
src/typer/genotype_paths.cpp:21-66 chain condition), the walk extension
covers only the right tail inside a single reference node
(src/graph/graph.cpp:1187-1276 get_labels_forward's single-candidate case),
the tail mismatch count passes the walk budget min(2 + len/11, 7)
(src/typer/genotype_paths.cpp:483-621), and no filter can reorder the
result. The clean-tier rules below are chosen so that every host code path
that could produce anything OTHER than the synthesized single path (Hamming-1
forks at crossed sites, alternative placements, multi-path lattices, special
end positions, var-branching tails) provably cannot fire — anything outside
the tier falls back to the host engine, so coverage costs throughput, never
correctness.

Why each clean rule is sufficient (the parity argument, kept in sync with
tests/ops/test_device_align.py):
  * every kmer's labels share one (start,end) span and chain -> exactly one
    full-length lattice path, mismatches 0, and NO other placement can
    survive: any alternative with <=1 mismatch per kmer would surface as an
    off-span exact label (fallback), and partial chains are strictly shorter
    than the full chain so remove_short_paths drops them before the walk.
  * total mismatches == 0 OR no variant crossed: a Hamming-1 fork at a
    crossed site costs +1 over the chain, so with chain mismatches 0 and
    total m*, a fork ties only when m* >= 1 AND a site is crossed — that
    combination falls back.
  * tail confined to one reference node -> get_labels_forward enumerates
    exactly one candidate (the ref continuation), so the walk cannot fork,
    and the end position is plain (never special).
  * mm <= 2 (and <= 1 when only two kmers fit): an alternative placement
    built purely from Hamming-1 links needs >= nk mismatches, which then
    always loses to the clean path's m*.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np

K = 32
LABEL_CAP = 6  # per-kmer gathered labels; bigger spans fall back
VAR_SLOTS = 6  # chain variant payload slots; more crossed vars fall back
TAIL_PAD = 32  # >= max tail length (30: one more kmer fits at 31)
OUT_COLS = 9  # meta (verdict | mm<<1 | nv<<4), start, end, slot0..5
SPECIAL_START = 0xD0000000
VAR_ID_BITS = 24  # slot encoding: var_id | (kmer_index << 24)
BUCKET_BITS = 14  # prefix-bucket accelerator over the sorted key table


def _ceil_log2(n: int) -> int:
    n = max(2, int(n))
    return int(n - 1).bit_length()


@lru_cache(maxsize=16)
def _jitted_verdicts(nk: int, key_steps: int, ref_steps: int):
    from graphtyper_tpu.utils.device import enable_compilation_cache

    enable_compilation_cache()
    import jax

    return jax.jit(partial(_verdicts_impl, nk=nk, key_steps=key_steps, ref_steps=ref_steps))


def _lower_bound_u64(q_hi, q_lo, keys_hi, keys_lo, steps: int, bounds=None):
    """Vectorized lower_bound over a sorted uint64 array stored as uint32
    halves: first index i with keys[i] >= q. Shapes broadcast over q.
    `bounds` (lo0, hi0) narrows the search range per query (prefix-bucket
    accelerator — the device twin of native/gt_align.cpp SeedFilter.bucket),
    cutting the dependent-gather chain from ~20 steps to ~6."""
    import jax.numpy as jnp

    n = keys_hi.shape[0]
    if bounds is not None:
        lo, hi = bounds
    else:
        lo = jnp.zeros(q_hi.shape, jnp.int32)
        hi = jnp.full(q_hi.shape, n, jnp.int32)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        midc = jnp.minimum(mid, n - 1)
        mh = keys_hi[midc]
        ml = keys_lo[midc]
        # keys[mid] < q  (uint32 lexicographic)
        less = (mh < q_hi) | ((mh == q_hi) & (ml < q_lo))
        lo = jnp.where(less & (mid < hi), mid + 1, lo)
        hi = jnp.where(less, hi, jnp.minimum(hi, mid))
    return lo


def _verdicts_impl(
    hi,  # [S, nk] uint32 exact kmer key high halves (row-padded)
    lo,  # [S, nk] uint32
    valid,  # [S, nk] uint8 (0: ambiguous or out of row range)
    tails,  # [S, TAIL_PAD] uint8 read codes after the last full kmer
    lens,  # [S] int32 read lengths
    keys_hi,  # [n_keys] uint32 sorted index keys
    keys_lo,  # [n_keys] uint32
    offsets,  # [n_keys + 1] int32 label spans
    lab_start,  # [n_labels] uint32
    lab_end,  # [n_labels] uint32
    lab_var,  # [n_labels] int32 (-1 = no variant)
    bucket,  # [2^BUCKET_BITS + 1] int32 prefix-bucket over the key table
    ref_order,  # [n_ref] uint32 reference node start positions (sorted)
    ref_len,  # [n_ref] int32 node dna lengths
    ref_start,  # [n_ref] int32 node arena offsets
    ref_arena,  # [arena] uint8
    nk: int,
    key_steps: int,
    ref_steps: int,
):
    import jax.numpy as jnp

    S = hi.shape[0]
    n_keys = keys_hi.shape[0]
    n_labels = lab_start.shape[0]
    n_ref = ref_order.shape[0]

    lens = lens.astype(jnp.int32)
    nk_r = jnp.where(lens >= K, 1 + (lens - K) // (K - 1), 0)  # [S]
    nk_r = jnp.minimum(nk_r, nk)
    karange = jnp.arange(nk, dtype=jnp.int32)[None, :]
    kmask = karange < nk_r[:, None]  # [S, nk] kmers the read actually has

    # ---- exact index probe per kmer -------------------------------------
    b = (hi >> jnp.uint32(32 - BUCKET_BITS)).astype(jnp.int32)
    pos = _lower_bound_u64(
        hi, lo, keys_hi, keys_lo, key_steps, bounds=(bucket[b], bucket[b + 1])
    )  # [S, nk]
    posc = jnp.minimum(pos, max(0, n_keys - 1))
    found = (pos < n_keys) & (keys_hi[posc] == hi) & (keys_lo[posc] == lo)
    a = offsets[posc]
    b = offsets[jnp.minimum(posc + 1, n_keys)]
    size = jnp.where(found, b - a, 0)  # [S, nk]
    okcap = (size >= 1) & (size <= LABEL_CAP)

    # ---- gather up to LABEL_CAP labels per kmer --------------------------
    slot = jnp.arange(LABEL_CAP, dtype=jnp.int32)[None, None, :]
    lidx = jnp.clip(a[:, :, None] + slot, 0, max(0, n_labels - 1))
    slot_on = slot < size[:, :, None]  # [S, nk, CAP]
    ls = lab_start[lidx]
    le = lab_end[lidx]
    lv = lab_var[lidx]

    # all labels of a kmer share one span (single placement, single path)
    same_span = jnp.all(
        (~slot_on) | ((ls == ls[:, :, :1]) & (le == le[:, :, :1])), axis=2
    )
    ls0 = ls[:, :, 0]
    le0 = le[:, :, 0]

    kmer_ok = (valid != 0) & found & okcap & same_span
    all_kmers_ok = jnp.all(kmer_ok | ~kmask, axis=1) & (nk_r >= 2)

    # consecutive kmers chain: end of i == start of i+1 (the 1-base overlap)
    link = (le0[:, :-1] == ls0[:, 1:]) | ~(kmask[:, 1:])
    chain_ok = jnp.all(link, axis=1)

    last = jnp.maximum(nk_r - 1, 0)
    chain_end = jnp.take_along_axis(le0, last[:, None], axis=1)[:, 0]  # [S] u32
    start = ls0[:, 0]
    end_plain = chain_end < jnp.uint32(SPECIAL_START)

    # ---- right-tail extension inside one reference node ------------------
    tail_len = jnp.maximum(lens - 1 - 31 * nk_r, 0)  # [S]
    has_tail = tail_len > 0
    r = (
        _lower_bound_u64(
            jnp.zeros_like(chain_end),
            chain_end + jnp.uint32(1),  # upper_bound(pos) == lower_bound(pos+1)
            jnp.zeros_like(ref_order),
            ref_order,
            ref_steps,
        )
        - 1
    )  # [S] node whose order <= chain_end
    rc = jnp.clip(r, 0, max(0, n_ref - 1))
    off_in_node = (chain_end - ref_order[rc]).astype(jnp.int32)
    in_node = (r >= 0) & (chain_end >= ref_order[rc]) & (off_in_node < ref_len[rc])
    tail_fits = off_in_node + tail_len < ref_len[rc]

    tk = jnp.arange(TAIL_PAD, dtype=jnp.int32)[None, :]
    tidx = ref_start[rc][:, None] + off_in_node[:, None] + 1 + tk
    refb = ref_arena[jnp.clip(tidx, 0, ref_arena.shape[0] - 1)]
    tmask = tk < tail_len[:, None]
    readb = tails
    mm = jnp.sum(
        (tmask & (readb != refb) & (readb < 4) & (refb < 4)).astype(jnp.int32), axis=1
    )
    no_tag = jnp.all((~tmask) | (refb != 6), axis=1)
    budget = jnp.minimum(2 + (tail_len + 1) // 11, 7)
    tail_ok = jnp.where(
        has_tail,
        in_node & tail_fits & no_tag & (mm <= budget) & (mm <= 2),
        True,
    )
    mm = jnp.where(has_tail, mm, 0)

    # ---- chain variant payload -------------------------------------------
    vmask = slot_on & (lv >= 0) & kmask[:, :, None]  # [S, nk, CAP]
    nv = jnp.sum(vmask.astype(jnp.int32), axis=(1, 2))
    small_ids = jnp.all((~vmask) | (lv < (1 << VAR_ID_BITS)), axis=(1, 2))
    flat_mask = vmask.reshape(S, nk * LABEL_CAP)
    flat_val = (lv + (karange[:, :, None] << VAR_ID_BITS)).reshape(S, nk * LABEL_CAP)
    rank = jnp.cumsum(flat_mask.astype(jnp.int32), axis=1) - 1
    outslot = jnp.arange(VAR_SLOTS, dtype=jnp.int32)[None, None, :]
    pick = flat_mask[:, :, None] & (rank[:, :, None] == outslot)
    slots = jnp.sum(jnp.where(pick, flat_val[:, :, None], 0), axis=1) + jnp.where(
        jnp.any(pick, axis=1), 0, -1
    )  # [S, VAR_SLOTS]; empty slots -1

    # a Hamming-1 fork at a crossed site can tie only when mm >= 1
    safety = (mm == 0) | (nv == 0)
    two_kmer_ok = (nk_r >= 3) | (mm <= 1)

    verdict = (
        all_kmers_ok
        & chain_ok
        & end_plain
        & tail_ok
        & (nv <= VAR_SLOTS)
        & small_ids
        & safety
        & two_kmer_ok
    )

    end = jnp.where(has_tail, chain_end + tail_len.astype(jnp.uint32), chain_end)
    meta = (
        verdict.astype(jnp.int32)
        | (jnp.minimum(mm, 7) << 1)
        | (jnp.minimum(nv, VAR_SLOTS) << 4)
    )
    out = jnp.stack(
        [
            meta,
            start.astype(jnp.int32),  # bitcast; host reads back as uint32
            end.astype(jnp.int32),
        ]
        + [slots[:, j] for j in range(VAR_SLOTS)],
        axis=1,
    )
    return out


#: duty-cycle telemetry for the verdict kernel (rows dispatched + wall spent
#: blocked on launch/collect), surfaced in $GT_SCORING_STATS lines as
#: align_rows / align_wall_s (ops/site_scoring._write_scoring_stats)
ALIGN_ROWS_DISPATCHED = 0
ALIGN_WALL_S = 0.0


class DeviceAligner:
    """Per-(graph, index) device alignment state: index + reference arrays
    stay in HBM for the lifetime of one call iteration."""

    def __init__(self, na) -> None:
        """na: typer.native_align.NativeAligner (flat graph + index arrays)."""
        import jax

        keys = np.asarray(na.keys, dtype=np.uint64)
        self.n_keys = len(keys)
        self.n_ref = len(na.ref_order)
        hi_host = (keys >> np.uint64(32)).astype(np.uint32)
        self.keys_hi = jax.device_put(hi_host)
        self.keys_lo = jax.device_put((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        # prefix buckets over the top BUCKET_BITS of each key: search only
        # within the (small) bucket span instead of the whole table
        tops = (hi_host >> np.uint32(32 - BUCKET_BITS)).astype(np.int64)
        bucket = np.searchsorted(tops, np.arange((1 << BUCKET_BITS) + 1)).astype(np.int32)
        span = int((bucket[1:] - bucket[:-1]).max()) if self.n_keys else 1
        self.key_steps = _ceil_log2(span + 1)
        self.bucket = jax.device_put(bucket)
        self.offsets = jax.device_put(np.asarray(na.offsets, dtype=np.int32))
        self.lab_start = jax.device_put(np.asarray(na.lab_start, dtype=np.uint32))
        self.lab_end = jax.device_put(np.asarray(na.lab_end, dtype=np.uint32))
        self.lab_var = jax.device_put(
            np.asarray(na.lab_var, dtype=np.int64).astype(np.int32)
        )  # INVALID (0xFFFFFFFF) -> -1
        self.ref_order = jax.device_put(np.asarray(na.ref_order, dtype=np.uint32))
        self.ref_len = jax.device_put(np.asarray(na.ref_dna_len, dtype=np.int32))
        self.ref_start = jax.device_put(np.asarray(na.ref_dna_start, dtype=np.int32))
        self.ref_arena = jax.device_put(np.asarray(na.ref_arena, dtype=np.uint8))

    def verdicts_async(self, kmers_dev, tails_dev, lens_dev, nk: int):
        """Dispatch the verdict kernel; returns the (async) device array.
        Resolve with np.asarray(...)[:n_rows]. Used by the streaming caller
        to overlap the device round-trip with the host's fill + align of
        neighboring batches."""
        hi, lo, valid = kmers_dev
        fn = _jitted_verdicts(nk, self.key_steps, _ceil_log2(self.n_ref + 1))
        return fn(
            hi,
            lo,
            valid,
            tails_dev,
            lens_dev,
            self.keys_hi,
            self.keys_lo,
            self.offsets,
            self.lab_start,
            self.lab_end,
            self.lab_var,
            self.bucket,
            self.ref_order,
            self.ref_len,
            self.ref_start,
            self.ref_arena,
        )

    def verdicts(self, kmers_dev, tails_dev, lens_dev, n_rows: int, nk: int) -> np.ndarray:
        """kmers_dev = (hi, lo, valid) [S, nk] device arrays; tails_dev
        [S, TAIL_PAD] uint8; lens_dev [S] int32 (all row-padded). Returns
        host int32 [n_rows, OUT_COLS]."""
        import time

        global ALIGN_ROWS_DISPATCHED, ALIGN_WALL_S
        t0 = time.perf_counter()
        out = self.verdicts_async(kmers_dev, tails_dev, lens_dev, nk)
        out.block_until_ready()
        res = np.asarray(out)[:n_rows]
        ALIGN_WALL_S += time.perf_counter() - t0
        ALIGN_ROWS_DISPATCHED += n_rows
        return res


def stage_tails(tails: np.ndarray, lens: np.ndarray):
    """Row-pad + upload the tail matrix and length vector (pow2 buckets to
    reuse jit shapes, like ops.seed_probe.stage_kmers)."""
    import jax

    n_rows = tails.shape[0]
    S = 1 << max(10, (n_rows - 1).bit_length()) if n_rows else 1024
    if S > n_rows:
        tails = np.pad(tails, ((0, S - n_rows), (0, 0)), constant_values=15)
        lens = np.pad(lens, (0, S - n_rows))
    return jax.device_put(tails.astype(np.uint8)), jax.device_put(lens.astype(np.int32))
