"""Device seeding: batched k-mer probe expansion + membership filtering.

The production aligner's dominant cost is its seed stage: each read takes nk
non-overlapping 32-mers (stride K-1) and probes the k-mer index with the
exact key plus 96 Hamming-1 variants — ~400 index probes per read
(reference: src/typer/alignment.cpp:30-31 exact+Hamming-1 seeding;
src/utilities/kmer_help_functions.cpp:93-119 the 96-key expansion). On the
host that is a pointer-chasing hash/binary-search loop; here the whole
pool's probe set is filtered on the device in one fused pass:

  1. the host prep ships each row's exact kmer keys as (hi, lo) uint32
     halves (native gt_prep_fetch_kmers; tiny — 9 bytes per kmer, cached on
     device across call iterations),
  2. the kernel expands the 97 probe variants per kmer via a static
     XOR-mask table (Hamming-1 in 2-bit space is `key ^ (d << 2*kpos)`),
  3. hashes each probe and tests it against a 2^bits membership bitset of
     the index keys (one gather per probe — the only irregular op),
  4. packs the pass/fail bits into uint32 words — a FIXED-shape output, so
     the whole call is one dispatch + one D2H with no data-dependent
     compaction (sort/scatter/count sync all avoided).

The host then scans the ~1-3% set bits per row and verifies those probes
exactly against the sorted key table (native/gt_align.cpp CandView /
SeedCands). The result is bit-identical to probing all 97 keys per kmer:
the bitset is built over every index key with the same hash
(gt_build_seed_bitset), so it has NO false negatives, and false positives
are eliminated by the host's exact lookup.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np

K = 32
PROBES_PER_KMER = 97  # 1 exact + 32 positions x 3 deltas
HASH_C1 = 0x9E3779B1  # must match native/gt_align.cpp gt_build_seed_bitset
HASH_C2 = 0x85EBCA77


@lru_cache(maxsize=1)
def _ham_masks() -> tuple[np.ndarray, np.ndarray]:
    """XOR masks per probe j (hi, lo uint32 halves); j=0 exact,
    j = 1 + kpos*3 + (d-1) flips 2-bit position kpos (shift ascending) by d
    — the same probe order the host seeding loop uses."""
    hi = np.zeros(PROBES_PER_KMER, np.uint32)
    lo = np.zeros(PROBES_PER_KMER, np.uint32)
    j = 1
    for kpos in range(K):
        for d in (1, 2, 3):
            m = d << (2 * kpos)
            hi[j] = (m >> 32) & 0xFFFFFFFF
            lo[j] = m & 0xFFFFFFFF
            j += 1
    return hi, lo


def bitset_bits_for(n_keys: int) -> int:
    """Bitset sized so the false-positive rate stays ~1-2%."""
    bits = 24
    while (1 << bits) < 64 * max(1, n_keys) and bits < 28:
        bits += 1
    return bits


def build_bitset(keys_u64: np.ndarray, bits: int) -> np.ndarray:
    """Host-side bitset build (numpy twin of gt_build_seed_bitset)."""
    lo = (keys_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys_u64 >> np.uint64(32)).astype(np.uint32)
    h = (lo * np.uint32(HASH_C1) + hi * np.uint32(HASH_C2)) >> np.uint32(32 - bits)
    words = np.zeros(1 << (bits - 5), np.uint32)
    np.bitwise_or.at(words, h >> np.uint32(5), np.uint32(1) << (h & np.uint32(31)))
    return words


def prow_for(nk: int) -> int:
    return (nk * PROBES_PER_KMER + 31) // 32


@lru_cache(maxsize=1)
def _jitted_probe_bits():
    from graphtyper_tpu.utils.device import enable_compilation_cache

    enable_compilation_cache()
    import jax

    return partial(jax.jit, static_argnames=("nk", "bits"))(_probe_bits_impl)


def _probe_bits_impl(hi, lo, valid, bitset, nk: int, bits: int):
    """hi/lo [S, nk] uint32 exact-key halves, valid [S, nk] uint8 (0 for
    ambiguous/out-of-range kmers), bitset uint32 words.

    Returns packed candidate words [S, PROW] uint32: bit (kpos*97 + j) of
    row r is set iff probe j of kmer kpos passed the membership test —
    matching native/gt_align.cpp CandView's layout.
    """
    import jax.numpy as jnp

    S = hi.shape[0]
    mask_hi, mask_lo = _ham_masks()
    p_hi = hi[:, :, None] ^ jnp.asarray(mask_hi)[None, None, :]  # [S, nk, 97]
    p_lo = lo[:, :, None] ^ jnp.asarray(mask_lo)[None, None, :]
    h = p_lo * jnp.uint32(HASH_C1) + p_hi * jnp.uint32(HASH_C2)
    idx = h >> jnp.uint32(32 - bits)
    word = bitset[(idx >> jnp.uint32(5)).astype(jnp.int32)]
    bit = (word >> (idx & jnp.uint32(31))) & jnp.uint32(1)
    bit = bit * valid[:, :, None].astype(jnp.uint32)

    flat = bit.reshape(S, nk * PROBES_PER_KMER)
    prow = prow_for(nk)
    pad = prow * 32 - nk * PROBES_PER_KMER
    if pad:
        flat = jnp.pad(flat, ((0, 0), (0, pad)))
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)
    packed = jnp.sum(
        flat.reshape(S, prow, 32) * jnp.asarray(weights)[None, None, :], axis=-1
    )
    return packed


def probe_bits_host(hi, lo, valid, bitset, nk: int, bits: int) -> np.ndarray:
    """numpy twin of _probe_bits_impl (same inputs, same packed words)."""
    mask_hi, mask_lo = _ham_masks()
    S = hi.shape[0]
    p_hi = hi[:, :, None].astype(np.uint32) ^ mask_hi[None, None, :]
    p_lo = lo[:, :, None].astype(np.uint32) ^ mask_lo[None, None, :]
    h = p_lo * np.uint32(HASH_C1) + p_hi * np.uint32(HASH_C2)
    idx = h >> np.uint32(32 - bits)
    word = np.asarray(bitset)[(idx >> np.uint32(5)).astype(np.int64)]
    bit = (word >> (idx & np.uint32(31))) & np.uint32(1)
    bit = bit * valid[:, :, None].astype(np.uint32)
    flat = bit.reshape(S, nk * PROBES_PER_KMER)
    prow = prow_for(nk)
    flat = np.pad(flat, ((0, 0), (0, prow * 32 - nk * PROBES_PER_KMER)))
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (flat.reshape(S, prow, 32) * weights).sum(axis=-1, dtype=np.uint32)


class DeviceSeeder:
    """Per-index device seeding state: the membership bitset lives on the
    device for the lifetime of one call iteration's index."""

    def __init__(self, keys_u64: np.ndarray, bits: int | None = None):
        import ctypes

        import jax

        from graphtyper_tpu.io.native import get_lib

        self.bits = bits if bits is not None else bitset_bits_for(len(keys_u64))
        lib = get_lib()
        if lib is not None and len(keys_u64):
            if not getattr(lib, "_bitset_ready", False):
                lib.gt_build_seed_bitset.restype = None
                lib.gt_build_seed_bitset.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_int64,
                    ctypes.c_void_p,
                    ctypes.c_int32,
                ]
                lib._bitset_ready = True
            keys = np.ascontiguousarray(keys_u64.astype(np.uint64))
            words = np.zeros(1 << (self.bits - 5), np.uint32)
            lib.gt_build_seed_bitset(
                keys.ctypes.data_as(ctypes.c_void_p),
                len(keys),
                words.ctypes.data_as(ctypes.c_void_p),
                self.bits,
            )
        else:
            words = build_bitset(keys_u64.astype(np.uint64), self.bits)
        self.bitset = jax.device_put(words)

    def probe_bits(self, kmers_dev, n_rows: int, nk: int) -> np.ndarray:
        """kmers_dev = (hi, lo, valid) device arrays [S, nk] (S row-padded);
        returns candidate words [n_rows, PROW] uint32 on host."""
        import os
        import time

        hi, lo, valid = kmers_dev
        t0 = time.perf_counter()
        packed = _jitted_probe_bits()(hi, lo, valid, self.bitset, nk=nk, bits=self.bits)
        packed.block_until_ready()
        t1 = time.perf_counter()
        # fetch the full padded array in ONE transfer and slice on host (a
        # device-side packed[:n_rows] would add a dispatch)
        out = np.asarray(packed)[:n_rows]
        if os.environ.get("GT_SEED_PROFILE"):
            import sys

            print(
                f"[seed_probe] kernel {t1 - t0:.3f}s d2h {time.perf_counter() - t1:.3f}s "
                f"S={hi.shape[0]} nk={nk} bits={self.bits}",
                file=sys.stderr,
            )
        return out


def stage_kmers(hi: np.ndarray, lo: np.ndarray, valid: np.ndarray):
    """Upload the per-row kmer tensors once (row-padded to pow2 buckets so
    the jitted kernel shape is reused); the returned device arrays are
    cached by the caller across call iterations."""
    import jax

    n_rows = hi.shape[0]
    S = 1 << max(10, (n_rows - 1).bit_length()) if n_rows else 1024
    if S > n_rows:
        padw = ((0, S - n_rows), (0, 0))
        hi = np.pad(hi, padw)
        lo = np.pad(lo, padw)
        valid = np.pad(valid, padw)
    return (
        jax.device_put(hi.astype(np.uint32)),
        jax.device_put(lo.astype(np.uint32)),
        jax.device_put(valid.astype(np.uint8)),
    )
