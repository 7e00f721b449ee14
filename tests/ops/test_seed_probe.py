"""Device seeding parity: the batched probe kernel (ops/seed_probe.py) must
reproduce the host's exact + Hamming-1 index probing bit-for-bit.

Reference semantics: src/typer/alignment.cpp:30-31 (exact + Hamming-1
seeding), src/utilities/kmer_help_functions.cpp:93-119 (96-key expansion).
"""

import numpy as np
import pytest

from graphtyper_tpu.ops.seed_probe import (
    PROBES_PER_KMER,
    DeviceSeeder,
    _ham_masks,
    bitset_bits_for,
    build_bitset,
    prow_for,
    stage_kmers,
)

K = 32


def _kmer_tensors(codes_mat, lens):
    n_rows, L = codes_mat.shape
    nk = 1 + (L - K) // (K - 1)
    hi = np.zeros((n_rows, nk), np.uint32)
    lo = np.zeros((n_rows, nk), np.uint32)
    valid = np.zeros((n_rows, nk), np.uint8)
    for row in range(n_rows):
        for i in range(nk):
            p = (K - 1) * i
            if p + K > lens[row]:
                continue
            win = codes_mat[row, p : p + K]
            if (win >= 4).any():
                continue
            key = 0
            for c in win.tolist():
                key = (key << 2) | c
            hi[row, i] = (key >> 32) & 0xFFFFFFFF
            lo[row, i] = key & 0xFFFFFFFF
            valid[row, i] = 1
    return hi, lo, valid, nk


def _true_probe_hits(codes_mat, lens, keys_sorted):
    keyset = set(keys_sorted.tolist())
    n_rows, L = codes_mat.shape
    nk = 1 + (L - K) // (K - 1)
    true_hits = set()
    for row in range(n_rows):
        for i in range(nk):
            p = (K - 1) * i
            if p + K > lens[row]:
                continue
            win = codes_mat[row, p : p + K]
            if (win >= 4).any():
                continue
            key = 0
            for c in win.tolist():
                key = (key << 2) | c
            for j in range(PROBES_PER_KMER):
                k2 = key if j == 0 else key ^ (((j - 1) % 3 + 1) << (2 * ((j - 1) // 3)))
                if k2 in keyset:
                    true_hits.add((row, i * PROBES_PER_KMER + j))
    return true_hits


def test_ham_mask_order_matches_host():
    hi, lo = _ham_masks()
    # j = 1 + kpos*3 + (d-1): flip 2-bit position kpos by xor d
    assert lo[1] == 1 and lo[2] == 2 and lo[3] == 3  # kpos 0
    assert lo[4] == 1 << 2  # kpos 1, d 1
    assert hi[1 + 16 * 3] == 1  # kpos 16 lives in the high half
    assert hi[0] == 0 and lo[0] == 0


def test_device_candidate_words_have_no_false_negatives():
    rng = np.random.default_rng(3)
    n_rows, L = 64, 151
    codes = rng.integers(0, 4, size=(n_rows, L)).astype(np.uint8)
    lens = np.full(n_rows, L, np.int32)
    lens[5] = 70  # short read: trailing kmers invalid
    codes[7, 3] = 4  # ambiguous base: kmer 0 masked out on device
    keys = []
    for row in range(0, n_rows, 3):
        win = codes[row, 31 : 31 + K]
        if (win >= 4).any():
            continue
        key = 0
        for c in win.tolist():
            key = (key << 2) | c
        keys.append(key)
        keys.append(key ^ (2 << (2 * 7)))  # a Ham-1 neighbor
    keys = np.unique(np.array(keys, dtype=np.uint64))

    seeder = DeviceSeeder(keys)
    hi, lo, valid, nk = _kmer_tensors(codes, lens)
    words = seeder.probe_bits(stage_kmers(hi, lo, valid), n_rows, nk)
    assert words.shape == (n_rows, prow_for(nk))

    def bit(row, rem):
        return (words[row, rem // 32] >> (rem % 32)) & 1

    want = _true_probe_hits(codes, lens, keys)
    assert want, "test setup produced no true hits"
    for row, rem in want:
        assert bit(row, rem) == 1, f"kernel lost true probe {(row, rem)}"
    # invalid kmers must produce no candidates at all
    for i in range(nk):
        if not valid[7, i] and i == 0:
            for j in range(PROBES_PER_KMER):
                assert bit(7, i * PROBES_PER_KMER + j) == 0


def test_bitset_builders_agree():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**63, size=1000, dtype=np.uint64)
    bits = bitset_bits_for(len(keys))
    np_words = build_bitset(keys, bits)
    from graphtyper_tpu.io.native import get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    seeder = DeviceSeeder(np.sort(keys), bits=bits)
    got = np.asarray(seeder.bitset)
    assert got.shape == np_words.shape
    assert (got == np_words).all()


def test_genotype_device_seed_parity(tmp_path):
    """End-to-end: device_seed on vs off produce byte-identical VCFs."""
    import gzip
    from dataclasses import replace

    from graphtyper_tpu.config import current_options, set_options
    from graphtyper_tpu.pipeline.genotype import genotype
    from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort

    cfg = SimConfig(region_length=30_000, coverage=25.0, seed=13, out_format="bam")
    sim = simulate_cohort(str(tmp_path / "c"), cfg)
    outs = {}
    base = current_options()
    try:
        for mode in ("off", "on"):
            set_options(replace(base, device_seed=mode))
            out = genotype(
                sim.fasta, sim.sams, f"{cfg.chrom}:1-30000", str(tmp_path / f"o_{mode}")
            )
            outs[mode] = gzip.open(out, "rb").read()
    finally:
        set_options(base)
    assert outs["on"] == outs["off"]


@pytest.mark.parametrize("nk", [1, 4])
def test_device_words_equal_numpy_twin(nk):
    """The jitted probe kernel and its numpy twin pack identical words."""
    from graphtyper_tpu.ops.seed_probe import _jitted_probe_bits, probe_bits_host

    rng = np.random.default_rng(nk)
    keys = np.unique(rng.integers(0, 2**63, size=5000, dtype=np.uint64))
    bits = bitset_bits_for(len(keys))
    bitset = build_bitset(keys, bits)
    S = 256
    hi = rng.integers(0, 2**32, size=(S, nk), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=(S, nk), dtype=np.uint64).astype(np.uint32)
    hi[::3, 0] = (keys[: len(hi[::3])] >> np.uint64(32)).astype(np.uint32)
    lo[::3, 0] = (keys[: len(lo[::3])] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    valid = (rng.random((S, nk)) < 0.9).astype(np.uint8)
    got = np.asarray(_jitted_probe_bits()(hi, lo, valid, bitset, nk=nk, bits=bits))
    want = probe_bits_host(hi, lo, valid, bitset, nk, bits)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert want.any()
