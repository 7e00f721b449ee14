"""Host-vs-device scoring parity: the batched segment-sum/Gram application
(ops/site_scoring.py) must produce bit-identical site state to the
reference-shaped per-read loop (haplotype.cpp:462-585, :180-361,
vcf_writer.cpp:503-676)."""

import numpy as np
import pytest

from graphtyper_tpu.graph.build import construct_graph
from graphtyper_tpu.graph.coords import GenomicRegion
from graphtyper_tpu.index.build import index_graph
from graphtyper_tpu.pipeline.caller import call_pool
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    cfg = SimConfig(region_length=6000, coverage=18.0, n_samples=2, seed=11, error_rate=0.004)
    out = tmp_path_factory.mktemp("simparity")
    return cfg, simulate_cohort(str(out), cfg)


def _run(sim_pair, device: bool, force_device_kernel: bool = False):
    cfg, res = sim_pair
    graph = construct_graph(res.fasta, res.vcf, f"{cfg.chrom}:1-{cfg.region_length}", use_index=True)
    index = index_graph(graph)
    region = GenomicRegion.parse(f"{cfg.chrom}:1-{cfg.region_length}")
    from graphtyper_tpu.config import current_options, replace, set_options
    from graphtyper_tpu.ops.site_scoring import ObsBatcher

    old = current_options()
    old_thresh = ObsBatcher.HOST_APPLY_MAX_ROWS
    set_options(replace(old, device_scoring="on" if device else "off"))
    if force_device_kernel:
        # batches at this scale fall under the host-apply threshold; force
        # every flush through the jitted device kernel so the e2e device
        # path stays covered
        ObsBatcher.HOST_APPLY_MAX_ROWS = 0
    try:
        return call_pool(graph, index, res.sams, region=region, is_writing_hap=True)
    finally:
        set_options(old)
        ObsBatcher.HOST_APPLY_MAX_ROWS = old_thresh


@pytest.mark.parametrize("force_device_kernel", [False, True])
def test_host_device_parity(sim, force_device_kernel):
    host = _run(sim, device=False)
    dev = _run(sim, device=True, force_device_kernel=force_device_kernel)
    assert len(host.scorer.sites) == len(dev.scorer.sites)
    assert len(host.scorer.sites) > 3
    n_obs_checked = 0
    for sh, sd in zip(host.scorer.sites, dev.scorer.sites):
        vh, vd = sh.var_stats, sd.var_stats
        assert vh.clipped_reads == vd.clipped_reads
        assert vh.mapq_squared == vd.mapq_squared
        for ah, ad in zip(vh.per_allele, vd.per_allele):
            assert ah.clipped_bp == ad.clipped_bp
            assert ah.mapq_squared == ad.mapq_squared
            assert ah.mismatches == ad.mismatches
            assert ah.score_diff == ad.score_diff
        for rh, rd in zip(vh.read_strand, vd.read_strand):
            assert (rh.r1_forward, rh.r1_reverse, rh.r2_forward, rh.r2_reverse) == (
                rd.r1_forward,
                rd.r1_reverse,
                rd.r2_forward,
                rd.r2_reverse,
            )
        for hh, hd in zip(sh.hap_samples, sd.hap_samples):
            np.testing.assert_array_equal(hh.log_score, hd.log_score)
            np.testing.assert_array_equal(hh.gt_coverage, hd.gt_coverage)
            assert hh.max_log_score == hd.max_log_score
            assert hh.ambiguous_depth == hd.ambiguous_depth
            assert hh.ambiguous_depth_alt == hd.ambiguous_depth_alt
            assert hh.alt_proper_pair_depth == hd.alt_proper_pair_depth
            n_obs_checked += int(hh.log_score.max() > 0)
    assert n_obs_checked > 0  # the workload actually scored reads

    # the phasing map and emitted VCF records must agree too
    assert host.ph.keys() == dev.ph.keys()
    assert len(host.vcf.variants) == len(dev.vcf.variants)
    for a, b in zip(host.vcf.variants, dev.vcf.variants):
        assert a.abs_pos == b.abs_pos
        assert a.seqs == b.seqs
        for ca, cb in zip(a.calls, b.calls):
            np.testing.assert_array_equal(ca.phred, cb.phred)
            np.testing.assert_array_equal(ca.coverage, cb.coverage)


@pytest.mark.parametrize("A", [2, 8])
def test_multi_chunk_flush_matches_numpy(A, monkeypatch):
    """A flush larger than one device chunk sums the chunks' outputs on the
    host; that sum must equal the numpy twin over all rows. (A device
    array's host view is read-only, so the sum must own its arrays.)"""
    from graphtyper_tpu.ops import site_scoring as ss

    monkeypatch.setattr(ss, "_chunk_rows", lambda A: 1024)
    rng = np.random.default_rng(A)
    n, n_sites, n_samples = 3000, 40, 5
    cols = {
        "site": rng.integers(0, n_sites, n),
        "sample": rng.integers(0, n_samples, n),
        "eps": rng.integers(1, 41, n),
        "apply_score": (rng.random(n) < 0.9).astype(np.int64),
        "bits_lo": rng.integers(1, 1 << A, n),
        "bits_hi": np.zeros(n, np.int64),
        "cov": rng.integers(-2, A, n),
        "clipped_scaled": rng.integers(0, 100, n),
        "clipped_flag": rng.integers(0, 2, n),
        "mapq_sq": rng.integers(0, 3601, n),
        "mm_scaled": rng.integers(0, 50, n),
        "sdiff": rng.integers(0, 30, n),
        "strand": rng.integers(0, 4, n),
        "proper": rng.integers(0, 2, n),
    }
    batcher = ss.ObsBatcher([None] * n_sites, n_samples)
    batcher.HOST_APPLY_MAX_ROWS = 0
    buf = ss._TierBuffer(A=A)
    buf.site_ids = list(range(n_sites))
    buf.blocks = [cols]
    batcher.tiers[A] = buf
    launched = batcher._flush_tier_launch(A, buf)
    assert len(launched) == 3
    for i, (vec, n_pad) in enumerate(launched):
        host = np.asarray(vec).copy()
        host.setflags(write=False)
        launched[i] = (host, n_pad)
    batcher._flush_tier_collect(A, launched)
    want = ss._apply_rows_numpy(cols, n, A, n_sites, n_samples)
    got = batcher._totals[A]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k][: v.shape[0]], v, err_msg=k)
