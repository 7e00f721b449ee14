"""SV pipeline benchmark: simulate a region with DEL/DUP/INV SVs plus 30x
paired reads for a small cohort, run `genotype_sv`, and report reads/s.

Usage: python tools/bench_sv.py [--kb 300] [--samples 4] [--profile]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from graphtyper_tpu.utils.simulate import _random_seq, _write_fasta  # noqa: E402


def _write_sv_vcf(path, chrom, svs):
    lines = [
        "##fileformat=VCFv4.2",
        f"##contig=<ID={chrom}>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
    ]
    for kind, pos1, ref_base, size, end1 in svs:
        if kind == "DEL":
            info = f"SVTYPE=DEL;SVLEN=-{size};SVSIZE={size};END={end1}"
        elif kind == "DUP":
            info = f"SVTYPE=DUP;SVLEN={size};SVSIZE={size};END={end1}"
        else:
            info = f"SVTYPE=INV;SVLEN={size};SVSIZE={size};END={end1}"
        lines.append(f"{chrom}\t{pos1}\t.\t{ref_base}\t<{kind}>\t.\t.\t{info}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _apply_svs(seq: np.ndarray, svs, carry: np.ndarray) -> np.ndarray:
    out = []
    cur = 0
    for (kind, pos1, _rb, size, end1), c in zip(svs, carry):
        p0 = pos1 - 1
        out.append(seq[cur : p0 + 1])
        if not c:
            out.append(seq[p0 + 1 : end1])
            cur = end1
            continue
        if kind == "DEL":
            cur = end1
        elif kind == "DUP":
            out.append(seq[p0 + 1 : end1])
            out.append(seq[p0 + 1 : end1])
            cur = end1
        else:  # INV
            seg = seq[p0 + 1 : end1]
            comp = {65: 84, 84: 65, 67: 71, 71: 67}
            out.append(np.array([comp.get(int(b), 78) for b in seg[::-1]], dtype=seq.dtype))
            cur = end1
    out.append(seq[cur:])
    return np.concatenate(out)


def _sim_sample_bam(path, chrom, contig_len, haps, n_pairs, sample, seed, read_len=125, frag=340):
    from graphtyper_tpu.io.bam import AlignedRead, BamHeader
    from graphtyper_tpu.io.bam_writer import write_bam

    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_pairs):
        hap = haps[i % len(haps)]
        f = max(read_len + 10, min(frag + int(rng.normal(0, 30)), len(hap) - 1))
        start = int(rng.integers(0, len(hap) - f))
        r1 = hap[start : start + read_len].tobytes()
        r2 = hap[start + f - read_len : start + f].tobytes()
        p1, p2 = start, start + f - read_len
        name = f"{sample}_r{i}"
        qual = np.full(read_len, 40, dtype=np.uint8)
        cig = [(0, read_len)]
        recs.append(
            AlignedRead(name=name, flag=99, ref_id=0, pos=p1, mapq=60, cigar=cig,
                        mate_ref_id=0, mate_pos=p2, tlen=p2 + read_len - p1,
                        seq=r1, qual=qual, tags={"RG": f"rg_{sample}"})
        )
        recs.append(
            AlignedRead(name=name, flag=147, ref_id=0, pos=p2, mapq=60, cigar=cig,
                        mate_ref_id=0, mate_pos=p1, tlen=-(p2 + read_len - p1),
                        seq=r2, qual=qual, tags={"RG": f"rg_{sample}"})
        )
    recs.sort(key=lambda r: r.pos)
    header = BamHeader(
        text=f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{chrom}\tLN:{contig_len}\n"
        f"@RG\tID:rg_{sample}\tSM:{sample}\n",
        ref_names=[chrom],
        ref_lengths=[contig_len],
    )
    write_bam(path, header, recs)
    return len(recs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kb", type=int, default=300)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--keep", default="")
    args = ap.parse_args()
    run(args)


def run(args) -> tuple[float, int]:
    """Simulate, genotype_sv, print the result line; returns (reads/s,
    records). `args` carries kb, samples, coverage, profile and keep."""
    L = args.kb * 1000
    chrom = "chrSV"
    rng = np.random.default_rng(7)
    seq = _random_seq(rng, L)

    tmp = args.keep or tempfile.mkdtemp(prefix="gt_svbench_")
    os.makedirs(tmp, exist_ok=True)
    fasta = os.path.join(tmp, "ref.fa")
    _write_fasta(fasta, chrom, seq)

    # one SV per ~25kb, mixed types
    svs = []
    kinds = ["DEL", "DUP", "INV"]
    step = 25000
    for k, p in enumerate(range(12000, L - 15000, step)):
        size = int(rng.integers(60, 400))
        svs.append((kinds[k % 3], p + 1, chr(seq[p]), size, p + 1 + size))
    sv_vcf = os.path.join(tmp, "sv.vcf")
    _write_sv_vcf(sv_vcf, chrom, svs)

    read_len, frag = 125, 340
    n_pairs = int(args.coverage * L / (2 * read_len))
    bams = []
    total_reads = 0
    for s in range(args.samples):
        carry = (rng.random(len(svs)) < 0.4).astype(np.int8)
        hap_a = _apply_svs(seq, svs, carry)
        hap_b = seq
        bam = os.path.join(tmp, f"s{s}.bam")
        total_reads += _sim_sample_bam(bam, chrom, L, [hap_a, hap_b], n_pairs, f"s{s}", 100 + s,
                                       read_len=read_len, frag=frag)
        bams.append(bam)

    from graphtyper_tpu.pipeline.genotype import genotype_sv

    out_dir = os.path.join(tmp, "out")
    avg = [args.coverage / read_len] * len(bams)
    t0 = time.monotonic()
    if args.profile:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()
    out = genotype_sv(fasta, sv_vcf, bams, f"{chrom}:1-{L}", out_dir, avg_cov_by_readlen=avg)
    wall = time.monotonic() - t0
    if args.profile:
        prof.disable()
        pstats.Stats(prof).sort_stats("cumulative").print_stats(35)

    import gzip

    body = [l for l in gzip.open(out, "rt") if not l.startswith("#")]
    print(f"svs={len(svs)} records={len(body)} reads={total_reads} wall={wall:.2f}s "
          f"reads_per_sec={total_reads / wall:.0f}")
    if not args.keep:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return total_reads / wall, len(body)


if __name__ == "__main__":
    main()
