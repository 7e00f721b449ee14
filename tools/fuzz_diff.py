"""Cross-path differential fuzzing.

For random workloads, the pipeline must produce byte-identical final VCFs
no matter which implementation path runs: native C++ vs Python oracles,
BAI-sliced vs full-scan input, streaming vs in-memory pooled caller,
native vs numpy SW, pooled region fan-out vs serial, 1 vs 4 threads, and
BAM vs CRAM vs SAM input encodings of the same reads.

Round-2's (uncommitted) version of this harness found 3 real bugs the unit
suite missed; this is the committed round-3 version. Run from the repo
root:  python tools/fuzz_diff.py [n_seeds]
"""

import gzip
import os
import sys
import tempfile
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from graphtyper_tpu.config import current_options, set_options
from graphtyper_tpu.io.bai import ensure_bai
from graphtyper_tpu.pipeline.genotype import genotype
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu.utils.simulate_indep import IndepConfig, simulate_indep


def vcf_text(path: str) -> list[str]:
    with gzip.open(path, "rt") as f:
        return [l for l in f if not l.startswith("##")]


def run(sim, region, out_dir, **opt_over):
    base = current_options()
    if opt_over:
        set_options(replace(base, **opt_over))
    try:
        return genotype(sim.fasta, sim.sams, region, out_dir)
    finally:
        set_options(base)


def bam_to_other(sim, fmt: str, out_dir: str):
    """Re-encode the cohort's BAMs as CRAM or SAM with identical records."""
    from graphtyper_tpu.io.bam import read_alignments
    from graphtyper_tpu.io.sam_writer import write_sam
    from graphtyper_tpu.io.cram_writer import write_cram

    out = []
    for i, p in enumerate(sim.sams):
        header, reads = read_alignments(p, parse_tags=True)
        dst = os.path.join(out_dir, f"re{i}.{fmt}")
        if fmt == "cram":
            write_cram(dst, header, reads)
        else:
            write_sam(dst, header, reads)
        out.append(dst)
    return out


def fuzz_seed(seed: int, tmp: str) -> list[str]:
    """Returns a list of failure descriptions for this seed."""
    fails = []
    rng_len = 30_000 + (seed * 7919) % 25_000
    if seed % 3 == 2:
        cfg = IndepConfig(region_length=rng_len, n_samples=1 + seed % 2, coverage=12.0, seed=seed)
        sim = simulate_indep(os.path.join(tmp, "sim"), cfg)
        chrom = cfg.chrom
    else:
        cfg = SimConfig(
            region_length=rng_len,
            n_samples=1 + seed % 3,
            coverage=10.0 + (seed % 3) * 4,
            seed=seed,
            out_format="bam",
        )
        sim = simulate_cohort(os.path.join(tmp, "sim"), cfg)
        chrom = cfg.chrom
    region = f"{chrom}:1-{rng_len}"

    ref_out = run(sim, region, os.path.join(tmp, "ref"))
    ref = vcf_text(ref_out)
    if len(ref) < 3:
        fails.append(f"seed {seed}: reference run produced {len(ref)} lines")
        return fails

    variants = {
        "python_caller": dict(native_caller="off"),
        "python_aligner": dict(native_aligner="off"),
        "stream_on": dict(streaming_caller="on"),
        "threads1": dict(threads=1),
        "threads4": dict(threads=4),
        "hq_reads": None,  # separate baseline: changes output legitimately
    }
    for name, over in variants.items():
        if over is None:
            continue
        try:
            out = run(sim, region, os.path.join(tmp, f"v_{name}"), **over)
            if vcf_text(out) != ref:
                fails.append(f"seed {seed}: {name} output differs")
        except Exception as e:
            fails.append(f"seed {seed}: {name} raised {e!r}")

    # numpy SW vs native SW
    from graphtyper_tpu.ops import sw as swmod

    saved = swmod._align_batch_native
    swmod._align_batch_native = lambda *a, **k: None
    try:
        out = run(sim, region, os.path.join(tmp, "v_numpy_sw"))
        if vcf_text(out) != ref:
            fails.append(f"seed {seed}: numpy-SW output differs")
    finally:
        swmod._align_batch_native = saved

    if all(p.endswith(".bam") for p in sim.sams):
        # BAI-sliced vs full-scan bamshrink
        for p in sim.sams:
            ensure_bai(p, min_size=0)
        out = run(sim, region, os.path.join(tmp, "v_bai"))
        if vcf_text(out) != ref:
            fails.append(f"seed {seed}: BAI-sliced output differs")
        for p in sim.sams:
            if os.path.exists(p + ".bai"):
                os.remove(p + ".bai")

        # python rANS vs native rANS through a CRAM re-encode
        cram_sams = bam_to_other(sim, "cram", tmp)
        from types import SimpleNamespace

        sim_cram = SimpleNamespace(fasta=sim.fasta, sams=cram_sams)
        out = run(sim_cram, region, os.path.join(tmp, "v_cram"))
        if vcf_text(out) != ref:
            fails.append(f"seed {seed}: CRAM-input output differs")
        from graphtyper_tpu.io import cram as crammod

        saved_rans = crammod._rans_decode_native
        crammod._rans_decode_native = lambda *a, **k: None
        try:
            out = run(sim_cram, region, os.path.join(tmp, "v_cram_pyrans"))
            if vcf_text(out) != ref:
                fails.append(f"seed {seed}: python-rANS CRAM output differs")
        finally:
            crammod._rans_decode_native = saved_rans

        sam_sams = bam_to_other(sim, "sam", tmp)
        sim_sam = SimpleNamespace(fasta=sim.fasta, sams=sam_sams)
        out = run(sim_sam, region, os.path.join(tmp, "v_sam"))
        if vcf_text(out) != ref:
            fails.append(f"seed {seed}: SAM-input output differs")

    # region split (3 units) vs genotyping each unit on its own
    from graphtyper_tpu.pipeline.genotype import genotype, genotype_regions

    try:
        split = genotype_regions(
            sim.fasta, sim.sams, region, os.path.join(tmp, "r_split"), max_region_size=12_000,
        )
        for a in split:
            begin, end = os.path.basename(a).split(".")[0].split("-")
            one = genotype(sim.fasta, sim.sams, f"{region.split(':')[0]}:{int(begin)}-{int(end)}",
                           os.path.join(tmp, "r_one"))
            if vcf_text(a) != vcf_text(one):
                fails.append(f"seed {seed}: split region differs at {os.path.basename(a)}")
    except Exception as e:
        fails.append(f"seed {seed}: region split raised {e!r}")

    # --vcf mode determinism: two runs byte-identical (and CSI variant
    # produces the same records)
    from graphtyper_tpu.pipeline.genotype import genotype_only_with_a_vcf

    sites = os.path.join(tmp, "ref", "input_sites")
    site_files = []
    for root, _, files in os.walk(sites):
        site_files += [os.path.join(root, f) for f in files if f.endswith(".vcf.gz")]
    if site_files:
        try:
            o1 = genotype_only_with_a_vcf(
                sim.fasta, sim.sams, site_files[0], region, os.path.join(tmp, "gv1")
            )
            o2 = genotype_only_with_a_vcf(
                sim.fasta, sim.sams, site_files[0], region, os.path.join(tmp, "gv2")
            )
            if vcf_text(o1) != vcf_text(o2):
                fails.append(f"seed {seed}: --vcf mode nondeterministic")
        except Exception as e:
            fails.append(f"seed {seed}: --vcf mode raised {e!r}")

    # popVCF final encoding must decode back to the plain output
    try:
        out_pop = run(sim, region, os.path.join(tmp, "v_pop"), encoding="p")
        from graphtyper_tpu.io.popvcf import decode_file

        dec = os.path.join(tmp, "pop_decoded.vcf.gz")
        decode_file(out_pop, dec)
        if vcf_text(dec) != ref:
            fails.append(f"seed {seed}: popVCF roundtrip differs")
    except Exception as e:
        fails.append(f"seed {seed}: popVCF raised {e!r}")

    fails += fuzz_sv(seed, os.path.join(tmp, "sv"))
    return fails


def _sim_sv_messy(tmp: str, seed: int):
    """An SV cohort with deliberately messy reads: low/edge mapq, soft clips
    (one- and both-ended), far mates, unmapped(-mate) flags, unpaired reads,
    duplicates and flag-filtered mates (leftover-mate fodder) — everything
    is_good_sv_read + the coverage bins + leftover resolution branch on."""
    import numpy as np

    from graphtyper_tpu.io.bam import AlignedRead, BamHeader
    from graphtyper_tpu.io.bam_writer import write_bam
    from graphtyper_tpu.utils.simulate import _random_seq, _write_fasta

    rng = np.random.default_rng(seed * 131 + 7)
    L = 24_000 + (seed * 4099) % 12_000
    chrom = "chrFSV"
    seq = _random_seq(rng, L)
    os.makedirs(tmp, exist_ok=True)
    fasta = os.path.join(tmp, "ref.fa")
    _write_fasta(fasta, chrom, seq)

    svs = []  # (kind, pos1, size)
    p = 5000
    kinds = ["DEL", "DUP", "INV"]
    while p < L - 3000:
        svs.append((kinds[len(svs) % 3], p + 1, int(rng.integers(60, 300))))
        p += int(rng.integers(5000, 9000))
    with open(os.path.join(tmp, "sv.vcf"), "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for kind, pos1, size in svs:
            sgn = "-" if kind == "DEL" else ""
            f.write(f"{chrom}\t{pos1}\t.\t{chr(seq[pos1 - 1])}\t<{kind}>\t.\t.\t"
                    f"SVTYPE={kind};SVLEN={sgn}{size};SVSIZE={size};END={pos1 + size}\n")

    # alt haplotype: apply every SV
    parts, cur = [], 0
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for kind, pos1, size in svs:
        p0 = pos1 - 1
        parts.append(seq[cur : p0 + 1])
        seg = seq[p0 + 1 : p0 + 1 + size]
        if kind == "DUP":
            parts.append(seg)
            parts.append(seg)
        elif kind == "INV":
            parts.append(np.frombuffer(seg.tobytes().translate(comp), dtype=np.uint8)[::-1])
        cur = p0 + 1 + size
    parts.append(seq[cur:])
    hap_alt = np.concatenate(parts)

    read_len, frag = 100, 300
    n_pairs = int(14.0 * L / (2 * read_len))
    bams = []
    for s in range(2):
        recs = []
        for i in range(n_pairs):
            hap = (seq, hap_alt)[int(rng.random() < 0.5)] if s == 0 else seq
            f = max(read_len + 8, min(frag + int(rng.normal(0, 40)), len(hap) - 1))
            start = int(rng.integers(0, len(hap) - f))
            r1 = hap[start : start + read_len].tobytes()
            r2 = hap[start + f - read_len : start + f].tobytes()
            p1, p2 = start, start + f - read_len
            mapq = int(rng.choice([0, 10, 15, 16, 30, 60], p=[0.05, 0.1, 0.05, 0.1, 0.2, 0.5]))
            cig1 = [(0, read_len)]
            roll = rng.random()
            if roll < 0.12:  # front clip
                c = int(rng.integers(8, 20))
                cig1 = [(4, c), (0, read_len - c)]
            elif roll < 0.2:  # back clip
                c = int(rng.integers(8, 20))
                cig1 = [(0, read_len - c), (4, c)]
            elif roll < 0.25:  # both clipped
                cig1 = [(4, 10), (0, read_len - 22), (4, 12)]
            flag1, flag2 = 99, 147
            mp1, mp2 = p2, p1
            roll2 = rng.random()
            if roll2 < 0.06:  # far mate
                mp1 = p1 + 250_000
                mp2 = p1 + 250_000
            elif roll2 < 0.1:  # mate unmapped
                flag1 = (flag1 | 0x8) & ~0x2
            elif roll2 < 0.14:  # unpaired read (drop the mate entirely)
                flag1 &= ~(0x1 | 0x2 | 0x8 | 0x20 | 0x40)
                flag2 = -1
            elif roll2 < 0.2:  # mate flag-filtered (0x400 dup) -> leftover
                flag2 |= 0x400
            qual = np.full(read_len, 35, dtype=np.uint8)
            name = f"s{s}_r{i}"
            recs.append(AlignedRead(name=name, flag=flag1, ref_id=0, pos=p1, mapq=mapq,
                                    cigar=cig1, mate_ref_id=0, mate_pos=mp1,
                                    tlen=p2 + read_len - p1, seq=r1, qual=qual,
                                    tags={"RG": f"rg_s{s}"}))
            if flag2 >= 0:
                recs.append(AlignedRead(name=name, flag=flag2, ref_id=0, pos=p2, mapq=mapq,
                                        cigar=[(0, read_len)], mate_ref_id=0, mate_pos=mp2,
                                        tlen=-(p2 + read_len - p1), seq=r2, qual=qual,
                                        tags={"RG": f"rg_s{s}"}))
            if rng.random() < 0.05 and flag2 >= 0:
                # dedup fodder: another pair with identical (pos, seq) under
                # a different name (the alignment is computed once, reused)
                d = recs[-1]
                recs.append(AlignedRead(name=name + "d", flag=d.flag, ref_id=0, pos=d.pos,
                                        mapq=d.mapq, cigar=list(d.cigar), mate_ref_id=0,
                                        mate_pos=d.mate_pos, tlen=d.tlen, seq=d.seq,
                                        qual=d.qual, tags=dict(d.tags)))
        recs.sort(key=lambda r: r.pos)
        header = BamHeader(
            text=f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{chrom}\tLN:{L}\n"
            f"@RG\tID:rg_s{s}\tSM:s{s}\n",
            ref_names=[chrom],
            ref_lengths=[L],
        )
        bam = os.path.join(tmp, f"s{s}.bam")
        write_bam(bam, header, recs)
        bams.append(bam)
    return fasta, os.path.join(tmp, "sv.vcf"), bams, f"{chrom}:1-{L}", L


def fuzz_sv(seed: int, tmp: str) -> list[str]:
    """SV pipeline differential axis: the native pooled SV loop (BAM bytes
    and object paths), the Python loop + native batch aligner, and the pure
    Python loop must emit byte-identical VCFs — with and without the
    coverage-bin filter — on messy inputs."""
    from graphtyper_tpu.pipeline.genotype import genotype_sv

    fails: list[str] = []
    os.makedirs(tmp, exist_ok=True)
    fasta, sv_vcf, bams, region, L = _sim_sv_messy(tmp, seed)

    def run_sv(name, avg, **opt_over):
        base = current_options()
        if opt_over:
            set_options(replace(base, **opt_over))
        try:
            return genotype_sv(fasta, sv_vcf, bams, region,
                               os.path.join(tmp, f"out_{name}"), avg_cov_by_readlen=avg)
        finally:
            set_options(base)

    for tag, avg in (("cov", [0.05, 0.05]), ("nocov", None)):
        try:
            ref_out = run_sv(f"{tag}_native", avg)
            ref = vcf_text(ref_out)
        except Exception as e:
            fails.append(f"seed {seed}: SV {tag} native raised {e!r}")
            continue
        for name, over in (
            ("pyloop", dict(native_caller="off")),
            ("pyall", dict(native_caller="off", native_aligner="off")),
        ):
            try:
                out = run_sv(f"{tag}_{name}", avg, **over)
                if vcf_text(out) != ref:
                    fails.append(f"seed {seed}: SV {tag} {name} differs")
            except Exception as e:
                fails.append(f"seed {seed}: SV {tag} {name} raised {e!r}")
        # object-array path (SAM re-encode defeats the BAM-bytes fast path)
        try:
            from types import SimpleNamespace

            from graphtyper_tpu.io.bam import read_alignments
            from graphtyper_tpu.io.sam_writer import write_sam

            sam_paths = []
            for i, p in enumerate(bams):
                header, reads = read_alignments(p, parse_tags=True)
                dst = os.path.join(tmp, f"re{i}.sam")
                write_sam(dst, header, list(reads))
                sam_paths.append(dst)
            bak = bams
            try:
                bams = sam_paths
                out = run_sv(f"{tag}_objpath", avg)
            finally:
                bams = bak
            if vcf_text(out) != ref:
                fails.append(f"seed {seed}: SV {tag} object-path differs")
        except Exception as e:
            fails.append(f"seed {seed}: SV {tag} object-path raised {e!r}")
    return fails


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    base = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    all_fails = []
    t0 = time.time()
    for seed in range(base, base + n):
        with tempfile.TemporaryDirectory(prefix="gt_fuzz_") as tmp:
            fails = fuzz_seed(seed, tmp)
            status = "OK" if not fails else "; ".join(fails)
            print(f"[{time.time()-t0:6.1f}s] seed {seed}: {status}", flush=True)
            all_fails.extend(fails)
    if all_fails:
        print(f"\nFUZZ FAILURES ({len(all_fails)}):")
        for f in all_fails:
            print(" ", f)
        sys.exit(1)
    print(f"\nall {n} seeds clean")


if __name__ == "__main__":
    main()
