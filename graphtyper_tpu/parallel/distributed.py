"""Multi-process orchestration: region sharding over processes (hosts, or
one process per card on one machine) with data-parallel read batches within
each process.

The reference scales beyond one machine only by running independent processes
on ~50kb regions and concatenating the per-region VCFs (SURVEY §2.5 "Region
sharding", main.cpp:30-58, genotype.cpp:734-739). The equivalent here
keeps that region independence — regions are embarrassingly parallel — and
adds a real multi-host runtime under it:

- `initialize()` brings up jax.distributed so all hosts share one JAX runtime
  and every host sees the global device set.
- `assign_regions()` deterministically shards the region list across hosts;
  each host genotypes only its share (graph + index replicated per region,
  never crossing hosts — the host boundary carries no tensor traffic).
- Within a host, read batches are data-parallel over the local mesh
  (parallel/mesh.py) with psum across the local devices.
- `host_mesh()` builds the local-device mesh; `global_mesh()` builds a
  ("host", "data") mesh for collectives that must span hosts (e.g. cohort-
  wide INFO accumulation).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> None:
    """Bring up the multi-process JAX runtime (no-op when single-process).

    `local_device_ids` pins this process to those local cards, so several
    processes on one machine each own one card instead of all reserving
    memory on every card. The backend comes up here, in every process
    together: its creation exchanges the device topology, so a process that
    only touched the device late (or never, with no regions to run) would
    leave the others waiting."""
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    jax.devices()


def num_hosts() -> int:
    return jax.process_count()


def host_id() -> int:
    return jax.process_index()


def assign_regions(regions: list, n_hosts: int | None = None, host: int | None = None) -> list:
    """Deterministic contiguous split of the region list for this host.

    Contiguous (not round-robin) so each host touches a minimal span of the
    reference and BAM files — locality mirrors the reference's per-process
    region ranges (main.cpp:30-58)."""
    n_hosts = n_hosts if n_hosts is not None else num_hosts()
    host = host if host is not None else host_id()
    if n_hosts <= 1:
        return list(regions)
    if not (0 <= host < n_hosts):
        raise ValueError(f"host {host} not in [0, {n_hosts})")
    bounds = np.linspace(0, len(regions), n_hosts + 1).astype(int)
    return list(regions[bounds[host] : bounds[host + 1]])


def host_mesh(axis: str = "data") -> Mesh:
    """Mesh over this process's local devices."""
    return Mesh(np.array(jax.local_devices()), (axis,))


def global_mesh(host_axis: str = "host", data_axis: str = "data") -> Mesh:
    """("host", "data") mesh over all devices: one row of local devices per
    process. Collectives over `data` stay inside a process; only explicit
    reductions over `host` cross processes."""
    n_hosts = jax.process_count()
    devices = np.array(jax.devices()).reshape(n_hosts, -1)
    return Mesh(devices, (host_axis, data_axis))


def genotype_regions_distributed(
    ref_path: str,
    sams: list[str],
    regions: list[str],
    output_path: str,
    n_hosts: int | None = None,
    host: int | None = None,
    **kw,
) -> list[str]:
    """Genotype this host's share of the regions (the cross-host analog of
    genotype_regions). Host identity comes from the jax.distributed runtime
    when initialized; pass n_hosts/host explicitly to run reference-style
    independent processes without one. All hosts write into the same
    region-structured output tree, so the union of all hosts' outputs is the
    complete result; merge afterwards with
    pipeline/vcf_operations.vcf_concatenate when a single file is wanted."""
    from graphtyper_tpu.pipeline.genotype import genotype_regions

    mine = assign_regions(regions, n_hosts, host)
    outs: list[str] = []
    for region in mine:
        outs.extend(genotype_regions(ref_path, sams, region, output_path, **kw))
    return outs


# ---------------------------------------------------------------------------
# Cross-host cohort genotyping: samples sharded over hosts, one region
# ---------------------------------------------------------------------------


def _allgather_bytes(payload: bytes) -> list[bytes]:
    """Gather one byte-string from every process (a collective over a
    padded uint8 tensor; jax.experimental.multihost_utils)."""
    from jax.experimental import multihost_utils

    n = np.asarray(len(payload), dtype=np.int64)
    sizes = np.atleast_1d(multihost_utils.process_allgather(n))
    m = max(1, int(sizes.max()))
    buf = np.zeros(m, dtype=np.uint8)
    if payload:
        buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    gathered = multihost_utils.process_allgather(buf)
    gathered = np.atleast_2d(gathered)
    return [gathered[i, : int(sizes[i])].tobytes() for i in range(gathered.shape[0])]


class DiscoveryDist:
    """Distribution hooks for streamlined_discovery: contiguous file
    ownership per host, partials allgather, and sequential realignment
    state rounds (see typer/discovery.py)."""

    def __init__(self, n_files: int, n_hosts: int | None = None, host: int | None = None):
        self.n_hosts = n_hosts if n_hosts is not None else num_hosts()
        self.host = host if host is not None else host_id()
        bounds = np.linspace(0, n_files, self.n_hosts + 1).astype(int)
        self.lo = int(bounds[self.host])
        self.hi = int(bounds[self.host + 1])

    def owns(self, file_i: int) -> bool:
        return self.lo <= file_i < self.hi

    def allgather(self, obj):
        import pickle

        return [pickle.loads(b) for b in _allgather_bytes(pickle.dumps(obj))]

    def sync_state(self, file_i: int, state):
        """One realignment round: the owner contributes the post-realign
        event state; everyone receives it."""
        import pickle

        payload = pickle.dumps(state) if state is not None else b""
        parts = [b for b in _allgather_bytes(payload) if b]
        if state is not None:
            return state
        return pickle.loads(parts[0])


def genotype_distributed(
    ref_path: str,
    sams: list[str],
    region_str: str,
    output_path: str,
    avg_cov_by_readlen: list[float] | None = None,
    is_extra_call_only_iteration: bool = False,
    output_all_variants: bool = False,
) -> str | None:
    """The full discovery + iterative pipeline with SAMPLES sharded across
    hosts for one region — the cross-host cohort analog of the reference's
    pool-file merge (src/typer/vcf_operations.cpp:20-142). Each host
    bamshrinks + calls only its sample shard; per-iteration pool results
    gather across processes as batched .vcfb bytes + pickled phasing maps and merge
    through the same code as the in-process multi-pool path, so every host
    reconstructs the identical cohort state (byte-identical to a
    single-process run; asserted by tests/parallel/test_distributed_e2e.py).
    Host 0 writes the final outputs; other hosts return None."""
    import os
    import pickle
    import shutil
    import tempfile

    import jax

    from graphtyper_tpu.config import current_options
    from graphtyper_tpu.graph.build import construct_graph
    from graphtyper_tpu.graph.coords import AbsolutePosition, GenomicRegion
    from graphtyper_tpu.index.build import index_graph
    from graphtyper_tpu.io.fasta import FastaFile
    from graphtyper_tpu.pipeline.caller import call_pools
    from graphtyper_tpu.pipeline.vcf_operations import (
        merge_ph_maps,
        vcf_merge_and_break,
        vcf_merge_and_filter,
        vcf_merge_streamed,
    )
    from graphtyper_tpu.typer.discovery import streamlined_discovery
    from graphtyper_tpu.typer.vcf_out import VcfOutput

    import time as _time

    _prof = bool(os.environ.get("GT_DIST_PROFILE"))
    _t_last = _time.perf_counter()

    def _mark(stage: str) -> None:
        nonlocal _t_last
        if _prof:
            now = _time.perf_counter()
            print(f"[gt_dist h{jax.process_index()}] {stage} {now - _t_last:.2f}s",
                  flush=True)
            _t_last = now

    n_hosts = jax.process_count()
    host = jax.process_index()
    bounds = np.linspace(0, len(sams), n_hosts + 1).astype(int)
    lo, hi = int(bounds[host]), int(bounds[host + 1])
    my_sams = list(sams[lo:hi])
    my_cov = avg_cov_by_readlen[lo:hi] if avg_cov_by_readlen is not None else None

    region = GenomicRegion.parse(region_str)
    fasta = FastaFile(ref_path)
    if fasta.has_contig(region.chr):
        region.end = min(region.end, fasta.contig_length(region.chr))
    padded = GenomicRegion(region.chr, region.begin, region.end)
    padded.pad(1000)
    if fasta.has_contig(region.chr):
        padded.end = min(padded.end, fasta.contig_length(region.chr))
    contigs = list(fasta.contigs)
    abs_pos = AbsolutePosition(contigs)
    fasta.close()

    tmp = tempfile.mkdtemp(prefix=f"gt_dist_h{host}_")
    if host == 0:
        os.makedirs(output_path, exist_ok=True)
        os.makedirs(os.path.join(output_path, region.chr), exist_ok=True)
        os.makedirs(os.path.join(output_path, "input_sites", region.chr), exist_ok=True)

    if not current_options().no_bamshrink:
        from graphtyper_tpu.pipeline.bamshrink import run_bamshrink

        my_sams = run_bamshrink(my_sams, padded, tmp, my_cov, current_options())
    _mark("bamshrink")

    # global path list: only owned entries are real paths on this host
    global_paths = [""] * len(sams)
    for i, p in enumerate(my_sams):
        global_paths[lo + i] = p

    # ---- iteration 1: distributed discovery --------------------------------
    dist = DiscoveryDist(len(sams))
    sample_names: list[str] = []
    sites_vcf = streamlined_discovery(
        global_paths, ref_path, padded.to_string(), sample_names, dist=dist
    )
    _mark("discovery")
    it1_final = os.path.join(tmp, "it1_final.vcf.gz")
    sites_vcf.write(it1_final, contigs, abs_pos, filter_zero_qual=False, is_dropping_genotypes=True)

    def gather_merge(result):
        """Pool results of all hosts -> (merged VcfOutput, merged ph) on
        host 0; (None, None) elsewhere. Every host contributes its shard's
        batched pool bytes + pickled ph map to the collective, but only
        host 0 pays the cohort merge — its (deterministic) products are
        broadcast back as files by bcast_file below, so the other hosts
        skip the duplicated merge entirely."""
        local = os.path.join(tmp, "pool_local.vcfb")
        result.vcf.save_batched(local)
        with open(local, "rb") as f:
            payload = f.read()
        vcfb_all = _allgather_bytes(payload)
        ph_all = [pickle.loads(b) for b in _allgather_bytes(pickle.dumps(result.ph))]
        if host != 0:
            return None, None
        paths = []
        for i, b in enumerate(vcfb_all):
            p = os.path.join(tmp, f"pool_h{i}.vcfb")
            with open(p, "wb") as f:
                f.write(b)
            paths.append(p)
        names, variants = vcf_merge_streamed(paths)
        merged = VcfOutput(sample_names=names, variants=list(variants))
        return merged, merge_ph_maps(ph_all)

    def gather_stats_reduce(result):
        """Non-last-iteration reduction (the distributed form of the pool
        merge): the iteration handoff (vcf_merge_and_filter) only consumes
        PER-VARIANT COHORT AGGREGATES — VarStats accumulators (scan_calls is
        a pure order-free sum/max per sample, variant.cpp:230-330) and the
        phasing map. So each host scans its own sample shard locally and the
        collective ships O(variants) stats partials instead of the full
        O(samples x variants) call matrix; every host then folds the
        partials (add_stats, host order) and computes the IDENTICAL filtered
        sites list with no host-0 merge and no broadcast."""
        from graphtyper_tpu.typer.native_finisher import scan_variants

        variants = result.vcf.variants
        unhandled = scan_variants(variants, len(result.vcf.sample_names))
        for v in unhandled:
            v.scan_calls()
        payload = pickle.dumps([v.stats for v in variants])
        stats_all = [pickle.loads(b) for b in _allgather_bytes(payload)]
        ph_all = [pickle.loads(b) for b in _allgather_bytes(pickle.dumps(result.ph))]
        for h, stats_list in enumerate(stats_all):
            if h == host:
                continue
            if len(stats_list) != len(variants):
                raise RuntimeError("cross-host variant skeletons diverged")
            for v, st in zip(variants, stats_list):
                v.stats.add_stats(st)
        for v in variants:
            v.calls = []  # stats carry everything the handoff needs
        result.vcf.sample_names = list(sample_names)
        return result.vcf, merge_ph_maps(ph_all)

    def bcast_file(path: str, sidecars: tuple = (".tbi", ".csi")) -> None:
        """Broadcast host-0's file (+ existing sidecars) to every host."""
        names = [path] + [path + ext for ext in sidecars]
        if host == 0:
            payload = pickle.dumps(
                [(os.path.basename(p), open(p, "rb").read()) for p in names if os.path.exists(p)]
            )
        else:
            payload = b""
        parts = [b for b in _allgather_bytes(payload) if b]
        if host != 0:
            for base, data in pickle.loads(parts[0]):
                for p in names:
                    if os.path.basename(p) == base:
                        with open(p, "wb") as f:
                            f.write(data)

    FIRST, LAST = 2, 3 + (1 if is_extra_call_only_iteration else 0)
    prev_vcf = it1_final
    out_vcf_path = os.path.join(tmp, "graphtyper.vcf.gz")
    prev_index = None
    for i in range(FIRST, LAST + 1):
        is_last = i == LAST
        graph = construct_graph(
            ref_path, prev_vcf, padded.to_string(), is_sv_graph=False, use_index=True,
            add_all_variants=True,
        )
        # successive iterations share the reference-backbone k-mers, so the
        # seed filter carries over additively instead of rebuilding — the
        # same donor chain genotype() uses (replicated per-host work shrinks,
        # which is where sample-sharded efficiency leaks)
        index = index_graph(graph, seed_filter_donor=prev_index)
        prev_index = index
        _mark(f"graph_index_it{i}")
        # rep-sharded align exchange (GT_REP_SHARD=1, parallel/rep_shard.py):
        # hosts split the cohort's deduplicated oriented-sequence space, so
        # the align stage divides ~linearly instead of replicating the
        # near-constant rep set on every host
        rep_oracle = None
        if os.environ.get("GT_REP_SHARD", "") == "1" and n_hosts > 1:
            from graphtyper_tpu.pipeline import native_caller as _nc
            from graphtyper_tpu.pipeline.caller import SAM_FLAG_FILTER, split_pools
            from graphtyper_tpu.parallel import rep_shard

            if _nc.available():
                union_key = (padded.to_string(), tuple(my_sams))
                if rep_shard._LOCAL_CACHE.get(union_key) is None:
                    my_seqs = rep_shard.local_row_seqs(
                        split_pools(my_sams), padded, SAM_FLAG_FILTER, ref_path=ref_path
                    )
                else:  # reads are iteration-invariant: partition cached
                    my_seqs = np.zeros((0, 0), dtype=np.uint8)
                rep_oracle = rep_shard.build_oracle(
                    graph, index, my_seqs, _allgather_bytes, n_hosts, host,
                    union_key=union_key,
                )
                _mark(f"rep_exchange_it{i}")
        result = call_pools(
            graph, index, my_sams,
            region=padded,
            avg_cov_by_readlen=my_cov,
            is_writing_calls_vcf=is_last,
            is_writing_hap=not is_last,
            ref_path=ref_path,
            rep_oracle=rep_oracle,
        )
        _mark(f"call_it{i}")
        if not is_last:
            # stats-partial collective: O(variants) on the wire, every host
            # computes the identical handoff — no host-0 merge, no broadcast
            merged_vcf, merged_ph = gather_stats_reduce(result)
            _mark(f"gather_stats_it{i}")
            next_vcf = os.path.join(tmp, f"it{i}_final.vcf.gz")
            vcf_merge_and_filter([merged_vcf], next_vcf, merged_ph, graph)
            _mark(f"merge_filter_it{i}")
            prev_vcf = next_vcf
            continue
        merged_vcf, merged_ph = gather_merge(result)
        _mark(f"gather_merge_it{i}")
        if host == 0:
            # only host 0 emits output: the final merge/decompose is pure
            # sink work, so the other hosts skip it
            vcf_merge_and_break(
                [merged_vcf], out_vcf_path, region.to_string(), graph,
                filter_zero_qual=output_all_variants,
            )
            _mark("final_merge_break")

    dst = None
    if host == 0:
        sites_dst = os.path.join(output_path, "input_sites", region.to_file_string() + ".vcf.gz")
        shutil.copyfile(prev_vcf, sites_dst)
        final_name = f"{region.begin + 1:09d}-{region.end:09d}.vcf.gz"
        dst = os.path.join(output_path, region.chr, final_name)
        shutil.copyfile(out_vcf_path, dst)
        for ext in (".tbi", ".csi"):
            if os.path.exists(out_vcf_path + ext):
                shutil.copyfile(out_vcf_path + ext, dst + ext)
    shutil.rmtree(tmp, ignore_errors=True)
    return dst
