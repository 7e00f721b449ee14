"""Multi-device execution: shard read batches over a device mesh and reduce
per-site score tensors with collectives.

This replaces the reference's thread-pool + file-based reduction (SURVEY
§2.5): read batches are data-parallel over the `data` mesh axis; the
per-site PL-triangle updates and depth counts are `psum`-reduced across the
devices instead of merged through cereal files.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtyper_tpu.ops.genotype_step import genotype_forward


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def sharded_genotype_step(mesh: Mesh, max_mismatches: int = 10):
    """Build a jitted multi-chip genotyping step: reads sharded over `data`,
    haplotype bank replicated, score delta psum-reduced."""

    def step(read_codes, hap_codes, hap_allele, eps):
        delta, B = genotype_forward(read_codes, hap_codes, hap_allele, eps, max_mismatches)
        delta = jax.lax.psum(delta, axis_name="data")
        depth = jax.lax.psum(B.sum(axis=0), axis_name="data")
        return delta, depth

    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P("data", None), P(None, None), P(None, None), P("data")),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )


def shard_reads(mesh: Mesh, read_codes: np.ndarray, eps: np.ndarray):
    """Place host read arrays onto the mesh, padded to a multiple of the
    data-axis size."""
    n = mesh.devices.size
    R = read_codes.shape[0]
    pad = (-R) % n
    if pad:
        read_codes = np.concatenate([read_codes, np.full((pad, read_codes.shape[1]), 5, dtype=read_codes.dtype)])
        eps = np.concatenate([eps, np.zeros(pad, dtype=eps.dtype)])
    reads_sharding = NamedSharding(mesh, P("data", None))
    eps_sharding = NamedSharding(mesh, P("data"))
    return (
        jax.device_put(read_codes, reads_sharding),
        jax.device_put(eps, eps_sharding),
    )
