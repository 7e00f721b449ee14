"""The fused device genotyping step — the flagship compute path.

One jittable function takes a read batch, a bank of enumerated local
haplotype windows (with their per-allele assignments), and per-read quality
penalties, and produces the per-site diploid log-score update:

    reads [R, L] --one-hot matmul--> mismatches [R, H]
    best-hit masking -> explains bitmap [R, A]
    bitmap --Gram matmul--> PL-triangle update [A, A]

The float32 products hold integer counts, so they run at HIGHEST precision
(a GPU would otherwise take them in TF32).

This replaces the reference's per-read scalar pipeline (align_read +
explain_to_score) for the batched regime; multi-chip execution shards reads
over a `data` mesh axis and psums the score update (parallel/mesh.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from graphtyper_tpu.ops.hamming import mismatch_matrix

_HI = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("max_mismatches",))
def genotype_forward(
    read_codes: jnp.ndarray,  # [R, L] uint8 (A0..T3, N=4, pad=5)
    hap_codes: jnp.ndarray,  # [H, L] uint8 haplotype windows
    hap_allele: jnp.ndarray,  # [H, A] 0/1: window h uses allele a
    eps: jnp.ndarray,  # [R] float epsilon exponents
    max_mismatches: int = 10,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (score_delta [A, A], explains [R, A])."""
    mm = mismatch_matrix(read_codes, hap_codes)  # [R, H]
    best = jnp.min(mm, axis=1, keepdims=True)  # [R, 1]
    hit = (mm == best) & (mm <= max_mismatches)  # [R, H] best-path windows
    B = (jnp.matmul(hit.astype(jnp.float32), hap_allele.astype(jnp.float32), precision=_HI) > 0)
    B = B.astype(jnp.float32)
    active = (B.sum(axis=1) > 0).astype(jnp.float32)
    epsf = eps.astype(jnp.float32) * active
    u = jnp.matmul(B.T, epsf - active, precision=_HI)  # Bᵀ(eps-1), inactive reads zeroed
    W = jnp.matmul((B * (2.0 * active - epsf)[:, None]).T, B, precision=_HI)
    delta = u[:, None] + u[None, :] + W
    return delta, B
