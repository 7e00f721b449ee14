"""Batched read-vs-haplotype mismatch counting as a matrix product.

The reference's graph "DFS" extension is bounded sequence enumeration +
Hamming counting (graph.cpp:1246-1276). The batched formulation: one-hot
encode reads [R, L, 4] and candidate haplotype windows [H, L, 4], then
matches = readOH . hapOH^T — a single int8 matmul; mismatches =
valid_overlap - matches. N bases (code 4) and padding one-hot to zero, so
they never count as matches; their contribution is removed from the overlap
term instead.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp


def one_hot_acgt(codes: jnp.ndarray) -> jnp.ndarray:
    """[..., L] uint8 codes -> [..., L, 4] int8; codes >= 4 (N/pad/tag) are
    all-zero. int8 because the values are exactly 0/1 and the products
    accumulate exactly in int32."""
    return jax.nn.one_hot(codes, 4, dtype=jnp.int8)


def _dot_int8(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a [M, K] . b [N, K]^T -> [M, N] int32."""
    return jax.lax.dot_general(a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)


@jax.jit
def mismatch_matrix(read_codes: jnp.ndarray, hap_codes: jnp.ndarray) -> jnp.ndarray:
    """Mismatch counts [R, H] between reads [R, L] and haplotypes [H, L].

    A position counts as a mismatch iff both sides are definite bases (A/C/G/T)
    and differ — matching count_mismatches semantics where N matches anything
    (pads/Ns are excluded from the comparison entirely; tag rejection is
    handled by the caller before batching).
    """
    r_oh = one_hot_acgt(read_codes).reshape(read_codes.shape[0], -1)  # [R, L*4]
    h_oh = one_hot_acgt(hap_codes).reshape(hap_codes.shape[0], -1)  # [H, L*4]
    matches = _dot_int8(r_oh, h_oh)  # [R, H]
    r_def = (read_codes < 4).astype(jnp.int8)  # definite bases [R, L]
    h_def = (hap_codes < 4).astype(jnp.int8)  # [H, L]
    overlap = _dot_int8(r_def, h_def)  # [R, H]
    return overlap - matches
