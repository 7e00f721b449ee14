"""Batched genotype-likelihood updates on device.

The reference updates the diploid PL triangle read-by-read
(haplotype.cpp:560-583): for each pair (x<=y),
    log_score[x,y] += eps        if read explains both x and y
                      eps - 1    if it explains exactly one
                      0          otherwise.

Summed over a read batch with explains bitmap B [R, A] and weights eps [R],
this decomposes into matrix-product form:

    delta[x,y] = u_x + u_y + W_xy        (x != y)
    delta[x,x] = e_x                      (diagonal: eps if explains x)
where u = B^T (eps-1),  W = B^T diag(2-eps) B,  e = B^T eps.

Check: both -> (eps-1)+(eps-1)+(2-eps) = eps; one -> eps-1; none -> 0;
diagonal W_xx = (2-eps)B_x and u_x+u_x+W_xx = 2(eps-1)+2-eps = eps. So the
same formula covers the diagonal too. One batched matmul replaces R * A^2/2
scalar updates — the batched formulation of explain_to_score. The float32
products hold integer counts, so they run at HIGHEST precision (a GPU would
otherwise take them in TF32).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("num_alleles",))
def score_update_dense(B: jnp.ndarray, eps: jnp.ndarray, num_alleles: int) -> jnp.ndarray:
    """Dense [A, A] log-score delta from explains bitmap B [R, A] (float) and
    per-read epsilon exponents eps [R] (float). Reads with all-zero rows
    contribute nothing."""
    del num_alleles
    Bf = B.astype(jnp.float32)
    active = (Bf.sum(axis=1) > 0).astype(jnp.float32)
    epsf = eps.astype(jnp.float32) * active
    hi = jax.lax.Precision.HIGHEST
    u = jnp.matmul(Bf.T, (eps - 1.0) * active, precision=hi)  # [A]
    W = jnp.matmul((Bf * (2.0 - epsf)[:, None]).T, Bf, precision=hi)  # [A, A]
    return u[:, None] + u[None, :] + W


def triangle_indices(num_alleles: int) -> tuple[np.ndarray, np.ndarray]:
    """x, y arrays for the flattened upper triangle, index = x + y(y+1)/2."""
    xs, ys = [], []
    for y in range(num_alleles):
        for x in range(y + 1):
            xs.append(x)
            ys.append(y)
    return np.array(xs), np.array(ys)


def score_update_triangle(B: np.ndarray, eps: np.ndarray, num_alleles: int) -> np.ndarray:
    """Flattened triangle delta (matches HapSample.log_score layout)."""
    dense = np.asarray(score_update_dense(jnp.asarray(B), jnp.asarray(eps), num_alleles))
    xs, ys = triangle_indices(num_alleles)
    out = np.rint(dense[xs, ys]).astype(np.int64)
    return out


def batch_explains_to_matrix(
    explains_per_read: list[set[int]], num_alleles: int
) -> np.ndarray:
    """Pack per-read explain sets into a dense bitmap [R, A]."""
    B = np.zeros((len(explains_per_read), num_alleles), dtype=np.float32)
    for r, ex in enumerate(explains_per_read):
        for a in ex:
            if a < num_alleles:
                B[r, a] = 1.0
    return B
