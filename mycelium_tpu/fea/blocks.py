"""Batched 3x3 block algebra as component-unrolled elementwise math.

``jnp.einsum("nij,njk->nik")`` lowers to a batched ``dot_general`` with
a contraction of size 3, which a matrix unit cannot use and whose
minor (3,3) dims pad badly in device layouts. Unrolling the contraction
into elementwise multiply-adds on (n,) component planes keeps every
buffer at its natural layout and turns the op into plain fused
elementwise work.

All products here are plain f32/f64 elementwise arithmetic, so they
are exact at the array dtype whatever the backend's default matmul
precision is (on a GPU that default is TF32 for f32 operands).
"""

from __future__ import annotations

import jax.numpy as jnp


def mm3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched block product: (n,3,3) @ (n,3,3) -> (n,3,3)."""
    rows = []
    for i in range(3):
        rows.append(jnp.stack(
            [a[:, i, 0] * b[:, 0, k]
             + a[:, i, 1] * b[:, 1, k]
             + a[:, i, 2] * b[:, 2, k] for k in range(3)], axis=-1))
    return jnp.stack(rows, axis=1)


def mv3(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched block-vector product: (n,3,3) x (n,3[,K]) -> (n,3[,K])."""
    if v.ndim == 2:
        return jnp.stack(
            [m[:, i, 0] * v[:, 0]
             + m[:, i, 1] * v[:, 1]
             + m[:, i, 2] * v[:, 2] for i in range(3)], axis=1)
    return jnp.stack(
        [m[:, i, 0, None] * v[:, 0]
         + m[:, i, 1, None] * v[:, 1]
         + m[:, i, 2, None] * v[:, 2] for i in range(3)], axis=1)


def mtv3(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched transposed block-vector product: m^T v, (n,3[,K]) out."""
    if v.ndim == 2:
        return jnp.stack(
            [m[:, 0, i] * v[:, 0]
             + m[:, 1, i] * v[:, 1]
             + m[:, 2, i] * v[:, 2] for i in range(3)], axis=1)
    return jnp.stack(
        [m[:, 0, i, None] * v[:, 0]
         + m[:, 1, i, None] * v[:, 1]
         + m[:, 2, i, None] * v[:, 2] for i in range(3)], axis=1)


def spd_inverse_ns(M: jnp.ndarray, phase1: int = 40,
                   polish: int = 3) -> jnp.ndarray:
    """Newton–Schulz dense inverse for SPD matrices — an ALTERNATIVE to
    ``jnp.linalg.inv`` (LU with partial pivoting, a serial-latency
    algorithm) for the preconditioner factors, not on the default path.
    The iteration X <- X(2I - MX) is two matmuls per step fused into one
    fori_loop program. Kept unit-tested
    (test_fea_core.py::test_spd_inverse_ns_matches_lu) for solver work
    where the inverse's latency is exposed.

    Robustness: M is symmetrically normalized to unit diagonal first
    (zero/negative diagonal entries — identity-padded grip rows — keep
    scale 1), and X0 = I/||A||_inf guarantees the spectrum of X0·A lies
    in (0, 1]. Convergence is then one error SQUARING per iteration:
    err_k = (1 - 1/kappa)^(2^k), so ``phase1`` = 40 covers kappa up to
    ~1e10 before the dtype floor. Every matmul runs at
    Precision.HIGHEST: reduced-precision products (TF32 on a GPU) add
    noise above the 1/kappa contraction margin of the early slow phase
    and can diverge the map. ``polish`` further iterations square away
    the last rounding and symmetrize, so the result stays an SPD
    preconditioner for CG. The achievable relative error is ~eps·kappa —
    the same limit an LU inverse of the same dtype has.
    """
    import jax
    n = M.shape[0]
    dt = M.dtype
    d = jnp.diagonal(M)
    s = jnp.where(d > 0, jax.lax.rsqrt(
        jnp.maximum(d, jnp.asarray(1e-30, dt))), 1.0).astype(dt)
    A = s[:, None] * M * s[None, :]
    c = jnp.maximum(jnp.max(jnp.sum(jnp.abs(A), axis=1)),
                    jnp.asarray(1.0, dt))
    X = (jnp.eye(n, dtype=dt) / c)
    hi = jax.lax.Precision.HIGHEST

    def body1(_, X):
        T = jnp.matmul(A, X, precision=hi)
        return 2.0 * X - jnp.matmul(X, T, precision=hi)

    X = jax.lax.fori_loop(0, phase1, body1, X)

    def body2(_, X):
        T = jnp.matmul(A, X, precision=hi)
        X = 2.0 * X - jnp.matmul(X, T, precision=hi)
        return 0.5 * (X + X.T)

    X = jax.lax.fori_loop(0, polish, body2, X)
    return s[:, None] * X * s[None, :]
