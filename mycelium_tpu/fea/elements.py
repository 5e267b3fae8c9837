"""Per-element stiffness kernels (reference component C15).

The reference element is NOT a textbook beam: it is an axial truss term
(EA/L)·n⊗n plus an isotropic transverse penalty (12EI/L³)·(I − n⊗n), with 3
translational DOF per node and no rotations (reference src/fea_solver.py:30-68
``bar_stiffness_bulk``; scalar twin src/fea_petsc.cpp:88-140). Lengths are
clamped at 1e-12 to guard degenerate (coincident-node) elements.

Everything here is batched over elements — the (E,6,6) stiffness batch feeds
the explicit assembly path, while the *factored* form (unit direction n plus
the two scalar stiffnesses k_ax, k_bd) feeds the matrix-free operator where
a 6x6 matmul per element would waste work: K_e·u is 9 fused multiply-adds
per element in factored form.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import FeaConfig


class ElementGeometry(NamedTuple):
    """Static per-element data (the mesh never deforms: fracture strain is
    evaluated on the undeformed geometry each step — SURVEY.md §2.5.11)."""
    n: jnp.ndarray      # (E, 3) unit direction p2-p1
    length: jnp.ndarray  # (E,) true length
    k_ax: jnp.ndarray   # (E,) EA/L
    k_bd: jnp.ndarray   # (E,) 12EI/L^3


def element_geometry(coords: jnp.ndarray, conn: jnp.ndarray,
                     cfg: FeaConfig) -> ElementGeometry:
    p1 = coords[conn[:, 0]]
    p2 = coords[conn[:, 1]]
    d = p2 - p1
    length = jnp.linalg.norm(d, axis=1)
    l_safe = jnp.maximum(length, jnp.asarray(1e-12, coords.dtype))
    n = d / l_safe[:, None]
    k_ax = (cfg.e_mod * cfg.area) / l_safe
    k_bd = 12.0 * cfg.e_mod * cfg.moi / (l_safe ** 3)
    return ElementGeometry(n=n, length=length, k_ax=k_ax, k_bd=k_bd)


def element_stiffness_batch(geom: ElementGeometry) -> jnp.ndarray:
    """Dense (E, 6, 6) element stiffness batch.

    K_e = k_ax·[[nnᵀ,-nnᵀ],[-nnᵀ,nnᵀ]] + k_bd·[[P,-P],[-P,P]], P = I − nnᵀ.
    """
    n = geom.n
    nnT = n[:, :, None] * n[:, None, :]                   # (E,3,3)
    eye = jnp.eye(3, dtype=n.dtype)
    blk = (geom.k_ax[:, None, None] * nnT
           + geom.k_bd[:, None, None] * (eye - nnT))      # (E,3,3)
    top = jnp.concatenate([blk, -blk], axis=2)            # (E,3,6)
    bot = jnp.concatenate([-blk, blk], axis=2)
    return jnp.concatenate([top, bot], axis=1)            # (E,6,6)


def element_forces(u_nodes: jnp.ndarray, conn: jnp.ndarray,
                   geom: ElementGeometry,
                   active: jnp.ndarray) -> jnp.ndarray:
    """Per-element end force in factored form.

    Returns f (E,3): the force K_e·u exerts on node n1; node n2 receives -f.
    f = k_ax·n·(n·(u1-u2)) + k_bd·((u1-u2) − n·(n·(u1-u2))).
    Inactive (fractured) elements contribute zero instead of shrinking the
    system — the sparsity pattern stays static across the whole ramp.
    """
    u1 = u_nodes[conn[:, 0]]
    u2 = u_nodes[conn[:, 1]]
    d = u1 - u2
    nd = jnp.sum(geom.n * d, axis=1)
    f = (geom.k_ax * nd)[:, None] * geom.n \
        + geom.k_bd[:, None] * (d - nd[:, None] * geom.n)
    return f * active[:, None].astype(f.dtype)


def element_strain(u_nodes: jnp.ndarray, conn: jnp.ndarray,
                   geom: ElementGeometry) -> jnp.ndarray:
    """Axial strain n·(u2-u1)/L on the undeformed geometry
    (reference src/fea_solver.py:269-281)."""
    du = u_nodes[conn[:, 1]] - u_nodes[conn[:, 0]]
    l_safe = jnp.maximum(geom.length,
                         jnp.asarray(1e-12, geom.length.dtype))
    return jnp.sum(geom.n * du, axis=1) / l_safe
