"""Cluster-Galerkin coarse space of the two-level preconditioners.

Clusters are runs of consecutive chain positions (chain.py), 128 per
block, so restriction to the coarse space is a reshape-sum and
prolongation a broadcast. This module builds the dense coarse operator
and its inverse; solve.py applies it on the single-device path and
shard.py on the sharded one. Reference analogue: the 'gamg' leg of the
PETSc sweep (src/fea_petsc_solverAndPC.cpp:223).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .chain import BLOCK

# entry budget of the matmul form of the coarse jump assembly's dense
# (3J·n_basis, nc) incidence (f32: 2^28 entries = ~1 GB transient); bigger
# jump sets fall back to the 36-entries-per-jump scatter assembly (see
# _coarse_matrix_chain — a real exported mesh with 488k jumps would
# otherwise build a 7.9 GB incidence inside the ramp's factor recompute)
COARSE_MATMUL_CAP = 1 << 28


def plan_nb(n_nodes: int) -> int:
    """128-position chain blocks covering the mesh, always leaving >= 1
    padding position at the end."""
    return n_nodes // BLOCK + 1


def _ramp_weight(pos_in_cluster, width: int = BLOCK):
    """Normalized linear coordinate within a width-node cluster, in
    [-1, 1]."""
    return (pos_in_cluster.astype(jnp.float32) - (width - 1) / 2) \
        / (width / 2)


def coarse_cluster_blocks(nb: int, cfg) -> int:
    """128-position chain blocks per coarse cluster: the smallest k that
    keeps the dense coarse operator's dimension n_basis*3*ceil(nb/k) under
    cfg.coarse_max_dim (k=1 — one block per cluster — up to ~131k nodes
    with the 'const' basis and a 3072 cap). Every consumer of
    _coarse_inverse must restrict/prolong with the SAME k."""
    n_basis = 2 if cfg.coarse_basis == "linear" else 1
    cap = max(int(cfg.coarse_max_dim), 3 * n_basis)
    return -(-(3 * n_basis * nb) // cap)


def _coarse_matrix_scatter(model, plan, active, free, cfg, nb,
                           kblk: int = 1):
    """Element-scatter assembly of the coarse Galerkin matrix (the
    original formulation; kept as the oracle for _coarse_matrix_chain,
    whose banded form avoids this (E·(6b)²)-entry scatter-add)."""
    from .elements import element_stiffness_batch
    f32 = jnp.float32
    conn = model.conn
    width = kblk * BLOCK                             # cluster width
    nbc = -(-nb // kblk)                             # clusters
    nc3 = 3 * nbc
    nc = (2 if cfg.coarse_basis == "linear" else 1) * nc3
    n_basis = 2 if cfg.coarse_basis == "linear" else 1
    pos = plan.inv_perm                              # (N,) chain position
    cl = pos // width                                # (N,) cluster ids
    ramp = _ramp_weight(pos % width, width)          # (N,)
    ke = element_stiffness_batch(model.geom).astype(f32)      # (E,6,6)
    f = free.astype(f32)
    # expand the 6x6 element block to the coarse dofs: order
    # (endpoint, basis) groups x 3 comps = [p0c(, p0r), p1c(, p1r)] x xyz
    rowmap = jnp.asarray(
        ([0, 1, 2] * n_basis) + ([3, 4, 5] * n_basis), jnp.int32)
    ke12 = ke[:, rowmap][:, :, rowmap]               # (E,6b,6b)
    w = []
    dof = []
    comp = jnp.arange(3, dtype=jnp.int32)
    for p in range(2):
        n_p = conn[:, p]
        for fb in range(n_basis):                    # basis: const(, ramp)
            wgt = (f[n_p] if fb == 0 else f[n_p] * ramp[n_p])
            w.append(jnp.repeat(wgt[:, None], 3, axis=1))
            dof.append(fb * nc3 + comp[None, :] * nbc + cl[n_p][:, None])
    nd = 6 * n_basis
    w12 = jnp.concatenate(w, axis=1)                 # (E,6b)
    dof12 = jnp.concatenate(dof, axis=1)             # (E,6b)
    vals = ke12 * (w12[:, :, None] * w12[:, None, :]) \
        * active.astype(f32)[:, None, None]
    rows = jnp.repeat(dof12, nd, axis=1)
    cols = jnp.tile(dof12, (1, nd))
    flat = (rows * nc + cols).reshape(-1)
    a = jnp.zeros((nc * nc,), f32).at[flat].add(vals.reshape(-1))
    # reg·P per node: 2x2 basis block [1, r; r, r^2] per comp. NO (I-P)
    # identity term: the restriction is free-masked (pinned residual rows
    # are zero) and grip identity entries would flatten the correction.
    dreg = np.float32(cfg.reg) * f
    base = comp[None, :] * nbc + cl[:, None]         # (N,3)
    for fa in range(n_basis):
        for fb in range(n_basis):
            wv = dreg * (ramp ** (fa + fb))
            ia = fa * nc3 + base
            ib = fb * nc3 + base
            a = a.at[(ia * nc + ib).reshape(-1)].add(
                jnp.repeat(wv[:, None], 3, 1).reshape(-1))
    return a.reshape(nc, nc)


def _coarse_matrix_chain(model, plan, active, free, cfg, nb,
                         kblk: int = 1):
    """Chain-banded assembly of the coarse Galerkin matrix.

    Clusters are CONTIGUOUS runs of chain positions, so a chain edge
    (position i -- i+1) couples cluster cl(i) to itself or to cl(i)+1:
    per (basis a, basis b, comp, comp') pair the whole chain's
    contribution reduces to cluster reshape-sums plus one strided slice
    for the boundary slots — banded writes of O(nbc) instead of the
    element scatter's E·(6b)² updates (14.8M at 103k nodes). Jump edges
    (few thousand) are added separately.
    Numerically the same matrix up to summation order
    (tests/test_coarse.py compares against _coarse_matrix_scatter)."""
    f32 = jnp.float32
    width = kblk * BLOCK
    nbc = -(-nb // kblk)
    nc3 = 3 * nbc
    n_basis = 2 if cfg.coarse_basis == "linear" else 1
    nc = n_basis * nc3
    n = model.n_nodes
    npad = nbc * width
    car = jnp.arange(nbc, dtype=jnp.int32)

    def padp(x):
        return jnp.pad(x.astype(f32), (0, npad - n))

    act_pad = jnp.concatenate([active.astype(bool),
                               jnp.zeros((1,), bool)])
    f_pos = padp(free[plan.perm].astype(f32))
    ramp_pos = _ramp_weight(jnp.arange(npad, dtype=jnp.int32) % width,
                            width)
    # endpoint weights per basis: a = position i, b = position i+1
    wa = [f_pos] + ([f_pos * ramp_pos] if n_basis == 2 else [])
    wb = [jnp.concatenate([w[1:], jnp.zeros((1,), f32)]) for w in wa]

    # chain-edge k3 component planes (full operator: no tree mask)
    m_c = padp(act_pad[plan.chain_elem].astype(f32))
    ncmp = [padp(plan.chain_n[:, k]) for k in range(3)]
    kd = padp(plan.chain_kax - plan.chain_kbd) * m_c
    kb = padp(plan.chain_kbd) * m_c

    inb = ((jnp.arange(npad, dtype=jnp.int32) % width) != width - 1
           ).astype(f32)
    bslice = slice(width - 1, None, width)
    # ONE flat scatter-add for every contribution class: the per-combo
    # .at[] writes (27 banded + 36-144 jump + reg) would otherwise be
    # ~70-250 separate scatter ops
    idx_parts, val_parts = [], []
    # rows * nc + cols is formed in int32: past nc = 46340 the product
    # overflows. Unreachable for the coarse_max_dim-capped sizes
    # (~768-3072), but nothing else guards a future widening.
    assert nc <= 46340, f"coarse dim {nc} overflows int32 flat indices"

    def emit(rows, cols, vals):
        idx_parts.append((rows * nc + cols).reshape(-1))
        val_parts.append(vals.reshape(-1))

    for kc in range(3):
        for kc2 in range(3):
            k3p = ncmp[kc] * ncmp[kc2] * kd
            if kc == kc2:
                k3p = k3p + kb
            for fa in range(n_basis):
                for fb in range(n_basis):
                    v00 = wa[fa] * wa[fb] * k3p
                    v11 = wb[fa] * wb[fb] * k3p
                    v01 = -wa[fa] * wb[fb] * k3p
                    v10 = -wb[fa] * wa[fb] * k3p
                    d = v00.reshape(nbc, width).sum(1)
                    # p1p1 belongs to cluster of position i+1
                    d = d + jnp.concatenate(
                        [jnp.zeros((1,), f32), v11[:-1]]
                    ).reshape(nbc, width).sum(1)
                    d = d + ((v01 + v10) * inb).reshape(nbc,
                                                        width).sum(1)
                    rows = fa * nc3 + kc * nbc + car
                    cols = fb * nc3 + kc2 * nbc + car
                    emit(rows, cols, d)
                    emit(rows[:-1], cols[1:], v01[bslice][:-1])
                    emit(rows[1:], cols[:-1], v10[bslice][:-1])

    # jump edges, assembled as one matmul when the incidence fits: the
    # scatter form writes 36·n_basis² entries per jump — 0.5M scatter rows
    # at 340k nodes. The jump stiffness block is the PSD sum
    # kax·n nᵀ + kbd·(t1 t1ᵀ + t2 t2ᵀ) (orthonormal frame from the STATIC
    # jump direction — the naive (kax−kbd) split is indefinite because
    # kbd > kax at the reference's element slenderness), so the whole
    # jump contribution is A_jump = Xᵀ X with one coarse incidence row
    # per (jump, direction): X[j,d] has ±√coeff·w·d_kc at the two
    # endpoint clusters. One (nc, 3J)·(3J, nc) product replaces the
    # scatter. It runs at Precision.HIGHEST: on a GPU the lower settings
    # mean TF32 (10-bit mantissa) for f32 operands, and the coarse matrix
    # must match the scatter assembly to f32 roundoff.
    # GATE: X is dense (3J·n_basis, nc) — real exported meshes are
    # anastomosis-heavy (16% jump edges, where the synthetic bench meshes
    # have 4%), and at 488k jumps X would be 7.9 GB. Past the entry budget
    # the scatter assembly runs instead.
    jp = plan.ja.shape[0]
    a_jump = None
    use_matmul_jumps = jp and (3 * jp * n_basis * nc) <= COARSE_MATMUL_CAP
    if jp:
        m_j = act_pad[plan.jump_elem].astype(f32)
        ja = jnp.minimum(plan.ja, npad - 1)
        jb = jnp.minimum(plan.jb, npad - 1)
        jok = (plan.ja < n) & (plan.jb < n)
        m_j = m_j * jok.astype(f32)
        cl_a = (ja // width).astype(jnp.int32)
        cl_b = (jb // width).astype(jnp.int32)
        wja = [f_pos[ja]] + ([f_pos[ja] * ramp_pos[ja]]
                             if n_basis == 2 else [])
        wjb = [f_pos[jb]] + ([f_pos[jb] * ramp_pos[jb]]
                             if n_basis == 2 else [])
    if use_matmul_jumps:
        nvec = plan.jump_n.astype(f32)                       # (J,3) unit
        ref = jnp.where(jnp.abs(nvec[:, 2:3]) < 0.9,
                        jnp.asarray([0.0, 0.0, 1.0], f32)[None],
                        jnp.asarray([1.0, 0.0, 0.0], f32)[None])
        t1 = jnp.cross(nvec, ref)
        t1 = t1 / jnp.maximum(
            jnp.linalg.norm(t1, axis=1, keepdims=True), 1e-20)
        t2 = jnp.cross(nvec, t1)
        ar = jnp.arange(nbc, dtype=jnp.int32)
        Ca = (cl_a[:, None] == ar[None, :]).astype(f32)      # (J, nbc)
        Cb = (cl_b[:, None] == ar[None, :]).astype(f32)
        x_parts = []
        for d, c in ((nvec, plan.jump_kax * m_j),
                     (t1, plan.jump_kbd * m_j),
                     (t2, plan.jump_kbd * m_j)):
            s = jnp.sqrt(jnp.maximum(c, 0.0))
            blocks = []
            for fa in range(n_basis):
                diff = ((s * wja[fa])[:, None] * Ca
                        - (s * wjb[fa])[:, None] * Cb)       # (J, nbc)
                for kc in range(3):
                    blocks.append(d[:, kc:kc + 1] * diff)
            x_parts.append(jnp.concatenate(blocks, axis=1))  # (J, nc)
        x_inc = jnp.concatenate(x_parts, axis=0)             # (3J, nc)
        a_jump = jnp.dot(x_inc.T, x_inc, precision=lax.Precision.HIGHEST)
    elif jp:
        jn = [plan.jump_n[:, k] for k in range(3)]
        jkd = (plan.jump_kax - plan.jump_kbd) * m_j
        jkb = plan.jump_kbd * m_j
        for kc in range(3):
            for kc2 in range(3):
                k3j = jn[kc] * jn[kc2] * jkd
                if kc == kc2:
                    k3j = k3j + jkb
                for fa in range(n_basis):
                    for fb in range(n_basis):
                        ra = fa * nc3 + kc * nbc
                        rb = fb * nc3 + kc2 * nbc
                        emit(ra + cl_a, rb + cl_a,
                             wja[fa] * wja[fb] * k3j)
                        emit(ra + cl_b, rb + cl_b,
                             wjb[fa] * wjb[fb] * k3j)
                        emit(ra + cl_a, rb + cl_b,
                             -wja[fa] * wjb[fb] * k3j)
                        emit(ra + cl_b, rb + cl_a,
                             -wjb[fa] * wja[fb] * k3j)

    # reg·P per position: 2x2 basis block [1, r; r, r^2] per comp. NO
    # (I-P) identity term (see _coarse_matrix_scatter).
    dreg = np.float32(cfg.reg) * f_pos
    for fa in range(n_basis):
        for fb in range(n_basis):
            wv = (dreg * (ramp_pos ** (fa + fb))).reshape(
                nbc, width).sum(1)
            for kc in range(3):
                emit(fa * nc3 + kc * nbc + car,
                     fb * nc3 + kc * nbc + car, wv)

    flat = jnp.zeros((nc * nc,), f32).at[
        jnp.concatenate(idx_parts)].add(
        jnp.concatenate([v.astype(f32) for v in val_parts]))
    a = flat.reshape(nc, nc)
    return a + a_jump if a_jump is not None else a


def _coarse_inverse(model, plan, active, free, cfg, nb, kblk: int = 1):
    """Galerkin coarse operator for the two-level preconditioner.

    Clusters = ``kblk`` consecutive 128-position chain blocks (``kblk``
    rows of the plane layout; coarse_cluster_blocks picks the smallest
    kblk that keeps the dense dimension under cfg.coarse_max_dim — an
    uncapped inverse would be 23k-dim at 1e6 nodes). The coarse space is
    piecewise LINEAR along the
    chain per cluster per component — a constant and an in-chain ramp
    function — which captures the dominant stretching modes of long hyphae
    far better than constants alone. Coarse DOF index = f*3*NBC + k*NBC +
    cluster with f in {const, ramp}, NBC = ceil(nb/kblk); assembled from
    the free-masked operator P·K·P + reg·P, symmetrically normalized, and
    densely inverted (3·NBC is ~400 at 1e5 DOF — trivial).

    Clusters are ALWAYS defined by chain position (plan.inv_perm): every
    caller — node-space, chain-space and sharded — restricts per-cluster
    in chain order with the same kblk, and a different position array here
    would desynchronize the coarse operator from their cluster
    restriction."""
    f32 = jnp.float32
    a = _coarse_matrix_chain(model, plan, active, free, cfg, nb, kblk)
    nc = a.shape[0]
    d = jnp.diagonal(a)
    s = jnp.where(d > 0, jax.lax.rsqrt(jnp.maximum(d, 1e-30)), 1.0)
    an = s[:, None] * a * s[None, :] \
        + np.float32(1e-5) * jnp.eye(nc, dtype=f32) \
        + jnp.diag(jnp.where(d > 0, 0.0, 1.0).astype(f32))
    ainv_n = jnp.linalg.inv(an)
    return s[:, None] * ainv_n * s[None, :]

