"""FEA model: static mesh data, grip masks, and the sparse operator layouts.

Replaces the reference's per-step global assembly (reference component C16,
src/fea_solver.py:74-106: a Python COO triple loop rebuilt every ramp step —
9.1 s of its 39.5 s profile) with data prepared ONCE per mesh:

- factored element geometry (see elements.py),
- an ELL-style node→incident-element table so K·u is gather-only
  (scatter-adds with duplicate indices need atomics; gathers do not),
- grip masks (reference C17 grip selection: |y − y_extreme| < GRIP_LENGTH,
  src/fea_solver.py:207-211).

Per-step "assembly" then degenerates to masking fractured elements — the
sparsity pattern and all index maps are static for the whole ramp, which is
what lets XLA compile one program for all 40 steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..config import FeaConfig
from .elements import ElementGeometry


class FeaModel(NamedTuple):
    coords: jnp.ndarray        # (N, 3)
    conn: jnp.ndarray          # (E, 2) int32
    geom: ElementGeometry
    # ELL gather layout: for node i, incident[i, d] is an element index whose
    # force contributes to i with sign[i, d] (+1 if i is n1, -1 if n2);
    # padding entries point at the sentinel row E (zero force) with sign 0.
    incident: jnp.ndarray      # (N, deg_max) int32
    sign: jnp.ndarray          # (N, deg_max) dtype
    neighbor: jnp.ndarray      # (N, deg_max) int32 — other endpoint of
                               # incident[i, d]; padding points at sentinel N
    top_nodes: jnp.ndarray     # (N,) bool — grip masks
    bot_nodes: jnp.ndarray     # (N,) bool
    free_nodes: jnp.ndarray    # (N,) bool  (~top & ~bot)
    chain: object = None       # Optional[chain.ChainPlan] — the
                               # gather-free SpMV layout (cfg.operator='chain')
    tree: object = None        # Optional[tree_jax.TreePlan] — spanning-
                               # forest elimination schedule
                               # (cfg.precond='tree')
    tree_fast: object = None    # Optional[tree_jax.FastFactorData] —
                                # static tables for the gather-free
                                # factorization (unified ordering only)

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.conn.shape[0]

    @property
    def n_dof(self) -> int:
        return 3 * self.coords.shape[0]


def _build_incidence(conn: np.ndarray, n_nodes: int):
    """Host-side ELL table build (static per mesh)."""
    n_elems = conn.shape[0]
    deg = np.zeros(n_nodes, dtype=np.int64)
    np.add.at(deg, conn[:, 0], 1)
    np.add.at(deg, conn[:, 1], 1)
    deg_max = max(int(deg.max()) if n_nodes else 0, 1)
    incident = np.full((n_nodes, deg_max), n_elems, dtype=np.int32)
    sign = np.zeros((n_nodes, deg_max), dtype=np.float64)
    neighbor = np.full((n_nodes, deg_max), n_nodes, dtype=np.int32)
    # vectorized fill: each element contributes one (node, slot) entry per
    # endpoint; slots are assigned by stable-sorting endpoints by node id
    ends = np.concatenate([conn[:, 0], conn[:, 1]]).astype(np.int64)
    elem = np.concatenate([np.arange(n_elems), np.arange(n_elems)])
    sgn = np.concatenate([np.ones(n_elems), -np.ones(n_elems)])
    other = np.concatenate([conn[:, 1], conn[:, 0]]).astype(np.int64)
    order = np.argsort(ends, kind="stable")
    sorted_nodes = ends[order]
    offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(ends, minlength=n_nodes))
    slot = np.arange(2 * n_elems) - offsets[sorted_nodes]
    incident[sorted_nodes, slot] = elem[order]
    sign[sorted_nodes, slot] = sgn[order]
    neighbor[sorted_nodes, slot] = other[order]
    return incident, sign, neighbor


def _unified_order(schedule, n_nodes: int) -> np.ndarray:
    """Node ordering for the unified tree/chain layout: tree-schedule slots
    first (level by level, path by path — so slot s sits at chain position
    s), then the remaining (gripped) nodes along a greedy path cover of
    their induced subgraph (keeps grip-grip edges as cheap shift edges).
    """
    from .chain import greedy_path_cover
    slots = (np.concatenate([lv.slots for lv in schedule.levels])
             if schedule.levels else np.zeros((0,), np.int64)).astype(np.int64)
    in_slot = np.zeros(n_nodes, bool)
    in_slot[slots] = True
    rest = np.nonzero(~in_slot)[0]
    if len(rest):
        remap = np.full(n_nodes, -1, np.int64)
        remap[rest] = np.arange(len(rest))
        conn = np.asarray(schedule.conn, np.int64)
        gg = conn[~in_slot[conn[:, 0]] & ~in_slot[conn[:, 1]]]
        if len(gg):
            sub_perm = greedy_path_cover(remap[gg].astype(np.int32),
                                         len(rest))
            rest = rest[sub_perm]
    return np.concatenate([slots, rest])


def build_model(coords: np.ndarray, conn: np.ndarray,
                cfg: FeaConfig) -> FeaModel:
    """Prepare all static solve data for a mesh.

    Grip selection (reference src/fea_solver.py:207-211): nodes within
    cfg.grip_length of y_max are the top grip, within grip_length of y_min
    the bottom grip. When a node qualifies for both, bottom wins — the
    reference builds its BC dict top-first so bottom entries overwrite
    (src/fea_solver.py:229-242).
    """
    coords = np.asarray(coords, dtype=np.float64)
    conn_np = np.asarray(conn, dtype=np.int32).reshape(-1, 2)
    dtype = jnp.dtype(cfg.dtype)

    y = coords[:, 1]
    y_min, y_max = float(y.min()), float(y.max())
    top = np.abs(y - y_max) < cfg.grip_length
    bot = np.abs(y - y_min) < cfg.grip_length
    top = top & ~bot  # bottom precedence on overlap
    free = ~(top | bot)

    incident, sign, neighbor = _build_incidence(conn_np, coords.shape[0])

    # factored element data, once in f64 host numpy (eager jnp here would
    # trigger one small XLA compile per op; the arrays only cross to the
    # device at the end)
    d = coords[conn_np[:, 1]] - coords[conn_np[:, 0]]
    length = np.linalg.norm(d, axis=1)
    l_safe = np.maximum(length, 1e-12)
    n_host = d / l_safe[:, None]
    k_ax_host = (cfg.e_mod * cfg.area) / l_safe
    k_bd_host = 12.0 * cfg.e_mod * cfg.moi / (l_safe ** 3)

    n_nodes = coords.shape[0]
    schedule = None
    unified_perm = None
    if cfg.precond == "tree":
        from .tree import build_tree_schedule
        schedule = build_tree_schedule(
            conn_np, n_nodes, free,
            max_path_len=cfg.tree_max_path_len)
        if cfg.operator == "chain":
            unified_perm = _unified_order(schedule, n_nodes)

    chain_plan = None
    chain_host: dict = {}
    if cfg.operator == "chain":
        from .chain import build_chain_plan
        # unified layout: chain positions = tree slot order, so the tree
        # PC's slot space is a prefix slice of chain space (no
        # slot<->chain permutation gathers per CG iteration)
        chain_plan = build_chain_plan(coords, conn_np, n_host, k_ax_host,
                                      k_bd_host, dtype, host_out=chain_host,
                                      perm=unified_perm)

    tree_plan = None
    tree_fast = None
    if cfg.precond == "tree":
        from .tree import KIND_ELEM, KIND_FILL, element_k3
        from .tree_jax import FastFactorData, FastMeta, build_tree_plan
        k3 = element_k3(n_host, k_ax_host, k_bd_host)
        tree_plan = build_tree_plan(schedule, k3, dtype,
                                    dense_tail=cfg.tree_dense_tail)
        if unified_perm is not None and schedule.levels:
            # static tables for the gather-free factorization: everything
            # index-shaped is resolved here on the host, once per mesh, so
            # the per-solve factor needs no (S,)-row f32 gathers/scatters
            tree_pad = np.concatenate([np.asarray(schedule.tree_edge),
                                       np.zeros(1, bool)])
            lk = np.concatenate([lv.left_kind for lv in schedule.levels])
            lid = np.concatenate([lv.left_id for lv in schedule.levels])
            left_k3 = np.zeros((len(lk), 3, 3))
            is_le = lk == KIND_ELEM
            left_k3[is_le] = k3[lid[is_le]]
            # unified-order invariant check (host, once per mesh): the
            # left edge of slot s is chain edge s-1 for every KIND_ELEM
            # slot — lets the factor derive the left-edge active mask
            # from the plan-order chain mask by a shift (no S-row gather)
            ce_h = np.asarray(chain_host["chain_elem"])
            ile = np.nonzero(is_le)[0]
            # intended fallback for any slot<->chain-position violation is
            # shift_ok=False, so bound-check BOTH ends before indexing
            # (an out-of-range slot would otherwise IndexError the build)
            shift_ok = bool(
                len(ile) == 0
                or (ile[0] > 0 and ile[-1] - 1 < len(ce_h)
                    and np.array_equal(lid[ile], ce_h[ile - 1])))
            tree_fast = FastFactorData(
                chain_tree=jnp.asarray(
                    tree_pad[chain_host["chain_elem"]]),
                jump_tree=jnp.asarray(tree_pad[chain_host["jump_elem"]]),
                left_k3=jnp.asarray(np.asarray(
                    left_k3.transpose(1, 2, 0).reshape(9, -1),
                    np.dtype(dtype))),
                ja=jnp.asarray(np.asarray(chain_host["ja"], np.int32)),
                jb=jnp.asarray(np.asarray(chain_host["jb"], np.int32)),
                meta=FastMeta(level_left_fill=tuple(
                    bool(np.any(lv.left_kind == KIND_FILL))
                    for lv in schedule.levels),
                    left_is_chain_shift=shift_ok),
            )

    coords_j = jnp.asarray(coords, dtype=dtype)
    conn_j = jnp.asarray(conn_np)
    geom = ElementGeometry(
        n=jnp.asarray(n_host, dtype=dtype),
        length=jnp.asarray(length, dtype=dtype),
        k_ax=jnp.asarray(k_ax_host, dtype=dtype),
        k_bd=jnp.asarray(k_bd_host, dtype=dtype))
    return FeaModel(
        coords=coords_j,
        conn=conn_j,
        geom=geom,
        incident=jnp.asarray(incident),
        sign=jnp.asarray(sign, dtype=dtype),
        neighbor=jnp.asarray(neighbor),
        top_nodes=jnp.asarray(top),
        bot_nodes=jnp.asarray(bot),
        free_nodes=jnp.asarray(free),
        chain=chain_plan,
        tree=tree_plan,
        tree_fast=tree_fast,
    )


def apply_stiffness(model: FeaModel, u_nodes: jnp.ndarray,
                    active: jnp.ndarray,
                    operator: str = "ell") -> jnp.ndarray:
    """Matrix-free K·u on node-major displacement (N,3) -> force (N,3).

    This is the rebuild's SpMV: the JAX replacement for PETSc MatMult
    (reference src/fea_petsc.cpp:360-363). 'ell' computes per-element end
    forces then reduces them with the gather-only incidence table; 'scatter'
    uses segment-style scatter-add (kept for cross-checking).
    """
    from .elements import element_forces
    f = element_forces(u_nodes, model.conn, model.geom, active)   # (E,3)
    if operator == "scatter":
        out = jnp.zeros_like(u_nodes)
        out = out.at[model.conn[:, 0]].add(f)
        out = out.at[model.conn[:, 1]].add(-f)
        return out
    # ELL gather: pad a zero sentinel row, then reduce over incident slots
    f_pad = jnp.concatenate([f, jnp.zeros((1, 3), dtype=f.dtype)], axis=0)
    gathered = f_pad[model.incident]                  # (N, deg_max, 3)
    return jnp.sum(model.sign[:, :, None] * gathered, axis=1)


def diag_blocks(model: FeaModel, active: jnp.ndarray,
                cfg: FeaConfig,
                free_nodes: jnp.ndarray | None = None) -> jnp.ndarray:
    """Per-node 3x3 diagonal blocks of the BC'd operator.

    Free nodes get their stiffness diagonal block + reg·I; grip nodes are
    identity (the BC'd operator acts as identity there). Used by the
    block-Jacobi preconditioner — the JAX stand-in for PETSc's
    ICC/BJACOBI setups (reference src/fea_petsc.cpp:336-339).
    """
    n = model.geom.n
    nnT = n[:, :, None] * n[:, None, :]
    eye = jnp.eye(3, dtype=n.dtype)
    blk = (model.geom.k_ax[:, None, None] * nnT
           + model.geom.k_bd[:, None, None] * (eye - nnT))
    blk = blk * active[:, None, None].astype(blk.dtype)
    out = jnp.zeros((model.n_nodes, 3, 3), dtype=blk.dtype)
    out = out.at[model.conn[:, 0]].add(blk)
    out = out.at[model.conn[:, 1]].add(blk)
    out = out + jnp.asarray(cfg.reg, blk.dtype) * eye
    free = (model.free_nodes if free_nodes is None else free_nodes)
    return jnp.where(free[:, None, None], out, eye)


def invert_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    """Batched scale-stabilized 3x3 adjugate inverse (vmap-free, fused)."""
    scale = jnp.max(jnp.abs(blocks), axis=(1, 2), keepdims=True)
    scale = jnp.maximum(scale, jnp.asarray(1e-300 if blocks.dtype ==
                                           jnp.float64 else 1e-30,
                                           blocks.dtype))
    b = blocks / scale
    a00, a01, a02 = b[:, 0, 0], b[:, 0, 1], b[:, 0, 2]
    a10, a11, a12 = b[:, 1, 0], b[:, 1, 1], b[:, 1, 2]
    a20, a21, a22 = b[:, 2, 0], b[:, 2, 1], b[:, 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    adj = jnp.stack([
        jnp.stack([c00, c01, c02], axis=-1),
        jnp.stack([c10, c11, c12], axis=-1),
        jnp.stack([c20, c21, c22], axis=-1),
    ], axis=1)
    return adj / (det[:, None, None] * scale)
