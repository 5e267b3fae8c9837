"""Device (JAX) implementation of the spanning-forest preconditioner.

Everything here consumes the static schedule built by tree.build_tree_schedule
(host, once per mesh) converted to a device pytree (TreePlan): all levels'
slots concatenated into ONE global slot space so inter-level Schur flows are
single scatters, and each level's block-tridiagonal solves run as parallel
cyclic reduction (PCR) — log2(max path length) rounds of shifted 3x3 block
products, no sequential recurrences, no data-dependent shapes.

  factor (once per solve): tree_factor(plan, k3, active, free, reg)
      -> TreeFactor pytree (PCR coefficients + attachment couplings)
  apply (per CG iteration): tree_apply(plan, factor, r)
      -> z = K_tree^{-1} r   (pinned rows pass through)

The oracle for both is the numpy implementation in tree.py (tests compare
them element-wise). See tree.py's module docstring for why this exists:
the forest solve takes CG on the archived mesh from 872 iterations to 9.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .tree import KIND_ELEM, KIND_FILL, KIND_NONE, TreeSchedule


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class TreeMeta:
    """Static shape info (hashable; part of the jit cache key)."""
    level_offsets: tuple        # slot-space offset per level, + total
    path_offsets: tuple         # path-space offset per level, + total
    level_steps: tuple          # PCR rounds per level
    k_scale: float = 1.0        # median element stiffness (reg floor ref)
    n_pcr: int = -1             # levels eliminated by PCR; the remaining
                                # (tiny) levels' slots are solved as ONE
                                # dense junction-Schur inverse. -1 = all
                                # levels PCR (no dense tail).


def n_pcr_levels(meta: TreeMeta) -> int:
    return len(meta.level_steps) if meta.n_pcr < 0 else meta.n_pcr


def pcr_split(sizes, dense_tail: int) -> int:
    """Number of leading levels kept on PCR: the trailing levels whose
    combined slot count fits ``dense_tail`` are folded into the dense
    junction solve. Their per-level shapes are tiny (9/2-slot at 103k
    nodes), and each level adds an unrolled PCR op chain to the compiled
    factorization, whose compile time grows superlinearly with the level
    count."""
    if dense_tail <= 0:
        return len(sizes)
    suffix = 0
    k = len(sizes)
    while k > 0 and suffix + sizes[k - 1] <= dense_tail:
        suffix += sizes[k - 1]
        k -= 1
    return k


class TreePlan(NamedTuple):
    """Device form of the static schedule. Slot/path arrays of ALL levels
    are concatenated; meta.level_offsets/path_offsets delimit them."""
    meta: TreeMeta
    tree_edge: jnp.ndarray    # (E,) bool — spanning-forest membership
    k3: jnp.ndarray           # (E,3,3) element coupling stiffnesses
    slots: jnp.ndarray        # (S,) int32 node id per global slot
    # left-edge (slot i-1 -- slot i) source; sentinels: elem=E, fill=P
    left_elem: jnp.ndarray    # (S,) int32
    left_fill: jnp.ndarray    # (S,) int32 fill id == producing path index
    left_fill_flip: jnp.ndarray  # (S,) bool
    first_gpos: jnp.ndarray   # (P,) int32 global slot index of path start
    last_gpos: jnp.ndarray    # (P,) int32
    att_elem: jnp.ndarray     # (P, 2) int32 (sentinel E)
    att_fill: jnp.ndarray     # (P, 2) int32 (sentinel P)
    att_flip: jnp.ndarray     # (P, 2) bool
    att_tgt: jnp.ndarray      # (P, 2) int32 global slot of junction
                              # (sentinel S when no attachment)
    has_fill: jnp.ndarray     # (P,) bool — path produces a fill edge
    # dense-tail assembly tables: tree-element edges whose BOTH endpoint
    # slots live in the tail levels (slot >= level_offsets[n_pcr]),
    # as (element id, local tail row i, local tail row j)
    dense_eid: jnp.ndarray = None   # (Ed,) int32
    dense_i: jnp.ndarray = None     # (Ed,) int32
    dense_j: jnp.ndarray = None     # (Ed,) int32

    @property
    def n_slots(self) -> int:
        return self.slots.shape[0]

    @property
    def n_paths(self) -> int:
        return self.first_gpos.shape[0]


class TreeFactor(NamedTuple):
    """Per-solve numeric factorization (pytree of device arrays).

    PCR coefficients cover only the first meta.n_pcr levels; the tail
    levels' slots are solved through ``sinv``, the dense inverse of their
    junction-Schur system. Block batches are stored as row-major
    COMPONENT PLANES — (…, 9, S) instead of (…, S, 3, 3) — so the apply's
    elementwise math runs on untiled 1-D buffers (see the plane-algebra
    section above)."""
    # PCR coefficients, one (steps, 9, S_l) pair per PCR level
    alphas: tuple
    betas: tuple
    dinv: jnp.ndarray         # (9, S_pcr) final decoupled block inverses
    att_b: jnp.ndarray        # (P_pcr, 2, 3, 3) attachment couplings B[j,s]
    sinv: jnp.ndarray = None  # (3*Sd, 3*Sd) dense tail inverse (None when
                              # the tail is empty)
    coarse_ainv: jnp.ndarray = None  # optional cached cluster-coarse dense
                              # inverse (solve._coarse_chain_fn): it shares
                              # the factor's (active, free) invariants, so
                              # compute_tree_factor attaches it and ramp
                              # drivers amortize it like the PCR factor


def build_tree_plan(schedule: TreeSchedule, k3: np.ndarray,
                    dtype, dense_tail: int = 0) -> TreePlan:
    """Convert the host schedule (+ element couplings) to the device
    layout. ``dense_tail`` > 0 folds the trailing levels whose combined
    slot count fits it into one dense junction solve (see pcr_split)."""
    lv_off, pa_off = [0], [0]
    steps = []
    slots, le, lf, lff = [], [], [], []
    fgp, lgp = [], []
    a_e, a_f, a_fl, a_tg = [], [], [], []
    hasf = []
    E = len(schedule.conn)

    # fill id == global producing-path index; build the map first
    fill_to_path = {}
    p_base = 0
    for lv in schedule.levels:
        for p, f in enumerate(lv.fill_out):
            if f >= 0:
                fill_to_path[int(f)] = p_base + p
        p_base += len(lv.first_pos)
    P_tot = p_base

    s_base = 0
    p_base = 0
    lv_starts = []
    for lv in schedule.levels:
        lv_starts.append(s_base)
        s_base += len(lv.slots)
        p_base += len(lv.first_pos)
    S_tot = s_base

    s_base = p_base = 0
    for lv in schedule.levels:
        S = len(lv.slots)
        P = len(lv.first_pos)
        slots.append(lv.slots)
        is_e = lv.left_kind == KIND_ELEM
        is_f = lv.left_kind == KIND_FILL
        le.append(np.where(is_e, lv.left_id, E).astype(np.int32))
        lf.append(np.where(
            is_f, [fill_to_path.get(int(i), P_tot) for i in lv.left_id],
            P_tot).astype(np.int32))
        lff.append(lv.left_flip & is_f)
        fgp.append(lv.first_pos.astype(np.int64) + s_base)
        lgp.append(lv.last_pos.astype(np.int64) + s_base)
        ae = np.where(lv.att_kind == KIND_ELEM, lv.att_id, E)
        af = np.where(
            lv.att_kind == KIND_FILL,
            np.vectorize(lambda i: fill_to_path.get(int(i), P_tot))(
                lv.att_id) if lv.att_id.size else lv.att_id,
            P_tot)
        a_e.append(ae.astype(np.int32))
        a_f.append(af.astype(np.int32))
        a_fl.append(lv.att_flip)
        tg = np.where(lv.att_kind == KIND_NONE, S_tot,
                      np.asarray([[lv_starts[l] for l in row]
                                  for row in lv.att_level])
                      + lv.att_pos)
        a_tg.append(tg.astype(np.int32))
        hasf.append(lv.fill_out >= 0)
        # PCR rounds: enough for the longest path at this level
        lens = lv.last_pos - lv.first_pos + 1
        maxlen = int(lens.max()) if len(lens) else 1
        steps.append(max(int(np.ceil(np.log2(max(maxlen, 1)))), 0))
        lv_off.append(lv_off[-1] + S)
        pa_off.append(pa_off[-1] + P)
        s_base += S

    cat = lambda xs, dt: jnp.asarray(  # noqa: E731
        np.concatenate(xs).astype(dt, copy=False))

    k3_np = np.asarray(k3)
    k_scale = (float(np.median(np.trace(k3_np, axis1=1, axis2=2) / 3.0))
               if len(k3_np) else 1.0)

    if not schedule.levels:   # fully gripped scene: nothing to eliminate
        z1 = jnp.zeros((0,), jnp.int32)
        z2 = jnp.zeros((0, 2), jnp.int32)
        return TreePlan(
            meta=TreeMeta(level_offsets=(0,), path_offsets=(0,),
                          level_steps=(), k_scale=k_scale, n_pcr=0),
            tree_edge=jnp.asarray(schedule.tree_edge),
            k3=jnp.asarray(np.asarray(k3, dtype)),
            slots=z1, left_elem=z1, left_fill=z1,
            left_fill_flip=jnp.zeros((0,), bool),
            first_gpos=z1, last_gpos=z1,
            att_elem=z2, att_fill=z2,
            att_flip=jnp.zeros((0, 2), bool), att_tgt=z2,
            has_fill=jnp.zeros((0,), bool),
            dense_eid=z1, dense_i=z1, dense_j=z1)

    sizes = [lv_off[i + 1] - lv_off[i] for i in range(len(lv_off) - 1)]
    n_pcr = pcr_split(sizes, dense_tail)
    t0 = lv_off[n_pcr]
    slots_cat = np.concatenate(slots).astype(np.int64)
    node_to_slot = np.full(len(schedule.free), -1, np.int64)
    node_to_slot[slots_cat] = np.arange(len(slots_cat))
    conn_np = np.asarray(schedule.conn, np.int64)
    te = np.nonzero(schedule.tree_edge)[0]
    sa = node_to_slot[conn_np[te, 0]]
    sb = node_to_slot[conn_np[te, 1]]
    both = (sa >= t0) & (sb >= t0)
    return TreePlan(
        meta=TreeMeta(level_offsets=tuple(lv_off),
                      path_offsets=tuple(pa_off),
                      level_steps=tuple(steps), k_scale=k_scale,
                      n_pcr=n_pcr),
        tree_edge=jnp.asarray(schedule.tree_edge),
        k3=jnp.asarray(np.asarray(k3, dtype)),
        slots=cat(slots, jnp.int32),
        left_elem=cat(le, jnp.int32),
        left_fill=cat(lf, jnp.int32),
        left_fill_flip=cat(lff, bool),
        first_gpos=cat(fgp, jnp.int32),
        last_gpos=cat(lgp, jnp.int32),
        att_elem=cat(a_e, jnp.int32),
        att_fill=cat(a_f, jnp.int32),
        att_flip=cat(a_fl, bool),
        att_tgt=cat(a_tg, jnp.int32),
        has_fill=cat(hasf, bool),
        dense_eid=jnp.asarray(te[both].astype(np.int32)),
        dense_i=jnp.asarray((sa[both] - t0).astype(np.int32)),
        dense_j=jnp.asarray((sb[both] - t0).astype(np.int32)),
    )


HI = jax.lax.Precision.HIGHEST   # for f32 operands a GPU runs the
                                  # DEFAULT and HIGH precisions as TF32
                                  # (10-bit mantissa); the dense-tail
                                  # matvec needs full f32 products

# component-unrolled block algebra (see blocks.py: elementwise
# multiply-adds on component planes instead of 3x3 dot_generals)
from .blocks import mm3 as _mm, mtv3 as _mtv3, mv3 as _mv3  # noqa: E402


# ---------------------------------------------------------------------------
# component-plane block algebra
#
# blocks.py removed the einsum dot_generals but its DATA still lives in
# (S,3,3) arrays with minor (3,3) dims. Here a 3x3 block batch is a tuple
# of 9 (S,)/(S,K) planes in row-major component order
# (00,01,02,10,...,22) and a 3-vector batch a tuple of 3 planes: every op
# is plain elementwise math on contiguous 1-D buffers and every shift is
# a 1-D roll. TreeFactor stores the stacked (steps, 9, S) form.
# ---------------------------------------------------------------------------

def _p_t(m):
    """Plane-tuple transpose."""
    return (m[0], m[3], m[6], m[1], m[4], m[7], m[2], m[5], m[8])


def _p_sh(m, k):
    """Plane-tuple shift: y[i] = x[i+k] (rolling, like _shift)."""
    return tuple(jnp.roll(p, -k, axis=0) for p in m)


def _p_mm(a, b):
    """(tuple9, tuple9) -> tuple9 block product."""
    return tuple(a[3 * i] * b[k] + a[3 * i + 1] * b[3 + k]
                 + a[3 * i + 2] * b[6 + k]
                 for i in range(3) for k in range(3))


def _p_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _p_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _p_neg(a):
    return tuple(-x for x in a)


def _p_inv(m):
    """Plane-tuple 3x3 adjugate inverse (same math as _inv3)."""
    a, b, c, d, e, f, g, h, i = m
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(det != 0, det, 1.0)
    return (A / det, -(b * i - c * h) / det, (b * f - c * e) / det,
            B / det, (a * i - c * g) / det, -(a * f - c * d) / det,
            C / det, -(a * h - b * g) / det, (a * e - b * d) / det)


def _p_bc(m, v):
    """Coefficient plane broadcast against a possibly-(S,K) vector plane."""
    return m[:, None] if v.ndim == 2 else m


def _p_mv(m, v):
    """tuple9 x tuple3 -> tuple3 (planes may be (S,) or (S,K))."""
    return tuple(_p_bc(m[3 * i], v[0]) * v[0]
                 + _p_bc(m[3 * i + 1], v[1]) * v[1]
                 + _p_bc(m[3 * i + 2], v[2]) * v[2] for i in range(3))


def _p_mtv(m, v):
    """tuple9^T x tuple3 -> tuple3."""
    return tuple(_p_bc(m[i], v[0]) * v[0]
                 + _p_bc(m[3 + i], v[1]) * v[1]
                 + _p_bc(m[6 + i], v[2]) * v[2] for i in range(3))


def _p_vsh(v, k):
    return tuple(jnp.roll(p, -k, axis=0) for p in v)


def _split9(m):
    """(S,3,3) -> tuple9 of (S,) planes (boundary conversion only)."""
    return tuple(m[:, i, j] for i in range(3) for j in range(3))


def _pcr_coeffs(D, B, steps):
    """PCR coefficient recurrence on a block tridiagonal with row i
    couplings L_i = B[i]^T (to i-1) and R_i = B[i+1] (to i+1).

    D, B: tuple9 of (S,) planes. Returns (alphas, betas) stacked over
    rounds as (steps, 9, S) arrays and the final block inverses as a
    tuple9."""
    L = _p_t(B)
    R = _p_sh(B, 1)
    alphas, betas = [], []
    s = 1
    for _ in range(steps):
        dinv = _p_inv(D)
        a = _p_mm(L, _p_sh(dinv, -s))
        b = _p_mm(R, _p_sh(dinv, s))
        D = _p_sub(D, _p_add(_p_mm(a, _p_sh(R, -s)),
                             _p_mm(b, _p_sh(L, s))))
        L = _p_neg(_p_mm(a, _p_sh(L, -s)))
        R = _p_neg(_p_mm(b, _p_sh(R, s)))
        alphas.append(jnp.stack(a))
        betas.append(jnp.stack(b))
        s *= 2
    n = D[0].shape[0]
    z = jnp.zeros((0, 9, n), D[0].dtype)
    al = jnp.stack(alphas) if alphas else z
    be = jnp.stack(betas) if betas else z
    return al, be, _p_inv(D)


def _pcr_apply(alphas, betas, dinv, r):
    """x = T^{-1} r given plane PCR coefficients.

    alphas/betas: (steps, 9, S); dinv: tuple9 (or (9, S) array slice);
    r: tuple3 of (S,) or (S, K) planes -> same."""
    steps = alphas.shape[0]
    s = 1
    for k in range(steps):
        a = tuple(alphas[k, c] for c in range(9))
        b = tuple(betas[k, c] for c in range(9))
        r = _p_sub(r, _p_add(_p_mv(a, _p_vsh(r, -s)),
                             _p_mv(b, _p_vsh(r, s))))
        s *= 2
    d = tuple(dinv[c] for c in range(9)) if not isinstance(dinv, tuple) \
        else dinv
    return _p_mv(d, r)


def _dense_tail_factor(plan: TreePlan, D_tail, dacc_tail, ke, fill_B):
    """Dense inverse of the tail levels' junction-Schur system.

    After the PCR levels eliminated slots [0, t0), the remaining system on
    the tail slots is: their (BC'd, reg'd) tree diagonal + the Schur diag
    corrections accumulated by PCR paths (``dacc_tail``) + tree-element
    couplings between tail slots (static ``dense_*`` tables) + fill
    couplings produced by PCR paths whose BOTH junctions are tail slots.
    SPD by construction, <= tree_dense_tail blocks — one inverse per
    factorization, one dense matvec per apply.

    D_tail/dacc_tail: tuple9 of (Sd,) planes. fill_B: (P+1, 9) row-major
    component rows. The system is assembled DIRECTLY in the flat
    (3Sd, 3Sd) layout with per-component scatters instead of being staged
    as (Sd, Sd, 3, 3) and reshaped."""
    meta = plan.meta
    S_tot = plan.n_slots
    t0 = meta.level_offsets[n_pcr_levels(meta)]
    Sd = S_tot - t0
    dtype = D_tail[0].dtype
    M = jnp.zeros((3 * Sd, 3 * Sd), dtype)
    ar = jnp.arange(Sd, dtype=jnp.int32)
    # ke: (Ed,3,3) couplings at the dense-tail element ids — tiny
    p_pcr = meta.path_offsets[n_pcr_levels(meta)]
    if p_pcr:
        tgt = plan.att_tgt[:p_pcr]
        both = (plan.has_fill[:p_pcr]
                & (tgt[:, 0] >= t0) & (tgt[:, 0] < S_tot)
                & (tgt[:, 1] >= t0) & (tgt[:, 1] < S_tot))
        fb = (fill_B[:p_pcr].reshape(-1, 3, 3)
              * both[:, None, None])
        ti = jnp.clip(tgt[:, 0] - t0, 0, Sd - 1)
        tj = jnp.clip(tgt[:, 1] - t0, 0, Sd - 1)
    for a in range(3):
        for b in range(3):
            M = M.at[3 * ar + a, 3 * ar + b].add(
                D_tail[3 * a + b] + dacc_tail[3 * a + b])
            M = M.at[3 * plan.dense_i + a,
                     3 * plan.dense_j + b].add(ke[:, a, b])
            M = M.at[3 * plan.dense_j + a,
                     3 * plan.dense_i + b].add(ke[:, b, a])
            if p_pcr:
                M = M.at[3 * ti + a, 3 * tj + b].add(fb[:, a, b])
                M = M.at[3 * tj + a, 3 * ti + b].add(fb[:, b, a])
    return jnp.linalg.inv(M)


def _dense_tail_apply(factor: TreeFactor, r_tail):
    """u_tail = Sinv · r_tail, (Sd, 3) -> (Sd, 3)."""
    u = jnp.einsum("ij,j->i", factor.sinv, r_tail.reshape(-1),
                   precision=HI)
    return u.reshape(r_tail.shape)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class FastMeta:
    """Static flags of the fast factorization (hashable jit-cache key)."""
    level_left_fill: tuple    # per level: has KIND_FILL left edges
    left_is_chain_shift: bool = False   # host-verified: the left edge of
                              # slot s is chain edge s-1 for every
                              # KIND_ELEM slot (unified order), so the
                              # left-edge active gather is a shift of the
                              # plan-order chain mask


class FastFactorData(NamedTuple):
    """Static (per-mesh) tables for the gather-free factorization under the
    UNIFIED chain==slot ordering (model._unified_order).

    With chain position s == slot s, the diagonal assembles from chain
    SHIFTS plus a tiny jump scatter, the left-edge couplings come from a
    static table masked by bool gathers, and slot extraction is a slice.
    """
    chain_tree: jnp.ndarray   # (N,) bool — chain slot's element in forest
    jump_tree: jnp.ndarray    # (Jp,) bool
    left_k3: jnp.ndarray      # (9,S) static left-edge element k3 as
                              # row-major component planes (zero for
                              # KIND_FILL / KIND_NONE rows)
    ja: jnp.ndarray           # (Jp,) int32 jump endpoint chain positions
    jb: jnp.ndarray           # (Jp,) int32 (sentinel N for padding rows)
    meta: FastMeta            # static flags


def chain_tree_diag(plan: TreePlan, fast: FastFactorData, cplan,
                    active: jnp.ndarray, free_chain: jnp.ndarray,
                    reg, chain_act_b=None, jump_act_b=None) -> jnp.ndarray:
    """(9, N) component planes of the tree-PC diagonal in CHAIN order,
    scatter/gather-free up to bool gathers and a 2J-row jump scatter.
    Rows >= n_slots (grips) and anchored-pinned rows are identity.

    ``chain_act_b``/``jump_act_b`` optionally inject the bool plan-order
    active masks (chain.plan_active_masks_bool) so callers that already
    gathered them don't pay the N-row bool gather twice."""
    dtype = plan.k3.dtype
    zero1 = jnp.zeros((1,), dtype)
    if chain_act_b is None or jump_act_b is None:
        act_pad = jnp.concatenate([active.astype(bool),
                                   jnp.zeros((1,), bool)])
        chain_act_b = act_pad[cplan.chain_elem]
        jump_act_b = act_pad[cplan.jump_elem]
    m_c = (chain_act_b & fast.chain_tree).astype(dtype)
    nc = [cplan.chain_n[:, k] for k in range(3)]
    kd_c = (cplan.chain_kax - cplan.chain_kbd) * m_c
    kb_c = cplan.chain_kbd * m_c
    m_j = (jump_act_b & fast.jump_tree).astype(dtype)
    njp = [cplan.jump_n[:, k] for k in range(3)]
    kd_j = (cplan.jump_kax - cplan.jump_kbd) * m_j
    kb_j = cplan.jump_kbd * m_j
    regp = jnp.asarray(reg, dtype)
    # jump edges: ONE batched (9, 2J) scatter over all 9 planes x both
    # endpoints instead of 18 per-plane scatters
    n_chain = free_chain.shape[0]
    kj = []
    for i in range(3):
        for j in range(3):
            k3j = njp[i] * njp[j] * kd_j
            if i == j:
                k3j = k3j + kb_j
            kj.append(k3j)
    kj = jnp.stack(kj)                                   # (9, J)
    jidx = jnp.concatenate([fast.ja, fast.jb])
    jump = (jnp.zeros((9, n_chain), dtype)
            .at[:, jidx].add(jnp.concatenate([kj, kj], axis=1),
                             mode="drop"))
    planes = []
    for i in range(3):
        for j in range(3):
            # (kax-kbd) n n^T + kbd I — same association as
            # tree.element_k3 so the fast factor tracks the generic one
            # to fp roundoff
            k3c = nc[i] * nc[j] * kd_c
            if i == j:
                k3c = k3c + kb_c
            # chain edge i connects positions i and i+1: both ends get it
            p = k3c + jnp.concatenate([zero1, k3c[:-1]])
            p = p + jump[3 * i + j]
            if i == j:
                p = p + regp
                p = jnp.where(free_chain, p, 1.0)
            else:
                p = jnp.where(free_chain, p, 0.0)
            planes.append(p)
    return jnp.stack(planes)


def tree_factor_fast(plan: TreePlan, fast: FastFactorData, cplan,
                     active: jnp.ndarray, free_now: jnp.ndarray,
                     free_chain: jnp.ndarray, reg,
                     conn: jnp.ndarray,
                     chain_act_b=None, jump_act_b=None) -> TreeFactor:
    """tree_factor without N/S-row f32 gathers or scatters (unified
    ordering only). Numerically identical to tree_factor — tested
    elementwise against it. All big-axis block algebra runs on (S,)
    component planes (see the plane-algebra section above)."""
    meta = plan.meta
    k3 = plan.k3
    S_tot = plan.n_slots
    P_tot = plan.n_paths
    dtype = k3.dtype

    D_g = chain_tree_diag(plan, fast, cplan, active, free_chain,
                          reg, chain_act_b, jump_act_b)[:, :S_tot]  # (9,S)

    # left-edge element couplings: static k3 table * active * both-free.
    # Under the unified order the left edge of slot s IS chain edge s-1
    # (verified on the host at model build: FastMeta.left_is_chain_shift),
    # so when the caller provides the plan-order mask the (S,)-row bool
    # gather becomes a shift + static mask.
    act_pad = jnp.concatenate([active.astype(bool),
                               jnp.zeros((1,), bool)])
    if chain_act_b is not None and fast.meta.left_is_chain_shift:
        la = jnp.concatenate([jnp.zeros((1,), bool),
                              chain_act_b[:S_tot - 1]]) \
            & (plan.left_elem < conn.shape[0])
    else:
        la = act_pad[plan.left_elem]                     # (S,) bool
    fprev = jnp.concatenate([jnp.zeros((1,), bool), free_chain[:S_tot][:-1]])
    lmask = (la & free_chain[:S_tot] & fprev).astype(dtype)
    B_elem = tuple(-fast.left_k3[c] * lmask for c in range(9))

    # attachment couplings stay on the (small) path axis: the coupling
    # mask is evaluated ONLY at the attachment/dense-tail element ids
    # (P- and Ed-row gathers) instead of two E-row free_now[conn] gathers
    conn_pad = jnp.concatenate([conn, jnp.zeros((1, 2), conn.dtype)])
    tree_pad = jnp.concatenate([plan.tree_edge, jnp.zeros((1,), bool)])
    free_pad = jnp.concatenate([free_now, jnp.zeros((1,), bool)])
    k3_pad = jnp.concatenate([k3, jnp.zeros((1, 3, 3), dtype)])

    def k_att(idx):
        flat = idx.reshape(-1)
        c = conn_pad[flat]
        m = (act_pad[flat] & tree_pad[flat]
             & free_pad[c[:, 0]] & free_pad[c[:, 1]]
             & (c[:, 0] != c[:, 1]))
        out = -k3_pad[flat] * m[:, None, None].astype(dtype)
        return out.reshape(idx.shape + (3, 3))

    fill_B = jnp.zeros((P_tot + 1, 9), dtype)            # row-major comps
    dacc = jnp.zeros((9, S_tot + 1), dtype)

    alphas, betas = [], []
    dinv_parts = []
    attb_parts = []
    FLIP = (0, 3, 6, 1, 4, 7, 2, 5, 8)                   # transpose order
    L = n_pcr_levels(meta)
    for li in range(L):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        D_l = tuple(D_g[c, s0:s1] + dacc[c, s0:s1] for c in range(9))
        B_l = tuple(p[s0:s1] for p in B_elem)
        if fast.meta.level_left_fill[li]:
            lf = plan.left_fill[s0:s1]
            bf = fill_B[lf]                              # (S_l, 9) gather
            flip = plan.left_fill_flip[s0:s1]
            B_l = tuple(B_l[c] + jnp.where(flip, bf[:, FLIP[c]], bf[:, c])
                        for c in range(9))

        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        ab = k_att(plan.att_elem[p0:p1]) \
            + fill_B[plan.att_fill[p0:p1]].reshape(-1, 2, 3, 3)
        ab = jnp.where(plan.att_flip[p0:p1, :, None, None],
                       jnp.swapaxes(ab, -1, -2), ab)
        attb_parts.append(ab)

        S_l = s1 - s0
        al, be, dinv = _pcr_coeffs(D_l, B_l, meta.level_steps[li])
        alphas.append(al)
        betas.append(be)
        dinv_parts.append(jnp.stack(dinv))

        # corner blocks of T^{-1}: one 6-column PCR solve (unit blocks at
        # every first slot -> cols 0:3, last -> cols 3:6)
        rhs = tuple(jnp.zeros((S_l, 6), dtype)
                    .at[fg, i].add(1.0).at[lg, 3 + i].add(1.0)
                    for i in range(3))
        X = _pcr_apply(al, be, dinv, rhs)                # tuple3 (S_l, 6)
        Mff = jnp.stack([X[i][fg][:, 0:3] for i in range(3)], axis=1)
        Mll = jnp.stack([X[i][lg][:, 3:6] for i in range(3)], axis=1)
        Mfl = jnp.stack([X[i][fg][:, 3:6] for i in range(3)], axis=1)
        bl, br = ab[:, 0], ab[:, 1]
        dg_l = -_mm(_mm(bl, Mff), jnp.swapaxes(bl, -1, -2))
        dg_r = -_mm(_mm(br, Mll), jnp.swapaxes(br, -1, -2))
        tgt = plan.att_tgt[p0:p1]
        for i in range(3):
            for j in range(3):
                dacc = dacc.at[3 * i + j, tgt[:, 0]].add(dg_l[:, i, j])
                dacc = dacc.at[3 * i + j, tgt[:, 1]].add(dg_r[:, i, j])
        fb = -_mm(_mm(bl, Mfl), jnp.swapaxes(br, -1, -2))
        fb = fb * plan.has_fill[p0:p1, None, None]
        fill_B = fill_B.at[jnp.arange(p0, p1)].set(fb.reshape(-1, 9))

    dinv_all = (jnp.concatenate(dinv_parts, axis=1) if dinv_parts
                else jnp.zeros((9, 0), dtype))
    attb_all = (jnp.concatenate(attb_parts) if attb_parts
                else jnp.zeros((0, 2, 3, 3), dtype))
    t0 = meta.level_offsets[L]
    sinv = (_dense_tail_factor(
                plan, tuple(D_g[c, t0:S_tot] for c in range(9)),
                tuple(dacc[c, t0:S_tot] for c in range(9)),
                k_att(plan.dense_eid), fill_B)
            if S_tot > t0 else None)
    return TreeFactor(alphas=tuple(alphas), betas=tuple(betas),
                      dinv=dinv_all, att_b=attb_all, sinv=sinv)


def tree_apply_chain(plan: TreePlan, factor: TreeFactor,
                     r_chain: jnp.ndarray) -> jnp.ndarray:
    """tree_apply on CHAIN-ordered (N,3) residuals under the unified
    ordering: slots occupy positions [0, n_slots) so the per-iteration
    N-row gathers of the node-space version become slices."""
    rp = tuple(r_chain[:, i] for i in range(3))
    up = tree_apply_chain_planes(plan, factor, rp)
    u_slots = jnp.stack(up, axis=1)
    S_tot = plan.n_slots
    return jnp.concatenate([u_slots, r_chain[S_tot:]], axis=0)


def tree_apply_chain_planes(plan: TreePlan, factor: TreeFactor, rp
                            ) -> tuple:
    """Plane form: rp is a tuple of 3 (>=S_tot,) chain-ordered component
    planes; returns the tuple of 3 (S_tot,) solution planes (callers
    append the pass-through grip tail themselves)."""
    meta = plan.meta
    L = n_pcr_levels(meta)
    S_tot = plan.n_slots
    t0 = meta.level_offsets[L]
    dtype = rp[0].dtype
    zero1 = jnp.zeros((1,), dtype)
    racc = tuple(jnp.concatenate([p[:S_tot], zero1]) for p in rp)

    def _lvl_apply(li, s0, s1, r3):
        return _pcr_apply(factor.alphas[li], factor.betas[li],
                          factor.dinv[:, s0:s1], r3)

    ys = []
    for li in range(L):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        y = _lvl_apply(li, s0, s1, tuple(p[s0:s1] for p in racc))
        ys.append(y)
        ab = factor.att_b[p0:p1]
        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        tgt = plan.att_tgt[p0:p1]
        y_f = jnp.stack([y[i][fg] for i in range(3)], axis=1)   # (P,3)
        y_l = jnp.stack([y[i][lg] for i in range(3)], axis=1)
        v0 = _mv3(ab[:, 0], y_f)
        v1 = _mv3(ab[:, 1], y_l)
        racc = tuple(racc[i].at[tgt[:, 0]].add(-v0[:, i])
                     .at[tgt[:, 1]].add(-v1[:, i]) for i in range(3))

    u_all = tuple(jnp.zeros((S_tot + 1,), dtype) for _ in range(3))
    if S_tot > t0:
        r_tail = jnp.stack([p[t0:S_tot] for p in racc], axis=1)
        u_tail = _dense_tail_apply(factor, r_tail)
        u_all = tuple(u_all[i].at[t0:S_tot].set(u_tail[:, i])
                      for i in range(3))
    for li in range(L - 1, -1, -1):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        ab = factor.att_b[p0:p1]
        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        tgt = plan.att_tgt[p0:p1]
        uj0 = jnp.stack([u_all[i][tgt[:, 0]] for i in range(3)], axis=1)
        uj1 = jnp.stack([u_all[i][tgt[:, 1]] for i in range(3)], axis=1)
        z0 = _mtv3(ab[:, 0], uj0)
        z1 = _mtv3(ab[:, 1], uj1)
        z = tuple(jnp.zeros((s1 - s0,), dtype)
                  .at[fg].add(z0[:, i]).at[lg].add(z1[:, i])
                  for i in range(3))
        corr = _lvl_apply(li, s0, s1, z)
        u_all = tuple(u_all[i].at[s0:s1].set(ys[li][i] - corr[i])
                      for i in range(3))
    return tuple(u_all[i][:S_tot] for i in range(3))


def tree_factor(plan: TreePlan, active: jnp.ndarray,
                free_now: jnp.ndarray, reg,
                conn: jnp.ndarray) -> TreeFactor:
    """Numeric factorization (jit-safe; called once per solve).

    active: (E,) bool; free_now: (N,) bool (grips AND anchored);
    conn: (E,2)."""
    meta = plan.meta
    k3 = plan.k3
    E = conn.shape[0]
    N = free_now.shape[0]
    S_tot = plan.n_slots
    P_tot = plan.n_paths
    dtype = k3.dtype

    m_tree = active & plan.tree_edge
    m_couple = (m_tree & free_now[conn[:, 0]] & free_now[conn[:, 1]]
                & (conn[:, 0] != conn[:, 1]))
    k_eff = k3 * m_tree[:, None, None]
    # diag: sum of incident active tree-edge couplings + reg, identity on
    # pinned rows
    D_nodes = jnp.zeros((N, 3, 3), dtype)
    D_nodes = D_nodes.at[conn[:, 0]].add(k_eff)
    D_nodes = D_nodes.at[conn[:, 1]].add(k_eff)
    eye = jnp.eye(3, dtype=dtype)
    D_nodes = D_nodes + reg * eye[None]
    D_nodes = jnp.where(free_now[:, None, None], D_nodes, eye[None])

    # couplings indexed by source, with sentinel rows appended
    k_pad = jnp.concatenate(
        [-k3 * m_couple[:, None, None], jnp.zeros((1, 3, 3), dtype)])

    D_g = D_nodes[plan.slots]                     # (S,3,3)
    fill_B = jnp.zeros((P_tot + 1, 3, 3), dtype)  # + sentinel row
    dacc = jnp.zeros((S_tot + 1, 3, 3), dtype)    # + sentinel row

    alphas, betas = [], []
    dinv_parts = []
    attb_parts = []
    L = n_pcr_levels(meta)
    for li in range(L):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        D_l = D_g[s0:s1] + dacc[s0:s1]
        lf = plan.left_fill[s0:s1]
        B_fill = fill_B[lf]
        B_fill = jnp.where(plan.left_fill_flip[s0:s1, None, None],
                           jnp.swapaxes(B_fill, -1, -2), B_fill)
        B_l = k_pad[plan.left_elem[s0:s1]] + B_fill
        al, be, dinv = _pcr_coeffs(_split9(D_l), _split9(B_l),
                                   meta.level_steps[li])
        alphas.append(al)
        betas.append(be)
        dinv_parts.append(jnp.stack(dinv))

        # attachment couplings B[j, s]
        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        ab = k_pad[plan.att_elem[p0:p1]] \
            + fill_B[plan.att_fill[p0:p1]]
        ab = jnp.where(plan.att_flip[p0:p1, :, None, None],
                       jnp.swapaxes(ab, -1, -2), ab)       # (P,2,3,3)
        attb_parts.append(ab)

        # corner blocks of T^{-1}: one 6-column PCR solve (unit blocks at
        # every first slot -> cols 0:3, every last slot -> cols 3:6; paths
        # are decoupled so they don't interact)
        S_l = s1 - s0
        rhs = tuple(jnp.zeros((S_l, 6), dtype)
                    .at[fg, i].add(1.0).at[lg, 3 + i].add(1.0)
                    for i in range(3))
        X = _pcr_apply(al, be, dinv, rhs)          # tuple3 (S_l, 6)
        Mff = jnp.stack([X[i][fg][:, 0:3] for i in range(3)], axis=1)
        Mll = jnp.stack([X[i][lg][:, 3:6] for i in range(3)], axis=1)
        Mfl = jnp.stack([X[i][fg][:, 3:6] for i in range(3)], axis=1)
        # Schur corrections dG_j = -B[j,s] M_ss B[j,s]^T
        bl, br = ab[:, 0], ab[:, 1]
        dg_l = -_mm(_mm(bl, Mff), jnp.swapaxes(bl, -1, -2))
        dg_r = -_mm(_mm(br, Mll), jnp.swapaxes(br, -1, -2))
        tgt = plan.att_tgt[p0:p1]
        dacc = dacc.at[tgt[:, 0]].add(dg_l)
        dacc = dacc.at[tgt[:, 1]].add(dg_r)
        # fill edge B[jl, jr] = -B[jl,f] M_fl B[jr,l]^T
        fb = -_mm(_mm(bl, Mfl), jnp.swapaxes(br, -1, -2))
        fb = fb * plan.has_fill[p0:p1, None, None]
        fill_B = fill_B.at[jnp.arange(p0, p1)].set(fb)

    dinv_all = (jnp.concatenate(dinv_parts, axis=1) if dinv_parts
                else jnp.zeros((9, 0), dtype))
    attb_all = (jnp.concatenate(attb_parts) if attb_parts
                else jnp.zeros((0, 2, 3, 3), dtype))
    t0 = meta.level_offsets[L]
    P_tot = plan.n_paths
    sinv = (_dense_tail_factor(plan, _split9(D_g[t0:S_tot]),
                               _split9(dacc[t0:S_tot]),
                               k_pad[plan.dense_eid],
                               fill_B.reshape(P_tot + 1, 9))
            if S_tot > t0 else None)
    return TreeFactor(alphas=tuple(alphas), betas=tuple(betas),
                      dinv=dinv_all, att_b=attb_all, sinv=sinv)


def tree_apply(plan: TreePlan, factor: TreeFactor, r: jnp.ndarray
               ) -> jnp.ndarray:
    """z = K_tree^{-1} r for (N,3) r; pinned rows pass through."""
    r_s = r[plan.slots]                                  # (S,3) gather
    up = tree_apply_chain_planes(plan, factor,
                                 tuple(r_s[:, i] for i in range(3)))
    return r.at[plan.slots].set(jnp.stack(up, axis=1))


# ---------------------------------------------------------------------------
# grip reachability accelerated by the tree hierarchy
# ---------------------------------------------------------------------------

def tree_anchored(plan: TreePlan, model, active: jnp.ndarray
                  ) -> jnp.ndarray:
    """Nodes reachable from a grip through active elements.

    The plain BFS (ramp.anchored_mask_device) needs O(graph diameter)
    sweeps (~300 on the archived mesh). Here
    each fixpoint iteration hops an arbitrary distance ALONG TREE PATHS in
    log2(max path length) doubling rounds — reachability crosses a whole
    hypha per iteration — plus one plain neighbor sweep that covers cycle
    edges and grip seeding. Convergence: a handful of iterations (bounded
    by the number of cycle-edge crossings a shortest anchoring path needs).
    """
    meta = plan.meta
    L = len(meta.level_steps)
    grip = jnp.logical_or(model.top_nodes, model.bot_nodes)
    n = grip.shape[0]
    conn = model.conn

    act_pad = jnp.concatenate([active, jnp.zeros((1,), bool)])
    link_ok = act_pad[model.incident]                     # (N, deg)
    # slot-space static pieces
    left_act = act_pad[plan.left_elem]                    # (S,) bool; fill
    # edges: a fill edge is traversable iff its underlying path span and
    # both attachments are — conservatively treat fills as INACTIVE here
    # (the plain neighbor sweep still propagates through those junctions'
    # real edges, so correctness is unaffected; only the hop length of a
    # single iteration shrinks)
    att_act = act_pad[plan.att_elem]                      # (P,2) bool
    tgt = plan.att_tgt                                    # (P,2)
    S_tot = plan.n_slots

    def body(c):
        anch, _ = c
        # 1. plain neighbor sweep (covers grip seeding + cycle edges)
        anch_pad = jnp.concatenate([anch, jnp.zeros((1,), bool)])
        nb = jnp.logical_and(anch_pad[model.neighbor], link_ok)
        anch1 = jnp.logical_or(anch, jnp.any(nb, axis=1))
        anch1 = jnp.logical_or(anch1, grip)
        # 2. tree sweep in slot space: within-path doubling + attachments
        sv = jnp.concatenate([anch1[plan.slots],
                              jnp.zeros((1,), bool)])     # (S+1,)
        for li in range(L):
            s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
            p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
            seg = sv[s0:s1]
            la = left_act[s0:s1]
            sv = sv.at[s0:s1].set(_span_or(seg, la,
                                           meta.level_steps[li]))
            # attachments: junction <-> path ends (both directions)
            fg = plan.first_gpos[p0:p1]
            lg = plan.last_gpos[p0:p1]
            aa = att_act[p0:p1]
            for side, ends in ((0, fg), (1, lg)):
                j_anch = jnp.logical_and(sv[tgt[p0:p1, side]], aa[:, side])
                sv = sv.at[ends].max(j_anch)
                e_anch = jnp.logical_and(sv[ends], aa[:, side])
                sv = sv.at[tgt[p0:p1, side]].max(e_anch)
            sv = sv.at[s0:s1].set(_span_or(sv[s0:s1], la,
                                           meta.level_steps[li]))
        anch2 = anch1.at[plan.slots].max(sv[:S_tot])
        return anch2, jnp.any(anch2 != anch)

    def cond(c):
        return c[1]

    anch, _ = jax.lax.while_loop(cond, body,
                                 (grip, jnp.asarray(True)))
    return anch


def _span_or(seg: jnp.ndarray, left_act: jnp.ndarray, steps: int
             ) -> jnp.ndarray:
    """OR-propagate boolean seg values along contiguous active spans of a
    concatenated-path array, in `steps` doubling rounds. left_act[i] marks
    the edge (i-1, i) active; propagation never crosses inactive edges or
    path boundaries (left_act is False there)."""
    # conn[i] at round with distance s: edges (i..i+s) all active,
    # i.e. left_act[i+1..i+s] all True
    conn = jnp.roll(left_act, -1)      # conn_1[i] = left_act[i+1]
    s = 1
    for _ in range(steps):
        seg = jnp.logical_or(seg,
                             jnp.logical_and(jnp.roll(seg, -s), conn))
        seg = jnp.logical_or(seg,
                             jnp.logical_and(jnp.roll(seg, s),
                                             jnp.roll(conn, s)))
        conn = jnp.logical_and(conn, jnp.roll(conn, -s))
        s *= 2
    return seg
