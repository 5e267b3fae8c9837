"""Chain-ordered SpMV: a gather-light sparse operator.

Mycelium networks are overwhelmingly CHAINS (hyphae) joined at sparse
junctions (branch points, shared inoculum sites). A generic ELL/scatter
SpMV pays one indexed gather or scatter per row; this module removes
almost all of them:

1. Host-side, nodes are permuted along a greedy path cover of the element
   graph, making ~85-95%% of edges connect consecutive ids (i, i+1).
2. The "chain" part of K·u then needs only SHIFTS (pad/slice) and
   elementwise math — zero gathers.
3. The remaining "jump" edges (one per extra branch/junction connection)
   are applied through two-stage one-hot matmuls: select the 128-node
   block with a (J, NB) one-hot, then the position within the block with
   a (J, 128) one-hot. With Precision.HIGHEST these selections are exact
   for f32 (a GPU would otherwise run them as TF32) and keep the operator
   linear/symmetric. Past ONEHOT_CAP the J jump rows are gathered and
   scattered instead. Whether a plain gather beats the one-hot form on a
   GPU at every size is not yet measured.

The reference has no analogue — its SpMV is PETSc MatMult over a generic
CSR (src/fea_petsc.cpp:360-363).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

BLOCK = 128


class ChainPlan(NamedTuple):
    """Static per-mesh data for the chain-ordered operator. All node-indexed
    arrays live in PERMUTED space; ``perm``/``inv_perm`` convert:
    permuted[i] = original[perm[i]]."""
    perm: jnp.ndarray          # (N,) new position -> original node id
    inv_perm: jnp.ndarray      # (N,) original node id -> new position
    # chain part: slot i describes the element between positions i and i+1
    chain_elem: jnp.ndarray    # (N,) int32 element id or E (sentinel)
    chain_n: jnp.ndarray       # (N, 3) unit direction (from pos i to i+1
                               # endpoint order of the original element,
                               # sign-adjusted so n points from i to i+1)
    chain_kax: jnp.ndarray     # (N,)
    chain_kbd: jnp.ndarray     # (N,)
    # jump part
    jump_elem: jnp.ndarray     # (J,) int32 element ids
    jump_n: jnp.ndarray        # (J, 3) direction from endpoint a to b
    jump_kax: jnp.ndarray      # (J,)
    jump_kbd: jnp.ndarray      # (J,)
    # jump endpoint positions (padded rows carry the sentinel N)
    ja: jnp.ndarray            # (J,) int32
    jb: jnp.ndarray            # (J,) int32
    # one-hot block tables for each endpoint (a = row node, b = col node).
    # None on huge meshes (J*NB one-hot entries past ONEHOT_CAP): the
    # operator then gathers/scatters the J jump rows instead, where the
    # one-hot tables would be gigabytes
    a_blk: jnp.ndarray         # (J, NB) one-hot over node blocks
    a_lane: jnp.ndarray        # (J, BLOCK) one-hot within the block
    b_blk: jnp.ndarray         # (J, NB)
    b_lane: jnp.ndarray        # (J, BLOCK)

    @property
    def n_padded(self) -> int:
        if self.a_blk is not None:
            return self.a_blk.shape[1] * BLOCK
        n = self.perm.shape[0]
        return ((n + BLOCK - 1) // BLOCK) * BLOCK


# past this many one-hot entries per (J, NB) table the jump part of the
# operator switches to J-row gather/scatter
ONEHOT_CAP = 1 << 25


def greedy_path_cover(conn: np.ndarray, n_nodes: int) -> np.ndarray:
    """Order nodes along a greedy path cover of the element graph.

    Walks unvisited nodes depth-first but only ever continuing along ONE
    unvisited neighbor (a path, not a tree), starting new paths at
    low-degree nodes first (chain tips). Returns perm: position -> node.

    Dispatches to the native C++ runtime (native/meshio.cpp
    meshio_path_cover, identical semantics — tested against this oracle)
    when available; the pure-Python walk below is the fallback.
    """
    from ..native import meshio_native
    native = meshio_native.path_cover(conn, n_nodes)
    if native is not None:
        return native
    n_elems = conn.shape[0]
    # CSR adjacency
    deg = np.zeros(n_nodes, dtype=np.int64)
    np.add.at(deg, conn[:, 0], 1)
    np.add.at(deg, conn[:, 1], 1)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    adj = np.empty(2 * n_elems, dtype=np.int64)
    cursor = indptr[:-1].copy()
    for a, b in ((0, 1), (1, 0)):
        src = conn[:, a].astype(np.int64)
        dst = conn[:, b].astype(np.int64)
        # vectorized CSR fill
        order = np.argsort(src, kind="stable")
        pos = cursor[src[order]] + (
            np.arange(len(order)) - np.searchsorted(src[order], src[order]))
        adj[pos] = dst[order]
        cursor += np.bincount(src, minlength=n_nodes)

    visited = np.zeros(n_nodes, dtype=bool)
    perm = np.empty(n_nodes, dtype=np.int64)
    out = 0
    # start nodes in increasing degree order: path endpoints first
    starts = np.argsort(deg, kind="stable")
    for s in starts:
        if visited[s]:
            continue
        cur = s
        while True:
            visited[cur] = True
            perm[out] = cur
            out += 1
            nxt = -1
            for k in range(indptr[cur], indptr[cur + 1]):
                nb = adj[k]
                if not visited[nb]:
                    nxt = nb
                    break
            if nxt < 0:
                break
            cur = nxt
    assert out == n_nodes
    return perm


def build_chain_plan(coords: np.ndarray, conn: np.ndarray,
                     geom_n: np.ndarray, k_ax: np.ndarray,
                     k_bd: np.ndarray, dtype,
                     host_out: dict | None = None,
                     perm: np.ndarray | None = None) -> ChainPlan:
    """Classify edges as chain (consecutive after permutation) or jump and
    build the one-hot jump tables. All inputs are host numpy in ORIGINAL
    node numbering; geometry is the factored element data.

    ``host_out``, if given, receives the numpy versions of the plan tables
    so host-side consumers (model.build_model) never fetch them back from
    the device.

    ``perm`` imposes a node ordering instead of the greedy path cover —
    used by the unified tree/chain layout (model.py): ordering nodes by
    the tree schedule's slot order makes the tree PC's slot<->chain
    transforms FREE (slices instead of permutation gathers), at the cost
    of somewhat more jump edges."""
    n_nodes = coords.shape[0]
    n_elems = conn.shape[0]
    if perm is None:
        perm = greedy_path_cover(conn, n_nodes)
    else:
        perm = np.asarray(perm, np.int64)
        assert perm.shape == (n_nodes,)
    inv = np.empty(n_nodes, dtype=np.int64)
    inv[perm] = np.arange(n_nodes)

    p1 = inv[conn[:, 0]]
    p2 = inv[conn[:, 1]]
    lo = np.minimum(p1, p2)
    is_chain = (np.abs(p1 - p2) == 1)
    # at most one element may claim a chain slot; duplicates become jumps
    slot_owner = np.full(n_nodes, n_elems, dtype=np.int64)
    chain_ids = np.nonzero(is_chain)[0]
    # first element wins the slot (stable)
    for e in chain_ids:
        if slot_owner[lo[e]] == n_elems:
            slot_owner[lo[e]] = e
        else:
            is_chain[e] = False
    jump_ids = np.nonzero(~is_chain)[0]

    # chain arrays, sign-adjusted so n points from position i to i+1
    chain_n = np.zeros((n_nodes, 3))
    chain_kax = np.zeros(n_nodes)
    chain_kbd = np.zeros(n_nodes)
    have = slot_owner < n_elems
    e_own = slot_owner[have]
    sgn = np.where(inv[conn[e_own, 0]] < inv[conn[e_own, 1]], 1.0, -1.0)
    chain_n[have] = geom_n[e_own] * sgn[:, None]
    chain_kax[have] = k_ax[e_own]
    chain_kbd[have] = k_bd[e_own]

    # jump tables (new numbering); a = conn[:,0], b = conn[:,1]
    J = len(jump_ids)
    ja = inv[conn[jump_ids, 0]] if J else np.zeros(0, np.int64)
    jb = inv[conn[jump_ids, 1]] if J else np.zeros(0, np.int64)
    NB = (n_nodes + BLOCK - 1) // BLOCK
    Jp = max(int(np.ceil(max(J, 1) / 8)) * 8, 8)   # pad J for tiling
    with_onehots = Jp * NB <= ONEHOT_CAP

    def one_hots(idx):
        if not with_onehots:
            return None, None
        blk = np.zeros((Jp, NB), dtype=np.float64)
        lane = np.zeros((Jp, BLOCK), dtype=np.float64)
        if len(idx):
            blk[np.arange(len(idx)), idx // BLOCK] = 1.0
            lane[np.arange(len(idx)), idx % BLOCK] = 1.0
        return blk, lane

    a_blk, a_lane = one_hots(ja)
    b_blk, b_lane = one_hots(jb)
    jn = np.zeros((Jp, 3))
    jkax = np.zeros(Jp)
    jkbd = np.zeros(Jp)
    jelem = np.full(Jp, n_elems, dtype=np.int64)
    if J:
        jn[:J] = geom_n[jump_ids]
        jkax[:J] = k_ax[jump_ids]
        jkbd[:J] = k_bd[jump_ids]
        jelem[:J] = jump_ids

    ja_pad = np.full(Jp, n_nodes, np.int64)
    jb_pad = np.full(Jp, n_nodes, np.int64)
    if J:
        ja_pad[:J] = ja
        jb_pad[:J] = jb
    if host_out is not None:
        host_out.update(
            perm=perm, inv_perm=inv, chain_n=chain_n, chain_kax=chain_kax,
            chain_kbd=chain_kbd, jump_n=jn, jump_kax=jkax, jump_kbd=jkbd,
            a_blk=a_blk, a_lane=a_lane, b_blk=b_blk, b_lane=b_lane,
            chain_elem=slot_owner, jump_elem=jelem, ja=ja_pad, jb=jb_pad)
    # dtype conversion stays in numpy: jnp.asarray with a dtype change
    # compiles a convert_element_type per shape; a same-dtype asarray is a
    # pure device transfer
    as_j = lambda x, dt=dtype: jnp.asarray(np.asarray(x, dt))   # noqa: E731
    opt = lambda x: as_j(x) if x is not None else None          # noqa: E731
    return ChainPlan(
        perm=as_j(perm, np.int32),
        inv_perm=as_j(inv, np.int32),
        chain_elem=as_j(slot_owner, np.int32),
        chain_n=as_j(chain_n), chain_kax=as_j(chain_kax),
        chain_kbd=as_j(chain_kbd),
        jump_elem=as_j(jelem, np.int32),
        jump_n=as_j(jn), jump_kax=as_j(jkax), jump_kbd=as_j(jkbd),
        ja=as_j(ja_pad, np.int32), jb=as_j(jb_pad, np.int32),
        a_blk=opt(a_blk), a_lane=opt(a_lane),
        b_blk=opt(b_blk), b_lane=opt(b_lane),
    )


def _shift_up(x):
    """y[i] = x[i+1] (zero at the end)."""
    return jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], axis=0)


def _shift_down(x):
    """y[i] = x[i-1] (zero at the start)."""
    return jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], axis=0)


def chain_apply(plan: ChainPlan, chain_act, jump_act, u_perm):
    """K·u in permuted space. ``chain_act``/(J,) ``jump_act`` are the active
    masks pre-gathered into plan order (once per solve, outside the CG
    loop). u_perm: (N, 3) -> (N, 3)."""
    import jax
    from jax import lax

    N = u_perm.shape[0]
    W = u_perm.shape[1]
    # ---- chain part: shifts only, on COORDINATE COMPONENT PLANES ----
    # each plane op is a contiguous (N,) vector pass instead of an (N,3)
    # temporary with a minor dim of 3 (same layout as the tree-PC block
    # algebra, tree_jax.py)
    up = [u_perm[:, k] for k in range(W)]
    cn = [plan.chain_n[:, k] for k in range(W)]
    d = [p - _shift_up(p) for p in up]            # u[i] - u[i+1]
    nd = sum(cn[k] * d[k] for k in range(W))
    kax_nd = plan.chain_kax * nd
    f = [(kax_nd * cn[k]
          + plan.chain_kbd * (d[k] - nd * cn[k])) * chain_act
         for k in range(W)]
    # slot i contributes +f to node i, -f to node i+1
    out = jnp.stack([f[k] - _shift_down(f[k]) for k in range(W)], axis=1)

    if plan.a_blk is None:
        # ---- jump part, huge-mesh variant: J-row gather/scatter ----
        # (the (J, NB) one-hot tables would be gigabytes)
        u_pad = jnp.concatenate(
            [u_perm, jnp.zeros((1, W), u_perm.dtype)], axis=0)
        dj = u_pad[plan.ja] - u_pad[plan.jb]
        ndj = jnp.sum(plan.jump_n * dj, axis=1)
        fj = (plan.jump_kax * ndj)[:, None] * plan.jump_n \
            + plan.jump_kbd[:, None] * (dj - ndj[:, None] * plan.jump_n)
        fj = fj * jump_act[:, None]
        out = out.at[plan.ja].add(fj, mode="drop")
        out = out.at[plan.jb].add(-fj, mode="drop")
        return out

    # ---- jump part: two-stage one-hot matmuls ----
    NB = plan.a_blk.shape[1]
    Npad = NB * BLOCK
    up = jnp.pad(u_perm, ((0, Npad - N), (0, 0)))
    ub = up.reshape(NB, BLOCK * W)
    hi = lax.Precision.HIGHEST

    def sel(blk, lane):
        tmp = jnp.dot(blk, ub, precision=hi,
                      preferred_element_type=u_perm.dtype)  # (J, BLOCK*W)
        tmp = tmp.reshape(-1, BLOCK, W)
        return jnp.sum(tmp * lane[:, :, None], axis=1)      # (J, W)

    ua = sel(plan.a_blk, plan.a_lane)
    ub_ = sel(plan.b_blk, plan.b_lane)
    dj = ua - ub_
    ndj = jnp.sum(plan.jump_n * dj, axis=1)
    fj = (plan.jump_kax * ndj)[:, None] * plan.jump_n \
        + plan.jump_kbd[:, None] * (dj - ndj[:, None] * plan.jump_n)
    fj = fj * jump_act[:, None]

    def scat(blk, lane, vals):
        fexp = (lane[:, :, None] * vals[:, None, :]).reshape(
            -1, BLOCK * W)                                   # (J, BLOCK*W)
        ob = jnp.dot(blk.T, fexp, precision=hi,
                     preferred_element_type=u_perm.dtype)    # (NB, BLOCK*W)
        return ob.reshape(Npad, W)[:N]

    out = out + scat(plan.a_blk, plan.a_lane, fj) \
        - scat(plan.b_blk, plan.b_lane, fj)
    return out


def plan_active_masks_bool(plan: ChainPlan, active):
    """Bool form of plan_active_masks: gather the per-element active mask
    into plan order ONCE and share it between the matvec prep, the tree
    diag, and the factor."""
    act_pad = jnp.concatenate([active.astype(bool),
                               jnp.zeros((1,), bool)])
    return act_pad[plan.chain_elem], act_pad[plan.jump_elem]


def plan_active_masks(plan: ChainPlan, active):
    """Gather the per-element active mask into plan order (chain slots and
    jump rows). Called once per solve — the only gathers on this path.

    The gather runs on the BOOL array (1 byte/row) and casts afterwards,
    moving a quarter of the bytes of an f32 gather."""
    dtype = plan.chain_n.dtype
    cb, jb = plan_active_masks_bool(plan, active)
    return cb.astype(dtype), jb.astype(dtype)
