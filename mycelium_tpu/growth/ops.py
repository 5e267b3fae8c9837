"""Growth operators: substrate translocation, tip growth/branching, cuboid
uptake, and wall enforcement — each a pure masked update over the
fixed-capacity state (reference components C5, C7, C6, C10).

Where the reference's semantics are inherently sequential, the deviation is
deliberate and documented:

- translocation (mycelium_sim_2D.py:275-310): the reference accumulates all
  pairwise deltas then applies them one-by-one with a clamp after *each*
  addition. Predecessor links are unique per (pred, succ) pair and each
  segment has exactly one predecessor, so the only sequential effect is the
  per-update clamp when a segment receives several updates (a pred with
  multiple successors never occurs within a hypha; branch children carry no
  pred link). We apply all deltas at once then clamp — identical except for
  transient mid-apply clamping, which cannot trigger here because each
  slot receives at most one +delta and one -delta, both already clamped.

- uptake (mycelium_sim_2D.py:315-338): sequential drain in traversal order
  is reproduced exactly with a while_loop in slot order (creation order
  rather than the reference's hypha-grouped order — with a different RNG
  stream, trajectories differ anyway; the contract is statistical parity,
  the same contract the reference holds between its Python and C++ sims,
  SURVEY.md §2.5.15). The loop exits once the cuboid's remaining E falls
  below an epsilon floor instead of exactly 0 (E decays geometrically and
  would otherwise never reach 0 in exact arithmetic). The deviation is
  bounded: a segment the floor skips would have received
  theta <= dt*mu*floor*s ~ 1e-12·s, i.e. <= 1e-12 relative per segment.
  Both paths are anchored to a floor-FREE numpy transcription of the
  reference drain in tests/test_growth_ops.py
  (test_uptake_both_paths_match_reference_oracle,
  test_uptake_floor_deviation_is_bounded).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import GrowthConfig
from .state import (ACTIVE, EMPTY, PASSIVE, EnvArrays, GrowthState,
                    direction_from_angles, perturb_direction)

UPTAKE_E_FLOOR = 1e-18  # mol; negligible vs the 5e-6 Omega0 budget


def _gather(arr, idx, fill=0):
    """Gather with -1/-out-of-range indices mapped to a fill value."""
    safe = jnp.clip(idx, 0, arr.shape[0] - 1)
    ok = (idx >= 0) & (idx < arr.shape[0])
    out = arr[safe]
    return jnp.where(ok if out.ndim == 1 else ok[..., None], out,
                     jnp.asarray(fill, arr.dtype))


def translocate(st: GrowthState, cfg: GrowthConfig) -> GrowthState:
    """Diffusive exchange between predecessor and successor segments,
    clamped so both stay in [0, M_cap] (mycelium_sim_2D.py:275-310). The
    clamp adjusts the transferred delta itself, testing bounds in the
    reference's elif order.

    OCCUPANCY-BOUNDED: slots are allocated densely in [0, n_seg), so
    the per-row work (the packed (rows, 2) gather, the elif algebra and
    the pred scatter) runs in 2^16-row chunks inside a while_loop with
    a trip count from n_seg, so the cost follows the live slots, not
    the capacity (occupancy runs 10-50% at large presets). Bit-identical:
    every read uses the ORIGINAL sub, each slot receives at most one
    +delta (itself) and one -delta (its unique extension child), and
    the clamp applies once at the end, exactly as before."""
    m_cap = jnp.asarray(cfg.m_cap, st.sub.dtype)
    N = st.capacity
    C = min(1 << 16, N)
    n_ch = (st.n_seg + C - 1) // C
    scale = jnp.asarray(cfg.dt * cfg.diffusion, st.sub.dtype)

    # packed (L, sub) source for the pred gather (full-capacity
    # ELEMENTWISE build is cheap; only the per-ROW ops are chunked)
    L_full = st.length()
    packed = jnp.stack([L_full, st.sub], axis=1)
    dsl = jax.lax.dynamic_slice_in_dim
    dus = jax.lax.dynamic_update_slice_in_dim

    def body(carry):
        ci, acc = carry
        s0 = ci * C
        prev_c = dsl(st.prev, s0, C, axis=0)
        state_c = dsl(st.state, s0, C, axis=0)
        sub_c = dsl(st.sub, s0, C, axis=0)
        L_c = dsl(L_full, s0, C, axis=0)
        valid = (prev_c >= 0) & (state_c != EMPTY)
        p = jnp.maximum(prev_c, 0)
        lp_sub = packed[p]                   # ONE C-row gather
        lp = lp_sub[:, 0]
        denom = (L_c + lp) / 2.0
        ok = valid & (denom > 0)
        denom_safe = jnp.where(denom > 0, denom, 1.0)
        sub_p = lp_sub[:, 1]
        delta = scale * (sub_p - sub_c) / denom_safe
        new_s = sub_c + delta
        new_p = sub_p - delta
        # reference's elif chain (order matters):
        delta_adj = jnp.where(
            new_s < 0, -sub_c,
            jnp.where(new_s > m_cap, m_cap - sub_c,
                      jnp.where(new_p < 0, sub_p,
                                jnp.where(new_p > m_cap, m_cap - sub_p,
                                          delta))))
        delta_adj = jnp.where(ok, delta_adj, 0.0)
        # self part: read-modify-write of the chunk window (additive —
        # preserves pred contributions other chunks already landed here)
        acc = dus(acc, dsl(acc, s0, C, axis=0) + delta_adj, s0,
                  axis=0)
        acc = acc.at[p].add(jnp.where(ok, -delta_adj, 0.0))
        return ci + 1, acc

    _, sub = jax.lax.while_loop(lambda c: c[0] < n_ch, body,
                                (jnp.asarray(0, st.n_seg.dtype), st.sub))
    sub = jnp.clip(sub, 0.0, m_cap)
    return st._replace(sub=sub)


def grow(st: GrowthState, cfg: GrowthConfig, key) -> GrowthState:
    """Apical extension and branching (mycelium_sim_2D.py:388-460).

    Per active tip with enough substrate (I·L >= c_g·h0): spend the growth
    cost, turn the tip passive, and append a new active segment continuing
    in a perturbed direction; with probability P_branch (and 2x the cost
    available) also spawn a branch child as a new hypha. Both new segments
    receive half the parent's post-cost concentration — substrate is NOT
    conserved here, faithfully to the reference (SURVEY.md §2.5.1).
    """
    N, H = st.capacity, st.tip.shape[0]
    dtype = st.sub.dtype
    k_branch, k_ext, k_child = jax.random.split(key, 3)

    hyp_ids = jnp.arange(H, dtype=jnp.int32)
    tip_slot = st.tip
    hyp_valid = (hyp_ids < st.n_hyp) & (tip_slot >= 0)
    t = jnp.maximum(tip_slot, 0)

    # ONE packed f32 gather for all per-tip fields instead of six
    # separate row gathers, + a 1-byte state gather
    packed = jnp.concatenate(
        [st.start, st.end, st.theta[:, None], st.phi[:, None],
         st.sub[:, None]], axis=1)[t]                  # (H, 9)
    tip_start = packed[:, 0:3]
    tip_end = packed[:, 3:6]
    tip_theta = packed[:, 6]
    tip_phi = packed[:, 7]
    tip_sub = packed[:, 8]

    tip_state = jnp.where(hyp_valid, st.state[t], EMPTY)
    L_tip = jnp.linalg.norm(tip_end - tip_start, axis=1)
    avail = tip_sub * L_tip
    cost = cfg.c_g * cfg.h0
    can_grow = (tip_state == ACTIVE) & (avail >= cost)

    u = jax.random.uniform(k_branch, (H,), dtype)
    do_branch = can_grow & (u < cfg.p_branch) & (avail >= 2 * cost)

    # slot allocation: extensions first (every grower gets one), then branch
    # children; hypha ids for children allocated the same way
    ext_off = jnp.cumsum(can_grow) - can_grow        # exclusive prefix sum
    n_ext = jnp.sum(can_grow).astype(jnp.int32)
    child_off = jnp.cumsum(do_branch) - do_branch
    n_child = jnp.sum(do_branch).astype(jnp.int32)
    ext_slot = st.n_seg + ext_off.astype(jnp.int32)
    child_slot = st.n_seg + n_ext + child_off.astype(jnp.int32)
    child_hyp = st.n_hyp + child_off.astype(jnp.int32)

    overflow = (st.n_seg + n_ext + n_child > N) | (st.n_hyp + n_child > H)
    valid_ext = can_grow & (ext_slot < N)
    valid_child = do_branch & (child_slot < N) & (child_hyp < H)

    # tip update: spend cost, become passive
    total_cost = jnp.where(do_branch, 2 * cost, cost)
    L_safe = jnp.where(L_tip > 0, L_tip, 1.0)
    tip_sub_new = jnp.maximum(0.0, (avail - total_cost)) / L_safe
    sub = st.sub.at[jnp.where(valid_ext, t, N)].set(
        jnp.where(valid_ext, tip_sub_new, 0.0), mode="drop")
    state = st.state.at[jnp.where(valid_ext, t, N)].set(PASSIVE, mode="drop")

    # new directions (one perturbation stream for extensions, one for kids)
    th_e, ph_e = perturb_direction(k_ext, tip_theta, tip_phi, cfg)
    th_c, ph_c = perturb_direction(k_child, tip_theta, tip_phi, cfg)
    dir_e = direction_from_angles(th_e, ph_e, cfg.three_d)
    dir_c = direction_from_angles(th_c, ph_c, cfg.three_d)
    end_e = tip_end + dir_e * cfg.h0
    end_c = tip_end + dir_c * cfg.h0
    child_sub = 0.5 * tip_sub_new  # both children get half the remaining I

    # New-segment writes: ext slots are the CONTIGUOUS range
    # [n_seg, n_seg + n_ext) and child slots the one after it, so instead
    # of ~14 H-row scatters into the (N,) state arrays we COMPACT each
    # batch's values by rank with two scatters into small (H, k) staging
    # buffers and commit them with
    # contiguous dynamic_update_slice windows. Arrays are padded by H
    # rows so a window starting at n_seg <= N never clamps; rows past
    # each batch's count carry the init fill values (state EMPTY,
    # prev/hypha -1, floats 0) and rows sliced off past N reproduce the
    # old mode="drop" overflow behavior.
    fdt = st.sub.dtype

    def compact(ok, rank, cols_f, cols_i):
        # one scalar scatter per column instead of one (H,9) row scatter
        # whose minor dim of 9 pads in device layouts
        cidx = jnp.where(ok, rank.astype(jnp.int32), H)
        cf = jnp.stack(
            [jnp.zeros((H,), fdt).at[cidx].set(c, mode="drop")
             for c in cols_f], axis=1)
        ci = jnp.stack(
            [jnp.full((H,), -1, jnp.int32).at[cidx].set(c, mode="drop")
             for c in cols_i], axis=1)
        return cf, ci

    # int staging stays as narrow as possible — scatter cost grows with
    # each extra s32 column: the hypha-id column doubles as
    # the "was written" indicator (fill -1 -> EMPTY), and the children's
    # prev column is the constant -1 (no staging needed)
    ext_f, ext_i = compact(
        valid_ext, ext_off,
        [tip_end[:, 0], tip_end[:, 1], tip_end[:, 2],
         end_e[:, 0], end_e[:, 1], end_e[:, 2], th_e, ph_e, child_sub],
        [tip_slot, hyp_ids])
    ch_f, ch_i = compact(
        valid_child, child_off,
        [tip_end[:, 0], tip_end[:, 1], tip_end[:, 2],
         end_c[:, 0], end_c[:, 1], end_c[:, 2], th_c, ph_c, child_sub],
        [child_hyp])

    # a rank row whose writer was INVALID (e.g. child_hyp >= H) keeps the
    # -1 fill -> EMPTY, so capacity-dropped writers leave their slot a
    # gap exactly like the old mode="drop" scatters did
    ext_state = jnp.where(ext_i[:, 1] >= 0, ACTIVE, EMPTY).astype(
        st.state.dtype)
    ch_state = jnp.where(ch_i[:, 0] >= 0, ACTIVE, EMPTY).astype(
        st.state.dtype)

    def window(arr, fill, pos, vals):
        pad = jnp.full((H,) + arr.shape[1:], fill, arr.dtype)
        zero = jnp.zeros((), pos.dtype)
        out = jax.lax.dynamic_update_slice(
            jnp.concatenate([arr, pad]),
            vals.astype(arr.dtype),
            (pos,) + (zero,) * (arr.ndim - 1))
        return out[:N]

    pos_e = st.n_seg
    pos_c = st.n_seg + n_ext
    start = window(window(st.start, 0.0, pos_e, ext_f[:, 0:3]),
                   0.0, pos_c, ch_f[:, 0:3])
    end = window(window(st.end, 0.0, pos_e, ext_f[:, 3:6]),
                 0.0, pos_c, ch_f[:, 3:6])
    theta = window(window(st.theta, 0.0, pos_e, ext_f[:, 6]),
                   0.0, pos_c, ch_f[:, 6])
    phi = window(window(st.phi, 0.0, pos_e, ext_f[:, 7]),
                 0.0, pos_c, ch_f[:, 7])
    sub = window(window(sub, 0.0, pos_e, ext_f[:, 8]),
                 0.0, pos_c, ch_f[:, 8])
    prev = window(window(st.prev, -1, pos_e, ext_i[:, 0]),
                  -1, pos_c, jnp.full((H,), -1, jnp.int32))
    hypha = window(window(st.hypha, -1, pos_e, ext_i[:, 1]),
                   -1, pos_c, ch_i[:, 0])
    state = window(window(state, EMPTY, pos_e, ext_state),
                   EMPTY, pos_c, ch_state)

    # tip table: the ext update is indexed by hypha id itself -> a where;
    # child hyphae are the contiguous range [n_hyp, n_hyp + n_child)
    tip = jnp.where(valid_ext & (ext_slot < N), ext_slot, st.tip)
    ch_tip = jnp.full((H,), -1, jnp.int32).at[
        jnp.where(valid_child, child_off.astype(jnp.int32), H)].set(
        child_slot, mode="drop")
    tip = jax.lax.dynamic_update_slice(
        jnp.concatenate([tip, jnp.full((H,), -1, jnp.int32)]),
        ch_tip, (st.n_hyp,))[:H]

    return st._replace(
        start=start, end=end, theta=theta, phi=phi, sub=sub, state=state,
        prev=prev, hypha=hypha, tip=tip,
        n_seg=jnp.minimum(st.n_seg + n_ext + n_child, N).astype(jnp.int32),
        n_hyp=jnp.minimum(st.n_hyp + n_child, H).astype(jnp.int32),
        overflow=st.overflow | overflow,
    )


def _contains(center, size, p, eps=1e-12):
    """Axis-aligned cuboid point test with the reference's 1e-12 slack
    (mycelium_sim_2D.py:163-166). center/size: (3,), p: (...,3)."""
    lo = center - 0.5 * size - eps
    hi = center + 0.5 * size + eps
    return jnp.all((p >= lo) & (p <= hi), axis=-1)


def uptake_loop(st: GrowthState, env: EnvArrays,
                cfg: GrowthConfig) -> GrowthState:
    """Literal sequential drain: one while_loop iteration per segment slot
    per cuboid (the reference's exact traversal,
    mycelium_sim_2D.py:315-338). O(n_seg) serial device steps — kept as
    the oracle for the run-parallel ``uptake`` below."""
    m_cap = jnp.asarray(cfg.m_cap, st.sub.dtype)
    sub = st.sub
    env_e = st.env_e
    n_cuboids = env.sub_center.shape[0]
    for c in range(n_cuboids):   # static, tiny
        mu = env.sub_mu[c]
        in_c = _contains(env.sub_center[c], env.sub_size[c], st.end) & \
            (st.state != EMPTY)

        def cond(carry):
            i, e, _ = carry
            return (i < st.n_seg) & (e > UPTAKE_E_FLOOR)

        def body(carry):
            i, e, s = carry
            si = s[i]
            theta = cfg.dt * mu * e * si
            theta = jnp.maximum(0.0, jnp.minimum(theta,
                                                 jnp.minimum(m_cap - si, e)))
            theta = jnp.where(in_c[i], theta, 0.0)
            return i + 1, e - theta, s.at[i].set(si + theta)

        _, e_left, sub = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32), env_e[c], sub))
        env_e = env_e.at[c].set(e_left)
    return st._replace(sub=sub, env_e=env_e)


def uptake(st: GrowthState, env: EnvArrays, cfg: GrowthConfig) -> GrowthState:
    """Run-parallel sequential drain (same semantics as ``uptake_loop``).

    The reference drains E through segments IN ORDER
    (mycelium_sim_2D.py:315-338): theta_i = clamp(dt*mu*E_i*s_i, 0,
    min(m_cap - s_i, E_i)); E_{i+1} = E_i - theta_i. Per segment that is
    one of three affine maps of E:

      A (no clamp)    E -> (1 - dt*mu*s_i) * E     (product decay)
      B (cap clamp)   E -> E - (m_cap - s_i)       (segment saturates)
      C (exhaustion)  E -> 0

    so the trajectory is a few alternating RUNS of regime A (one masked
    cumprod evaluates the whole run) and regime B (one masked cumsum),
    separated by single clamp events. Each outer while iteration commits
    one maximal A-run, then one maximal B-run, then — only if neither
    advanced — one scalar element, so the iteration count is the number of
    regime alternations (a handful) instead of one per segment: the
    SURVEY.md §7.1 cumulative-clamp sketch, made exact. At the 1e6-segment
    preset this replaces ~1e6 serial device steps per growth step with
    ~2-10 vector passes. Equivalence to uptake_loop is tested on random
    clamp-exercising states (tolerance ~1e-12 in f64; boundary decisions
    match exactly, only product/sum association rounding differs).
    """
    dtype = st.sub.dtype
    m_cap = jnp.asarray(cfg.m_cap, dtype)
    floor = jnp.asarray(UPTAKE_E_FLOOR, dtype)
    N = st.capacity
    idx = jnp.arange(N, dtype=jnp.int32)
    sub0 = st.sub
    env_e = st.env_e
    n_cuboids = env.sub_center.shape[0]
    sub = sub0
    for c in range(n_cuboids):   # static, tiny
        mu = env.sub_mu[c]
        # Segments already at m_cap are exact no-ops in the reference
        # drain (theta = clamp(..., min(m_cap - s, E)) = 0,
        # mycelium_sim_2D.py:331-335), and each segment is visited ONCE,
        # so excluding them by their pre-drain s is exact. Without this
        # they are run BREAKERS (th_a > cap == 0 violates every A-run),
        # and at xlarge occupancy the saturated/unsaturated interleaving
        # drove one while iteration per boundary — O(1e5) full-capacity
        # cumprod passes per growth step.
        elig = _contains(env.sub_center[c], env.sub_size[c], st.end) & \
            (st.state != EMPTY) & (idx < st.n_seg) & (sub < m_cap)

        def cond(carry):
            pos, e, _ = carry
            return (pos < N) & (e > floor)

        def body(carry, elig=elig, mu=mu):
            pos, e, s = carry
            live = (idx >= pos) & elig
            a = jnp.where(live, cfg.dt * mu * s, 0.0)      # uptake rate
            cap = jnp.maximum(m_cap - s, 0.0)              # room to m_cap

            # ---- regime-A run: E_i = e * prod_{j<i}(1-a_j) ----
            f = jnp.where(live, 1.0 - a, 1.0)
            p_excl = jnp.concatenate([jnp.ones((1,), dtype),
                                      jnp.cumprod(f)[:-1]])
            e_a = e * p_excl
            th_a = a * e_a
            # first position the pure product is wrong: a>=1 (exhaustion
            # candidate), cap clamp, or the reference's E-floor early stop
            viol = live & ((a >= 1.0) | (th_a > cap) | (e_a <= floor))
            v1 = jnp.where(jnp.any(viol), jnp.argmax(viol), N
                           ).astype(jnp.int32)
            commit_a = live & (idx < v1)
            s = s + jnp.where(commit_a, th_a, 0.0)
            e1 = e * jnp.where(v1 < N, p_excl[jnp.minimum(v1, N - 1)],
                               jnp.cumprod(f)[-1])

            # ---- regime-B run from v1: theta_i = cap_i (saturation) ----
            live_b = (idx >= v1) & elig
            cap_b = jnp.where(live_b, cap, 0.0)
            s_excl = jnp.concatenate([jnp.zeros((1,), dtype),
                                      jnp.cumsum(cap_b)[:-1]])
            e_b = e1 - s_excl
            ok_b = e1 > floor
            bind = live_b & ok_b & (cap <= a * e_b) & (cap <= e_b) \
                & (e_b > floor)
            # run ends at the first ELIGIBLE non-binding position
            stop = live_b & ~bind
            w = jnp.where(jnp.any(stop), jnp.argmax(stop), N
                          ).astype(jnp.int32)
            commit_b = live_b & bind & (idx < w)
            s = jnp.where(commit_b, m_cap, s)
            e2 = e1 - jnp.sum(jnp.where(commit_b, cap_b, 0.0))

            # ---- scalar fallback: one stuck element at w == pos ----
            stuck = (w == pos) & (w < N) & ok_b & (e2 > floor)
            sw = s[jnp.minimum(w, N - 1)]
            aw = cfg.dt * mu * sw
            th_w = jnp.maximum(0.0, jnp.minimum(
                aw * e2, jnp.minimum(jnp.maximum(m_cap - sw, 0.0), e2)))
            th_w = jnp.where(stuck & elig[jnp.minimum(w, N - 1)], th_w, 0.0)
            s = s.at[jnp.minimum(w, N - 1)].add(
                jnp.where(stuck, th_w, 0.0))
            e3 = e2 - th_w
            pos_next = jnp.where(stuck, w + 1, jnp.maximum(w, v1))
            return pos_next, e3, s

        _, e_left, sub = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32), env_e[c], sub))
        env_e = env_e.at[c].set(e_left)
    return st._replace(sub=sub, env_e=env_e)


def enforce_walls(st: GrowthState, env: EnvArrays, cfg: GrowthConfig,
                  key) -> GrowthState:
    """Project tips penetrating impenetrable cuboids tangentially along the
    wall face, iterating up to 3 times for corners
    (mycelium_sim_2D.py:340-383). Applies to the LAST segment of every
    hypha regardless of state, and reactivates projected tips ('A') — both
    faithful reference quirks (tip_segments() yields all tips; state is
    reset at :380)."""
    H = st.tip.shape[0]
    N = st.capacity
    W = env.wall_center.shape[0]
    if W == 0:
        return st
    dtype = st.start.dtype
    hyp_ids = jnp.arange(H, dtype=jnp.int32)
    hyp_valid = (hyp_ids < st.n_hyp) & (st.tip >= 0)
    t = jnp.maximum(st.tip, 0)

    # one packed row gather for both endpoints (row gathers cost per ROW)
    ge = jnp.concatenate([st.start, st.end], axis=1)[t]       # (H,6)
    start = ge[:, 0:3]
    end = ge[:, 3:6]
    length = jnp.linalg.norm(end - start, axis=1)
    touched = jnp.zeros((H,), bool)

    for it in range(3):                       # reference max_iter=3
        key, k_dir, k_tan = jax.random.split(key, 3)
        inside = jnp.stack([_contains(env.wall_center[w], env.wall_size[w],
                                      end) for w in range(W)], axis=1)
        pen = jnp.any(inside, axis=1) & hyp_valid
        w_first = jnp.argmax(inside, axis=1)          # first penetrated wall
        # one-hot selection over the tiny wall table instead of H-row
        # gathers. It is a masked sum, not a matmul: wall geometry must
        # come out exact, and a GPU runs f32 matmuls as TF32 by default
        ohw = jax.nn.one_hot(w_first, W, dtype=dtype)[:, :, None]  # (H,W,1)
        c = jnp.sum(ohw * env.wall_center[None], axis=1)
        half = jnp.sum(ohw * env.wall_size[None], axis=1) / 2.0
        delta = end - c
        overlap = jnp.abs(delta) - half
        face = jnp.argmax(overlap, axis=1)
        ohf = jax.nn.one_hot(face, 3, dtype=dtype)              # (H, 3)
        normal = ohf * jnp.sign(
            jnp.sum(delta * ohf, axis=1, keepdims=True))
        d = end - start
        dn = jnp.linalg.norm(d, axis=1, keepdims=True)
        rnd = jax.random.normal(k_dir, (H, 3), dtype)
        d = jnp.where(dn < 1e-12, rnd, d)
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
        slide = d - jnp.sum(d * normal, axis=1, keepdims=True) * normal
        sn = jnp.linalg.norm(slide, axis=1, keepdims=True)
        # fallback: random tangent with the normal component zeroed
        tan = jax.random.normal(k_tan, (H, 3), dtype)
        tan = tan * (1.0 - jnp.abs(normal))
        slide = jnp.where(sn < 1e-12, tan, slide)
        slide = slide / jnp.linalg.norm(slide, axis=1, keepdims=True)
        new_end = start + slide * length[:, None]
        end = jnp.where(pen[:, None], new_end, end)
        touched = touched | pen

    dirv = end - start
    dn = jnp.maximum(jnp.linalg.norm(dirv, axis=1), 1e-30)
    new_theta = jnp.arccos(jnp.clip(dirv[:, 2] / dn, -1.0, 1.0))
    new_phi = jnp.arctan2(dirv[:, 1], dirv[:, 0])

    idx = jnp.where(touched, t, N)
    # per coordinate plane: three scalar scatters instead of one width-3
    # row scatter
    end_out = jnp.stack(
        [st.end[:, k].at[idx].set(end[:, k], mode="drop")
         for k in range(3)], axis=1)
    theta_out = st.theta.at[idx].set(new_theta, mode="drop")
    phi_out = st.phi.at[idx].set(new_phi, mode="drop")
    state_out = st.state.at[idx].set(ACTIVE, mode="drop")
    return st._replace(end=end_out, theta=theta_out, phi=phi_out,
                       state=state_out, key=key)
