"""Static-shape neighbor search and anastomosis detection.

Replaces the reference's dict-based voxel hash (reference component C8,
src/mycelium_sim_2D.py:465-501; int64-keyed C++ twin
src/mycelium_sim_2D.cpp:185-231) with a DENSE cell grid over the dish:
segments are bucketed into a static (G, G, Gz, C) table (one argsort + one
scatter). Two query strategies read it (detect_anastomosis): 'window'
gathers each tip's neighbor-cell windows, 'grid' aligns tip and segment
buckets by ROLLING the small tip planes, gather-free. In the 'grid' form
tips are bucketed by their nearest grid CORNER, which shrinks the exact
search window to the 2x2 cell block around it. Grid wrap-around from the
rolls is harmless: wrapped candidates are physically far, so their true
distances never pass the 1e-3 mm tolerance.

Anastomosis (C9, src/mycelium_sim_2D.py:507-542): an active tip whose
endpoint comes within tol of any other segment snaps to the closest point
on that segment and becomes 'S' (it stops growing forever). Like the
reference, the query runs against the post-growth segment set, indexes
midpoints only (the voxel size 0.1 is 2x the segment length, so the 3x3
neighborhood is safe), and excludes only the tip itself. Deviations (both
documented): we snap to the NEAREST candidate rather than the first in
dict-bucket order, and cells hold at most C segments / Ct tips (overflow
drops candidates; the defaults are ~10x the mean occupancy).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GrowthConfig
from .state import ACTIVE, ANASTOMOSED, EMPTY, GrowthState


def grid_dims(cfg: GrowthConfig):
    """Static grid extents: the dish plus margin for wall-leaked tips;
    out-of-range coordinates clip into the border cells."""
    g = int(np.ceil(cfg.dish_size / cfg.voxel_size)) + 4
    if cfg.three_d:
        gz = int(np.ceil((cfg.height + 2 * cfg.wall_thickness)
                         / cfg.voxel_size)) + 3
    else:
        gz = 1
    return g, gz


def cell_coords(p, cfg: GrowthConfig):
    """(..., 3) positions -> clipped integer cell coords (cx, cy, cz)."""
    g, gz = grid_dims(cfg)
    c = jnp.floor(p / cfg.voxel_size).astype(jnp.int32)
    cx = jnp.clip(c[..., 0] + g // 2, 0, g - 1)
    cy = jnp.clip(c[..., 1] + g // 2, 0, g - 1)
    cz = jnp.clip(c[..., 2] + gz // 2, 0, gz - 1)
    return cx, cy, cz


def _cell_id(p, cfg):
    g, gz = grid_dims(cfg)
    cx, cy, cz = cell_coords(p, cfg)
    return (cx * g + cy) * gz + cz


def _bucket(ids, cell, n_cells, cap, sentinel, want_pos=False):
    """Bucket `ids` (already the item indices) by cell into a dense
    (n_cells, cap) table of item ids; empty slots hold ``sentinel`` (which
    must be out of range for the ID SPACE of ``ids``, not their count).

    ``cell`` must be n_cells for invalid items (they drop out).

    Returns (table, n_dropped, occ_max): items past a cell's capacity are
    silently absent from the table, so callers must surface
    ``n_dropped > 0`` (a dense inoculum cluster or an undersized cap would
    otherwise lose anastomosis candidates undetectably). ``occ_max`` is
    the largest per-cell occupancy actually present (capped at ``cap``) —
    the query loops bound their trip counts with it, so the static cap
    only sets memory, not compute.

    With ``want_pos`` a fourth array is returned: per INPUT position, the
    item's table position ``cell*cap + rank`` (``n_cells*cap`` for items
    that were dropped or invalid) — the inverse map that lets callers pull
    per-item results back out of table-shaped query outputs with a small
    gather instead of scattering through the full table space.
    """
    n = ids.shape[0]
    key = jnp.where(cell < n_cells, cell, n_cells)
    order = jnp.argsort(key)
    sc = key[order]
    # first-occurrence index of each run in the sorted keys via cummax
    # (one scan instead of a searchsorted)
    pos = jnp.arange(n, dtype=jnp.int32)
    run_start = jnp.concatenate([jnp.ones((1,), bool), sc[1:] != sc[:-1]])
    first = jax.lax.cummax(jnp.where(run_start, pos, 0))
    rank = pos - first
    in_range = sc < n_cells
    valid = in_range & (rank < cap)
    n_dropped = jnp.sum(in_range & (rank >= cap))
    occ_max = jnp.max(jnp.where(valid, rank, -1)).astype(jnp.int32) + 1
    slot = jnp.where(valid, sc * cap + rank, n_cells * cap)
    tbl = jnp.full((n_cells * cap + 1,), sentinel, jnp.int32)
    tbl = tbl.at[slot].set(ids[order], mode="drop")
    out = (tbl[:n_cells * cap].reshape(n_cells, cap), n_dropped, occ_max)
    if want_pos:
        item_pos = jnp.zeros((n,), jnp.int32).at[order].set(
            slot.astype(jnp.int32))
        out = out + (item_pos,)
    return out


class SegGrid(NamedTuple):
    """Persistent APPEND-ONLY anastomosis candidate grid
    (cfg.grid_incremental).

    Replaces the per-step full rebucket (an N-slot argsort + full-grid
    geometry gather) with inserts of
    only the segments FINALIZED since the last step. A segment's geometry
    freezes the moment its hypha extends past it: walls
    (ops.enforce_walls) and anastomosis snaps mutate TIP slots only, so
    entries never go stale and nothing is ever removed. Mutable tip
    segments are queried through a per-step overlay table instead (built
    in detect_anastomosis over H hypha rows, not N segment slots).

    Arrays are stored in the query's plane layout — plane p = rank*gz+cz,
    so (p, cx, cy) holds the rank-th segment of cell (cx, cy, cz) — and
    hold exactly what the distance scan reads (start, end-start,
    1/|end-start|^2), so the query consumes them with no per-step gather
    at all. The reference's closest analogue is its incremental voxel
    insert (mycelium_sim_2D.py:540-542 re-inserts only the snapped tip).

    Arrays are stored FLAT (P = GC*g*g) — the query reshapes them to
    (GC, g, g) views (free: contiguous row-major), and the insert loop
    works in flat index space, so a steady-state step with an empty
    insert window re-stacks no untouched planes.
    """
    ids: jnp.ndarray     # (P,) int32 segment slots; sentinel = N
    a: tuple             # 3 x (P,) segment start components
    ab: tuple            # 3 x (P,) end - start components
    r_ab2: jnp.ndarray   # (P,) 1/max(|ab|^2, eps); 0 if degenerate
    count: jnp.ndarray   # (g*g*gz,) int32 per-cell occupancy
    occ: jnp.ndarray     # () int32 max per-cell occupancy seen
    n_seen: jnp.ndarray  # () int32 slots already scanned for finalization


def empty_grid(cfg: GrowthConfig, capacity: int, dtype) -> SegGrid:
    g, gz = grid_dims(cfg)
    GC = gz * cfg.max_per_cell
    P = GC * g * g
    return SegGrid(
        ids=jnp.full((P,), capacity, jnp.int32),
        a=tuple(jnp.zeros((P,), dtype) for _ in range(3)),
        ab=tuple(jnp.zeros((P,), dtype) for _ in range(3)),
        r_ab2=jnp.zeros((P,), dtype),
        count=jnp.zeros((g * g * gz,), jnp.int32),
        occ=jnp.zeros((), jnp.int32),
        n_seen=jnp.zeros((), jnp.int32),
    )


def grid_insert_finalized(grid: SegGrid, st: GrowthState, cfg: GrowthConfig,
                          sgeo_pad=None):
    """Insert every segment finalized since the grid last looked.

    The extension window [n_seen, n_seg) of ``st.prev`` is exactly the
    set of parents finalized since then: a hypha's old tip enters
    ``prev`` of its extension segment the step it stops being the tip
    (branch children carry prev = -1 and mask out; a hypha extends at
    most once per step, so the window holds no duplicates). Reading the
    window is one contiguous dynamic slice — no per-hypha gathers.

    Batches run in ``cfg.grid_update_cap`` chunks inside one bounded
    while_loop, which doubles as the resume path: a fresh grid over a
    checkpoint-loaded state inserts the whole backlog in the same code.

    Returns (grid', dropped) where ``dropped`` flags per-cell capacity
    overflow (candidates silently absent — surfaced via state.overflow
    like the full-rebuild path does).
    """
    N = st.capacity
    g, gz = grid_dims(cfg)
    C = cfg.max_per_cell
    GC = gz * C
    m_cells = g * g * gz
    U = int(cfg.grid_update_cap)
    dtype = st.start.dtype
    if sgeo_pad is None:
        sgeo_pad = jnp.concatenate(
            [jnp.concatenate([st.start, st.end], axis=1),
             jnp.zeros((1, 6), dtype)], axis=0)
    prev_pad = jnp.concatenate([st.prev, jnp.full((U,), -1, jnp.int32)])
    eps_len = jnp.asarray(1e-12, dtype)
    P = GC * g * g
    pos = jnp.arange(U, dtype=jnp.int32)

    def body(carry):
        ci, ids_f, a_f, ab_f, r_f, count, occ, dropped = carry
        base = grid.n_seen + ci * U
        rows = jax.lax.dynamic_slice_in_dim(prev_pad, base, U)
        valid = (base + pos < st.n_seg) & (rows >= 0)
        slot = jnp.where(valid, rows, N)
        geo = sgeo_pad[slot]                                  # (U, 6)
        mid = (geo[:, 0:3] + geo[:, 3:6]) * 0.5
        cell = jnp.where(valid, _cell_id(mid, cfg), m_cells)
        # rank allocation: in-batch rank by cell (argsort over U rows,
        # not N) + the cell's standing count
        order = jnp.argsort(cell)
        sc = cell[order]
        run_start = jnp.concatenate([jnp.ones((1,), bool),
                                     sc[1:] != sc[:-1]])
        first = jax.lax.cummax(jnp.where(run_start, pos, 0))
        brank = pos - first
        rank = count[jnp.minimum(sc, m_cells - 1)] + brank
        ok = (sc < m_cells) & (rank < C)
        dropped = dropped | jnp.any((sc < m_cells) & (rank >= C))
        cz = sc % gz
        cxy = sc // gz
        tgt = jnp.where(ok, ((rank * gz + cz) * g + cxy // g) * g
                        + cxy % g, P)
        geo_s = geo[order]
        ab3 = geo_s[:, 3:6] - geo_s[:, 0:3]
        ab2 = ab3[:, 0] ** 2 + ab3[:, 1] ** 2 + ab3[:, 2] ** 2
        r = jnp.where(ab2 < eps_len, 0.0,
                      1.0 / jnp.maximum(ab2, eps_len)).astype(dtype)
        ids_f = ids_f.at[tgt].set(slot[order], mode="drop")
        a_f = tuple(a_f[k].at[tgt].set(geo_s[:, k], mode="drop")
                    for k in range(3))
        ab_f = tuple(ab_f[k].at[tgt].set(ab3[:, k], mode="drop")
                     for k in range(3))
        r_f = r_f.at[tgt].set(r, mode="drop")
        count = count.at[jnp.where(ok, sc, m_cells)].add(1, mode="drop")
        occ = jnp.maximum(occ, jnp.max(jnp.where(ok, rank + 1, 0)))
        return ci + 1, ids_f, a_f, ab_f, r_f, count, occ, dropped

    init = (jnp.asarray(0, jnp.int32), grid.ids,
            tuple(grid.a), tuple(grid.ab),
            grid.r_ab2, grid.count, grid.occ,
            jnp.asarray(False))
    _, ids_f, a_f, ab_f, r_f, count, occ, dropped = jax.lax.while_loop(
        lambda c: grid.n_seen + c[0] * U < st.n_seg, body, init)
    out = grid._replace(
        ids=ids_f, a=tuple(a_f), ab=tuple(ab_f), r_ab2=r_f,
        count=count, occ=occ,
        n_seen=jnp.maximum(grid.n_seen, st.n_seg))
    return out, dropped


def point_segment_distance(p, a, b):
    """Batched point-to-segment distance + closest point
    (mycelium_sim_2D.py:114-128). p,a,b: (...,3)."""
    ap = p - a
    ab = b - a
    ab2 = jnp.sum(ab * ab, axis=-1)
    t = jnp.sum(ap * ab, axis=-1) / jnp.where(ab2 < 1e-12, 1.0, ab2)
    t = jnp.where(ab2 < 1e-12, 0.0, jnp.clip(t, 0.0, 1.0))
    proj = a + t[..., None] * ab
    dist = jnp.linalg.norm(p - proj, axis=-1)
    return dist, proj


def detect_anastomosis(st: GrowthState, cfg: GrowthConfig,
                       strategy: str | None = None) -> GrowthState:
    """Snap active tips onto nearby segments.

    Two query strategies over the same dense cell table (identical
    candidate sets -> identical snaps up to distance ties):
    - 'grid': roll the whole table for each neighbor offset; distances are
      computed for every cell whether or not it holds tips — more FLOPs,
      but gather-free;
    - 'window': gather each tip's 9 neighbor-cell windows — ~6x fewer
      distance evaluations.
    'window' is the default: on an H100 it measured 2-3x faster per
    growth step than 'grid' at the demo and medium presets (PERF.md).

    With cfg.grid_incremental the 'grid' candidate table is NOT rebuilt
    per step: finalized segments live in the persistent append-only
    SegGrid (st.grid, updated by one windowed insert batch) and the
    mutable tip segments in a per-step overlay bucketed over H hypha
    rows; the query folds both sources. Bit-equality with the full
    rebuild is tested over whole trajectories
    (test_growth_ops.py::test_incremental_grid_*).
    """
    if strategy is None:
        # the persistent grid IS the candidate table -> 'grid' everywhere;
        # an EXPLICIT strategy still wins (tests cross-check paths)
        strategy = "grid" if cfg.grid_incremental else "window"
    use_inc = bool(cfg.grid_incremental) and strategy == "grid"
    N, H = st.capacity, st.tip.shape[0]
    C = cfg.max_per_cell
    Ct = cfg.max_tips_per_cell
    g, gz = grid_dims(cfg)
    m_cells = g * g * gz
    dtype = st.start.dtype

    # ---- segment table: bucket by midpoint cell, gather packed geometry.
    # The z dimension is folded into the candidate axis (the z extent is a
    # couple of cells), so a query covers the full z column of each of the
    # 3x3 xy-neighbor cells — a superset of the reference's 3x3x3 query.
    # With cfg.grid_incremental the full rebucket is replaced by the
    # persistent SegGrid + a tip-segment overlay (built below).
    sgeo = jnp.concatenate([st.start, st.end], axis=1)        # (N, 6)
    sgeo_pad = jnp.concatenate([sgeo, jnp.zeros((1, 6), dtype)], axis=0)
    if not use_inc:
        alive = st.state != EMPTY
        mid = (st.start + st.end) * 0.5
        seg_cell = jnp.where(alive, _cell_id(mid, cfg), m_cells)
        seg_tbl, seg_dropped, seg_occ = _bucket(
            jnp.arange(N, dtype=jnp.int32), seg_cell, m_cells, C,
            sentinel=N)

    hyp_ids = jnp.arange(H, dtype=jnp.int32)
    t = jnp.maximum(st.tip, 0)
    tip_ok = (hyp_ids < st.n_hyp) & (st.tip >= 0) & (st.state[t] == ACTIVE)
    tge = sgeo[t]                                             # (H, 6)
    tip_end = tge[:, 3:6]                                     # (H, 3)

    big = jnp.asarray(jnp.inf, dtype)
    offs = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]

    def fold_offset(best, d, proj, cand_idx, self_slot):
        invalid = (cand_idx == self_slot) | (cand_idx >= N)
        d = jnp.where(invalid, big, d)
        dmin = jnp.min(d, axis=-1)
        # first-match one-hot select of the projection (take_along_axis
        # would be another per-row gather) — same cumsum-free reduction
        # form as the grid scan
        hit = d <= dmin[..., None]
        kk = jax.lax.broadcasted_iota(jnp.int32, d.shape, d.ndim - 1)
        kmin = jnp.min(jnp.where(hit, kk, d.shape[-1]), axis=-1)
        first = kk == kmin[..., None]
        pmin = jnp.sum(proj * first[..., None].astype(proj.dtype), axis=-2)
        best_d, best_proj = best
        better = dmin < best_d
        return (jnp.where(better, dmin, best_d),
                jnp.where(better[..., None], pmin, best_proj))

    if strategy == "grid":
        # Dense-grid query, shaped by four rules:
        # 1. CORNER WINDOW: candidates within anastomosis_tol of a tip
        #    have midpoints within reach = (h0+tol)/2 + tol of it, and
        #    reach < voxel/2 — so bucketing TIPS by their nearest grid
        #    CORNER makes the exact search window the 2x2 cell block
        #    around that corner: 4 offsets instead of the reference's 3x3
        #    (falls back to 9 cell-bucketed offsets if a config breaks
        #    the reach bound).
        # 2. Per offset the small TIP planes are rolled, never the
        #    segment geometry (7 planes, 4x larger).
        # 3. All per-item axes are MAJOR dims — planes are (slot, g, g),
        #    so the big (g,g) face is contiguous and chunk slicing never
        #    cuts it (minor dims of 3/64 force padded layouts, as in the
        #    tree-PC block algebra, fea/tree_jax.py).
        # 4. Trip counts of the chunk loops are bounded by the MEASURED
        #    max occupancy (lax.while_loop with a dynamic bound), so the
        #    static caps C/Ct only size memory.
        # The scan carries (distance, segment parameter tt, winner slot)
        # and the winning projection is recomputed once per hypha after
        # the scan — one H-row gather instead of three carried planes.
        GC = gz * C
        GT = gz * Ct
        eps_len = jnp.asarray(1e-12, dtype)

        def chunk_of(cap, want=16):
            # finer chunks track the measured occupancy tighter: the trip
            # bound ceil(occ/K)*K overshoots occ by up to K-1 planes
            K = min(want, cap)
            while cap % K:
                K -= 1
            return K

        def gather_source(ids_grid, occ, cap, want=16):
            """Build one candidate source from a plane-layout id table:
            occupancy-bounded geometry pregather (only occupied chunks
            are gathered; unvisited chunks stay zero, excluded by the
            ids>=N mask in the scan) + offset-independent per-candidate
            precompute (direction, inverse squared length — segment
            planes are never rolled)."""
            K = chunk_of(cap, want)
            n_sc = jnp.minimum((occ * gz + K - 1) // K,
                               cap // K).astype(jnp.int32)

            def pre_body(carry):
                pc, bufs = carry
                ids_c = jax.lax.dynamic_slice_in_dim(ids_grid, pc * K, K,
                                                     axis=0)
                geo = sgeo_pad[ids_c]                         # (K,g,g,6)
                bufs = tuple(
                    jax.lax.dynamic_update_slice_in_dim(
                        bufs[k], geo[..., k], pc * K, axis=0)
                    for k in range(6))
                return pc + 1, bufs

            _, segp_t = jax.lax.while_loop(
                lambda cy_: cy_[0] < n_sc, pre_body,
                (jnp.asarray(0, jnp.int32),
                 tuple(jnp.zeros((cap, g, g), dtype) for _ in range(6))))
            segp = list(segp_t)
            ab = [segp[3 + k] - segp[k] for k in range(3)]
            ab2 = ab[0] * ab[0] + ab[1] * ab[1] + ab[2] * ab[2]
            r_ab2 = jnp.where(ab2 < eps_len, 0.0,
                              1.0 / jnp.maximum(ab2, eps_len))
            return (segp[:3], ab, r_ab2, ids_grid, n_sc, K)

        grid_new = st.grid
        if use_inc:
            # persistent source: finalized segments, query-ready planes —
            # no per-step gather at all; mutable tip segments ride a
            # per-step overlay table built over H hypha rows, not N slots
            if st.grid is None:
                raise ValueError(
                    "cfg.grid_incremental needs st.grid — thread the "
                    "state through state.ensure_grid / init_state")
            grid_new, ins_dropped = grid_insert_finalized(
                st.grid, st, cfg, sgeo_pad)
            Kp = chunk_of(GC, 8)
            n_sc_p = jnp.minimum((grid_new.occ * gz + Kp - 1) // Kp,
                                 GC // Kp).astype(jnp.int32)
            # flat -> (GC, g, g) views: contiguous reshape, no copy
            sources = [([grid_new.a[k].reshape(GC, g, g) for k in range(3)],
                        [grid_new.ab[k].reshape(GC, g, g) for k in range(3)],
                        grid_new.r_ab2.reshape(GC, g, g),
                        grid_new.ids.reshape(GC, g, g), n_sc_p, Kp)]
            # overlay capacity = max_per_cell (not the tip-END cap): tip
            # SEGMENT midpoints cluster like segments, not like corner-
            # bucketed tips, and Ct=16 drops candidates at dense inoculum
            # sites. The scan is bounded by measured occupancy, so the
            # wider table costs memory only.
            GO = gz * C
            tip_seg_ok = (hyp_ids < st.n_hyp) & (st.tip >= 0)
            mid_t = (tge[:, 0:3] + tip_end) * 0.5
            ov_cell = jnp.where(tip_seg_ok, _cell_id(mid_t, cfg), m_cells)
            ov_tbl, ov_dropped, ov_occ = _bucket(
                t, ov_cell, m_cells, C, sentinel=N)
            ov_ids = ov_tbl.reshape(g, g, gz, C) \
                .transpose(3, 2, 0, 1).reshape(GO, g, g)
            sources.append(gather_source(ov_ids, ov_occ, GO, want=4))
            seg_dropped = ov_dropped + ins_dropped.astype(ov_dropped.dtype)
        else:
            # slot-major candidate axis: position = slot*gz + z, so
            # occupied entries form a prefix of length occ*gz in every
            # (x,y) column
            idx_grid = seg_tbl.reshape(g, g, gz, C) \
                .transpose(3, 2, 0, 1).reshape(GC, g, g)
            sources = [gather_source(idx_grid, seg_occ, GC)]

        reach = (cfg.h0 + cfg.anastomosis_tol) * 0.5 + cfg.anastomosis_tol
        corner_window = reach <= cfg.voxel_size * 0.5
        if corner_window:
            # nearest-corner bucket in x,y (z stays cell-folded)
            c = jnp.floor(tip_end / cfg.voxel_size + 0.5).astype(jnp.int32)
            cx = jnp.clip(c[..., 0] + g // 2, 0, g - 1)
            cy = jnp.clip(c[..., 1] + g // 2, 0, g - 1)
            _, _, cz = cell_coords(tip_end, cfg)
            tip_bucket = (cx * g + cy) * gz + cz
            grid_offs = [(-1, -1), (-1, 0), (0, -1), (0, 0)]
        else:
            tip_bucket = _cell_id(tip_end, cfg)
            grid_offs = offs
        tip_cell = jnp.where(tip_ok, tip_bucket, m_cells)
        tip_tbl, tip_dropped, tip_occ, tip_pos = _bucket(
            t, tip_cell, m_cells, Ct, sentinel=N,
            want_pos=True)                                    # seg slots
        tslot = tip_tbl.reshape(g, g, gz, Ct) \
            .transpose(3, 2, 0, 1).reshape(GT, g, g)
        # tip geometry table by ONE H-row scatter through tip_pos instead
        # of a (GT·g·g)-row gather at every table cell. Empty table slots
        # stay zero exactly like a gathered sentinel row would.
        tbl3 = jnp.zeros((m_cells * Ct + 1, 3), dtype) \
            .at[tip_pos].set(tip_end, mode="drop")
        tip_flat = tbl3[:m_cells * Ct].reshape(g, g, gz, Ct, 3) \
            .transpose(3, 2, 0, 1, 4).reshape(GT, g, g, 3)
        tpp = [tip_flat[..., k] for k in range(3)]            # (GT,g,g)

        # ONE tip plane per chunk: corner-bucket occupancy is heterogeneous
        # (a few tips per cell on average, several times that at the
        # busiest), so Kt=1 makes the trip bound exact in occ
        Kt = 1
        n_tc = jnp.minimum(tip_occ * gz, GT).astype(jnp.int32)

        best_d2 = jnp.full((GT, g, g), big)
        best_tt = jnp.zeros((GT, g, g), dtype)
        best_id = jnp.full((GT, g, g), N, jnp.int32)

        def make_seg_scan(src):
            """Chunked distance scan over one candidate source (the
            persistent grid and the tip overlay fold the same way)."""
            aP, abP, rP, idsP, n_scP, Ks = src

            def seg_body(carry, tpc, tsl):
                sc, b_d2, b_tt, b_id = carry
                sl_a = [jax.lax.dynamic_slice_in_dim(
                    aP[k], sc * Ks, Ks, axis=0)[None]
                        for k in range(3)]                    # (1,K,g,g)
                sl_ab = [jax.lax.dynamic_slice_in_dim(
                    abP[k], sc * Ks, Ks, axis=0)[None]
                         for k in range(3)]
                sl_r = jax.lax.dynamic_slice_in_dim(rP, sc * Ks, Ks,
                                                    axis=0)[None]
                ids = jax.lax.dynamic_slice_in_dim(idsP, sc * Ks, Ks,
                                                   axis=0)[None]
                ap = [tpc[k][:, None] - sl_a[k] for k in range(3)]
                apab = (ap[0] * sl_ab[0] + ap[1] * sl_ab[1]
                        + ap[2] * sl_ab[2])
                tt = jnp.clip(apab * sl_r, 0.0, 1.0)          # (Kt,K,g,g)
                e = [ap[k] - tt * sl_ab[k] for k in range(3)]
                d2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
                invalid = (ids == tsl[:, None]) | (ids >= N)
                d2 = jnp.where(invalid, big, d2)
                dmin = jnp.min(d2, axis=1)                    # (Kt,g,g)
                # first-match one-hot select of the projection — no
                # gather, and no cumsum: a cumsum along the candidate
                # axis is a serial scan XLA cannot fuse into this body,
                # so every (Kt,K,g,g) intermediate would go through
                # device memory. Two fusable reductions pick the same
                # winner (smallest candidate index among the distance
                # ties).
                hit = d2 <= dmin[:, None]
                kk = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
                kmin = jnp.min(jnp.where(hit, kk, d2.shape[1]), axis=1)
                first = kk == kmin[:, None]
                # carry the winner's segment PARAMETER + slot id instead
                # of its projection point: the projection is recomputed
                # once per hypha after the scan (one H-row gather) from
                # the same a/ab/tt values, bit-identical in f32 — saves
                # three (Kt,K,g,g) product-sums here and one full result
                # plane through every chunk/offset merge
                tt_w = jnp.sum(tt * first.astype(dtype), axis=1)
                id_w = jnp.sum(jnp.where(first, ids, 0), axis=1,
                               dtype=jnp.int32)
                better = dmin < b_d2
                return (sc + 1,
                        jnp.where(better, dmin, b_d2),
                        jnp.where(better, tt_w, b_tt),
                        jnp.where(better, id_w, b_id))

            def run(tpc, tsl, best):
                init = (jnp.asarray(0, jnp.int32),) + best
                out = jax.lax.while_loop(
                    lambda cy_: cy_[0] < n_scP,
                    lambda cy_: seg_body(cy_, tpc, tsl), init)
                return out[1:]

            return run

        seg_scans = [make_seg_scan(src) for src in sources]
        for dx, dy in grid_offs:
            # roll tips by +(dx,dy): at grid index m the pair is
            # (tip bucket m-(dx,dy)) vs (segment cell m)
            rtp = [jnp.roll(p, (dx, dy), axis=(1, 2)) for p in tpp]
            rts = jnp.roll(tslot, (dx, dy), axis=(1, 2))

            def tip_body(carry):
                tc, d2b, ttb, idb = carry
                tpc = [jax.lax.dynamic_slice_in_dim(p, tc * Kt, Kt, axis=0)
                       for p in rtp]                          # (Kt,g,g)
                tsl = jax.lax.dynamic_slice_in_dim(rts, tc * Kt, Kt,
                                                   axis=0)
                best = (jnp.full((Kt, g, g), big),
                        jnp.zeros((Kt, g, g), dtype),
                        jnp.full((Kt, g, g), N, jnp.int32))
                for run_scan in seg_scans:
                    best = run_scan(tpc, tsl, best)
                bd2, btt, bid = best
                upd = jax.lax.dynamic_update_slice_in_dim
                return (tc + 1, upd(d2b, bd2, tc * Kt, axis=0),
                        upd(ttb, btt, tc * Kt, axis=0),
                        upd(idb, bid, tc * Kt, axis=0))

            o_init = (jnp.asarray(0, n_tc.dtype), jnp.full((GT, g, g), big),
                      jnp.zeros((GT, g, g), dtype),
                      jnp.full((GT, g, g), N, jnp.int32))
            _, od2, ott, oid = jax.lax.while_loop(
                lambda cy_: cy_[0] < n_tc, tip_body, o_init)
            # roll results back to unrolled tip-bucket space and merge
            od2 = jnp.roll(od2, (-dx, -dy), axis=(1, 2))
            ott = jnp.roll(ott, (-dx, -dy), axis=(1, 2))
            oid = jnp.roll(oid, (-dx, -dy), axis=(1, 2))
            better = od2 < best_d2
            best_d2 = jnp.where(better, od2, best_d2)
            best_tt = jnp.where(better, ott, best_tt)
            best_id = jnp.where(better, oid, best_id)

        # ---- pull per-HYPHA results out of the table space: the results
        # live in (GT,g,g) planes; four H-row gathers + H-row scatters
        # replace a scatter of snaps through the whole table space.
        # Flat plane index of hypha h's tip: tip_pos = cell*Ct + rank with
        # cell = (cx*g + cy)*gz + cz  ->  ((rank*gz + cz)*g + cx)*g + cy.
        cell_h = tip_pos // Ct
        rank_h = tip_pos - cell_h * Ct
        cz_h = cell_h % gz
        cxy_h = cell_h // gz
        pos_h = (rank_h * gz + cz_h) * (g * g) + cxy_h
        in_tbl = tip_pos < m_cells * Ct
        pos_c = jnp.minimum(pos_h, GT * g * g - 1)
        d_h = jnp.sqrt(best_d2.reshape(-1)[pos_c])            # (H,)
        tt_h = best_tt.reshape(-1)[pos_c]
        id_h = best_id.reshape(-1)[pos_c]
        # recompute the winner's projection from its slot geometry: same
        # a, ab = end - start, and tt values the scan used (the grid
        # stores ab computed exactly this way at insert), so the f32
        # projection is bit-identical to the old in-scan select
        geo_h = sgeo_pad[jnp.minimum(id_h, N)]                # (H, 6)
        proj_h = geo_h[:, 0:3] + tt_h[:, None] \
            * (geo_h[:, 3:6] - geo_h[:, 0:3])                 # (H, 3)
        flat_slot = jnp.where(in_tbl & tip_ok, t, N)
        flat_d = jnp.where(in_tbl, d_h, big)
        flat_proj = proj_h
        snap = (flat_slot < N) & (flat_d <= cfg.anastomosis_tol)
        n_dropped = seg_dropped + tip_dropped
    else:
        # per-tip windows gathered from the dense table
        grid_new = st.grid
        tbl_cols = seg_tbl.reshape(g * g, gz * C)
        cx, cy, _ = cell_coords(tip_end, cfg)
        best = (jnp.full((H,), big), jnp.zeros((H, 3), dtype))
        for dx, dy in offs:
            nx = jnp.clip(cx + dx, 0, g - 1)
            ny = jnp.clip(cy + dy, 0, g - 1)
            cand = tbl_cols[nx * g + ny]                      # (H, gz*C)
            geo = sgeo_pad[cand]                              # (H, gz*C, 6)
            d, proj = point_segment_distance(
                tip_end[:, None, :], geo[..., 0:3], geo[..., 3:6])
            best = fold_offset(best, d, proj, cand, t[:, None])
        flat_slot = jnp.where(tip_ok, t, N)
        flat_d = best[0]
        flat_proj = best[1]
        snap = tip_ok & (flat_d <= cfg.anastomosis_tol)
        n_dropped = seg_dropped

    # ---- scatter snaps back to tip segment slots (per coordinate plane:
    # three scalar scatters instead of one width-3 row scatter)
    idx = jnp.where(snap, flat_slot, N)
    end = jnp.stack(
        [st.end[:, k].at[idx].set(flat_proj[:, k], mode="drop")
         for k in range(3)], axis=1)
    state = st.state.at[idx].set(ANASTOMOSED, mode="drop")
    # cell-capacity overflow dropped candidates from the query: surface it
    # through the same flag as slot-capacity exhaustion (drivers warn).
    # NOTE the snap above mutates st.end of a TIP slot only — the
    # persistent grid (finalized segments) cannot go stale from it; the
    # new end is seen next step through the rebuilt tip overlay.
    return st._replace(end=end, state=state, grid=grid_new,
                       overflow=st.overflow | (n_dropped > 0))
