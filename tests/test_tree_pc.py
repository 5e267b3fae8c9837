"""Spanning-forest preconditioner: schedule, numpy oracle, device port.

Validates (a) the numpy factor/apply against scipy splu of the BC'd tree
matrix, (b) the JAX implementation against the numpy oracle, (c) the
iteration-count win and solution parity inside the full solver.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from mycelium_tpu import scenes
from mycelium_tpu.config import FeaConfig
from mycelium_tpu.fea import tree as tr
from mycelium_tpu.fea import tree_jax as trj
from mycelium_tpu.fea.assemble import assemble_scipy
from mycelium_tpu.fea.model import build_model
from mycelium_tpu.fea.solve import solve_displacement


def random_forest_mesh(n_nodes=600, n_extra=12, seed=0):
    """Random mycelium-like mesh: chains that branch, plus a few
    cycle-closing edges (the anastomosis analogue)."""
    rng = np.random.default_rng(seed)
    coords = [np.zeros(3)]
    conn = []
    while len(coords) < n_nodes:
        start = int(rng.integers(0, len(coords)))
        phi = rng.uniform(0, 2 * np.pi)
        pos = coords[start].copy()
        prev = start
        for _ in range(int(rng.integers(2, 14))):
            if len(coords) >= n_nodes:
                break
            phi += rng.uniform(-0.4, 0.4)
            pos = pos + np.array([np.cos(phi), np.sin(phi), 0.0]) * 0.05
            coords.append(pos)
            conn.append([prev, len(coords) - 1])
            prev = len(coords) - 1
    for _ in range(n_extra):
        a, b = rng.integers(0, n_nodes, 2)
        if a != b:
            conn.append([a, b])
    return np.asarray(coords), np.asarray(conn, np.int32)


def bc_tree_matrix(model, sch, active, free, reg):
    """Oracle matrix: forest-only stiffness with pinned rows/cols set to
    identity and reg on the free diagonal."""
    Kt = assemble_scipy(model, active & sch.tree_edge).tolil()
    fd = np.repeat(free, 3)
    Kt[~fd, :] = 0.0
    Kt[:, ~fd] = 0.0
    for i in np.nonzero(~fd)[0]:
        Kt[i, i] = 1.0
    return (Kt.tocsr() + reg * sp.diags(fd.astype(float))).tocsc()


@pytest.mark.parametrize("seed,frac", [(0, None), (1, 0.06), (2, 0.2)])
def test_numpy_factor_apply_matches_splu(seed, frac):
    coords, conn = random_forest_mesh(seed=seed)
    cfg = FeaConfig(dtype="float64", operator="ell", grip_length=0.08)
    model = build_model(coords, conn, cfg)
    N = model.n_nodes
    conn_np = np.asarray(model.conn)
    free = ~(np.asarray(model.top_nodes) | np.asarray(model.bot_nodes))
    rng = np.random.default_rng(seed)
    active = np.ones(model.n_elems, bool) if frac is None else \
        rng.random(model.n_elems) > frac

    sch = tr.build_tree_schedule(conn_np, N, free)
    k3 = tr.element_k3(np.asarray(model.geom.n, np.float64),
                       np.asarray(model.geom.k_ax, np.float64),
                       np.asarray(model.geom.k_bd, np.float64))
    reg_pc = max(cfg.reg, cfg.tree_reg_rel * float(
        np.median(np.trace(k3, axis1=1, axis2=2) / 3.0)))
    fac = tr.tree_factor_np(sch, k3, active, free, reg_pc)

    r = rng.standard_normal((N, 3))
    r[~free] = 0.0
    z = tr.tree_apply_np(fac, r)
    T = bc_tree_matrix(model, sch, active, free, reg_pc)
    z_ref = spla.spsolve(T, r.reshape(-1))
    # heavily fractured meshes have components held only by reg=1e-12, so
    # compare by residual (the well-posed criterion), not by value
    res = np.linalg.norm(T @ z.reshape(-1) - r.reshape(-1))
    res_ref = np.linalg.norm(T @ z_ref - r.reshape(-1))
    rnorm = np.linalg.norm(r)
    assert res <= max(10 * res_ref, 1e-9 * rnorm)


@pytest.mark.parametrize("seed,frac,anchor_frac",
                         [(0, None, 0.0), (1, 0.08, 0.0), (3, 0.1, 0.05)])
def test_jax_matches_numpy_oracle(seed, frac, anchor_frac):
    coords, conn = random_forest_mesh(seed=seed)
    cfg = FeaConfig(dtype="float64", operator="ell", grip_length=0.08, precond="tree")
    model = build_model(coords, conn, cfg)
    N = model.n_nodes
    conn_np = np.asarray(model.conn)
    free = ~(np.asarray(model.top_nodes) | np.asarray(model.bot_nodes))
    rng = np.random.default_rng(seed + 100)
    active = np.ones(model.n_elems, bool) if frac is None else \
        rng.random(model.n_elems) > frac
    free_now = free.copy()
    if anchor_frac:
        free_now &= rng.random(N) > anchor_frac   # extra numeric pinning

    sch = tr.build_tree_schedule(conn_np, N, free)
    k3 = tr.element_k3(np.asarray(model.geom.n, np.float64),
                       np.asarray(model.geom.k_ax, np.float64),
                       np.asarray(model.geom.k_bd, np.float64))
    reg_pc = max(cfg.reg, cfg.tree_reg_rel * model.tree.meta.k_scale)
    fac_np = tr.tree_factor_np(sch, k3, active, free_now, reg_pc)

    fac = trj.tree_factor(model.tree, jnp.asarray(active),
                          jnp.asarray(free_now), reg_pc, model.conn)
    r = rng.standard_normal((N, 3))
    r[~free_now] = 0.0
    z_np = tr.tree_apply_np(fac_np, r)
    z = np.asarray(trj.tree_apply(model.tree, fac, jnp.asarray(r)))
    if frac is None and not anchor_frac:
        # intact forest: both exact solvers agree to roundoff
        np.testing.assert_allclose(z, z_np, rtol=1e-8, atol=1e-12)
    # always: the device result solves the tree system (residual check is
    # the well-posed criterion when fracture leaves reg-held fragments)
    T = bc_tree_matrix(model, sch, active, free_now, reg_pc)
    res = np.linalg.norm(T @ z.reshape(-1) - r.reshape(-1))
    res_np = np.linalg.norm(T @ z_np.reshape(-1) - r.reshape(-1))
    # PCR loses a few more digits than splu through reg-floored fracture
    # fragments; 1e-5 relative residual is far below what perturbs CG
    assert res <= max(10 * res_np, 1e-5 * np.linalg.norm(r))


def test_tree_pc_cuts_iterations_and_matches_solution():
    coords, conn = random_forest_mesh(n_nodes=900, n_extra=18, seed=4)
    base = dict(dtype="float64", operator="chain",
                grip_length=0.1, rtol=1e-8)
    cfg_bj = FeaConfig(precond="block_jacobi", **base)
    cfg_tr = FeaConfig(precond="tree", **base)
    model_bj = build_model(coords, conn, cfg_bj)
    model_tr = build_model(coords, conn, cfg_tr)
    active = jnp.ones((model_bj.n_elems,), bool)
    x0 = jnp.zeros((model_bj.n_nodes, 3), jnp.float64)
    res_bj = solve_displacement(model_bj, active, 0.01, -0.01, x0, cfg_bj)
    res_tr = solve_displacement(model_tr, active, 0.01, -0.01, x0, cfg_tr)
    assert bool(res_bj.converged) and bool(res_tr.converged)
    assert int(res_tr.iters) < int(res_bj.iters) / 5
    np.testing.assert_allclose(np.asarray(res_tr.x), np.asarray(res_bj.x),
                               rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("scene_name", list(scenes.SCENES))
def test_tree_pc_on_fully_gripped_scenes(scene_name):
    """The archived test scenes are fully gripped (no free nodes) — the
    tree PC must degenerate gracefully to the identity."""
    sc = scenes.SCENES[scene_name]()
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree")
    model = build_model(sc.coords, sc.conn, cfg)
    active = jnp.ones((model.n_elems,), bool)
    x0 = jnp.zeros((model.n_nodes, 3), jnp.float64)
    res = solve_displacement(model, active, 0.01, -0.01, x0, cfg)
    assert bool(res.converged)


def test_tree_plus_coarse_weight_matches_tree_solution():
    """tree_coarse_weight only changes the CG path, not the solution."""
    import dataclasses
    import jax.numpy as jnp
    from mycelium_tpu.fea.ramp import anchored_mask_host
    from mycelium_tpu.fea.solve import solve_displacement

    coords, conn = random_forest_mesh(n_nodes=300, n_extra=12, seed=5)
    base = FeaConfig(dtype="float64", rtol=1e-11, operator="chain",
                     precond="tree", warm_start=False, grip_length=0.1)
    m = build_model(coords, conn, base)
    grip = np.asarray(m.top_nodes) | np.asarray(m.bot_nodes)
    anch = jnp.asarray(anchored_mask_host(
        np.asarray(m.conn), np.ones(m.n_elems, bool), grip))
    act = jnp.ones((m.n_elems,), bool)
    x0 = jnp.zeros((m.n_nodes, 3))
    ref = solve_displacement(m, act, 0.01, -0.01, x0, base, anch)
    cfg = dataclasses.replace(base, tree_coarse_weight=0.25)
    res = solve_displacement(m, act, 0.01, -0.01, x0, cfg, anch)
    assert bool(res.converged)
    scale = max(float(jnp.abs(ref.x).max()), 1e-30)
    assert float(jnp.abs(res.x - ref.x).max()) / scale < 1e-7


@pytest.mark.parametrize("cap", [6, 9])
def test_coarse_wide_clusters_same_solution(cap):
    """coarse_max_dim widens clusters to kblk consecutive 128-blocks so
    the dense coarse operator stays bounded at large n (the uncapped
    inverse grows as 3n/128 — 330k-node meshes need kblk>1). The
    correction is a pure
    preconditioner: wide-cluster solves must reproduce the tree-only
    solution, for both the additive tree+coarse PC and the standalone
    'coarse' PC."""
    import dataclasses
    import jax.numpy as jnp
    from mycelium_tpu.fea.coarse import coarse_cluster_blocks, plan_nb
    from mycelium_tpu.fea.ramp import anchored_mask_host
    from mycelium_tpu.fea.solve import solve_displacement

    coords, conn = random_forest_mesh(n_nodes=600, n_extra=12, seed=11)
    base = FeaConfig(dtype="float64", rtol=1e-11, operator="chain",
                     precond="tree", warm_start=False, grip_length=0.1)
    m = build_model(coords, conn, base)
    grip = np.asarray(m.top_nodes) | np.asarray(m.bot_nodes)
    anch = jnp.asarray(anchored_mask_host(
        np.asarray(m.conn), np.ones(m.n_elems, bool), grip))
    act = jnp.ones((m.n_elems,), bool)
    x0 = jnp.zeros((m.n_nodes, 3))
    ref = solve_displacement(m, act, 0.01, -0.01, x0, base, anch)
    scale = max(float(jnp.abs(ref.x).max()), 1e-30)

    wide = dataclasses.replace(base, coarse_max_dim=cap)
    assert coarse_cluster_blocks(plan_nb(m.n_nodes), wide) > 1, \
        "cap did not widen the clusters — test is vacuous"

    res = solve_displacement(m, act, 0.01, -0.01, x0,
                             dataclasses.replace(wide,
                                                 tree_coarse_weight=0.25),
                             anch)
    assert bool(res.converged)
    assert float(jnp.abs(res.x - ref.x).max()) / scale < 1e-7

    resc = solve_displacement(
        m, act, 0.01, -0.01, x0,
        dataclasses.replace(wide, precond="coarse", rtol=1e-11), anch)
    assert bool(resc.converged)
    assert float(jnp.abs(resc.x - ref.x).max()) / scale < 1e-7


@pytest.mark.parametrize("max_len", [4, 16])
def test_split_schedule_matches_unbounded(max_len):
    """max_path_len chops long paths by demoting cut nodes to the next
    level (two-level cyclic reduction); the factorization stays EXACT —
    apply through the split schedule must solve the same tree system."""
    coords, conn = random_forest_mesh(seed=7)
    cfg = FeaConfig(dtype="float64", operator="ell", grip_length=0.08, precond="tree")
    model = build_model(coords, conn, cfg)
    N = model.n_nodes
    conn_np = np.asarray(model.conn)
    free = ~(np.asarray(model.top_nodes) | np.asarray(model.bot_nodes))
    sch = tr.build_tree_schedule(conn_np, N, free, max_path_len=max_len)
    for lv in sch.levels:
        lens = lv.last_pos - lv.first_pos + 1
        assert lens.max() <= max_len
    # every free node eliminated exactly once
    all_slots = np.concatenate([lv.slots for lv in sch.levels])
    assert sorted(all_slots.tolist()) == sorted(np.nonzero(free)[0].tolist())
    k3 = tr.element_k3(np.asarray(model.geom.n, np.float64),
                       np.asarray(model.geom.k_ax, np.float64),
                       np.asarray(model.geom.k_bd, np.float64))
    active = np.ones(model.n_elems, bool)
    reg_pc = 1e-9
    fac = tr.tree_factor_np(sch, k3, active, free, reg_pc)
    rng = np.random.default_rng(max_len)
    r = rng.standard_normal((N, 3))
    r[~free] = 0.0
    z = tr.tree_apply_np(fac, r)
    T = bc_tree_matrix(model, sch, active, free, reg_pc)
    res = np.linalg.norm(T @ z.reshape(-1) - r.reshape(-1))
    assert res <= 1e-8 * np.linalg.norm(r)


@pytest.mark.parametrize("cap", [0, 32, 10 ** 6])
def test_dense_tail_apply_matches_pure_pcr(cap):
    """The dense junction-Schur tail (tree_dense_tail) is an exact
    re-grouping of the trailing elimination levels: pure PCR (cap=0),
    mixed PCR+dense (cap=32), and pure dense (cap=1e6) must all solve the
    same tree system to roundoff."""
    import dataclasses
    coords, conn = random_forest_mesh(n_nodes=500, n_extra=10, seed=9)
    base = FeaConfig(dtype="float64", operator="chain",  grip_length=0.08, precond="tree", tree_dense_tail=0)
    m0 = build_model(coords, conn, base)
    mc = build_model(coords, conn,
                     dataclasses.replace(base, tree_dense_tail=cap))
    L = len(mc.tree.meta.level_steps)
    n_pcr = trj.n_pcr_levels(mc.tree.meta)
    if cap == 0:
        assert n_pcr == L
    elif cap == 32:
        assert 0 < n_pcr < L       # genuinely mixed
    else:
        assert n_pcr == 0          # pure dense
    N = m0.n_nodes
    rng = np.random.default_rng(9)
    free = ~(np.asarray(m0.top_nodes) | np.asarray(m0.bot_nodes))
    active = jnp.asarray(rng.random(m0.n_elems) > 0.05)
    reg = jnp.asarray(1e-9)
    r = rng.standard_normal((N, 3))
    r[~free] = 0.0
    f0 = trj.tree_factor(m0.tree, active, jnp.asarray(free), reg, m0.conn)
    fc = trj.tree_factor(mc.tree, active, jnp.asarray(free), reg, mc.conn)
    z0 = np.asarray(trj.tree_apply(m0.tree, f0, jnp.asarray(r)))
    zc = np.asarray(trj.tree_apply(mc.tree, fc, jnp.asarray(r)))
    np.testing.assert_allclose(zc, z0, rtol=1e-7, atol=1e-12)
    # and the fast (chain-space) variant agrees under the same cap
    free_chain = jnp.asarray(free)[mc.chain.perm]
    ff = trj.tree_factor_fast(mc.tree, mc.tree_fast, mc.chain, active,
                              jnp.asarray(free), free_chain, reg, mc.conn)
    perm = np.asarray(mc.chain.perm)
    z_chain = np.asarray(trj.tree_apply_chain(mc.tree, ff,
                                              jnp.asarray(r[perm])))
    np.testing.assert_allclose(z_chain, zc[perm], rtol=1e-7, atol=1e-12)


def test_fast_factor_matches_generic():
    """tree_factor_fast (gather-free, unified ordering) must produce the
    same factorization as tree_factor, including under fracture and extra
    anchoring pins, and tree_apply_chain must equal tree_apply through the
    chain permutation."""
    import mycelium_tpu.fea.tree_jax as trj2
    coords, conn = random_forest_mesh(seed=5)
    cfg = FeaConfig(dtype="float64", operator="chain", grip_length=0.08, precond="tree")
    model = build_model(coords, conn, cfg)
    assert model.tree_fast is not None
    N = model.n_nodes
    rng = np.random.default_rng(55)
    free0 = ~(np.asarray(model.top_nodes) | np.asarray(model.bot_nodes))
    for frac, pin in ((0.0, 0.0), (0.1, 0.05)):
        active = jnp.asarray(rng.random(model.n_elems) > frac)
        free_now = free0 & (rng.random(N) > pin)
        free_j = jnp.asarray(free_now)
        reg = jnp.asarray(1e-9)
        f_ref = trj2.tree_factor(model.tree, active, free_j, reg,
                                 model.conn)
        free_chain = free_j[model.chain.perm]
        f_fast = trj2.tree_factor_fast(model.tree, model.tree_fast,
                                       model.chain, active, free_j,
                                       free_chain, reg, model.conn)
        import jax as _jax
        # rtol covers the dense-tail sinv leaf too: jnp.linalg.inv
        # amplifies the two assemblies' scatter-order roundoff ~1e-10
        for a, b in zip(_jax.tree_util.tree_leaves(f_ref),
                        _jax.tree_util.tree_leaves(f_fast)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-8, atol=1e-18)
        # apply equivalence in chain space
        r = rng.standard_normal((N, 3))
        z_node = trj2.tree_apply(model.tree, f_ref, jnp.asarray(r))
        perm = np.asarray(model.chain.perm)
        z_chain = trj2.tree_apply_chain(model.tree, f_fast,
                                        jnp.asarray(r[perm]))
        np.testing.assert_allclose(np.asarray(z_chain),
                                   np.asarray(z_node)[perm],
                                   rtol=1e-10, atol=1e-16)


@pytest.mark.parametrize("seed,mpl,grip", [(0, 0, 0.1), (1, 16, 0.1),
                                           (2, 128, 0.3), (3, 64, 0.02)])
def test_native_peel_matches_python(seed, mpl, grip):
    """The C++ schedule peel (native/meshio.cpp meshio_tree_peel) must be
    array-for-array identical to the python walk it replaces — every
    TreeLevel field, every level, including fill ids, attachment
    orientation flags and the max_path_len demotion structure."""
    from mycelium_tpu.native import meshio_native
    if not meshio_native.available():
        pytest.skip("native library unavailable")
    coords, conn = random_forest_mesh(n_nodes=900, n_extra=25, seed=seed)
    n = coords.shape[0]
    rng = np.random.default_rng(seed)
    free = rng.random(n) > grip
    a = tr.build_tree_schedule(conn, n, free, max_path_len=mpl,
                               use_native=True)
    b = tr.build_tree_schedule(conn, n, free, max_path_len=mpl,
                               use_native=False)
    assert a.n_fill == b.n_fill
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        for f in la._fields:
            va, vb = np.asarray(getattr(la, f)), np.asarray(getattr(lb, f))
            assert va.shape == vb.shape, f
            assert np.array_equal(va, vb), f


def test_native_peel_matches_python_grip_bands():
    """Same equality on a larger mesh with CONTIGUOUS y-band grips (the
    build_model pattern): gripped bands cut hyphae into free fragments,
    a different peel structure than random free masks."""
    from mycelium_tpu.native import meshio_native
    if not meshio_native.available():
        pytest.skip("native library unavailable")
    coords, conn = random_forest_mesh(n_nodes=4000, n_extra=80, seed=7)
    n = coords.shape[0]
    y = coords[:, 1]
    ext = y.max() - y.min()
    free = (y > y.min() + 0.25 * ext) & (y < y.max() - 0.25 * ext)
    a = tr.build_tree_schedule(conn, n, free, max_path_len=128,
                               use_native=True)
    b = tr.build_tree_schedule(conn, n, free, max_path_len=128,
                               use_native=False)
    assert a.n_fill == b.n_fill and len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        for f in la._fields:
            assert np.array_equal(np.asarray(getattr(la, f)),
                                  np.asarray(getattr(lb, f))), f
