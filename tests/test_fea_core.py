"""Unit tests for the FEA core: element stiffness, operator equivalence,
assembly, preconditioner, and solver correctness against SciPy oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.sparse import csr_matrix, identity
from scipy.sparse.linalg import spsolve

from mycelium_tpu import scenes
from mycelium_tpu.config import FeaConfig, archive_parity_config
from mycelium_tpu.fea import build_model
from mycelium_tpu.fea.assemble import (assemble_dense, assemble_scipy,
                                       coo_indices)
from mycelium_tpu.fea.bc import bc_operator, bc_rhs, prescribed_values
from mycelium_tpu.fea.elements import (element_geometry,
                                       element_stiffness_batch)
from mycelium_tpu.fea.model import (apply_stiffness, diag_blocks,
                                    invert_blocks)
from mycelium_tpu.fea.solve import make_preconditioner, solve_displacement

CFG = FeaConfig(dtype="float64")


def _numpy_bar_stiffness(p1, p2, cfg):
    """Independent scalar oracle of the reference element
    (src/fea_solver.py:30-68)."""
    lv = np.asarray(p2, float) - np.asarray(p1, float)
    L = np.linalg.norm(lv)
    Ls = max(L, 1e-12)
    n = lv / Ls
    nnT = np.outer(n, n)
    blk = (cfg.e_mod * cfg.area / Ls) * nnT \
        + (12 * cfg.e_mod * cfg.moi / Ls ** 3) * (np.eye(3) - nnT)
    K = np.zeros((6, 6))
    K[:3, :3] = blk
    K[3:, 3:] = blk
    K[:3, 3:] = -blk
    K[3:, :3] = -blk
    return K


@pytest.mark.parametrize("p1,p2", [
    ([0, 0, 0], [0, 1, 0]),
    ([0, 0, 0], [1, 2, 3]),
    ([0.1, -0.2, 0.05], [0.12, -0.21, 0.05]),
])
def test_element_stiffness_matches_reference_formula(p1, p2):
    coords = jnp.asarray([p1, p2], dtype=jnp.float64)
    conn = jnp.asarray([[0, 1]], dtype=jnp.int32)
    geom = element_geometry(coords, conn, CFG)
    ke = np.asarray(element_stiffness_batch(geom))[0]
    np.testing.assert_allclose(ke, _numpy_bar_stiffness(p1, p2, CFG),
                               rtol=1e-12, atol=0)


def test_element_stiffness_degenerate_length_clamped():
    coords = jnp.zeros((2, 3), dtype=jnp.float64)
    conn = jnp.asarray([[0, 1]], dtype=jnp.int32)
    geom = element_geometry(coords, conn, CFG)
    ke = np.asarray(element_stiffness_batch(geom))
    assert np.isfinite(ke).all()


@pytest.mark.parametrize("scene_name", list(scenes.SCENES))
@pytest.mark.parametrize("operator", ["ell", "scatter"])
def test_apply_stiffness_matches_assembled_matrix(scene_name, operator):
    sc = scenes.SCENES[scene_name]()
    model = build_model(sc.coords, sc.conn, CFG)
    K = assemble_scipy(model, np.ones(model.n_elems, bool))
    rng = np.random.default_rng(0)
    u = rng.normal(size=(model.n_nodes, 3))
    active = jnp.ones((model.n_elems,), bool)
    ku = np.asarray(apply_stiffness(model, jnp.asarray(u), active, operator))
    np.testing.assert_allclose(ku.reshape(-1), K @ u.reshape(-1),
                               rtol=1e-12, atol=1e-18)


def test_apply_stiffness_respects_active_mask():
    sc = scenes.test_X()
    model = build_model(sc.coords, sc.conn, CFG)
    active_np = np.ones(model.n_elems, bool)
    active_np[::2] = False
    K = assemble_scipy(model, active_np)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(model.n_nodes, 3))
    ku = np.asarray(apply_stiffness(model, jnp.asarray(u),
                                    jnp.asarray(active_np), "ell"))
    np.testing.assert_allclose(ku.reshape(-1), K @ u.reshape(-1),
                               rtol=1e-12, atol=1e-18)


def test_dense_assembly_matches_scipy():
    sc = scenes.test_t()
    model = build_model(sc.coords, sc.conn, CFG)
    active = jnp.ones((model.n_elems,), bool)
    Kd = np.asarray(assemble_dense(model, active))
    Ks = assemble_scipy(model, np.ones(model.n_elems, bool)).toarray()
    np.testing.assert_allclose(Kd, Ks, rtol=1e-12, atol=1e-18)


def test_invert_blocks_exact():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(16, 3, 3))
    a = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)  # SPD
    a[3] *= 1e-12   # badly scaled block
    inv = np.asarray(invert_blocks(jnp.asarray(a)))
    np.testing.assert_allclose(inv @ a, np.broadcast_to(np.eye(3),
                                                        (16, 3, 3)),
                               atol=1e-9)


def test_block_jacobi_blocks_match_operator_diagonal():
    sc = scenes.test_y()
    model = build_model(sc.coords, sc.conn, CFG)
    active = jnp.ones((model.n_elems,), bool)
    blocks = np.asarray(diag_blocks(model, active, CFG))
    op = bc_operator(model, active, CFG)
    n_dof = model.n_dof
    A = np.zeros((n_dof, n_dof))
    for i in range(n_dof):
        e = jnp.zeros((model.n_nodes, 3), jnp.float64)
        e = e.at[i // 3, i % 3].set(1.0)
        A[:, i] = np.asarray(op(e)).reshape(-1)
    for node in range(model.n_nodes):
        np.testing.assert_allclose(blocks[node],
                                   A[3 * node:3 * node + 3,
                                     3 * node:3 * node + 3],
                                   rtol=1e-12, atol=1e-18)


def _scipy_reference_solve(model, cfg, active_np, dy_top, dy_bot):
    """The reference Python solve path (src/fea_solver.py:112-135,207-245):
    static condensation onto free DOFs + 1e-12 regularization + spsolve."""
    K = assemble_scipy(model, active_np)
    n_dof = model.n_dof
    top = np.asarray(model.top_nodes)
    bot = np.asarray(model.bot_nodes)
    disp = {}
    for n in np.nonzero(top)[0]:
        disp.update({3 * n: 0.0, 3 * n + 1: dy_top, 3 * n + 2: 0.0})
    for n in np.nonzero(bot)[0]:
        disp.update({3 * n: 0.0, 3 * n + 1: dy_bot, 3 * n + 2: 0.0})
    known = np.array(sorted(disp))
    vals = np.array([disp[k] for k in known])
    free = np.setdiff1d(np.arange(n_dof), known)
    K_ff = K[free][:, free].tocsr() + cfg.reg * identity(len(free),
                                                         format="csr")
    K_fk = K[free][:, known]
    F_f = -K_fk @ vals
    U = np.zeros(n_dof)
    U[free] = spsolve(K_ff, F_f)
    U[known] = vals
    return U


@pytest.mark.parametrize("scene_name", list(scenes.SCENES))
@pytest.mark.parametrize("solver", ["cg", "bicgstab", "gmres"])
def test_solve_matches_spsolve(scene_name, solver):
    cfg = archive_parity_config(solver=solver)
    sc = scenes.SCENES[scene_name]()
    model = build_model(sc.coords, sc.conn, cfg)
    active_np = np.ones(model.n_elems, bool)
    dy = 0.01
    U_ref = _scipy_reference_solve(model, cfg, active_np, dy, -dy)
    res = solve_displacement(model, jnp.asarray(active_np), dy, -dy,
                             jnp.zeros((model.n_nodes, 3), jnp.float64), cfg)
    assert bool(res.converged)
    # every solver leg reports a real iteration count (gmres counts
    # Arnoldi steps = operator applies; the old jax.scipy wrapper could
    # only return a -1 sentinel)
    assert int(res.iters) > 0
    U = np.asarray(res.x).reshape(-1)
    assert np.linalg.norm(U - U_ref) < 1e-6   # the BASELINE.json parity bar
    np.testing.assert_allclose(U, U_ref, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("precond", ["block_jacobi", "jacobi", "none",
                                     "coarse"])
def test_preconditioners_all_converge(precond):
    # 'coarse' requires the chain node ordering (spatially coherent
    # clusters); with the default 'ell' operator it now raises instead of
    # silently degrading to block-Jacobi
    cfg = archive_parity_config(
        precond=precond,
        operator="chain" if precond == "coarse" else "ell")
    sc = scenes.test_X()
    model = build_model(sc.coords, sc.conn, cfg)
    active = jnp.ones((model.n_elems,), bool)
    res = solve_displacement(model, active, 0.01, -0.01,
                             jnp.zeros((model.n_nodes, 3), jnp.float64), cfg)
    assert bool(res.converged)


def test_solve_with_fractured_isolated_nodes():
    """After fracture, isolated free nodes see only the reg·I operator —
    the solve must stay finite and exact."""
    cfg = archive_parity_config()
    sc = scenes.test_X()
    model = build_model(sc.coords, sc.conn, cfg)
    active_np = np.zeros(model.n_elems, bool)  # everything broken
    res = solve_displacement(model, jnp.asarray(active_np), 0.01, -0.01,
                             jnp.zeros((model.n_nodes, 3), jnp.float64), cfg)
    U = np.asarray(res.x)
    assert np.isfinite(U).all()
    # free center node stays put; grips move
    assert abs(U[7, 1]) < 1e-12
    np.testing.assert_allclose(U[np.asarray(model.top_nodes), 1], 0.01)


def test_ramp_refuses_diverged_solves():
    """The drivers must abort instead of recording garbage when a solve
    fails to converge (reference src/fea_petsc.cpp:343-354 aborts on
    KSPGetConvergedReason; src/fea_solver.py:250-254 catches LinAlgError).
    max_iter=1 at rtol=1e-14 cannot converge once dy > 0."""
    from mycelium_tpu.fea.ramp import (SolveDivergedError, run_ramp,
                                       run_ramp_scan)
    cfg = archive_parity_config(max_iter=1, rtol=1e-14, precond="none",
                                n_steps=4)
    sc = scenes.test_X()
    with pytest.raises(SolveDivergedError):
        run_ramp(sc.coords, sc.conn, cfg)
    with pytest.raises(SolveDivergedError):
        run_ramp_scan(sc.coords, sc.conn, cfg)


def test_pcg_stagnation_exit():
    """f32 CG can floor a hair above a too-tight tolerance; without a
    stagnation exit the loop spins to max_iter (seen at 330k nodes: a
    20000-iteration device execution). pcg
    must exit once the best residual stops improving, and report
    converged only when the floor is within stall_accept of tol."""
    from mycelium_tpu.fea.solve import pcg

    n = 512
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    # eigenvalues spread over 4 decades; in f32 the recurrence residual
    # floors around eps*kappa relative and NEVER reaches an exact zero
    # (unlike a tiny well-conditioned system, where Krylov exact
    # termination gives 0.0) — the same floor the 330k-node f32 solve hit
    lam = np.logspace(0, 4, n)
    mat32 = jnp.asarray((q * lam) @ q.T, jnp.float32)
    b32 = jnp.asarray(rng.standard_normal(n), jnp.float32)
    op32 = lambda v: mat32 @ v  # noqa: E731
    ident = lambda r: r         # noqa: E731
    x032 = jnp.zeros(n, jnp.float32)

    # tolerance far below the f32 floor: must stall-exit, not run to
    # max_iter (the 330k runaway was a 20000-iteration device execution)
    res = pcg(op32, b32, x032, ident, rtol=0.0, atol=1e-30,
              max_iter=50000, stall_window=64)
    assert int(res.iters) < 49999, "stagnation exit did not fire"
    assert float(res.resnorm) > 0.0
    assert not bool(res.converged)
    # solution is still the floored-CG answer: true residual near the floor
    rel = float(jnp.linalg.norm(mat32 @ res.x - b32) /
                jnp.linalg.norm(b32))
    assert rel < 1e-2

    # same stall, but the floor is within stall_accept of tol -> converged
    floor = float(res.resnorm)
    res2 = pcg(op32, b32, x032, ident, rtol=0.0, atol=floor * 0.5,
               max_iter=50000, stall_window=64, stall_accept=10.0)
    assert bool(res2.converged), (float(res2.resnorm), floor)

    # a genuinely converging solve is untouched by the stall machinery
    mat = jnp.asarray((q * lam) @ q.T, jnp.float64)
    b = jnp.asarray(rng.standard_normal(n))
    res3 = pcg(lambda v: mat @ v, b, jnp.zeros(n), ident,
               rtol=1e-8, atol=0.0, max_iter=20000)
    assert bool(res3.converged)
    assert float(jnp.linalg.norm(mat @ res3.x - b)) <= \
        1e-8 * float(jnp.linalg.norm(b)) * 1.01


def test_spd_inverse_ns_matches_lu():
    """Newton-Schulz inverse (the alternative to linalg.inv in the PC
    factors) converges to the LU inverse for SPD systems across a
    wide conditioning range, including identity-padded grip rows."""
    from mycelium_tpu.fea.blocks import spd_inverse_ns
    rng = np.random.default_rng(3)
    for n, cond in [(64, 1e2), (300, 1e6)]:
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = np.logspace(0.0, np.log10(cond), n)
        m = (q * ev) @ q.T
        m = 0.5 * (m + m.T)
        # identity-pad a few rows like the coarse operator's gripped
        # clusters (coarse._coarse_inverse)
        m[:3, :] = 0.0
        m[:, :3] = 0.0
        m[np.arange(3), np.arange(3)] = 1.0
        x = np.asarray(spd_inverse_ns(jnp.asarray(m, jnp.float64)))
        # de-normalized residual amplifies by diagonal-scale ratios; the
        # normalized residual (what CG sees through the PC) floors ~1e-11
        err = np.linalg.norm(x @ m - np.eye(n)) / np.linalg.norm(x @ m)
        assert err < 1e-5, (n, cond, err)
        lu = np.linalg.inv(m)
        assert np.linalg.norm(x - lu) / np.linalg.norm(lu) < 1e-5
        assert np.allclose(x, x.T, atol=1e-10)
