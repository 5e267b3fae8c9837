"""Multi-device tests on the virtual 8-device CPU mesh: the sharded CG
solve must match the single-chip solver to solver tolerance (the 1-chip vs
N-chip equality contract the reference validates with mpirun -np 1 vs -np 4,
SURVEY.md §4.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mycelium_tpu import scenes
from mycelium_tpu.config import archive_parity_config
from mycelium_tpu.fea import build_model
from mycelium_tpu.fea.shard import default_mesh, sharded_cg_solver
from mycelium_tpu.fea.solve import solve_displacement


@pytest.fixture(scope="module")
def growth_mesh():
    from mycelium_tpu.config import GrowthConfig
    from mycelium_tpu.growth import run_growth
    from mycelium_tpu.growth.export import state_mesh
    cfg = GrowthConfig(t_steps=10, max_segments=4096, max_hyphae=2048,
                       dtype="float32")
    st, _, _ = run_growth(cfg)
    return state_mesh(st)


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_dev", [1, 4, 8])
@pytest.mark.parametrize("scene_name", ["test_X", "test_y"])
def test_sharded_solve_matches_single_chip(scene_name, n_dev):
    cfg = archive_parity_config()
    sc = scenes.SCENES[scene_name]()
    model = build_model(sc.coords, sc.conn, cfg)
    active = jnp.ones((model.n_elems,), bool)
    x0 = jnp.zeros((model.n_nodes, 3), jnp.float64)
    ref = solve_displacement(model, active, 0.01, -0.01, x0, cfg)
    mesh = default_mesh(n_dev)
    solve = sharded_cg_solver(model, cfg, mesh)
    res = solve(active, 0.01, -0.01, x0)
    assert bool(res.converged)
    err = np.linalg.norm(np.asarray(res.x) - np.asarray(ref.x))
    assert err < 1e-6, f"{n_dev}-dev vs 1-chip L2 {err:.3e}"


def test_sharded_solve_real_growth_mesh(growth_mesh):
    coords, conn = growth_mesh
    cfg = archive_parity_config(grip_length=1.5)
    model = build_model(coords, conn, cfg)
    active = jnp.ones((model.n_elems,), bool)
    x0 = jnp.zeros((model.n_nodes, 3), jnp.float64)
    ref = solve_displacement(model, active, 0.005, -0.005, x0, cfg)
    solve = sharded_cg_solver(model, cfg, default_mesh(8))
    res = solve(active, 0.005, -0.005, x0)
    assert bool(res.converged)
    err = np.linalg.norm(np.asarray(res.x) - np.asarray(ref.x))
    assert err < 1e-6, f"L2 {err:.3e}"


def test_sharded_solve_with_fracture_and_anchored(growth_mesh):
    coords, conn = growth_mesh
    cfg = archive_parity_config(grip_length=1.5)
    model = build_model(coords, conn, cfg)
    rng = np.random.default_rng(0)
    active_np = rng.random(model.n_elems) > 0.3     # fractured network
    from mycelium_tpu.fea.ramp import anchored_mask_host
    grip = np.asarray(jnp.logical_or(model.top_nodes, model.bot_nodes))
    anchored = anchored_mask_host(np.asarray(model.conn), active_np, grip)
    active = jnp.asarray(active_np)
    x0 = jnp.zeros((model.n_nodes, 3), jnp.float64)
    ref = solve_displacement(model, active, 0.005, -0.005, x0, cfg,
                             jnp.asarray(anchored))
    solve = sharded_cg_solver(model, cfg, default_mesh(8))
    res = solve(active, 0.005, -0.005, x0, jnp.asarray(anchored))
    assert bool(res.converged)
    err = np.linalg.norm(np.asarray(res.x) - np.asarray(ref.x))
    assert err < 1e-6, f"L2 {err:.3e}"


def test_sharded_ramp_matches_single_chip():
    """Full pull test over the 8-device mesh == single-chip ramp records
    (the mpirun -np 1 vs -np 4 CSV-comparison contract, SURVEY.md §4.4)."""
    from mycelium_tpu.fea.ramp import run_ramp, run_ramp_sharded
    sc = scenes.test_X()
    cfg = archive_parity_config(n_steps=8, displacement_max=0.06)
    res1 = run_ramp(sc.coords, sc.conn, cfg)
    resN = run_ramp_sharded(sc.coords, sc.conn, cfg, default_mesh(8))
    assert res1.disp_record.shape == resN.disp_record.shape
    np.testing.assert_allclose(resN.disp_record, res1.disp_record,
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_array_equal(resN.active_record, res1.active_record)
    np.testing.assert_allclose(resN.force_disp, res1.force_disp,
                               rtol=1e-7, atol=1e-16)


@pytest.mark.parametrize("basis,cap", [("const", None), ("linear", None),
                                       ("const", 6)])
def test_sharded_coarse_preconditioner(growth_mesh, basis, cap):
    """The sharded two-level CG (block-Jacobi + replicated coarse solve in
    chain order) must reproduce the single-chip 'coarse' PC: same solution
    and essentially the same iteration path. (Whether the coarse level
    helps is mesh-dependent — it wins on large/loopy meshes, see
    docs/PERFORMANCE.md — so the contract here is sharding fidelity.)
    cap=6 forces widened clusters (coarse_max_dim, kblk>1): the shard
    padding quantum and cluster restriction must track the same width."""
    coords, conn = growth_mesh
    import dataclasses
    base = archive_parity_config(grip_length=0.3, operator="chain")
    cfg = dataclasses.replace(base, precond="coarse", coarse_basis=basis,
                              **({"coarse_max_dim": cap} if cap else {}))
    if cap is not None:
        from mycelium_tpu.fea.coarse import coarse_cluster_blocks, plan_nb
        assert coarse_cluster_blocks(plan_nb(coords.shape[0]), cfg) > 1
    model = build_model(coords, conn, base)
    active = jnp.ones((model.n_elems,), bool)
    x0 = jnp.zeros((model.n_nodes, 3), jnp.float64)
    # pin grip-unreachable islands like every ramp driver does: their
    # near-null modes are fixed only by reg*I, so two CG runs with
    # different reduction orders legitimately drift apart there (~1e-6
    # at 1e-12 rtol) — the fidelity contract applies to the well-posed
    # anchored subspace
    from mycelium_tpu.fea.ramp import anchored_mask_host
    anchored = jnp.asarray(anchored_mask_host(
        np.asarray(model.conn), np.ones(model.n_elems, bool),
        np.asarray(jnp.logical_or(model.top_nodes, model.bot_nodes))))
    ref = solve_displacement(model, active, 0.005, -0.005, x0, cfg,
                             anchored)
    tl = sharded_cg_solver(model, cfg, default_mesh(8))(
        active, 0.005, -0.005, x0, anchored)
    assert bool(tl.converged)
    err = np.linalg.norm(np.asarray(tl.x) - np.asarray(ref.x))
    assert err < 1e-6, f"sharded vs 1-chip coarse L2 {err:.3e}"
    # same PC => same Krylov path up to float associativity
    assert abs(int(tl.iters) - int(ref.iters)) <= max(
        5, int(0.2 * int(ref.iters))), (int(tl.iters), int(ref.iters))


def test_sharded_tree_pc_matches_single_chip(growth_mesh):
    """precond='tree' under shard_map (redundant forest-elimination PC,
    distributed operator — the PCREDUNDANT pattern): same solution AND the
    same iteration path as the single-chip tree-PC chain solver, with and
    without a precomputed reusable factor (compute_tree_factor)."""
    coords, conn = growth_mesh
    from mycelium_tpu.fea.ramp import anchored_mask_host
    from mycelium_tpu.fea.solve import compute_tree_factor
    cfg = archive_parity_config(grip_length=0.3, operator="chain",
                                precond="tree", tree_coarse_weight=0.25,
                                tree_reg_rel=1e-7)
    model = build_model(coords, conn, cfg)
    active = jnp.ones((model.n_elems,), bool)
    x0 = jnp.zeros((model.n_nodes, 3), jnp.float64)
    anchored = jnp.asarray(anchored_mask_host(
        np.asarray(model.conn), np.ones(model.n_elems, bool),
        np.asarray(jnp.logical_or(model.top_nodes, model.bot_nodes))))
    ref = solve_displacement(model, active, 0.005, -0.005, x0, cfg,
                             anchored)
    solve = sharded_cg_solver(model, cfg, default_mesh(8))
    res = solve(active, 0.005, -0.005, x0, anchored)
    assert bool(res.converged)
    err = np.linalg.norm(np.asarray(res.x) - np.asarray(ref.x))
    assert err < 1e-6, f"sharded vs 1-chip tree L2 {err:.3e}"
    assert abs(int(res.iters) - int(ref.iters)) <= max(
        3, int(0.2 * int(ref.iters))), (int(res.iters), int(ref.iters))
    # precomputed-factor path (the ramp drivers' reuse contract)
    fac = jax.jit(compute_tree_factor, static_argnums=(2,))(
        model, active, cfg, anchored)
    res2 = solve(active, 0.005, -0.005, x0, anchored, fac)
    assert bool(res2.converged)
    err2 = np.linalg.norm(np.asarray(res2.x) - np.asarray(ref.x))
    assert err2 < 1e-6, f"factor-reuse L2 {err2:.3e}"


def test_sharded_ramp_tree_pc_and_checkpoint(tmp_path):
    """run_ramp_sharded production parity: the tree-PC config (factor
    reused across unchanged-mask steps, device-side anchored refresh,
    pipelined fetches) must reproduce the single-chip run_ramp records
    through fracture events, and checkpoint/resume must be record-exact."""
    from mycelium_tpu.fea.ramp import run_ramp, run_ramp_sharded
    sc = scenes.test_X()
    coords, conn = sc.coords, sc.conn
    import dataclasses
    cfg = archive_parity_config(operator="chain",
                                precond="tree", tree_coarse_weight=0.25,
                                tree_reg_rel=1e-7, n_steps=10,
                                displacement_max=0.12)  # forces fracture
    res1 = run_ramp(coords, conn, cfg)
    resN = run_ramp_sharded(coords, conn, cfg, default_mesh(8))
    assert res1.active_record.sum() < res1.active_record.shape[0] * \
        res1.active_record.shape[1], "config never fractured anything"
    assert res1.disp_record.shape == resN.disp_record.shape
    np.testing.assert_allclose(resN.disp_record, res1.disp_record,
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_array_equal(resN.active_record, res1.active_record)
    np.testing.assert_allclose(resN.force_disp, res1.force_disp,
                               rtol=1e-7, atol=1e-16)
    # checkpoint mid-ramp, resume, records must match the one-shot run
    ckpt = str(tmp_path / "sharded_ramp.npz")
    half = dataclasses.replace(cfg, n_steps=10)
    run_ramp_sharded(coords, conn,
                     dataclasses.replace(half, n_steps=10), default_mesh(8),
                     checkpoint_path=ckpt, checkpoint_every=4)
    import os
    assert os.path.exists(ckpt)
    from mycelium_tpu.io.checkpoint import load_ramp_state
    step0, _, _, _ = load_ramp_state(ckpt)
    assert step0 > 0
    res_r = run_ramp_sharded(coords, conn, half, default_mesh(8),
                             resume_from=ckpt)
    np.testing.assert_allclose(res_r.disp_record, resN.disp_record,
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_array_equal(res_r.active_record, resN.active_record)


def test_growth_trajectory_matches_single_device():
    """Growth is data-parallel over segment slots: a GSPMD run with state
    arrays sharded across all 8 devices must reproduce the single-device
    trajectory BIT-FOR-BIT over 10 steps (same program, same threefry
    keys; only the layout differs). This is the growth half of the
    reference's mpirun -np 1 vs -np 4 contract (SURVEY.md §4.4)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from mycelium_tpu.config import GrowthConfig
    from mycelium_tpu.growth import init_state
    from mycelium_tpu.growth.step import growth_step

    cfg = GrowthConfig(t_steps=10, max_segments=512, max_hyphae=256,
                       h0_per_point=2, inoculum_nx=2, inoculum_ny=2,
                       max_per_cell=8, dtype="float32")
    st1, ea = init_state(cfg)

    mesh = Mesh(np.asarray(jax.devices()), ("shard",))
    seg_sharding = NamedSharding(mesh, P("shard"))
    rep = NamedSharding(mesh, P())

    def shard_state(s):
        def place(x):
            if hasattr(x, "ndim") and x.ndim >= 1 and \
                    x.shape[0] == cfg.max_segments:
                return jax.device_put(x, seg_sharding)
            return jax.device_put(x, rep)
        return jax.tree_util.tree_map(place, s)

    stN = shard_state(st1)
    for _ in range(10):
        st1 = growth_step(st1, ea, cfg)
        stN = growth_step(stN, ea, cfg)

    for name, a, b in zip(st1._fields, st1, stN):
        if name in ("sub", "env_e"):
            # substrate accumulators go through cross-slot reductions
            # (translocation sums, the uptake cumprod/cumsum) whose GSPMD
            # partials reassociate across shards: tolerance-equal
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-12,
                                       err_msg=f"field {name} diverged")
        else:
            # geometry, states, ids, keys, counters: bit-equal
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"field {name} diverged "
                                                  "between 1-dev and 8-dev")
