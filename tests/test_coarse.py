"""The chain + tree-PC solve path and its cluster coarse space.

The chain operator with the spanning-forest preconditioner and the
cluster coarse correction (tuned_fea_config, the pipeline's default
solver) must reproduce the SciPy spsolve oracle on a real grown mesh,
and the chain-banded coarse Galerkin assembly must equal the element
scatter assembly it replaced.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mycelium_tpu.config import FeaConfig, GrowthConfig, tuned_fea_config
from mycelium_tpu.fea.model import build_model
from mycelium_tpu.fea.ramp import anchored_mask_host
from mycelium_tpu.fea.solve import solve_displacement

from test_fea_core import _scipy_reference_solve


@pytest.fixture(scope="module")
def growth_mesh():
    from mycelium_tpu.growth import run_growth
    from mycelium_tpu.growth.export import state_mesh
    cfg = GrowthConfig(t_steps=10, max_segments=4096, max_hyphae=2048,
                       dtype="float32")
    st, _, _ = run_growth(cfg)
    return state_mesh(st)


@pytest.mark.parametrize("case,dtype,frac,basis", [
    ("intact", "float32", 0.0, "const"),
    ("fracture", "float32", 0.3, "const"),
    ("linear_basis", "float32", 0.0, "linear"),
    ("intact_f64", "float64", 0.0, "const"),
])
def test_chain_tree_solve_matches_spsolve(growth_mesh, case, dtype, frac,
                                          basis):
    """The tuned preset's solve against the f64 spsolve oracle: rel L2
    < 1e-4 in f32 (the bar the GPU smoke check holds the card to), and
    < 1e-8 in f64. With fracture, nodes cut off from the grips are pinned
    to zero, which is the direct solver's answer for them (b = 0)."""
    coords, conn = growth_mesh
    ext = float(np.ptp(coords[:, 1]))
    cfg = tuned_fea_config(dtype=dtype, coarse_basis=basis,
                           warm_start=False, grip_length=0.3 * ext,
                           **({"rtol": 1e-12} if dtype == "float64"
                              else {}))
    model = build_model(coords, conn, cfg)
    assert model.tree_fast is not None and model.chain is not None
    rng = np.random.default_rng(0)
    active_np = rng.random(model.n_elems) >= frac
    grip = np.asarray(model.top_nodes) | np.asarray(model.bot_nodes)
    anchored = jnp.asarray(anchored_mask_host(np.asarray(model.conn),
                                              active_np, grip))
    dy = 0.01
    x0 = jnp.zeros((model.n_nodes, 3), jnp.dtype(dtype))
    res = solve_displacement(model, jnp.asarray(active_np), dy, -dy, x0,
                             cfg, anchored)
    assert bool(res.converged)
    ref_model = build_model(coords, conn, FeaConfig(
        dtype="float64", grip_length=cfg.grip_length))
    U_ref = _scipy_reference_solve(ref_model, cfg, active_np, dy, -dy)
    U = np.asarray(res.x, np.float64).reshape(-1)
    rel = np.linalg.norm(U - U_ref) / np.linalg.norm(U_ref)
    assert rel < (1e-4 if dtype == "float32" else 1e-8), (case, rel)


def test_dense_tail_inverse_f64_matches_numpy(monkeypatch):
    """The dense junction-tail inverse stays in the factor's dtype: an
    f64 factor inverts its assembled tail system in f64 (no f32 cast on
    any backend), to numpy's f64 inverse."""
    from mycelium_tpu.fea import tree_jax as trj
    from test_tree_pc import random_forest_mesh

    seen = []
    inv = jnp.linalg.inv

    def spy(m):
        out = inv(m)
        seen.append((np.asarray(m), np.asarray(out)))
        return out

    monkeypatch.setattr(jnp.linalg, "inv", spy)

    coords, conn = random_forest_mesh(n_nodes=600, n_extra=12, seed=5)
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree",
                    grip_length=0.1, tree_dense_tail=256)
    model = build_model(coords, conn, cfg)
    meta = model.tree.meta
    t0 = meta.level_offsets[trj.n_pcr_levels(meta)]
    assert model.tree.n_slots > t0, "mesh has no dense tail"
    free = model.free_nodes
    fac = trj.tree_factor_fast(
        model.tree, model.tree_fast, model.chain,
        jnp.ones((model.n_elems,), bool), free, free[model.chain.perm],
        jnp.asarray(1e-9, jnp.float64), model.conn)
    assert fac.sinv.dtype == jnp.float64
    (M, M_inv), = seen
    assert M.dtype == np.float64 and M.shape == fac.sinv.shape
    np.testing.assert_array_equal(np.asarray(fac.sinv), M_inv)
    ref = np.linalg.inv(M)
    np.testing.assert_allclose(M_inv, ref, rtol=1e-9,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("kblk,basis,frac", [(1, "linear", 0.0),
                                             (2, "linear", 0.15),
                                             (1, "const", 0.1)])
def test_coarse_matrix_chain_matches_scatter(growth_mesh, kblk, basis,
                                             frac):
    """The chain-banded coarse Galerkin assembly must equal the original
    element-scatter assembly (same matrix up to summation roundoff) —
    including under fracture, extra pins, multi-block clusters and both
    basis choices."""
    from mycelium_tpu.fea.coarse import (_coarse_matrix_chain,
                                         _coarse_matrix_scatter, plan_nb)
    coords, conn = growth_mesh
    cfg = FeaConfig(dtype="float32", operator="chain", coarse_basis=basis)
    model = build_model(coords, conn, cfg)
    rng = np.random.default_rng(7)
    active = jnp.asarray(rng.random(model.n_elems) > frac)
    free = jnp.asarray(np.asarray(model.free_nodes)
                       & (rng.random(model.n_nodes) > 0.03))
    nb = plan_nb(model.n_nodes)
    a_sc = np.asarray(_coarse_matrix_scatter(model, model.chain, active,
                                             free, cfg, nb, kblk))
    a_ch = np.asarray(_coarse_matrix_chain(model, model.chain, active,
                                           free, cfg, nb, kblk))
    scale = max(np.abs(a_sc).max(), 1e-30)
    np.testing.assert_allclose(a_ch, a_sc, rtol=2e-5,
                               atol=2e-5 * scale)


def test_coarse_matrix_scatter_fallback_matches_mxu(growth_mesh):
    """Past COARSE_MATMUL_CAP the jump block of the coarse assembly falls
    back to the 36-entries-per-jump scatter (the dense incidence would
    reach gigabytes on an anastomosis-heavy 1e6-node mesh); both branches
    must build the same matrix."""
    import mycelium_tpu.fea.coarse as coarse_mod
    from mycelium_tpu.fea.coarse import _coarse_matrix_chain, plan_nb
    coords, conn = growth_mesh
    cfg = FeaConfig(dtype="float64", operator="chain")
    model = build_model(coords, conn, cfg)
    rng = np.random.default_rng(11)
    active = jnp.asarray(rng.random(model.n_elems) > 0.2)
    free = model.free_nodes
    nb = plan_nb(model.n_nodes)
    a_mm = np.asarray(_coarse_matrix_chain(model, model.chain, active,
                                           free, cfg, nb, 1))
    old_cap = coarse_mod.COARSE_MATMUL_CAP
    try:
        coarse_mod.COARSE_MATMUL_CAP = 0
        a_sc = np.asarray(_coarse_matrix_chain(model, model.chain, active,
                                               free, cfg, nb, 1))
    finally:
        coarse_mod.COARSE_MATMUL_CAP = old_cap
    scale = max(np.abs(a_sc).max(), 1e-30)
    np.testing.assert_allclose(a_mm, a_sc, rtol=2e-5, atol=2e-5 * scale)
