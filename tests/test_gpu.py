"""Checks that need an NVIDIA GPU. They skip on the CPU; run them on a
GPU machine with ``MYC_TEST_GPU=1 python -m pytest tests/ -m gpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from mycelium_tpu.config import tuned_fea_config
from mycelium_tpu.fea.model import build_model
from mycelium_tpu.fea.ramp import anchored_mask_host
from mycelium_tpu.fea.solve import solve_displacement
from test_tree_pc import random_forest_mesh


@pytest.mark.gpu
def test_tree_solve_on_gpu_matches_spsolve(gpu_device):
    """The f32 'fast' solve on the card against the host f64 oracle, at
    the smoke check's bar."""
    coords, conn = random_forest_mesh(n_nodes=900, n_extra=18, seed=4)
    cfg = tuned_fea_config(grip_length=0.1, warm_start=False)
    with jax.default_device(gpu_device):
        model = build_model(coords, conn, cfg)
        active = np.ones(model.n_elems, bool)
        grip = np.asarray(model.top_nodes) | np.asarray(model.bot_nodes)
        anchored = jnp.asarray(anchored_mask_host(np.asarray(model.conn),
                                                  active, grip))
        res = solve_displacement(model, jnp.asarray(active), 0.01, -0.01,
                                 jnp.zeros((model.n_nodes, 3), jnp.float32),
                                 cfg, anchored)
        assert res.x.devices() == {gpu_device}
    ref = chip_smoke.host_reference_solve(coords, conn, active, 0.01, cfg)
    assert bool(res.converged)
    assert chip_smoke.rel_l2(res.x, ref) < chip_smoke.F32_REL_L2
