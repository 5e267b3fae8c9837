"""DOF-scaling benchmark: cold PCG solve time at growing system sizes.

Run:  python -m mycelium_tpu.bench.scaling [n_nodes ...]

Meshes come from bench.synthetic_mesh (random-walk hyphae with branches,
mostly-chain structure) so the chain-ordered operator applies. Each
measurement chains data-dependent cold solves, one dispatch each, and
times the chain. Needs a GPU; every row names the device it ran on.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def run(n_nodes_list, n_chain=8, rtol=1e-6, quiet=False):
    import jax
    import jax.numpy as jnp

    from ..device import device_info, require_gpu
    from ..utils import enable_compilation_cache
    require_gpu()
    enable_compilation_cache()
    dev = device_info()

    from ..config import FeaConfig
    from ..fea.model import build_model
    from ..fea.ramp import anchored_mask_host
    from ..fea.solve import compute_tree_factor, solve_displacement

    sys.path.insert(0, ".")
    from bench import synthetic_mesh

    results = []
    for n_target in n_nodes_list:
        coords, conn = synthetic_mesh(n_target)
        n_dof = 3 * coords.shape[0]
        # grip 30% of the extent per side, the reference workload's
        # fraction (GRIP_LENGTH=1.5 on the 5 mm dish): a sliver-gripped
        # random tree is floppy enough that soft bending modes
        # (~k_bd/(path len)^4) sink below any PC floor and f32 CG stalls
        # on conditioning, which benchmarks precision, not speed
        ext = float(coords[:, 1].max() - coords[:, 1].min())
        cfg = FeaConfig(dtype="float32", rtol=rtol, warm_start=False,
                        operator="chain", precond="tree",
                        tree_coarse_weight=0.25, tree_reg_rel=1e-7,
                        grip_length=0.3 * ext)
        t0 = time.perf_counter()
        model = build_model(coords, conn, cfg)
        build_s = time.perf_counter() - t0
        grip = np.asarray(model.top_nodes) | np.asarray(model.bot_nodes)
        anchored = jnp.asarray(anchored_mask_host(
            np.asarray(model.conn), np.ones(model.n_elems, bool), grip))
        active = jnp.ones((model.n_elems,), bool)
        x0 = jnp.zeros((model.n_nodes, 3), jnp.float32)
        dy = jnp.asarray(0.02, jnp.float32)

        # Cold solves chained on the host, each one program with its
        # factorization inside (tree_factor_val=None). The active mask
        # depends on the previous solution so XLA cannot hoist the
        # factorization: every solve is a true cold solve.
        @jax.jit
        def one_solve(model, active, anchored, xc):
            act = active & jnp.isfinite(xc[0, 0])
            res = solve_displacement(model, act, dy, -dy, xc * 1e-30,
                                     cfg, anchored)
            return res.x, res.iters

        def chained(k):
            xc, it = x0, None
            for _ in range(k):
                xc, it = one_solve(model, active, anchored, xc)
            jax.block_until_ready(xc)
            return it

        t0 = time.perf_counter()
        chained(1)                        # compile + one solve
        first_call_s = time.perf_counter() - t0
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            iters = chained(n_chain)
            ts.append((time.perf_counter() - t0) / n_chain)

        # factorization share of the cold solve: chained jitted
        # compute_tree_factor calls, each data-dependent on the last
        @jax.jit
        def one_fac(model, active, anchored, xc):
            act = active & jnp.isfinite(xc[0, 0])
            f = compute_tree_factor(model, act, cfg, anchored)
            return xc * 1e-30 + f.dinv[0, 0]

        def fac_chain(k):
            xc = x0
            for _ in range(k):
                xc = one_fac(model, active, anchored, xc)
            jax.block_until_ready(xc)

        fac_chain(1)
        fts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fac_chain(n_chain)
            fts.append((time.perf_counter() - t0) / n_chain)

        per_solve = float(np.median(ts))
        row = dict(dev)
        row.update({
            "n_dof": n_dof,
            "solve_ms": per_solve * 1e3,
            "solves_per_sec": 1.0 / per_solve,
            "cg_iters": int(iters),
            "factor_ms": float(np.median(fts)) * 1e3,
            "plan_build_s": build_s,
            "first_call_s": first_call_s,
        })
        from .roofline import roofline_row
        row.update(roofline_row(model, row["cg_iters"], per_solve,
                                dev["device_kind"]))
        results.append(row)
        if not quiet:
            print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    sizes = [int(a) for a in sys.argv[1:]] or [7375, 33000]
    run(sizes)
