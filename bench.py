"""Headline benchmark: cold PCG solve time on the reference's largest
archived system (sim_20251117_181147: 7,375 nodes / 22,125 DOF).

Baseline (BASELINE.md): PETSc KSP cg+icc, median 164.0 ms per solve on a
Great Lakes CPU node (best of the reference's 15-combo sweep, n=200).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
where value is our median cold-solve wall time in ms and vs_baseline =
164.0 / value (higher = faster than the reference), followed by the
309k-DOF solve and ramp fields. Needs a GPU: the line names the platform,
device kind and device count it ran on, and a run that finds no GPU
fails. When the reference archive is absent (it is not shipped), the
22k row runs on a synthetic mesh of the same node count and says so in
its "mesh" field.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_MS = 164.0
MESH_DIR = "/root/reference/results/sim_20251117_181147"


def synthetic_mesh(n_target_nodes: int, seed: int = 0,
                   mean_chain: int = 64):
    """Synthetic mycelium-like network: random-walk hyphae (chains of ~0.05
    mm segments) that branch off existing nodes — matching the real
    workload's mostly-chain topology (jumps ~= number of hyphae), unlike a
    grid graph. Used when the reference archive is absent and for the
    DOF-scaling benchmark."""
    rng = np.random.default_rng(seed)
    h0 = 0.05
    extent = h0 * np.sqrt(n_target_nodes)   # keep density roughly constant
    coords = [np.zeros(3)]
    conn = []
    headings = {}
    while len(coords) < n_target_nodes:
        # branch from a random existing node
        start = int(rng.integers(0, len(coords)))
        length = max(int(rng.geometric(1.0 / mean_chain)), 4)
        phi = rng.uniform(0, 2 * np.pi)
        pos = coords[start].copy()
        prev = start
        for _ in range(length):
            if len(coords) >= n_target_nodes:
                break
            phi += rng.uniform(-0.26, 0.26)
            step = np.array([np.cos(phi), np.sin(phi), 0.0]) * h0
            # wall: BOUNCE the step direction (length-preserving). The
            # old clamp shrank wall-adjacent steps — down to L=0.0025 at
            # 340k nodes, a 20x axial / 8000x bending stiffness spread
            # that f32 CG cannot solve to 1e-6 (measured: residual floor
            # 3e-4 relative; the f64 oracle needed 6 iterations). The
            # REAL workload has no such elements: the reference's
            # benchmark mesh is uniform L in [0.049, 0.05] (growth steps
            # are h0 and its walls project tangentially), so the bench
            # generator must reproduce that contract.
            for ax in range(2):
                if abs(pos[ax] + step[ax]) > extent / 2:
                    step[ax] = -step[ax]
            phi = np.arctan2(step[1], step[0])
            pos = pos + step
            coords.append(pos)
            conn.append([prev, len(coords) - 1])
            prev = len(coords) - 1
    return np.asarray(coords), np.asarray(conn, np.int32)


def main():
    import jax
    import jax.numpy as jnp

    from mycelium_tpu.device import device_info, require_gpu
    from mycelium_tpu.utils import enable_compilation_cache
    require_gpu()
    enable_compilation_cache()

    from mycelium_tpu.config import FeaConfig
    from mycelium_tpu.fea.model import build_model
    from mycelium_tpu.fea.ramp import anchored_mask_host
    from mycelium_tpu.fea.solve import solve_displacement

    if os.path.isdir(MESH_DIR):
        from mycelium_tpu.io import read_mesh_dir
        coords, conn = read_mesh_dir(MESH_DIR)
        mesh_name = os.path.basename(MESH_DIR)
    else:
        coords, conn = synthetic_mesh(7375)
        mesh_name = "synthetic_7375 (reference archive absent)"

    # spanning-forest preconditioner: exact tree elimination cuts CG from
    # 872 iterations to ~14 on this mesh (see fea/tree.py)
    cfg = FeaConfig(dtype="float32", rtol=1e-6, warm_start=False,
                    operator="chain", precond="tree", tree_reg_rel=1e-7)
    model = build_model(coords, conn, cfg)
    grip = np.asarray(model.top_nodes) | np.asarray(model.bot_nodes)
    anchored = jnp.asarray(anchored_mask_host(
        np.asarray(model.conn), np.ones(model.n_elems, bool), grip))

    active = jnp.ones((model.n_elems,), bool)
    x0 = jnp.zeros((model.n_nodes, 3), jnp.dtype(cfg.dtype))
    dy = jnp.asarray(cfg.displacement_max, x0.dtype)   # full-ramp system

    # cold solves chained on the host, one dispatch each: every start
    # vector and active mask depends on the previous solution (scaled to
    # zero), so each solve is a full cold solve, factorization included
    @jax.jit
    def one_solve(model, active, anchored, xc):
        act = active & jnp.isfinite(xc[0, 0])
        res = solve_displacement(model, act, dy, -dy, xc * 1e-30, cfg,
                                 anchored)
        return res.x, res.iters

    n_chain = 16

    def chained(k):
        xc, it = x0, None
        for _ in range(k):
            xc, it = one_solve(model, active, anchored, xc)
        jax.block_until_ready(xc)
        return it

    chained(1)                                    # compile warm-up
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        iters = chained(n_chain)
        times.append((time.perf_counter() - t0) * 1e3 / n_chain)
    value = float(np.median(times))

    from mycelium_tpu.bench.roofline import roofline_row
    dev = device_info()
    row = dict(dev)
    row.update({
        "metric": "pcg_cold_solve_22125dof_median",
        "value": value,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / value,
        "mesh": mesh_name,
        "cg_iters": int(iters),
    })
    row.update(roofline_row(model, int(iters), value / 1e3,
                            dev["device_kind"]))

    # the 309k-DOF cold solve (bench/scaling.py, same methodology) and
    # the 40-step production ramp at that size. Reference scaling is
    # linear in DOF on the archived sweep data (164 ms @22,125 DOF ->
    # ~2.3 s @309k, see BASELINE.md), so vs_baseline_309k uses
    # ref_ms = 164 * n_dof / 22125; the reference ramp records 71.76 s at
    # 22,125 DOF (results/sim_20251117_181147/fea_results/runtime.txt),
    # scaled the same way.
    if not os.environ.get("MYC_BENCH_SMALL"):
        from mycelium_tpu.bench.scaling import run as scaling_run
        big = scaling_run([103000], n_chain=8, quiet=True)[0]
        ref_big_ms = BASELINE_MS * big["n_dof"] / 22125.0
        row["solve_ms_309k"] = big["solve_ms"]
        row["vs_baseline_309k"] = ref_big_ms / big["solve_ms"]
        row["cg_iters_309k"] = big["cg_iters"]
        row["achieved_gbps_309k"] = big["achieved_gbps"]
        row["roofline_frac_309k"] = big["roofline_frac"]

        from mycelium_tpu.fea.ramp import run_ramp_async
        coords_b, conn_b = synthetic_mesh(103000)
        ext_b = float(coords_b[:, 1].max() - coords_b[:, 1].min())
        cfg_b = FeaConfig(dtype="float32", rtol=1e-6, operator="chain",
                          precond="tree", tree_coarse_weight=0.25,
                          tree_reg_rel=1e-7, grip_length=0.3 * ext_b)
        model_b = build_model(coords_b, conn_b, cfg_b)
        run_ramp_async(coords_b, conn_b, cfg_b, model=model_b)  # compile
        ramp_ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            res_b = run_ramp_async(coords_b, conn_b, cfg_b, model=model_b)
            ramp_ts.append(time.perf_counter() - t0)
        ramp_s = float(np.median(ramp_ts))
        row["ramp_s_309k"] = ramp_s
        ref_ramp_s = 71.76 * (3 * coords_b.shape[0]) / 22125.0
        row["ramp_vs_baseline_309k"] = ref_ramp_s / ramp_s
        row["ramp_steps_309k"] = int(res_b.force_disp.shape[0])
    print(json.dumps(row))


if __name__ == "__main__":
    main()
