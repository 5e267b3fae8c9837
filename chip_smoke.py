"""Smoke check of the whole system on an NVIDIA GPU.

    python chip_smoke.py               # phases 0-5 on one card
    python chip_smoke.py --four-gpus   # phase 6 only: sharded ramp, 4 cards

One process drives the card(s) through the normal entry points
(``cli.main``, ``run_growth``, ``run_ramp``, ``run_ramp_sharded``) at the
reference's real size, and checks every result against a plain reference:
host f64 SciPy ``spsolve`` for displacements, the CPU rehearsal's growth
statistics, and bit-equality between the two growth-grid paths.

  0 device      refuse anything but a GPU; name the card and its power limit
  1 pipeline    grow (25 sites x 10 hyphae, 150 steps, seed 42) -> export ->
                40-step pull test (f32, 'fast' preset); growth stats within
                15% of the CPU rehearsal, three recorded steps within rel L2
                1e-4 of spsolve
  2 f64         the same mesh in f64 at rtol 1e-12; L2 < 1e-6 vs spsolve
  3 large       synthetic 103,000-node mesh (~309k DOF): one cold solve vs
                spsolve (rel L2 < 1e-4), then the full ramp; the factor's
                compile time is reported apart
  4 growth      incremental vs full-rebuild grid bit-equal; 'window' vs
                'grid' anastomosis query timings
  5 precision   one growth step (op by op) and one solve on the GPU and on
                the CPU backend from identical inputs
  6 sharded     (--four-gpus) the phase-1 and 309k meshes sharded over 4
                cards against single-card run_ramp

Every printed time says whether it is cold (compile included) or warm.
The last line of standard output is the JSON object
{"ok": true, "device": {"platform", "kind", "count"}}; any failed check
exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# CPU rehearsal of the default growth run (GrowthConfig(): 25 sites x 10
# hyphae, 150 steps, seed 42, f32, 16,384 slots). Growth parity between
# backends is statistical, so the card's run is held to a band around
# these; the reference itself ends at 6.8k-7.5k segments (SURVEY.md).
REHEARSAL_SEGMENTS = 6806
REHEARSAL_HYPHAE = 1644
REHEARSAL_LENGTH_MM = 340.2952880859375
GROWTH_BAND = 0.15

F32_REL_L2 = 1e-4     # f32 displacement vs the f64 oracle (relative)
F64_L2 = 1e-6         # the repo's parity bar (absolute L2)
PRECISION_REL = 1e-5  # GPU vs CPU backend, same f32 inputs
GROW_TIE_BAND = 1e-6  # growth-test margin within which f32 rounding decides
TIE_NUDGE = 1e-4      # relative nudge that moves such a tie off its threshold
SHARD_REL = 1e-3      # sharded vs single-card ramp, per step

LARGE_NODES = 103000


class SmokeFailure(RuntimeError):
    pass


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def rel_l2(x, ref) -> float:
    """||x - ref|| / ||ref|| over all entries (f64)."""
    x = np.asarray(x, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


def max_rel_diff(x, ref) -> float:
    """max |x - ref| / max |ref| (f64)."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref), initial=0.0)
                 / max(np.max(np.abs(ref), initial=0.0), 1e-300))


def within_band(value: float, center: float, band: float) -> bool:
    return abs(value - center) <= band * abs(center)


def pick_steps(force_disp: np.ndarray) -> list:
    """Recorded ramp steps to re-solve: the first loaded step (step 0 has
    dy = 0), the peak-force step and the last step."""
    n = len(force_disp)
    peak = int(np.argmax(np.abs(force_disp[:, 1])))
    return sorted({min(1, n - 1), peak, n - 1})


def host_reference_solve(coords, conn, active, dy: float, cfg) -> np.ndarray:
    """Plain f64 host oracle, independent of the code under test: SciPy
    CSR assembly of the reference bar element, static condensation onto
    the free DOFs + cfg.reg regularization, and spsolve (reference
    src/fea_solver.py:30-135,207-245). Grips: nodes within
    cfg.grip_length of the extreme y, bottom winning an overlap; they
    move (0, +dy, 0) on top and (0, -dy, 0) at the bottom. Returns the
    (N, 3) displacement field."""
    from scipy.sparse import csr_matrix, identity
    from scipy.sparse.linalg import spsolve
    coords = np.asarray(coords, np.float64)
    conn = np.asarray(conn, np.int64)
    n = coords.shape[0]
    d = coords[conn[:, 1]] - coords[conn[:, 0]]
    length = np.maximum(np.linalg.norm(d, axis=1), 1e-12)
    nv = d / length[:, None]
    k_ax = cfg.e_mod * cfg.area / length
    k_bd = 12.0 * cfg.e_mod * cfg.moi / length ** 3
    nnt = nv[:, :, None] * nv[:, None, :]
    blk = (k_ax[:, None, None] * nnt
           + k_bd[:, None, None] * (np.eye(3) - nnt))
    blk = blk * np.asarray(active, bool)[:, None, None]
    ke = np.block([[blk, -blk], [-blk, blk]])             # (E, 6, 6)
    dof = np.concatenate([3 * conn[:, :1] + np.arange(3),
                          3 * conn[:, 1:2] + np.arange(3)], axis=1)
    rows = np.repeat(dof, 6, axis=1).ravel()
    cols = np.tile(dof, (1, 6)).ravel()
    K = csr_matrix((ke.ravel(), (rows, cols)), shape=(3 * n, 3 * n))

    y = coords[:, 1]
    bot = np.abs(y - y.min()) < cfg.grip_length
    top = (np.abs(y - y.max()) < cfg.grip_length) & ~bot
    u = np.zeros((n, 3))
    u[top, 1] = dy
    u[bot, 1] = -dy
    known = np.zeros((n, 3), bool)
    known[top | bot] = True
    known, u = known.ravel(), u.ravel()
    free = np.nonzero(~known)[0]
    kn = np.nonzero(known)[0]
    K_ff = K[free][:, free] + cfg.reg * identity(len(free), format="csr")
    u[free] = spsolve(K_ff.tocsc(), -(K[free][:, kn] @ u[kn]))
    return u.reshape(n, 3)


def read_fea_records(fea_dir: str):
    """(disp (n_rec, N, 3), active (n_rec, E) bool, force_disp (n_rec, 2))
    from the CSVs the CLI wrote (python dialect)."""
    disp = np.loadtxt(os.path.join(fea_dir, "node_displacements.csv"),
                      delimiter=",", skiprows=1, ndmin=2)[:, :-1]
    with open(os.path.join(fea_dir, "active_elements.csv")) as f:
        lines = f.read().splitlines()[1:]
    active = np.asarray([[v == "True" for v in ln.split(",")[:-1]]
                         for ln in lines], bool)
    fd = np.loadtxt(os.path.join(fea_dir, "force_displacement.csv"),
                    delimiter=",", skiprows=1, ndmin=2)
    return disp.reshape(len(disp), -1, 3), active, fd


def check_ramp_steps(coords, conn, cfg, disp, active_rec, force_disp,
                     bar: float, relative: bool) -> list:
    """Re-solve the picked recorded steps with the host oracle; each solve
    ran on the active mask recorded one step earlier (all-active for step
    0). Returns one dict per step; raises past ``bar``."""
    out = []
    for k in pick_steps(force_disp):
        act = active_rec[k - 1] if k > 0 else np.ones(len(conn), bool)
        dy = cfg.displacement_max * k / (cfg.n_steps - 1)
        ref = host_reference_solve(coords, conn, act, dy, cfg)
        err = (rel_l2(disp[k], ref) if relative
               else float(np.linalg.norm(np.asarray(disp[k]) - ref)))
        out.append({"step": k, "dy": dy, "rel_l2" if relative else "l2": err})
        check(err < bar, f"step {k}: displacement error {err:.3e} >= {bar}")
    return out


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _block(x):
    import jax
    jax.block_until_ready(x)
    return x


def phase_device() -> dict:
    import jax
    from mycelium_tpu.device import device_info, require_gpu
    require_gpu()
    info = device_info()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    from mycelium_tpu.native import meshio_native
    emit("device", **info, jax=jax.__version__,
         native_meshio=bool(meshio_native.available()))
    for line in smi.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}", flush=True)
    return info


def phase_pipeline(out_dir: str, gcfg=None, expected=None) -> dict:
    """Grow -> export -> pull test. Stage timings come from the library
    entry points (cold = first call in the process, compile included;
    warm = second call); the checked outputs come from one warm
    ``cli pipeline`` run into ``out_dir``."""
    from mycelium_tpu import cli
    from mycelium_tpu.config import GrowthConfig, tuned_fea_config
    from mycelium_tpu.fea.model import build_model
    from mycelium_tpu.fea.ramp import run_ramp
    from mycelium_tpu.growth import run_growth
    from mycelium_tpu.growth.export import state_mesh
    from mycelium_tpu.io import read_mesh_dir

    gcfg = gcfg or GrowthConfig()
    fcfg = tuned_fea_config()
    t = {}
    for run in ("cold", "warm"):
        (st, _, _), t[f"growth_s_{run}"] = _timed(lambda: run_growth(gcfg))
        coords, conn = state_mesh(st)
        model, t[f"plan_s_{run}"] = _timed(
            lambda: build_model(coords, conn, fcfg))
        res, t[f"ramp_s_{run}"] = _timed(
            lambda: run_ramp(coords, conn, fcfg, model=model))

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["pipeline", "--dir", out_dir, "--snapshots", "none",
            "--no-plots", "--no-summary-plot"]
    if gcfg.t_steps != GrowthConfig().t_steps:
        argv += ["--steps", str(gcfg.t_steps)]
    _, t["cli_pipeline_s_warm"] = _timed(lambda: cli.main(argv))

    with open(os.path.join(out_dir, "mycelium_growth_stats.csv")) as f:
        head, *rows = f.read().splitlines()
    last = dict(zip(head.split(","), rows[-1].split(",")))
    growth = {k: float(last[k])
              for k in ("segments", "hyphae", "total_length_mm")}
    expected = expected or {"segments": REHEARSAL_SEGMENTS,
                            "hyphae": REHEARSAL_HYPHAE,
                            "total_length_mm": REHEARSAL_LENGTH_MM}
    for k, center in expected.items():
        check(within_band(growth[k], center, GROWTH_BAND),
              f"growth {k} = {growth[k]} outside {GROWTH_BAND:.0%} of the "
              f"CPU rehearsal's {center}")

    coords, conn = read_mesh_dir(out_dir)
    disp, active_rec, fd = read_fea_records(
        os.path.join(out_dir, "fea_results"))
    steps = check_ramp_steps(coords, conn, fcfg, disp, active_rec, fd,
                             F32_REL_L2, relative=True)
    emit("pipeline", **t, **growth, nodes=int(coords.shape[0]),
         elements=int(conn.shape[0]), steps_recorded=int(len(fd)),
         cg_iters=[int(i) for i in res.cg_iters],
         fractured=int(len(conn) - active_rec[-1].sum()),
         checked_steps=steps)
    return {"coords": coords, "conn": conn}


def phase_f64(coords, conn) -> None:
    import jax
    from mycelium_tpu.config import tuned_fea_config
    from mycelium_tpu.fea.model import build_model
    from mycelium_tpu.fea.ramp import run_ramp

    jax.config.update("jax_enable_x64", True)
    try:
        cfg = tuned_fea_config(dtype="float64", rtol=1e-12)
        model, plan_s = _timed(lambda: build_model(coords, conn, cfg))
        res, ramp_s = _timed(lambda: run_ramp(coords, conn, cfg,
                                              model=model))
    finally:
        jax.config.update("jax_enable_x64", False)
    disp = res.disp_record.reshape(len(res.disp_record), -1, 3)
    steps = check_ramp_steps(coords, conn, cfg, disp, res.active_record,
                             res.force_disp, F64_L2, relative=False)
    emit("f64", plan_s_cold=plan_s, ramp_s_cold=ramp_s,
         cg_iters=[int(i) for i in res.cg_iters], checked_steps=steps)


def _large_problem(n_nodes: int):
    sys.path.insert(0, REPO)
    from bench import synthetic_mesh
    from mycelium_tpu.config import FeaConfig
    coords, conn = synthetic_mesh(n_nodes)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    # bench.py's 309k configuration
    cfg = FeaConfig(dtype="float32", rtol=1e-6, operator="chain",
                    precond="tree", tree_coarse_weight=0.25,
                    tree_reg_rel=1e-7, grip_length=0.3 * ext)
    return coords, conn, cfg


def _anchored(model, active_np):
    import jax.numpy as jnp
    from mycelium_tpu.fea.ramp import anchored_mask_host
    grip = np.asarray(model.top_nodes) | np.asarray(model.bot_nodes)
    return jnp.asarray(anchored_mask_host(np.asarray(model.conn),
                                          active_np, grip))


def phase_large(n_nodes: int = LARGE_NODES) -> None:
    """One cold solve of the 309k-DOF mesh, run as the ramp drivers run
    it (the jitted tree factorization, then the jitted ramp step) and
    checked against spsolve; then the full ramp, which reuses both
    compiled programs."""
    import jax
    import jax.numpy as jnp
    from mycelium_tpu.fea.model import build_model
    from mycelium_tpu.fea.ramp import jit_ramp_step, run_ramp
    from mycelium_tpu.fea.solve import compute_tree_factor

    (coords, conn, cfg), mesh_s = _timed(lambda: _large_problem(n_nodes))
    model, plan_s = _timed(lambda: build_model(coords, conn, cfg))
    active_np = np.ones(model.n_elems, bool)
    active = jnp.asarray(active_np)
    anchored = _anchored(model, active_np)
    x0 = jnp.zeros((model.n_nodes, 3), jnp.float32)
    dy = cfg.displacement_max
    jit_fac = jax.jit(compute_tree_factor, static_argnums=(2,))

    def factor():
        return _block(jit_fac(model, active, cfg, anchored))

    def step(fac):
        return _block(jit_ramp_step(model, cfg, active, x0,
                                    jnp.asarray(dy, jnp.float32),
                                    jnp.asarray(-dy, jnp.float32),
                                    anchored, fac))

    fac, fac_cold = _timed(factor)
    fac, fac_warm = _timed(factor)
    out, step_cold = _timed(lambda: step(fac))
    out, step_warm = _timed(lambda: step(fac))
    u, iters, converged = out[0], out[4], out[6]
    check(bool(converged), "309k cold solve did not converge")
    ref, oracle_s = _timed(lambda: host_reference_solve(
        coords, conn, active_np, dy, cfg))
    err = rel_l2(u, ref)
    check(err < F32_REL_L2, f"309k solve rel L2 {err:.3e} >= {F32_REL_L2}")

    _, ramp_s_cold = _timed(lambda: run_ramp(coords, conn, cfg, model=model))
    ramp, ramp_s_warm = _timed(
        lambda: run_ramp(coords, conn, cfg, model=model))
    stats = jax.devices()[0].memory_stats() or {}
    emit("large", n_nodes=int(coords.shape[0]), n_dof=3 * int(coords.shape[0]),
         n_jumps=int(model.chain.ja.shape[0]), mesh_gen_s=mesh_s,
         plan_s_cold=plan_s, solve_ms_cold=(fac_cold + step_cold) * 1e3,
         solve_ms_warm=(fac_warm + step_warm) * 1e3,
         factor_ms_warm=fac_warm * 1e3,
         compile_s_factor=fac_cold - fac_warm,
         compile_s_step=step_cold - step_warm,
         cg_iters_cold_solve=int(iters), rel_l2_vs_spsolve=err,
         oracle_s=oracle_s, ramp_s_cold=ramp_s_cold,
         ramp_s_warm=ramp_s_warm, compile_s_ramp=ramp_s_cold - ramp_s_warm,
         ramp_steps=int(len(ramp.force_disp)),
         ramp_cg_iters=[int(i) for i in ramp.cg_iters],
         peak_bytes_in_use=int(stats.get("peak_bytes_in_use", -1)))


def _time_growth(cfg, strategy: str) -> dict:
    """Cold first step and warm mean step time of a full run with the
    anastomosis query pinned to ``strategy``."""
    from mycelium_tpu.growth import init_state
    from mycelium_tpu.growth.step import growth_step
    st, ea = init_state(cfg)
    st, cold = _timed(lambda: _block(growth_step(st, ea, cfg, strategy)))
    t0 = time.perf_counter()
    for _ in range(cfg.t_steps - 1):
        st = growth_step(st, ea, cfg, strategy)
    _block(st)
    warm = (time.perf_counter() - t0) / max(cfg.t_steps - 1, 1)
    return {"first_step_s_cold": cold, "step_ms_warm": warm * 1e3,
            "segments": int(st.n_seg)}


def phase_growth_paths(preset: str = "medium", equal_steps: int = 40,
                       timing_cfgs=None) -> None:
    """Incremental grid vs full rebuild (both 'grid' strategy) bit-equal
    over ``equal_steps`` steps of ``preset``; query strategy timings."""
    from mycelium_tpu.bench.growth_scale import PRESETS
    from mycelium_tpu.config import GrowthConfig
    from mycelium_tpu.growth import init_state
    from mycelium_tpu.growth.state import ANASTOMOSED
    from mycelium_tpu.growth.step import growth_step

    cfg_f = dataclasses.replace(PRESETS[preset], t_steps=equal_steps)
    cfg_i = dataclasses.replace(cfg_f, grid_incremental=True)
    st_f, ea = init_state(cfg_f)
    st_i, _ = init_state(cfg_i)
    for _ in range(equal_steps):
        st_f = growth_step(st_f, ea, cfg_f, "grid")
        st_i = growth_step(st_i, ea, cfg_i, "grid")
    fields = ("start", "end", "theta", "phi", "sub", "state", "prev",
              "hypha", "tip", "n_seg", "n_hyp", "env_e")
    differ = [f for f in fields
              if not np.array_equal(np.asarray(getattr(st_f, f)),
                                    np.asarray(getattr(st_i, f)))]
    check(not differ, f"incremental grid differs from full rebuild in "
                      f"{differ}")
    snaps = int(np.sum(np.asarray(st_f.state) == ANASTOMOSED))
    check(snaps > 0, "growth-path comparison saw no anastomosis")

    timing_cfgs = timing_cfgs or {"pipeline": GrowthConfig(),
                                  preset: PRESETS[preset]}
    timings = {f"{name}/{strategy}": _time_growth(cfg, strategy)
               for name, cfg in timing_cfgs.items()
               for strategy in ("window", "grid")}
    emit("growth_paths", preset=preset, equal_steps=equal_steps,
         segments=int(st_f.n_seg), anastomosed=snaps, bit_equal=True,
         strategy_timings=timings)


def grow_ties(st, cfg, band: float = GROW_TIE_BAND) -> np.ndarray:
    """Slots of active tips whose growth test (I*L >= c_g*h0) or branch
    test (I*L >= 2*c_g*h0) is a tie to f32 rounding, judged in f64 on the
    host. The model puts tips exactly on these thresholds (a tip's budget
    is halved from multiples of the cost), and there the f32 outcome is
    decided by the last bit of the arithmetic, which differs between
    backends (the GPU's f32 division is not correctly rounded)."""
    from mycelium_tpu.growth.state import ACTIVE
    tip = np.asarray(st.tip)
    t = np.maximum(tip, 0)
    seg = (np.asarray(st.end, np.float64)[t]
           - np.asarray(st.start, np.float64)[t])
    avail = np.asarray(st.sub, np.float64)[t] * np.linalg.norm(seg, axis=1)
    cost = cfg.c_g * cfg.h0
    live = ((np.arange(len(tip)) < int(st.n_hyp)) & (tip >= 0)
            & (np.asarray(st.state)[t] == ACTIVE))
    tie = live & ((np.abs(avail / cost - 1.0) <= band)
                  | (np.abs(avail / (2.0 * cost) - 1.0) <= band))
    return t[tie]


GROWTH_CONTINUOUS = ("start", "end", "theta", "phi", "sub", "env_e")
GROWTH_DISCRETE = ("state", "prev", "hypha", "tip", "n_seg", "n_hyp")


def _growth_stages(cfg) -> dict:
    """growth_step's ops in its order (growth/step.py), each jitted as
    fn(state, env, k_grow)."""
    import jax
    from mycelium_tpu.growth.neighbors import detect_anastomosis
    from mycelium_tpu.growth.ops import (enforce_walls, grow, translocate,
                                         uptake)
    fns = {"translocate": lambda s, e, k: translocate(s, cfg),
           "grow": lambda s, e, k: grow(s, cfg, k),
           "anastomose": lambda s, e, k: detect_anastomosis(s, cfg),
           "uptake": lambda s, e, k: uptake(s, e, cfg),
           "walls": lambda s, e, k: enforce_walls(s, e, cfg, s.key)}
    return {name: jax.jit(fn) for name, fn in fns.items()}


def _discrete_flips(a, b) -> list:
    return [f for f in GROWTH_DISCRETE
            if not np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f)))]


def phase_precision(coords, conn, gcfg=None, grow_steps: int = 60) -> None:
    """The same f32 inputs on the GPU and on the CPU backend.

    Growth: the GPU step must be deterministic; then each op of one
    growth step runs on both backends from identical inputs (the CPU's
    output of the op before), and every op must give equal discrete
    fields and continuous fields within PRECISION_REL. Growth/branch
    tests that are ties to f32 rounding (grow_ties) are nudged off their
    threshold by TIE_NUDGE in the shared input of ``grow``, and counted.
    The plain whole-step comparison is reported beside it. Solve: one
    cold solve, continuous within PRECISION_REL."""
    import jax
    import jax.numpy as jnp
    from mycelium_tpu.config import GrowthConfig, tuned_fea_config
    from mycelium_tpu.fea.model import build_model
    from mycelium_tpu.fea.solve import solve_displacement
    from mycelium_tpu.growth import init_state
    from mycelium_tpu.growth.step import growth_step

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    gcfg = gcfg or GrowthConfig()
    st, ea = init_state(gcfg)
    for _ in range(grow_steps):
        st = growth_step(st, ea, gcfg)
    out_g = growth_step(st, ea, gcfg)
    again = growth_step(st, ea, gcfg)
    deterministic = all(np.array_equal(np.asarray(x), np.asarray(y))
                        for x, y in zip(jax.tree.leaves(out_g),
                                        jax.tree.leaves(again)))
    whole_flips = _discrete_flips(
        out_g, growth_step(*jax.device_put((st, ea), cpu), gcfg))

    key, k_grow = jax.random.split(st.key)
    s, ea_c, kg_c = jax.device_put((st._replace(key=key), ea, k_grow), cpu)
    stage_diff, stage_flips, n_ties = {}, {}, 0
    for name, fn in _growth_stages(gcfg).items():
        if name == "grow":
            ties = grow_ties(s, gcfg)
            n_ties = int(len(ties))
            s = s._replace(sub=s.sub.at[ties].multiply(1.0 + TIE_NUDGE))
        out_c = fn(s, ea_c, kg_c)
        out_g = fn(*jax.device_put((s, ea_c, kg_c), gpu))
        stage_diff[name] = {f: max_rel_diff(getattr(out_g, f),
                                            getattr(out_c, f))
                            for f in GROWTH_CONTINUOUS}
        flips = _discrete_flips(out_g, out_c)
        if flips:
            stage_flips[name] = flips
        s = out_c

    cfg = dataclasses.replace(tuned_fea_config(), warm_start=False)
    model = build_model(coords, conn, cfg)
    active_np = np.ones(model.n_elems, bool)
    anchored = _anchored(model, active_np)
    dy = cfg.displacement_max / 2
    args = (model, jnp.asarray(active_np), anchored,
            jnp.zeros((model.n_nodes, 3), jnp.float32))
    solve = jax.jit(lambda m, a, an, x0: solve_displacement(
        m, a, dy, -dy, x0, cfg, an))
    res_g = solve(*args)
    res_c = solve(*jax.device_put(args, cpu))
    solve_diff = max_rel_diff(res_g.x, res_c.x)
    emit("precision", growth_step=grow_steps,
         gpu_growth_deterministic=deterministic,
         whole_step_discrete_flips=whole_flips, grow_ties_nudged=n_ties,
         stage_max_rel_diff=stage_diff, stage_discrete_flips=stage_flips,
         solve_max_rel_diff=solve_diff, cg_iters_gpu=int(res_g.iters),
         cg_iters_cpu=int(res_c.iters))
    check(deterministic, "two GPU growth steps from one state differ")
    check(not stage_flips,
          f"discrete growth fields differ GPU vs CPU: {stage_flips}")
    worst = max(max(d.values()) for d in stage_diff.values())
    check(worst <= PRECISION_REL,
          f"growth GPU vs CPU max rel diff {worst:.3e} > {PRECISION_REL}")
    check(solve_diff <= PRECISION_REL,
          f"solve GPU vs CPU max rel diff {solve_diff:.3e} > "
          f"{PRECISION_REL}")


def phase_sharded(meshes: dict, n_dev: int = 4) -> None:
    """Each mesh's ramp sharded over ``n_dev`` devices against the
    single-device run_ramp: same fracture history, per-step rel
    displacement difference < SHARD_REL."""
    import jax
    from mycelium_tpu.fea.model import build_model
    from mycelium_tpu.fea.ramp import run_ramp, run_ramp_sharded
    from mycelium_tpu.fea.shard import default_mesh

    check(len(jax.devices()) >= n_dev,
          f"need {n_dev} devices, have {len(jax.devices())}")
    mesh = default_mesh(n_dev)
    for name, (coords, conn, cfg) in meshes.items():
        model = build_model(coords, conn, cfg)
        row = {"mesh": name, "n_dof": 3 * int(coords.shape[0])}
        for run in ("cold", "warm"):
            one, row[f"single_s_{run}"] = _timed(
                lambda: run_ramp(coords, conn, cfg, model=model))
            shd, row[f"sharded_s_{run}"] = _timed(
                lambda: run_ramp_sharded(coords, conn, cfg, mesh,
                                         model=model))
        check(np.array_equal(one.active_record, shd.active_record),
              f"{name}: sharded fracture history differs")
        per_step = [rel_l2(a, b) for a, b in zip(shd.disp_record,
                                                 one.disp_record)]
        worst = max(per_step)
        row.update(steps=int(len(one.force_disp)), max_step_rel_diff=worst,
                   step_rel_diff=per_step,
                   single_step_s_warm=[float(s) for s in one.solve_seconds],
                   sharded_step_s_warm=[float(s) for s in shd.solve_seconds],
                   cg_iters_single=[int(i) for i in one.cg_iters],
                   cg_iters_sharded=[int(i) for i in shd.cg_iters])
        emit("sharded", **row)
        check(worst < SHARD_REL,
              f"{name}: sharded step rel diff {worst:.3e} >= {SHARD_REL}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the sharded phase, over 4 cards")
    args = p.parse_args(argv)

    import jax
    from mycelium_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    info = phase_device()
    if args.four_gpus:
        from mycelium_tpu.config import GrowthConfig, tuned_fea_config
        from mycelium_tpu.growth import run_growth
        from mycelium_tpu.growth.export import state_mesh
        st, _, _ = run_growth(GrowthConfig())
        coords, conn = state_mesh(st)
        phase_sharded({"pipeline": (coords, conn, tuned_fea_config()),
                       "synthetic_309k": _large_problem(LARGE_NODES)})
    else:
        mesh = phase_pipeline(os.path.join(REPO, "smoke_out", "pipeline"))
        phase_f64(mesh["coords"], mesh["conn"])
        phase_large()
        phase_growth_paths()
        phase_precision(mesh["coords"], mesh["conn"])
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
