"""The quasi-static tensile pull test (reference component C25).

40-step displacement ramp, dy = ±DISPLACEMENT_MAX·step/(N_STEPS−1): solve
K·U = F under grip BCs, compute reactions with the pre-BC stiffness
(SURVEY.md §2.5.10), evaluate axial strains on the undeformed geometry,
deactivate elements with |strain| > MAX_STRAIN, record the force-displacement
curve, and stop early once the network has fully fractured (reference
src/fea_solver.py:186-335, src/fea_petsc.cpp:156-537).

Two drivers:
- run_ramp: Python loop around one jitted step — supports the reference's
  early stop and streams records to host (CSV writers);
- run_ramp_scan: single fully-jitted lax.scan over all steps — used for
  benchmarking and as the sharded multi-chip entry (no host sync per step).
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FeaConfig
from .elements import element_strain
from .model import FeaModel, apply_stiffness, build_model
from .solve import solve_displacement


class RampResult(NamedTuple):
    stress_record: np.ndarray    # (n_rec, E)
    active_record: np.ndarray    # (n_rec, E) bool
    disp_record: np.ndarray      # (n_rec, n_dof) DOF order [n0x,n0y,n0z,...]
    force_disp: np.ndarray       # (n_rec, 2) [2*dy, total_force]
    solve_seconds: np.ndarray    # (n_rec,)
    cg_iters: np.ndarray         # (n_rec,) iterations per solve
    total_seconds: float


def _step_factors(cfg: FeaConfig, step):
    factor = step / (cfg.n_steps - 1)
    return cfg.displacement_max * factor, -cfg.displacement_max * factor


def anchored_mask_host(conn: np.ndarray, active: np.ndarray,
                       grip: np.ndarray) -> np.ndarray:
    """Nodes reachable from a grip through active elements (host-side BFS
    via scipy connected components). Unreachable nodes form fracture islands
    whose exact solution is zero — the solver pins them (see solve.py)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    n = grip.shape[0]
    act = conn[active.astype(bool)]
    adj = coo_matrix((np.ones(len(act)), (act[:, 0], act[:, 1])),
                     shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    grip_labels = np.unique(labels[grip])
    return np.isin(labels, grip_labels)


def anchored_mask_device(model: FeaModel, active: jnp.ndarray) -> jnp.ndarray:
    """Device-side grip-reachability by monotone label propagation over the
    ELL neighbor table (runs inside jit for the scan driver; O(graph
    diameter) sweeps, each a single gather)."""
    grip = jnp.logical_or(model.top_nodes, model.bot_nodes)
    act_pad = jnp.concatenate([active, jnp.zeros((1,), bool)])
    link_ok = act_pad[model.incident]                      # (N, deg)

    def cond(c):
        return c[1]

    def body(c):
        anch, _ = c
        anch_pad = jnp.concatenate([anch, jnp.zeros((1,), bool)])
        nb = jnp.logical_and(anch_pad[model.neighbor], link_ok)
        new = jnp.logical_or(grip, jnp.any(nb, axis=1))
        return new, jnp.any(new != anch)

    anch, _ = jax.lax.while_loop(cond, body, (grip, jnp.asarray(True)))
    return anch


def ramp_step(model: FeaModel, cfg: FeaConfig, active, x0, dy_top, dy_bot,
              anchored=None, tree_factor_val=None):
    """One ramp step: solve -> reactions -> stress -> fracture.

    ``tree_factor_val`` optionally carries a precomputed tree-PC
    factorization (solve.compute_tree_factor) — the drivers reuse it
    across steps whose active mask did not change."""
    res = solve_displacement(model, active, dy_top, dy_bot, x0, cfg,
                             anchored, tree_factor_val=tree_factor_val)
    u = res.x                                            # (N,3)
    stress, active_new, total_force = post_solve(model, cfg, u, active)
    return (u, stress, active_new, total_force, res.iters, res.resnorm,
            res.converged)


class SolveDivergedError(RuntimeError):
    """A ramp solve failed to converge — the drivers refuse to record the
    step, mirroring the reference's KSPGetConvergedReason abort
    (src/fea_petsc.cpp:343-354) and LinAlgError catch
    (src/fea_solver.py:250-254)."""


def _check_converged(converged, step: int, resnorm) -> None:
    if not bool(converged):
        raise SolveDivergedError(
            f"solver diverged at ramp step {step + 1}: "
            f"|r| = {float(resnorm):.3e} after max_iter iterations "
            "(reference aborts here, fea_petsc.cpp:343-354)")


# the model is passed as a PYTREE ARGUMENT, never closed over: closed-over
# device arrays become constants embedded in the executable (compiled into
# the program and re-uploaded with it); cfg is hashable and static.
jit_ramp_step = jax.jit(ramp_step, static_argnums=(1,))


def post_solve(model: FeaModel, cfg: FeaConfig, u, active):
    """Reactions -> stress -> fracture, given a solved displacement field
    (shared by the single-chip and sharded ramp drivers)."""
    f_react = apply_stiffness(model, u, active,
                              "ell" if cfg.operator == "chain"
                              else cfg.operator)
    total_force = jnp.sum(jnp.where(model.top_nodes, f_react[:, 1], 0.0))
    strain = element_strain(u, model.conn, model.geom)
    stress = jnp.where(active, cfg.e_mod * strain, 0.0)
    active_new = jnp.logical_and(active, jnp.abs(strain) <= cfg.max_strain)
    return stress, active_new, total_force


jit_post_solve = jax.jit(post_solve, static_argnums=(1,))


def run_ramp(coords, conn, cfg: FeaConfig,
             model: Optional[FeaModel] = None,
             verbose: bool = False,
             checkpoint_path: Optional[str] = None,
             checkpoint_every: int = 0,
             resume_from: Optional[str] = None,
             profile: Optional[dict] = None) -> RampResult:
    """Python-loop ramp driver. ``checkpoint_path``/``checkpoint_every``
    save the resumable mid-ramp state (active mask, last displacement,
    accumulated records) every N steps; ``resume_from`` continues an
    interrupted ramp bit-identically (closing the reference's §5.4 gap —
    a killed SLURM job there is simply re-run from scratch).

    ``profile``, if given, receives per-phase wall-time totals (seconds):
    dispatch (async step_jit call), converged_fetch (the per-step scalar
    sync), active_fetch, scalar_fetch (force/iters), flush (record
    pulls), anchored + factor (fracture refreshes) — the non-solve
    overhead breakdown."""
    t0 = time.time()
    prof = profile if profile is not None else {}
    for k in ("dispatch", "converged_fetch", "active_fetch",
              "scalar_fetch", "flush", "anchored", "factor", "steps",
              "refreshes"):
        prof.setdefault(k, 0.0)

    def _clk():
        return time.perf_counter()
    if model is None:
        model = build_model(coords, conn, cfg)
    dtype = model.coords.dtype

    def step_jit(*args):
        return jit_ramp_step(model, cfg, *args)

    conn_np = np.asarray(model.conn)
    grip_np = np.asarray(jnp.logical_or(model.top_nodes, model.bot_nodes))

    start_step = 0
    active = jnp.ones((model.n_elems,), dtype=bool)
    u_prev = jnp.zeros((model.n_nodes, 3), dtype=dtype)
    prev_factor = 0.0
    stress_rec, active_rec, disp_rec, fd_rec = [], [], [], []
    solve_secs, iters_rec = [], []
    if resume_from is not None:
        from ..io.checkpoint import load_ramp_state
        start_step, active_np_in, u_prev_np, recs = \
            load_ramp_state(resume_from)
        active = jnp.asarray(active_np_in)
        u_prev = jnp.asarray(u_prev_np, dtype=dtype)
        # the previous step ran at factor (start_step-1)/(n_steps-1)
        prev_factor = (start_step - 1) / (cfg.n_steps - 1) \
            if start_step > 0 else 0.0
        stress_rec = list(recs["stress"])
        active_rec = list(recs["active"])
        disp_rec = list(recs["disp"])
        fd_rec = [list(r) for r in recs["fd"]]
        solve_secs = list(recs["solve_secs"])
        iters_rec = [int(i) for i in recs["iters"]]

    anchored = jnp.asarray(anchored_mask_host(
        conn_np, np.asarray(active), grip_np))

    # reuse the tree-PC factorization across steps with an unchanged
    # active mask (it dominates the cold-solve cost at 1e5+ DOF)
    use_fac = (getattr(model, "tree_fast", None) is not None
               and cfg.operator == "chain" and cfg.precond == "tree")
    from .solve import compute_tree_factor
    jit_fac = jax.jit(compute_tree_factor, static_argnums=(2,))
    fac = jit_fac(model, active, cfg, anchored) if use_fac else None

    def _save_checkpoint(next_step):
        from ..io.checkpoint import save_ramp_state
        save_ramp_state(
            checkpoint_path, next_step, np.asarray(active),
            np.asarray(u_prev),
            records=dict(stress=np.stack(stress_rec),
                         active=np.stack(active_rec),
                         disp=np.stack(disp_rec),
                         fd=np.asarray(fd_rec, dtype=np.float64),
                         solve_secs=np.asarray(solve_secs),
                         iters=np.asarray(iters_rec, dtype=np.int64)))

    # device-side grip reachability for fracture refreshes (no mask fetch
    # + scipy label pass per event); the tree-accelerated device sweep is
    # the same mask the scan driver uses (scan==loop golden equality pins
    # them to each other)
    if model.tree is not None:
        from .tree_jax import tree_anchored
        jit_anch = jax.jit(lambda m, act: tree_anchored(m.tree, m, act))
    else:
        jit_anch = None

    # record fetches are PIPELINED: the (u, stress) pulls of step k-1 run
    # while step k executes on device — only the control-flow values
    # (converged, active mask, force) block on the current step
    pending = None

    def _flush(p):
        u_d, stress_d = p
        stress_rec.append(np.asarray(stress_d))
        disp_rec.append(np.asarray(u_d).reshape(-1))

    for step in range(start_step, cfg.n_steps):
        if step > 0 and int(np.asarray(active).sum()) == 0:
            break   # resumed past full fracture: nothing left to solve
        dy_top, dy_bot = _step_factors(cfg, step)
        # warm start: scale the previous solution by the ramp ratio (the
        # response is linear between fracture events)
        factor = step / (cfg.n_steps - 1)
        if cfg.warm_start and prev_factor > 0:
            x0 = u_prev * (factor / prev_factor)
        else:
            x0 = jnp.zeros_like(u_prev)
        ts = time.time()
        tq = _clk()
        u, stress, active_new, total_force, iters, resnorm, converged = \
            step_jit(active, x0, jnp.asarray(dy_top, dtype),
                     jnp.asarray(dy_bot, dtype), anchored, fac)
        prof["dispatch"] += _clk() - tq
        if pending is not None:
            tq = _clk()
            _flush(pending)        # overlaps the dispatched solve above
            prof["flush"] += _clk() - tq
            pending = None
        tq = _clk()
        conv_now = bool(converged)
        prof["converged_fetch"] += _clk() - tq
        _check_converged(conv_now, step, resnorm)
        solve_secs.append(time.time() - ts)

        tq = _clk()
        active_new_np = np.asarray(active_new)
        prof["active_fetch"] += _clk() - tq
        active_rec.append(active_new_np)
        tq = _clk()
        fd_rec.append([dy_top - dy_bot, float(total_force)])
        iters_rec.append(int(iters))
        prof["scalar_fetch"] += _clk() - tq
        pending = (u, stress)
        if verbose:
            print(f"step {step + 1}/{cfg.n_steps} dy={dy_top:.5f} "
                  f"iters={int(iters)} res={float(resnorm):.3e} "
                  f"active={int(active_new_np.sum())}")

        prof["steps"] += 1
        if not np.array_equal(active_new_np, np.asarray(active)):
            # fracture changed the topology: refresh grip reachability
            # and the tree-PC factorization
            prof["refreshes"] += 1
            tq = _clk()
            if jit_anch is not None:
                anchored = jit_anch(model, active_new)
            else:
                anchored = jnp.asarray(
                    anchored_mask_host(conn_np, active_new_np, grip_np))
            prof["anchored"] += _clk() - tq
            if use_fac:
                tq = _clk()
                fac = jit_fac(model, active_new, cfg, anchored)
                prof["factor"] += _clk() - tq
        u_prev, active, prev_factor = u, active_new, factor
        if checkpoint_path is not None and checkpoint_every > 0 \
                and (step + 1 - start_step) % checkpoint_every == 0:
            _flush(pending)
            pending = None
            _save_checkpoint(step + 1)
        if int(active_new_np.sum()) == 0:
            break  # early stop on full fracture (fea_solver.py:293-295)
    if pending is not None:
        _flush(pending)

    return RampResult(
        stress_record=np.stack(stress_rec),
        active_record=np.stack(active_rec),
        disp_record=np.stack(disp_rec),
        force_disp=np.asarray(fd_rec, dtype=np.float64),
        solve_seconds=np.asarray(solve_secs),
        cg_iters=np.asarray(iters_rec, dtype=np.int64),
        total_seconds=time.time() - t0,
    )


def _device_ramp_step(model: FeaModel, cfg: FeaConfig, carry, bufs,
                      step, factor, prev_factor):
    """One ramp step with records written into preallocated device
    buffers (donated across dispatches). Mirrors _scan_ramp's body —
    solve, post-process, conditional anchored/factor refresh — but is
    dispatched step-by-step from the host so the program compiles once
    at any mesh size (the 40-step scan program stalls the compiler past
    ~300k nodes) while the host NEVER syncs inside the ramp."""
    active, u_prev, anchored, fac = carry
    dtype = model.coords.dtype
    dy_top = cfg.displacement_max * factor
    scale = jnp.where(prev_factor > 0,
                      factor / jnp.where(prev_factor > 0, prev_factor, 1.0),
                      0.0)
    x0 = u_prev * scale if cfg.warm_start else jnp.zeros_like(u_prev)
    u, stress, active_new, total_force, iters, resnorm, converged = \
        ramp_step(model, cfg, active, x0, dy_top, -dy_top, anchored, fac)
    if model.tree is not None:
        from .tree_jax import tree_anchored
        recompute = lambda: tree_anchored(model.tree, model, active_new)  # noqa: E731
    else:
        recompute = lambda: anchored_mask_device(model, active_new)  # noqa: E731
    changed = jnp.any(active_new != active)
    anchored = jax.lax.cond(changed, recompute, lambda: anchored)
    use_fac = fac is not None
    if use_fac:
        from .solve import compute_tree_factor
        fac = jax.lax.cond(
            changed,
            lambda: compute_tree_factor(model, active_new, cfg, anchored),
            lambda: fac)
    bufs = dict(
        stress=bufs["stress"].at[step].set(stress),
        active=bufs["active"].at[step].set(active_new),
        disp=bufs["disp"].at[step].set(u.reshape(-1)),
        status=bufs["status"].at[step].set(jnp.stack([
            converged.astype(dtype),
            jnp.sum(active_new).astype(dtype),
            iters.astype(dtype),
            total_force.astype(dtype)])),
    )
    return (active_new, u, anchored, fac), bufs


def _device_ramp_chunk(model: FeaModel, cfg: FeaConfig, carry, bufs,
                       steps, factors_c, prev_factors_c):
    """``len(steps)`` ramp steps as ONE dispatched lax.scan program.
    The body is _device_ramp_step verbatim (compiled once per chunk
    LENGTH, not per step), so a 40-step ramp is 5 host dispatches
    instead of 40, which cuts the host's per-step dispatch overhead."""
    def body(state, inp):
        c, b = state
        k, factor, prev_factor = inp
        return _device_ramp_step(model, cfg, c, b, k, factor,
                                 prev_factor), None

    (carry, bufs), _ = jax.lax.scan(body, (carry, bufs),
                                    (steps, factors_c, prev_factors_c))
    return carry, bufs


def run_ramp_async(coords, conn, cfg: FeaConfig,
                   model: Optional[FeaModel] = None,
                   sync_every: int = 8) -> RampResult:
    """Host-dispatch ramp with DEVICE-RESIDENT records: the per-step
    host round-trips of ``run_ramp`` (converged + active + force +
    iters fetches plus the two record pulls) are replaced by ONE status
    fetch per ``sync_every`` steps and one record fetch at the end.
    Whether this still pays on a local GPU is not yet measured. Early stop
    and the divergence guard run at sync granularity; records are
    truncated at the full-fracture step exactly like the scan driver
    (scan≡loop equality pins both to ``run_ramp``).

    Reference analogue: the same 40-step driver loop
    (src/fea_solver.py:216-295) — this is the latency-hiding variant of
    ``run_ramp`` for benchmarking and headless production runs (no
    per-step checkpointing/verbose). ``solve_seconds`` is the
    CHUNK-AMORTIZED wall time (each sync chunk's wall time divided
    evenly over its steps) — per-step device times are not observable
    without the per-step syncs this driver exists to avoid; the
    runtime.txt writers stay NaN-free. The record pull at the end is
    one serial fetch."""
    t0 = time.time()
    if model is None:
        model = build_model(coords, conn, cfg)
    dtype = model.coords.dtype
    n_steps = cfg.n_steps

    use_fac = (getattr(model, "tree_fast", None) is not None
               and cfg.operator == "chain" and cfg.precond == "tree")
    from .solve import compute_tree_factor

    all_active = jnp.ones((model.n_elems,), bool)
    if model.tree is not None:
        from .tree_jax import tree_anchored
        anch0 = jax.jit(lambda m, a: tree_anchored(m.tree, m, a))(
            model, all_active)
    else:
        anch0 = jax.jit(anchored_mask_device)(model, all_active)
    fac0 = jax.jit(compute_tree_factor, static_argnums=(2,))(
        model, all_active, cfg, anch0) if use_fac else None
    carry = (all_active, jnp.zeros((model.n_nodes, 3), dtype), anch0, fac0)
    bufs = dict(
        stress=jnp.zeros((n_steps, model.n_elems), dtype),
        active=jnp.zeros((n_steps, model.n_elems), bool),
        disp=jnp.zeros((n_steps, 3 * model.n_nodes), dtype),
        status=jnp.zeros((n_steps, 4), dtype),
    )

    # donate carry + buffers: every chunk updates them in place instead
    # of allocating copies of the ~70 MB record set
    chunk_fn = jax.jit(_device_ramp_chunk, static_argnums=(1,),
                      donate_argnums=(2, 3))

    factors = [s / (n_steps - 1) for s in range(n_steps)]
    stopped = n_steps
    # chunk-amortized per-step seconds: wall time between status syncs,
    # spread evenly over the chunk's steps (see docstring)
    secs = np.zeros((n_steps,))
    chunk_lo, chunk_t0 = 0, time.time()

    def _close_chunk(hi):
        nonlocal chunk_lo, chunk_t0
        now = time.time()
        if hi > chunk_lo:
            secs[chunk_lo:hi] = (now - chunk_t0) / (hi - chunk_lo)
        chunk_lo, chunk_t0 = hi, now

    lo = 0
    while lo < n_steps:
        hi = min(lo + sync_every, n_steps)
        prevs = [factors[s - 1] if s else 0.0 for s in range(lo, hi)]
        carry, bufs = chunk_fn(
            model, cfg, carry, bufs,
            jnp.arange(lo, hi, dtype=jnp.int32),
            jnp.asarray(factors[lo:hi], dtype),
            jnp.asarray(prevs, dtype))
        lo = hi
        if lo < n_steps:
            status = np.asarray(bufs["status"])      # blocks on the chunk
            _close_chunk(lo)
            _check_status(status, lo)
            if status[lo - 1, 1] == 0:               # fully fractured
                stopped = lo
                break
    status = np.asarray(bufs["status"])
    last = min(stopped, n_steps)
    _close_chunk(last)
    _check_status(status, last)

    fd = np.stack([2 * cfg.displacement_max * np.asarray(factors[:last]),
                   status[:last, 3].astype(np.float64)], axis=1)
    res = RampResult(
        stress_record=np.asarray(bufs["stress"])[:last],
        active_record=np.asarray(bufs["active"])[:last],
        disp_record=np.asarray(bufs["disp"])[:last],
        force_disp=fd,
        solve_seconds=secs[:last],
        cg_iters=status[:last, 2].astype(np.int64),
        total_seconds=time.time() - t0,
    )
    return truncate_after_fracture(res)


def _check_status(status: np.ndarray, n_done: int) -> None:
    conv = status[:n_done, 0] > 0
    alive_before = np.concatenate([[1.0], status[:n_done - 1, 1]]) > 0
    bad = np.nonzero(~conv & alive_before)[0]
    if len(bad):
        raise SolveDivergedError(
            f"solver diverged at ramp step {int(bad[0]) + 1}: "
            "(reference aborts here, fea_petsc.cpp:343-354)")


@partial(jax.jit, static_argnums=(1,))
def _scan_ramp(model: FeaModel, cfg: FeaConfig):
    dtype = model.coords.dtype
    factors = (jnp.arange(cfg.n_steps, dtype=dtype) / (cfg.n_steps - 1))

    use_fac = (getattr(model, "tree_fast", None) is not None
               and cfg.operator == "chain" and cfg.precond == "tree")
    from .solve import compute_tree_factor

    def body(carry, factor):
        active, u_prev, prev_factor, anchored, fac = carry
        dy_top = cfg.displacement_max * factor
        scale = jnp.where(prev_factor > 0, factor
                          / jnp.where(prev_factor > 0, prev_factor, 1.0), 0.0)
        x0 = u_prev * scale if cfg.warm_start else jnp.zeros_like(u_prev)
        u, stress, active_new, total_force, iters, resnorm, converged = \
            ramp_step(model, cfg, active, x0, dy_top, -dy_top, anchored,
                      fac)
        # refresh grip reachability (and the tree-PC factorization) only
        # when fracture changed the topology
        if model.tree is not None:
            # tree-accelerated sweep: whole hyphae per fixpoint round
            # instead of one hop (~7x fewer sweeps than the plain BFS)
            from .tree_jax import tree_anchored
            recompute = lambda: tree_anchored(model.tree, model, active_new)  # noqa: E731
        else:
            recompute = lambda: anchored_mask_device(model, active_new)  # noqa: E731
        changed = jnp.any(active_new != active)
        anchored = jax.lax.cond(changed, recompute, lambda: anchored)
        if use_fac:
            fac = jax.lax.cond(
                changed,
                lambda: compute_tree_factor(model, active_new, cfg,
                                            anchored),
                lambda: fac)
        carry = (active_new, u, factor, anchored, fac)
        return carry, (stress, active_new, u.reshape(-1),
                       jnp.stack([2 * dy_top, total_force]), iters,
                       converged)

    all_active = jnp.ones((model.n_elems,), dtype=bool)
    if model.tree is not None:
        from .tree_jax import tree_anchored
        anch0 = tree_anchored(model.tree, model, all_active)
    else:
        anch0 = anchored_mask_device(model, all_active)
    fac0 = compute_tree_factor(model, all_active, cfg, anch0) \
        if use_fac else None
    init = (all_active,
            jnp.zeros((model.n_nodes, 3), dtype=dtype),
            jnp.zeros((), dtype),
            anch0, fac0)
    _, out = jax.lax.scan(body, init, factors)
    return out


def run_ramp_scan(coords, conn, cfg: FeaConfig,
                  model: Optional[FeaModel] = None) -> RampResult:
    """Fully-jitted ramp: one XLA program for all steps (no early stop —
    after full fracture the remaining solves are trivial identity solves)."""
    t0 = time.time()
    if model is None:
        model = build_model(coords, conn, cfg)
    if model.n_nodes > (1 << 18):
        # Large-mesh models run the ramp as the Python-loop driver: the
        # two-program composition (jitted factorization + jitted CG
        # step, chained on the host) reuses the factorization across
        # steps with an unchanged active mask, while one n_steps-scan
        # would put the factorization + whole CG in a single much larger
        # program to compile, for a per-dispatch saving that is noise
        # next to solves of this size.
        return run_ramp(coords, conn, cfg, model=model)
    stress, active, disp, fd, iters, converged = _scan_ramp(model, cfg)
    jax.block_until_ready(stress)
    total = time.time() - t0
    conv_np = np.asarray(converged)
    if not conv_np.all():
        bad = int(np.nonzero(~conv_np)[0][0])
        raise SolveDivergedError(
            f"solver diverged at ramp step {bad + 1} "
            f"({int((~conv_np).sum())} of {cfg.n_steps} steps failed); "
            "no records written")
    return RampResult(
        stress_record=np.asarray(stress),
        active_record=np.asarray(active),
        disp_record=np.asarray(disp),
        force_disp=np.asarray(fd, dtype=np.float64),
        solve_seconds=np.full((cfg.n_steps,), np.nan),
        cg_iters=np.asarray(iters, dtype=np.int64),
        total_seconds=total,
    )


def run_ramp_sharded(coords, conn, cfg: FeaConfig, mesh,
                     model: Optional[FeaModel] = None,
                     verbose: bool = False,
                     checkpoint_path: Optional[str] = None,
                     checkpoint_every: int = 0,
                     resume_from: Optional[str] = None) -> RampResult:
    """The full pull test with every solve domain-decomposed over a device
    mesh — the end-to-end equivalent of the reference's MPI binary
    (mpirun -np 4 fea_petsc_parallel, SURVEY.md §3.4). Records match the
    single-chip driver to solver tolerance (asserted in tests).

    Production feature parity with ``run_ramp``: the tree-PC factorization
    is computed once and reused across steps whose active mask did not
    change; fracture events refresh grip reachability device-side
    (tree_anchored, no host BFS per event); the
    (u, stress) record fetches of step k-1 overlap step k's solve; and the
    checkpoint/resume flags match the single-chip driver.

    The mesh may span MULTIPLE PROCESSES (a jax.distributed cluster over
    the global device set — the reference's mpirun model): every process
    runs the same driver, record fetches go through a cross-process
    all-gather, and file writes (checkpoints here, CSVs at the CLI) are
    coordinator-only — the reference's every-rank-writes bug
    (fea_petsc_parallel.cpp:487-570) fixed by construction.
    """
    from .shard import sharded_cg_solver
    from .solve import compute_tree_factor
    t0 = time.time()
    if model is None:
        model = build_model(coords, conn, cfg)
    dtype = model.coords.dtype
    solver = sharded_cg_solver(model, cfg, mesh)

    multiproc = jax.process_count() > 1

    def fetch(x):
        """Device->host for a (possibly cross-process) global array."""
        if multiproc:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(
                x, tiled=True))
        return np.asarray(x)

    conn_np = np.asarray(model.conn)
    grip_np = np.asarray(jnp.logical_or(model.top_nodes, model.bot_nodes))

    # multi-process: everything fed to the solver must be a process-local
    # host value (replicated), so state stays numpy there; single-process
    # keeps device arrays to avoid host round-trips
    def as_state(x, np_dtype=None):
        if multiproc:
            return np.asarray(x, np_dtype) if np_dtype else np.asarray(x)
        return jnp.asarray(x) if np_dtype is None \
            else jnp.asarray(x, np_dtype)

    start_step = 0
    active = as_state(np.ones((model.n_elems,), bool))
    u_prev = as_state(np.zeros((model.n_nodes, 3)), dtype)
    prev_factor = 0.0
    stress_rec, active_rec, disp_rec, fd_rec = [], [], [], []
    solve_secs, iters_rec = [], []
    if resume_from is not None:
        from ..io.checkpoint import load_ramp_state
        start_step, active_np_in, u_prev_np, recs = \
            load_ramp_state(resume_from)
        active = as_state(active_np_in)
        u_prev = as_state(u_prev_np, dtype)
        prev_factor = (start_step - 1) / (cfg.n_steps - 1) \
            if start_step > 0 else 0.0
        stress_rec = list(recs["stress"])
        active_rec = list(recs["active"])
        disp_rec = list(recs["disp"])
        fd_rec = [list(r) for r in recs["fd"]]
        solve_secs = list(recs["solve_secs"])
        iters_rec = [int(i) for i in recs["iters"]]

    # device-side grip reachability (matches run_ramp / the scan driver)
    if model.tree is not None:
        from .tree_jax import tree_anchored
        jit_anch = jax.jit(lambda m, act: tree_anchored(m.tree, m, act))
        anchored = as_state(np.asarray(jit_anch(model, jnp.asarray(active))))
    else:
        jit_anch = None
        anchored = as_state(anchored_mask_host(
            conn_np, np.asarray(active), grip_np))

    # tree-PC factor reuse across unchanged-mask steps: computed on the
    # local default device (replicated input to the sharded solve; in
    # multi-process runs every rank computes the identical factor, the
    # redundant-PC half of the PETSc pattern)
    use_fac = (getattr(model, "tree_fast", None) is not None
               and cfg.operator == "chain" and cfg.precond == "tree")
    jit_fac = jax.jit(compute_tree_factor, static_argnums=(2,))

    def make_factor(act, anch):
        if not use_fac:
            return None
        fac = jit_fac(model, act, cfg, anch)
        # multi-process jit requires replicated inputs be process-local
        # host values (each rank computed the identical factor)
        return jax.device_get(fac) if multiproc else fac

    fac = make_factor(active, anchored)

    def _save_checkpoint(next_step):
        from ..io.checkpoint import save_ramp_state   # coordinator-guarded
        save_ramp_state(
            checkpoint_path, next_step, np.asarray(active),
            np.asarray(u_prev),
            records=dict(stress=np.stack(stress_rec),
                         active=np.stack(active_rec),
                         disp=np.stack(disp_rec),
                         fd=np.asarray(fd_rec, dtype=np.float64),
                         solve_secs=np.asarray(solve_secs),
                         iters=np.asarray(iters_rec, dtype=np.int64)))

    # record fetches PIPELINED like run_ramp: step k-1's (u, stress) pull
    # overlaps step k's dispatched solve. Multi-process runs instead pull
    # the sharded solution once per step through the cross-process
    # all-gather (a collective, inherently synchronous) and do ALL
    # post-processing on process-local arrays — the reference's parallel
    # binary makes the same redundant-postprocessing choice
    # (fea_petsc_parallel.cpp:439-460), minus its every-rank-writes bug.
    pending = None

    def _flush(p):
        u_f, stress_f = p
        disp_rec.append(np.asarray(u_f).reshape(-1))
        stress_rec.append(np.asarray(stress_f))

    active_np = np.asarray(active)
    for step in range(start_step, cfg.n_steps):
        if step > 0 and int(active_np.sum()) == 0:
            break   # resumed past full fracture: nothing left to solve
        dy_top, dy_bot = _step_factors(cfg, step)
        factor = step / (cfg.n_steps - 1)
        if cfg.warm_start and prev_factor > 0:
            x0 = u_prev * (factor / prev_factor)
        else:
            x0 = jnp.zeros_like(u_prev) if not multiproc \
                else np.zeros_like(u_prev)
        ts = time.time()
        res = solver(active, jnp.asarray(dy_top, dtype),
                     jnp.asarray(dy_bot, dtype), x0, anchored, fac)
        if multiproc:
            x_step = fetch(res.x)                  # full (N,3) numpy
            x_post = jnp.asarray(x_step)           # local device copy
        else:
            x_step = x_post = res.x
        stress, active_new, total_force = jit_post_solve(
            model, cfg, x_post, active)
        if pending is not None:
            _flush(pending)        # overlaps the dispatched solve above
            pending = None
        _check_converged(res.converged, step, res.resnorm)
        solve_secs.append(time.time() - ts)

        active_new_np = np.asarray(active_new)
        active_rec.append(active_new_np)
        fd_rec.append([dy_top - dy_bot, float(total_force)])
        iters_rec.append(int(res.iters))
        pending = (x_step, stress)
        if verbose:
            print(f"step {step + 1}: iters {int(res.iters)} "
                  f"active {int(active_new_np.sum())}")

        if not np.array_equal(active_new_np, active_np):
            # fracture changed the topology: refresh grip reachability
            # and the tree-PC factorization
            if jit_anch is not None:
                anchored = jit_anch(model, active_new)
                if multiproc:
                    anchored = np.asarray(anchored)
            else:
                anchored = jnp.asarray(
                    anchored_mask_host(conn_np, active_new_np, grip_np))
            fac = make_factor(active_new, anchored)
        # multi-process: everything fed back into the solver must be a
        # process-local host value (replicated input), not a committed
        # local device array
        u_prev = x_step if multiproc else res.x
        active = active_new_np if multiproc else active_new
        active_np, prev_factor = active_new_np, factor
        if checkpoint_path is not None and checkpoint_every > 0 \
                and (step + 1 - start_step) % checkpoint_every == 0:
            _flush(pending)
            pending = None
            _save_checkpoint(step + 1)
        if int(active_new_np.sum()) == 0:
            break
    if pending is not None:
        _flush(pending)

    return RampResult(
        stress_record=np.stack(stress_rec),
        active_record=np.stack(active_rec),
        disp_record=np.stack(disp_rec),
        force_disp=np.asarray(fd_rec, dtype=np.float64),
        solve_seconds=np.asarray(solve_secs),
        cg_iters=np.asarray(iters_rec, dtype=np.int64),
        total_seconds=time.time() - t0,
    )


def truncate_after_fracture(res: RampResult) -> RampResult:
    """Cut scan-mode records at the early-stop point the Python-loop driver
    (and the reference) would have produced: records up to and including the
    step where the last element fractured."""
    n_active = res.active_record.sum(axis=1)
    dead = np.nonzero(n_active == 0)[0]
    n_rec = (dead[0] + 1) if len(dead) else len(n_active)
    return RampResult(*(x[:n_rec] for x in res[:6]), res.total_seconds)
