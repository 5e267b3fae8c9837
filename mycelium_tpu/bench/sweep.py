"""Solver x preconditioner sweep harness (reference component C20).

The reference benchmarks 3 KSP types x 5 PETSc preconditioners x 5 trials
per ramp step and writes step,solver,pc,trial,runtime_ms
(src/fea_petsc_solverAndPC.cpp:221-223,326-391). The rebuild sweeps the
same 3x5 matrix shape: (cg, bicgstab, gmres) x (tree, coarse,
block_jacobi, jacobi, none) — tree plays the icc/ilu role (exact
factorization-grade PC), coarse the gamg role (two-level coarse grid) —
over the same ramp with the same CSV schema. Unlike the reference — which leaks per-trial
vectors and keeps only the last combo's solution for the physics
(SURVEY.md §2.5.14) — the physics here always advances with the primary
config's solution.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FeaConfig
from ..fea.model import build_model
from ..fea.ramp import anchored_mask_host, ramp_step
from ..io.writers import write_sweep_results

DEFAULT_SOLVERS = ("cg", "bicgstab", "gmres")
DEFAULT_PCS = ("tree", "coarse", "block_jacobi", "jacobi", "none")


def run_solver_sweep(coords, conn, cfg: FeaConfig,
                     solvers: Sequence[str] = DEFAULT_SOLVERS,
                     pcs: Sequence[str] = DEFAULT_PCS,
                     trials: int = 5,
                     out_csv: Optional[str] = None,
                     verbose: bool = False,
                     chain_trials=None,
                     return_meta: bool = False):
    """Returns rows (step, solver, pc, trial, runtime_ms); the timed kernel
    is one full cold-start solve (x0 = 0) of the current ramp system.

    ``chain_trials``: optional dict (or int) — each trial times a chain of
    that many data-dependent cold solves in flight and reports the mean,
    amortizing the per-dispatch host overhead. A dict maps pc name ->
    chain length (fast combos warrant longer chains). Default 1 keeps the
    reference's one-solve-per-trial semantics.

    When ``out_csv`` is given, a ``*_meta.json`` sidecar is written next
    to it so the artifact is self-describing without external prose:
    per-combo chain length (rows are CHAIN MEANS when k > 1, not
    independent solves), per-combo converged-step fraction and
    median iteration count — a reader comparing against the reference's
    runtime_results.csv can see at a glance which legs' medians are
    capped cost rather than converged solves. ``return_meta`` returns
    (rows, meta) instead of rows."""
    # build the model with the superset of solver plans (chain ordering +
    # tree schedule) so every swept combo finds what it needs, whatever
    # the primary cfg uses
    build_cfg = dataclasses.replace(cfg, operator="chain", precond="tree")
    model = build_model(coords, conn, build_cfg)
    dtype = model.coords.dtype

    # one jitted solver per combo; physics advances with the primary cfg.
    # the model rides along as a pytree argument, not a closure constant
    # (see ramp.jit_ramp_step)
    from ..fea.ramp import jit_ramp_step

    def make_fn(ccfg):
        return lambda *a: jit_ramp_step(model, ccfg, *a)

    def make_cold_fn(ccfg):
        # chained-trial variant: the cold restart (x0 scaled to zero)
        # lives INSIDE the jit, so no eager op is timed with the solve
        f = jax.jit(lambda m, act, xc, dt, db, anch: ramp_step(
            m, ccfg, act, xc * 1e-30, dt, db, anch))
        return lambda act, xc, dt, db, anch: f(model, act, xc, dt, db,
                                               anch)

    combos = {}
    for s in solvers:
        for pc in pcs:
            ccfg = dataclasses.replace(cfg, solver=s, precond=pc,
                                       warm_start=False)
            combos[(s, pc)] = (make_fn(ccfg), make_cold_fn(ccfg))
    primary = make_fn(cfg)

    if chain_trials is None:
        chain_map = {}
    elif isinstance(chain_trials, int):
        chain_map = {pc: chain_trials for pc in pcs}
    else:
        # keys may be pc names or (solver, pc) pairs; pair wins. Chain
        # length only amortizes dispatch overhead — slow combos should
        # run chains of 1, or a capped non-converging combo multiplies
        # its worst case by the chain length
        chain_map = dict(chain_trials)

    conn_np = np.asarray(model.conn)
    grip_np = np.asarray(jnp.logical_or(model.top_nodes, model.bot_nodes))
    active = jnp.ones((model.n_elems,), dtype=bool)
    anchored = jnp.asarray(anchored_mask_host(
        conn_np, np.ones(model.n_elems, bool), grip_np))
    u_prev = jnp.zeros((model.n_nodes, 3), dtype=dtype)
    prev_factor = 0.0
    zeros = jnp.zeros((model.n_nodes, 3), dtype=dtype)

    rows: List[Tuple] = []
    # per-combo convergence record (sidecar provenance): iters/converged
    # of the LAST timed solve each step — read off the already-computed
    # result, no extra solves (a capped 3 s leg must not pay a 6th solve)
    combo_stats = {key: {"iters": [], "converged": []} for key in combos}
    warmed = set()
    for step in range(cfg.n_steps):
        factor = step / (cfg.n_steps - 1)
        dy = jnp.asarray(cfg.displacement_max * factor, dtype)
        for (s, pc), (fn, fn_cold) in combos.items():
            k = int(chain_map.get((s, pc), chain_map.get(pc, 1)))
            if chain_trials is None:
                # reference one-solve-per-trial semantics; warm the jit
                # cache outside the timed region
                fn(active, zeros, dy, -dy, anchored)[0].block_until_ready()
                out = None
                for trial in range(trials):
                    t0 = time.perf_counter()
                    out = fn(active, zeros, dy, -dy, anchored)
                    out[0].block_until_ready()
                    ms = (time.perf_counter() - t0) * 1e3
                    rows.append((step, s, pc, trial, ms))
            else:
                def chain(kk):
                    xc, out = zeros, None
                    for _ in range(kk):
                        out = fn_cold(active, xc, dy, -dy, anchored)
                        xc = out[0]
                    jax.block_until_ready(xc)
                    return out

                if (s, pc) not in warmed:
                    chain(2)        # compile warm-up (program per combo)
                    warmed.add((s, pc))
                out = None
                for trial in range(trials):
                    t0 = time.perf_counter()
                    out = chain(k)
                    ms = (time.perf_counter() - t0) * 1e3 / k
                    rows.append((step, s, pc, trial, ms))
            # fetch AFTER the timed region (ramp_step tuple: [4]=iters,
            # [6]=converged)
            combo_stats[(s, pc)]["iters"].append(int(out[4]))
            combo_stats[(s, pc)]["converged"].append(bool(out[6]))
        if verbose:
            last = [r for r in rows if r[0] == step]
            best = min(last, key=lambda r: r[4])
            per = {}
            for r in last:
                per.setdefault(f"{r[1]}+{r[2]}", []).append(r[4])
            combo_s = " ".join(
                f"{k}:{float(np.median(v)):.1f}" for k, v in per.items())
            print(f"step {step}: best {best[1]}+{best[2]} "
                  f"{best[4]:.2f} ms | {combo_s}", flush=True)

        # advance physics with the primary configuration
        x0 = u_prev * (factor / prev_factor) \
            if (cfg.warm_start and prev_factor > 0) else zeros
        u, _, active_new, _, _, resnorm, converged = primary(
            active, x0, dy, -dy, anchored)
        if not bool(converged):
            # the reference's sweep would abort via KSPGetConvergedReason;
            # physics must not advance on a garbage solution
            from ..fea.ramp import SolveDivergedError
            raise SolveDivergedError(
                f"primary solver diverged at sweep step {step + 1}: "
                f"|r| = {float(resnorm):.3e}")
        active_new_np = np.asarray(active_new)
        if not np.array_equal(active_new_np, np.asarray(active)):
            anchored = jnp.asarray(anchored_mask_host(conn_np, active_new_np,
                                                      grip_np))
        u_prev, active, prev_factor = u, active_new, factor
        if active_new_np.sum() == 0:
            break

    meta = {
        "row_semantics": "runtime_ms is the MEAN over a chain of "
                         "chain_len data-dependent cold solves when "
                         "chain_len > 1 (dispatch amortization, see "
                         "docstring); one timed solve when chain_len = 1",
        "combos": {
            f"{s}+{pc}": {
                "chain_len": int(chain_map.get((s, pc),
                                               chain_map.get(pc, 1)))
                if chain_trials is not None else 1,
                "converged_steps": int(sum(st["converged"])),
                "steps": len(st["converged"]),
                "median_iters": float(np.median(st["iters"]))
                if st["iters"] else None,
                "max_iters": int(max(st["iters"])) if st["iters"] else None,
            }
            for (s, pc), st in combo_stats.items()
        },
    }
    if out_csv is not None:
        write_sweep_results(out_csv, rows)
        import json
        import os
        base, _ = os.path.splitext(out_csv)
        with open(base + "_meta.json", "w") as f:
            json.dump(meta, f, indent=1)
    if return_meta:
        return rows, meta
    return rows
