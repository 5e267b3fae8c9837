"""Fused growth step and drivers (reference component C13, the 150-step
demo loop src/mycelium_sim_2D.py:630-691).

Per-step op order matches the reference driver exactly
(mycelium_sim_2D.py:667-673):
  translocate -> grow/branch -> (rebuild cell index) -> anastomose ->
  uptake -> walls -> stats.

The cell index rebuild is folded into detect_anastomosis (it is the only
consumer). One call to growth_step is one fully-jitted XLA program; the
drivers differ only in where the loop lives:
- run_growth: Python loop, streams per-step stats to host (for CSV output
  and snapshots) — the shape of the reference demo;
- run_growth_scan: lax.fori_loop entirely on device (benchmark path).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GrowthConfig
from ..scenes import Environment, petri_dish
from .neighbors import detect_anastomosis
from .ops import enforce_walls, grow, translocate, uptake
from .state import (ACTIVE, ANASTOMOSED, EMPTY, PASSIVE, EnvArrays,
                    GrowthState, init_state)


@partial(jax.jit, static_argnums=(2, 3))
def growth_step(st: GrowthState, env: EnvArrays, cfg: GrowthConfig,
                strategy: str | None = None) -> GrowthState:
    """One growth step. ``strategy`` pins the anastomosis query strategy
    (neighbors.detect_anastomosis); None takes the platform default."""
    key, k_grow = jax.random.split(st.key)
    st = st._replace(key=key)
    st = translocate(st, cfg)
    st = grow(st, cfg, k_grow)
    st = detect_anastomosis(st, cfg, strategy)
    st = uptake(st, env, cfg)
    st = enforce_walls(st, env, cfg, st.key)
    return st._replace(step=st.step + 1)


@partial(jax.jit, static_argnums=(1,))
def summarize_device(st: GrowthState, cfg: GrowthConfig):
    """Per-step network statistics (mycelium_sim_2D.py:201-242)."""
    alive = st.state != EMPTY
    return dict(
        hyphae=st.n_hyp,
        segments=jnp.sum(alive).astype(jnp.int32),
        active_tips=jnp.sum(st.state == ACTIVE).astype(jnp.int32),
        passive_tips=jnp.sum(st.state == PASSIVE).astype(jnp.int32),
        anastomosed=jnp.sum(st.state == ANASTOMOSED).astype(jnp.int32),
        branches=jnp.maximum(0, st.n_hyp - cfg.n_inoculum),
        total_length_mm=jnp.sum(jnp.where(alive, st.length(), 0.0)),
    )


def summarize(st: GrowthState, cfg: GrowthConfig) -> Dict:
    d = jax.device_get(summarize_device(st, cfg))
    return {k: (float(v) if k == "total_length_mm" else int(v))
            for k, v in d.items()}


def run_growth(cfg: GrowthConfig, env: Environment | None = None,
               seed: int | None = None,
               on_step: Optional[Callable[[int, GrowthState], None]] = None,
               verbose: bool = False,
               initial_state: Optional[GrowthState] = None,
               checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 0):
    """Python-loop driver: returns (final_state, env_arrays, history) where
    history is the per-step stats list in reference column order.

    Pass ``initial_state`` (e.g. from io.checkpoint.load_growth_state) to
    resume a run mid-trajectory: the PRNG key lives in the state, so the
    continuation is bit-identical to an uninterrupted run. With
    ``checkpoint_path`` + ``checkpoint_every``, the state is saved every k
    steps (closing the reference's no-restart gap, SURVEY.md §5.4).
    """
    if env is None:
        env = petri_dish(cfg)
    st, ea = init_state(cfg, env, seed)
    if initial_state is not None:
        st = initial_state
    start_step = int(jax.device_get(st.step))
    device_stats = []     # fetched in ONE device_get at the end, not
    for t in range(start_step, cfg.t_steps):   # one host sync per step
        st = growth_step(st, ea, cfg)
        if checkpoint_path and checkpoint_every > 0 \
                and (t + 1) % checkpoint_every == 0:
            from ..io.checkpoint import save_growth_state
            save_growth_state(checkpoint_path, st)
        device_stats.append(summarize_device(st, cfg))
        if verbose or on_step is not None:
            stats = summarize(st, cfg)
            stats["step"] = t
            if verbose:
                print(f"Step {t}: {stats}")
            if on_step is not None:
                on_step(t, st)
    fetched = jax.device_get(device_stats)
    history: List[Dict] = []
    for t, d in zip(range(start_step, cfg.t_steps), fetched):
        row = {k: (float(v) if k == "total_length_mm" else int(v))
               for k, v in d.items()}
        row["step"] = t
        history.append(row)
    if bool(jax.device_get(st.overflow)):
        import warnings
        warnings.warn("growth capacity exhausted: increase "
                      "GrowthConfig.max_segments/max_hyphae")
    return st, ea, history


@partial(jax.jit, static_argnums=(2,))
def _scan_growth(st: GrowthState, env: EnvArrays, cfg: GrowthConfig):
    def body(carry, _):
        st = growth_step(carry, env, cfg)
        stats = summarize_device(st, cfg)
        return st, stats

    return jax.lax.scan(body, st, None, length=cfg.t_steps)


@partial(jax.jit, static_argnums=(2, 3))
def _scan_growth_chunk(st: GrowthState, env: EnvArrays, cfg: GrowthConfig,
                       n_steps: int):
    def body(carry, _):
        st = growth_step(carry, env, cfg)
        stats = summarize_device(st, cfg)
        return st, stats

    return jax.lax.scan(body, st, None, length=n_steps)


def run_growth_scan(cfg: GrowthConfig, env: Environment | None = None,
                    seed: int | None = None):
    """Fully-on-device driver: one XLA program for the whole run; stats for
    every step come back stacked."""
    if env is None:
        env = petri_dish(cfg)
    st, ea = init_state(cfg, env, seed)
    st, stats = _scan_growth(st, ea, cfg)
    jax.block_until_ready(st.n_seg)
    history = []
    stats = jax.device_get(stats)
    for t in range(cfg.t_steps):
        row = {k: (float(v[t]) if k == "total_length_mm" else int(v[t]))
               for k, v in stats.items()}
        row["step"] = t
        history.append(row)
    return st, ea, history


def run_growth_chunked(cfg: GrowthConfig, env: Environment | None = None,
                       seed: int | None = None, chunk_steps: int = 10,
                       verbose: bool = False):
    """Scan driver split into bounded device executions.

    The one-program scan (`run_growth_scan`) is the fastest shape for
    benchmark-sized runs; at the xlarge preset (2^21 segment slots) the
    whole 150-step run would be one long device execution. Here the scan
    runs `chunk_steps` steps per dispatch with a host sync between chunks,
    which also reports progress. Whether a local GPU needs the bound is
    not yet measured. The trajectory is bit-identical to run_growth_scan:
    same ops, same order, the chunk boundary only moves the loop carry
    through the host queue.
    """
    if env is None:
        env = petri_dish(cfg)
    st, ea = init_state(cfg, env, seed)
    parts = []
    done = 0
    while done < cfg.t_steps:
        n = min(chunk_steps, cfg.t_steps - done)
        t0 = time.perf_counter()
        st, stats = _scan_growth_chunk(st, ea, cfg, n)
        parts.append(jax.device_get(stats))   # fetch = the only real sync
        done += n
        if verbose:
            print(f"  growth steps {done - n}..{done - 1}: "
                  f"{time.perf_counter() - t0:.2f} s "
                  f"({int(parts[-1]['segments'][-1])} segments)",
                  flush=True)
    history = []
    for ci, stats in enumerate(parts):
        base = ci * chunk_steps
        for t in range(len(stats["segments"])):
            row = {k: (float(v[t]) if k == "total_length_mm"
                       else int(v[t])) for k, v in stats.items()}
            row["step"] = base + t
            history.append(row)
    return st, ea, history
