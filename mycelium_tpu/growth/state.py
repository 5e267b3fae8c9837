"""Fixed-capacity SoA growth state (the jit-friendly replacement for the
reference's object graph of Hypha/Segment lists — src/mycelium_sim_2D.py:
133-199 — and the C++ AoS structs, src/mycelium_sim_2D.cpp:86-139).

All arrays are pre-allocated at static capacity; new segments claim slots
through prefix-sum allocation and dead capacity is masked, so every growth
step compiles once and never reshapes. Segment slots are assigned in
creation order; within a hypha, slot order is chain order (each extension
takes a fresh higher slot), which export.py uses to reconstruct the
reference's per-hypha traversal order.

Segment states: 0 = empty slot, 1 = 'A' (active tip), 2 = 'P' (passive),
3 = 'S' (anastomosed). The reference documents a 'B' state but never
assigns it (SURVEY.md §2.5.2).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GrowthConfig
from ..scenes import Environment, petri_dish

EMPTY, ACTIVE, PASSIVE, ANASTOMOSED = 0, 1, 2, 3


class EnvArrays(NamedTuple):
    """Static environment geometry on device (nutrient E lives in state)."""
    sub_center: jnp.ndarray   # (S,3)
    sub_size: jnp.ndarray     # (S,3)
    sub_mu: jnp.ndarray       # (S,)
    wall_center: jnp.ndarray  # (W,3)
    wall_size: jnp.ndarray    # (W,3)
    inoculum: jnp.ndarray     # (P,3)


class GrowthState(NamedTuple):
    start: jnp.ndarray    # (N,3)
    end: jnp.ndarray      # (N,3)
    theta: jnp.ndarray    # (N,) polar angle
    phi: jnp.ndarray      # (N,) azimuth
    sub: jnp.ndarray      # (N,) internal substrate I [mol/mm]
    state: jnp.ndarray    # (N,) int8 segment state
    prev: jnp.ndarray     # (N,) int32 predecessor slot (-1 = none)
    hypha: jnp.ndarray    # (N,) int32 owning hypha id
    tip: jnp.ndarray      # (H,) int32 tip slot per hypha (-1 = unused)
    n_seg: jnp.ndarray    # () int32 segments allocated
    n_hyp: jnp.ndarray    # () int32 hyphae allocated
    env_e: jnp.ndarray    # (S,) nutrient remaining per substrate cuboid
    key: jnp.ndarray      # PRNG key
    step: jnp.ndarray     # () int32
    overflow: jnp.ndarray  # () bool — capacity exhausted at some point
    grid: object = None   # Optional[neighbors.SegGrid] — persistent
                          # anastomosis candidate grid
                          # (cfg.grid_incremental); a pure CACHE of the
                          # arrays above: reconstructible at any point,
                          # skipped by checkpoints, attached by
                          # init_state / ensure_grid

    @property
    def capacity(self) -> int:
        return self.start.shape[0]

    def alive(self) -> jnp.ndarray:
        return self.state != EMPTY

    def length(self) -> jnp.ndarray:
        return jnp.linalg.norm(self.end - self.start, axis=1)


def state_env_arrays(env: Environment, cfg: GrowthConfig) -> EnvArrays:
    dtype = jnp.dtype(cfg.dtype)
    return EnvArrays(
        sub_center=jnp.asarray(env.substrate_center, dtype),
        sub_size=jnp.asarray(env.substrate_size, dtype),
        sub_mu=jnp.asarray(env.substrate_mu, dtype),
        wall_center=jnp.asarray(env.wall_center, dtype),
        wall_size=jnp.asarray(env.wall_size, dtype),
        inoculum=jnp.asarray(env.inoculum, dtype),
    )


def direction_from_angles(theta, phi, three_d: bool):
    """2D: (cos phi, sin phi, 0) — theta pinned to pi/2
    (mycelium_sim_2D.py:95-99). 3D: full spherical (mycelium_sim.py:60-63).
    """
    if three_d:
        st = jnp.sin(theta)
        return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi),
                          jnp.cos(theta)], axis=-1)
    z = jnp.zeros_like(phi)
    return jnp.stack([jnp.cos(phi), jnp.sin(phi), z], axis=-1)


def perturb_direction(key, theta, phi, cfg: GrowthConfig):
    """Uniform angular noise in [-lam/2, lam/2).

    2D perturbs phi only and pins theta to pi/2 (mycelium_sim_2D.py:101-109);
    3D perturbs both angles (mycelium_sim.py:65-69).
    """
    lam = cfg.lambda_angle
    if cfg.three_d:
        k1, k2 = jax.random.split(key)
        dth = (jax.random.uniform(k1, theta.shape, theta.dtype) - 0.5) * lam
        dph = (jax.random.uniform(k2, phi.shape, phi.dtype) - 0.5) * lam
        return theta + dth, phi + dph
    dph = (jax.random.uniform(key, phi.shape, phi.dtype) - 0.5) * lam
    return jnp.full_like(theta, jnp.pi / 2), phi + dph


def init_state(cfg: GrowthConfig, env: Environment | None = None,
               seed: int | None = None) -> tuple[GrowthState, EnvArrays]:
    """Seed the inoculum: each site spawns h0_per_point hyphae of one
    segment each with random initial direction; the substrate budget
    Omega0 is split evenly over sites then over hyphae
    (mycelium_sim_2D.py:247-270)."""
    if env is None:
        env = petri_dish(cfg)
    ea = state_env_arrays(env, cfg)
    dtype = jnp.dtype(cfg.dtype)
    N, H = cfg.max_segments, cfg.max_hyphae
    P = ea.inoculum.shape[0]
    n0 = P * cfg.h0_per_point
    if n0 > N or n0 > H:
        raise ValueError("capacity too small for inoculum")

    key = jax.random.PRNGKey(cfg.seed if seed is None else seed)
    key, k_th, k_ph = jax.random.split(key, 3)
    theta0 = jax.random.uniform(k_th, (n0,), dtype) * jnp.pi
    phi0 = jax.random.uniform(k_ph, (n0,), dtype) * (2 * jnp.pi)
    starts0 = jnp.repeat(ea.inoculum, cfg.h0_per_point, axis=0)
    dir0 = direction_from_angles(theta0, phi0, cfg.three_d)
    ends0 = starts0 + dir0 * cfg.h0
    per_seg = (cfg.omega0 / P) / cfg.h0_per_point
    sub0 = jnp.full((n0,), per_seg / cfg.h0, dtype)

    def pad(x, fill, n=N):
        out = jnp.full((n,) + x.shape[1:], fill, x.dtype)
        return out.at[:x.shape[0]].set(x)

    st = GrowthState(
        start=pad(starts0, 0.0),
        end=pad(ends0, 0.0),
        theta=pad(theta0, 0.0),
        phi=pad(phi0, 0.0),
        sub=pad(sub0, 0.0),
        state=pad(jnp.full((n0,), ACTIVE, jnp.int8), EMPTY),
        prev=jnp.full((N,), -1, jnp.int32),
        hypha=pad(jnp.arange(n0, dtype=jnp.int32), -1),
        tip=jnp.full((H,), -1, jnp.int32).at[:n0].set(
            jnp.arange(n0, dtype=jnp.int32)),
        n_seg=jnp.asarray(n0, jnp.int32),
        n_hyp=jnp.asarray(n0, jnp.int32),
        env_e=jnp.asarray(env.substrate_e0, dtype),
        key=key,
        step=jnp.asarray(0, jnp.int32),
        overflow=jnp.asarray(False),
    )
    return ensure_grid(st, cfg), ea


def ensure_grid(st: GrowthState, cfg: GrowthConfig) -> GrowthState:
    """Attach the persistent anastomosis grid when cfg.grid_incremental and
    the state doesn't carry one (fresh init, loaded checkpoint). Must run
    OUTSIDE any scan: the grid changes the carry pytree structure."""
    if not cfg.grid_incremental or st.grid is not None:
        return st
    from .neighbors import empty_grid
    return st._replace(grid=empty_grid(cfg, st.capacity,
                                       jnp.dtype(cfg.dtype)))
