"""Configuration pytrees for the JAX mycelium + FEA pipeline.

The reference keeps all parameters as module-level constants with no config
system (reference: src/mycelium_sim_2D.py:23-41, src/fea_solver.py:14-28).
Here every run is parameterized by two frozen dataclasses whose defaults
reproduce the reference constants exactly, and which serialize to JSON into
each results directory (closing the §5.6 config gap noted in SURVEY.md).

All fields are static (Python numbers) so a config instance can be closed
over by jit-compiled functions without retracing hazards.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class GrowthConfig:
    """Parameters of the stochastic hyphal growth model.

    Defaults mirror reference src/mycelium_sim_2D.py:23-41 (2D variant).
    Use :func:`growth_3d_config` for the 3D variant's overrides
    (reference: src/mycelium_sim.py:21-48).
    """

    seed: int = 42                     # mycelium_sim_2D.py:16
    h0: float = 0.05                   # mm, segment length
    dt: float = 0.01                   # days
    lambda_angle: float = math.pi / 6  # max angular perturbation
    p_branch: float = 0.5              # branching probability
    c_g: float = 1e-7                  # mol/mm, cost of growth
    diffusion: float = 3.456           # mm/day, internal diffusion coeff D
    m_cap: float = 2e-6                # mol/mm, max substrate per mm
    omega0: float = 5e-6               # mol, total initial internal substrate
    t_steps: int = 150                 # number of growth steps
    anastomosis_tol: float = 1e-3      # mm
    wall_thickness: float = 0.05       # mm
    dish_size: float = 5.0             # mm
    height: float = 0.1                # mm (z extent of the dish volume)
    h0_per_point: int = 10             # hyphae per inoculum site
    substrate_width: float = 5.0       # mm (y extent of substrate cuboid)
    dist_inoculum: float = 0.5         # mm grid spacing of inoculum points
    inoculum_nx: int = 5               # inoculum grid (2D variant)
    inoculum_ny: int = 5
    three_d: bool = False              # full-sphere directions + z-walls
    substrate_e0: float = 2e-6         # mol, initial cuboid nutrient E
    substrate_mu: float = 1e8          # uptake coefficient mu

    # --- rebuild additions (static shapes / query knobs) ---
    max_segments: int = 1 << 14        # fixed segment capacity (slots)
    max_hyphae: int = 1 << 13          # fixed hypha capacity
    voxel_size: float = 0.1            # neighbor-grid cell size (call-site value,
                                       # mycelium_sim_2D.py:661 — NOT the 0.2 class default)
    max_per_cell: int = 64             # static cap on segments gathered per grid cell
    max_tips_per_cell: int = 16        # static cap on active tips per cell in the
                                       # anastomosis query (>= h0_per_point covers
                                       # the co-located inoculum tips; large scenes
                                       # can lower it — cost scales linearly)
    grid_incremental: bool = False     # persistent APPEND-ONLY cell grid of
                                       # finalized segments + per-step tip-
                                       # segment overlay, replacing the full
                                       # per-step rebucket (an N-slot argsort
                                       # + full-grid geometry gather). A
                                       # segment's geometry freezes when its
                                       # hypha extends past it (walls and
                                       # anastomosis mutate TIP slots only),
                                       # so finalized entries never go stale;
                                       # mutable tip segments live in the
                                       # overlay, rebuilt per step over H
                                       # rows instead of N. Forces the 'grid'
                                       # query strategy.
    grid_update_cap: int = 1 << 16     # chunk size of the incremental insert
                                       # batch; steps finalizing more than
                                       # this many segments loop more chunks.
                                       # Also the one-off resume path: a grid
                                       # rebuilt from a checkpoint inserts
                                       # the whole backlog in these chunks.
    dtype: str = "float32"

    @property
    def n_inoculum(self) -> int:
        return 6 if self.three_d else self.inoculum_nx * self.inoculum_ny


def growth_3d_config(**overrides) -> GrowthConfig:
    """The 3D variant's parameter set (reference: src/mycelium_sim.py:21-48,585-600)."""
    base = dict(
        t_steps=25,
        anastomosis_tol=5e-3,
        substrate_width=2.0,
        three_d=True,
    )
    base.update(overrides)
    return GrowthConfig(**base)


@dataclass(frozen=True)
class FeaConfig:
    """Parameters of the quasi-static tensile pull test.

    Defaults mirror reference src/fea_solver.py:14-28. ``area`` and ``moi``
    are derived exactly as the reference derives A and I.
    """

    e_mod: float = 2500.0              # MPa, Young's modulus
    d: float = 2e-4                    # mm, fiber outer diameter
    t: float = 1e-6                    # mm, wall thickness
    n_steps: int = 40
    displacement_max: float = 0.02     # mm (archived test_* runs used 0.06 — see
                                       # SURVEY.md §2.4; use archive_parity_config())
    max_strain: float = 0.018
    grip_length: float = 1.5           # mm, grip selection tolerance
    reg: float = 1e-12                 # diagonal regularization (fea_solver.py:125)

    # --- solver knobs (replace PETSc -ksp_type/-pc_type) ---
    solver: str = "cg"                 # 'cg' | 'bicgstab' | 'gmres'
    precond: str = "block_jacobi"      # 'block_jacobi' | 'jacobi' | 'none'
                                       # | 'tree' (exact spanning-forest
                                       # elimination; ~100x fewer CG iters
                                       # on mycelium meshes)
                                       # | 'coarse' (block-Jacobi + 128-node
                                       # cluster Galerkin coarse grid;
                                       # requires operator='chain')
    tree_coarse_weight: float = 0.0    # >0 adds w x the 128-node-cluster
                                       # Galerkin coarse correction to the
                                       # tree PC (captures long-wavelength
                                       # coupling through anastomosis
                                       # loops)
    tree_reg_rel: float = 1e-5         # tree-PC diagonal floor, relative to
                                       # the median element stiffness: caps
                                       # the amplification of tree-floating
                                       # fracture fragments (the operator's
                                       # own reg stays cfg.reg). PCR loses
                                       # ~(k_scale/floor)^2 digits on
                                       # reg-held fragment blocks, so this
                                       # default keeps the PC residual at
                                       # ~1e-6 |r| under heavy unanchored
                                       # fracture; production ramps pin
                                       # fragments via the anchored mask,
                                       # so tuned_fea_config lowers the
                                       # floor to 1e-7 — the 1e-5 floor
                                       # sits ABOVE the soft bending modes
                                       # of long hyphae (~k_bd*(pi/len)^4)
                                       # and inflates CG iterations at
                                       # 1e5+ DOF
    tree_max_path_len: int = 128       # chop tree-schedule paths longer
                                       # than this (0 = unbounded): bounds
                                       # the PCR round count r =
                                       # ceil(log2(max len)), and with it
                                       # the factor's 2*r*9 coefficient
                                       # planes per slot
    tree_dense_tail: int = 256         # fold trailing elimination levels
                                       # whose combined slot count is below
                                       # this into ONE dense junction-Schur
                                       # inverse (0 = pure PCR): the tail
                                       # levels are tiny (9/2-slot shapes at
                                       # 103k nodes), each level adds an
                                       # unrolled op chain to the compiled
                                       # factor, and a small dense inverse
                                       # is one matvec per PC apply. Not yet
                                       # re-derived on the GPU
    operator: str = "ell"              # 'ell' (gather-only SpMV) | 'scatter'
                                       # | 'chain' (shifts + jump matmuls)
    coarse_basis: str = "const"        # two-level PC coarse space per
                                       # chain cluster: 'const' |
                                       # 'linear' (adds an in-chain ramp).
                                       # 'linear' doubles the coarse system
                                       # (halving the node count at which
                                       # coarse_max_dim widens clusters)
    coarse_max_dim: int = 1536         # cap on the dense coarse operator's
                                       # dimension: clusters widen from one
                                       # 128-position chain block to k
                                       # blocks so n_basis*3*ceil(nb/k)
                                       # stays under this. Uncapped, the
                                       # dense inverse grows as n/128*3
                                       # (7.7k x 7.7k at 330k nodes, 23k at
                                       # 1e6). Not yet re-derived on the GPU
    gmres_restart: int = 32            # Arnoldi restart length for the
                                       # 'gmres' solver leg
    cg_restarts: int = 2               # tree-PC CG: on a plateau, rebuild
                                       # the Krylov space from the TRUE
                                       # residual b - K·x up to this many
                                       # times before accepting the floor
                                       # (f32 recurrence drift can pin the
                                       # residual far above the real floor
                                       # at 1e5+ nodes; see solve.pcg).
                                       # Weak-PC configs (sweep jacobi
                                       # legs) ignore it.
    rtol: float = 1e-8                 # CG relative residual tolerance
    atol: float = 0.0
    max_iter: int = 20000
    warm_start: bool = True            # reuse previous ramp step's solution
    dtype: str = "float32"

    @property
    def area(self) -> float:
        # A = 3.14*((d/2)^2 - (d/2 - t)^2)     (fea_solver.py:17)
        return 3.14 * ((self.d / 2) ** 2 - (self.d / 2 - self.t) ** 2)

    @property
    def moi(self) -> float:
        # I = A*0.001                          (fea_solver.py:20)
        return self.area * 0.001

    @property
    def max_stress(self) -> float:
        return self.e_mod * self.max_strain


def tuned_fea_config(**overrides) -> FeaConfig:
    """Performance solver preset: chain-ordered operator + spanning-forest
    (tree) preconditioner with the cluster coarse correction. Numerics are
    unchanged — CG converges to the same displacement field (same rtol),
    it just takes ~60x fewer iterations on mycelium meshes (see
    fea/tree.py). The preset does not depend on the backend.
    """
    base = dict(operator="chain", precond="tree", tree_coarse_weight=0.25,
                tree_reg_rel=1e-7)
    base.update(overrides)
    return FeaConfig(**base)


def archive_parity_config(**overrides) -> FeaConfig:
    """Config matching the archived results/test_* runs.

    The archived fixtures were generated with DISPLACEMENT_MAX=0.06 and grips
    on the extreme nodes only (SURVEY.md §2.4: per-step dy = 0.06/39 and
    interior nodes displace linearly), not with fea_solver.py's current
    defaults.
    """
    base = dict(displacement_max=0.06, grip_length=0.5, dtype="float64",
                rtol=1e-12)
    base.update(overrides)
    return FeaConfig(**base)


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def save_config(cfg, path: str) -> None:
    with open(path, "w") as f:
        json.dump({"type": type(cfg).__name__, **dataclasses.asdict(cfg)}, f,
                  indent=2)


def load_config(path: str):
    with open(path) as f:
        data = json.load(f)
    kind = data.pop("type")
    cls = {"GrowthConfig": GrowthConfig, "FeaConfig": FeaConfig}[kind]
    return cls(**data)


def save_run_configs(out_dir: str, growth: GrowthConfig | None = None,
                     fea: FeaConfig | None = None) -> None:
    """Serialize the configs that produced a results/sim_* directory."""
    os.makedirs(out_dir, exist_ok=True)
    if growth is not None:
        save_config(growth, os.path.join(out_dir, "growth_config.json"))
    if fea is not None:
        save_config(fea, os.path.join(out_dir, "fea_config.json"))
