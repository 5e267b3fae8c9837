"""mycelium_tpu — a JAX rebuild of the mycelium growth + FEA pipeline.

A JAX/XLA framework with the capabilities of the `mycelium-fea-project`
reference (see SURVEY.md): a lattice-free stochastic model of fungal
network growth coupled to a quasi-static tensile FEA pass — fixed-capacity
jit-compiled growth state, matrix-free preconditioned sparse solves, and
`shard_map` data parallelism in place of PETSc/MPI. It runs on an NVIDIA
GPU (tests run on the CPU).
"""

from . import config, scenes
from .config import FeaConfig, GrowthConfig, archive_parity_config

__version__ = "0.1.0"

__all__ = ["config", "scenes", "FeaConfig", "GrowthConfig",
           "archive_parity_config", "__version__"]
