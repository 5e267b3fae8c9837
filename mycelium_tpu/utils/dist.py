"""Multi-process (multi-host) initialization and coordinator-only IO.

JAX counterpart of the reference's MPI process model
(src/fea_petsc_parallel.cpp:156-171: MPI_Init via PetscInitialize,
MPI_Comm_rank/size, mpirun -np N): JAX processes connected by
``jax.distributed.initialize`` (SURVEY.md §5.8's PetscInitialize mapping).
Inside a process nothing changes — jit/shard_map programs simply see the
global device set. One process drives one card: a JAX process reserves
most of every card it can see, so each process is restricted to its own
(``JAX_LOCAL_DEVICE_IDS``, by default the card numbered like the
process).

IO discipline: exactly ONE process writes result files. The reference's
parallel binary gets this wrong — every rank opens the same CSVs
(fea_petsc_parallel.cpp:487-570, a documented bug, SURVEY.md §2.5.14) —
here every writer call site is guarded by ``is_coordinator()``.

Single-process behavior is unchanged: without ``initialize_distributed``
(or with world size 1) ``process_index()`` is 0 and every guard passes.
"""

from __future__ import annotations

import os
from typing import Optional

_initialized = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[list] = None) -> None:
    """Connect this process to a multi-process JAX cluster.

    Must run before the first JAX computation (same constraint as
    PetscInitialize). Arguments default to the environment variables
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID /
    JAX_LOCAL_DEVICE_IDS (comma-separated). The first three are required:
    nothing here auto-detects a cluster. Without local device ids the
    process takes the single card ``[process_id]`` — the layout of N
    processes on one N-card host.
    """
    global _initialized
    import jax
    coordinator_address = coordinator_address or \
        os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "distributed run needs JAX_COORDINATOR_ADDRESS (host:port), "
            "JAX_NUM_PROCESSES and JAX_PROCESS_ID")
    if local_device_ids is None:
        env_ids = os.environ.get("JAX_LOCAL_DEVICE_IDS")
        local_device_ids = ([int(i) for i in env_ids.split(",")]
                            if env_ids else [process_id])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    _initialized = True


def process_index() -> int:
    """This process's rank (0 in single-process runs)."""
    import jax
    return jax.process_index()


def process_count() -> int:
    import jax
    return jax.process_count()


def is_coordinator() -> bool:
    """True exactly on the process that owns result-file IO (rank 0 —
    the VecScatterCreateToZero/rank-0-writer role of the reference,
    fea_petsc_parallel.cpp:374-428, minus its every-rank-writes bug)."""
    return process_index() == 0


def coordinator_barrier(name: str = "io") -> None:
    """Block until all processes arrive (e.g. before the coordinator
    reads files another stage just wrote). No-op single-process."""
    import jax
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
