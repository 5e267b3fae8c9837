"""Tracing / profiling hooks (reference §5.1 equivalents).

The reference ships cProfile dumps (profile_output*.prof) and hand-rolled
wall timers writing runtime.txt / solve_runtime.txt / runtime_results.csv.
The rebuild keeps those file contracts (io.writers) and adds the device
instrument: jax.profiler traces viewable in TensorBoard/Perfetto.

    with trace("/tmp/trace"):
        run_ramp(...)

    timer = StepTimer()
    with timer.step():
        ...
    timer.write("fea_results/solve_runtime.txt")
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import jax

from ..io.writers import write_solve_runtimes


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace (the KSPView/cProfile stand-in)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Per-step wall timers matching the reference's solve_runtime.txt
    contract (src/fea_solver.py:213-215,247,260-261)."""

    def __init__(self):
        self.seconds: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.append(time.perf_counter() - t0)

    def write(self, path_or_dir: str) -> None:
        import os
        d = path_or_dir
        if d.endswith(".txt"):
            d = os.path.dirname(d)
        write_solve_runtimes(d or ".", self.seconds)
