"""Growth-throughput benchmark: steps/sec at growing network sizes.

BASELINE.json's north star asks for growth steps/sec alongside PCG
solves/sec. The reference's growth engines are single-threaded
object-graph walkers: the archived cProfile run (BASELINE.md) spends
0.75 s/step at ~2k segments (3D, 25 steps = 18.76 s); the 150-step 2D
demo reaches 7.5k segments. Here the whole run is one XLA program
(`run_growth_scan`); scaling beyond the demo uses a wider dish with a
denser inoculum grid so the network genuinely fills the domain.

Run:  python -m mycelium_tpu.bench.growth_scale [preset ...]
Presets: demo (reference-sized), medium (~30k segments), large (~1e5),
xlarge (~1e6). Prints one JSON line per preset. Needs a GPU; every row
names the device it ran on.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

from ..config import GrowthConfig

PRESETS = {
    # the reference demo: 25 sites, 150 steps -> ~7k segments
    "demo": GrowthConfig(),
    # 121 sites on a 10 mm dish -> ~3e4 segments at step 150
    "medium": GrowthConfig(
        dish_size=10.0, substrate_width=10.0,
        inoculum_nx=11, inoculum_ny=11,
        omega0=5e-6 * (121 / 25),        # same substrate budget per site
        max_segments=1 << 16, max_hyphae=1 << 15,
    ),
    # 441 sites on a 20 mm dish -> ~1e5 segments at step 150
    "large": GrowthConfig(
        dish_size=20.0, substrate_width=20.0,
        inoculum_nx=21, inoculum_ny=21,
        omega0=5e-6 * (441 / 25),
        max_segments=1 << 18, max_hyphae=1 << 17,
        # keep the default per-cell tip cap (16): sizing it to the step-0
        # worst case (h0_per_point=10) silently truncates cells where tips
        # from neighboring sites converge mid-run; the dense-grid query now
        # raises the overflow flag when that happens
    ),
    # 4,356 sites on a 33 mm dish -> ~1e6 segments at step 150 (the
    # SURVEY.md M4 scale target; fixed-capacity state at 2^21 slots)
    "xlarge": GrowthConfig(
        dish_size=35.0, substrate_width=35.0,
        inoculum_nx=66, inoculum_ny=66,
        omega0=5e-6 * (4356 / 25),
        # hypha capacity sized to the workload (~235k peak) + ~11%
        # headroom: every per-hypha op (grow staging, walls sweeps, the
        # tip overlay) is H-row-bound, so slack capacity is pure padding;
        # overflow surfaces via the state flag
        max_segments=1 << 21, max_hyphae=1 << 18,
        # persistent candidate grid instead of a per-step 2M-slot
        # rebucket (bit-equality vs the full rebuild tested in
        # test_growth_ops.py::test_incremental_grid_*)
        grid_incremental=True,
    ),
}


def run(names, t_steps: int | None = None, verbose: bool = False):
    import jax

    from ..device import device_info, require_gpu
    from ..growth.step import run_growth_chunked, run_growth_scan
    from ..utils import enable_compilation_cache
    require_gpu()
    enable_compilation_cache()
    dev = device_info()

    results = []
    for name in names:
        cfg = PRESETS[name]
        if t_steps is not None:
            cfg = dataclasses.replace(cfg, t_steps=t_steps)
        # xlarge-class runs (>= 2^20 slots) split into bounded device
        # executions (run_growth_chunked docstring)
        if cfg.max_segments >= 1 << 20:
            driver = lambda c: run_growth_chunked(  # noqa: E731
                c, chunk_steps=10, verbose=verbose)
        else:
            driver = run_growth_scan
        # warm-up runs the SAME program: scan length is baked into the XLA
        # program, so a short-run warm-up would not precompile it (the
        # persistent cache makes this near-free on repeat invocations).
        # The chunked driver's program unit is one chunk_steps-scan, so a
        # single chunk warms it fully — but it must run with the IDENTICAL
        # static cfg: cfg is a static jit argument, and a
        # replace(cfg, t_steps=10) warm-up leaves the timed run's first
        # chunk to re-trace the whole program
        if cfg.max_segments >= 1 << 20:
            from ..growth import init_state
            from ..growth.step import _scan_growth_chunk
            from ..scenes import petri_dish
            st_w, ea_w = init_state(cfg, petri_dish(cfg))
            st_w, stats_w = _scan_growth_chunk(st_w, ea_w, cfg, 10)
            jax.device_get(stats_w["segments"])      # sync the warm-up
            del st_w
        else:
            driver(cfg)
        t0 = time.perf_counter()
        st, _, history = driver(cfg)
        # run_growth_scan value-fetches the stats, so the clock is closed
        wall = time.perf_counter() - t0
        final = history[-1]
        row = dict(dev)
        row.update({
            "metric": f"growth_steps_per_sec_{name}",
            "value": cfg.t_steps / wall,
            "unit": "steps/s",
            "segments": int(final["segments"]),
            "hyphae": int(final["hyphae"]),
            "total_length_mm": final["total_length_mm"],
            "wall_s": wall,
            "overflow": bool(np.asarray(jax.device_get(st.overflow))),
        })
        print(json.dumps(row))
        results.append(row)
    return results


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    run(args or ["demo", "medium"], verbose="--verbose" in sys.argv)
