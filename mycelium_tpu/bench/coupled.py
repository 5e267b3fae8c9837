"""Coupled-pipeline benchmark: grow -> export mesh -> assemble -> pull test.

No archived reference artifact runs the coupled pipeline at 1e5+ DOF
scale (BASELINE.md: the largest archived solve is 22,125 DOF), so the
reference cost is extrapolated from its measured parts:

  growth    0.75 s/step at ~2k segments (cProfile, profile_output.prof) —
            the object-graph walkers scale superlinearly, so scaling
            linearly in segment count UNDER-estimates the reference cost
            (conservative for us);
  FEA       per-step assemble+solve+record from the 22,125-DOF run
            (71.76 s / 40 steps with plotting; 164 ms/solve cg+icc without),
            scaled linearly in DOF.

Run:  python -m mycelium_tpu.bench.coupled [preset]   (presets from
growth_scale: demo | medium | large | xlarge). Prints one JSON line.
Needs a GPU; the row names the device it ran on.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..config import tuned_fea_config
from .growth_scale import PRESETS


def _note(msg: str) -> None:
    print(f"[coupled] {msg}", file=sys.stderr, flush=True)


def run(preset: str = "medium", fea_steps: int = 40):
    from ..device import device_info, require_gpu
    from ..fea.ramp import run_ramp_scan, truncate_after_fracture
    from ..growth.export import state_mesh
    from ..growth.step import run_growth_chunked, run_growth_scan
    from ..utils import enable_compilation_cache

    require_gpu()
    enable_compilation_cache()
    gcfg = PRESETS[preset]
    if gcfg.max_segments >= 1 << 20:
        # bounded device executions at xlarge (see run_growth_chunked)
        grow_fn = lambda c: run_growth_chunked(c, chunk_steps=10)  # noqa: E731
    else:
        grow_fn = run_growth_scan

    # --- stage 1: growth (one XLA program) ---
    # warm-up runs the SAME program (scan length is baked into the XLA
    # program, so a short-run warm-up would not precompile it); the
    # persistent cache makes this near-free on repeat invocations.
    # The chunked driver's program unit is one chunk, so one chunk warms
    # it — run with the IDENTICAL static cfg (a replace(cfg, t_steps=10)
    # warm-up leaves the timed run's first chunk to re-trace the whole
    # program)
    if gcfg.max_segments >= 1 << 20:
        from ..growth import init_state
        from ..growth.step import _scan_growth_chunk
        from ..scenes import petri_dish
        import jax
        st_w, ea_w = init_state(gcfg, petri_dish(gcfg))
        st_w, stats_w = _scan_growth_chunk(st_w, ea_w, gcfg, 10)
        jax.device_get(stats_w["segments"])
        del st_w
    else:
        grow_fn(gcfg)
    t0 = time.perf_counter()
    st, _, history = grow_fn(gcfg)
    t_growth = time.perf_counter() - t0
    n_seg = int(history[-1]["segments"])
    _note(f"growth done: {n_seg} segments in {t_growth:.1f} s")

    # --- stage boundary: host-side mesh extraction (native dedup) ---
    t0 = time.perf_counter()
    coords, conn = state_mesh(st)
    t_export = time.perf_counter() - t0
    n_dof = 3 * coords.shape[0]
    _note(f"export done: {coords.shape[0]} nodes / {n_dof} DOF "
          f"in {t_export:.1f} s")

    # --- stage 2: the pull test (assemble+bc+solve+fracture per step) ---
    from ..fea.model import build_model
    fcfg = tuned_fea_config(n_steps=fea_steps, rtol=1e-6)
    t0 = time.perf_counter()
    model = build_model(coords, conn, fcfg)
    t_plan = time.perf_counter() - t0
    _note(f"model build done in {t_plan:.1f} s")
    # same-program compile warm-up as the growth stage. Large meshes run
    # the async driver (device-resident records, scan-chunk dispatch —
    # the production bench driver, bench.py ramp leg); its chunk program
    # bakes the record-buffer shapes, so the warm-up runs the FULL ramp
    # once (the persistent cache makes repeats near-free).
    if model.n_nodes > (1 << 18):
        from ..fea.ramp import run_ramp_async
        ramp_fn = lambda: run_ramp_async(coords, conn, fcfg,  # noqa: E731
                                         model=model)
    else:
        ramp_fn = lambda: run_ramp_scan(coords, conn, fcfg,  # noqa: E731
                                        model=model)
    ramp_fn()
    _note("ramp warm-up done")
    t0 = time.perf_counter()
    res = truncate_after_fracture(ramp_fn())
    t_fea = time.perf_counter() - t0
    wall = t_growth + t_export + t_plan + t_fea

    # reference extrapolation (see module docstring)
    ref_growth_s = 0.75 * gcfg.t_steps * (n_seg / 2000.0)
    ref_fea_s = 71.76 * (n_dof / 22125.0)
    ref_s = ref_growth_s + ref_fea_s

    row = device_info()
    row.update({
        "metric": f"coupled_pipeline_{preset}",
        "value": wall,
        "unit": "s",
        "vs_baseline": ref_s / wall,
        "segments": n_seg,
        "n_dof": n_dof,
        "growth_s": t_growth,
        "export_s": t_export,
        "plan_s": t_plan,
        "fea_s": t_fea,
        "fea_steps_recorded": int(res.disp_record.shape[0]),
        "ref_extrapolated_s": ref_s,
    })
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "medium")
