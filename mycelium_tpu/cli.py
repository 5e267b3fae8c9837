"""Command-line interface: grow | fea | pipeline | sweep | plot.

Replaces the reference's SLURM-script orchestration (reference component
C29: run_all.slurm runs the growth sim, picks the newest results/sim_* dir,
and feeds it to the FEA solver — run_all.slurm:30-48) with explicit
subcommands over the same on-disk contracts:

  python -m mycelium_tpu.cli grow  [--out results] [--steps N] [--seed S]
  python -m mycelium_tpu.cli fea   <results_dir> [--no-plots]
  python -m mycelium_tpu.cli pipeline [--out results]
  python -m mycelium_tpu.cli sweep <results_dir> [--trials N]
  python -m mycelium_tpu.cli plot-snapshots <results_dir>
  python -m mycelium_tpu.cli plot-fea <results_dir>
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import glob
import os
import sys
import time

import numpy as np


def _timestamp_dir(base: str) -> str:
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    return os.path.join(base, f"sim_{ts}")


def newest_sim_dir(base: str) -> str:
    """The reference's newest-dir convention (run_all.slurm:33)."""
    dirs = sorted(glob.glob(os.path.join(base, "sim_*")),
                  key=os.path.getmtime)
    if not dirs:
        raise SystemExit(f"no results/sim_* directory under {base}")
    return dirs[-1]


def cmd_grow(args) -> str:
    from .config import GrowthConfig, growth_3d_config, save_run_configs
    from .growth import run_growth
    from .growth.export import (export_state_geometry, segments_to_host,
                                write_state_snapshot)
    from .io.writers import write_growth_stats

    cfg = growth_3d_config() if args.three_d else GrowthConfig()
    overrides = {}
    if args.steps is not None:
        overrides["t_steps"] = args.steps
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.capacity is not None:
        overrides["max_segments"] = args.capacity
        overrides["max_hyphae"] = max(args.capacity // 2, 1024)
    cfg = dataclasses.replace(cfg, **overrides)

    out_dir = args.dir or _timestamp_dir(args.out)
    snapshot_dir = os.path.join(out_dir, "snapshots")
    os.makedirs(snapshot_dir, exist_ok=True)

    initial_state = None
    if args.resume:
        from .io.checkpoint import load_growth_state
        initial_state = load_growth_state(args.resume)
        print(f"resuming from {args.resume} at step "
              f"{int(initial_state.step)}")
    ckpt_path = os.path.join(out_dir, "growth_checkpoint.npz") \
        if args.checkpoint_every else None

    snapshot_cb = None
    if args.snapshots == "csv":
        from .growth.export import write_state_snapshot

        def snapshot_cb(t, st):
            write_state_snapshot(st, snapshot_dir, t)
    elif args.snapshots == "png":
        from .viz import plot_mycelium

        def snapshot_cb(t, st):
            starts, ends, sub, _, _ = segments_to_host(st)
            inten = sub * np.linalg.norm(ends - starts, axis=1)
            plot_mycelium(starts, ends, inten, t,
                          os.path.join(snapshot_dir,
                                       f"petri_step_{t:04d}.png"),
                          dish_size=cfg.dish_size,
                          three_d=cfg.three_d, height=cfg.height)

    print(f"growing: {cfg.t_steps} steps -> {out_dir}")
    st, _, history = run_growth(cfg, on_step=snapshot_cb,
                                verbose=args.verbose,
                                initial_state=initial_state,
                                checkpoint_path=ckpt_path,
                                checkpoint_every=args.checkpoint_every)
    from .utils.dist import is_coordinator
    if is_coordinator():
        write_growth_stats(out_dir, history,
                           variant=getattr(args, "csv_variant", "python"))
        export_state_geometry(st, out_dir)
        save_run_configs(out_dir, growth=cfg)
        if not args.no_summary_plot:
            from .viz import plot_growth_summary
            plot_growth_summary(history, out_dir)
    final = history[-1]
    print(f"done: {final['hyphae']} hyphae, {final['segments']} segments, "
          f"{final['total_length_mm']:.1f} mm")
    return out_dir


def cmd_fea(args) -> str:
    from .config import FeaConfig, save_run_configs
    from .fea import run_ramp
    from .io import read_mesh_dir, write_fea_records
    from .io.writers import write_runtime, write_solve_runtimes

    results_dir = args.results_dir
    t0 = time.time()
    coords, conn = read_mesh_dir(results_dir)
    overrides = {}
    if args.fea_steps is not None:
        overrides["n_steps"] = args.fea_steps
    if args.grip is not None:
        overrides["grip_length"] = args.grip
    if args.disp_max is not None:
        overrides["displacement_max"] = args.disp_max
    if args.f64:
        overrides["dtype"] = "float64"
    if getattr(args, "preset", "fast") == "fast":
        from .config import tuned_fea_config
        cfg = tuned_fea_config(**overrides)
    else:
        cfg = FeaConfig(**overrides)

    print(f"FEA on {results_dir}: {coords.shape[0]} nodes, "
          f"{conn.shape[0]} elements")
    trace_dir = getattr(args, "trace", None)
    trace_ctx = None
    if trace_dir:
        # device-trace capture (reference §5.1 profile_output*.prof
        # analogue): a jax.profiler trace viewable in Perfetto/TensorBoard
        from .utils.profiling import trace as _trace
        trace_ctx = _trace(trace_dir)
        trace_ctx.__enter__()
    try:
        if getattr(args, "sharded", None) is not None:
            # every solve domain-decomposed over the (possibly
            # multi-process) device mesh — the mpirun -np N role
            from .fea.ramp import run_ramp_sharded
            from .fea.shard import default_mesh
            n_dev = None if args.sharded == -1 else args.sharded
            ckpt_every = getattr(args, "fea_checkpoint_every", 0)
            ckpt_path = os.path.join(results_dir, "fea_checkpoint.npz") \
                if ckpt_every else None
            res = run_ramp_sharded(
                coords, conn, cfg, default_mesh(n_dev),
                verbose=args.verbose, checkpoint_path=ckpt_path,
                checkpoint_every=ckpt_every,
                resume_from=getattr(args, "fea_resume", None))
        elif args.scan:
            # one XLA program for the whole ramp (no per-step host sync);
            # records are cut at the reference's early-stop point afterwards
            from .fea import run_ramp_scan
            from .fea.ramp import truncate_after_fracture
            res = truncate_after_fracture(run_ramp_scan(coords, conn, cfg))
        else:
            ckpt_every = getattr(args, "fea_checkpoint_every", 0)
            ckpt_path = os.path.join(results_dir, "fea_checkpoint.npz") \
                if ckpt_every else None
            res = run_ramp(coords, conn, cfg, verbose=args.verbose,
                           checkpoint_path=ckpt_path,
                           checkpoint_every=ckpt_every,
                           resume_from=getattr(args, "fea_resume", None))
    finally:
        if trace_ctx is not None:
            trace_ctx.__exit__(None, None, None)
            print(f"device trace captured -> {trace_dir}")
    fea_dir = os.path.join(results_dir, "fea_results")
    from .utils.dist import is_coordinator
    if is_coordinator():
        write_fea_records(fea_dir, res.stress_record, res.active_record,
                          res.disp_record, res.force_disp,
                          variant=getattr(args, "csv_variant", "python"))
        write_solve_runtimes(fea_dir, res.solve_seconds)
        write_runtime(fea_dir, time.time() - t0)
        save_run_configs(results_dir, fea=cfg)

    if not args.no_plots and is_coordinator():
        from .viz import plot_force_displacement, plot_network
        plot_force_displacement(res.force_disp,
                                os.path.join(fea_dir,
                                             "force_displacement.png"))
        for step in range(res.disp_record.shape[0]):
            u = res.disp_record[step].reshape(-1, 3)
            plot_network(coords + u, conn, res.stress_record[step],
                         res.active_record[step],
                         os.path.join(fea_dir, f"fea_step_{step:03d}.png"),
                         step)
    n_rec = res.disp_record.shape[0]
    print(f"FEA completed: {n_rec} steps recorded -> {fea_dir} "
          f"({time.time() - t0:.2f}s)")
    return fea_dir


def cmd_pipeline(args) -> None:
    out_dir = cmd_grow(args)
    args.results_dir = out_dir
    cmd_fea(args)


def cmd_sweep(args) -> None:
    from .bench import run_solver_sweep
    from .config import FeaConfig
    from .io import read_mesh_dir

    coords, conn = read_mesh_dir(args.results_dir)
    cfg = FeaConfig(dtype="float64" if args.f64 else "float32")
    out_csv = os.path.join(args.results_dir, "runtime_results.csv")
    rows = run_solver_sweep(coords, conn, cfg, trials=args.trials,
                            out_csv=out_csv, verbose=args.verbose)
    print(f"{len(rows)} timings -> {out_csv}")


def cmd_plot_snapshots(args) -> None:
    from .viz import plot_snapshot_csv
    snaps = sorted(glob.glob(os.path.join(args.results_dir, "snapshots",
                                          "step_*.csv")))
    for csv in snaps:
        png = csv.replace(".csv", ".png")
        plot_snapshot_csv(csv, png)
    print(f"rendered {len(snaps)} snapshots")


def cmd_plot_fea(args) -> None:
    import pandas as pd
    from .io import read_mesh_dir
    from .viz import plot_force_displacement, plot_network

    coords, conn = read_mesh_dir(args.results_dir)
    fea_dir = os.path.join(args.results_dir, "fea_results")
    stress = pd.read_csv(os.path.join(fea_dir, "stress_record.csv"))
    active = pd.read_csv(os.path.join(fea_dir, "active_elements.csv"))
    fd = pd.read_csv(os.path.join(fea_dir, "force_displacement.csv"))
    plot_force_displacement(fd.to_numpy(),
                            os.path.join(fea_dir, "force_displacement.png"))
    n_elems = conn.shape[0]
    for i in range(len(stress)):
        plot_network(coords, conn,
                     stress.iloc[i, :n_elems].to_numpy(float),
                     active.iloc[i, :n_elems].to_numpy(bool),
                     os.path.join(fea_dir, f"fea_step_{i:03d}.png"), i)
    print(f"rendered {len(stress)} FEA frames")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mycelium_tpu",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run: call jax.distributed.initialize "
                        "before any computation (coordinator/process id "
                        "from JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/"
                        "JAX_PROCESS_ID, all three required; each process "
                        "takes the card JAX_LOCAL_DEVICE_IDS names, by "
                        "default the one numbered like its process id); "
                        "result files are written by process 0 only — the "
                        "mpirun -np N role of the reference parallel "
                        "binary, without its every-rank-writes bug")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_grow_args(g):
        g.add_argument("--out", default="results")
        g.add_argument("--dir", default=None,
                       help="exact output dir (overrides --out/sim_<ts>)")
        g.add_argument("--steps", type=int, default=None)
        g.add_argument("--seed", type=int, default=None)
        g.add_argument("--capacity", type=int, default=None)
        g.add_argument("--three-d", action="store_true")
        g.add_argument("--snapshots", choices=["none", "csv", "png"],
                       default="csv")
        g.add_argument("--checkpoint-every", type=int, default=0,
                       help="save growth_checkpoint.npz every N steps")
        g.add_argument("--resume", default=None,
                       help="resume growth from a checkpoint npz")
        g.add_argument("--no-summary-plot", action="store_true")
        g.add_argument("--csv-variant", choices=["python", "cpp"],
                       default="python",
                       help="CSV dialect: 'python' (step-last stats, "
                            "True/False actives) or 'cpp' (step-first "
                            "stats, 1/0 actives — the reference C++ "
                            "binaries' contract)")
        g.add_argument("--verbose", action="store_true")

    def add_fea_args(g, positional=True):
        if positional:
            g.add_argument("results_dir")
        g.add_argument("--fea-steps", type=int, default=None)
        g.add_argument("--scan", action="store_true",
                       help="run the whole ramp as one device program")
        g.add_argument("--sharded", type=int, nargs="?", const=-1,
                       default=None, metavar="N",
                       help="domain-decompose every solve over a device "
                            "mesh of N devices (default: all devices — "
                            "the global set under --distributed); the "
                            "reference's mpirun -np N fea_petsc_parallel "
                            "role")
        g.add_argument("--grip", type=float, default=None)
        g.add_argument("--disp-max", type=float, default=None)
        g.add_argument("--f64", action="store_true")
        g.add_argument("--fea-checkpoint-every", type=int, default=0,
                       help="save fea_checkpoint.npz every N ramp steps "
                            "(loop driver only)")
        g.add_argument("--fea-resume", default=None,
                       help="resume the ramp from a checkpoint npz")
        g.add_argument("--trace", default=None, metavar="DIR",
                       help="capture a jax.profiler device trace of the "
                            "ramp into DIR (Perfetto/TensorBoard viewable; "
                            "the reference's profile_output*.prof analogue)")
        g.add_argument("--no-plots", action="store_true")
        if positional:
            g.add_argument("--csv-variant", choices=["python", "cpp"],
                           default="python",
                           help="CSV dialect (see grow --csv-variant)")
        g.add_argument("--preset", choices=["fast", "reference"],
                       default="fast",
                       help="solver preset: 'fast' = chain operator + tree "
                            "preconditioner + cluster coarse grid; "
                            "'reference' = FeaConfig defaults (ELL + "
                            "block-Jacobi, the PETSc-shaped path)")
        if positional:
            g.add_argument("--verbose", action="store_true")

    g = sub.add_parser("grow", help="run the growth simulation")
    add_grow_args(g)
    g.set_defaults(fn=cmd_grow)

    f = sub.add_parser("fea", help="run the FEA pull test on a results dir")
    add_fea_args(f)
    f.set_defaults(fn=cmd_fea)

    pl = sub.add_parser("pipeline", help="grow then FEA (run_all.slurm flow)")
    add_grow_args(pl)
    add_fea_args(pl, positional=False)
    pl.set_defaults(fn=cmd_pipeline)

    sw = sub.add_parser("sweep", help="solver x preconditioner timing sweep")
    sw.add_argument("results_dir")
    sw.add_argument("--trials", type=int, default=5)
    sw.add_argument("--f64", action="store_true")
    sw.add_argument("--verbose", action="store_true")
    sw.set_defaults(fn=cmd_sweep)

    ps = sub.add_parser("plot-snapshots", help="render snapshot CSVs to PNG")
    ps.add_argument("results_dir")
    ps.set_defaults(fn=cmd_plot_snapshots)

    pf = sub.add_parser("plot-fea", help="render FEA records to PNG")
    pf.add_argument("results_dir")
    pf.set_defaults(fn=cmd_plot_fea)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if getattr(args, "f64", False):
        import jax
        jax.config.update("jax_enable_x64", True)  # before any computation
    if getattr(args, "distributed", False):
        from .utils.dist import initialize_distributed
        initialize_distributed()   # must precede the first computation
    from .utils import enable_compilation_cache
    enable_compilation_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
