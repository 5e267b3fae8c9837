"""Algorithmic traffic model + roofline accounting for the solver benches.

Sparse preconditioned CG does ~0 useful FLOPs per byte, so MFU is the
wrong lens; the hardware-limit metric is achieved memory bandwidth
against the device's peak. This module computes the MINIMUM bytes a
solve must move through the memory system given the mesh's actual plan
shapes:

- per-iteration traffic: one operator apply (chain shifts + jump one-hot
  tables), one tree-PC apply (PCR coefficient planes, forward + backward),
  and the CG vector updates;
- per-solve setup traffic: the numeric factorization's coefficient writes
  and the one-time table load.

Every XLA op round-trips device memory, so achieved_gbps reads directly
against the device's memory peak from ``PEAKS``.
"""

from __future__ import annotations

# Published peaks, keyed by JAX's device_kind. Source: NVIDIA H100 Tensor
# Core GPU data sheet, SXM part, dense rates (full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0,
                              "tf32_tflops": 495.0},
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; an unknown device is an error,
    not a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add it to bench.roofline.PEAKS"
                       ) from None


def solver_traffic_bytes(model, iters: int, dtype_bytes: int = 4) -> dict:
    """Bytes-moved model for one cold solve on ``model`` (FeaModel).

    Returns a dict with per-iteration and per-solve totals. Uses the
    actual packed table shapes when the chain/tree plans exist, else the
    ELL layout.
    """
    n = model.n_nodes
    vec = 3 * n * dtype_bytes                     # one (N,3) vector

    # ---- operator apply ----
    if model.chain is not None:
        plan = model.chain
        jp = int(plan.ja.shape[0])
        # chain part: u in, 3 coefficient planes + mask, f out
        op = 6 * vec
        if plan.a_blk is not None:
            # jump part: a/b one-hot block + position tables, each read
            # by the gather product and the scatter product, + scalars
            nbc = int(plan.a_blk.shape[1])
            op += 4 * jp * (nbc + 128) * dtype_bytes + jp * 5 * dtype_bytes
        else:
            # huge-mesh gather/scatter jumps: 4 J-row (J,3) passes
            op += 4 * jp * 3 * dtype_bytes + jp * 5 * dtype_bytes
    else:
        deg = int(model.incident.shape[1])
        # ELL: per-element forces + (N, deg) gather tables + signs
        op = (2 * model.n_elems * 3 + 2 * n * deg + 4 * n) * dtype_bytes

    # ---- preconditioner apply (tree PCR) ----
    pc = 0
    setup = 0
    if model.tree is not None:
        from ..fea.tree_jax import n_pcr_levels
        meta = model.tree.meta
        S = int(model.tree.n_slots)
        P = int(model.tree.n_paths)
        n_pcr = n_pcr_levels(meta)
        r9S = sum(meta.level_steps[i]
                  * (meta.level_offsets[i + 1] - meta.level_offsets[i])
                  for i in range(n_pcr)) * 9 * dtype_bytes
        # forward + backward each read every PCR level's (alpha, beta)
        # once, plus dinv and the attachment couplings
        pc = 2 * (2 * r9S + 9 * S * dtype_bytes) \
            + 4 * P * 9 * dtype_bytes + 4 * vec
        # dense junction tail: one (3Sd)^2 sinv matvec per apply
        sd3 = 3 * (S - meta.level_offsets[n_pcr])
        pc += sd3 * sd3 * dtype_bytes
        # factorization: coefficient recurrence writes alpha/beta once and
        # streams D/L/R ~3x per round; dense tail assembles + inverts sinv
        setup = 2 * r9S + 3 * 2 * r9S + 18 * S * dtype_bytes \
            + 4 * sd3 * sd3 * dtype_bytes
    else:
        pc = 2 * vec + 9 * n * dtype_bytes        # block-Jacobi

    # ---- CG vector updates: x,r,z,p,ap reads/writes per iteration ----
    cg_vec = 10 * vec

    per_iter = op + pc + cg_vec
    total = setup + iters * per_iter + 4 * vec    # + b/x0/uk/x out
    return {"bytes_per_iter": per_iter, "setup_bytes": setup,
            "bytes_total": total}


def roofline_row(model, iters: int, solve_seconds: float,
                 device_kind: str, dtype_bytes: int = 4) -> dict:
    """achieved_gbps / roofline_frac fields for a bench JSON row; the
    fraction is of ``device_kind``'s published memory peak."""
    peak = device_peaks(device_kind)["hbm_gbps"]
    t = solver_traffic_bytes(model, iters, dtype_bytes)
    gbps = t["bytes_total"] / max(solve_seconds, 1e-12) / 1e9
    return {
        "bytes_per_iter": int(t["bytes_per_iter"]),
        "bytes_total": int(t["bytes_total"]),
        "achieved_gbps": gbps,
        "roofline_frac": gbps / peak,
    }
