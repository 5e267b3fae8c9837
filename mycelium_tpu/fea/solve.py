"""Krylov solvers: preconditioned CG and BiCGStab (reference C18/C19).

Replaces SciPy spsolve (reference src/fea_solver.py:112-135) and the PETSc
KSP solvers (src/fea_petsc.cpp:323-357: CG+ICC; src/fea_petsc_parallel.cpp:
336-339: CG+Block-Jacobi). All state lives in (N,3) node-major arrays and
every iteration is a handful of fused elementwise passes plus one SpMV — there is no
host round-trip inside the loop (`lax.while_loop`), so one jit compilation
covers any iteration count.

Preconditioners:
  'block_jacobi' — exact per-node 3x3 block inverse (BJACOBI with the block
                   size PETSc would pick for 3-DOF nodes);
  'jacobi'       — scalar diagonal;
  'none'.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..config import FeaConfig
from .blocks import mv3
from .model import FeaModel, diag_blocks, invert_blocks

_HIGHEST = jax.lax.Precision.HIGHEST


class SolveResult(NamedTuple):
    x: jnp.ndarray          # (N,3) solution
    iters: jnp.ndarray      # () int32 — CG/BiCGStab iterations, or total
                            # Arnoldi steps for gmres (operator applies)
    resnorm: jnp.ndarray    # () final |r|
    converged: jnp.ndarray  # () bool


def _dot(a, b):
    return jnp.sum(a * b)


def make_preconditioner(model: FeaModel, active: jnp.ndarray,
                        cfg: FeaConfig,
                        free_nodes: jnp.ndarray | None = None) -> Callable:
    if cfg.precond == "none":
        return lambda r: r
    if cfg.precond == "coarse":
        if model.chain is None:
            # mirror shard.py: the coarse clusters are 128 consecutive
            # CHAIN positions — without the chain permutation they would
            # be arbitrary node-id runs and the PC silently degrades to
            # plain block-Jacobi
            raise ValueError("precond='coarse' needs the chain node "
                             "ordering; build the model with "
                             "operator='chain'")
        return _coarse_preconditioner(model, active, cfg, free_nodes)
    if cfg.precond == "tree":
        from .tree_jax import tree_apply, tree_factor
        free = model.free_nodes if free_nodes is None else free_nodes
        # the PC's diagonal floor is RELATIVE to the element stiffness
        # scale: fracture can leave tree-floating fragments held only by
        # the regularization, and cfg.reg (1e-12) would amplify PC noise
        # there by ~1e7x; the floor caps it without touching anchored
        # modes (static python float — no runtime cost)
        reg_pc = max(cfg.reg, cfg.tree_reg_rel * model.tree.meta.k_scale)
        factor = tree_factor(model.tree, active, free,
                             jnp.asarray(reg_pc, model.coords.dtype),
                             model.conn)
        if cfg.tree_coarse_weight > 0.0 and model.chain is not None:
            # additive cluster coarse grid on top of the exact forest
            # elimination: the tree PC misses the long-wavelength coupling
            # through anastomosis loops, which is exactly what the
            # 128-node-cluster Galerkin space captures
            cpc = _coarse_preconditioner(model, active, cfg, free_nodes,
                                         include_blocks=False)
            w = float(cfg.tree_coarse_weight)
            return lambda r: tree_apply(model.tree, factor, r) + w * cpc(r)
        return lambda r: tree_apply(model.tree, factor, r)
    blocks = diag_blocks(model, active, cfg, free_nodes)
    if cfg.precond == "jacobi":
        d = jnp.stack([blocks[:, 0, 0], blocks[:, 1, 1], blocks[:, 2, 2]],
                      axis=1)
        inv_d = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 1.0)
        return lambda r: r * inv_d
    inv_blocks = invert_blocks(blocks)
    return lambda r: mv3(inv_blocks, r)


def _coarse_preconditioner(model: FeaModel, active, cfg: FeaConfig,
                           free_nodes=None,
                           include_blocks: bool = True) -> Callable:
    """Two-level additive Schwarz in node space: exact per-node 3x3 block
    inverse plus a Galerkin coarse correction over 128-node chain clusters
    (the coarse operator is built by coarse._coarse_inverse and densely
    inverted — ~400x400 at 1e5 DOF). Reference analogue: the 'gamg' leg of
    the PETSc sweep (src/fea_petsc_solverAndPC.cpp:223)."""
    from .coarse import (_coarse_inverse, _ramp_weight,
                         coarse_cluster_blocks, plan_nb)
    plan = model.chain
    free = model.free_nodes if free_nodes is None else free_nodes
    n = model.n_nodes
    nb = plan_nb(n)
    kblk = coarse_cluster_blocks(nb, cfg)     # blocks per cluster
    width = kblk * 128
    nbc = -(-nb // kblk)
    nc3 = 3 * nbc
    use_ramp = cfg.coarse_basis == "linear"
    ainv = _coarse_inverse(model, plan, active, free, cfg, nb, kblk)
    inv_blocks = (invert_blocks(diag_blocks(model, active, cfg, free))
                  if include_blocks else None)
    pos = plan.inv_perm                       # node -> chain position
    cl = pos // width
    ramp = _ramp_weight(pos % width, width).astype(model.coords.dtype)
    fmask = free.astype(model.coords.dtype)

    def pc(r):                                # r: (N,3) node space
        z = (mv3(inv_blocks, r) if include_blocks
             else jnp.zeros_like(r))
        rf = r * fmask[:, None]
        # restriction: coarse dof (basis fb, comp k, cluster c) =
        # sum over nodes in cluster of (ramp^fb * r)
        nc = (2 if use_ramp else 1) * nc3
        rc = jnp.zeros((nc,), r.dtype)
        for fb in range(2 if use_ramp else 1):
            wgt = rf * (ramp[:, None] if fb else 1.0)
            for k in range(3):
                rc = rc.at[fb * nc3 + k * nbc + cl].add(wgt[:, k])
        # HIGHEST: on a GPU the default precision of an f32 matvec is TF32
        zc = jnp.dot(ainv.astype(r.dtype), rc, precision=_HIGHEST)
        zn = jnp.stack([zc[k * nbc + cl] for k in range(3)], axis=1)
        if use_ramp:
            zn = zn + ramp[:, None] * jnp.stack(
                [zc[nc3 + k * nbc + cl] for k in range(3)], axis=1)
        return z + zn * fmask[:, None]

    return pc


def coarse_chain_apply(ainv, free_p, r, n: int, nbc: int, width: int,
                       rampw, use_ramp: bool):
    """One cluster-Galerkin coarse correction on a CHAIN-ORDERED (N,3)
    residual: restriction is a reshape-sum over 128·kblk-position clusters,
    prolongation a broadcast (zero gathers). Shared by the single-chip
    chain solver (via ``_coarse_chain_fn``) and the sharded solver's
    replicated PC (shard.py). ``free_p`` is the (N,) free mask in chain
    order as the residual dtype; ``rampw`` the (nbc*width,) in-cluster
    ramp weights (ignored unless ``use_ramp``)."""
    dtype = r.dtype
    rf = r * free_p[:, None]
    rpad = jnp.pad(rf, ((0, nbc * width - n), (0, 0)))
    rcl = rpad.reshape(nbc, width, 3)
    rc0 = jnp.sum(rcl, axis=1)                         # (nbc, 3)
    # dof order: fb*3nbc + comp*nbc + cluster
    parts = [rc0.T.reshape(-1)]
    if use_ramp:
        rw = rampw.reshape(nbc, width, 1)
        parts.append(jnp.sum(rcl * rw, axis=1).T.reshape(-1))
    # HIGHEST: on a GPU the default precision of an f32 matvec is TF32
    zc = jnp.dot(ainv.astype(dtype), jnp.concatenate(parts),
                 precision=_HIGHEST)
    zc0 = zc[:3 * nbc].reshape(3, nbc).T               # (nbc, 3)
    zn = jnp.repeat(zc0[:, None, :], width, axis=1)    # (nbc, width, 3)
    if use_ramp:
        zc1 = zc[3 * nbc:6 * nbc].reshape(3, nbc).T
        zn = zn + zc1[:, None, :] * rampw.reshape(nbc, width, 1)
    return zn.reshape(-1, 3)[:n] * free_p[:, None]


def _coarse_chain_fn(model: FeaModel, active, cfg: FeaConfig,
                     free_nodes=None, ainv=None) -> Callable:
    """Cluster Galerkin coarse correction operating on CHAIN-PERMUTED
    residuals: clusters = 128 consecutive chain positions, so restriction
    is a reshape-sum and prolongation a broadcast (zero gathers).

    ``ainv`` optionally injects a precomputed coarse inverse (from
    TreeFactor.coarse_ainv): it shares the tree factor's (active, free)
    invariants, so ramp drivers assemble it only when those change."""
    from .coarse import (_coarse_inverse, _ramp_weight,
                         coarse_cluster_blocks, plan_nb)
    plan = model.chain
    free = model.free_nodes if free_nodes is None else free_nodes
    n = model.n_nodes
    nb = plan_nb(n)
    kblk = coarse_cluster_blocks(nb, cfg)
    width = kblk * 128
    nbc = -(-nb // kblk)
    use_ramp = cfg.coarse_basis == "linear"
    if ainv is None:
        ainv = _coarse_inverse(model, plan, active, free, cfg, nb, kblk)
    dtype = model.coords.dtype
    pos = jnp.arange(nbc * width, dtype=jnp.int32)
    rampw = _ramp_weight(pos % width, width).astype(dtype)  # (nbc*width,)
    free_p = free[plan.perm].astype(dtype)                 # chain order

    def cc(r):                                             # r: (N,3) chain
        return coarse_chain_apply(ainv, free_p, r, n, nbc, width, rampw,
                                  use_ramp)

    return cc


def pcg(operator: Callable, b: jnp.ndarray, x0: jnp.ndarray,
        precond: Callable, rtol: float, atol: float,
        max_iter: int, bnorm=None, stall_window: int = 256,
        stall_accept: float = 10.0, n_restarts: int = 0) -> SolveResult:
    """Preconditioned conjugate gradients on the SPD BC'd operator.

    ``bnorm`` lets the caller scale rtol by the *condensed* RHS (free rows
    only) — the full b carries the prescribed values on identity rows, whose
    much larger norm would make the tolerance artificially loose.

    Stagnation exit: f32 CG can hit its roundoff floor a hair ABOVE the
    requested tolerance (seen at 330k nodes: residual pinned at
    1.0x-to-few-x tol from iteration ~8 on), and without an exit the loop
    spins to max_iter, 20000 iterations. If the best residual has
    not improved by 0.1% in ``stall_window`` iterations the loop exits
    (256 is conservative: ill-conditioned unpreconditioned CG plateaus for
    tens of iterations mid-run while still converging — the window must
    sit well above that, and the production tree-PC solves finish in
    ≤~100 iterations anyway). A plateau already WITHIN ``stall_accept``
    of tol exits after stall_window/8 — CG's residual collapses quickly
    once the Krylov space resolves a mode, so 32 flat iterations next to
    the tolerance are conclusive, and burning the full window there
    multiplies the solve's iteration count;
    the result still counts as converged when the floor is within
    ``stall_accept``·tol (the true solution error there is dominated by
    f32 operator roundoff, not the Krylov iteration). A genuine stall far
    from tol reports converged=False for the drivers' divergence guard.

    ``n_restarts``: on a plateau, instead of exiting, recompute the TRUE
    residual r = b - K·x and rebuild the Krylov space from it (costs one
    operator apply, counted as an iteration). The plateau is usually the
    accumulated drift of the recurrence residual away from the true one
    — seen at 340k nodes: the first stall pinned at 90x tol, one
    restart dropped the floor 90x to ~tol. Restarted segments use the
    short near_window for BOTH the next restart trigger and the final
    exit (a restarted Krylov that re-stalls quickly is conclusively at
    the f32 operator floor — no reason to burn the long window again).
    Enabled by the tree-PC solve paths; defaults off so plateau-prone
    weak-PC configs (the sweep's jacobi runs) keep the conservative
    exit."""
    if bnorm is None:
        bnorm = jnp.sqrt(_dot(b, b))
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = b - operator(x0)
    z0 = precond(r0)
    rz0 = _dot(r0, z0)
    rn0 = jnp.sqrt(_dot(r0, r0))
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    state0 = (x0, r0, z0, z0, rz0, rn0,
              i32(0), rn0, i32(0), i32(n_restarts))

    near_window = max(stall_window // 8, 8)

    def cond(s):
        rnorm, k, _, since, rleft = s[-5], s[-4], s[-3], s[-2], s[-1]
        near = rnorm <= stall_accept * tol
        used = rleft < n_restarts
        win = jnp.where(near | used, near_window, stall_window)
        stalled = (since >= win) & (rleft == 0)
        return (k < max_iter) & (rnorm > tol) & ~stalled

    def body(s):
        x, r, z, p, rz, rnorm, k, best, since, rleft = s

        def _restart(_):
            rr = b - operator(x)
            zz = precond(rr)
            rnn = jnp.sqrt(_dot(rr, rr))
            return (x, rr, zz, zz, _dot(rr, zz), rnn, k + 1,
                    jnp.minimum(best, rnn), i32(0), rleft - 1)

        def _step(_):
            ap = operator(p)
            pap = _dot(p, ap)
            alpha = jnp.where(pap > 0, rz / jnp.where(pap > 0, pap, 1.0),
                              0.0)
            xn = x + alpha * p
            rn = r - alpha * ap
            zn = precond(rn)
            rz_new = _dot(rn, zn)
            beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0),
                             0.0)
            pn = zn + beta * p
            rnn = jnp.sqrt(_dot(rn, rn))
            improved = rnn < best * (1.0 - 1e-3)
            return (xn, rn, zn, pn, rz_new, rnn, k + 1,
                    jnp.minimum(best, rnn),
                    jnp.where(improved, 0, since + 1), rleft)

        if n_restarts == 0:
            return _step(None)
        trigger = (since >= near_window) & (rleft > 0)
        return jax.lax.cond(trigger, _restart, _step, None)

    x, r, _, _, _, rnorm, k, _, since, _ = \
        jax.lax.while_loop(cond, body, state0)
    stalled = since >= near_window
    converged = (rnorm <= tol) | (stalled & (rnorm <= stall_accept * tol))
    return SolveResult(x=x, iters=k, resnorm=rnorm, converged=converged)


def bicgstab(operator: Callable, b: jnp.ndarray, x0: jnp.ndarray,
             precond: Callable, rtol: float, atol: float,
             max_iter: int, bnorm=None) -> SolveResult:
    """Right-preconditioned BiCGStab — the 'bcgs' leg of the reference's
    solver sweep (src/fea_petsc_solverAndPC.cpp:221)."""
    if bnorm is None:
        bnorm = jnp.sqrt(_dot(b, b))
    tol = jnp.maximum(rtol * bnorm, atol)
    eps = jnp.asarray(1e-300 if b.dtype == jnp.float64 else 1e-30, b.dtype)

    r0 = b - operator(x0)
    rhat = r0
    state0 = (x0, r0, r0, jnp.zeros_like(b), jnp.ones((), b.dtype),
              jnp.ones((), b.dtype), jnp.ones((), b.dtype),
              jnp.sqrt(_dot(r0, r0)), jnp.asarray(0, jnp.int32))

    def cond(s):
        return jnp.logical_and(jnp.logical_and(s[-1] < max_iter,
                                               s[-2] > tol),
                               jnp.isfinite(s[-2]))

    def body(s):
        x, r, p, v, rho, alpha, omega, _, k = s
        rho_new = _dot(rhat, r)
        beta = (rho_new / jnp.where(jnp.abs(rho) > eps, rho, eps)) * \
               (alpha / jnp.where(jnp.abs(omega) > eps, omega, eps))
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = operator(phat)
        denom = _dot(rhat, v)
        alpha = rho_new / jnp.where(jnp.abs(denom) > eps, denom, eps)
        s_vec = r - alpha * v
        shat = precond(s_vec)
        t = operator(shat)
        tt = _dot(t, t)
        # guard the stabilization step: when the half-iterate s is already
        # converged (or t degenerates to ~0), skip it — otherwise omega's
        # quotient of underflowed dots can poison the state with inf/nan
        s_small = jnp.sqrt(_dot(s_vec, s_vec)) <= tol
        omega_raw = _dot(t, s_vec) / jnp.where(tt > eps, tt, eps)
        omega_ok = jnp.logical_and(jnp.isfinite(omega_raw),
                                   jnp.logical_not(s_small))
        omega = jnp.where(omega_ok, omega_raw, jnp.zeros_like(omega_raw))
        x = x + alpha * phat + omega * shat
        r = s_vec - omega * t
        return (x, r, p, v, rho_new, alpha, omega,
                jnp.sqrt(_dot(r, r)), k + 1)

    out = jax.lax.while_loop(cond, body, state0)
    x, r = out[0], out[1]
    rnorm, k = out[-2], out[-1]
    return SolveResult(x=x, iters=k, resnorm=rnorm, converged=rnorm <= tol)


def gmres(operator: Callable, b: jnp.ndarray, x0: jnp.ndarray,
          precond: Callable, rtol: float, atol: float,
          max_iter: int, bnorm=None, restart: int = 32) -> SolveResult:
    """Right-preconditioned restarted GMRES(m) — the 'gmres' leg of the
    reference's solver sweep (src/fea_petsc_solverAndPC.cpp:221).

    Own implementation (modified Gram-Schmidt Arnoldi + Givens-rotation
    QR of the Hessenberg) so the sweep reports a REAL iteration count:
    ``iters`` is the total number of Arnoldi steps (= operator applies,
    PETSc's KSPGetIterationNumber semantics), where the previous
    jax.scipy wrapper could only return a -1 sentinel. The residual is
    tracked exactly via the rotated RHS inside a cycle, and recomputed
    from scratch at each restart (classic safeguard against Arnoldi
    drift). Everything is one jitted while_loop nest: no host round
    trips, any iteration count."""
    if bnorm is None:
        bnorm = jnp.sqrt(_dot(b, b))
    tol = jnp.maximum(rtol * bnorm, atol)
    m = int(restart)
    dtype = b.dtype
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    im = jnp.arange(m)

    def cycle(x):
        """One GMRES(m) cycle from x; returns (x_new, arnoldi_steps)."""
        r = b - operator(x)
        beta = jnp.sqrt(_dot(r, r))
        v0 = r / jnp.where(beta > 0, beta, 1.0)
        V = jnp.zeros((m + 1,) + b.shape, dtype).at[0].set(v0)
        R = jnp.zeros((m, m), dtype)
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)

        def inner_cond(s):
            j, res = s[0], s[1]
            return jnp.logical_and(j < m, res > tol)

        def inner_body(s):
            j, _, V, R, cs, sn, g = s
            w = operator(precond(V[j]))

            def mgs(i, carry):
                w, h = carry
                hi = jnp.where(i <= j, _dot(V[i], w), 0.0)
                return w - hi * V[i], h.at[i].set(hi)

            w, h = jax.lax.fori_loop(0, m + 1, mgs,
                                     (w, jnp.zeros((m + 1,), dtype)))
            h_next = jnp.sqrt(_dot(w, w))
            hcol = h.at[j + 1].set(h_next)

            def rot(i, hcol):
                act = i < j
                t0 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                t1 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                return (hcol.at[i].set(jnp.where(act, t0, hcol[i]))
                        .at[i + 1].set(jnp.where(act, t1, hcol[i + 1])))

            hcol = jax.lax.fori_loop(0, m, rot, hcol)
            hj, hj1 = hcol[j], hcol[j + 1]
            denom = jnp.sqrt(hj * hj + hj1 * hj1)
            safe = jnp.where(denom > 0, denom, 1.0)
            c = jnp.where(denom > 0, hj / safe, jnp.ones((), dtype))
            s_ = jnp.where(denom > 0, hj1 / safe, jnp.zeros((), dtype))
            cs, sn = cs.at[j].set(c), sn.at[j].set(s_)
            hcol = hcol.at[j].set(c * hj + s_ * hj1).at[j + 1].set(0.0)
            R = R.at[:, j].set(hcol[:m])
            gj = g[j]
            g = g.at[j].set(c * gj).at[j + 1].set(-s_ * gj)
            res = jnp.abs(g[j + 1])
            # lucky breakdown (h_next ~ 0): keep the zero vector; res is
            # already ~0 so the loop exits
            V = V.at[j + 1].set(
                jnp.where(h_next > eps * beta,
                          w / jnp.where(h_next > 0, h_next, 1.0),
                          jnp.zeros_like(w)))
            return j + 1, res, V, R, cs, sn, g

        j, _, V, R, cs, sn, g = jax.lax.while_loop(
            inner_cond, inner_body,
            (jnp.asarray(0, jnp.int32), beta, V, R, cs, sn, g))

        # y = R[:j,:j]^-1 g[:j], masked to the full m x m triangle
        used = im < j
        diag = jnp.where(used, jnp.diagonal(R), jnp.ones((m,), dtype))
        R_safe = R.at[im, im].set(jnp.where(jnp.abs(diag) > 0, diag, 1.0))
        y = jax.scipy.linalg.solve_triangular(
            R_safe, jnp.where(used, g[:m], 0.0), lower=False)
        # HIGHEST: this product is the solution update itself, and on a
        # GPU the default precision of an f32 contraction is TF32
        dx = jnp.tensordot(y, V[:m], axes=1, precision=_HIGHEST)
        return x + precond(dx), j

    r0 = b - operator(x0)
    rn0 = jnp.sqrt(_dot(r0, r0))

    def outer_cond(s):
        _, k, rnorm = s
        return jnp.logical_and(k < max_iter, rnorm > tol)

    def outer_body(s):
        x, k, _ = s
        x, j = cycle(x)
        r = b - operator(x)
        # j >= 1 whenever the cycle's entry residual exceeded tol; the
        # max(j, 1) guards the degenerate j == 0 case (an fp flip between
        # the outer residual and the cycle's recomputation) from looping
        # forever without advancing k
        return x, k + jnp.maximum(j, 1), jnp.sqrt(_dot(r, r))

    x, k, rnorm = jax.lax.while_loop(
        outer_cond, outer_body, (x0, jnp.asarray(0, jnp.int32), rn0))
    # zero-RHS guard ONLY: an all-gripped/zero-dy system has condensed
    # bnorm == 0, so tol == atol (often 0) and the recomputed residual can
    # miss it by ~1e-24 of fp noise. For any genuinely nonzero RHS the
    # caller's rtol·bnorm stands un-floored (a 64·eps floor on the FULL b
    # previously reported f32 solves converged at ~8e-6 relative residual
    # even when cfg.rtol demanded tighter).
    floor = jnp.where(bnorm <= eps * jnp.sqrt(_dot(b, b)),
                      64.0 * eps * jnp.sqrt(_dot(b, b)),
                      jnp.zeros_like(bnorm))
    return SolveResult(x=x, iters=k, resnorm=rnorm,
                       converged=rnorm <= jnp.maximum(tol, floor))


SOLVERS = {"cg": pcg, "bicgstab": bicgstab, "gmres": gmres}


def compute_tree_factor(model: FeaModel, active, cfg: FeaConfig,
                        anchored=None, free_chain=None,
                        chain_act_b=None, jump_act_b=None):
    """The per-solve tree-PC factorization (fast path), exposed so ramp
    drivers can REUSE it across steps whose active mask did not change —
    between fracture events the factorization is step-invariant and
    dominates the cold-solve cost at 1e5+ DOF.

    ``free_chain``/``chain_act_b``/``jump_act_b`` optionally inject the
    chain-permuted free mask and plan-order bool active masks so callers
    that already gathered them skip the duplicate N-row bool gathers."""
    from .tree_jax import tree_factor_fast
    free = model.free_nodes if anchored is None \
        else jnp.logical_and(model.free_nodes, anchored)
    free_p = free[model.chain.perm] if free_chain is None else free_chain
    reg_pc = max(cfg.reg, cfg.tree_reg_rel * model.tree.meta.k_scale)
    factor = tree_factor_fast(model.tree, model.tree_fast, model.chain,
                              active, free, free_p,
                              jnp.asarray(reg_pc, model.coords.dtype),
                              model.conn,
                              chain_act_b=chain_act_b,
                              jump_act_b=jump_act_b)
    if cfg.tree_coarse_weight > 0.0 and model.chain is not None:
        # the cluster-coarse operator shares the factor's (active, free)
        # invariants: bundle its dense inverse so solves/ramps reuse it
        from .coarse import (_coarse_inverse, coarse_cluster_blocks,
                             plan_nb)
        nb = plan_nb(model.n_nodes)
        kblk = coarse_cluster_blocks(nb, cfg)
        ainv = _coarse_inverse(model, model.chain, active, free, cfg,
                               nb, kblk)
        factor = factor._replace(coarse_ainv=ainv)
    return factor


def solve_displacement(model: FeaModel, active: jnp.ndarray,
                       dy_top, dy_bot, x0: jnp.ndarray,
                       cfg: FeaConfig,
                       anchored: jnp.ndarray | None = None,
                       tree_factor_val=None) -> SolveResult:
    """One boundary-value solve of the ramp: K_ff u_f = −K_fk u_k.

    ``anchored`` (n_nodes,) marks nodes still connected to a grip through
    active elements; unanchored free nodes are pinned to zero, which is
    exactly the direct solver's answer for them (their b is 0) and keeps the
    effective operator's spectrum away from the reg·I floor.

    ``tree_factor_val`` (optional) is a precomputed compute_tree_factor
    result (chain + tree_fast path only); drivers pass it to amortize the
    factorization across ramp steps with an unchanged active mask.
    """
    from .bc import bc_operator, bc_rhs, prescribed_values
    free = model.free_nodes if anchored is None \
        else jnp.logical_and(model.free_nodes, anchored)
    u_k = prescribed_values(model, dy_top, dy_bot)

    if cfg.operator == "chain" and model.chain is not None:
        # run the Krylov loop entirely in chain-permuted node space — the
        # per-iteration operator is then shifts + jump products only (see
        # chain.py); the permutation gathers are paid once per solve here
        from .chain import chain_apply, plan_active_masks
        plan = model.chain
        chain_act, jump_act = plan_active_masks(plan, active)
        free_p = free[plan.perm]
        freef = free_p[:, None]
        u_k_p = u_k[plan.perm]
        x0_p = jnp.where(freef, x0[plan.perm], u_k_p)
        reg = jnp.asarray(cfg.reg, u_k.dtype)

        def operator(u):
            uf = jnp.where(freef, u, 0.0)
            ku = chain_apply(plan, chain_act, jump_act, uf)
            return jnp.where(freef, ku + reg * uf, u)

        b = jnp.where(freef,
                      -chain_apply(plan, chain_act, jump_act, u_k_p),
                      u_k_p)
        if cfg.precond == "tree" and model.tree_fast is not None:
            # gather-free path (unified ordering): factorization from
            # chain shifts + static tables, apply directly on chain-order
            # residuals (slots are positions [0, n_slots) — slices, not
            # the two N-row permutation gathers per iteration)
            from .tree_jax import tree_apply_chain
            factor = (tree_factor_val if tree_factor_val is not None
                      else compute_tree_factor(model, active, cfg,
                                               anchored))
            if cfg.tree_coarse_weight > 0.0:
                cc = _coarse_chain_fn(model, active, cfg, free,
                                      ainv=factor.coarse_ainv)
                w = float(cfg.tree_coarse_weight)
                precond = lambda r: (tree_apply_chain(model.tree, factor,  # noqa: E731
                                                      r) + w * cc(r))
            else:
                precond = lambda r: tree_apply_chain(model.tree, factor, r)  # noqa: E731
        elif cfg.precond == "tree" and cfg.tree_coarse_weight > 0.0:
            # tree PC in node space + coarse correction directly in chain
            # space: the 128-node clusters ARE the chain-plane rows, so
            # restriction/prolongation are reshape-sums and broadcasts —
            # no gathers or scatters (the node-space version's scatter-add
            # restriction costs as much as the tree apply itself)
            import dataclasses as _dc
            tree_only = _dc.replace(cfg, tree_coarse_weight=0.0)
            node_pc = make_preconditioner(model, active, tree_only, free)
            cc = _coarse_chain_fn(model, active, cfg, free)
            w = float(cfg.tree_coarse_weight)
            precond = lambda r: (node_pc(r[plan.inv_perm])[plan.perm]  # noqa: E731
                                 + w * cc(r))
        elif cfg.precond in ("tree", "coarse"):
            # these PCs live in node space; wrap them with the chain
            # permutation (two static gathers per iteration)
            node_pc = make_preconditioner(model, active, cfg, free)
            precond = lambda r: node_pc(r[plan.inv_perm])[plan.perm]  # noqa: E731
        elif cfg.precond != "none":
            inv_blocks = invert_blocks(diag_blocks(model, active, cfg,
                                                   free))[plan.perm]
            precond = lambda r: mv3(inv_blocks, r)  # noqa: E731
        else:
            precond = lambda r: r  # noqa: E731
        bnorm = jnp.sqrt(_dot(jnp.where(freef, b, 0.0),
                              jnp.where(freef, b, 0.0)))
        kw = ({"restart": cfg.gmres_restart} if cfg.solver == "gmres"
              else {})
        if cfg.solver == "cg" and cfg.precond == "tree":
            kw["n_restarts"] = cfg.cg_restarts
        res = SOLVERS[cfg.solver](operator, b, x0_p, precond, cfg.rtol,
                                  cfg.atol, cfg.max_iter, bnorm=bnorm,
                                  **kw)
        return res._replace(x=res.x[plan.inv_perm])

    operator = bc_operator(model, active, cfg, free)
    b = bc_rhs(model, active, u_k, cfg, free)
    precond = make_preconditioner(model, active, cfg, free)
    # start from the warm start with BC/pinned values overwritten so the
    # prescribed rows carry zero initial residual
    x0 = jnp.where(free[:, None], x0, u_k)
    # tolerance scales with the condensed RHS (free rows only)
    bnorm = jnp.sqrt(_dot(jnp.where(free[:, None], b, 0.0),
                          jnp.where(free[:, None], b, 0.0)))
    solver = SOLVERS[cfg.solver]
    kw = {"restart": cfg.gmres_restart} if cfg.solver == "gmres" else {}
    if cfg.solver == "cg" and cfg.precond == "tree":
        kw["n_restarts"] = cfg.cg_restarts
    return solver(operator, b, x0, precond, cfg.rtol, cfg.atol, cfg.max_iter,
                  bnorm=bnorm, **kw)
