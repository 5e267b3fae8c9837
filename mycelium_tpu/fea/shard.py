"""Multi-chip sharded solve: domain decomposition over a JAX device mesh.

The JAX equivalent of the reference's MPI-parallel PETSc solver
(reference component C21, src/fea_petsc_parallel.cpp:156-485): where PETSc
row-partitions Mat/Vec over MPI ranks and runs CG with MPI_Allreduce dot
products, this module shards nodes AND elements over a 1-D `jax.sharding`
mesh axis and runs the same block-Jacobi PCG under `shard_map`:

  MPI rank                      ->  mesh axis index
  PETSc row partition           ->  node-block shard of u/b/diag-blocks
  distributed MatMult + halo    ->  all_gather(u) + local element forces
                                    + psum_scatter of node contributions
  KSP CG MPI_Allreduce dots     ->  jax.lax.psum over the mesh axis
  VecScatterToZero + MPI_Bcast  ->  (unnecessary: out_specs gather the
                                    sharded solution directly)

On one multi-GPU host the collectives ride NVLink. The element force
pass is the same factored kernel as the single-chip path, so
1-chip and N-chip runs agree up to float associativity (asserted in tests).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import FeaConfig
from .bc import prescribed_values
from .blocks import mv3
from .model import FeaModel, diag_blocks, invert_blocks
from .solve import SolveResult


def default_mesh(n_devices: Optional[int] = None,
                 axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _pad_to(x, m, fill=0):
    pad = (-x.shape[0]) % m
    if pad == 0:
        return x
    filler = jnp.full((pad,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x, filler], axis=0)


def sharded_cg_solver(model: FeaModel, cfg: FeaConfig, mesh: Mesh,
                      axis: str = "shard"):
    """Build a jitted sharded solver: (active, dy_top, dy_bot, x0
    [, anchored, tree_factor_val]) -> SolveResult with the full (N,3)
    solution on the host layout.

    Elements and node rows are block-partitioned over the mesh axis
    (PETSC_DECIDE-style even split, padded to a device multiple). Padded
    elements carry zero stiffness and point at node 0; padded nodes are
    pinned (free=False) with zero prescribed values, so they never
    contribute.

    With ``cfg.precond == 'tree'`` (and a chain/tree-capable model) the
    solve runs in chain-permuted node order and the spanning-forest PC is
    applied REDUNDANTLY: each shard all-gathers the residual, runs the
    full tree apply (plus the optional cluster-coarse correction), and
    keeps its local slice — the PETSc 'redundant preconditioner,
    distributed operator' pattern (cf. PCREDUNDANT; the reference's
    bjacobi PC likewise does not scale PC quality with ranks,
    fea_petsc_parallel.cpp:336-339). Iteration counts therefore match the
    single-chip tree-PC solver, and the per-call ``tree_factor_val``
    (solve.compute_tree_factor) lets ramp drivers amortize the
    factorization across steps exactly like the single-chip path.
    """
    n_dev = int(mesh.devices.size)
    N = model.n_nodes
    dtype = model.coords.dtype
    # node padding: a device multiple, and with the coarse level also a
    # cluster-width multiple per shard so clusters never cross shard
    # boundaries
    use_coarse = cfg.precond == "coarse"
    use_tree = (cfg.precond == "tree" and model.chain is not None
                and model.tree is not None
                and getattr(model, "tree_fast", None) is not None)
    if cfg.precond == "tree" and not use_tree:
        if model.chain is None:
            raise ValueError("sharded precond='tree' needs the chain "
                             "ordering and tree plan: build the model with "
                             "operator='chain', precond='tree'")
        # chain exists but the tree plan is empty (e.g. a fully-gripped
        # mesh has no free nodes to eliminate): PC choice is then
        # irrelevant — degrade to block-Jacobi, same solution
        use_tree = False
    if use_coarse and model.chain is None:
        raise ValueError("sharded precond='coarse' needs the chain node "
                         "ordering: build the model with operator='chain' "
                         "(coarse clusters must be spatially coherent — "
                         "creation-order clusters make the correction "
                         "counterproductive)")
    from .coarse import _ramp_weight, coarse_cluster_blocks, plan_nb
    kblk = coarse_cluster_blocks(plan_nb(N), cfg) if use_coarse else 1
    width = 128 * kblk                 # coarse cluster width (cap on the
    #                                    dense coarse dim, see coarse_max_dim)
    quantum = n_dev * width if use_coarse else n_dev
    Np = N + ((-N) % quantum)
    nb_tot = Np // 128 if use_coarse else 0
    n_basis = 2 if cfg.coarse_basis == "linear" else 1

    # the tree PC's optional additive cluster-coarse term (tree_coarse_
    # weight > 0) reuses the factor's cached dense inverse; its cluster
    # geometry is the single-chip one (solve._coarse_chain_fn)
    w_tc = float(cfg.tree_coarse_weight) if use_tree else 0.0
    if w_tc > 0.0:
        nb_t = plan_nb(N)
        kblk_t = coarse_cluster_blocks(nb_t, cfg)
        width_t = 128 * kblk_t
        nbc_t = -(-nb_t // kblk_t)
        use_ramp_t = cfg.coarse_basis == "linear"
        rampw_t = np.asarray(_ramp_weight(
            jnp.arange(nbc_t * width_t, dtype=jnp.int32) % width_t,
            width_t), dtype)
    else:
        nbc_t = width_t = 0
        use_ramp_t = False
        rampw_t = np.zeros((1,), dtype)

    # with the coarse level or the tree PC, the whole solve runs in
    # CHAIN-permuted node order: 128-node clusters are then contiguous
    # chain runs / tree slots are positions [0, n_slots), and shard halos
    # shrink as a side effect
    permuted = use_coarse or use_tree
    perm = model.chain.perm if permuted else None
    inv_perm = model.chain.inv_perm if permuted else None
    conn_eff = inv_perm[model.conn] if permuted else model.conn

    conn_p = _pad_to(conn_eff, n_dev, 0)
    n_geom = _pad_to(model.geom.n, n_dev, 0.0)
    k_ax_p = _pad_to(model.geom.k_ax, n_dev, 0.0)   # zero-stiffness padding
    k_bd_p = _pad_to(model.geom.k_bd, n_dev, 0.0)

    spec1 = P(axis)
    rep = P()

    def body(local, rep):
        """Per-shard CG. Local vectors are (Np/n_dev, 3); conn_l holds
        GLOBAL node ids resolved against the all-gathered displacement.
        ``rep`` carries the replicated PC operands: the dense coarse
        inverse for precond='coarse', or (tree plan, factor, chain-order
        free mask, ramp weights) for precond='tree'."""
        (conn_l, n_l, kax_l, kbd_l, active_l,
         free_l, u_k_l, inv_b_l, x0_l) = local
        freef = free_l[:, None]
        reg = jnp.asarray(cfg.reg, dtype)

        def pdot(a, b):
            return jax.lax.psum(jnp.sum(a * b), axis)

        def matvec_k(u_l):
            u_full = jax.lax.all_gather(u_l, axis, tiled=True)    # (Np,3)
            u1 = u_full[conn_l[:, 0]]
            u2 = u_full[conn_l[:, 1]]
            d = u1 - u2
            nd = jnp.sum(n_l * d, axis=1)
            f = (kax_l * nd)[:, None] * n_l \
                + kbd_l[:, None] * (d - nd[:, None] * n_l)
            f = f * active_l[:, None].astype(f.dtype)
            contrib = jnp.zeros((Np, 3), dtype)
            contrib = contrib.at[conn_l[:, 0]].add(f)
            contrib = contrib.at[conn_l[:, 1]].add(-f)
            return jax.lax.psum_scatter(contrib, axis,
                                        scatter_dimension=0, tiled=True)

        def matvec(u_l):
            v_l = jnp.where(freef, u_l, 0.0)
            kv_l = matvec_k(v_l)
            return jnp.where(freef, kv_l + reg * v_l, u_l)

        if use_tree:
            from .solve import coarse_chain_apply
            from .tree_jax import tree_apply_chain
            tplan_r, fac_r, free_chain_r, rampw_r = rep
            S_loc = Np // n_dev
            me = jax.lax.axis_index(axis)

            def precond(r_l):
                """Redundant tree-PC apply: gather the full chain-order
                residual, run the forest elimination (+ the optional
                cluster-coarse correction) identically on every shard,
                keep the local row block. The PC compute is duplicated
                per device, but its cost is a fraction of the matvec's
                and iteration counts drop ~100x vs block-Jacobi."""
                r_full = jax.lax.all_gather(r_l, axis, tiled=True)[:N]
                z = tree_apply_chain(tplan_r, fac_r, r_full)
                if w_tc > 0.0:
                    z = z + w_tc * coarse_chain_apply(
                        fac_r.coarse_ainv, free_chain_r, r_full, N,
                        nbc_t, width_t, rampw_r, use_ramp_t)
                zp = jnp.pad(z, ((0, Np - N), (0, 0)))
                return jax.lax.dynamic_slice_in_dim(zp, me * S_loc, S_loc,
                                                    axis=0)
        elif use_coarse:
            (ainv_r,) = rep
            nbc_loc = Np // n_dev // width
            rampw = _ramp_weight(jnp.arange(width), width).astype(dtype)
            me = jax.lax.axis_index(axis)

            def coarse(r_l):
                """Two-level correction: shard-local cluster restriction,
                replicated dense coarse solve (rc is a few KB — the
                all_gather is the analogue of PETSc GAMG's coarsest-level
                redundant solve), local prolongation."""
                rf = r_l * freef
                rcl = rf.reshape(nbc_loc, width, 3)
                parts_l = [jnp.sum(rcl, axis=1)]               # (nbc_loc,3)
                if n_basis == 2:
                    parts_l.append(jnp.sum(rcl * rampw[None, :, None],
                                           axis=1))
                rc_l = jnp.stack(parts_l, axis=0)              # (nb_basis,...)
                rc = jax.lax.all_gather(rc_l, axis)            # (D,nb_b,nbc_loc,3)
                # global dof order fb*3*nbc + comp*nbc + cluster, with
                # cluster = dev*nbc_loc + local cluster
                rc = jnp.moveaxis(rc, (1, 3), (0, 1))          # (nb_b,3,D,nbc_loc)
                rc_vec = rc.reshape(-1)
                # HIGHEST: on a GPU the default precision of an f32
                # matvec is TF32
                zc = jnp.dot(ainv_r.astype(dtype), rc_vec,
                             precision=jax.lax.Precision.HIGHEST)
                zc = zc.reshape(n_basis, 3, n_dev, nbc_loc)
                zme = jax.lax.dynamic_index_in_dim(
                    jnp.moveaxis(zc, 2, 0), me, axis=0,
                    keepdims=False)                            # (nb_b,3,nbc_loc)
                zn = jnp.repeat(zme[0].T[:, None, :], width, axis=1)
                if n_basis == 2:
                    zn = zn + zme[1].T[:, None, :] * rampw[None, :, None]
                return zn.reshape(-1, 3) * freef

            def precond(r_l):
                return mv3(inv_b_l, r_l) + coarse(r_l)
        else:
            def precond(r_l):
                return mv3(inv_b_l, r_l)

        b_l = jnp.where(freef, -matvec_k(u_k_l), u_k_l)
        bnorm = jnp.sqrt(pdot(jnp.where(freef, b_l, 0.0),
                              jnp.where(freef, b_l, 0.0)))
        tol = jnp.maximum(cfg.rtol * bnorm, cfg.atol)

        x_l = jnp.where(freef, x0_l, u_k_l)
        r = b_l - matvec(x_l)
        z = precond(r)
        rz = pdot(r, z)
        rn0 = jnp.sqrt(pdot(r, r))
        state0 = (x_l, r, z, z, rz, rn0,
                  jnp.asarray(0, jnp.int32), rn0, jnp.asarray(0, jnp.int32))

        # stagnation exit, same constants/semantics as solve.pcg: f32 CG
        # can floor a hair above tol and would otherwise spin to max_iter
        stall_window, stall_accept = 256, 10.0
        near_window = max(stall_window // 8, 8)

        def cond(s):
            rnorm, k, _, since = s[-4], s[-3], s[-2], s[-1]
            near = rnorm <= stall_accept * tol
            stalled = since >= jnp.where(near, near_window, stall_window)
            return (k < cfg.max_iter) & (rnorm > tol) & ~stalled

        def it(s):
            x, r, z, p, rz, _, k, best, since = s
            ap = matvec(p)
            pap = pdot(p, ap)
            alpha = jnp.where(pap > 0, rz / jnp.where(pap > 0, pap, 1.0),
                              0.0)
            x = x + alpha * p
            r = r - alpha * ap
            z = precond(r)
            rz_new = pdot(r, z)
            beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0),
                             0.0)
            p = z + beta * p
            rnorm = jnp.sqrt(pdot(r, r))
            improved = rnorm < best * (1.0 - 1e-3)
            best = jnp.minimum(best, rnorm)
            since = jnp.where(improved, 0, since + 1)
            return (x, r, z, p, rz_new, rnorm, k + 1, best, since)

        x, _, _, _, _, rnorm, k, _, since = \
            jax.lax.while_loop(cond, it, state0)
        stalled = since >= near_window
        converged = (rnorm <= tol) | (stalled & (rnorm <= stall_accept * tol))
        return x, k, rnorm, converged

    body_sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=((spec1,) * 9, rep),
        out_specs=(spec1, rep, rep, rep),
        check_vma=False,
    )

    # the model pytree and padded tables are jit ARGUMENTS, not closure
    # constants (see ramp.jit_ramp_step)
    @jax.jit
    def _solve(model_, tables, active, dy_top, dy_bot, x0, anchored, fac):
        conn_t, n_t, kax_t, kbd_t, rampw_tbl = tables
        active_p = _pad_to(active, n_dev, False)
        u_k = prescribed_values(model_, dy_top, dy_bot)
        free = model_.free_nodes if anchored is None \
            else jnp.logical_and(model_.free_nodes, anchored)
        inv_blocks = invert_blocks(diag_blocks(model_, active, cfg, free))
        if use_tree:
            if fac is None:
                from .solve import compute_tree_factor
                fac = compute_tree_factor(model_, active, cfg, anchored)
            u_k, x0_n = u_k[perm], x0[perm]
            free = free[perm]
            inv_blocks = inv_blocks[perm]
            rep_args = (model_.tree, fac, free.astype(dtype), rampw_tbl)
        elif use_coarse:
            from .coarse import _coarse_inverse
            ainv = _coarse_inverse(model_, model_.chain, active, free,
                                   cfg, nb_tot, kblk)
            u_k, free, x0_n = u_k[perm], free[perm], x0[perm]
            inv_blocks = inv_blocks[perm]
            rep_args = (ainv,)
        else:
            rep_args = (jnp.zeros((1, 1), dtype),)
            x0_n = x0
        u_k_p = _pad_to(u_k, quantum, 0.0)
        free_p = _pad_to(free, quantum, False)
        x0_p = _pad_to(x0_n, quantum, 0.0)
        inv_blocks_p = _pad_to(inv_blocks, quantum, 0.0)
        x_p, iters, rnorm, conv = body_sharded(
            (conn_t, n_t, kax_t, kbd_t, active_p,
             free_p, u_k_p, inv_blocks_p, x0_p), rep_args)
        x = x_p[:N][inv_perm] if permuted else x_p[:N]
        return SolveResult(x=x, iters=iters, resnorm=rnorm,
                           converged=conv)

    tables = (conn_p, n_geom, k_ax_p, k_bd_p, jnp.asarray(rampw_t))

    def solve(active, dy_top, dy_bot, x0, anchored=None,
              tree_factor_val=None):
        return _solve(model, tables, active, dy_top, dy_bot, x0, anchored,
                      tree_factor_val)

    return solve
