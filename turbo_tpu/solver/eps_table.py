"""EPS subproblem-root table: precomputed dive tree for the batched engine.

After every EPS refill a lane replays its k-step bit-path dive in
lockstep with solving neighbours — k visits per refill, the single
biggest occupancy loss of the SIMD architecture
(the reference's MIMD blocks pay a dive only per block,
barebones_dive_and_solve.hpp:674-711, so they never see this tax).

This module removes the dive phase from the solve loop entirely: the
2^k-leaf dive tree is expanded ONCE, level by level, by a small jitted
"dive level" program (propagate the frontier -> classify -> select ->
branch), sharing every prefix: total work is ~2*2^k node propagations
instead of k*2^k lockstep replays, and it runs at full batch occupancy.
The surviving leaves (stores + strategy cursors + bit-paths) become a
device-resident table carried in the search state; a refill is then a
single row gather that drops the lane straight into SOLVE phase.

Dead prefixes are detected during the build (bot / entailed / no
splittable var) and accounted exactly like the engine's dive-leaf
subtree skip (engine.step VIII, barebones:717-741): a dead node at
level l covers 2^(k-l) subproblems -> 1 solved + (2^(k-l)-1) skipped.
Entailed prefixes also seed the incumbent (their lb plane is a valid
solution box, lb[obj] its best objective — same reasoning as the
engine's solution block, barebones:992-1009).

Soundness: the table rows partition the shard's subproblem range by
construction (each branch's two children partition the parent box, and
range-pruned branches belong to other shards); propagation only
removes non-solutions. Branch-variable selection uses the SAME
solver._select / _children code as the engine, so the tree shape
matches what the in-engine dive would have produced at fixpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.ops import INF, NINF

I32 = jnp.int32
_BIG_CAP = 1 << 30  # build propagates to TRUE fixpoint (no per-step cap)


class TableBuildTimeout(Exception):
    """Raised internally when the build exceeds its deadline
    (solver._table_deadline on solver.clock(), set by solve() from the
    -t budget); the caller falls back to dive-mode refills instead of
    blowing the user's timeout on presolve work."""


@dataclasses.dataclass
class SubTable:
    """Host-side build result; engine.init_state ships it to the device."""
    lb: np.ndarray       # (n_pad, V) int32 leaf stores (plan space)
    ub: np.ndarray
    strat: np.ndarray    # (n_pad,) int32 post-dive strategy cursor
    path: np.ndarray     # (n_pad,) int32 bit-path (for resplit / stats)
    n_live: int
    n_pad: int
    # Build statistics, seeded into the engine's counters so the
    # reported nodes/fails/fixpoint work include the dive tree.
    nodes: int = 0
    fails: int = 0
    fpit: int = 0
    deds: float = 0.0
    solved: int = 0      # subproblems completed by dead prefixes
    skipped: int = 0     # subproblems skipped by dead prefixes
    sols: int = 0
    dmax: int = 0        # deepest level classified (peakDepth seed)
    nonexh: bool = False
    has_cand: bool = False
    cand_bound: int = INF
    cand_lb: Optional[np.ndarray] = None  # (V,)
    cand_ub: Optional[np.ndarray] = None
    build_time: float = 0.0


def table_n_pad(solver) -> int:
    """Static table row count: the largest per-shard range, padded.
    Depends only on (k, num_shards) — never on the build outcome — so
    the compiled step program's shape is stable across runs."""
    from .plan import quantize
    total = solver.num_sub_total
    per = max(1, total // solver.num_shards)
    mx = total - (solver.num_shards - 1) * per
    return quantize(max(mx, 1))


def _make_programs(solver):
    """ONE compiled program: the dive level. The build keeps its device
    surface minimal: root planes arrive by host transfer and the final
    leaf embed runs in numpy (build_table)."""
    if getattr(solver, "_tbl_programs", None) is not None:
        return solver._tbl_programs

    plan, kernels, cfg = solver.plan, solver.kernels, solver.cfg
    W, V = cfg.num_dives, plan.V
    obj = plan.obj

    def _embed(lb_par, ub_par, strat_par, var_par, c0l, c0u, c1l, c1u,
               pidx, pbit):
        rows = jnp.arange(W, dtype=I32)
        lbp = lb_par[pidx]
        ubp = ub_par[pidx]
        stp = strat_par[pidx]
        vp = var_par[pidx]
        cl = jnp.where(pbit == 1, c1l[pidx], c0l[pidx])
        cu = jnp.where(pbit == 1, c1u[pidx], c0u[pidx])
        lbp = lbp.at[rows, vp].max(cl)
        ubp = ubp.at[rows, vp].min(cu)
        return lbp, ubp, stp

    def dive_level(lb_par, ub_par, strat_par, var_par, c0l, c0u, c1l,
                   c1u, pidx, pbit):
        lbp, ubp, stp = _embed(lb_par, ub_par, strat_par, var_par,
                               c0l, c0u, c1l, c1u, pidx, pbit)
        if cfg.fp_mode == "wac1":
            lb2, ub2, iters, _ = kernels.fixpoint_wac1(
                lbp, ubp, _BIG_CAP, cfg.wac1_inner_cap)
        else:
            # _BIG_CAP: the build always reaches the true fixpoint, so
            # the unconverged mask is empty by construction.
            lb2, ub2, iters, _ = kernels.fixpoint(lbp, ubp, _BIG_CAP)
        bot = kernels.is_bot(lb2, ub2)
        ent = kernels.all_entailed(lb2, ub2) & ~bot
        found, var2, nstrat, valo = solver._select(lb2, ub2, stp)
        lo = jnp.take_along_axis(lb2, var2[:, None], 1)[:, 0]
        hi = jnp.take_along_axis(ub2, var2[:, None], 1)[:, 0]
        d0l, d0u, d1l, d1u = solver._children(valo, lo, hi)
        strat2 = jnp.where(found, nstrat, stp)
        objlb = lb2[:, obj]
        return (lb2, ub2, strat2, var2, d0l, d0u, d1l, d1u,
                bot, ent, found, iters, objlb)

    exW = jax.ShapeDtypeStruct((W, V), I32)
    exw = jax.ShapeDtypeStruct((W,), I32)
    ex_args = (exW, exW, exw, exw, exw, exw, exw, exw, exw, exw)
    progs = {"dive": solver.compile(jax.jit(dive_level).lower(*ex_args))}
    solver._tbl_programs = progs
    return progs


class _Chunk:
    """One frontier chunk: device outputs of a dive_level call plus the
    host bookkeeping needed to expand it."""
    __slots__ = ("lb", "ub", "strat", "var", "c0l", "c0u", "c1l", "c1u",
                 "rows", "paths")

    def __init__(self, dev, rows, paths):
        (self.lb, self.ub, self.strat, self.var,
         self.c0l, self.c0u, self.c1l, self.c1u) = dev
        self.rows = rows      # np int32: live row indices in this chunk
        self.paths = paths    # np int64: bit-path per live row


def build_table(solver, shard_idx: int = 0) -> Optional[SubTable]:
    """Expand the shard's dive tree and return its leaf table.

    Returns None when the build overruns `solver._table_deadline` (a
    deadline on `solver.clock()`, which stops during XLA compiles,
    budgeted from -t by solve());
    the wasted wall time is recorded in `solver._table_aborted_s` so
    the solve budget still charges it (reference `-t` bounds the whole
    run, test_turbo.sh:38). Progress is reported on stderr as `%` lines
    once the build runs longer than ~2 s (a k=14 build issues
    ~2*2^k/W serial device calls)."""
    import sys
    cfg, plan = solver.cfg, solver.plan
    W = cfg.num_dives
    k = solver.k
    total = solver.num_sub_total
    per = max(1, total // solver.num_shards)
    base = shard_idx * per
    limit = (total if shard_idx == solver.num_shards - 1
             else min(base + per, total))
    # Compile the dive-level program BEFORE starting the build clock:
    # build_time is charged against the solve budget (the reference's
    # dive work runs inside solveTime) but XLA compile belongs to
    # initTime.
    progs = _make_programs(solver)
    t_start = time.monotonic()
    deadline = getattr(solver, "_table_deadline", None)
    last_progress = [t_start]

    def checkpoint(level, n_chunks):
        """Deadline check + throttled progress, called between device
        calls (the build's only preemption points)."""
        now = time.monotonic()
        if now - last_progress[0] > 5.0 and now - t_start > 2.0:
            last_progress[0] = now
            print(f"% table build: level {level}/{k} "
                  f"({n_chunks} frontier chunks, "
                  f"{now - t_start:.0f}s elapsed)",
                  file=sys.stderr, flush=True)
        if deadline is not None and solver.clock() > deadline:
            raise TableBuildTimeout()
    eps_skip = 1 if getattr(solver, "has_eps", False) else 0
    pscale = float(plan.num_real_props)
    is_opt = bool(plan.is_opt)

    acc = SubTable(lb=None, ub=None, strat=None, path=None,
                   n_live=0, n_pad=table_n_pad(solver))

    def classify(raw, rows, paths, level):
        """Account a freshly-propagated chunk; return the expandable
        subset (rows, paths) and the trimmed device arrays."""
        dev = raw[:8]
        bot, ent, found, iters, objlb = (np.asarray(x) for x in
                                         jax.device_get(raw[8:]))
        n = len(rows)
        acc.nodes += n
        acc.fpit += int(iters[rows].sum())
        acc.deds += float(iters[rows].sum()) * pscale
        if n:
            acc.dmax = max(acc.dmax, level)
        keep_rows, keep_paths = [], []
        shift = k - level
        for r, p in zip(rows, paths):
            lo_cov = int(p) << shift
            hi_cov = (int(p) + 1) << shift
            cov = min(hi_cov, limit) - max(lo_cov, base)
            if bot[r]:
                acc.fails += 1
                if cov >= 1:
                    acc.solved += 1
                    acc.skipped += cov - 1
            elif ent[r]:
                objv = int(objlb[r])
                better = (objv < acc.cand_bound) if is_opt \
                    else (not acc.has_cand)
                if better:
                    acc.sols += 1
                    acc.has_cand = True
                    acc.cand_bound = objv if is_opt else 0
                    acc.cand_lb = np.asarray(
                        jax.device_get(dev[0][int(r)]))
                    acc.cand_ub = np.asarray(
                        jax.device_get(dev[1][int(r)]))
                if cov >= 1:
                    acc.solved += 1
                    acc.skipped += cov - 1
            elif not found[r]:
                # No splittable var but not entailed: unbounded vars
                # remain (engine: incomplete -> exhaustive=false).
                acc.nonexh = True
                if cov >= 1:
                    acc.solved += 1
                    acc.skipped += cov - 1
            else:
                keep_rows.append(int(r))
                keep_paths.append(int(p))
        return _Chunk(dev, np.asarray(keep_rows, dtype=np.int64),
                      np.asarray(keep_paths, dtype=np.int64))

    # Level 0: the root (host transfer; no dedicated device program).
    V = plan.V
    lb_r = jnp.asarray(np.tile(plan.lb0[None, :], (W, 1)).astype(np.int32))
    ub_r = jnp.asarray(np.tile(plan.ub0[None, :], (W, 1)).astype(np.int32))
    z = jnp.zeros((W,), dtype=I32)
    neu0l = jnp.full((W,), NINF, dtype=I32)
    neu0u = jnp.full((W,), INF, dtype=I32)
    raw = progs["dive"](lb_r, ub_r, z, z, neu0l, neu0u, neu0l, neu0u,
                        z, z)
    parents = [classify(raw, np.asarray([0]), np.asarray([0]), 0)]

    def expand(level, make_call):
        """Construct level-`level` chunks from `parents` (level-1)."""
        out = []
        shift = k - level
        for ch in parents:
            kids = []  # (parent_row, bit, path)
            for r, p in zip(ch.rows, ch.paths):
                for bit in (0, 1):
                    cp = int(p) * 2 + bit
                    lo_cov = cp << shift
                    hi_cov = (cp + 1) << shift
                    if min(hi_cov, limit) - max(lo_cov, base) >= 1:
                        kids.append((int(r), bit, cp))
            for g0 in range(0, len(kids), W):
                checkpoint(level, len(parents))
                grp = kids[g0:g0 + W]
                pidx = np.zeros(W, dtype=np.int32)
                pbit = np.zeros(W, dtype=np.int32)
                pidx[:len(grp)] = [g[0] for g in grp]
                pbit[:len(grp)] = [g[1] for g in grp]
                res = make_call(ch, jnp.asarray(pidx), jnp.asarray(pbit))
                out.append((res, np.arange(len(grp)),
                            np.asarray([g[2] for g in grp])))
        return out

    try:
        for level in range(1, k):
            raws = expand(level, lambda ch, pidx, pbit: progs["dive"](
                ch.lb, ch.ub, ch.strat, ch.var, ch.c0l, ch.c0u, ch.c1l,
                ch.c1u, pidx, pbit))
            parents = [classify(raw, rows, paths, level)
                       for raw, rows, paths in raws]
            parents = [c for c in parents if len(c.rows)]
            if not parents:
                break
    except TableBuildTimeout:
        solver._table_aborted_s = time.monotonic() - t_start
        print(f"% table build deadline exceeded at level<= {k}: "
              f"abandoning after {solver._table_aborted_s:.1f}s; "
              f"falling back to dive-mode refills",
              file=sys.stderr, flush=True)
        return None

    # Leaf level k: embed-only, done host-side in numpy (the lane's
    # first step propagates the leaf anyway, and skipping a dedicated
    # device program saves a compile per shape).
    leaf_lb, leaf_ub, leaf_st, leaf_paths = [], [], [], []
    for ch in parents:
        if not len(ch.rows):
            continue
        lbh, ubh, sth, vrh, c0lh, c0uh, c1lh, c1uh = (
            np.asarray(x) for x in jax.device_get(
                (ch.lb, ch.ub, ch.strat, ch.var,
                 ch.c0l, ch.c0u, ch.c1l, ch.c1u)))
        for bit in (0, 1):
            cps = ch.paths * 2 + bit
            inr = (cps >= base) & (cps < limit)
            rs = ch.rows[inr]
            if not len(rs):
                continue
            lbn = lbh[rs].copy()
            ubn = ubh[rs].copy()
            v = vrh[rs]
            cl = (c1lh if bit else c0lh)[rs]
            cu = (c1uh if bit else c0uh)[rs]
            ar = np.arange(len(rs))
            lbn[ar, v] = np.maximum(lbn[ar, v], cl)
            ubn[ar, v] = np.minimum(ubn[ar, v], cu)
            leaf_lb.append(lbn)
            leaf_ub.append(ubn)
            leaf_st.append(sth[rs])
            leaf_paths.append(cps[inr])

    n_pad = acc.n_pad
    if leaf_lb:
        tlb = np.concatenate(leaf_lb, axis=0).astype(np.int32)
        tub = np.concatenate(leaf_ub, axis=0).astype(np.int32)
        tst = np.maximum(np.concatenate(leaf_st), eps_skip).astype(np.int32)
        tpa = np.concatenate(leaf_paths).astype(np.int32)
    else:
        tlb = np.zeros((0, V), dtype=np.int32)
        tub = np.zeros((0, V), dtype=np.int32)
        tst = np.zeros((0,), dtype=np.int32)
        tpa = np.zeros((0,), dtype=np.int32)
    if len(tlb):
        # Deterministic live ordering: sort leaves by bit-path (chunk
        # emission order interleaves left/right children).
        order = np.argsort(tpa, kind="stable")
        tlb, tub, tst, tpa = tlb[order], tub[order], tst[order], tpa[order]
    n_live = len(tlb)
    pad = n_pad - n_live
    if pad > 0:
        # Padding rows are never gathered (refill guards newidx <
        # sub_limit == n_live); root copies keep them harmless.
        tlb = np.concatenate(
            [tlb, np.tile(plan.lb0[None, :], (pad, 1))]).astype(np.int32)
        tub = np.concatenate(
            [tub, np.tile(plan.ub0[None, :], (pad, 1))]).astype(np.int32)
        tst = np.concatenate([tst, np.zeros(pad, dtype=np.int32)])
        tpa = np.concatenate([tpa, np.zeros(pad, dtype=np.int32)])
    acc.lb, acc.ub, acc.strat, acc.path = tlb, tub, tst, tpa
    acc.n_live = n_live
    acc.build_time = time.monotonic() - t_start
    return acc
