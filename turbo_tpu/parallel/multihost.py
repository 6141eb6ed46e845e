"""Multi-host EPS distribution (SURVEY.md §7 stage 6).

The reference is a single-GPU binary; scaling past one host there means
running independent solvers. Here each *process* (host) runs a
ShardedSolver over its local devices and owns a contiguous macro-range
of the global 2^k EPS subproblem space; hosts cooperate with two
host-side exchanges (the only cross-process traffic is small
allgathers of scalars/ranges; the mesh collectives stay inside each
process):

  1. incumbent bound: the allgathered global best is met into the
     engine's `ext_bound` state field (the cross-process analog of the grid-atomic
     `appx_best_bound`, barebones_dive_and_solve.hpp:996-997);
  2. work stealing: a deterministic steal plan computed by *every* host
     from the same allgathered (next_sub, sub_limit) snapshot - donors
     shrink their range, thieves reseed from the stolen half, no extra
     messaging round. Timing races only ever duplicate subproblems
     (donor may pass `mid` before applying the shrink), never skip
     them, so exhaustiveness is preserved.

Run one process per host with `init_distributed(...)` (wraps
`jax.distributed.initialize`); tests exercise two CPU processes on
localhost.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from ..compile.tnf import Tnf
from ..solver.engine import IDLE, EngineConfig
from ..solver.result import EngineResult
from .mesh import ShardedSolver

INF = 1 << 30


def dcn_allgather(vec: np.ndarray) -> np.ndarray:
    """Gather `vec` from every process; returns (H, *vec.shape).

    `multihost_utils.process_allgather` assumes every process owns the
    same number of local devices (it reshapes the global device list to
    (H, S)); heterogeneous hosts break it. This
    variant builds a mesh of exactly ONE device per process (sorted by
    process index), places each host's row on its own device, and
    replicates — the resharding collective crosses processes and is agnostic to
    how many other devices each host has."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    vec = np.asarray(vec)
    if jax.process_count() == 1:
        return vec[None, ...]
    by_proc = {}
    for d in jax.devices():
        by_proc.setdefault(d.process_index, d)
    devs = [by_proc[p] for p in sorted(by_proc)]
    mesh = Mesh(np.array(devs), ("h",))
    mine = by_proc[jax.process_index()]
    row = jax.device_put(vec[None, ...], mine)
    g = jax.make_array_from_single_device_arrays(
        (len(devs),) + vec.shape, NamedSharding(mesh, P("h")), [row])
    rep = jax.jit(lambda a: a,
                  out_shardings=NamedSharding(mesh, P()))(g)
    return np.asarray(rep.addressable_data(0))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed for a multi-host run. Returns True
    when a multi-process runtime was set up (False = single process,
    nothing to do). Safe to call once per process, before first JAX
    use."""
    if num_processes in (None, 1):
        return False
    import jax

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def plan_host_steal(next_mat: np.ndarray, limit_mat: np.ndarray,
                    idle: np.ndarray) -> List[Tuple[int, int, int, int, int]]:
    """Deterministic cross-host steal plan.

    next_mat/limit_mat: (H, S) int64 per-host per-local-shard subproblem
    cursors and range ends (padded shards have next==limit); idle: (H,)
    bool, host has no running lanes. Every host computes this from the
    same snapshot, so donors and thieves agree without a second round.

    Returns moves [(thief_host, donor_host, donor_shard, mid, hi)]:
    donor shard's range shrinks to [.., mid), thief reseeds [mid, hi).
    """
    next_mat = next_mat.copy()
    limit_mat = limit_mat.copy()
    rem = limit_mat - next_mat
    dry = idle & (rem.sum(axis=1) <= 0)
    moves = []
    for thief in np.nonzero(dry)[0]:
        rem = limit_mat - next_mat
        rem[dry, :] = 0          # dry hosts (incl. served thieves) can't donate
        d_host, d_shard = np.unravel_index(int(np.argmax(rem)), rem.shape)
        give = int(rem[d_host, d_shard]) // 2
        if give < 1:
            continue
        hi = int(limit_mat[d_host, d_shard])
        mid = hi - give
        limit_mat[d_host, d_shard] = mid
        dry[thief] = False
        moves.append((int(thief), int(d_host), int(d_shard), mid, hi))
    return moves


def reseed_ranges(st, D: int, n_shards: int, lb0: np.ndarray,
                  ub0: np.ndarray, lo: int, hi: int):
    """Reseed ALL local shards of a dry host with the stolen range
    [lo, hi): contiguous per-shard sub-ranges, same lane layout as
    init_state (numpy state surgery, mirrors mesh.rebalance_ranges)."""
    per = max(1, (hi - lo) // n_shards)
    out = {f: getattr(st, f).copy()
           for f in ("phase", "subp", "next_sub", "sub_limit", "depth",
                     "strat", "snap_strat", "remaining", "lb", "ub",
                     "root_lb", "root_ub")}
    for s in range(n_shards):
        sl = slice(s * D, (s + 1) * D)
        base = min(lo + s * per, hi)
        limit = hi if s == n_shards - 1 else min(base + per, hi)
        lane_sub = base + np.arange(D, dtype=np.int32)
        out["subp"][sl] = lane_sub
        out["phase"][sl] = np.where(lane_sub < limit, 0, IDLE)  # DIVE=0
        out["next_sub"][sl] = min(base + D, limit)
        out["sub_limit"][sl] = limit
        out["depth"][sl] = 0
        out["strat"][sl] = 0
        out["snap_strat"][sl] = 0
        out["remaining"][sl] = st.kpow[sl]
        out["lb"][sl] = lb0[None, :]
        out["ub"][sl] = ub0[None, :]
        out["root_lb"][sl] = lb0[None, :]
        out["root_ub"][sl] = ub0[None, :]
    return st._replace(**out)


class MultiHostSolver:
    """Per-host ShardedSolver + cross-process bound sharing and work stealing.

    Construct AFTER init_distributed(); every process must call solve()
    collectively (the allgathers are collective operations)."""

    def __init__(self, tnf: Tnf, config: EngineConfig = EngineConfig(),
                 exchange_every_chunks: int = 2):
        import jax

        if config.enumerate_all:
            # Steal races may duplicate subproblems (sound for bounds,
            # pruned by the incumbent), but enumeration would count the
            # duplicated solutions twice - route -a to one host.
            raise ValueError(
                "enumerate_all (-a) is not supported by the multi-host "
                "architecture; run it on a single host")
        import dataclasses

        # Cross-host steals move subproblem ranges between hosts whose
        # EPS tables are process-local (a thief cannot gather another
        # host's table rows); stolen ranges re-dive from the root
        # instead, so the multi-host architecture runs in dive mode.
        config = dataclasses.replace(config, use_table=False)
        self.pid = jax.process_index()
        self.n_hosts = jax.process_count()
        local = jax.local_devices()
        # Global shard layout: host h owns shard ids [off_h, off_h+S_h).
        # Device counts are allgathered so heterogeneous hosts get
        # correct offsets; the exchanged snapshot pads to
        # the largest per-host count (padded shards carry next==limit,
        # i.e. no work, so the steal planner ignores them).
        S = len(local)
        counts = dcn_allgather(
            np.array([S], dtype=np.int64)).reshape(-1)
        self.host_shards = counts.astype(np.int64)
        total_shards = int(counts.sum())
        shard_offset = int(counts[:self.pid].sum())
        self.S_max = int(counts.max())
        if config.subproblems_power <= 0:
            # The root-tree probe is wall-clock bounded, so hosts under
            # different load could derive different k and build
            # inconsistent subproblem spaces. Compute k on host 0 only
            # and broadcast it (deterministic k).
            import dataclasses

            from ..solver.engine import choose_subproblems_power
            k = choose_subproblems_power(tnf, config, total_shards,
                                         allow_probe=(self.pid == 0))
            k = int(dcn_allgather(np.array([k], dtype=np.int64))[0, 0])
            config = dataclasses.replace(config, subproblems_power=k)
        self.sharded = ShardedSolver(tnf, config, devices=local,
                                     shard_offset=shard_offset,
                                     total_shards=total_shards)
        self.plan = self.sharded.plan
        self.opt = self.sharded.opt
        # Final-reduction direction: res.objective is reported in
        # ORIGINAL objective space (result.py flips the internal
        # minimize rewrite), so maximize problems reduce with max().
        self.is_max = bool(self.sharded.tnf.is_max)
        self.exchange_every = max(1, exchange_every_chunks)
        self.S = S

    def _allgather(self, vec: np.ndarray) -> np.ndarray:
        return dcn_allgather(vec)

    def solve(self, timeout_s: float = 1e18, chunk: int = 16,
              stop_after_n_solutions: int = 1,
              verbose: bool = False, on_improve=None,
              node_limit: int = 0, checkpoint_path: str = "",
              checkpoint_every_s: float = 60.0) -> EngineResult:
        """Collective multi-host solve.

        on_improve(best_lb_tnf): called (on every host; only host 0's
        stdout is live) whenever the GLOBAL incumbent improves, at
        exchange latency — the winning host's solution store rides the
        exchanged snapshot (-i parity).
        node_limit: global node budget (-cutnodes), evaluated on the
        allgathered total so every host stops at the same tick.
        checkpoint_path: per-host files `path.h<pid>`; host 0's wall
        clock arms a save flag in the snapshot so all hosts save at the
        same exchange tick, and a restore is adopted only when EVERY
        host restored successfully (all-fresh otherwise)."""
        import os

        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        t_entry = time.monotonic()
        sh = self.sharded
        D = sh.solver.cfg.num_dives
        sharding = NamedSharding(sh.mesh, P("dives"))
        if self.plan.root_unsat:
            return EngineResult.unsat(sh)
        st = sh.init_state()
        jax.block_until_ready(st.lb)
        my_ckpt = f"{checkpoint_path}.h{self.pid}" if checkpoint_path \
            else ""
        if my_ckpt:
            from ..solver.checkpoint import load_state
            restored = None
            if os.path.exists(my_ckpt):
                restored = load_state(
                    sh.solver, my_ckpt, num_shards=self.S,
                    device_put=lambda x: jax.device_put(x, sharding))
            ok = self._allgather(np.array(
                [int(restored is not None)], dtype=np.int64)).reshape(-1)
            if ok.all() and restored is not None:
                st = restored[0]
            elif ok.any() and self.pid == 0:
                print("% warning: partial multi-host checkpoint set; "
                      "all hosts starting fresh", flush=True)
        last_ckpt = time.monotonic()
        step_n = sh.make_step_n(chunk)
        t0 = time.monotonic()
        first = True
        stopped = False
        redistributions = 0
        chunks = 0
        V = int(self.plan.V)
        last_improve_printed = INF
        # Every break decision below is computed from the *allgathered*
        # snapshot, identically on every host, at exchange ticks that
        # are synchronized by iteration count - the allgather is a
        # collective, so no host may leave the loop unilaterally (a lone
        # breaker would deadlock the others' next collective).
        while True:
            st = step_n(st)
            jax.block_until_ready(st.phase)
            if first:
                first = False
                t0 = time.monotonic()
                warmup_time = t0 - t_entry
            chunks += 1
            if chunks % self.exchange_every:
                continue
            phase, bbs, ns, slim, sols, nodes_v, has_b = jax.device_get(
                (st.phase, st.best_bound, st.next_sub, st.sub_limit,
                 st.sols, st.nodes, st.has_best))
            local_idle = bool((phase == IDLE).all())
            # Host exchange: [best, idle, want_stop, n_sols, nodes,
            #   want_ckpt, next_s..., limit_s..., best_store(V)]
            # Fixed-size snapshot across heterogeneous hosts: pad to
            # the largest local shard count with next==limit (no work).
            # The winning incumbent STORE rides the snapshot so -i can
            # print the global improving solution on host 0 (V extra
            # int64 per host per exchange — KBs).
            SM = self.S_max
            snap = np.zeros(6 + 2 * SM + V, dtype=np.int64)
            snap[0] = int(bbs.min())
            snap[1] = int(local_idle)
            snap[2] = int(time.monotonic() - t0 > timeout_s)
            snap[3] = int(sols.sum())
            snap[4] = int(nodes_v.sum())
            snap[5] = int(bool(my_ckpt) and self.pid == 0 and
                          time.monotonic() - last_ckpt
                          > checkpoint_every_s)
            for s in range(self.S):
                snap[6 + s] = int(ns[s * D])
                snap[6 + SM + s] = int(slim[s * D])
            if bool(np.asarray(has_b).any()):
                d = int(np.argmin(np.where(np.asarray(has_b),
                                           np.asarray(bbs), INF + 1)))
                snap[6 + 2 * SM:] = np.asarray(
                    jax.device_get(st.best_lb[d])).astype(np.int64)
            allsnap = self._allgather(snap)
            gbest = int(allsnap[:, 0].min())
            idle = allsnap[:, 1].astype(bool)
            total_sols = int(allsnap[:, 3].sum())
            total_nodes = int(allsnap[:, 4].sum())
            next_mat = allsnap[:, 6:6 + SM]
            limit_mat = allsnap[:, 6 + SM:6 + 2 * SM]
            if self.opt and gbest < int(np.asarray(
                    jax.device_get(st.ext_bound))[0]):
                eb = jnp.full((self.S * D,), gbest, dtype=jnp.int32)
                st = st._replace(ext_bound=jax.device_put(eb, sharding))
            if (on_improve is not None and self.opt and gbest < INF
                    and gbest < last_improve_printed):
                last_improve_printed = gbest
                win = int(np.argmin(allsnap[:, 0]))
                store = allsnap[win, 6 + 2 * SM:].astype(np.int32)
                on_improve(self.plan.store_to_tnf(store))
            moves = plan_host_steal(next_mat, limit_mat, idle)
            my_moves = [m for m in moves
                        if m[0] == self.pid or m[1] == self.pid]
            if my_moves:
                st_np = jax.device_get(st)
                for thief, d_host, d_shard, mid, hi in my_moves:
                    if d_host == self.pid:
                        sl = slice(d_shard * D, (d_shard + 1) * D)
                        new_lim = st_np.sub_limit.copy()
                        new_lim[sl] = np.minimum(new_lim[sl], mid)
                        st_np = st_np._replace(sub_limit=new_lim)
                    if thief == self.pid:
                        st_np = reseed_ranges(st_np, D, self.S,
                                              self.plan.lb0,
                                              self.plan.ub0, mid, hi)
                        redistributions += 1
                st = jax.tree.map(
                    lambda x: jax.device_put(x, sharding), st_np)
            if my_ckpt and allsnap[:, 5].any():
                # Host 0 armed the save flag: every host snapshots its
                # local state at this same (collectively agreed) tick.
                from ..solver.checkpoint import save_state
                save_state(sh.solver, st, my_ckpt, num_shards=self.S)
                last_ckpt = time.monotonic()
            if allsnap[:, 2].any():          # some host hit the timeout
                stopped = True
                break
            if node_limit and total_nodes >= node_limit:
                # Global -cutnodes budget, same allgathered total on
                # every host -> same break tick.
                stopped = True
                break
            if (not self.opt and stop_after_n_solutions > 0
                    and total_sols >= stop_after_n_solutions):
                # Satisfaction: enough solutions found across hosts
                # (-n semantics); stop everywhere (exhaustive only if
                # all ranges drained).
                stopped = not bool(idle.all())
                break
            if idle.all() and not moves:
                break
            if verbose and self.pid == 0:
                print(f"% host0: chunks={chunks} best={int(bbs.min())}")
        if my_ckpt and stopped:
            from ..solver.checkpoint import save_state
            save_state(sh.solver, st, my_ckpt, num_shards=self.S)
        res = EngineResult.from_state(sh, st, stopped,
                                       time.monotonic() - t0)
        res.warmup_time = warmup_time
        res.compile_time = sh.step_compile_time
        res.eps_redistributions = redistributions
        # Global reduction: every host reports the global objective,
        # global exhaustiveness, its countable statistics, and its best
        # store — so every host returns the SAME result (objective,
        # stats, and the winning solution store; the reference prints
        # one global stat block, statistics.hpp:338-371, and host 0
        # must not print a stale local store as the final solution).
        has_sol = res.status in ("sat", "optimal")
        V = len(res.best_lb) if res.best_lb is not None else \
            len(self.plan.store_to_tnf(np.asarray(self.plan.lb0),
                                       np.asarray(self.plan.ub0))[0])
        zeros = np.zeros(V, dtype=np.int64)
        blb = (res.best_lb.astype(np.int64) if res.best_lb is not None
               else zeros)
        bub = (res.best_ub.astype(np.int64) if res.best_ub is not None
               else zeros)
        # Hosts without an incumbent contribute a losing sentinel in
        # the reduction direction (min for minimize, max for maximize).
        sent = -INF if self.is_max else INF
        fin = self._allgather(np.concatenate([np.array(
            [res.objective if res.objective is not None else sent,
             int(res.exhaustive), int(has_sol),
             res.nodes, res.fails, res.solutions,
             res.fixpoint_iterations, int(res.num_deductions),
             res.depth_max, res.eps_solved_subproblems,
             res.eps_skipped_subproblems, redistributions],
            dtype=np.int64), blb, bub]))
        gobj = int(fin[:, 0].max() if self.is_max else fin[:, 0].min())
        res.exhaustive = bool(fin[:, 1].all())
        any_sol = bool(fin[:, 2].any())
        res.host_nodes = [int(x) for x in fin[:, 3]]
        res.nodes = int(fin[:, 3].sum())
        res.fails = int(fin[:, 4].sum())
        res.solutions = int(fin[:, 5].sum())
        res.fixpoint_iterations = int(fin[:, 6].sum())
        res.num_deductions = float(fin[:, 7].sum())
        res.depth_max = int(fin[:, 8].max())
        res.eps_solved_subproblems = int(fin[:, 9].sum())
        res.eps_skipped_subproblems = int(fin[:, 10].sum())
        res.eps_redistributions = int(fin[:, 11].sum())
        if any_sol:
            # Winning store: best objective, lowest pid on ties (for
            # satisfaction all objectives are INF, so pid 0's first).
            key = -fin[:, 0] if self.is_max else fin[:, 0]
            win = int(np.lexsort((np.arange(fin.shape[0]),
                                  key))[0]) if self.opt else \
                int(np.nonzero(fin[:, 2])[0][0])
            res.best_lb = fin[win, 12:12 + V].astype(np.int32)
            res.best_ub = fin[win, 12 + V:12 + 2 * V].astype(np.int32)
        if self.opt and gobj != sent:
            res.objective = gobj
            res.status = "optimal" if res.exhaustive else "sat"
        elif not self.opt:
            if any_sol:
                res.status = "sat" if res.status != "optimal" else res.status
            else:
                res.status = "unsat" if res.exhaustive else "unknown"
        return res
