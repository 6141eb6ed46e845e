"""Multi-chip EPS: shard the dive batch over a device mesh.

The reference is single-GPU (SURVEY.md §2c: no MPI/NCCL anywhere); its
intra-GPU sharing primitives map onto a mesh of devices as:

  grid-atomic incumbent bound  ->  `lax.pmin` over the mesh every step
                                   (an all-reduce; barebones:996-997)
  `next_subproblem` atomic counter -> static per-shard subproblem
                                   ranges + per-shard on-device counters
                                   (lazy EPS generation per shard)
  final `reduce_blocks`        ->  host-side reduction over all shards'
                                   states (EngineResult already meets
                                   per-lane stats; shards concatenate).

Each device runs `num_dives` lanes of the batched engine; the only
cross-device traffic is the one-scalar pmin per step.
"""
from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..compile.tnf import Tnf
from ..solver.engine import IDLE, BatchedSolver, EngineConfig, SearchState
from ..solver.result import EngineResult


def rebalance_ranges(st, D: int, n_shards: int, lb0: np.ndarray,
                     ub0: np.ndarray, use_table: bool = False):
    """Host-side EPS work redistribution across shards (pure numpy).

    The reference's single GPU shares one grid-atomic `next_subproblem`
    counter (barebones:877-884); across devices we use static
    per-shard ranges instead (no cross-device atomics), which can leave
    a shard idle while others still hold work. This is the host-side
    subproblem re-exchange from SURVEY.md §2c's mapping: when a
    shard is dry (all lanes IDLE, range exhausted), it steals the upper
    half of the richest shard's remaining range and reseeds its lanes
    from the root store. Only state *values* change (never shapes), so
    no recompilation is ever triggered.

    `st` is a device_get'd SearchState (numpy leaves, global layout:
    shard s owns rows [s*D, (s+1)*D)). Returns (new_state, moves).
    """
    phase = st.phase.copy()
    subp = st.subp.copy()
    next_sub = st.next_sub.copy()
    sub_limit = st.sub_limit.copy()
    depth = st.depth.copy()
    strat = st.strat.copy()
    snap_strat = st.snap_strat.copy()
    remaining = st.remaining.copy()
    lb = st.lb.copy()
    ub = st.ub.copy()
    root_lb = st.root_lb.copy()
    root_ub = st.root_ub.copy()
    tab_lb = st.tab_lb.copy()
    tab_ub = st.tab_ub.copy()
    tab_strat = st.tab_strat.copy()
    tab_path = st.tab_path.copy()
    n_pad = tab_lb.shape[0] // n_shards

    def shard_next(s):
        return int(next_sub[s * D])

    def shard_limit(s):
        return int(sub_limit[s * D])

    moves = 0
    for s in range(n_shards):
        sl = slice(s * D, (s + 1) * D)
        if not (phase[sl] == IDLE).all():
            continue
        if shard_limit(s) - shard_next(s) > 0:
            continue  # not dry (can't normally happen)
        # Donor: the shard with the largest remaining unexplored range.
        rems = [(shard_limit(d) - shard_next(d), d) for d in range(n_shards)
                if d != s]
        rem, donor = max(rems, default=(0, -1))
        give = rem // 2
        if give < 1:
            continue
        dsl = slice(donor * D, (donor + 1) * D)
        limit_d = shard_limit(donor)
        mid = limit_d - give
        sub_limit[dsl] = mid          # donor keeps [next_d, mid)
        if use_table:
            # Table mode: counters index live table rows, so the
            # receiver also copies the donor's table and seeds its
            # lanes straight into SOLVE from rows [mid, limit_d) —
            # same dataflow as a device-side table refill.
            tsl = slice(s * n_pad, (s + 1) * n_pad)
            dtl = slice(donor * n_pad, (donor + 1) * n_pad)
            tab_lb[tsl] = tab_lb[dtl]
            tab_ub[tsl] = tab_ub[dtl]
            tab_strat[tsl] = tab_strat[dtl]
            tab_path[tsl] = tab_path[dtl]
            rows = mid + np.arange(D, dtype=np.int64)
            live = rows < limit_d
            ridx = np.clip(rows, 0, n_pad - 1)
            subp[sl] = tab_path[dtl][ridx]
            phase[sl] = np.where(live, 1, IDLE)  # SOLVE=1
            lb[sl] = tab_lb[dtl][ridx]
            ub[sl] = tab_ub[dtl][ridx]
            root_lb[sl] = tab_lb[dtl][ridx]
            root_ub[sl] = tab_ub[dtl][ridx]
            strat[sl] = tab_strat[dtl][ridx]
            snap_strat[sl] = tab_strat[dtl][ridx]
            remaining[sl] = 0
        else:
            # Receiver lanes take [mid, limit_d) exactly like init_state.
            lane_sub = mid + np.arange(D, dtype=np.int32)
            subp[sl] = lane_sub
            phase[sl] = np.where(lane_sub < limit_d, 0, IDLE)  # DIVE=0
            lb[sl] = lb0[None, :]
            ub[sl] = ub0[None, :]
            root_lb[sl] = lb0[None, :]
            root_ub[sl] = ub0[None, :]
            strat[sl] = 0
            snap_strat[sl] = 0
            remaining[sl] = st.kpow[sl]
        next_sub[sl] = min(mid + D, limit_d)
        sub_limit[sl] = limit_d
        depth[sl] = 0
        moves += 1
    if not moves:
        return st, 0
    return st._replace(
        phase=phase, subp=subp, next_sub=next_sub, sub_limit=sub_limit,
        depth=depth, strat=strat, snap_strat=snap_strat,
        remaining=remaining, lb=lb, ub=ub, root_lb=root_lb,
        root_ub=root_ub, tab_lb=tab_lb, tab_ub=tab_ub,
        tab_strat=tab_strat, tab_path=tab_path), moves


class ShardedSolver:
    """BatchedSolver spread over a 1-D 'dives' mesh of devices."""

    def __init__(self, tnf: Tnf, config: EngineConfig = EngineConfig(),
                 devices=None, shard_offset: int = 0,
                 total_shards: Optional[int] = None):
        """`devices` default to all visible devices. In a multi-host run
        (parallel/multihost.py) each process builds a ShardedSolver over
        its *local* devices with `shard_offset`/`total_shards` set so the
        global subproblem space is partitioned across all hosts' shards;
        single-process callers leave both at their defaults."""
        self.devices = list(devices if devices is not None else jax.devices())
        self.n_shards = len(self.devices)
        self.shard_offset = shard_offset
        self.total_shards = (total_shards if total_shards is not None
                             else self.n_shards)
        self.mesh = Mesh(np.array(self.devices), ("dives",))
        self.solver = BatchedSolver(tnf, config, axis_name="dives",
                                    num_shards=self.total_shards)
        self.plan = self.solver.plan
        self.opt = self.solver.opt
        self.num_sub_total = self.solver.num_sub_total
        self._step_n_cache = {}

    # -- global state --------------------------------------------------

    def init_state(self) -> SearchState:
        """Global state: shard i's lanes hold subproblem range i."""
        while True:
            use_table0 = self.solver.use_table
            shards = [self.solver.init_state(shard_idx=self.shard_offset + i)
                      for i in range(self.n_shards)]
            if self.solver.use_table == use_table0:
                break
            # A shard's table build hit its deadline mid-loop and the
            # solver fell back to dive mode; already-built shard states
            # have table-shaped leaves — rebuild them all in dive mode
            # so the concatenated global state is consistent.
        glob = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *shards)
        sharding = NamedSharding(self.mesh, P("dives"))
        return jax.tree.map(lambda x: jax.device_put(x, sharding), glob)

    def make_step_n(self, n: int):
        if n not in self._step_n_cache:
            local_step = self.solver.step

            @functools.partial(
                jax.shard_map, mesh=self.mesh,
                in_specs=P("dives"), out_specs=P("dives"))
            def sharded_steps(st):
                # Mark every carry leaf as device-varying up front; the
                # incumbent pmin makes some outputs varying, and the
                # while/fori carry types must match.
                def to_varying(x):
                    if "dives" in getattr(jax.typeof(x), "vma", ()):
                        return x
                    return jax.lax.pvary(x, ("dives",))
                st = jax.tree.map(to_varying, st)
                return jax.lax.fori_loop(0, n, lambda i, s: local_step(s), st)

            lowered = jax.jit(sharded_steps, donate_argnums=0).lower(
                self.init_state())
            c0 = self.solver.compile_s
            self._step_n_cache[n] = self.solver.compile(lowered)
            self.step_compile_time = self.solver.compile_s - c0
        return self._step_n_cache[n]

    def solve(self, timeout_s: float = 1e18, chunk: int = 16,
              stop_after_n_solutions: int = 1, max_steps: int = 1 << 60,
              node_limit: int = 0, verbose: bool = False,
              on_improve=None, on_solution=None, checkpoint_path: str = "",
              checkpoint_every_s: float = 60.0,
              fp_cap: int = 0) -> EngineResult:
        """Mesh host loop. `on_solution` drains the PER-SHARD on-device
        solution rings every chunk (shard-major, device order within a
        shard) — the multi-arch analog of engine.solve's gpu-streaming
        parity."""
        from ..solver.timers import PhaseTimers
        import os as _os
        t0 = time.monotonic()
        t_entry = time.monotonic()
        # Hard wall backstop on the solver's compile-free clock (see
        # engine.solve).
        hard_mult = float(_os.environ.get("TURBO_TPU_HARD_WALL_MULT", "2"))
        c_entry = self.solver.clock()
        if self.plan.root_unsat:
            return EngineResult.unsat(self)
        timers = PhaseTimers(
            num_lanes=self.solver.cfg.num_dives * self.n_shards)
        tt = time.monotonic()
        if (self.solver.use_table and not self.solver._tables
                and timeout_s < 1e17):
            # Budget the per-shard table builds inside -t (shared
            # deadline across shards; engine falls back to dive mode
            # for ALL shards on overrun — see init_state above). A
            # caller-provided tighter deadline stays binding.
            dl = self.solver.clock() + max(2.0, 0.5 * timeout_s)
            prev = getattr(self.solver, "_table_deadline", None)
            self.solver._table_deadline = (dl if prev is None
                                           else min(prev, dl))
        st = self.init_state()
        self.solver._table_deadline = None  # consumed; see engine.solve
        # Shared auto-cap calibration (engine.AutoCapCalibrator). The
        # mesh step program has a BAKED trip count (one executable per
        # chunk size), so the chunk-resize hint is ignored — the
        # ascending ladder's early stop keeps expensive high-cap
        # samples rare.
        from ..solver.engine import AutoCapCalibrator
        if fp_cap > 0:
            # Per-run override of the traced cap plane (no recompile).
            st = AutoCapCalibrator._set_cap(st, fp_cap)
        cal = AutoCapCalibrator(self.solver.cfg, fp_cap)
        st = cal.arm(st)
        jax.block_until_ready(st.lb)
        timers.transfer_c2g = time.monotonic() - tt
        # Table-build wall time (incl. an aborted build's waste) counts
        # against the solve budget, exactly as in engine.solve.
        dive_dur = sum(t.build_time
                       for t in getattr(self.solver, "_tables", {}).values())
        dive_dur += getattr(self.solver, "_table_aborted_s", 0.0)
        if checkpoint_path:
            from ..solver.checkpoint import load_state
            restored = load_state(
                self.solver, checkpoint_path, num_shards=self.n_shards,
                device_put=lambda x: jax.device_put(
                    x, NamedSharding(self.mesh, P("dives"))))
            if restored is not None:
                st, _ = restored
        last_ckpt = time.monotonic()
        ring = self.solver.cfg.sol_ring_size
        if ring > 0 and self.solver.cfg.enumerate_all:
            # Enumeration must not lose solutions between drains: cap
            # the chunk so at most `ring` can land per shard per chunk
            # (same rule as engine.solve).
            chunk = max(1, min(chunk,
                               ring // max(self.solver.cfg.num_dives, 1)))
        ring_drained = [0] * self.n_shards
        printed_total = 0
        step_n = self.make_step_n(chunk)
        steps = 0
        stopped = False
        first_call = True
        best_seen = None
        best_obj_time = 0.0
        redistributions = 0
        D = self.solver.cfg.num_dives
        sharding = NamedSharding(self.mesh, P("dives"))
        while True:
            td = time.monotonic()
            st = step_n(st)
            jax.block_until_ready(st.phase)
            device_dur = time.monotonic() - td
            steps += chunk
            warmup = first_call
            if first_call:
                # Exclude one-time XLA compile/load from the solve budget
                # (the reference's initTime/solveTime split); the table
                # build stays inside it.
                first_call = False
                t0 = time.monotonic() - dive_dur
                warmup_time = t0 - t_entry
            tg = time.monotonic()
            # One transfer per chunk: fetch all host-loop inputs at once
            # (block_until_ready above waited for the chunk, so the
            # fetch is pure device-to-host transfer).
            phase, sols, fpit, bbs, nodes_v = jax.device_get(
                (st.phase, st.sols, st.fpit, st.best_bound, st.nodes))
            timers.transfer_g2c += time.monotonic() - tg
            timers.record_chunk(device_dur, int(fpit.sum()), phase, chunk,
                                time.monotonic() - t0, measured=not warmup)
            if not cal.done:
                st, _ = cal.observe(st, int(nodes_v.sum()), device_dur,
                                    warmup, verbose=verbose)
            if ring > 0 and on_solution is not None:
                sw = np.asarray(jax.device_get(st.sol_w))
                if any(int(sw[s * D]) > ring_drained[s]
                       for s in range(self.n_shards)):
                    rows = np.asarray(jax.device_get(st.sol_ring))
                    for s in range(self.n_shards):
                        cur = int(sw[s * D])
                        if not self.opt and stop_after_n_solutions > 0:
                            # Global -n budget across shards.
                            left = stop_after_n_solutions - printed_total
                            cur = min(cur, ring_drained[s] + max(left, 0))
                        if cur - ring_drained[s] > ring:
                            print(f"% warning: shard {s} solution ring "
                                  f"overflow; {cur - ring_drained[s] - ring}"
                                  f" solutions not streamed", flush=True)
                            ring_drained[s] = cur - ring
                        seg = rows[s * ring:(s + 1) * ring]
                        for si in range(ring_drained[s], cur):
                            on_solution(self.plan.store_to_tnf(seg[si % ring]))
                            printed_total += 1
                        ring_drained[s] = cur
            bbm = int(bbs.min())
            if on_improve is not None:
                if not hasattr(self, "_last_best"):
                    self._last_best = 1 << 40
                if bbm < self._last_best:
                    self._last_best = bbm
                    blb = jax.device_get(st.best_lb)
                    d = int(np.argmin(bbs))
                    on_improve(self.plan.store_to_tnf(blb[d]))
            if bbm < (best_seen if best_seen is not None else 1 << 40):
                best_seen = bbm
                best_obj_time = time.monotonic() - t0
            # Host-side EPS re-exchange: revive dry shards from the
            # richest shard's remaining range (SURVEY.md §2c refill).
            if self.n_shards > 1:
                dry = [bool((phase[s * D:(s + 1) * D] == IDLE).all())
                       for s in range(self.n_shards)]
                if any(dry) and not all(dry):
                    ns, slim = jax.device_get((st.next_sub, st.sub_limit))
                    if any(int(slim[s * D]) - int(ns[s * D]) > 1
                           for s in range(self.n_shards)):
                        st_np = jax.device_get(st)
                        st_np, moves = rebalance_ranges(
                            st_np, D, self.n_shards,
                            self.plan.lb0, self.plan.ub0,
                            use_table=self.solver.use_table)
                        if moves:
                            redistributions += moves
                            st = jax.tree.map(
                                lambda x: jax.device_put(x, sharding), st_np)
                            phase = st_np.phase
            if (phase == IDLE).all():
                break
            if not self.opt and sols.sum() >= stop_after_n_solutions > 0:
                stopped = True
                break
            if time.monotonic() - t0 > timeout_s or steps >= max_steps:
                stopped = True
                break
            if (timeout_s < 1e17 and hard_mult > 0
                    and self.solver.clock() - c_entry
                    > hard_mult * timeout_s):
                import sys as _sys
                print("% hard wall-clock limit reached "
                      f"({hard_mult:g}x timeout, compile excluded); "
                      "stopping", file=_sys.stderr, flush=True)
                stopped = True
                break
            if node_limit and int(jax.device_get(st.nodes.sum())) >= node_limit:
                stopped = True
                break
            if checkpoint_path and \
                    time.monotonic() - last_ckpt > checkpoint_every_s:
                from ..solver.checkpoint import save_state
                save_state(self.solver, st, checkpoint_path,
                           num_shards=self.n_shards)
                last_ckpt = time.monotonic()
        if checkpoint_path and stopped:
            from ..solver.checkpoint import save_state
            save_state(self.solver, st, checkpoint_path,
                       num_shards=self.n_shards)
        # EngineResult reduction works on the concatenated global state.
        res = EngineResult.from_state(self, st, stopped,
                                       time.monotonic() - t0)
        res.best_obj_time = best_obj_time
        res.warmup_time = warmup_time
        res.compile_time = self.step_compile_time
        res.eps_redistributions = redistributions
        timers.fill_result(res, res.solve_time)
        res.dive_time += dive_dur
        res.table_build_time = dive_dur
        return res

    # Attributes EngineResult reads.
    @property
    def tnf(self):
        return self.solver.tnf
