"""Batched EPS dive-and-solve engine (the default device architecture).

A JAX re-expression of the reference's barebones GPU architecture
(barebones_dive_and_solve.hpp): where the GPU runs one MIMD thread
block per EPS worker, this engine runs a *batch of D dives in lockstep*
as one jitted step function:

  - bit-path diving to the assigned subproblem with subtree skipping
    (barebones:674-741),
  - branch-and-bound solve with decision stacks + ropes fast
    backtracking (barebones:386-404, 812-864),
  - per-step incumbent sharing: min over the dive batch, and
    `lax.pmin` across a device mesh when sharded (in place of the
    grid-scope atomic `appx_best_bound`, barebones:996-997),
  - lazy subproblem generation from a monotone counter
    (`next_subproblem`, barebones:877-884) kept inside the jitted
    state so refills happen on-device.

All search state lives in device-resident int32 arrays; one `step` call
advances every dive by one search node.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.ops import INF, NINF
from ..compile.tnf import Tnf
from .plan import Plan, build_plan
from .propagate_jax import PropagatorKernels

I32 = jnp.int32
DIVE, SOLVE, IDLE = 0, 1, 2

from .strategy import VO_CODE as _VO_CODE, VALO_CODE as _VALO_CODE
from . import strategy as _strategy


class SearchState(NamedTuple):
    lb: jnp.ndarray          # (D, V) current store
    ub: jnp.ndarray
    root_lb: jnp.ndarray     # (D, V) subproblem root snapshot
    root_ub: jnp.ndarray
    best_lb: jnp.ndarray     # (D, V) per-dive best solution store
    best_ub: jnp.ndarray
    best_bound: jnp.ndarray  # (D,) per-dive bound (INF = none); minimization
    has_best: jnp.ndarray    # (D,) bool
    dec_var: jnp.ndarray     # (D, MAXD)
    dec_l0: jnp.ndarray      # (D, MAXD) left child interval
    dec_u0: jnp.ndarray
    dec_l1: jnp.ndarray      # (D, MAXD) right child interval
    dec_u1: jnp.ndarray
    dec_rope1: jnp.ndarray   # (D, MAXD) rope of the right child
    dec_cur: jnp.ndarray     # (D, MAXD) current child index (0/1)
    depth: jnp.ndarray       # (D,)
    phase: jnp.ndarray       # (D,) DIVE/SOLVE/IDLE
    remaining: jnp.ndarray   # (D,) remaining dive depth
    subp: jnp.ndarray        # (D,) current subproblem index
    strat: jnp.ndarray       # (D,) current strategy cursor
    snap_strat: jnp.ndarray  # (D,)
    next_sub: jnp.ndarray    # (D,) next subproblem counter (replicated in-shard)
    nonexh: jnp.ndarray      # (D,) search not exhaustive
    nodes: jnp.ndarray       # (D,)
    fails: jnp.ndarray
    sols: jnp.ndarray
    fpit: jnp.ndarray
    deds: jnp.ndarray        # (D,) float32
    dmax: jnp.ndarray
    solved_sub: jnp.ndarray
    skipped_sub: jnp.ndarray
    # Instance scalars kept as traced per-lane vectors (D,) so the
    # compiled program depends only on the plan's shape signature
    # (cross-instance reuse) and shard_map shards them with the lanes.
    obj: jnp.ndarray       # (D,) permuted objective var id (replicated)
    is_opt: jnp.ndarray    # (D,) bool (replicated)
    kpow: jnp.ndarray      # (D,) subproblems power (replicated)
    sub_limit: jnp.ndarray # (D,) this shard's subproblem range end
    pscale: jnp.ndarray    # (D,) float32: live propagators per sweep
    eps_strat: jnp.ndarray # (D,) 1 if an EPS dive strategy is prepended
    # External incumbent bound injected by a *remote host*
    # (multi-host EPS, parallel/multihost.py); INF when single-host.
    # The local pmin cannot see other processes' meshes, so the host
    # loop meets the allgathered global bound into this field.
    ext_bound: jnp.ndarray # (D,) int32 (replicated)
    # Per-step fixpoint sweep cap, TRACED so cap tuning (and host-side
    # adaptation) costs no recompile. The while trip count per step is
    # the max over lanes, so this cap IS the per-step sweep count on
    # unconverged workloads — the main per-node latency knob.
    fp_cap: jnp.ndarray    # (D,) int32 (replicated)
    # EPS subproblem-root table (solver/eps_table.py), device-resident
    # and carried (donated) through every step: refills gather a leaf
    # row and drop the lane straight into SOLVE phase. In non-table
    # mode these are (1, V)/(1,) placeholders. Under shard_map the
    # row axis shards with the lanes (each shard owns its own table).
    tab_lb: jnp.ndarray    # (n_pad, V) int32
    tab_ub: jnp.ndarray    # (n_pad, V) int32
    tab_strat: jnp.ndarray  # (n_pad,) int32 post-dive strategy cursor
    tab_path: jnp.ndarray   # (n_pad,) int32 subproblem bit-path
    # On-device solution ring (per-solution streaming for -a / -i on
    # the batched arch; the reference's gpu arch streams each solution
    # through a producer/consumer handshake, gpu_dive_and_solve.hpp:
    # 100-132). Accepted solution stores (lb plane) append here; the
    # host drains new rows each chunk. (1, V) placeholder when off.
    sol_ring: jnp.ndarray  # (R, V) int32
    sol_w: jnp.ndarray     # (D,) int32 total accepted count (replicated)


@dataclasses.dataclass
class EngineConfig:
    num_dives: int = 64          # D: lanes per device (GPU: number of blocks)
    subproblems_power: int = 0   # k: 2^k subproblems; 0 -> auto from factor
    subproblems_factor: int = 300  # reference default (config.hpp:76)
    # Decision stack depth (MAXD); 0 = auto-size from the instance so
    # overflow can never cost exhaustiveness (the reference provisions
    # MAX_SEARCH_DEPTH=10000 entries, barebones_dive_and_solve.hpp:14).
    max_depth: int = 0
    fp_max_iters: int = 10000
    # "fixpoint": AC-1 until no change (reference semantics).
    # "fixed": exactly fp_fixed_iters sweeps per step - cheaper per node
    # (no convergence loop, pure lockstep), sound because entailment and
    # failure detection stay exact; un-decided nodes simply propagate
    # further on the next step before branching.
    # "wac1": per-op-group local fixpoints, Gauss-Seidel over groups
    # (warp-fixpoint analog, config.cpp:25-27); falls back to AC-1 when
    # the instance has fewer than wac1_threshold propagators.
    fp_mode: str = "fixpoint"
    # Plane layout inside the fixpoint: "dv" = (D, V) as carried by the
    # search state; "vd" = transpose to dive-minor (V, D) for the sweep
    # (matches the layout XLA's assignment prefers for the candidate
    # gathers - see PropagatorKernels.iteration_t). Both layouts give
    # identical stores; which one is faster on a given device is an
    # open measurement.
    fp_layout: str = "vd"
    fp_fixed_iters: int = 2
    # Sweeps unrolled inside each fixpoint while-iteration. Unrolling
    # multiplies the compile time, and the while trip count is set by
    # the slowest lane (~the cap) either way, so the default is 1.
    fp_unroll: int = 1
    # Hot prefix of the decision stacks: backtrack replays deeper than
    # this take a rarely-executed slow branch (see step VII).
    hot_depth: int = 256
    wac1_threshold: int = 0
    wac1_inner_cap: int = 16
    # Distinct strategy for the diving phase (push_eps_strategy,
    # common_solving.hpp:652-667); "default" = none.
    eps_var_order: str = "default"
    eps_value_order: str = "default"
    seed: int = 1
    # All-solutions mode (-a / -n>1 on satisfaction problems): count
    # only all-singleton stores, splitting entailed boxes further.
    enumerate_all: bool = False
    # -disable_simplify (config.cpp:41): skip the plan's simplification
    # passes (entailed-prop drop, rhs folding, store compaction); the
    # root fixpoint still runs (preprocess_tcn, common_solving.hpp:530).
    disable_simplify: bool = False
    # Root bound shaving (plan.shave_root, beyond the reference):
    # probe-and-refute presolve on the root bounds. Opt-in (-shave):
    # it did not shrink the proof trees it was tried on, so the host
    # presolve cost bought nothing there — see DESIGN.md.
    shave: bool = False
    # Solution ring size R (0 = off): device buffer for per-solution
    # streaming (-a / -i). The host drains new rows each chunk; in
    # enumerate mode the driver caps the chunk at R // num_dives steps
    # so the ring can never overflow between drains.
    sol_ring_size: int = 0
    # Auto fixpoint cap: when solve() gets no explicit fp_cap, sweep
    # the traced cap plane live over a candidate ladder (one short
    # chunk each, after the compile chunk) and lock in the nodes/s
    # argmax. Sound at every cap thanks to the hold rule (the search
    # tree is the exact AC-1 fixpoint tree regardless), so calibration
    # chunks are real solve progress — the only cost is running a few
    # chunks at non-optimal caps. The cap sets the per-step sweep count
    # and its optimum is instance-dependent (sweep depth vs per-step
    # fixed overhead), so no static default suits every instance.
    fp_cap_auto: bool = True
    # Precomputed EPS subproblem-root table (solver/eps_table.py):
    # expand the dive tree once (shared prefixes, full occupancy) and
    # seed refills straight into SOLVE phase — eliminates the lockstep
    # dive-replay tax (DESIGN.md "The EPS subproblem-root table").
    # Auto-disabled for enumerate_all, fp_mode="fixed" (builder needs
    # true fixpoints), oversized tables, and multi-host runs (stolen
    # ranges cross table boundaries; those lanes re-dive instead).
    use_table: bool = True


class AutoCapCalibrator:
    """Live fixpoint-cap calibration over the traced cap plane.

    The per-step sweep cap sets the node rate on proof workloads with
    an instance-dependent optimum, and the hold rule makes the search
    tree the exact AC-1 fixpoint tree at ANY cap — so the cap is a pure
    throughput knob that can be swept LIVE: one short chunk per
    candidate, every calibration chunk is real solve progress, zero
    recompiles (the cap is traced state). Ascending ladder with early
    stop: a step at cap c costs up to c sweeps, so cheap candidates run
    first and expensive ones are only sampled while the curve still
    rises. Shared by the single-device and mesh host loops."""

    def __init__(self, cfg, fp_cap_override: int):
        self.rates = {}
        self.active = None
        self.nodes0 = 0
        self.chosen = None
        # Per-candidate sample accumulation (one short chunk is too
        # noisy a sample to lock the knob on): keep sampling the active
        # candidate until it has >= min_sample_s of device time or
        # max_sample_chunks chunks, whichever first.
        self.min_sample_s = float(os.environ.get(
            "TURBO_TPU_CAL_SAMPLE_S", "0.4"))
        self.max_sample_chunks = 4
        self.acc_dur = 0.0
        self.acc_chunks = 0
        if (fp_cap_override == 0 and cfg.fp_cap_auto
                and cfg.fp_mode != "fixed"):
            self.caps = [c for c in (2, 3, 4, 8, 16)
                         if c <= cfg.fp_max_iters]
        else:
            self.caps = []
        if self.caps:
            self.active = self.caps[0]

    @property
    def done(self) -> bool:
        return not self.caps

    @staticmethod
    def _set_cap(st, v: int):
        # Preserve the plane's sharding (the mesh state shards it over
        # the dives axis; full_like alone lands on the default device).
        new = jnp.full_like(st.fp_cap, jnp.int32(v))
        sh = getattr(st.fp_cap, "sharding", None)
        if sh is not None:
            try:
                new = jax.device_put(new, sh)
            except Exception:
                pass
        return st._replace(fp_cap=new)

    def arm(self, st):
        """Set the first candidate before the compile chunk (the run
        then never pays the uncapped default)."""
        if self.caps:
            return self._set_cap(st, self.active)
        return st

    def observe(self, st, tot_nodes: int, device_dur: float,
                warmup: bool, verbose: bool = False):
        """Feed one chunk's observation. Returns (st', chunk_hint):
        chunk_hint is the suggested trip count for the NEXT chunk
        (None = caller's own choice)."""
        if not self.caps:
            return st, None
        if warmup:
            # No rate sample (the compile chunk): just rebase the
            # counter.
            self.nodes0 = tot_nodes
            self.acc_dur = 0.0
            self.acc_chunks = 0
            return st, max(2, 32 // self.active)
        # Accumulate until the active candidate has a robust sample.
        self.acc_dur += device_dur
        self.acc_chunks += 1
        if (self.acc_dur < self.min_sample_s
                and self.acc_chunks < self.max_sample_chunks):
            return st, max(2, 32 // self.active)
        if self.active is not None:
            self.rates[self.active] = (
                (tot_nodes - self.nodes0) / max(self.acc_dur, 1e-6))
        best_rate = max(self.rates.values(), default=0.0)
        nxt = next((c for c in self.caps if c not in self.rates), None)
        declined = (self.active is not None and len(self.rates) >= 2
                    and self.rates[self.active] < 0.7 * best_rate)
        if nxt is not None and not declined:
            self.active = nxt
            self.nodes0 = tot_nodes
            self.acc_dur = 0.0
            self.acc_chunks = 0
            # Equal-ish wall time per sample: scale trips inversely
            # with the cap (a step costs up to `cap` sweeps).
            return self._set_cap(st, nxt), max(2, 32 // nxt)
        best_cap, best_rate = max(self.rates.items(),
                                  key=lambda kv: (kv[1], kv[0]))
        st = self._set_cap(st, best_cap)
        self.chosen = best_cap
        self.caps = []
        self.active = None
        if verbose:
            print(f"% auto fp_cap={best_cap} ({best_rate:,.0f} nodes/s;"
                  " swept "
                  + " ".join(f"{c}:{self.rates[c]:,.0f}"
                             for c in sorted(self.rates)) + ")",
                  flush=True)
        return st, None


def probe_tree_power(tnf, probe_nodes: int = 2000,
                     probe_timeout_s: float = 0.5):
    """Root-tree size probe for EPS auto-splitting: run the sequential
    oracle briefly; if it exhausts the whole tree in N nodes, the proof
    tree is tiny and the factor-based 2^k split (config.hpp:76) would
    bury it under redundant dive prefixes. Returns ceil(log2(N))+1, or
    None when the tree is bigger than the probe budget (use the factor
    split). Probe cost is bounded by probe_nodes/probe_timeout_s and is
    negligible against any solve that needs the device."""
    from . import oracle
    try:
        r = oracle.solve(tnf, timeout_s=probe_timeout_s,
                         node_limit=probe_nodes)
    except Exception:
        return None
    if not r.stats.exhaustive:
        return None
    return max(1, int(np.ceil(np.log2(max(2, r.stats.nodes)))) + 1)


def auto_max_depth(plan) -> int:
    """Decision-stack depth that provably covers the instance.

    Per-var worst-case decisions depend on the value order actually in
    play: indomain_split/_reverse_split halve the interval (<=
    ceil(log2(w)) decisions), but indomain_min/_max right children only
    shrink it by ONE value, so a var of width w can sit on a branch up
    to w-1 times before it is fixed. With any min/max strategy present
    the bound is sum(min(w-1, ...)) — typically saturating the
    reference's flat MAX_SEARCH_DEPTH=10000 provision
    (barebones_dive_and_solve.hpp:14), which we then match. Overflow
    past the cap still degrades soundly to a non-exhaustive answer,
    but an exhaustiveness proof must never be lost to an optimistic
    depth estimate."""
    from .plan import quantize
    lb0 = plan.lb0[:plan.n_active].astype(np.int64)
    ub0 = plan.ub0[:plan.n_active].astype(np.int64)
    w = ub0 - lb0 + 1
    # Along any search path a variable is always branched by the FIRST
    # strategy that contains it (once fixed it stays fixed, so later
    # strategies — including the auto-appended first_fail/indomain_min
    # fallback — never touch it). Charging every var the fallback's
    # w-1 worst case would saturate the 10000 cap for models whose own
    # annotations are all halving splits.
    cost = np.zeros(plan.n_active, dtype=np.int64)
    seen = np.zeros(plan.n_active, dtype=bool)
    for s in plan.strategies:
        if getattr(s, "is_eps", False):
            continue  # k <= 30 dive decisions, charged in the margin
        ids = np.asarray(s.ids, dtype=np.int64)
        ids = ids[ids < plan.n_active]
        ids = ids[~seen[ids]]
        if len(ids) == 0:
            continue
        ws = w[ids]
        if s.val_order in ("indomain_split", "indomain_reverse_split"):
            c = np.ceil(np.log2(np.clip(ws, 2, None))).astype(np.int64)
        else:
            c = np.minimum(ws - 1, 10000)
        cost[ids] = np.where(ws > 1, c, 0)
        seen[ids] = True
    bits = int(cost.sum())
    # +38 margin: up to 30 EPS bit-path decisions per subproblem plus
    # the historical +8 slack.
    return int(min(10000, max(128, quantize(bits + 38))))


def choose_subproblems_power(tnf, config, num_shards: int,
                             allow_probe: bool = True) -> int:
    """EPS split size 2^k: pinned -sub, or the occupancy-factor default
    (config.hpp:76) capped by the root-tree probe AND by a dive-work
    budget. Multi-host callers compute k on ONE host and broadcast it
    (MultiHostSolver), because the probe is wall-clock bounded and may
    differ between hosts under load — inconsistent k would break the
    shared subproblem-id space.

    The dive budget is the SIMD-specific correction to the reference's
    factor heuristic: every subproblem refill costs up to k lockstep
    propagate+branch steps before the solve phase starts, and a lane
    step costs the same whether 1 or 1024 lanes are live. With the raw
    factor formula (2^19 at D=1024) a proof tree of ~10^5 nodes pays
    ~10^7 dive visits, with nearly every lane stuck in DIVE phase.
    Capping per-lane dive work at TURBO_TPU_DIVE_BUDGET lockstep steps
    (default 1500, ~30-60 s of steps on mid-size instances) keeps the
    dive overhead proportionate; under-splitting only risks tail skew,
    which the shared refill counter and host-side stealing absorb."""
    D = config.num_dives
    k = config.subproblems_power
    if k <= 0:
        total = max(1, config.subproblems_factor * D * num_shards)
        k = max(1, int(np.ceil(np.log2(total))))
        budget = int(os.environ.get("TURBO_TPU_DIVE_BUDGET", "1500"))
        kb = 1
        while kb < 30 and ((1 << (kb + 1)) * (kb + 1)) // max(D * num_shards, 1) <= budget:
            kb += 1
        k = min(k, kb)
        # Refill cap: ~2^REFILL_BITS refills per lane. Every completed
        # subproblem costs a fresh k-step dive replay, and that replay
        # dominates small proofs: at k=16, 65536 subproblems x 16
        # lockstep steps ≈ 1M dive visits against a proof tree of
        # ~2*10^5 nodes. With 4 refills
        # per lane the guaranteed dive work is k*4*D visits total and
        # the EPS tail resplit (re-splitting stragglers 2^j-finer once
        # the range drains) replaces fine pre-splitting as the load
        # balancer. The reference has no such correction because its
        # MIMD blocks pay a dive only per block, not per SIMD step.
        refill_bits = int(os.environ.get("TURBO_TPU_REFILL_BITS", "2"))
        kr = int(np.ceil(np.log2(max(1, D * num_shards)))) + refill_bits
        k = min(k, max(kr, 1))
        if not config.enumerate_all and allow_probe:
            kp = probe_tree_power(tnf)
            if kp is not None:
                k = min(k, kp)
    # Every shard must own a non-empty subproblem range, or an
    # explicitly pinned tiny -sub could leave shards claiming
    # exhaustiveness over work they never received.
    k = max(k, int(np.ceil(np.log2(max(1, num_shards)))))
    return min(k, 30)


def apply_strategy_config(plan, cfg) -> bool:
    """Seed-shuffle 'random' strategies and prepend the EPS dive
    strategy (split->shuffle_random_strategies + push_eps_strategy,
    common_solving.hpp:631-667). Returns whether an EPS strategy was
    prepended. Shared by the batched and hybrid architectures."""
    import numpy as _np
    from .plan import PlanStrategy
    rng = _np.random.default_rng(cfg.seed)
    for st in plan.strategies:
        if st.var_order == "random":
            ids = st.ids.copy()
            rng.shuffle(ids)
            st.ids = ids
            st.var_order = "input_order"
    has_eps = cfg.eps_var_order != "default"
    if has_eps:
        base = plan.strategies[-1]  # default whole-store strategy
        eps = PlanStrategy(cfg.eps_var_order,
                           cfg.eps_value_order
                           if cfg.eps_value_order != "default"
                           else "indomain_min",
                           base.ids.copy())
        # The dive strategy only ever takes k (<=30) bit-path decisions
        # per subproblem; auto_max_depth must not charge it per-var
        # worst cases (it covers the whole store).
        eps.is_eps = True
        plan.strategies.insert(0, eps)
        # Re-pad the strategy list to a power of two.
        while len(plan.strategies) & (len(plan.strategies) - 1):
            plan.strategies.append(plan.strategies[-1])
    return has_eps


class BatchedSolver:
    def __init__(self, tnf: Tnf, config: EngineConfig = EngineConfig(),
                 axis_name: Optional[str] = None, num_shards: int = 1):
        self.tnf = tnf
        self.cfg = config
        self.axis_name = axis_name
        self.num_shards = num_shards
        self.compile_s = 0.0  # XLA compile seconds of this solver's programs
        self.plan = build_plan(tnf,
                               disable_simplify=config.disable_simplify,
                               shave=config.shave)
        self._apply_strategy_config()
        self.kernels = PropagatorKernels(self.plan)
        if (config.fp_mode == "wac1"
                and self.plan.num_real_props < config.wac1_threshold):
            # Reference semantics: WAC1 behaves as AC1 below the
            # threshold (config.cpp:27-28).
            self.cfg = config = dataclasses.replace(config,
                                                    fp_mode="fixpoint")
        if config.max_depth <= 0:
            self.cfg = config = dataclasses.replace(
                config, max_depth=auto_max_depth(self.plan))
        self.k = choose_subproblems_power(tnf, config, num_shards)
        self.num_sub_total = 1 << self.k
        self.opt = self.plan.is_opt
        self._strategy_tables = self._build_strategy_tables()
        # EPS subproblem-root table gate (see EngineConfig.use_table).
        self.use_table = (config.use_table
                          and not config.enumerate_all
                          and config.fp_mode in ("fixpoint", "wac1"))
        if self.use_table:
            from .eps_table import table_n_pad
            budget = int(os.environ.get("TURBO_TPU_TABLE_BUDGET",
                                        str(512 << 20)))
            if 2 * 4 * table_n_pad(self) * self.plan.V > budget:
                self.use_table = False
        self._tables = {}

    def compile(self, lowered):
        """Compile a lowered program, adding its time to `compile_s`."""
        tc = time.monotonic()
        exe = lowered.compile()
        self.compile_s += time.monotonic() - tc
        return exe

    def clock(self) -> float:
        """Wall clock that stops while this solver's programs compile.
        The -t budgets (the table-build deadline, the hard wall) run on
        it, so a cold XLA compile does not eat the solve window."""
        return time.monotonic() - self.compile_s

    def get_table(self, shard_idx: int = 0):
        """Build (once per shard) the EPS subproblem-root table.

        Returns None when the build hit its deadline
        (solver._table_deadline on `clock()`, budgeted from -t by
        solve()); the caller then falls back to dive-mode refills for
        the whole run."""
        if shard_idx not in self._tables:
            from .eps_table import build_table
            tb = build_table(self, shard_idx)
            if tb is None:
                return None
            self._tables[shard_idx] = tb
        return self._tables[shard_idx]

    def disable_table(self):
        """Deadline fallback: drop table mode for this solver. Clears
        every table-keyed compilation cache so subsequent init/step
        programs compile (or cache-load) their dive-mode variants; a
        multi-shard caller must rebuild ALL shard states after this
        (table and dive states have different leaf shapes)."""
        self.use_table = False
        self._tables = {}
        self._init_cache = {}
        for attr in ("_step_budget", "_step_budget_jit", "_step_budget_pk"):
            if hasattr(self, attr):
                delattr(self, attr)

    # -- strategies ---------------------------------------------------

    def _apply_strategy_config(self):
        self.has_eps = apply_strategy_config(self.plan, self.cfg)

    def _build_strategy_tables(self):
        ids = [jnp.asarray(s.ids.astype(np.int32)) for s in self.plan.strategies]
        vo = jnp.asarray([_VO_CODE.get(s.var_order, 0)
                          for s in self.plan.strategies], dtype=I32)
        valo = jnp.asarray([_VALO_CODE.get(s.val_order, 0)
                            for s in self.plan.strategies], dtype=I32)
        return ids, vo, valo

    def _select(self, lb, ub, strat):
        """Pick the branching variable per dive.

        Mirrors barebones split()/input_order_split/lattice_smallest_split
        (barebones:186-349): first strategy index >= cursor that still
        has a splittable var; ties break on the smallest position in the
        strategy's variable order.
        Returns (found (D,), var (D,), new_strat (D,), valo (D,)).
        """
        D = lb.shape[0]
        s_ids, s_vo, s_valo = self._strategy_tables
        founds, vars_ = [], []
        big = jnp.iinfo(jnp.int32).max
        # The strategy list is padded to a power of two with REFERENCES
        # to the last strategy (plan.py); compute each distinct
        # strategy once and alias the duplicates (the padding would
        # otherwise double the largest strategy's select work).
        dedup = {}
        for si, ids in enumerate(s_ids):
            skey = id(self.plan.strategies[si])
            if skey in dedup:
                f, v = dedup[skey]
                founds.append(f)
                vars_.append(v)
                continue
            l = lb[:, ids]
            u = ub[:, ids]
            ok = (l < u) & (l > NINF) & (u < INF)
            vo = s_vo[si]
            pos_key = jnp.broadcast_to(
                jnp.arange(ids.shape[0], dtype=I32)[None, :], l.shape)
            key = _strategy.split_key(jnp, vo, pos_key, l, u)
            pos = jnp.argmin(jnp.where(ok, key, big), axis=1)
            founds.append(ok.any(axis=1))
            vars_.append(ids[pos])
            dedup[skey] = (founds[-1], vars_[-1])
        found_s = jnp.stack(founds, axis=1)    # (D, S)
        var_s = jnp.stack(vars_, axis=1)
        valo_s = jnp.broadcast_to(s_valo[None, :], found_s.shape)
        S = found_s.shape[1]
        allowed = jnp.arange(S, dtype=I32)[None, :] >= strat[:, None]
        ok = found_s & allowed
        has = ok.any(axis=1)
        chosen = jnp.argmax(ok, axis=1).astype(I32)
        var = jnp.take_along_axis(var_s, chosen[:, None], axis=1)[:, 0]
        valo = jnp.take_along_axis(valo_s, chosen[:, None], axis=1)[:, 0]
        return has, var, chosen, valo

    @staticmethod
    def _children(valo, lo, hi):
        """LightBranch children per value order (barebones:355-384);
        table shared with the oracle via solver.strategy."""
        c0l, c0u, c1l, c1u = _strategy.children(jnp, valo, lo, hi)
        return (c0l.astype(I32), c0u.astype(I32),
                c1l.astype(I32), c1u.astype(I32))

    # -- state --------------------------------------------------------

    def init_state(self, shard_idx: int = 0) -> SearchState:
        """Fresh search state, built by ONE compiled device program
        (one compile and one launch in place of ~40 eager
        allocations, each its own small program)."""
        if not hasattr(self, "_init_cache"):
            self._init_cache = {}
        table_args = ()
        if self.use_table:
            tb = self.get_table(shard_idx)
            if tb is None:
                # Build deadline hit: fall back to dive-mode refills
                # (sound — the dive path re-derives every subproblem
                # root the table would have held).
                self.disable_table()
        if self.use_table:
            seed = np.zeros(12, dtype=np.int64)
            seed[0] = tb.n_live
            seed[1:9] = (tb.nodes, tb.fails, tb.fpit, tb.solved,
                         tb.skipped, tb.sols, int(tb.nonexh),
                         int(tb.has_cand))
            seed[9] = tb.cand_bound if tb.has_cand else INF
            seed[10] = int(tb.deds)
            seed[11] = tb.dmax
            cand_lb = (tb.cand_lb if tb.cand_lb is not None
                       else self.plan.lb0).astype(np.int32)
            cand_ub = (tb.cand_ub if tb.cand_ub is not None
                       else self.plan.ub0).astype(np.int32)
            table_args = (jnp.asarray(tb.lb), jnp.asarray(tb.ub),
                          jnp.asarray(tb.strat), jnp.asarray(tb.path),
                          jnp.asarray(seed), jnp.asarray(cand_lb),
                          jnp.asarray(cand_ub))
        if shard_idx not in self._init_cache:
            self._init_cache[shard_idx] = self.compile(jax.jit(
                functools.partial(self._init_state_impl, shard_idx)).lower(
                    *table_args))
        return self._init_cache[shard_idx](*table_args)

    def _init_state_impl(self, shard_idx: int = 0, tab_lb=None,
                         tab_ub=None, tab_strat=None, tab_path=None,
                         seed=None, cand_lb=None,
                         cand_ub=None) -> SearchState:
        D = self.cfg.num_dives
        V = self.plan.V
        MAXD = self.cfg.max_depth
        lb0 = jnp.asarray(self.plan.lb0)
        ub0 = jnp.asarray(self.plan.ub0)
        def mat(base):
            # Materialized (not aliased) per-field buffers: step() donates
            # its input, so every state leaf needs its own buffer.
            return jnp.tile(base[None, :], (D, 1)).astype(I32)

        def zeros():
            return jnp.zeros((D,), dtype=I32)

        lb = mat(lb0)
        ub = mat(ub0)
        root_lb, root_ub = mat(lb0), mat(ub0)
        best_lb, best_ub = mat(lb0), mat(ub0)
        best_bound = jnp.full((D,), INF, dtype=I32)
        has_best = jnp.zeros((D,), dtype=bool)
        nodes, fails, sols, fpit = zeros(), zeros(), zeros(), zeros()
        deds = jnp.zeros((D,), dtype=jnp.float32)
        solved_sub, skipped_sub = zeros(), zeros()
        nonexh = jnp.zeros((D,), dtype=bool)
        strat, snap_strat = zeros(), zeros()
        dmax0 = zeros()
        if self.use_table:
            # Lanes seed directly from the first D table leaves, in
            # SOLVE phase; the next_sub counter indexes live table rows
            # and sub_limit carries the (traced) live count. The build
            # statistics are folded into lane 0's counters so the
            # reported work includes the dive tree.
            rows0 = jnp.arange(D, dtype=I32)
            n_live = seed[0].astype(I32)
            seeded = rows0 < jnp.minimum(n_live, D)
            n_pad = tab_lb.shape[0]
            idx0 = jnp.clip(rows0, 0, n_pad - 1)
            lb = jnp.where(seeded[:, None], tab_lb[idx0], lb)
            ub = jnp.where(seeded[:, None], tab_ub[idx0], ub)
            root_lb = jnp.where(seeded[:, None], tab_lb[idx0], root_lb)
            root_ub = jnp.where(seeded[:, None], tab_ub[idx0], root_ub)
            strat = jnp.where(seeded, tab_strat[idx0], 0)
            snap_strat = strat
            subp = jnp.where(seeded, tab_path[idx0], 0)
            phase = jnp.where(seeded, SOLVE, IDLE).astype(I32)
            remaining = zeros()
            next_sub = jnp.full((D,), jnp.minimum(n_live, D), dtype=I32)
            sub_limit = jnp.full((D,), n_live, dtype=I32)
            at0 = rows0 == 0
            nodes = jnp.where(at0, seed[1].astype(I32), 0)
            fails = jnp.where(at0, seed[2].astype(I32), 0)
            fpit = jnp.where(at0, seed[3].astype(I32), 0)
            solved_sub = jnp.where(at0, seed[4].astype(I32), 0)
            skipped_sub = jnp.where(at0, seed[5].astype(I32), 0)
            sols = jnp.where(at0, seed[6].astype(I32), 0)
            nonexh = at0 & (seed[7] > 0)
            has_cand = seed[8] > 0
            has_best = at0 & has_cand
            best_bound = jnp.where(at0 & has_cand,
                                   seed[9].astype(I32), INF)
            best_lb = jnp.where((at0 & has_cand)[:, None],
                                cand_lb[None, :], best_lb)
            best_ub = jnp.where((at0 & has_cand)[:, None],
                                cand_ub[None, :], best_ub)
            deds = jnp.where(at0, seed[10].astype(jnp.float32), 0.0)
            dmax0 = jnp.where(at0, seed[11].astype(I32), 0)
        else:
            # Static subproblem partition across shards; each shard owns
            # a contiguous range (multi-host EPS; reference uses one
            # global atomic counter on one GPU).
            per = self.num_sub_total // self.num_shards
            base = shard_idx * per
            # The last shard absorbs the remainder so the union of
            # ranges is exactly [0, 2^k) for ANY shard count (a floor
            # split would drop num_sub_total % num_shards subproblems
            # yet still claim exhaustiveness).
            limit = (self.num_sub_total
                     if shard_idx == self.num_shards - 1 else base + per)
            subp = (base + jnp.arange(D, dtype=I32)).astype(I32)
            phase = jnp.where(subp < limit, DIVE, IDLE).astype(I32)
            remaining = jnp.full((D,), self.k, dtype=I32)
            next_sub = jnp.full((D,), min(base + D, limit), dtype=I32)
            sub_limit = jnp.full((D,), limit, dtype=I32)
            # Placeholder table (never gathered; see SearchState docs).
            tab_lb = lb0[None, :]
            tab_ub = ub0[None, :]
            tab_strat = jnp.zeros((1,), dtype=I32)
            tab_path = jnp.zeros((1,), dtype=I32)
        R = max(1, self.cfg.sol_ring_size)
        sol_ring = jnp.zeros((R, V), dtype=I32)
        sol_w = zeros()
        if self.use_table and self.cfg.sol_ring_size > 0:
            # A solution found during the table build streams too.
            had = seed[8] > 0
            sol_ring = jnp.where(
                (jnp.arange(R) == 0)[:, None] & had,
                cand_lb[None, :], sol_ring)
            sol_w = jnp.full((D,), had.astype(I32), dtype=I32)
        return SearchState(
            lb=lb, ub=ub, root_lb=root_lb, root_ub=root_ub,
            best_lb=best_lb, best_ub=best_ub,
            best_bound=best_bound, has_best=has_best,
            dec_var=jnp.zeros((D, MAXD), dtype=I32),
            dec_l0=jnp.zeros((D, MAXD), dtype=I32),
            dec_u0=jnp.zeros((D, MAXD), dtype=I32),
            dec_l1=jnp.zeros((D, MAXD), dtype=I32),
            dec_u1=jnp.zeros((D, MAXD), dtype=I32),
            dec_rope1=jnp.zeros((D, MAXD), dtype=I32),
            dec_cur=jnp.zeros((D, MAXD), dtype=I32),
            depth=zeros(), phase=phase,
            remaining=remaining,
            subp=subp.astype(I32),
            strat=strat, snap_strat=snap_strat,
            next_sub=next_sub,
            nonexh=nonexh,
            nodes=nodes, fails=fails, sols=sols, fpit=fpit,
            deds=deds,
            dmax=dmax0, solved_sub=solved_sub, skipped_sub=skipped_sub,
            obj=jnp.full((D,), self.plan.obj, dtype=I32),
            is_opt=jnp.full((D,), bool(self.opt)),
            kpow=jnp.full((D,), self.k, dtype=I32),
            sub_limit=sub_limit,
            pscale=jnp.full((D,), float(self.plan.num_real_props),
                            dtype=jnp.float32),
            eps_strat=jnp.full((D,), int(getattr(self, "has_eps", False)),
                               dtype=I32),
            ext_bound=jnp.full((D,), INF, dtype=I32),
            fp_cap=jnp.full((D,), self.cfg.fp_max_iters, dtype=I32),
            tab_lb=jnp.asarray(tab_lb, dtype=I32),
            tab_ub=jnp.asarray(tab_ub, dtype=I32),
            tab_strat=jnp.asarray(tab_strat, dtype=I32),
            tab_path=jnp.asarray(tab_path, dtype=I32),
            sol_ring=sol_ring, sol_w=sol_w,
        )

    # -- the step function -------------------------------------------

    def step(self, st: SearchState) -> SearchState:
        cfg = self.cfg
        D = cfg.num_dives
        V = self.plan.V
        MAXD = cfg.max_depth
        obj = st.obj[0]
        is_opt = st.is_opt[0]
        shard_limit = st.sub_limit[0]

        promote = (st.phase == DIVE) & (st.remaining == 0)
        phase = jnp.where(promote, SOLVE, st.phase)
        # After the dive, skip the EPS strategy if one is configured
        # (barebones:748-752).
        strat0 = jnp.where(promote, jnp.maximum(st.strat, st.eps_strat),
                           st.strat)
        act = phase != IDLE
        in_dive = phase == DIVE
        in_solve = phase == SOLVE
        lb, ub = st.lb, st.ub
        best_bound = st.best_bound

        # I. Tighten the objective from the incumbent (barebones:752-771);
        # ext_bound carries a remote host's incumbent (multi-host EPS).
        g = jnp.minimum(best_bound.min(), st.ext_bound[0])
        if self.axis_name is not None:
            g = jax.lax.pmin(g, self.axis_name)
        lim = jnp.minimum(g, best_bound) - 1
        lim = jnp.where(is_opt, lim, INF).astype(I32)
        newu = jnp.minimum(ub[:, obj], lim)
        ub = ub.at[:, obj].set(jnp.where(in_solve, newu, ub[:, obj]))

        # II. Propagate (to fixpoint, or a fixed number of sweeps). The
        # named scope tags every propagation HLO op so a trace can be
        # split into FIXPOINT/SEARCH time (scripts/analyze_trace.py).
        with jax.named_scope("fixpoint"):
            fp_cap = st.fp_cap[0]
            if cfg.fp_mode == "fixed":
                lb, ub, iters, unconv = self.kernels.fixed_sweeps(
                    lb, ub, cfg.fp_fixed_iters)
            elif cfg.fp_mode == "wac1":
                lb, ub, iters, unconv = self.kernels.fixpoint_wac1(
                    lb, ub, fp_cap, cfg.wac1_inner_cap)
            elif cfg.fp_layout == "vd":
                lbT, ubT, iters, unconv = self.kernels.fixpoint_t(
                    lb.T, ub.T, fp_cap, cfg.fp_unroll)
                lb, ub = lbT.T, ubT.T
            else:
                lb, ub, iters, unconv = self.kernels.fixpoint(
                    lb, ub, fp_cap, cfg.fp_unroll)
        bot = self.kernels.is_bot(lb, ub)
        ent = self.kernels.all_entailed(lb, ub) & ~bot
        # HOLD lanes the capped fixpoint left unconverged: they neither
        # branch nor count a node this step — next step they resume
        # sweeping the same node. This keeps the search tree the EXACT
        # AC-1 fixpoint tree under ANY cap (branching pre-fixpoint is
        # sound but inflates the tree exponentially — sudoku_opt_p0:
        # 575 nodes at fixpoint vs 20583 at cap 4), while the step pays
        # only cap sweeps. Entailment/failure are exact at any prefix
        # of the fixpoint, so ent/bot lanes classify immediately.
        held = unconv & ~bot & ~ent

        # IV(a). Branch variable selection (needed before the solution
        # block in all-solutions mode).
        found, var, nstrat, valo = self._select(lb, ub, strat0)
        if cfg.enumerate_all:
            # All-solutions semantics: a solution is an all-singleton
            # store (AtomicExtraction); entailed boxes with splittable
            # vars keep splitting so each assignment is counted. A
            # singleton reached mid-dive is shared by every subproblem
            # of its prefix: count it only in the left-most one
            # (subp suffix bits all zero - the same dedup the reference
            # applies to skip counts, barebones:737-739).
            leftmost = (st.subp &
                        (jnp.left_shift(1, st.remaining) - 1)) == 0
            sol = ent & ~found & jnp.where(in_dive, leftmost, True)
            leaf = bot | (ent & ~found)
        else:
            sol = ent
            leaf = bot | sol

        nodes = st.nodes + (act & ~held).astype(I32)
        fails = st.fails + (act & bot).astype(I32)
        fpit = st.fpit + jnp.where(act, iters, 0)
        deds = st.deds + jnp.where(act, iters.astype(jnp.float32) * st.pscale, 0.0)
        # peakDepth counts the FULL tree depth incl. committed dive
        # decisions (kpow - remaining). The reference barebones keeps
        # its counter subproblem-relative (it undoes the dive increment,
        # barebones:698), but its CPU arch measures from the true root
        # (common_solving.hpp:831) — we follow the latter so engine and
        # oracle stats agree side by side.
        tree_depth = st.depth + (st.kpow - st.remaining)
        dmax = jnp.maximum(st.dmax, jnp.where(act, tree_depth, 0))

        # III. Solutions (all propagators entailed; objective read at lb).
        impr = act & sol & jnp.where(is_opt,
                                     lb[:, obj] < jnp.minimum(
                                         best_bound, st.ext_bound[0]),
                                     (True if cfg.enumerate_all
                                      else ~st.has_best))
        best_lb = jnp.where(impr[:, None], lb, st.best_lb)
        best_ub = jnp.where(impr[:, None], ub, st.best_ub)
        best_bound = jnp.where(
            impr, jnp.where(is_opt, lb[:, obj], 0), best_bound)
        has_best = st.has_best | impr
        sols = st.sols + impr.astype(I32)
        if cfg.sol_ring_size > 0:
            # Append accepted solution stores to the ring (gpu arch
            # streaming parity, gpu_dive_and_solve.hpp:100-132). Lanes
            # get distinct slots via the prefix count; non-writers
            # scatter to index R, which mode="drop" discards.
            R = cfg.sol_ring_size
            w0 = st.sol_w[0]
            ridx = jnp.where(impr,
                             (w0 + jnp.cumsum(impr.astype(I32)) - 1) % R,
                             R)
            sol_ring = st.sol_ring.at[ridx].set(lb, mode="drop")
            sol_w = st.sol_w + impr.sum().astype(I32)
        else:
            sol_ring, sol_w = st.sol_ring, st.sol_w
        no_split = act & ~leaf & ~found & ~held
        # No splittable var: if some unfixed (necessarily unbounded) var
        # remains, search is incomplete (reference: exhaustive=false,
        # barebones:688-695). If everything is fixed but undecided (only
        # possible before reaching the propagation fixpoint in "fixed"
        # mode), hold the lane: it keeps propagating next step.
        any_unfixed = jnp.any(lb[:, :self.plan.n_active] <
                              ub[:, :self.plan.n_active], axis=1)
        incomplete = no_split & any_unfixed
        waiting = no_split & ~any_unfixed
        nonexh = st.nonexh | incomplete
        leaf = leaf | incomplete
        branching = act & ~leaf & ~waiting & ~held

        lo = jnp.take_along_axis(lb, var[:, None], axis=1)[:, 0]
        hi = jnp.take_along_axis(ub, var[:, None], axis=1)[:, 0]
        c0l, c0u, c1l, c1u = self._children(valo, lo, hi)

        # V. Dive branching: commit the child given by the path bit
        # (barebones:700-708).
        dive_br = branching & in_dive
        bit = jnp.right_shift(st.subp, jnp.maximum(st.remaining - 1, 0)) & 1
        remaining = jnp.where(dive_br, st.remaining - 1, st.remaining)

        # VI. Solve branching: snapshot root at depth 0, push decision,
        # take the left child (barebones:783-823).
        solve_br = branching & in_solve
        ovf = solve_br & (st.depth >= MAXD)
        nonexh = nonexh | ovf
        solve_br = solve_br & ~ovf
        leaf = leaf | ovf
        snap = solve_br & (st.depth == 0)
        root_lb = jnp.where(snap[:, None], lb, st.root_lb)
        root_ub = jnp.where(snap[:, None], ub, st.root_ub)
        snap_strat = jnp.where(snap, strat0, st.snap_strat)

        dd = jnp.clip(st.depth, 0, MAXD - 1)
        parent = jnp.clip(st.depth - 1, 0, MAXD - 1)
        parent_cur = jnp.take_along_axis(st.dec_cur, parent[:, None], 1)[:, 0]
        parent_rope1 = jnp.take_along_axis(st.dec_rope1, parent[:, None], 1)[:, 0]
        rope1 = jnp.where(st.depth > 0,
                          jnp.where(parent_cur == 0, st.depth, parent_rope1),
                          -1)

        rows = jnp.arange(D, dtype=I32)

        def push(dst, vals):
            # One batched scatter per stack (not a vmapped per-row
            # dynamic update: that lowers to a full (D, MAXD) masked
            # rewrite, costly at deep MAXD).
            upd = jnp.where(solve_br, vals,
                            jnp.take_along_axis(dst, dd[:, None], 1)[:, 0])
            return dst.at[rows, dd].set(upd)

        dec_var = push(st.dec_var, var)
        dec_l0 = push(st.dec_l0, c0l)
        dec_u0 = push(st.dec_u0, c0u)
        dec_l1 = push(st.dec_l1, c1l)
        dec_u1 = push(st.dec_u1, c1u)
        dec_rope1 = push(st.dec_rope1, rope1.astype(I32))
        dec_cur = push(st.dec_cur, jnp.zeros((D,), dtype=I32))
        depth = jnp.where(solve_br, st.depth + 1, st.depth)

        # Apply the chosen child bounds (dive: by path bit; solve: left).
        embed = dive_br | solve_br
        el = jnp.where(dive_br, jnp.where(bit == 1, c1l, c0l), c0l)
        eu = jnp.where(dive_br, jnp.where(bit == 1, c1u, c0u), c0u)
        evar = jnp.where(embed, var, 0)
        el = jnp.where(embed, el, NINF)
        eu = jnp.where(embed, eu, INF)
        lb = lb.at[rows, evar].max(el)
        ub = ub.at[rows, evar].min(eu)

        # VII. Backtracking by ropes (barebones:826-864).
        bt = act & leaf & in_solve
        lastd = jnp.clip(depth - 1, 0, MAXD - 1)
        last_cur = jnp.take_along_axis(dec_cur, lastd[:, None], 1)[:, 0]
        last_rope1 = jnp.take_along_axis(dec_rope1, lastd[:, None], 1)[:, 0]
        t = jnp.where(last_cur == 0, depth, last_rope1)
        done_sub = bt & ((depth == 0) | (t == -1))
        restore = bt & (depth > 0) & (t != -1)

        tm1 = jnp.clip(t - 1, 0, MAXD - 1)
        dec_cur = dec_cur.at[rows, tm1].set(
            jnp.where(restore, 1,
                      jnp.take_along_axis(dec_cur, tm1[:, None], 1)[:, 0]))

        # Rebuild the store: root snapshot meet all decisions < t at
        # their current child (the flipped one included). Replays are
        # almost always shallow, so the deep tail of the stacks is
        # only touched when some lane actually restores past the hot
        # prefix (lax.cond executes a single branch at runtime; this
        # keeps steady-state stack traffic at O(D*HOT), not O(D*MAXD),
        # which matters at trains15-scale MAXD=10000).
        HOT = min(MAXD, cfg.hot_depth)
        tr = jnp.where(restore, t, 0)

        def _rebuild(w):
            narrow = jnp.arange(w, dtype=I32)[None, :]
            live = narrow < tr[:, None]
            cl = jnp.where(dec_cur[:, :w] == 1, dec_l1[:, :w], dec_l0[:, :w])
            cu = jnp.where(dec_cur[:, :w] == 1, dec_u1[:, :w], dec_u0[:, :w])
            cl = jnp.where(live, cl, NINF)
            cu = jnp.where(live, cu, INF)
            tvar = jnp.where(live, dec_var[:, :w], 0)
            return (root_lb.at[rows[:, None], tvar].max(cl),
                    root_ub.at[rows[:, None], tvar].min(cu))

        if HOT < MAXD:
            reb_lb, reb_ub = jax.lax.cond(
                jnp.max(tr) <= HOT,
                lambda: _rebuild(HOT), lambda: _rebuild(MAXD))
        else:
            reb_lb, reb_ub = _rebuild(MAXD)
        lb = jnp.where(restore[:, None], reb_lb, lb)
        ub = jnp.where(restore[:, None], reb_ub, ub)
        depth = jnp.where(restore, t, depth)
        strat = jnp.where(branching, nstrat, strat0)
        strat = jnp.where(restore, snap_strat, strat)

        # VIII. Dive leaves: skip the unreachable subtree
        # (barebones:717-741).
        dleaf = act & leaf & in_dive
        nxt = jnp.left_shift(
            jnp.right_shift(st.subp, remaining) + 1, remaining)
        # Subproblem accounting: a dive that dies on the leftmost path
        # of its dead subtree completes its own subproblem (counted
        # solved) and skips the rest of the range (nxt - subp - 1).
        # The reference folds the current one into the skipped range
        # (barebones:738); splitting it out makes solved+skipped
        # partition the subproblem space exactly, so an exhausted run
        # always shows every subproblem accounted for.
        dleaf_left = dleaf & (
            (st.subp & (jnp.left_shift(1, remaining) - 1)) == 0)
        skip_gain = jnp.where(dleaf_left, nxt - st.subp - 1, 0)
        skipped_sub = st.skipped_sub + skip_gain
        next_sub = jnp.maximum(st.next_sub[0],
                               jnp.where(dleaf, nxt, 0).max())

        # IX. Refill finished lanes from the subproblem counter
        # (barebones:877-884).
        want = dleaf | done_sub
        solved_sub = st.solved_sub + (done_sub | dleaf_left).astype(I32)
        rank = jnp.cumsum(want.astype(I32)) - 1
        newidx = next_sub + jnp.where(want, rank, 0)
        havework = want & (newidx < shard_limit)
        next_sub = jnp.minimum(next_sub + want.sum().astype(I32), shard_limit)

        refill = havework
        next_sub = jnp.full((D,), next_sub, dtype=I32)
        if self.use_table:
            # Table refill: gather the leaf row and enter SOLVE phase
            # directly (no dive replay; see solver/eps_table.py). The
            # counter indexes live table rows; subp carries the leaf's
            # real bit-path so the tail resplit keeps working.
            phase = jnp.where(want, jnp.where(havework, SOLVE, IDLE),
                              phase)
            n_pad = st.tab_lb.shape[0]
            idxc = jnp.clip(newidx, 0, n_pad - 1)
            tlb = st.tab_lb[idxc]
            tub = st.tab_ub[idxc]
            lb = jnp.where(refill[:, None], tlb, lb)
            ub = jnp.where(refill[:, None], tub, ub)
            root_lb = jnp.where(refill[:, None], tlb, root_lb)
            root_ub = jnp.where(refill[:, None], tub, root_ub)
            depth = jnp.where(refill, 0, depth)
            tstr = st.tab_strat[idxc]
            strat = jnp.where(refill, tstr, strat)
            snap_strat = jnp.where(refill, tstr, snap_strat)
            remaining = jnp.where(refill, 0, remaining)
            subp = jnp.where(refill, st.tab_path[idxc], st.subp)
        else:
            phase = jnp.where(want, jnp.where(havework, DIVE, IDLE),
                              phase)
            lb0 = jnp.asarray(self.plan.lb0)
            ub0 = jnp.asarray(self.plan.ub0)
            lb = jnp.where(refill[:, None], lb0[None, :], lb)
            ub = jnp.where(refill[:, None], ub0[None, :], ub)
            depth = jnp.where(refill, 0, depth)
            strat = jnp.where(refill, 0, strat)
            remaining = jnp.where(refill, st.kpow, remaining)
            subp = jnp.where(refill, newidx, st.subp)

        return SearchState(
            lb=lb, ub=ub, root_lb=root_lb, root_ub=root_ub,
            best_lb=best_lb, best_ub=best_ub, best_bound=best_bound,
            has_best=has_best, dec_var=dec_var, dec_l0=dec_l0, dec_u0=dec_u0,
            dec_l1=dec_l1, dec_u1=dec_u1, dec_rope1=dec_rope1,
            dec_cur=dec_cur, depth=depth, phase=phase, remaining=remaining,
            subp=subp, strat=strat, snap_strat=snap_strat, next_sub=next_sub,
            nonexh=nonexh, nodes=nodes, fails=fails, sols=sols, fpit=fpit,
            deds=deds, dmax=dmax, solved_sub=solved_sub,
            skipped_sub=skipped_sub, obj=st.obj, is_opt=st.is_opt,
            kpow=st.kpow, sub_limit=st.sub_limit, pscale=st.pscale,
            eps_strat=st.eps_strat, ext_bound=st.ext_bound,
            fp_cap=st.fp_cap, tab_lb=st.tab_lb, tab_ub=st.tab_ub,
            tab_strat=st.tab_strat, tab_path=st.tab_path,
            sol_ring=sol_ring, sol_w=sol_w)

    # -- host driver --------------------------------------------------

    def _tail_resplit(self, st, phase, max_new_kpow: int = 28):
        """EPS tail refinement: when the subproblem range is drained and
        only a few straggler lanes are still solving, re-split each
        unfinished subproblem 2^j-ways (extending its bit-path) and
        reseed the whole lane batch over the refined space.

        This is the SIMD answer to EPS tail skew: a deep subtree that
        one lane would grind sequentially while the rest idle becomes a
        2^j-wide parallel dive-and-solve of its own. Sound because the
        2^j refined bit-paths partition the unfinished subproblem
        exactly (same argument as the root split); already-completed
        work is never repeated — only the stragglers' in-progress
        subtrees are re-explored from their subproblem roots.

        Returns the reseeded state (numpy surgery, like the multi-host
        reseed) or None when refinement isn't worthwhile."""
        D = self.cfg.num_dives
        active = np.nonzero(phase != IDLE)[0]
        if len(active) == 0 or len(active) > D // 4:
            return None
        j = int(np.floor(np.log2(D / len(active))))
        j = min(j, 8)
        if j < 2:
            return None
        host = jax.device_get(st)
        host = jax.tree.map(np.asarray, host)
        pairs = [(int(host.subp[i]), int(host.kpow[i])) for i in active]
        pairs = sorted(set(pairs))
        j = min(j, max_new_kpow - max(kp for _, kp in pairs))
        if j < 2:
            return None
        new_subp = []
        new_kpow = []
        for sp, kp in pairs:
            for suf in range(1 << j):
                new_subp.append((sp << j) | suf)
                new_kpow.append(kp + j)
        n_new = len(new_subp)
        if n_new > D:  # shouldn't happen with j from the formula
            return None
        out = {f: getattr(host, f).copy()
               for f in ("phase", "subp", "kpow", "remaining", "depth",
                         "strat", "snap_strat", "next_sub", "sub_limit",
                         "lb", "ub", "root_lb", "root_ub")}
        out["phase"][:] = IDLE
        out["phase"][:n_new] = DIVE
        out["subp"][:n_new] = new_subp
        out["kpow"][:n_new] = new_kpow
        out["remaining"][:n_new] = new_kpow
        out["depth"][:] = 0
        out["strat"][:] = 0
        out["snap_strat"][:] = 0
        out["next_sub"][:] = 0   # every refined subproblem is lane-
        out["sub_limit"][:] = 0  # resident; no counter refills
        lb0 = self.plan.lb0[None, :]
        ub0 = self.plan.ub0[None, :]
        out["lb"][:] = lb0
        out["ub"][:] = ub0
        out["root_lb"][:] = lb0
        out["root_ub"][:] = ub0
        host = host._replace(**out)
        return jax.tree.map(jnp.asarray, host), len(pairs)

    def _open_branch_counter(self):
        """Tiny compiled program: number of open right branches across
        SOLVE-phase stacks — the steal gate's cheap precheck."""
        if not hasattr(self, "_open_cnt_fn"):
            def cnt(dec_cur, depth, phase):
                live = ((phase == SOLVE)[:, None]
                        & (jax.lax.broadcasted_iota(I32, dec_cur.shape, 1)
                           < depth[:, None]))
                return ((dec_cur == 0) & live).sum()

            D, MAXD = self.cfg.num_dives, self.cfg.max_depth
            ex = (jax.ShapeDtypeStruct((D, MAXD), I32),
                  jax.ShapeDtypeStruct((D,), I32),
                  jax.ShapeDtypeStruct((D,), I32))
            self._open_cnt_fn = self.compile(jax.jit(cnt).lower(*ex))
        return self._open_cnt_fn

    def _steal_open_branches(self, st, phase):
        """Post-drain work stealing from decision stacks.

        When the subproblem range is drained, straggler lanes grind deep
        subtrees while the rest idle. The resplit (above) re-splits the
        stragglers' subtrees from their roots — discarding the work they
        already did. Stealing is the strictly better move when the
        straggler has OPEN right branches on its stack: every entry d
        with dec_cur[d]==0 is an unexplored subtree (the right child the
        rope restore would eventually flip to). Reseeding an idle lane
        with that subtree and closing the entry on the victim partitions
        the victim's remaining work exactly — no node is ever explored
        twice, unlike the resplit. This is the SIMD analog of classic
        work-stealing-from-the-bottom-of-the-stack (steal the SHALLOWEST
        open entry: biggest stolen subtree, fewest steal rounds); the
        reference's MIMD blocks have no answer to this skew (its EPS
        refill, barebones_dive_and_solve.hpp:877-884, just grinds).

        Mechanics per steal (victim v, open depth d0, thief lane t):
          - thief stack = victim stack prefix [0, d0] with cur[d0]=1 and
            rope1[d0]=-1: exhausting the stolen subtree ropes to -1 ->
            done_sub -> the lane idles (the victim still owns the
            subproblem id; coarse accounting is frozen below).
          - thief store = victim root snapshot meet decisions[0..d0] at
            their current child (d0 at the right child) — exactly the
            store the victim's own rope restore to t=d0+1 would rebuild.
          - victim cur[d0]=1 plus a rope-chain recompute for its live
            entries above d0 (stored rope1 values are push-time
            snapshots that may point at the now-closed d0).

        Returns (new_state, n_steals) or None."""
        D = self.cfg.num_dives
        idle = np.nonzero(phase == IDLE)[0]
        if len(idle) == 0:
            return None
        host = jax.device_get(st)
        host = jax.tree.map(np.asarray, host)
        out = {f: getattr(host, f).copy()
               for f in ("phase", "subp", "kpow", "remaining", "depth",
                         "strat", "snap_strat", "lb", "ub",
                         "root_lb", "root_ub", "dec_var", "dec_l0",
                         "dec_u0", "dec_l1", "dec_u1", "dec_rope1",
                         "dec_cur")}
        # All open entries across SOLVE-phase lanes, shallowest first.
        opens = []
        for v in np.nonzero(host.phase == SOLVE)[0]:
            dep = int(host.depth[v])
            for d in range(dep):
                if out["dec_cur"][v, d] == 0:
                    opens.append((d, int(v)))
        if not opens:
            return None
        opens.sort()
        n_steals = 0
        for t in idle:
            if not opens:
                break
            d0, v = opens.pop(0)
            # Close the branch on the victim. cur[d0]=1 alone would
            # corrupt the victim's future rebuilds (restores to t > d0
            # rebuild decisions < t picking the cur child — the victim
            # is inside d0's LEFT subtree), so the right-child interval
            # is also rewritten to the left child's: the "cur child" of
            # the closed entry reproduces the victim's actual path.
            # The rope chain above d0 is then recomputed with the
            # current cur values (stored rope1 are push-time snapshots
            # that may still point at the now-closed d0); rope1[d0]
            # itself stays valid (cur below a live entry cannot have
            # flipped since its push — a flip at x < d0 truncates depth
            # to x+1, killing d0).
            out["dec_cur"][v, d0] = 1
            for d in range(d0 + 1, int(host.depth[v])):
                out["dec_rope1"][v, d] = (
                    d if out["dec_cur"][v, d - 1] == 0
                    else out["dec_rope1"][v, d - 1])
            # Seed the thief BEFORE the victim's l1/u1 rewrite so it
            # copies the true right child at d0. Shallower entries of
            # the same victim already closed by earlier steals copy
            # over with cur=1 and l1=l0 — which correctly reproduces
            # the victim's path at those depths.
            for f in ("dec_var", "dec_l0", "dec_u0", "dec_l1", "dec_u1",
                      "dec_rope1", "dec_cur"):
                out[f][t, :d0 + 1] = out[f][v, :d0 + 1]
            out["dec_cur"][t, d0] = 1
            out["dec_rope1"][t, d0] = -1
            out["dec_l1"][v, d0] = out["dec_l0"][v, d0]
            out["dec_u1"][v, d0] = out["dec_u0"][v, d0]
            lb = host.root_lb[v].copy()
            ub = host.root_ub[v].copy()
            for d in range(d0 + 1):
                var = out["dec_var"][t, d]
                right = out["dec_cur"][t, d] == 1
                lb[var] = max(lb[var],
                              out["dec_l1" if right else "dec_l0"][t, d])
                ub[var] = min(ub[var],
                              out["dec_u1" if right else "dec_u0"][t, d])
            out["lb"][t] = lb
            out["ub"][t] = ub
            out["root_lb"][t] = host.root_lb[v]
            out["root_ub"][t] = host.root_ub[v]
            out["depth"][t] = d0 + 1
            out["phase"][t] = SOLVE
            out["remaining"][t] = 0
            out["subp"][t] = host.subp[v]
            out["kpow"][t] = host.kpow[v]
            out["strat"][t] = host.snap_strat[v]
            out["snap_strat"][t] = host.snap_strat[v]
            n_steals += 1
        if n_steals == 0:
            return None
        host = host._replace(**out)
        return jax.tree.map(jnp.asarray, host), n_steals

    def make_step_budget(self):
        """One compiled program advancing the batch by a TRACED number
        of steps: `fn(state, n) -> state'`.

        A while_loop with a traced bound makes the chunk size a runtime
        scalar: one executable serves every chunk, and solve() adapts
        it to a wall-clock target (a step's cost varies by orders of
        magnitude between dive-phase and solve-phase steps, so no fixed
        chunk suits a whole run). The loop also early-exits when every
        lane is IDLE (an exhausted batch stops paying for the rest of
        its chunk).

        The compiled program is kept (with its optimized HLO, see
        step_hlo_text) and its XLA compile time is recorded in
        `step_compile_time`."""
        if hasattr(self, "_step_budget"):
            return self._step_budget

        @functools.partial(jax.jit, donate_argnums=0)
        def step_budget(st, n):
            def cond(c):
                i, s = c
                return (i < n) & jnp.any(s.phase != IDLE)

            def body(c):
                i, s = c
                return i + jnp.int32(1), self.step(s)

            # Return the executed-step counter too: the loop early-exits
            # on an all-IDLE batch, so `chunk` alone overcounts steps
            # (and would skew max_steps and per-step stats).
            i, st2 = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
            return st2, i

        lowered = step_budget.lower(self.init_state(),
                                    jax.ShapeDtypeStruct((), I32))
        c0 = self.compile_s
        self._step_budget = self.compile(lowered)
        self.step_compile_time = self.compile_s - c0
        return self._step_budget

    def make_step_n(self, n: int):
        """Fixed-chunk wrapper over the traced-budget program (all
        chunk sizes share ONE executable)."""
        fn = self.make_step_budget()
        nn = jnp.int32(n)
        return lambda st: fn(st, nn)[0]

    def make_step_counted(self, n: int):
        """Like make_step_n but also returns the executed-step count
        (the budget loop early-exits on an all-IDLE batch)."""
        fn = self.make_step_budget()
        nn = jnp.int32(n)
        return lambda st: fn(st, nn)

    def step_hlo_text(self) -> str:
        """Optimized-HLO text of the compiled budget program (the
        sidecar scripts/analyze_trace.py reads beside a trace)."""
        return self.make_step_budget().as_text()

    def solve(self, timeout_s: float = 1e18, chunk: int = 16,
              stop_after_n_solutions: int = 1, max_steps: int = 1 << 60,
              node_limit: int = 0, verbose: bool = False, on_improve=None,
              on_solution=None,
              checkpoint_path: str = "", checkpoint_every_s: float = 60.0,
              fp_cap: int = 0):
        """Single-device host loop. Returns an EngineResult.

        on_improve(best_lb_tnf_ids): called whenever the global
        incumbent improves (for -i intermediate solution printing).
        on_solution(lb_tnf_ids): with cfg.sol_ring_size > 0, called for
        EVERY accepted solution, in device order, at chunk latency —
        the batched-arch analog of the reference gpu arch's
        per-solution device->host stream (gpu_dive_and_solve.hpp:
        100-132). In enumerate mode the chunk is capped so the ring
        cannot overflow between drains.
        """
        from .result import EngineResult  # local import to avoid cycle
        from .timers import PhaseTimers
        t0 = time.monotonic()
        t_entry = time.monotonic()
        # Hard wall backstop: solveTime starts after the first chunk, so
        # beyond hard_mult * timeout_s since entry on `clock()` (which
        # stops while XLA compiles) the loop stops with the best-known
        # answer, however the time before the first chunk was spent.
        hard_mult = float(os.environ.get("TURBO_TPU_HARD_WALL_MULT", "2"))
        c_entry = self.clock()
        if self.plan.root_unsat:
            return EngineResult.unsat(self)
        timers = PhaseTimers(num_lanes=self.cfg.num_dives * self.num_shards)
        tt = time.monotonic()
        if (self.use_table and not self._tables and timeout_s < 1e17):
            # Budget the table build inside -t: at most half the solve
            # budget on `clock()`, so its program's compile is not
            # charged; on overrun build_table aborts and the run falls
            # back to dive-mode refills (the wasted wall time is still
            # charged to the solve budget below). A caller-provided
            # deadline (e.g. bench.py's artifact budget) stays binding
            # when tighter.
            dl = self.clock() + max(2.0, 0.5 * timeout_s)
            prev = getattr(self, "_table_deadline", None)
            self._table_deadline = dl if prev is None else min(prev, dl)
        st = self.init_state()
        self._table_deadline = None  # consumed; don't leak to re-solves
        if fp_cap > 0:
            # Per-run fixpoint-cap override: the cap plane is traced
            # state, so this swaps it with no recompile.
            st = st._replace(fp_cap=jnp.full_like(st.fp_cap, fp_cap))
        # Auto-cap calibration (AutoCapCalibrator): the first candidate
        # is armed before the compile chunk so the run never pays the
        # uncapped default; the winner is locked in for the rest of the
        # run. The cap plane is traced state: zero recompiles.
        cal = AutoCapCalibrator(self.cfg, fp_cap)
        st = cal.arm(st)
        jax.block_until_ready(st.lb)
        timers.transfer_c2g = time.monotonic() - tt
        # Table-build wall time counts against the solve budget (the
        # reference's dive work runs inside solveTime; excluding the
        # precomputed dive tree would flatter the 60 s regression).
        # An ABORTED build's wasted wall time is charged the same way.
        dive_dur = sum(t.build_time
                       for t in getattr(self, "_tables", {}).values())
        dive_dur += getattr(self, "_table_aborted_s", 0.0)
        resplit_rounds = 0
        resplit_base = None
        steal_rounds = 0
        if checkpoint_path:
            from .checkpoint import load_state
            restored = load_state(self, checkpoint_path)
            if restored is not None:
                st, extras = restored
                resplit_base = extras.get("resplit_base")
                resplit_rounds = extras.get("resplit_rounds", 0)
                steal_rounds = extras.get("steal_rounds", 0)
        ring = self.cfg.sol_ring_size
        if ring > 0 and self.cfg.enumerate_all:
            # Cap the chunk so at most `ring` solutions (D per step)
            # can land between drains — enumeration must not lose any.
            chunk = max(1, min(chunk, ring // max(self.cfg.num_dives, 1)))
        ring_drained = 0
        import sys as _sys
        step_fn = self.make_step_budget()
        cur_chunk = chunk
        step_n = lambda s: step_fn(s, jnp.int32(cur_chunk))
        steps = 0
        stopped = False
        first_call = True
        last_ckpt = time.monotonic()
        best_seen = None
        best_obj_time = 0.0
        last_best = INF + 1
        last_steal = 0.0
        steal_wait = 1.0
        # One-shot re-calibration on workload phase change: the cap
        # optimum can shift when the table-seeded /
        # EPS range drains into the deep tail. Armed only after the
        # loop has SEEN the undrained phase (otherwise tiny runs would
        # sweep the ladder twice back to back).
        recal_armed = False
        recal_done = False
        while True:
            td = time.monotonic()
            st, ndone = step_n(st)
            jax.block_until_ready(st.phase)
            device_dur = time.monotonic() - td
            warmup = first_call
            if first_call:
                # Exclude one-time XLA compile from the solve budget
                # (the reference's initTime/solveTime split) but keep
                # the table build inside it.
                first_call = False
                t0 = time.monotonic() - dive_dur
                warmup_time = t0 - t_entry
            tg = time.monotonic()
            # One transfer per chunk: fetch all host-loop inputs at once.
            phase, sols, fpit, bbs, nsub, slim, ndone_v, nodes_v = \
                jax.device_get(
                    (st.phase, st.sols, st.fpit, st.best_bound,
                     st.next_sub, st.sub_limit, ndone, st.nodes))
            steps += int(ndone_v)
            # block_until_ready above waited for the chunk, so the
            # fetch is pure device-to-host transfer.
            timers.transfer_g2c += time.monotonic() - tg
            timers.record_chunk(device_dur, int(fpit.sum()), phase,
                                int(ndone_v), time.monotonic() - t0,
                                measured=not warmup)
            if ring > 0 and on_solution is not None:
                cur = int(jax.device_get(st.sol_w)[0])
                if not self.opt and stop_after_n_solutions > 0:
                    cur = min(cur, stop_after_n_solutions)
                if cur > ring_drained:
                    if cur - ring_drained > ring:
                        print(f"% warning: solution ring overflow; "
                              f"{cur - ring_drained - ring} solutions "
                              f"not streamed", flush=True)
                        ring_drained = cur - ring
                    rows = jax.device_get(st.sol_ring)
                    for si in range(ring_drained, cur):
                        on_solution(self.plan.store_to_tnf(rows[si % ring]))
                    ring_drained = cur
            bbm = int(bbs.min())
            if on_improve is not None and bbm < last_best:
                last_best = bbm
                import numpy as _np
                blb = jax.device_get(st.best_lb)
                d = int(_np.argmin(bbs))
                on_improve(self.plan.store_to_tnf(blb[d]))
            if bbm < (best_seen if best_seen is not None else 1 << 40):
                best_seen = bbm
                best_obj_time = time.monotonic() - t0
            if (phase == IDLE).all():
                break
            if not self.opt and sols.sum() >= stop_after_n_solutions > 0:
                stopped = True
                break
            if time.monotonic() - t0 > timeout_s or steps >= max_steps:
                stopped = True
                break
            if (timeout_s < 1e17 and hard_mult > 0
                    and self.clock() - c_entry > hard_mult * timeout_s):
                print("% hard wall-clock limit reached "
                      f"({hard_mult:g}x timeout, compile excluded); "
                      "stopping", file=_sys.stderr, flush=True)
                stopped = True
                break
            # Adapt the chunk to the remaining budget: a SOLVE-phase
            # step can cost ~1 s at D=1024 on big-P instances, so a
            # fixed 64-step chunk overshoots a 60 s proof budget by 30%+
            # in one device call. The budget program takes its trip
            # count as a TRACED scalar, so resizing costs no recompile.
            if not warmup and int(ndone_v) > 0 and timeout_s < 1e17:
                step_cost = device_dur / int(ndone_v)
                remaining = timeout_s - (time.monotonic() - t0)
                cur_chunk = int(max(1, min(
                    chunk, remaining / max(step_cost, 1e-9))))
            # Auto-cap calibration: record the just-measured candidate,
            # arm the next one, or lock in the winner. The per-call
            # dispatch floor biases short chunks equally across
            # candidates, so the argmax is fair at small trip counts.
            if not cal.done:
                st, hint = cal.observe(st, int(nodes_v.sum()), device_dur,
                                       warmup, verbose=verbose)
                if hint is not None:
                    cur_chunk = min(cur_chunk, hint)
                else:
                    self.last_auto_cap = cal.chosen
                    cur_chunk = chunk
            # EPS tail: once the range is drained, idle lanes can only
            # get work from the stragglers. Stack stealing first (no
            # re-exploration); resplit as the fallback when stragglers
            # have no open branches to steal (e.g. all mid-dive).
            drained = nsub[0] >= slim[0]
            if not drained:
                recal_armed = True
            elif (recal_armed and not recal_done and cal.done
                    and fp_cap == 0 and self.cfg.fp_cap_auto
                    and self.cfg.fp_mode != "fixed"
                    and timeout_s - (time.monotonic() - t0) > 10.0):
                # Range just drained: re-sweep the cap ladder once for
                # the tail phase (every calibration chunk is still real
                # solve progress; the cap plane is traced state).
                recal_done = True
                cal = AutoCapCalibrator(self.cfg, fp_cap)
                if not cal.done:
                    cal.nodes0 = int(nodes_v.sum())
                    st = cal.arm(st)
                    if verbose:
                        print("% range drained: re-calibrating fp_cap",
                              flush=True)
            idle_n = int((phase == IDLE).sum())
            # Threshold idle_n >= D/8: each steal round fetches the full
            # state (stacks + stores) to the host, so reseeding a couple
            # of lanes is not worth the transfer; a large idle pool is.
            if (drained and idle_n >= max(1, len(phase) // 8)
                    and not (phase == IDLE).all()
                    and not self.cfg.enumerate_all
                    and timeout_s - (time.monotonic() - t0) > 2.0
                    and time.monotonic() - last_steal > steal_wait):
                last_steal = time.monotonic()
                def _freeze_accounting(_n_unique):
                    nonlocal resplit_base
                    if resplit_base is None:
                        # Snapshot coarse accounting: refined/stolen-
                        # unit counter deltas after this point are
                        # credited as the not-yet-accounted coarse
                        # subproblems once the run exhausts
                        # (EngineResult post-fix). NOT the unique-subp
                        # count of the non-idle lanes: a lane can be
                        # mid-dive inside a range another lane already
                        # counted as skipped (its dead subtree covered
                        # handed-out subproblems), so unique-subp
                        # double-counts those — total-solved-skipped
                        # makes solved+skipped partition the space by
                        # construction at any fixpoint cap.
                        solved0, skipped0 = jax.device_get(
                            (st.solved_sub, st.skipped_sub))
                        s0, k0 = int(solved0.sum()), int(skipped0.sum())
                        resplit_base = (
                            s0, k0,
                            max(0, self.num_sub_total - s0 - k0))
                # Cheap precheck: a device-side open-branch count gates
                # the full-state fetch; stragglers with closed stacks
                # cost one scalar round trip, not a full-state fetch
                # per second.
                n_open = int(jax.device_get(self._open_branch_counter()(
                    st.dec_cur, st.depth, st.phase)))
                res3 = None
                if n_open > 0:
                    res3 = self._steal_open_branches(st, np.asarray(phase))
                if res3 is not None:
                    # Freeze BEFORE adopting the post-steal state: the
                    # snapshot must read the pre-steal counters.
                    _freeze_accounting(0)
                    st, n_steals = res3
                    steal_rounds += 1
                    steal_wait = 1.0
                    if verbose:
                        print(f"% stack steal #{steal_rounds}: "
                              f"{n_steals} open branches reseeded")
                elif resplit_rounds < 8 and idle_n >= (3 * len(phase)) // 4:
                    res2 = self._tail_resplit(st, phase)
                    if res2 is not None:
                        _freeze_accounting(0)
                        st, n_coarse = res2
                        resplit_rounds += 1
                        steal_wait = 1.0
                        if verbose:
                            print(f"% tail resplit #{resplit_rounds}: "
                                  f"{n_coarse} stragglers refined")
                    else:
                        steal_wait = min(steal_wait * 2, 8.0)
                else:
                    # Nothing to steal or refine this round: back off
                    # exponentially so the straggler's chunks are not
                    # starved by retry fetches.
                    steal_wait = min(steal_wait * 2, 8.0)
            if node_limit and int(jax.device_get(st.nodes.sum())) >= node_limit:
                stopped = True
                break
            if checkpoint_path and \
                    time.monotonic() - last_ckpt > checkpoint_every_s:
                from .checkpoint import save_state
                save_state(self, st, checkpoint_path, extras={
                    "resplit_base": resplit_base,
                    "resplit_rounds": resplit_rounds,
                    "steal_rounds": steal_rounds})
                last_ckpt = time.monotonic()
            if verbose:
                # Occupancy trace: per-chunk wall time, phase histogram
                # and counter position — the data that adjudicates
                # whether a slow proof is kernel cost (few slow steps at
                # full occupancy) or starvation (many steps, most lanes
                # DIVE/IDLE). See DESIGN.md "EPS economics".
                bb = int(bbs.min())
                nd = int(jax.device_get(st.nodes.sum()))
                print(f"% t={time.monotonic()-t0:6.1f}s steps={steps} "
                      f"chunk_s={device_dur:.2f} nodes={nd} "
                      f"best={bb if bb < INF else None} "
                      f"dive={(phase == DIVE).sum()} "
                      f"solve={(phase == SOLVE).sum()} "
                      f"idle={(phase == IDLE).sum()}/{len(phase)} "
                      f"next_sub={int(nsub[0])}/{int(slim[0])}",
                      flush=True)
        if checkpoint_path and stopped:
            from .checkpoint import save_state
            save_state(self, st, checkpoint_path, extras={
                "resplit_base": resplit_base,
                "resplit_rounds": resplit_rounds,
                "steal_rounds": steal_rounds})
        res = EngineResult.from_state(self, st, stopped,
                                       time.monotonic() - t0)
        if resplit_base is not None:
            # Report subproblem accounting in COARSE (2^k) units: the
            # refined-unit deltas accumulated after the first resplit
            # collapse back into the stragglers they partition.
            solved0, skipped0, n_coarse = resplit_base
            res.eps_solved_subproblems = solved0 + (
                n_coarse if res.exhaustive else 0)
            res.eps_skipped_subproblems = skipped0
            res.eps_redistributions = (getattr(res, "eps_redistributions", 0)
                                       or 0) + resplit_rounds + steal_rounds
        res.best_obj_time = best_obj_time
        res.warmup_time = warmup_time
        res.compile_time = self.step_compile_time
        timers.fill_result(res, res.solve_time)
        # Precomputed dive-tree build (host wall time): the reference's
        # DIVE timer analog for the table path. Also surfaced as its
        # own stat (table_build_time) so dive_time's absorption of the
        # build is observable.
        res.dive_time += dive_dur
        res.table_build_time = dive_dur
        return res
