"""Batched engine tests: golden objectives, oracle equivalence,
propagation cross-checks, multi-chip sharding."""
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from turbo_tpu.frontend.fzn import parse_fzn, parse_fzn_text
from turbo_tpu.compile.model import compile_model
from turbo_tpu.core.ops import INF, NINF
from turbo_tpu.solver import deduce_np
from turbo_tpu.solver.engine import BatchedSolver, EngineConfig
from turbo_tpu.solver.oracle import PropTable, solve as oracle_solve
from turbo_tpu.solver.plan import build_plan
from turbo_tpu.solver.propagate_jax import PropagatorKernels

from instances import GOLOMB8, MODELS, OPTIMUM, golomb_fzn

GOLDEN = sorted((name, opt) for name, (_, opt) in MODELS.items())


def model(name):
    """Compiled TNF of one of the in-repo MODELS."""
    return compile_model(parse_fzn_text(MODELS[name][0]))


def plan_root(tnf, plan):
    """The plan's root store (after its root fixpoint) in TNF ids: the
    store the plan's propagators are complete for (it drops the ones
    already entailed there)."""
    lb, ub = tnf.lb0.copy(), tnf.ub0.copy()
    act = plan.inv_perm >= 0
    lb[plan.inv_perm[act]] = plan.lb0[act]
    ub[plan.inv_perm[act]] = plan.ub0[act]
    return lb, ub


@pytest.mark.parametrize("name,expected", GOLDEN, ids=[c[0] for c in GOLDEN])
def test_engine_golden(name, expected):
    tnf = model(name)
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=5,
                                        max_depth=64))
    r = s.solve(timeout_s=120, chunk=16)
    assert r.status == "optimal"
    assert r.objective == expected


@pytest.mark.slow
def test_engine_golden_golomb8():
    tnf = compile_model(parse_fzn(GOLOMB8))
    s = BatchedSolver(tnf, EngineConfig(num_dives=16, subproblems_power=6,
                                        max_depth=128))
    r = s.solve(timeout_s=240, chunk=32)
    assert r.status == "optimal" and r.objective == OPTIMUM[8]


def test_engine_matches_oracle_on_random_models():
    """Differential test: random tiny optimization models, engine vs
    oracle must agree on the optimum (or both prove unsat)."""
    rng = np.random.default_rng(7)
    for trial in range(8):
        n = 4
        lines = []
        for i in range(n):
            lines.append(f"var {rng.integers(-3, 1)}..{rng.integers(2, 6)}: x{i};")
        # random linear constraints
        for c in range(4):
            coeffs = rng.integers(-3, 4, size=n)
            k = int(rng.integers(-5, 15))
            cs = ",".join(str(int(v)) for v in coeffs)
            xs = ",".join(f"x{i}" for i in range(n))
            lines.append(f"constraint int_lin_le([{cs}], [{xs}], {k});")
        lines.append("constraint int_times(x0, x1, x2);")
        lines.append(f"solve minimize x{int(rng.integers(0, n))};")
        text = "\n".join(lines)
        tnf = compile_model(parse_fzn_text(text))
        ro = oracle_solve(tnf, timeout_s=30)
        s = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=3,
                                            max_depth=64))
        re = s.solve(timeout_s=60, chunk=8)
        assert ro.status == re.status, (trial, text, ro.status, re.status)
        assert ro.objective == re.objective, (trial, text)


def test_jax_propagation_matches_numpy():
    """Fixpoint of the JAX kernels == fixpoint of the numpy oracle rules
    on randomly narrowed stores of a real instance."""
    tnf = compile_model(parse_fzn(GOLOMB8))
    plan = build_plan(tnf)
    kernels = PropagatorKernels(plan)
    table = PropTable(tnf)
    rng = np.random.default_rng(3)

    D = 4
    Vr = tnf.num_vars
    lb_root, ub_root = plan_root(tnf, plan)
    lbs, ubs = [], []
    for d in range(D):
        lb = lb_root.copy()
        ub = ub_root.copy()
        # randomly narrow some vars (soundly: sub-intervals)
        for v in rng.choice(Vr, size=5, replace=False):
            if lb[v] < ub[v]:
                lo = rng.integers(lb[v], ub[v] + 1)
                hi = rng.integers(lo, ub[v] + 1)
                lb[v], ub[v] = lo, hi
        lbs.append(lb)
        ubs.append(ub)

    # numpy fixpoints per dive
    np_results = []
    for lb, ub in zip(lbs, ubs):
        l, u = lb.copy(), ub.copy()
        table.propagate(l, u)
        np_results.append((l, u))

    # jax fixpoint batched (permuted ids)
    lbp = np.stack([plan.lb0.copy() for _ in range(D)])
    ubp = np.stack([plan.ub0.copy() for _ in range(D)])
    for d in range(D):
        lbp[d, plan.perm] = lbs[d]
        ubp[d, plan.perm] = ubs[d]
    jl, ju, _, _ = jax.jit(kernels.fixpoint)(jnp.asarray(lbp, jnp.int32),
                                          jnp.asarray(ubp, jnp.int32))
    jl, ju = np.asarray(jl), np.asarray(ju)

    for d in range(D):
        nl, nu = np_results[d]
        bot_np = (nl > nu).any()
        gl = jl[d][plan.perm]
        gu = ju[d][plan.perm]
        bot_jx = (jl[d] > ju[d]).any()
        assert bot_np == bot_jx, f"dive {d}: bot mismatch"
        if not bot_np:
            # The plan drops root-entailed props, so the device fixpoint
            # can only differ on vars those props would have pruned;
            # both must agree on all vars of live propagators.
            kept = ~plan.dropped  # store-compacted vars are inert
            np.testing.assert_array_equal(gl[kept], nl[kept],
                                          err_msg=f"dive {d} lb")
            np.testing.assert_array_equal(gu[kept], nu[kept],
                                          err_msg=f"dive {d} ub")


def test_sharded_matches_single():
    from turbo_tpu.parallel.mesh import ShardedSolver

    tnf = model("golomb6")
    s1 = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=6,
                                         max_depth=64))
    r1 = s1.solve(timeout_s=120, chunk=16)
    s8 = ShardedSolver(tnf, EngineConfig(num_dives=2, subproblems_power=6,
                                         max_depth=64))
    r8 = s8.solve(timeout_s=120, chunk=16)
    assert r1.status == r8.status == "optimal"
    assert r1.objective == r8.objective == OPTIMUM[6]


def test_satisfaction_mode():
    tnf = compile_model(parse_fzn_text(
        """
        var 1..3: x :: output_var;
        var 1..3: y :: output_var;
        constraint int_ne(x, y);
        solve satisfy;
        """
    ))
    s = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=3,
                                        max_depth=16))
    r = s.solve(timeout_s=60, chunk=8)
    assert r.status == "sat"
    assert r.best_lb is not None
    # the witness must satisfy the constraint
    xs = [i for i, n in enumerate(tnf.names) if n == "x"]
    ys = [i for i, n in enumerate(tnf.names) if n == "y"]
    assert r.best_lb[xs[0]] != r.best_lb[ys[0]]


def test_unsat_detected():
    tnf = compile_model(parse_fzn_text(
        """
        var 1..2: x;
        var 1..2: y;
        var 1..2: z;
        constraint int_ne(x, y);
        constraint int_ne(y, z);
        constraint int_ne(x, z);
        solve satisfy;
        """
    ))
    s = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=3,
                                        max_depth=16))
    r = s.solve(timeout_s=60, chunk=8)
    assert r.status == "unsat"


def test_solutions_pass_independent_checker():
    """Engine solutions must satisfy the ORIGINAL FlatZinc constraints
    (independent evaluator, no propagator code involved)."""
    from turbo_tpu.utils.checker import check_solution

    for name in ["golomb6", "times_div", "reified_in", "element"]:
        m = parse_fzn_text(MODELS[name][0])
        tnf = compile_model(m)
        s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=5,
                                            max_depth=64))
        r = s.solve(timeout_s=120, chunk=16)
        assert r.best_lb is not None
        bad = check_solution(m, tnf, r.best_lb)
        assert not bad, (name, bad[:5])


def test_jax_element_member_kernels_match_numpy():
    """Element/membership device kernels vs numpy oracle rules on
    randomly narrowed stores."""
    text = """
    array [1..6] of int: t = [4, 9, 2, 9, 7, 5];
    var 1..6: i :: output_var;
    var {2,4,7,9}: r :: output_var;
    var 1..6: j :: output_var;
    constraint array_int_element(i, t, r);
    constraint int_ne(i, j);
    solve minimize r;
    """
    tnf = compile_model(parse_fzn_text(text))
    assert len(tnf.elements) == 1 and len(tnf.members) >= 1
    plan = build_plan(tnf)
    kernels = PropagatorKernels(plan)
    table = PropTable(tnf)
    rng = np.random.default_rng(11)
    D = 8
    Vr = tnf.num_vars
    lbs, ubs = [], []
    for d in range(D):
        lb = tnf.lb0.copy()
        ub = tnf.ub0.copy()
        for v in rng.choice(Vr, size=3, replace=False):
            if lb[v] < ub[v]:
                lo = rng.integers(lb[v], ub[v] + 1)
                hi = rng.integers(lo, ub[v] + 1)
                lb[v], ub[v] = lo, hi
        lbs.append(lb)
        ubs.append(ub)
    np_res = []
    for lb, ub in zip(lbs, ubs):
        l, u = lb.copy(), ub.copy()
        table.propagate(l, u)
        np_res.append((l, u))
    lbp = np.stack([plan.lb0.copy() for _ in range(D)])
    ubp = np.stack([plan.ub0.copy() for _ in range(D)])
    for d in range(D):
        lbp[d, plan.perm] = lbs[d]
        ubp[d, plan.perm] = ubs[d]
    jl, ju, _, _ = jax.jit(kernels.fixpoint)(jnp.asarray(lbp, jnp.int32),
                                          jnp.asarray(ubp, jnp.int32))
    jl, ju = np.asarray(jl), np.asarray(ju)
    for d in range(D):
        nl, nu = np_res[d]
        bot_np = (nl > nu).any()
        bot_jx = (jl[d] > ju[d]).any()
        assert bot_np == bot_jx, f"dive {d}"
        if not bot_np:
            kept = ~plan.dropped  # store-compacted vars are inert
            np.testing.assert_array_equal(jl[d][plan.perm][kept], nl[kept])
            np.testing.assert_array_equal(ju[d][plan.perm][kept], nu[kept])


def test_element_engine_end_to_end():
    text = """
    array [1..5] of int: t = [3, 1, 4, 1, 5];
    var 1..5: i :: output_var;
    var 1..5: r :: output_var;
    constraint array_int_element(i, t, r);
    constraint int_le(2, i);
    solve minimize r;
    """
    tnf = compile_model(parse_fzn_text(text))
    s = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=3,
                                        max_depth=16))
    r = s.solve(timeout_s=60, chunk=8)
    assert r.status == "optimal"
    assert r.objective == 1  # t[2] = 1 reachable with i >= 2


def test_checkpoint_resume(tmp_path):
    from turbo_tpu.solver.checkpoint import load_state, save_state

    tnf = model("golomb6")
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=6,
                                        max_depth=64))
    path = str(tmp_path / "ckpt.pkl")
    # Run a few steps, checkpoint, resume, finish: same optimum.
    st = s.init_state()
    step_n = s.make_step_n(8)
    st = step_n(st)
    save_state(s, st, path)
    restored = load_state(s, path)
    assert restored is not None
    st2, _extras = restored
    import numpy as _np
    _np.testing.assert_array_equal(jax.device_get(st.nodes),
                                   jax.device_get(st2.nodes))
    r = s.solve(timeout_s=120, chunk=8, checkpoint_path=path)
    assert r.status == "optimal" and r.objective == OPTIMUM[6]
    # Same SHAPES but different plan DATA must be rejected (v4): a
    # -shave run can tighten lb0/ub0 without changing any shape, and
    # resuming lane state against different root bounds remaps the
    # subproblem bit-paths. Simulate with a solver whose plan data
    # digest differs.
    s_shaved = BatchedSolver(tnf, EngineConfig(
        num_dives=8, subproblems_power=6, max_depth=64, shave=True))
    if s_shaved.plan.data_digest != s.plan.data_digest:
        assert load_state(s_shaved, path) is None


def test_jax_linear_kernel_matches_numpy():
    """Native linear kernels: JAX vs numpy on random narrowed stores."""
    text = """
    var 0..9: a; var -5..5: b :: output_var; var 0..20: c;
    constraint int_lin_le([2, -3, 1], [a, b, c], 7);
    constraint int_lin_eq([1, 1, 1], [a, b, c], 12);
    constraint int_lin_le_reif([4, 1], [a, c], 9, b);
    solve minimize b;
    """
    tnf = compile_model(parse_fzn_text(text))
    assert len(tnf.linears) >= 2
    plan = build_plan(tnf)
    kernels = PropagatorKernels(plan)
    table = PropTable(tnf)
    rng = np.random.default_rng(5)
    D = 8
    Vr = tnf.num_vars
    lbs, ubs = [], []
    for d in range(D):
        lb = tnf.lb0.copy()
        ub = tnf.ub0.copy()
        for v in rng.choice(Vr, size=2, replace=False):
            if lb[v] < ub[v]:
                lo = rng.integers(lb[v], ub[v] + 1)
                hi = rng.integers(lo, ub[v] + 1)
                lb[v], ub[v] = lo, hi
        lbs.append(lb)
        ubs.append(ub)
    np_res = []
    for lb, ub in zip(lbs, ubs):
        l, u = lb.copy(), ub.copy()
        table.propagate(l, u)
        np_res.append((l, u))
    lbp = np.stack([plan.lb0.copy() for _ in range(D)])
    ubp = np.stack([plan.ub0.copy() for _ in range(D)])
    for d in range(D):
        lbp[d, plan.perm] = lbs[d]
        ubp[d, plan.perm] = ubs[d]
    jl, ju, _, _ = jax.jit(kernels.fixpoint)(jnp.asarray(lbp, jnp.int32),
                                          jnp.asarray(ubp, jnp.int32))
    jl, ju = np.asarray(jl), np.asarray(ju)
    for d in range(D):
        nl, nu = np_res[d]
        bot_np = (nl > nu).any()
        bot_jx = (jl[d] > ju[d]).any()
        assert bot_np == bot_jx, f"dive {d}"
        if not bot_np:
            kept = ~plan.dropped  # store-compacted vars are inert
            np.testing.assert_array_equal(jl[d][plan.perm][kept], nl[kept])
            np.testing.assert_array_equal(ju[d][plan.perm][kept], nu[kept])


def test_phase_timers():
    """Per-phase timer parity (statistics.hpp:13-29): timers populate,
    are non-negative, and the fixpoint/search split covers the measured
    device time."""
    tnf = model("golomb5")
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=4,
                                        max_depth=128, fp_max_iters=16))
    r = s.solve(timeout_s=60.0)
    assert r.status == "optimal"
    assert r.num_blocks == 8
    assert r.num_blocks_done == 8
    assert r.variables == tnf.num_vars - int(s.plan.dropped.sum())
    assert r.propagators > 0
    for f in ("search_time", "fixpoint_time", "dive_time",
              "transfer_cpu2gpu_time", "transfer_gpu2cpu_time",
              "wait_cpu_time", "first_block_idle_time",
              "cumulative_time_block_sec"):
        assert getattr(r, f) >= 0.0, f
    # The split partitions device time: per-block sums stay within wall.
    assert r.fixpoint_time + r.search_time <= r.solve_time + 1e-6
    assert r.dive_time <= r.solve_time + 1e-6
    assert r.first_block_idle_time <= r.solve_time + 1e-6
    assert r.deductions_per_block_second >= 0.0


def test_phase_timers_attribution():
    """The least-squares FIXPOINT/SEARCH attribution recovers a known
    linear cost model from synthetic chunk samples."""
    from turbo_tpu.solver.timers import PhaseTimers
    t = PhaseTimers(num_lanes=4)
    a, b = 0.010, 0.002  # fixed cost per chunk, cost per fp iteration
    total = 0
    for i, iters in enumerate([10, 30, 20, 50, 40]):
        total += iters
        t.record_chunk(a + b * iters, total, np.array([0, 1, 1, 2]),
                       chunk=4, now=float(i))
    fix, search = t.fixpoint_search_split()
    assert abs(fix - b * total) < 1e-9
    assert abs(search - 5 * a) < 1e-9
    assert t.dive_steps == 5 * 4  # one DIVE lane per chunk x chunk steps
    assert t.act_steps == 15 * 4
    assert t.first_idle == 0.0


def test_rebalance_ranges_unit():
    """Host-side EPS redistribution: a dry shard steals the upper half
    of the richest shard's remaining range and reseeds its lanes from
    the root store; ranges stay disjoint."""
    from turbo_tpu.parallel.mesh import ShardedSolver, rebalance_ranges
    tnf = model("golomb5")
    # use_table=False: this unit test exercises the DIVE-mode reseed
    # (the table-mode twin lives in test_eps_table.py).
    s = ShardedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=8,
                                        max_depth=64, use_table=False))
    D, S = 4, s.n_shards
    st = jax.tree.map(lambda x: np.array(x), jax.device_get(s.init_state()))
    per = s.num_sub_total // S
    # Make shard 0 dry: all IDLE, counter at its limit.
    st.phase[0:D] = 2
    st.next_sub[0:D] = per
    st.subp[0:D] = per - 1
    # Mutate its stores so the reseed is observable.
    st.lb[0:D] = 99
    new, moves = rebalance_ranges(st, D, S, s.plan.lb0, s.plan.ub0)
    assert moves == 1
    # Donor (any other shard; all have `per - D` remaining) gave its
    # upper half; receiver lanes resume diving there.
    rec_next = int(new.next_sub[0])
    rec_lim = int(new.sub_limit[0])
    assert rec_lim - int(new.subp[0]) <= per  # inside some shard's old range
    assert (new.phase[0:D] == 0).all()        # DIVE
    assert (new.depth[0:D] == 0).all()
    assert (new.lb[0:D] == s.plan.lb0[None, :]).all()
    assert (new.remaining[0:D] == s.solver.k).all()
    assert rec_next == int(new.subp[D - 1]) + 1
    # Donor's limit shrank to the receiver's base.
    donor = None
    for d in range(1, S):
        if int(new.sub_limit[d * D]) != int(st.sub_limit[d * D]):
            donor = d
    assert donor is not None
    assert int(new.sub_limit[donor * D]) == int(new.subp[0])
    # Disjoint: donor's new range ends where the receiver's begins, and
    # the receiver's range ends at the donor's old limit.
    assert rec_lim == int(st.sub_limit[donor * D])
    # No work when every shard is dry.
    st2 = jax.tree.map(lambda x: np.array(x), jax.device_get(s.init_state()))
    st2.phase[:] = 2
    st2.next_sub[:] = np.repeat(
        [(i + 1) * per for i in range(S)], D).astype(np.int32)
    _, moves2 = rebalance_ranges(st2, D, S, s.plan.lb0, s.plan.ub0)
    assert moves2 == 0


def test_sharded_solve_with_redistribution():
    """End-to-end: redistribution preserves correctness and
    exhaustiveness on a golden instance."""
    from turbo_tpu.parallel.mesh import ShardedSolver
    tnf = model("golomb5")
    s = ShardedSolver(tnf, EngineConfig(num_dives=2, subproblems_power=7,
                                        max_depth=64, fp_max_iters=16))
    r = s.solve(timeout_s=120.0)
    assert r.status == "optimal" and r.objective == OPTIMUM[5]
    assert r.eps_redistributions >= 0


def test_sharded_checkpoint_resume(tmp_path):
    """Cross-run checkpoint/resume through the sharded (multi) arch:
    the global sharded state round-trips with mesh sharding restored."""
    from turbo_tpu.parallel.mesh import ShardedSolver
    from turbo_tpu.solver.checkpoint import load_state, save_state

    tnf = model("golomb6")
    s = ShardedSolver(tnf, EngineConfig(num_dives=2, subproblems_power=6,
                                        max_depth=64))
    path = str(tmp_path / "ckpt.pkl")
    st = s.init_state()
    step_n = s.make_step_n(8)
    st = step_n(st)
    save_state(s.solver, st, path, num_shards=s.n_shards)
    # Shard-count mismatch is refused.
    assert load_state(s.solver, path, num_shards=s.n_shards + 1) is None
    restored = load_state(s.solver, path, num_shards=s.n_shards)
    assert restored is not None
    st2, _extras = restored
    np.testing.assert_array_equal(jax.device_get(st.nodes),
                                  jax.device_get(st2.nodes))
    r = s.solve(timeout_s=120, chunk=8, checkpoint_path=path)
    assert r.status == "optimal" and r.objective == OPTIMUM[6]


def test_hybrid_goldens():
    """Hybrid arch (host search + batched device propagation) proves
    the same optima as the engine (hybrid_dive_and_solve.hpp parity)."""
    from turbo_tpu.solver.hybrid import HybridSolver
    for name in ("golomb5", "times_div", "golomb6"):
        expected = MODELS[name][1]
        tnf = model(name)
        s = HybridSolver(tnf, EngineConfig(num_dives=4, subproblems_power=4,
                                           max_depth=256, fp_max_iters=64))
        r = s.solve(timeout_s=120.0)
        assert r.status == "optimal", name
        assert r.objective == expected, name
        assert r.num_blocks == 4
        assert r.fixpoint_time >= 0.0


def test_hybrid_satisfaction_and_unsat():
    from turbo_tpu.solver.hybrid import HybridSolver
    tnf = compile_model(parse_fzn_text("""
var 1..3: x; var 1..3: y;
constraint int_ne(x, y);
solve satisfy;
"""))
    r = HybridSolver(tnf, EngineConfig(num_dives=2, subproblems_power=2,
                                       fp_max_iters=32)).solve(timeout_s=60)
    assert r.status == "sat"
    assert int(r.best_lb[0]) != int(r.best_lb[1])
    tnf2 = compile_model(parse_fzn_text("""
var 1..2: x; var 1..2: y; var 1..2: z;
constraint int_ne(x, y);
constraint int_ne(y, z);
constraint int_ne(x, z);
solve satisfy;
"""))
    r2 = HybridSolver(tnf2, EngineConfig(num_dives=2, subproblems_power=2,
                                         fp_max_iters=32)).solve(timeout_s=60)
    assert r2.status == "unsat"


def test_hybrid_matches_oracle_on_random_models():
    """Differential: random tiny optimization models, hybrid arch vs
    oracle agree on the optimum (or both prove unsat)."""
    from turbo_tpu.solver.hybrid import HybridSolver
    rng = np.random.default_rng(11)
    for trial in range(6):
        n = 4
        lines = []
        for i in range(n):
            lines.append(f"var {rng.integers(-3, 1)}..{rng.integers(2, 6)}: x{i};")
        for c in range(4):
            coeffs = rng.integers(-3, 4, size=n)
            k = int(rng.integers(-5, 15))
            cs = ",".join(str(int(v)) for v in coeffs)
            xs = ",".join(f"x{i}" for i in range(n))
            lines.append(f"constraint int_lin_le([{cs}], [{xs}], {k});")
        lines.append("constraint int_times(x0, x1, x2);")
        lines.append(f"solve minimize x{int(rng.integers(0, n))};")
        text = "\n".join(lines)
        tnf = compile_model(parse_fzn_text(text))
        ro = oracle_solve(tnf, timeout_s=30)
        s = HybridSolver(tnf, EngineConfig(num_dives=3, subproblems_power=3,
                                           max_depth=64, fp_max_iters=64))
        rh = s.solve(timeout_s=60)
        assert ro.status == rh.status, (trial, text, ro.status, rh.status)
        assert ro.objective == rh.objective, (trial, text)


def test_all_solutions_enumeration():
    """-a semantics: solutions are all-singleton stores; entailed boxes
    split further, and mid-dive duplicates across EPS prefixes are
    counted once (left-most subproblem). x<y in 1..3 has exactly 3."""
    from turbo_tpu.solver.hybrid import HybridSolver
    from turbo_tpu.solver.oracle import solve as osolve
    tnf = compile_model(parse_fzn_text("""
var 1..3: x; var 1..3: y;
constraint int_lt(x, y);
solve satisfy;
"""))
    ro = osolve(tnf, timeout_s=30, stop_after_n_solutions=0)
    assert ro.stats.solutions == 3
    cfg = EngineConfig(num_dives=4, subproblems_power=3, max_depth=64,
                       fp_max_iters=32, enumerate_all=True)
    re = BatchedSolver(tnf, cfg).solve(timeout_s=60,
                                       stop_after_n_solutions=0)
    assert re.solutions == 3
    rh = HybridSolver(tnf, cfg).solve(timeout_s=60,
                                      stop_after_n_solutions=0)
    assert rh.solutions == 3


def test_solution_ring_streams_every_solution():
    """Per-solution streaming (gpu_dive_and_solve.hpp:100-132 parity):
    with a sol_ring, -a emits every distinct all-singleton solution
    through on_solution, in device order, none lost."""
    tnf = compile_model(parse_fzn_text("""
var 1..3: x :: output_var; var 1..3: y :: output_var;
constraint int_lt(x, y);
solve satisfy;
"""))
    cfg = EngineConfig(num_dives=4, subproblems_power=3, max_depth=64,
                       fp_max_iters=32, enumerate_all=True,
                       sol_ring_size=16)
    got = []
    r = BatchedSolver(tnf, cfg).solve(
        timeout_s=60, stop_after_n_solutions=0,
        on_solution=lambda lb: got.append((int(lb[0]), int(lb[1]))))
    assert r.solutions == 3
    assert sorted(set(got)) == [(1, 2), (1, 3), (2, 3)]
    assert len(got) == 3
    # Improving-solution streaming on an optimization problem (-i): the
    # emitted objective sequence is strictly improving per lane-accept
    # and ends at the optimum.
    tnf2 = compile_model(parse_fzn_text("""
var 1..9: x :: output_var; var 1..9: y;
constraint int_lt(y, x);
solve minimize x;
"""))
    cfg2 = EngineConfig(num_dives=2, subproblems_power=2, max_depth=64,
                        fp_max_iters=32, sol_ring_size=16)
    objs = []
    r2 = BatchedSolver(tnf2, cfg2).solve(
        timeout_s=60, on_solution=lambda lb: objs.append(int(lb[0])))
    assert r2.status == "optimal" and r2.objective == 2
    assert objs and objs[-1] == 2


def test_shard_partition_covers_all_subproblems():
    # ADVICE r1 (high): floor split dropped num_sub_total % num_shards
    # subproblems; tiny -sub gave shards empty ranges -> false UNSAT.
    from turbo_tpu.frontend.fzn import parse_fzn_text as _p

    tnf = compile_model(_p(
        """
        var 1..3: x :: output_var;
        solve satisfy;
        """
    ))
    for n_shards in (3, 5, 8):
        for k in (1, 2, 5):
            # Dive mode: counters ARE subproblem ids; ranges must tile
            # [0, 2^k) exactly.
            s = BatchedSolver(tnf, EngineConfig(
                num_dives=2, subproblems_power=k, max_depth=16,
                use_table=False),
                num_shards=n_shards)
            covered = set()
            limits = []
            for i in range(n_shards):
                st = s.init_state(shard_idx=i)
                base = int(st.subp[0])
                limit = int(st.sub_limit[0])
                assert limit > base, (
                    f"shard {i}/{n_shards} k={s.k} got an empty range")
                covered.update(range(base, limit))
                limits.append((base, limit))
            assert covered == set(range(s.num_sub_total)), (
                n_shards, k, limits)
            # Table mode: each shard's live leaves plus its dead
            # (solved+skipped) prefixes must partition its range, and
            # live paths across shards must be disjoint.
            s2 = BatchedSolver(tnf, EngineConfig(
                num_dives=2, subproblems_power=k, max_depth=16),
                num_shards=n_shards)
            if not s2.use_table:
                continue
            live_all = []
            accounted = 0
            for i in range(n_shards):
                tb = s2.get_table(i)
                live_all.extend(tb.path[:tb.n_live].tolist())
                accounted += tb.n_live + tb.solved + tb.skipped
            assert accounted == s2.num_sub_total, (n_shards, k)
            assert len(live_all) == len(set(live_all))


def test_sharded_tiny_sub_still_sat():
    # End-to-end version of the empty-range scenario: 8 virtual devices
    # with -sub 1 on a satisfiable model must not report UNSAT.
    from turbo_tpu.parallel.mesh import ShardedSolver

    tnf = model("golomb5")
    s = ShardedSolver(tnf, EngineConfig(num_dives=2, subproblems_power=1,
                                        max_depth=64))
    r = s.solve(timeout_s=120, chunk=8)
    assert r.status in ("sat", "optimal")
    assert r.objective is not None


def test_wac1_fixpoint_matches_numpy():
    """fixpoint_wac1 (per-group local fixpoints, scatter-meet) must
    reach the same fixpoint as the numpy oracle rules; it may only
    detect MORE bottoms than the bucketed AC-1 (it also meets into
    fixed singleton slots, like the reference's tell)."""
    tnf = compile_model(parse_fzn(GOLOMB8))
    plan = build_plan(tnf)
    kernels = PropagatorKernels(plan)
    table = PropTable(tnf)
    rng = np.random.default_rng(11)

    D = 4
    Vr = tnf.num_vars
    lb_root, ub_root = plan_root(tnf, plan)
    lbs, ubs = [], []
    for d in range(D):
        lb = lb_root.copy()
        ub = ub_root.copy()
        for v in rng.choice(Vr, size=5, replace=False):
            if lb[v] < ub[v]:
                lo = rng.integers(lb[v], ub[v] + 1)
                hi = rng.integers(lo, ub[v] + 1)
                lb[v], ub[v] = lo, hi
        lbs.append(lb)
        ubs.append(ub)

    np_results = []
    for lb, ub in zip(lbs, ubs):
        l, u = lb.copy(), ub.copy()
        table.propagate(l, u)
        np_results.append((l, u))

    lbp = np.stack([plan.lb0.copy() for _ in range(D)])
    ubp = np.stack([plan.ub0.copy() for _ in range(D)])
    for d in range(D):
        lbp[d, plan.perm] = lbs[d]
        ubp[d, plan.perm] = ubs[d]
    jl, ju, sweeps, _ = jax.jit(kernels.fixpoint_wac1)(
        jnp.asarray(lbp, jnp.int32), jnp.asarray(ubp, jnp.int32))
    al, au, aiters, _ = jax.jit(kernels.fixpoint)(
        jnp.asarray(lbp, jnp.int32), jnp.asarray(ubp, jnp.int32))
    jl, ju = np.asarray(jl), np.asarray(ju)

    for d in range(D):
        nl, nu = np_results[d]
        bot_np = (nl > nu).any()
        bot_wc = (jl[d] > ju[d]).any()
        assert bot_np == bot_wc, f"dive {d}: bot mismatch"
        if not bot_np:
            kept = ~plan.dropped
            np.testing.assert_array_equal(jl[d][plan.perm][kept], nl[kept],
                                          err_msg=f"dive {d} lb")
            np.testing.assert_array_equal(ju[d][plan.perm][kept], nu[kept],
                                          err_msg=f"dive {d} ub")
    # The warp-fixpoint analog must do its outer convergence in fewer
    # sweeps than pure-Jacobi AC-1 (that is its entire point).
    assert int(np.asarray(sweeps).max()) < int(np.asarray(aiters).max())


def test_engine_wac1_end_to_end():
    """-fp wac1 end to end: same optimum as ac1, different (smaller)
    outer iteration counts."""
    tnf = model("golomb6")
    base = dict(num_dives=8, subproblems_power=5, max_depth=64)
    r_ac1 = BatchedSolver(tnf, EngineConfig(**base)).solve(
        timeout_s=120, chunk=16)
    r_wac = BatchedSolver(tnf, EngineConfig(fp_mode="wac1", **base)).solve(
        timeout_s=120, chunk=16)
    assert r_ac1.status == r_wac.status == "optimal"
    assert r_ac1.objective == r_wac.objective == OPTIMUM[6]
    assert r_wac.fixpoint_iterations != r_ac1.fixpoint_iterations


def test_wac1_threshold_falls_back_to_ac1():
    tnf = compile_model(parse_fzn_text(
        "var 1..3: x;\nsolve minimize x;\n"))
    s = BatchedSolver(tnf, EngineConfig(fp_mode="wac1",
                                        wac1_threshold=10**6))
    assert s.cfg.fp_mode == "fixpoint"


def test_auto_num_dives_occupancy_analog():
    """-or 0 auto-sizing (reference occupancy default, barebones:527-
    547): big working sets get fewer lanes, small ones more, always a
    power of two in [64, 1024]."""
    from turbo_tpu.solver.plan import auto_num_dives
    from instances import GOLOMB13
    small = compile_model(parse_fzn(GOLOMB8))
    big = compile_model(parse_fzn(GOLOMB13))
    dw, dt = auto_num_dives(small), auto_num_dives(big)
    assert 256 <= dw <= 1024
    assert 64 <= dt <= dw
    assert dw & (dw - 1) == 0 and dt & (dt - 1) == 0


def test_transposed_fixpoint_matches_dv():
    """fixpoint_t on (V, D) planes must equal fixpoint on (D, V) planes
    exactly (same sweeps, same stores), across instances exercising the
    bytecode, element, membership, and linear kernel families."""
    for path in ("golomb6", "element", "reified_in", "linear_reif"):
        tnf = model(path)
        plan = build_plan(tnf)
        kernels = PropagatorKernels(plan)
        rng = np.random.default_rng(7)
        D = 6
        lbp = np.stack([plan.lb0.copy() for _ in range(D)])
        ubp = np.stack([plan.ub0.copy() for _ in range(D)])
        for d in range(D):
            for v in rng.choice(plan.n_active, size=6, replace=False):
                if lbp[d, v] < ubp[d, v]:
                    lo = rng.integers(lbp[d, v], ubp[d, v] + 1)
                    hi = rng.integers(lo, ubp[d, v] + 1)
                    lbp[d, v], ubp[d, v] = lo, hi
        al, au, ai, _ = jax.jit(kernels.fixpoint)(
            jnp.asarray(lbp, jnp.int32), jnp.asarray(ubp, jnp.int32))
        tl, tu, ti, _ = jax.jit(kernels.fixpoint_t)(
            jnp.asarray(lbp.T, jnp.int32), jnp.asarray(ubp.T, jnp.int32))
        np.testing.assert_array_equal(np.asarray(al), np.asarray(tl).T, path)
        np.testing.assert_array_equal(np.asarray(au), np.asarray(tu).T, path)
        np.testing.assert_array_equal(np.asarray(ai), np.asarray(ti), path)


def test_engine_vd_layout_matches_dv():
    """The vd fixpoint layout must not change search results."""
    tnf = model("golomb6")
    r1 = BatchedSolver(tnf, EngineConfig(
        num_dives=8, subproblems_power=5, max_depth=64)).solve(timeout_s=120)
    r2 = BatchedSolver(tnf, EngineConfig(
        num_dives=8, subproblems_power=5, max_depth=64,
        fp_layout="dv")).solve(timeout_s=120)
    assert r1.status == r2.status == "optimal"
    assert r1.objective == r2.objective == OPTIMUM[6]
    assert r1.nodes == r2.nodes


def test_hot_depth_cold_branch_matches():
    """A tiny hot prefix forces the deep-rebuild branch constantly;
    results must be identical to the default."""
    tnf = model("golomb6")
    r1 = BatchedSolver(tnf, EngineConfig(
        num_dives=8, subproblems_power=5, max_depth=64)).solve(timeout_s=120)
    r2 = BatchedSolver(tnf, EngineConfig(
        num_dives=8, subproblems_power=5, max_depth=64,
        hot_depth=4)).solve(timeout_s=120)
    assert r1.status == r2.status == "optimal"
    assert r1.objective == r2.objective == OPTIMUM[6]
    assert r1.nodes == r2.nodes


def test_disable_simplify_changes_network_and_keeps_answers():
    """-disable_simplify (config.cpp:41) must actually disable the
    simplification passes: the device plan keeps entailed propagators
    and compacted variables, the reported network stats change, and
    the answer stays the same."""
    # The root fixpoint fixes b (x <= 10 always holds) and bounds s by
    # 15, so int_le_reif and int_le(s, 15) are entailed at the root.
    tnf = compile_model(parse_fzn_text("""
var 1..5: x :: output_var;
var 1..5: y :: output_var;
var bool: b;
var 0..20: s;
constraint int_le_reif(x, 10, b);
constraint int_lin_eq([1, 1, -1], [x, y, s], 0);
constraint int_le(s, 15);
constraint int_lin_le([-1, -1], [x, y], -6);
solve minimize x;
"""))
    p_on = build_plan(tnf)
    p_off = build_plan(tnf, disable_simplify=True)
    assert p_off.num_real_props > p_on.num_real_props
    assert int(p_off.dropped.sum()) == 0
    # Solve with the flag: same optimum, and the result's stat block
    # reflects the unsimplified network.
    cfg = EngineConfig(num_dives=8, subproblems_power=4, max_depth=64,
                       disable_simplify=True)
    s = BatchedSolver(tnf, cfg)
    r = s.solve(timeout_s=120, chunk=16)
    assert r.status == "optimal" and r.objective == 1
    assert r.propagators == p_off.num_real_props
    s2 = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=4,
                                         max_depth=64))
    r2 = s2.solve(timeout_s=120, chunk=16)
    assert r2.propagators == p_on.num_real_props
    assert r2.variables <= r.variables


def test_shave_root_cuts_refutable_bound():
    """-shave (opt-in, beyond the reference): probing x=0 propagates
    y=1 via the sum and then refutes x>=y, so the root lower bound of
    x is shaved to 1 — a cut bounds-AC-1 alone cannot make. The
    shaved plan fixes the whole model at the root; answers must not
    change (shaving removes only values belonging to no solution)."""
    text = (
        "var 0..1: x;\n"
        "var 0..1: y;\n"
        "constraint int_lin_eq([1, 1], [x, y], 1);\n"
        "constraint int_lin_le([-1, 1], [x, y], 0);\n"
        "solve minimize y;\n")
    tnf = compile_model(parse_fzn_text(text))
    p_plain = build_plan(tnf)
    p_shaved = build_plan(tnf, shave=True)
    # AC-1 alone leaves x/y open; shaving fixes both (x=1, y=0), so
    # every propagator roots entailed and the active store empties.
    assert p_plain.n_active > 0
    assert p_shaved.n_active == 0
    assert p_shaved.num_real_props < p_plain.num_real_props
    for shave in (False, True):
        r = BatchedSolver(tnf, EngineConfig(
            num_dives=4, subproblems_power=2, max_depth=16,
            shave=shave)).solve(timeout_s=60, chunk=4)
        assert r.status == "optimal" and r.objective == 0
    # -disable_simplify implies no shaving (it is a simplification):
    # the combined plan is identical to the plain unsimplified one.
    p_both = build_plan(tnf, disable_simplify=True, shave=True)
    p_off = build_plan(tnf, disable_simplify=True)
    assert p_both.num_real_props == p_off.num_real_props
    assert (p_both.lb0 == p_off.lb0).all() and (p_both.ub0 == p_off.ub0).all()


def test_engine_stats_parity_with_oracle():
    """Side-by-side stat fidelity (VERDICT r2 §6): on an exhausted run
    the engine's subproblem accounting must partition the EPS space
    exactly, peakDepth must count dive decisions (the oracle measures
    from the true root, common_solving.hpp:831), and the headline
    results must agree with the sequential oracle."""
    tnf = model("golomb5")
    ro = oracle_solve(tnf, timeout_s=120)
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=5,
                                        max_depth=64))
    r = s.solve(timeout_s=120, chunk=16)
    assert r.status == ro.status == "optimal"
    assert r.objective == ro.objective
    assert r.exhaustive and ro.stats.exhaustive
    # Every one of the 2^5 subproblems is accounted for: solved by a
    # completed SOLVE phase or the leftmost representative of a
    # skipped subtree (solved), plus the rest of each dead range.
    assert (r.eps_solved_subproblems + r.eps_skipped_subproblems
            == r.eps_num_subproblems)
    # The proof branched; with dive decisions counted, peak depth is
    # positive and can reach at most the oracle's true-root depth plus
    # the EPS path length.
    assert 0 < r.depth_max <= ro.stats.depth_max + 5
    assert ro.stats.depth_max > 0


def test_tail_resplit_preserves_answers():
    """EPS tail refinement (round 3): when the subproblem range drains
    and stragglers remain, the engine re-splits them 2^j-finer and
    reseeds. The proof must stay exhaustive with the same optimum, and
    the subproblem accounting must stay in coarse 2^k units."""
    tnf = compile_model(parse_fzn_text(golomb_fzn(7)))
    s = BatchedSolver(tnf, EngineConfig(num_dives=32, subproblems_power=5,
                                        max_depth=128))
    r = s.solve(timeout_s=300, chunk=8)
    assert r.status == "optimal" and r.objective == OPTIMUM[7]
    assert r.exhaustive
    assert (r.eps_solved_subproblems + r.eps_skipped_subproblems
            == r.eps_num_subproblems == 32)


def test_stack_steal_preserves_answers():
    """Post-drain stack stealing (round 3): with D > 2^k the subproblem
    range drains at init, so idle lanes can only be fed by stealing open
    right-branches from straggler stacks. The proof must stay exhaustive
    with the oracle's optimum, stealing must actually engage, and the
    coarse subproblem accounting must stay an exact partition."""
    tnf = compile_model(parse_fzn_text(golomb_fzn(7)))
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=2,
                                        max_depth=128))
    r = s.solve(timeout_s=300, chunk=8)
    assert r.status == "optimal" and r.objective == OPTIMUM[7]
    assert r.exhaustive
    assert r.eps_redistributions >= 1
    assert (r.eps_solved_subproblems + r.eps_skipped_subproblems
            == r.eps_num_subproblems == 4)


def test_stack_steal_differential_random_models():
    """Stealing surgery differential: random models run with D > 2^k
    (steal-dominated tails) must agree with the sequential oracle on
    status and optimum — exercises victim rope-chain rewrites, thief
    seeding, and repeated steals from one victim."""
    rng = np.random.default_rng(23)
    for trial in range(6):
        n = 4
        lines = []
        for i in range(n):
            lines.append(f"var {rng.integers(-4, 0)}.."
                         f"{rng.integers(3, 8)}: x{i};")
        for c in range(3):
            coeffs = rng.integers(-3, 4, size=n)
            k = int(rng.integers(-4, 18))
            cs = ",".join(str(int(v)) for v in coeffs)
            xs = ",".join(f"x{i}" for i in range(n))
            lines.append(f"constraint int_lin_le([{cs}], [{xs}], {k});")
        lines.append("constraint int_times(x0, x1, x2);")
        lines.append(f"solve minimize x{int(rng.integers(0, n))};")
        text = "\n".join(lines)
        tnf = compile_model(parse_fzn_text(text))
        ro = oracle_solve(tnf, timeout_s=30)
        s = BatchedSolver(tnf, EngineConfig(num_dives=8,
                                            subproblems_power=1,
                                            max_depth=64))
        re = s.solve(timeout_s=60, chunk=4)
        assert ro.status == re.status, (trial, text, ro.status, re.status)
        assert ro.objective == re.objective, (trial, text)
        if re.exhaustive:
            assert (re.eps_solved_subproblems + re.eps_skipped_subproblems
                    == re.eps_num_subproblems), (trial, text)


def test_auto_subproblems_capped_by_dive_budget(monkeypatch):
    """The factor-based EPS split (config.hpp:76) is additionally
    capped so per-lane lockstep dive work stays bounded (round-3 SIMD
    economics, DESIGN.md)."""
    # The caps read env knobs at call time; pin the defaults so an
    # exported benchmarking override cannot flip the exact assertions.
    monkeypatch.delenv("TURBO_TPU_REFILL_BITS", raising=False)
    monkeypatch.delenv("TURBO_TPU_DIVE_BUDGET", raising=False)
    from turbo_tpu.solver.engine import choose_subproblems_power
    for D, kexp in ((64, 8), (256, 10), (1024, 12)):
        k = choose_subproblems_power(None, EngineConfig(num_dives=D), 1,
                                     allow_probe=False)
        # refill cap: ~4 refills per lane (k = log2(D) + 2); dive
        # replay, not tail skew, dominates SIMD proofs (DESIGN.md)
        assert k == kexp, (D, k)
        assert (1 << k) * k // D <= 3000, (D, k)
    # pinned -sub is never overridden
    k = choose_subproblems_power(None, EngineConfig(
        num_dives=1024, subproblems_power=19), 1, allow_probe=False)
    assert k == 19


def test_hybrid_checkpoint_resume(tmp_path):
    """Hybrid arch cross-run checkpoint/resume (round 3): a node-limited
    run snapshots its host search state; the resumed run continues (not
    restarts) and proves the same optimum."""
    from turbo_tpu.solver.hybrid import HybridSolver

    tnf = model("golomb6")
    cfg = EngineConfig(num_dives=4, subproblems_power=5, max_depth=64)
    path = str(tmp_path / "hyb.pkl")
    r1 = HybridSolver(tnf, cfg).solve(timeout_s=300, node_limit=40,
                                      checkpoint_path=path)
    assert r1.status in ("unknown", "sat") and r1.nodes >= 40
    import os
    assert os.path.exists(path)
    r2 = HybridSolver(tnf, cfg).solve(timeout_s=300,
                                      checkpoint_path=path)
    assert r2.status == "optimal" and r2.objective == OPTIMUM[6]
    # Resumed, not restarted: cumulative counters cover both runs.
    assert r2.nodes > r1.nodes
    # A mismatched configuration must refuse the snapshot (fresh run).
    cfg2 = EngineConfig(num_dives=8, subproblems_power=5, max_depth=64)
    r3 = HybridSolver(tnf, cfg2).solve(timeout_s=300, node_limit=8,
                                       checkpoint_path=path)
    assert r3.nodes <= 16


def test_auto_max_depth_first_cover_strategy():
    """Depth bound charges each var the val order of the FIRST strategy
    covering it: an all-split user search keeps the log2 bound even
    though compile_model appends a first_fail/indomain_min fallback
    (which only ever branches vars no earlier strategy covers)."""
    from turbo_tpu.solver.engine import auto_max_depth

    txt_split = """
var 0..1000000: x;
var 0..1000000: y;
var 0..10: obj;
constraint int_le(x, obj);
solve :: int_search([x, y], first_fail, indomain_split, complete)
    minimize obj;
"""
    plan = build_plan(compile_model(parse_fzn_text(txt_split)))
    # x,y: ceil(log2(1e6+1))=20 bits each; obj (fallback, indomain_min):
    # w-1=10. Far below the 10000 saturation the old bound hit.
    assert auto_max_depth(plan) <= 256

    txt_enum = txt_split.replace("indomain_split", "indomain_min")
    plan2 = build_plan(compile_model(parse_fzn_text(txt_enum)))
    # indomain_min right spines are w-1 deep: must saturate to 10000.
    assert auto_max_depth(plan2) == 10000


def test_checkpoint_version_and_fp_cap_override(tmp_path, capsys):
    """Old-format checkpoints are rejected LOUDLY; a restored state
    takes the resuming run's fp cap, not the snapshot's."""
    import pickle

    from turbo_tpu.solver import checkpoint as ckpt

    tnf = model("golomb5")
    s = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=3,
                                        max_depth=64, fp_max_iters=16))
    st = s.init_state()
    path = str(tmp_path / "ck.pkl")
    ckpt.save_state(s, st, path)

    s2 = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=3,
                                         max_depth=64, fp_max_iters=9))
    restored = ckpt.load_state(s2, path)
    assert restored is not None
    st2, _extras = restored
    assert int(np.asarray(st2.fp_cap)[0]) == 9

    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["format"] = 1
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    assert ckpt.load_state(s, path) is None
    err = capsys.readouterr().err
    assert "checkpoint" in err and "ignored" in err


def test_singleton_tail_conflict_detected():
    """A deduction that contradicts a ROOT-FIXED var (compacted into the
    singleton tail, outside the bucketed combine) must fail the node.
    Round-3 fuzzing found the dropped conflict: an all-singleton
    non-entailed leaf could neither branch, fail, nor be accepted —
    a livelock (hundreds of thousands of lockstep steps on a 2-var
    model). int_div(x4, 2, x1) with x1 root-fixed at -2: x4=-3 gives
    x4 div 2 = -1 != -2 and must die by propagation."""
    txt = """
var -3..-2: x1;
var -4..1: x4;
constraint int_div(x4, 2, x1);
solve maximize x4;
"""
    tnf = compile_model(parse_fzn_text(txt))
    plan = build_plan(tnf)
    assert plan.conf_idx is not None  # x1 and const 2 are tail targets
    k = PropagatorKernels(plan)
    lb = plan.lb0[None, :].astype(np.int32).copy()
    ub = plan.ub0[None, :].astype(np.int32).copy()
    lb[0, 0] = ub[0, 0] = -3  # x4 := -3 (active col 0)
    l2, u2 = k.iteration(jnp.asarray(lb), jnp.asarray(ub))
    assert bool(np.asarray(k.is_bot(l2, u2))[0])
    # Transposed layout agrees.
    l3, u3 = k.iteration_t(jnp.asarray(lb.T), jnp.asarray(ub.T))
    assert bool(np.asarray(jnp.any(l3 > u3)))
    # End-to-end: the proof closes in a few dozen nodes (was: livelock).
    for mode in ("fixpoint", "wac1"):
        s = BatchedSolver(tnf, EngineConfig(num_dives=2,
                                            subproblems_power=2,
                                            max_depth=64, fp_mode=mode,
                                            wac1_threshold=0))
        r = s.solve(timeout_s=60, chunk=8)
        assert r.status == "optimal" and r.objective == -4, mode
        assert r.nodes < 500, (mode, r.nodes)


def test_low_cap_partition_exact_with_steal():
    """Round-4 fuzz finding: at low fixpoint caps, held dive lanes can
    linger inside a subproblem range another lane already counted as
    skipped (its dead subtree covered handed-out subproblems). The
    steal-freeze snapshot must therefore derive the outstanding coarse
    count as total-solved-skipped, NOT as the unique-subp count of the
    non-idle lanes (which double-counts those lanes): solved+skipped
    must partition the space exactly at every cap."""
    tnf = model("golomb6")
    for cap in (2, 3, 16):
        s = BatchedSolver(tnf, EngineConfig(
            num_dives=16, fp_max_iters=16, use_table=False,
            fp_cap_auto=False))
        r = s.solve(timeout_s=300, chunk=8, fp_cap=cap)
        assert r.status == "optimal" and r.objective == OPTIMUM[6], cap
        assert r.exhaustive, cap
        assert (r.eps_solved_subproblems + r.eps_skipped_subproblems
                == r.eps_num_subproblems), (
            cap, r.eps_solved_subproblems, r.eps_skipped_subproblems,
            r.eps_num_subproblems)


def test_auto_cap_calibration():
    """The live fixpoint-cap sweep (AutoCapCalibrator): on a run long
    enough to finish calibrating, a winner is locked in, the answer is
    exact, and the tree equals the fixed-cap tree (the hold rule keeps
    the search tree the exact AC-1 fixpoint tree at every cap)."""
    tnf = compile_model(parse_fzn(GOLOMB8))
    s = BatchedSolver(tnf, EngineConfig(num_dives=16, fp_max_iters=16))
    r = s.solve(timeout_s=25, chunk=8)
    assert getattr(s, "last_auto_cap", None) in (2, 3, 4, 8, 16)
    # Any incumbent must be a valid bound >= the known optimum.
    if r.objective is not None:
        assert r.objective >= OPTIMUM[8]
    # Explicit override disables calibration.
    s2 = BatchedSolver(tnf, EngineConfig(num_dives=16, fp_max_iters=16))
    r2 = s2.solve(timeout_s=5, chunk=8, fp_cap=4)
    assert getattr(s2, "last_auto_cap", None) is None
