"""Engine hardening: table-build deadline fallback, wall-clock hard
limit, auto-cap sample accumulation, re-calibration on drain, and the
table_build_time stat."""
import io
import time
import types

import numpy as np
import pytest

from turbo_tpu.compile.model import compile_model
from turbo_tpu.frontend.fzn import parse_fzn_text
from turbo_tpu.solver.engine import (AutoCapCalibrator, BatchedSolver,
                                     EngineConfig)

from instances import MODELS


def model(name):
    return compile_model(parse_fzn_text(MODELS[name][0]))


def test_table_deadline_falls_back_to_dive_mode():
    """A table build that overruns its deadline must abandon cleanly:
    the solver flips to dive-mode refills, still proves the optimum,
    and charges the wasted build time to the solve budget."""
    tnf = model("golomb6")
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=7,
                                        max_depth=64))
    assert s.use_table
    s._table_deadline = s.clock() - 1.0  # already expired
    r = s.solve(timeout_s=300, chunk=8)
    assert not s.use_table
    assert r.status == "optimal" and r.exhaustive
    assert r.objective == MODELS["golomb6"][1]
    # The aborted build's wall time is charged as table/dive time.
    assert r.table_build_time > 0.0
    assert r.dive_time >= r.table_build_time
    assert (r.eps_solved_subproblems + r.eps_skipped_subproblems
            == r.eps_num_subproblems)


def test_table_deadline_mesh_consistent_fallback():
    """On the sharded mesh a mid-loop fallback must rebuild EVERY shard
    in dive mode (mixed leaf shapes would break the concatenation)."""
    from turbo_tpu.parallel.mesh import ShardedSolver

    tnf = model("golomb6")
    s = ShardedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=7,
                                        max_depth=64))
    assert s.solver.use_table
    s.solver._table_deadline = s.solver.clock() - 1.0
    r = s.solve(timeout_s=300, chunk=8)
    assert not s.solver.use_table
    assert r.status == "optimal" and r.exhaustive
    assert r.objective == MODELS["golomb6"][1]


def test_generous_deadline_keeps_table_mode():
    """A deadline the build comfortably meets must not disable tables."""
    tnf = model("knapsack")
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, fp_max_iters=16))
    assert s.use_table
    s._table_deadline = s.clock() + 600.0
    r = s.solve(timeout_s=300, chunk=8)
    assert s.use_table
    assert r.status == "optimal" and r.objective == MODELS["knapsack"][1]


class _CapState(types.SimpleNamespace):
    def _replace(self, **kw):
        d = dict(self.__dict__)
        d.update(kw)
        return _CapState(**d)


def _cap_state():
    import jax.numpy as jnp
    return _CapState(fp_cap=jnp.full((4,), 16, dtype=jnp.int32))


def test_calibrator_accumulates_short_samples(monkeypatch):
    """One sub-threshold chunk must NOT lock a rate sample; the
    calibrator keeps sampling the active candidate until it has
    min_sample_s of device time (single short samples are too noisy
    to lock the knob on)."""
    monkeypatch.setenv("TURBO_TPU_CAL_SAMPLE_S", "0.4")
    cfg = EngineConfig(fp_max_iters=16)
    cal = AutoCapCalibrator(cfg, 0)
    assert cal.active == 2
    st = _cap_state()
    st, _ = cal.observe(st, 0, 0.0, warmup=True)
    # Three short chunks: still sampling cap 2 (0.3 s < 0.4 s, 3 < 4).
    for i in range(3):
        st, _ = cal.observe(st, 100 * (i + 1), 0.1, warmup=False)
        assert cal.active == 2
    assert 2 not in cal.rates
    # Fourth chunk crosses max_sample_chunks: cap 2 locks, ladder moves.
    st, _ = cal.observe(st, 400, 0.1, warmup=False)
    assert 2 in cal.rates
    assert cal.rates[2] == pytest.approx(400 / 0.4)
    assert cal.active == 3
    assert int(st.fp_cap[0]) == 3


def test_calibrator_picks_argmax(monkeypatch):
    """Synthetic rates: the ladder must lock the argmax cap."""
    monkeypatch.setenv("TURBO_TPU_CAL_SAMPLE_S", "0.0")
    cfg = EngineConfig(fp_max_iters=16)
    cal = AutoCapCalibrator(cfg, 0)
    st = _cap_state()
    st, _ = cal.observe(st, 0, 0.0, warmup=True)
    # nodes/s per cap: 2 -> 100, 3 -> 300, 4 -> 200 (declines, 8/16
    # skipped by the early stop since 200 < 0.7 * 300).
    rates = {2: 100, 3: 300, 4: 200}
    tot = 0
    while not cal.done:
        tot += rates[cal.active]
        st, _ = cal.observe(st, tot, 1.0, warmup=False)
    assert cal.chosen == 3
    assert int(st.fp_cap[0]) == 3


def test_budgets_exclude_compile_time(monkeypatch):
    """A cold XLA compile must not eat the -t budgets: with every
    compile slowed by 2.5 s, a 3 s timeout (table deadline 2 s, hard
    wall 6 s) still builds the EPS table and proves the optimum."""
    import jax

    orig = jax.stages.Lowered.compile

    def slow_compile(self, *a, **k):
        time.sleep(2.5)
        return orig(self, *a, **k)

    monkeypatch.setattr(jax.stages.Lowered, "compile", slow_compile)
    tnf = model("knapsack")
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, fp_max_iters=16))
    r = s.solve(timeout_s=3.0, chunk=8)
    assert s.use_table
    assert s.compile_s >= 3 * 2.5  # table, init and step programs
    assert r.status == "optimal" and r.objective == MODELS["knapsack"][1]


def test_hard_wall_stops_runaway(monkeypatch):
    """With a microscopic hard-wall multiple the loop must stop after
    the first chunk instead of running the full solve budget."""
    monkeypatch.setenv("TURBO_TPU_HARD_WALL_MULT", "0.0001")
    tnf = model("golomb6")
    s = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=7,
                                        max_depth=64, use_table=False))
    t0 = time.monotonic()
    r = s.solve(timeout_s=3600, chunk=1)
    assert not r.exhaustive
    assert time.monotonic() - t0 < 120  # compile + one chunk, not 3600 s


def test_hard_wall_disabled_by_zero(monkeypatch):
    monkeypatch.setenv("TURBO_TPU_HARD_WALL_MULT", "0")
    tnf = model("knapsack")
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, fp_max_iters=16))
    r = s.solve(timeout_s=300, chunk=8)
    assert r.status == "optimal" and r.objective == MODELS["knapsack"][1]


def test_table_build_time_stat_emitted():
    from turbo_tpu.utils.output import MznStats, print_mzn_statistics

    buf = io.StringIO()
    stats = MznStats(True, file=buf)
    r = types.SimpleNamespace(
        nodes=1, fails=0, depth_max=0, solve_time=1.0, solutions=1,
        eps_num_subproblems=1, eps_solved_subproblems=1,
        eps_skipped_subproblems=0, fixpoint_iterations=1,
        num_deductions=1.0, objective=None, table_build_time=0.25,
        dive_time=0.3)
    print_mzn_statistics(stats, r)
    out = buf.getvalue()
    assert "%%%mzn-stat: table_build_time=0.250000" in out
    assert "%%%mzn-stat: dive_time=0.300000" in out


def test_host_nodes_stat_emitted():
    from turbo_tpu.utils.output import MznStats, print_mzn_statistics

    buf = io.StringIO()
    r = types.SimpleNamespace(
        nodes=10, fails=0, depth_max=0, solve_time=1.0, solutions=1,
        eps_num_subproblems=1, eps_solved_subproblems=1,
        eps_skipped_subproblems=0, fixpoint_iterations=1,
        num_deductions=1.0, objective=None, host_nodes=[3, 7])
    print_mzn_statistics(MznStats(True, file=buf), r)
    assert '%%%mzn-stat: host_nodes="3,7"' in buf.getvalue()


def test_recalibration_on_drain(monkeypatch):
    """After the subproblem range drains, a second calibration ladder
    runs once (phase-change re-calibration)."""
    import turbo_tpu.solver.engine as eng

    monkeypatch.setenv("TURBO_TPU_CAL_SAMPLE_S", "0.0")
    created = []
    orig = eng.AutoCapCalibrator

    class Counting(orig):
        def __init__(self, cfg, fp_cap_override):
            super().__init__(cfg, fp_cap_override)
            created.append(self)

    monkeypatch.setattr(eng, "AutoCapCalibrator", Counting)
    tnf = model("golomb6")
    s = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=7,
                                        max_depth=64, use_table=False))
    r = s.solve(timeout_s=300, chunk=1)
    assert r.status == "optimal" and r.objective == MODELS["golomb6"][1]
    # At least the initial calibrator ran; if the run was long enough to
    # observe an undrained chunk followed by a drained one, the recal
    # fired exactly once more.
    assert 1 <= len(created) <= 2
    if len(created) == 2:
        assert created[0].done and created[1].done


def test_mesh_solution_ring_streams_per_shard():
    """-a on the 'multi' arch: per-shard solution rings drain through
    on_solution with none lost."""
    from turbo_tpu.parallel.mesh import ShardedSolver

    tnf = compile_model(parse_fzn_text("""
var 1..4: x :: output_var; var 1..4: y :: output_var;
constraint int_lt(x, y);
solve satisfy;
"""))
    cfg = EngineConfig(num_dives=2, subproblems_power=4, max_depth=64,
                       fp_max_iters=32, enumerate_all=True,
                       sol_ring_size=8)
    got = []
    s = ShardedSolver(tnf, cfg)
    r = s.solve(timeout_s=120, stop_after_n_solutions=0,
                on_solution=lambda lb: got.append((int(lb[0]), int(lb[1]))))
    assert r.solutions == 6
    assert sorted(set(got)) == [(1, 2), (1, 3), (1, 4), (2, 3), (2, 4),
                                (3, 4)]
    assert len(got) == 6


def test_mesh_ring_respects_n_budget():
    """-n 2 on the multi arch: the global print budget stops streaming
    at exactly two solutions even when shards hold more."""
    from turbo_tpu.parallel.mesh import ShardedSolver

    tnf = compile_model(parse_fzn_text("""
var 1..4: x :: output_var; var 1..4: y :: output_var;
constraint int_lt(x, y);
solve satisfy;
"""))
    cfg = EngineConfig(num_dives=2, subproblems_power=4, max_depth=64,
                       fp_max_iters=32, enumerate_all=True,
                       sol_ring_size=8)
    got = []
    s = ShardedSolver(tnf, cfg)
    s.solve(timeout_s=120, stop_after_n_solutions=2,
            on_solution=lambda lb: got.append((int(lb[0]), int(lb[1]))))
    assert len(got) == 2


def test_cli_enumerate_no_duplicate_final_block(tmp_path, capsys):
    """-a must print each solution exactly once: the final-block dedup
    can't rely on the LAST streamed solution being the reduction's pick
    (the multi arch interleaves shards)."""
    from turbo_tpu.cli import main

    fzn = tmp_path / "enum.fzn"
    fzn.write_text("""
var 1..4: x :: output_var;
var 1..4: y :: output_var;
constraint int_lt(x, y);
solve satisfy;
""")
    for arch in ("barebones", "multi"):
        main([str(fzn), "-arch", arch, "-or", "2", "-sub", "4", "-a",
              "-t", "60000"])
        out = capsys.readouterr().out
        assert out.count("----------") == 6, (arch, out)
        assert "==========" in out


def test_hold_rule_tree_invariant_across_caps():
    """DESIGN.md's hold-rule claim, as an in-tree artifact: the proof
    tree node count is IDENTICAL at every fixpoint cap — branching only
    ever happens at the true AC-1 fixpoint store, held lanes just take
    more steps to get there. (Across lanes a cap can still shift when
    an incumbent arrives, and so what it prunes: golomb6 at 16 lanes
    gives 496 nodes at cap 2 and 498 at cap 4.)"""
    tnf = model("golomb5")
    nodes = {}
    for cap in (2, 4, 16):
        s = BatchedSolver(tnf, EngineConfig(
            num_dives=16, fp_max_iters=16, use_table=False,
            fp_cap_auto=False))
        r = s.solve(timeout_s=300, chunk=8, fp_cap=cap)
        assert r.status == "optimal" and r.exhaustive
        assert r.objective == MODELS["golomb5"][1]
        nodes[cap] = r.nodes
    assert len(set(nodes.values())) == 1, nodes
