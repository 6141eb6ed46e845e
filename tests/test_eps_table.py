"""EPS subproblem-root table (solver/eps_table.py): differential tests
against the in-engine dive path.

The table must be a pure re-expression of the dive phase: identical
optima and exhaustiveness on the goldens, and exact subproblem
accounting (solved + skipped + live partitions the 2^k space)."""
import numpy as np
import pytest

from turbo_tpu.compile.model import compile_model
from turbo_tpu.frontend.fzn import parse_fzn_text
from turbo_tpu.solver.engine import BatchedSolver, EngineConfig

from instances import MODELS, OPTIMUM, golomb_fzn

GOLDENS = [
    ("golomb7", OPTIMUM[7]),
    ("times_div", MODELS["times_div"][1]),
    ("golomb5", OPTIMUM[5]),
    ("knapsack", MODELS["knapsack"][1]),
]


def model(name):
    text = golomb_fzn(7) if name == "golomb7" else MODELS[name][0]
    return compile_model(parse_fzn_text(text))


@pytest.mark.parametrize("name,expected", GOLDENS)
def test_table_matches_dive(name, expected):
    tnf = model(name)
    results = {}
    for use_table in (False, True):
        s = BatchedSolver(tnf, EngineConfig(
            num_dives=16, fp_max_iters=16, use_table=use_table))
        assert s.use_table == use_table
        r = s.solve(timeout_s=300, chunk=8)
        assert r.status == "optimal", (name, use_table, r.status)
        assert r.objective == expected
        assert r.exhaustive
        # solved + skipped partitions the subproblem space exactly.
        assert (r.eps_solved_subproblems + r.eps_skipped_subproblems
                == r.eps_num_subproblems), (name, use_table)
        results[use_table] = r
    # The table path counts each shared dive prefix once instead of
    # once per refill, so its node count can only be <= the dive path
    # on instances large enough to refill (tiny probe-capped trees tie).
    assert results[True].nodes <= results[False].nodes * 1.05


def test_table_build_accounting():
    """Direct builder check: live + dead covers the shard range."""
    tnf = model("golomb6")
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=7,
                                        max_depth=64))
    assert s.use_table
    tb = s.get_table(0)
    assert tb.n_live + tb.solved + tb.skipped == s.num_sub_total
    assert tb.n_live <= tb.n_pad
    # Leaf bit-paths are unique and within range.
    paths = tb.path[:tb.n_live]
    assert len(np.unique(paths)) == tb.n_live
    assert paths.min() >= 0 and paths.max() < s.num_sub_total
    # Leaf stores are non-bot boxes inside the root box.
    lb, ub = tb.lb[:tb.n_live], tb.ub[:tb.n_live]
    assert (lb <= ub).all()
    assert (lb >= s.plan.lb0[None, :] - 1).all()
    assert (ub <= s.plan.ub0[None, :] + 1).all()


def test_table_mid_dive_solution_seeds_incumbent():
    """An instance whose dive tree contains entailed boxes: the builder
    must seed the incumbent (and solution store) from them."""
    # Unconstrained minimize: the root itself is entailed, so the whole
    # tree collapses during the build and the engine starts solved.
    tnf = model("minimize_unconstrained")
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, fp_max_iters=16))
    r = s.solve(timeout_s=120, chunk=4)
    assert r.status == "optimal" and r.objective == 1 and r.exhaustive


def test_table_sharded_mesh():
    """Table mode under shard_map on the 8-device CPU mesh."""
    from turbo_tpu.parallel.mesh import ShardedSolver

    tnf = model("golomb6")
    s = ShardedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=7,
                                        max_depth=64))
    assert s.solver.use_table
    r = s.solve(timeout_s=300, chunk=8)
    assert r.status == "optimal" and r.objective == OPTIMUM[6]
    assert r.exhaustive
    assert (r.eps_solved_subproblems + r.eps_skipped_subproblems
            == r.eps_num_subproblems)


def test_table_satisfaction_stop_after_one():
    """Satisfaction + table: solutions found during (or right after)
    the build stop the solve with a valid store."""
    from turbo_tpu.frontend.fzn import parse_fzn_text

    tnf = compile_model(parse_fzn_text("""
    var 1..3: x :: output_var;
    var 1..3: y :: output_var;
    constraint int_lin_le([1, 1], [x, y], 4);
    solve satisfy;
    """))
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, fp_max_iters=16))
    r = s.solve(timeout_s=120, chunk=4, stop_after_n_solutions=1)
    assert r.status == "sat"
    assert r.best_lb is not None
    assert r.best_lb[0] + r.best_lb[1] <= 4


def test_rebalance_ranges_table_mode():
    """Mesh EPS re-exchange under table mode: the receiver copies the
    donor's table and seeds its lanes straight into SOLVE phase."""
    import jax

    from turbo_tpu.parallel.mesh import ShardedSolver, rebalance_ranges

    tnf = model("golomb5")
    s = ShardedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=8,
                                        max_depth=64))
    assert s.solver.use_table
    D, S = 4, s.n_shards
    st = jax.tree.map(lambda x: np.array(x), jax.device_get(s.init_state()))
    n_pad = st.tab_lb.shape[0] // S
    # Make shard 0 dry: all IDLE, counter at its live limit.
    st.phase[0:D] = 2
    st.next_sub[0:D] = st.sub_limit[0:D]
    new, moves = rebalance_ranges(st, D, S, s.plan.lb0, s.plan.ub0,
                                  use_table=True)
    if moves == 0:
        pytest.skip("no donor had >=2 remaining rows on this split")
    # Receiver lanes are SOLVE-phase table rows of the donor's table.
    live = new.phase[0:D] != 2
    assert live.any()
    assert (new.phase[0:D][live] == 1).all()
    assert (new.remaining[0:D] == 0).all()
    # Thief's table now equals some donor's table slice.
    donors = [d for d in range(1, S)
              if (new.tab_lb[0:n_pad] == st.tab_lb[d * n_pad:(d + 1) * n_pad]).all()]
    assert donors
    d = donors[0]
    base = int(new.next_sub[0]) - int(live.sum())
    rows = np.arange(D)[live] + base
    np.testing.assert_array_equal(
        new.lb[0:D][live],
        st.tab_lb[d * n_pad:(d + 1) * n_pad][rows])
    # Ranges stay disjoint: donor limit shrank to the receiver's base.
    assert int(new.sub_limit[d * D]) == base
