"""Parser + TNF compiler tests over the in-repo instances."""
import glob
import os

import numpy as np
import pytest

from turbo_tpu.frontend.fzn import parse_fzn, parse_fzn_text
from turbo_tpu.compile.model import compile_model
from turbo_tpu.core.ops import INF, NINF

from instances import MODELS, OPTIMUM, REPO, golomb_fzn


def _fixtures():
    """(name, path or None, text) of every in-repo FlatZinc instance."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "benchmarks", "**",
                                              "*.fzn"), recursive=True)):
        with open(path) as f:
            out.append((os.path.basename(path), path, f.read()))
    out += [(f"{name}.fzn", None, text)
            for name, (text, _) in sorted(MODELS.items())]
    return out


FIXTURES = _fixtures()
IDS = [f[0] for f in FIXTURES]


def _parse(fixture):
    _, path, text = fixture
    return parse_fzn(path) if path else parse_fzn_text(text)


@pytest.mark.parametrize("fixture", FIXTURES, ids=IDS)
def test_parse_all_fixtures(fixture):
    m = _parse(fixture)
    assert m.solve.kind in ("satisfy", "minimize", "maximize")


@pytest.mark.parametrize("fixture", FIXTURES, ids=IDS)
def test_compile_all_fixtures(fixture):
    tnf = compile_model(_parse(fixture))
    V, P = tnf.num_vars, tnf.num_props
    assert (tnf.lb0 <= tnf.ub0).all() or tnf.root_unsat
    if P:
        for arr in (tnf.xs, tnf.ys, tnf.zs):
            assert arr.min() >= 0 and arr.max() < V


def test_parse_basics():
    m = parse_fzn_text(
        """
        var 1..9: x :: output_var;
        var bool: b;
        array [1..2] of int: c = [2,-3];
        constraint int_lin_le(c, [x, x], 7);
        solve :: int_search([x], first_fail, indomain_min, complete) minimize x;
        """
    )
    assert len(m.vars) == 2
    assert m.vars[0].lb == 1 and m.vars[0].ub == 9
    assert m.solve.kind == "minimize"
    assert m.solve.searches[0].var_order == "first_fail"


def test_sparse_domain_membership():
    tnf = compile_model(parse_fzn_text(
        "var {1,3,7}: x :: output_var;\nsolve maximize x;"))
    assert not tnf.root_unsat
    # Hull bounds 1..7 at the variable.
    assert tnf.lb0[tnf.orig_obj_var] == 1
    assert tnf.ub0[tnf.orig_obj_var] == 7


def test_trivially_false():
    tnf = compile_model(parse_fzn_text(
        "constraint bool_eq(false, true);\nsolve satisfy;"))
    assert tnf.root_unsat


def test_cse_dedups_shared_linear_terms():
    t1 = compile_model(parse_fzn_text(
        """
        var 0..9: x; var 0..9: y :: output_var;
        array [1..2] of int: c = [2,3];
        constraint int_lin_le(c, [x,y], 20);
        constraint int_lin_le(c, [x,y], 15);
        solve minimize y;
        """
    ))
    t2 = compile_model(parse_fzn_text(
        """
        var 0..9: x; var 0..9: y :: output_var;
        array [1..2] of int: c = [2,3];
        constraint int_lin_le(c, [x,y], 20);
        solve minimize y;
        """
    ))
    # The duplicate lin_le shares the whole sum tree: no extra props,
    # the tighter bound lands in the domain meet.
    assert t1.num_props == t2.num_props


@pytest.mark.parametrize("fixture", FIXTURES, ids=IDS)
def test_native_parser_matches_python(fixture):
    from turbo_tpu.frontend.fzn import parse_fzn, parse_fzn_text
    from turbo_tpu.frontend.native import parse_fzn_native

    path, text = fixture[0], fixture[2]
    mp = parse_fzn_text(text, path)
    mn = parse_fzn_native(text, path)
    if mn is None:
        pytest.skip("native parser unavailable")
    assert [(v.name, v.is_bool, v.lb, v.ub, v.sparse, v.output_var, v.alias)
            for v in mp.vars] == \
           [(v.name, v.is_bool, v.lb, v.ub, v.sparse, v.output_var, v.alias)
            for v in mn.vars]
    assert [(c.name, repr(c.args), c.defines) for c in mp.constraints] == \
           [(c.name, repr(c.args), c.defines) for c in mn.constraints]
    assert mp.solve == mn.solve


def test_search_annotation_array_expansion():
    """Search annotations naming a var ARRAY must expand to its
    elements, for each int_search of a seq_search (an empty strategy
    would degrade search to the default order)."""
    text = golomb_fzn(6).replace(
        "solve :: int_search(mark, input_order, indomain_min, complete)",
        "array [1..2] of var int: ends = [x_1, x_5];\n"
        "solve :: seq_search([int_search(ends, smallest, indomain_min, "
        "complete), int_search(mark, input_order, indomain_min, "
        "complete)])")
    tnf = compile_model(parse_fzn_text(text))
    assert len(tnf.strategies) == 3  # two annotated + the fallback
    assert len(tnf.strategies[0].var_ids) == 2
    assert len(tnf.strategies[1].var_ids) == 6
    assert tnf.strategies[0].var_order == "smallest"


def test_golomb6_proves_with_annotated_search():
    from turbo_tpu.solver.oracle import solve
    tnf = compile_model(parse_fzn_text(golomb_fzn(6)))
    r = solve(tnf, timeout_s=60)
    assert r.status == "optimal" and r.objective == OPTIMUM[6]
    assert r.stats.nodes < 1000


def test_unsolved_bugs_fixtures_handled():
    """The kinds of instance the reference lists as known-bad must not
    crash the frontend/compiler: a trivially false model is unsat,
    huge domains parse and compile under the clamped +-2^30 universe,
    and raw set VARIABLES (which the reference also cannot represent —
    its mzn-lib routes sets through nosets.mzn) fail with an explicit
    diagnostic."""
    from turbo_tpu.frontend.fzn import FznParseError
    from turbo_tpu.solver.oracle import solve

    false = "var 1..3: x;\nconstraint int_lt(x, 1);\nsolve satisfy;\n"
    r = solve(compile_model(parse_fzn_text(false)), timeout_s=10)
    assert r.status == "unsat"

    bigdom = ("var -2000000000..2000000000: x :: output_var;\n"
              "var -2000000000..2000000000: y;\n"
              "constraint int_lin_le([1, 1], [x, y], 5);\n"
              "solve minimize x;\n")
    tnf = compile_model(parse_fzn_text(bigdom))
    assert tnf.num_vars > 0

    with pytest.raises(FznParseError):
        parse_fzn_text("var set of 1..3: s;\nsolve satisfy;\n")
