"""Golden-objective tests for the sequential oracle solver.

The expected optima are those of the in-repo instances
(tests/instances.py: Golomb rulers with CSPLib prob006's known
optima, and small hand-written models).
"""
import pytest

from turbo_tpu.frontend.fzn import parse_fzn, parse_fzn_text
from turbo_tpu.compile.model import compile_model
from turbo_tpu.solver.oracle import solve

from instances import GOLOMB8, MODELS, OPTIMUM, golomb_fzn

FAST_GOLDEN = sorted((name, opt) for name, (_, opt) in MODELS.items()) + [
    ("golomb7", OPTIMUM[7])]


@pytest.mark.parametrize("name,expected", FAST_GOLDEN, ids=[c[0] for c in FAST_GOLDEN])
def test_golden_objective(name, expected):
    text = golomb_fzn(7) if name == "golomb7" else MODELS[name][0]
    tnf = compile_model(parse_fzn_text(text))
    r = solve(tnf, timeout_s=60)
    assert r.status == "optimal"
    assert r.objective == expected


@pytest.mark.slow
def test_golden_golomb8():
    tnf = compile_model(parse_fzn(GOLOMB8))
    r = solve(tnf, timeout_s=120)
    assert r.status == "optimal" and r.objective == OPTIMUM[8]


def test_unsat():
    tnf = compile_model(parse_fzn_text(
        "var 1..3: x;\nconstraint int_le(x, 0);\nsolve satisfy;\n"))
    r = solve(tnf, timeout_s=10)
    assert r.status == "unsat"


def test_array_int_minimum_maximum():
    """array_int_minimum/maximum builtins (MiniZinc's min()/max() over
    var arrays) as balanced OP_MIN/OP_MAX fold trees."""
    from turbo_tpu.frontend.fzn import parse_fzn_text
    from turbo_tpu.compile.model import compile_model
    from turbo_tpu.solver.oracle import solve
    text = """
    var 3..9: a; var 1..7: b; var 5..6: c;
    var 0..20: lo :: output_var; var 0..20: hi :: output_var;
    constraint array_int_minimum(lo, [a, b, c]);
    constraint array_int_maximum(hi, [a, b, c]);
    constraint int_le(hi, 5);
    solve minimize lo;
    """
    r = solve(compile_model(parse_fzn_text(text)), timeout_s=30)
    # hi <= 5 forces a<=5, b<=5, c=5; min lo = min(3,1,5) = 1.
    assert r.status == "optimal" and r.objective == 1


def test_int_pow_fixed_exponent():
    from turbo_tpu.frontend.fzn import parse_fzn_text
    from turbo_tpu.compile.model import compile_model
    from turbo_tpu.solver.oracle import solve
    text = """
    var 1..5: x :: output_var; var 0..200: z;
    constraint int_pow(x, 3, z);
    constraint int_le(30, z);
    solve minimize x;
    """
    r = solve(compile_model(parse_fzn_text(text)), timeout_s=30)
    # x^3 >= 30 -> x >= 4.
    assert r.status == "optimal" and r.objective == 4


def test_int_pow_var_exponent_fails_loudly():
    import pytest as _pytest
    from turbo_tpu.frontend.fzn import parse_fzn_text
    from turbo_tpu.compile.model import compile_model
    from turbo_tpu.compile.tnf import CompileError
    text = """
    var 1..5: x; var 1..3: n; var 0..200: z;
    constraint int_pow(x, n, z);
    solve satisfy;
    """
    with _pytest.raises(CompileError):
        compile_model(parse_fzn_text(text))
