"""In-repo instances for the tests.

The Golomb rulers come from the deterministic generator in
benchmarks/gen/golomb.py (CSPLib prob006; known optima); the small
hand-written FlatZinc models below each exercise one part of the
FlatZinc surface. Their optima were found by the sequential oracle and
are checked again by every test that uses them.
"""
from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks", "gen"))

from golomb import OPTIMUM, golomb_fzn  # noqa: E402

GOLOMB8 = os.path.join(REPO, "benchmarks", "golomb8.fzn")
GOLOMB13 = os.path.join(REPO, "benchmarks", "golomb13.fzn")

# name -> (FlatZinc text, optimal objective)
MODELS = {
    # Unbounded ("var int") objective bounded only by a constraint.
    "minimize_unconstrained": ("""
var int: x :: output_var;
var 0..5: y :: output_var;
constraint int_lin_le([-1, 1], [x, y], -1);
solve minimize x;
""", 1),
    "maximize_unconstrained": ("""
var int: x :: output_var;
var 0..5: y :: output_var;
constraint int_lin_le([1, 1], [x, y], 2);
constraint int_le(-5, x);
solve maximize x;
""", 2),
    # Reified set membership.
    "reified_in": ("""
var 0..5: x :: output_var;
var bool: b :: output_var;
constraint set_in_reif(x, {1, 3, 5}, b);
constraint bool_eq(b, true);
solve minimize x;
""", 1),
    # Element over a constant table.
    "element": ("""
array [1..6] of int: t = [4, 9, 2, 9, 7, 5];
var 1..6: i :: output_var;
var 0..9: r :: output_var;
var 1..6: j :: output_var;
constraint array_int_element(i, t, r);
constraint int_ne(i, j);
constraint int_lin_le([1, 1], [i, j], 5);
constraint int_le(3, r);
solve minimize r;
""", 4),
    # Linear constraints, one of them reified.
    "linear_reif": ("""
var 0..9: a :: output_var;
var -5..5: b :: output_var;
var 0..20: c :: output_var;
var bool: r :: output_var;
constraint int_lin_le([2, -3, 1], [a, b, c], 7);
constraint int_lin_eq([1, 1, 1], [a, b, c], 12);
constraint int_lin_le_reif([4, 1], [a, c], 9, r);
constraint bool_eq(r, true);
solve minimize b;
""", 3),
    # Nonlinear arithmetic.
    "times_div": ("""
var 1..9: x :: output_var;
var 1..9: y :: output_var;
var 0..81: p :: output_var;
var 0..9: q :: output_var;
constraint int_times(x, y, p);
constraint int_div(p, 3, q);
constraint int_lin_le([-1, -1], [x, y], -7);
constraint int_le(4, q);
solve minimize p;
""", 12),
    # 0/1 knapsack, maximised.
    "knapsack": ("""
array [1..6] of int: w = [3, 4, 5, 9, 4, 2];
array [1..6] of int: v = [3, 5, 6, 10, 4, 2];
var 0..1: k1 :: output_var;
var 0..1: k2 :: output_var;
var 0..1: k3 :: output_var;
var 0..1: k4 :: output_var;
var 0..1: k5 :: output_var;
var 0..1: k6 :: output_var;
var 0..40: val :: output_var;
constraint int_lin_le(w, [k1, k2, k3, k4, k5, k6], 13);
constraint int_lin_eq([3, 5, 6, 10, 4, 2, -1], [k1, k2, k3, k4, k5, k6, val], 0);
solve maximize val;
""", 15),
    "golomb4": (golomb_fzn(4), OPTIMUM[4]),
    "golomb5": (golomb_fzn(5), OPTIMUM[5]),
    "golomb6": (golomb_fzn(6), OPTIMUM[6]),
}


def model_path(tmp_path, name: str) -> str:
    """Write MODELS[name] under tmp_path and return its path."""
    p = os.path.join(str(tmp_path), f"{name}.fzn")
    with open(p, "w") as f:
        f.write(MODELS[name][0])
    return p
