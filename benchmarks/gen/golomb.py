#!/usr/bin/env python3
"""FlatZinc generator for the Golomb ruler (CSPLib prob006).

A Golomb ruler of m marks is a set of integers 0 = x_0 < x_1 < ... <
x_{m-1} whose pairwise differences are all distinct; the problem is to
minimise its length x_{m-1}. The known optimal lengths for m = 4..13
are 6, 11, 17, 25, 34, 44, 55, 72, 85 and 106 (CSPLib prob006).

The emitted model is the standard one, flattened the way MiniZinc's
default library flattens it, using FlatZinc builtins only:

  - marks x_0..x_{m-1} in 0..m*m, with x_0 = 0 and x_i < x_{i+1};
  - one difference d_i_j = x_j - x_i per pair i < j, defined by
    ``int_lin_eq``;
  - all-different over the differences, lowered to pairwise ``int_ne``
    (MiniZinc's default decomposition);
  - the symmetry break d_0_1 < d_{m-2}_{m-1};
  - ``minimize x_{m-1}`` under ``int_search(marks, input_order,
    indomain_min, complete)``.

With ``--max-length L`` the model is the satisfaction variant: the
same constraints plus x_{m-1} <= L, and ``solve satisfy`` under the
same search annotation.

The output is a pure function of its arguments (no randomness), so the
committed instances can be regenerated byte for byte:

    python benchmarks/gen/golomb.py 13 > benchmarks/golomb13.fzn
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

# Known optimal ruler lengths (CSPLib prob006).
OPTIMUM = {4: 6, 5: 11, 6: 17, 7: 25, 8: 34, 9: 44, 10: 55, 11: 72, 12: 85,
           13: 106}


def golomb_fzn(m: int, max_length: Optional[int] = None) -> str:
    if m < 3:
        raise ValueError("a Golomb ruler model needs at least 3 marks")
    n = m * m
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    out = [f"% Golomb ruler, m = {m} marks (CSPLib prob006)"]
    for i in range(m):
        out.append(f"var 0..{n}: x_{i};")
    for i, j in pairs:
        out.append(f"var 0..{n}: d_{i}_{j} :: var_is_introduced "
                   f":: is_defined_var;")
    marks = ", ".join(f"x_{i}" for i in range(m))
    out.append(f"array [1..{m}] of var int: mark :: output_array([1..{m}]) "
               f"= [{marks}];")
    out.append("constraint int_eq(x_0, 0);")
    for i in range(m - 1):
        out.append(f"constraint int_lt(x_{i}, x_{i + 1});")
    for i, j in pairs:
        out.append(f"constraint int_lin_eq([1, -1, -1], "
                   f"[x_{j}, x_{i}, d_{i}_{j}], 0) "
                   f":: defines_var(d_{i}_{j});")
    for a in range(len(pairs)):
        i, j = pairs[a]
        for b in range(a + 1, len(pairs)):
            k, l = pairs[b]
            out.append(f"constraint int_ne(d_{i}_{j}, d_{k}_{l});")
    out.append(f"constraint int_lt(d_0_1, d_{m - 2}_{m - 1});")
    search = "int_search(mark, input_order, indomain_min, complete)"
    if max_length is None:
        out.append(f"solve :: {search} minimize x_{m - 1};")
    else:
        out.append(f"constraint int_le(x_{m - 1}, {max_length});")
        out.append(f"solve :: {search} satisfy;")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, help="number of marks")
    ap.add_argument("--max-length", type=int, default=None,
                    help="satisfaction variant: rulers of length <= L")
    a = ap.parse_args(argv)
    sys.stdout.write(golomb_fzn(a.m, a.max_length))
    return 0


if __name__ == "__main__":
    sys.exit(main())
