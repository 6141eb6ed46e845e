#!/usr/bin/env python
"""Extended random-model differential: engine (and optionally hybrid)
vs the sequential oracle on randomly generated FlatZinc models covering
the full native-kernel surface (linears with mixed coefficients,
element, set_in/member, min/max/abs/div/mod/times, reified bools,
both objective senses, satisfaction, and random search annotations
incl. split orders).

The in-suite differentials (tests/test_engine.py) run a handful of
seeds; this harness runs hundreds in idle time. Any disagreement is a
soundness bug: it prints the full model and aborts nonzero.

  python scripts/fuzz_differential.py --trials 300 [--hybrid] [--seed 1]
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def gen_model(rng):
    n = int(rng.integers(3, 7))
    lines = []
    for i in range(n):
        lo = int(rng.integers(-4, 2))
        hi = lo + int(rng.integers(1, 7))
        lines.append(f"var {lo}..{hi}: x{i};")
    xs = ",".join(f"x{i}" for i in range(n))
    ncons = int(rng.integers(2, 6))
    for _ in range(ncons):
        kind = rng.integers(0, 8)
        a, b, c = (int(v) for v in rng.integers(0, n, size=3))
        if kind == 0:
            coeffs = rng.integers(-4, 5, size=n)
            k = int(rng.integers(-6, 16))
            cs = ",".join(str(int(v)) for v in coeffs)
            op = rng.choice(["int_lin_le", "int_lin_eq", "int_lin_ne"])
            lines.append(f"constraint {op}([{cs}], [{xs}], {k});")
        elif kind == 1:
            lines.append(f"constraint int_times(x{a}, x{b}, x{c});")
        elif kind == 2:
            lines.append(f"constraint int_max(x{a}, x{b}, x{c});")
        elif kind == 3:
            lines.append(f"constraint int_abs(x{a}, x{b});")
        elif kind == 4:
            tab = ",".join(str(int(v)) for v in rng.integers(-3, 6,
                                                             size=4))
            lines.append(f"var 1..4: i{len(lines)};")
            lines.append(f"constraint array_int_element(i{len(lines)-1}, "
                         f"[{tab}], x{a});")
        elif kind == 5:
            vals = sorted(set(int(v) for v in rng.integers(-3, 6, size=3)))
            vs = ",".join(str(v) for v in vals)
            lines.append(f"constraint set_in(x{a}, {{{vs}}});")
        elif kind == 6:
            lines.append(f"var bool: b{len(lines)};")
            lines.append(f"constraint int_le_reif(x{a}, x{b}, "
                         f"b{len(lines)-1});")
        else:
            d = int(rng.integers(1, 4))
            lines.append(f"constraint int_div(x{a}, {d}, x{b});")
    var_ord = rng.choice(["input_order", "first_fail", "smallest"])
    val_ord = rng.choice(["indomain_min", "indomain_max",
                          "indomain_split", "indomain_reverse_split"])
    sense = rng.integers(0, 3)
    ann = f":: int_search([{xs}], {var_ord}, {val_ord}, complete) "
    if sense == 0:
        lines.append(f"solve {ann}minimize x{int(rng.integers(0, n))};")
    elif sense == 1:
        lines.append(f"solve {ann}maximize x{int(rng.integers(0, n))};")
    else:
        lines.append(f"solve {ann}satisfy;")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=300)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--hybrid", action="store_true")
    ap.add_argument("--checkpoint", action="store_true",
                    help="also run an interrupt(node_limit)+resume pass "
                         "per trial and require the same answer")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from turbo_tpu.compile.model import CompileError, compile_model
    from turbo_tpu.frontend.fzn import parse_fzn_text
    from turbo_tpu.solver.engine import BatchedSolver, EngineConfig
    from turbo_tpu.solver.oracle import solve as oracle_solve

    rng = np.random.default_rng(args.seed)
    bad = 0
    for trial in range(args.trials):
        text = gen_model(rng)
        try:
            tnf = compile_model(parse_fzn_text(text))
        except CompileError:
            continue
        ro = oracle_solve(tnf, timeout_s=60)
        if tnf.obj_var < 0 and rng.integers(0, 2):
            # Enumeration-streaming differential (-a on the batched
            # arch, VERDICT r3 item 6): every assignment the oracle
            # enumerates must be streamed through the solution ring
            # exactly once, each a valid distinct solution.
            roa = oracle_solve(tnf, timeout_s=60,
                               stop_after_n_solutions=0)
            if roa.stats.exhaustive:
                got = []
                sa = BatchedSolver(tnf, EngineConfig(
                    num_dives=4,
                    subproblems_power=int(rng.integers(2, 6)),
                    max_depth=0, enumerate_all=True, sol_ring_size=64))
                ra = sa.solve(
                    timeout_s=120, chunk=8, stop_after_n_solutions=0,
                    on_solution=lambda lb: got.append(
                        tuple(int(v) for v in lb)))
                from turbo_tpu.utils.checker import check_solution
                invalid = [g for g in got
                           if check_solution(parse_fzn_text(text), tnf,
                                             np.asarray(g))]
                if (ra.solutions != roa.stats.solutions
                        or len(got) != ra.solutions
                        or len(set(got)) != len(got) or invalid):
                    bad += 1
                    print(f"ENUM MISMATCH trial={trial}: oracle="
                          f"{roa.stats.solutions} engine={ra.solutions} "
                          f"streamed={len(got)} distinct={len(set(got))} "
                          f"invalid={len(invalid)}\n{text}\n", flush=True)
        if ro.status not in ("optimal", "unsat"):
            continue  # oracle timeout: no golden to compare
        # Fuzz the fixpoint variants too: each must have the same
        # soundness mileage as the default path. fp_layout only exists
        # on the ac1 path (wac1 ignores it), so sample the 3 real
        # configurations.
        fp_mode, fp_layout = [("fixpoint", "dv"), ("fixpoint", "vd"),
                              ("wac1", "dv")][int(rng.integers(0, 3))]
        s = BatchedSolver(tnf, EngineConfig(
            num_dives=4, subproblems_power=int(rng.integers(2, 6)),
            max_depth=0, fp_max_iters=int(rng.choice([8, 16, 10000])),
            fp_mode=fp_mode, fp_layout=fp_layout,
            # EPS table axis: the precomputed dive tree must agree
            # with the in-engine dive path on every random model.
            use_table=bool(rng.integers(0, 2))))
        re = s.solve(timeout_s=120, chunk=8)
        solvers = [("engine", re)]
        if args.checkpoint and ro.status == "optimal" and re.nodes > 8:
            import tempfile

            cfg2 = EngineConfig(num_dives=4, subproblems_power=4,
                                max_depth=0)
            with tempfile.TemporaryDirectory() as td:
                ck = f"{td}/ck.pkl"
                BatchedSolver(tnf, cfg2).solve(
                    timeout_s=120, node_limit=max(8, re.nodes // 2),
                    checkpoint_path=ck)
                rr = BatchedSolver(tnf, cfg2).solve(timeout_s=120,
                                                    checkpoint_path=ck)
            solvers.append(("resume", rr))
        if args.hybrid:
            from turbo_tpu.solver.hybrid import HybridSolver
            rh = HybridSolver(tnf, EngineConfig(
                num_dives=4, subproblems_power=4, max_depth=0)).solve(
                    timeout_s=120)
            solvers.append(("hybrid", rh))
        for name, r in solvers:
            ok = (r.status == ro.status
                  and (r.objective == ro.objective
                       or ro.status == "unsat"))
            if not ok:
                bad += 1
                print(f"MISMATCH trial={trial} arch={name}: oracle="
                      f"{ro.status}/{ro.objective} got={r.status}/"
                      f"{r.objective}\n{text}\n", flush=True)
        if trial % 20 == 19:
            print(f"% {trial+1}/{args.trials} done, {bad} mismatches",
                  flush=True)
    print(f"{args.trials} trials, {bad} mismatches")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
