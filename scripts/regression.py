#!/usr/bin/env python
"""Golden-objective regression runner.

Port of the reference's test_turbo.sh (regression over a list of
`path,objective` rows with a per-instance time budget; a timeout
without a wrong bound is tolerated, a wrong bound fails —
test_turbo.sh:27-76). The default list is benchmarks/test_list.csv;
paths in a list are relative to the directory above the list's own.

Usage:
  python scripts/regression.py [--arch cpu|barebones|multi] [--timeout 60]
                               [--list benchmarks/test_list.csv] [--or 32]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

def make_solver(tnf, arch: str, or_nodes: int, disable_simplify=False):
    """Build the solver exactly as the regression runs it."""
    from turbo_tpu.solver.engine import BatchedSolver, EngineConfig
    nd = or_nodes
    if nd == 0:
        from turbo_tpu.solver.plan import auto_num_dives
        nd = auto_num_dives(tnf)
    cfgc = EngineConfig(num_dives=nd, fp_max_iters=16,
                        disable_simplify=disable_simplify)
    if arch == "multi":
        from turbo_tpu.parallel.mesh import ShardedSolver
        return ShardedSolver(tnf, cfgc)
    if arch == "hybrid":
        from turbo_tpu.solver.hybrid import HybridSolver
        return HybridSolver(tnf, cfgc)
    return BatchedSolver(tnf, cfgc)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="barebones",
                    choices=["cpu", "barebones", "multi", "hybrid"])
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--list", dest="list_path",
                    default=os.path.join(REPO, "benchmarks",
                                         "test_list.csv"))
    ap.add_argument("--or", dest="or_nodes", type=int, default=32)
    ap.add_argument("--platform", default=None,
                    help="force jax platform (e.g. cpu)")
    ap.add_argument("--disable-simplify", action="store_true",
                    help="run the reference harness's second leg "
                         "(test_turbo.sh simplify_flag sweep): same "
                         "goldens with -disable_simplify semantics")
    # Steps per device call (a traced trip count: one compile serves
    # every chunk size).
    ap.add_argument("--chunk", type=int, default=64)
    # Per-STEP fixpoint sweep cap (traced: no recompile). Under the
    # hold rule the tree is cap-invariant (tests/test_round5.py::
    # test_hold_rule_tree_invariant_across_caps) and the cap is a pure
    # throughput knob with an instance-dependent optimum; default 0 =
    # the engine's live auto-cap calibration.
    ap.add_argument("--fp-cap", type=int, default=0,
                    help="override the per-step sweep cap at solve time")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from turbo_tpu.frontend.fzn import parse_fzn
    from turbo_tpu.frontend.xcsp3 import parse_xcsp3
    from turbo_tpu.compile.model import compile_model

    base = os.path.dirname(os.path.dirname(args.list_path))
    rows = list(csv.reader(open(args.list_path)))
    failures = 0
    timeouts = 0
    for path, exp in rows:
        exp = int(exp)
        full = os.path.join(base, path)
        name = os.path.basename(path)
        t0 = time.time()
        try:
            model = parse_xcsp3(full) if full.endswith(".xml") else parse_fzn(full)
            tnf = compile_model(model)
            if args.arch == "cpu":
                from turbo_tpu.solver.oracle import solve
                r = solve(tnf, timeout_s=args.timeout)
            else:
                # Auto EPS split: the engine's root-tree probe shrinks
                # the subproblem power on tiny proof trees by itself
                # (probe_tree_power, engine.py), so no per-harness pin.
                s = make_solver(tnf, args.arch, args.or_nodes,
                                args.disable_simplify)
                kw = ({"chunk": args.chunk}
                      if args.arch in ("barebones", "multi") else {})
                if args.fp_cap and args.arch == "barebones":
                    kw["fp_cap"] = args.fp_cap
                r = s.solve(timeout_s=args.timeout, **kw)
            dt = time.time() - t0
            if r.status in ("optimal", "sat") and                     getattr(r, "best_lb", None) is not None:
                from turbo_tpu.utils.checker import check_solution
                bad = check_solution(model, tnf, r.best_lb)
                if bad:
                    failures += 1
                    print(f"FAIL {name:34s} invalid solution: {bad[:2]}")
                    continue
            # Node/EPS accounting beside each answer (solve_time
            # excludes the compile).
            extra = ""
            nodes = getattr(r, "nodes", None)
            if nodes is None:
                nodes = getattr(getattr(r, "stats", None), "nodes", 0)
            st_ = getattr(r, "solve_time", None)
            if st_ is None:
                st_ = getattr(getattr(r, "stats", None), "solve_time", 0)
            if nodes and st_:
                extra = f" nodes={nodes} ({nodes/st_:,.0f}/s)"
            sub_s = getattr(r, "eps_solved_subproblems", None)
            if sub_s is not None:
                extra += (f" sub={sub_s}+{r.eps_skipped_subproblems}skip"
                          f"/{getattr(r, 'eps_num_subproblems', 0)}")
            if r.status == "optimal" and r.objective == exp:
                print(f"OK   {name:34s} obj={r.objective} t={dt:.1f}s{extra}")
            elif r.status in ("sat", "unknown"):
                if r.objective is not None and _bound_impossible(r, exp, tnf):
                    failures += 1
                    print(f"FAIL {name:34s} bound {r.objective} contradicts "
                          f"expected {exp}")
                else:
                    timeouts += 1
                    print(f"TIME {name:34s} best={r.objective} "
                          f"t={dt:.1f}s{extra}")
            else:
                failures += 1
                print(f"FAIL {name:34s} got={r.objective} st={r.status} "
                      f"exp={exp}")
        except Exception as e:
            failures += 1
            print(f"ERR  {name:34s} {type(e).__name__}: {e}")
        sys.stdout.flush()
    print(f"\n{len(rows)} instances: {len(rows)-failures-timeouts} ok, "
          f"{timeouts} timeout, {failures} failed")
    return 1 if failures else 0


def _bound_impossible(r, exp, tnf):
    """An intermediate bound strictly better than the known optimum is a
    soundness bug (objectives: minimize prints lb; maximize prints ub)."""
    if tnf.is_max:
        return r.objective > exp
    return r.objective < exp


if __name__ == "__main__":
    sys.exit(main())
