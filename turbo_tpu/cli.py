"""turbo-tpu command line entry point.

Pipeline mirrors the reference's `main` (src/turbo.cpp:22-55):
parse flags -> parse model -> preprocess/compile -> dispatch to an
architecture -> print solutions + MiniZinc statistics.
"""
from __future__ import annotations

import sys
import time

from .frontend.fzn import parse_fzn
from .compile.model import compile_model
from .utils.config import Configuration, parse_args
from .utils.output import (MznStats, print_final_separator,
                           print_mzn_statistics, print_solution)


def run(cfg: Configuration) -> int:
    if cfg.hosts > 1 and cfg.host_id != 0:
        # SPMD convention: every host parses/compiles/solves, only host
        # 0 speaks on stdout (solns2out must see exactly one stream).
        # FD-level dup2, not sys.stdout: native libs (gloo's rendezvous
        # banner) write straight to fd 1.
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
    stats = MznStats(cfg.print_statistics)
    t0 = time.monotonic()
    if cfg.arch == "cpu":
        hardware = "cpu"  # the sequential numpy oracle uses no device
    elif cfg.hosts > 1:
        # jax.distributed.initialize must precede the first device
        # lookup, so the backend is only named after the rendezvous.
        hardware = cfg.platform or "distributed"
    else:
        from .utils.device import device_description, select_platform

        select_platform(cfg.platform)
        hardware = device_description()
    # Config echo (turbo.cpp:27, config.hpp:237-266).
    stats.stat("command_line", f'"turbo-tpu {cfg.problem_path}"')
    stats.stat("problem_path", f'"{cfg.problem_path}"')
    stats.stat("solver", '"turbo-tpu"')
    from . import __version__
    stats.stat("version", f'"{cfg.version_tag or __version__}"')
    stats.stat("hardware", f'"{cfg.hardware or hardware}"')
    stats.stat("arch", f'"{cfg.arch}"')
    # Echo the requested fixpoint policy (config.hpp:243-247); the cpu
    # oracle always runs ac1, like the reference's CPU arch.
    stats.stat("fixpoint",
               f'"{cfg.fixpoint if cfg.arch != "cpu" else "ac1"}"')
    if cfg.fixpoint == "wac1" and cfg.arch != "cpu":
        stats.stat("wac1_threshold", cfg.wac1_threshold)
    stats.stat("subproblems_factor", cfg.subproblems_factor)
    stats.stat("seed", cfg.seed)
    stats.stat("eps_var_order", f'"{cfg.eps_var_order}"')
    stats.stat("eps_value_order", f'"{cfg.eps_value_order}"')
    stats.stat("free_search", '"yes"' if cfg.free_search else '"no"')
    stats.stat("or_nodes", cfg.or_nodes)
    stats.stat("timeout_ms", cfg.timeout_ms)
    stats.stat("cutnodes", cfg.stop_after_n_nodes or 0)
    # Input-format sniffing by extension (config.hpp:268-279).
    if cfg.problem_path.endswith(".xml"):
        from .frontend.xcsp3 import parse_xcsp3

        model = parse_xcsp3(cfg.problem_path)
    else:
        model = parse_fzn(cfg.problem_path)
    stats.stat("parsed_variables", len(model.vars))
    stats.stat("parsed_constraints", len(model.constraints))
    if cfg.free_search:
        model.solve.searches = []
    if cfg.print_ast:
        # -ast: print the parsed model (config.cpp:17 "print the AST").
        for v in model.vars:
            dom = f"{v.lb}..{v.ub}" if not v.is_bool else "bool"
            print(f"var {dom}: {v.name};")
        for con in model.constraints:
            print(f"constraint {con.name}{tuple(con.args)!r};")
        print(f"solve {model.solve.kind}"
              + (f" {model.solve.objective};" if model.solve.objective
                 else ";"))
    tnf = compile_model(model)
    stats.stat("variables", tnf.num_vars)
    stats.stat("propagators", tnf.num_props)
    if cfg.print_statistics and not cfg.disable_network_analysis:
        from .compile.analyze import print_analysis

        print_analysis(stats, model, tnf)
    init_time = time.monotonic() - t0
    stats.stat("initTime", f"{init_time:.3f}")
    if cfg.verbose:
        print(f"% compiled: {tnf.num_vars} vars, {tnf.num_props} propagators "
              f"in {init_time:.2f}s", file=sys.stderr)

    timeout_s = (cfg.timeout_ms / 1000.0 - init_time) if cfg.timeout_ms else 1e18
    timeout_s = max(timeout_s, 0.5)
    node_limit = cfg.stop_after_n_nodes or (1 << 62)

    if cfg.arch == "cpu":
        from .solver import oracle

        printer = None
        if cfg.print_intermediate or not tnf.obj_var >= 0:
            def printer(blb, bub):
                print_solution(tnf, blb)
        r = oracle.solve(tnf, timeout_s=timeout_s,
                         stop_after_n_solutions=cfg.stop_after_n_solutions,
                         node_limit=node_limit,
                         print_intermediate=printer)
        result = r
        stats_obj = r.stats
        best = r.best_lb
        if best is not None and printer is None:
            print_solution(tnf, best)
        print_final_separator(r.status, tnf.obj_var >= 0,
                              exhaustive=r.stats.exhaustive)
        if cfg.print_statistics:
            # Adapt the oracle result to the shared stat block (the
            # reference's cpu arch prints the same keys as the GPU
            # archs, statistics.hpp:338-371; num_blocks=1).
            import types

            s = stats_obj
            adapter = types.SimpleNamespace(
                nodes=s.nodes, fails=s.fails, depth_max=s.depth_max,
                init_time=round(init_time, 3),
                solve_time=s.solve_time, solutions=s.solutions,
                eps_num_subproblems=1, eps_solved_subproblems=1,
                eps_skipped_subproblems=0,
                fixpoint_iterations=s.fixpoint_iterations,
                num_deductions=s.num_deductions,
                num_blocks=1, num_blocks_done=int(s.exhaustive),
                variables=tnf.num_vars, propagators=tnf.num_props,
                search_time=s.search_time, fixpoint_time=s.fixpoint_time,
                dive_time=0.0, transfer_cpu2gpu_time=0.0,
                transfer_gpu2cpu_time=0.0,
                select_fp_functions_time=s.select_fp_functions_time,
                wait_cpu_time=0.0, first_block_idle_time=s.solve_time,
                cumulative_time_block_sec=s.solve_time,
                deductions_per_block_second=(
                    s.num_deductions / s.solve_time
                    if s.solve_time > 0 else 0.0),
                best_obj_time=s.best_obj_time,
                objective=r.objective)
            print_mzn_statistics(stats, adapter)
        return 0

    # Multi-host run: rendezvous over jax.distributed BEFORE any other
    # backend use (initialize() must precede the first device lookup).
    if cfg.hosts > 1:
        if not cfg.coordinator:
            raise ValueError("-hosts > 1 requires -coordinator HOST:PORT "
                             "(or TURBO_TPU_COORDINATOR)")
        import jax

        if cfg.platform:
            jax.config.update("jax_platforms", cfg.platform)
        from .parallel.multihost import MultiHostSolver, init_distributed

        init_distributed(cfg.coordinator, cfg.hosts, cfg.host_id)
        enumerate_all = tnf.obj_var < 0 and cfg.stop_after_n_solutions != 1
        if enumerate_all:
            raise ValueError("-a is not supported by the multi-host "
                             "architecture; run it on a single host")
        from .solver.engine import EngineConfig as _EC
        num_dives = cfg.or_nodes
        if num_dives == 0:
            from .solver.plan import auto_num_dives
            num_dives = auto_num_dives(tnf)
        econf = _EC(num_dives=num_dives,
                    subproblems_power=cfg.subproblems_power,
                    subproblems_factor=cfg.subproblems_factor,
                    max_depth=cfg.max_depth,
                    eps_var_order=cfg.eps_var_order,
                    eps_value_order=cfg.eps_value_order,
                    seed=cfg.seed,
                    fp_mode=("wac1" if cfg.fixpoint == "wac1"
                             else "fixpoint"),
                    wac1_threshold=cfg.wac1_threshold,
                    disable_simplify=cfg.disable_simplify,
                    shave=cfg.shave)
        solver = MultiHostSolver(tnf, econf)
        mh_printed = [None]
        mh_improve = None
        if cfg.print_intermediate:
            # -i: the global improving solution rides the host snapshot;
            # every host calls the printer but only host 0's stdout is
            # live (the others are routed to devnull above).
            def mh_improve(best_lb_tnf):
                mh_printed[0] = list(best_lb_tnf)
                print_solution(tnf, best_lb_tnf)
        r = solver.solve(timeout_s=timeout_s,
                         stop_after_n_solutions=cfg.stop_after_n_solutions,
                         verbose=cfg.verbose >= 2,
                         on_improve=mh_improve,
                         node_limit=cfg.stop_after_n_nodes or 0,
                         checkpoint_path=cfg.checkpoint_path or "")
        r.init_time = init_time + r.warmup_time
        # Every host holds the same allgathered global result; host 0's
        # stdout is the run's output (others are routed to devnull).
        if r.best_lb is not None and mh_printed[0] != list(r.best_lb):
            print_solution(tnf, r.best_lb)
        print_final_separator(r.status, tnf.obj_var >= 0,
                              exhaustive=r.exhaustive)
        print_mzn_statistics(stats, r)
        return 0

    # Batched engine (single device or sharded mesh).
    from .solver.engine import BatchedSolver, EngineConfig

    enumerate_all = tnf.obj_var < 0 and cfg.stop_after_n_solutions != 1
    arch = cfg.arch
    num_dives = cfg.or_nodes
    if num_dives == 0:
        # -or 0 / absent: auto-size the dive batch, the analog of the
        # reference's occupancy default (barebones:527-547).
        from .solver.plan import auto_num_dives
        num_dives = auto_num_dives(tnf)
        if cfg.verbose:
            print(f"% auto-sized num_blocks={num_dives}", file=sys.stderr)
    # Per-solution streaming (-a / -i) on the batched archs: size the
    # on-device solution ring; the host loop drains it every chunk
    # (per shard on the 'multi' arch — mesh.solve on_solution).
    want_stream = ((cfg.print_intermediate or enumerate_all)
                   and arch in ("barebones", "multi"))
    ring = min(4 * num_dives, 8192) if want_stream else 0
    econf = EngineConfig(num_dives=num_dives,
                         subproblems_power=cfg.subproblems_power,
                         subproblems_factor=cfg.subproblems_factor,
                         max_depth=cfg.max_depth,
                         eps_var_order=cfg.eps_var_order,
                         eps_value_order=cfg.eps_value_order,
                         seed=cfg.seed,
                         enumerate_all=enumerate_all,
                         fp_mode=("wac1" if cfg.fixpoint == "wac1"
                                  else "fixpoint"),
                         wac1_threshold=cfg.wac1_threshold,
                         disable_simplify=cfg.disable_simplify,
                         shave=cfg.shave,
                         sol_ring_size=ring)
    if arch == "multi":
        from .parallel.mesh import ShardedSolver

        solver = ShardedSolver(tnf, econf)
    elif arch == "hybrid":
        from .solver.hybrid import HybridSolver

        solver = HybridSolver(tnf, econf)
    else:
        solver = BatchedSolver(tnf, econf)
    on_improve = None
    printed_last = [None]
    extra = {}
    if want_stream:
        # The ring streams EVERY accepted solution in device order —
        # strictly better -i/-a fidelity than the chunk-granular
        # incumbent callback (which only surfaces the latest best).
        def on_solution(lb_tnf):
            printed_last[0] = list(lb_tnf)
            print_solution(tnf, lb_tnf)
        extra["on_solution"] = on_solution
    elif cfg.print_intermediate or enumerate_all:
        def on_improve(best_lb_tnf):
            printed_last[0] = list(best_lb_tnf)
            print_solution(tnf, best_lb_tnf)
    if cfg.checkpoint_path:
        extra["checkpoint_path"] = cfg.checkpoint_path
    r = solver.solve(timeout_s=timeout_s,
                     stop_after_n_solutions=cfg.stop_after_n_solutions,
                     node_limit=cfg.stop_after_n_nodes,
                     verbose=cfg.verbose >= 2, on_improve=on_improve,
                     **extra)
    # initTime covers everything before the timed solve window: parse,
    # TNF compile, state init, XLA compile and the warm-up chunk.
    r.init_time = init_time + r.warmup_time
    # Final solution block — skipped when the intermediate printer
    # already emitted this exact store (avoids a duplicate block that
    # would miscount solutions under solns2out). In enumerate mode the
    # ring streamed EVERY accepted solution, so any final block would
    # be a duplicate regardless of which one was streamed last (the
    # multi arch interleaves shards, so last-streamed need not be the
    # reduction's pick).
    stream_complete = (enumerate_all and want_stream
                       and printed_last[0] is not None)
    if (r.best_lb is not None and printed_last[0] != list(r.best_lb)
            and not stream_complete):
        print_solution(tnf, r.best_lb)
    print_final_separator(r.status, tnf.obj_var >= 0,
                          exhaustive=r.exhaustive)
    print_mzn_statistics(stats, r)
    return 0


def main(argv=None) -> int:
    cfg = parse_args(argv)
    if cfg.arch != "cpu":
        from .utils.device import enable_compile_cache

        enable_compile_cache()
    try:
        return run(cfg)
    except Exception as e:  # mirror turbo.cpp's top-level catch
        print(f"% ERROR: {e}", file=sys.stderr)
        raise


if __name__ == "__main__":
    sys.exit(main())
