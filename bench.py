#!/usr/bin/env python
"""Benchmark driver: batched dive-and-solve throughput on one device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "nodes/s", "device": {...}, ...}

Metric: search nodes per second on the full-width Golomb ruler
(benchmarks/golomb13.fzn) over a steady-state window after the compile,
matching the reference's `nodes` / `solveTime` statistics definition
(statistics.hpp:340-346), with the bound trajectory beside it (nodes/s
alone rewards a weaker fixpoint). The line names the device it ran on
and, on a GPU, the card's name and power limit from nvidia-smi.

Every stage announces its start and finish on stderr. The run fails
unless JAX's default device is a GPU.

    python bench.py
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

INSTANCE = os.environ.get(
    "BENCH_INSTANCE", os.path.join(REPO, "benchmarks", "golomb13.fzn"))
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1500"))
MEASURE_S = float(os.environ.get("BENCH_MEASURE_S", "60"))
DIVES = int(os.environ.get("BENCH_DIVES", "256"))
# Fixed per-step fixpoint cap, so that runs compare at one setting;
# BENCH_FP_CAP=0 sweeps CAPS and measures at the fastest.
FP_CAP = int(os.environ.get("BENCH_FP_CAP", "4"))
# Caps swept when BENCH_FP_CAP=0; ~2 s of device time each, every
# sweep chunk is real solve progress (sound at any cap — hold rule).
CAPS = [int(c) for c in os.environ.get("BENCH_CAPS", "2,3,4,8,16").split(",")]
SWEEP_S = float(os.environ.get("BENCH_SWEEP_S", "3.0"))
# Steps per device call (a traced trip count: no recompile per size).
CHUNK = int(os.environ.get("BENCH_CHUNK", "64"))
T_START = time.monotonic()


def log(msg):
    print(f"% [{time.monotonic() - T_START:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


@contextlib.contextmanager
def stage(name):
    """Announce a stage on stderr, and its duration when it ends."""
    log(f"stage: {name} ...")
    t0 = time.monotonic()
    try:
        yield
    finally:
        log(f"stage: {name} done ({time.monotonic() - t0:.1f}s)")


def remaining():
    return BUDGET_S - (time.monotonic() - T_START)


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of the card, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def main():
    import numpy as np

    from turbo_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py: JAX's default device is {platform!r}, not a "
                 f"GPU")

    from turbo_tpu.frontend.fzn import parse_fzn
    from turbo_tpu.compile.model import compile_model
    from turbo_tpu.solver.engine import BatchedSolver, EngineConfig

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = gpu_name_and_power_limit()
    log(f"devices: {jax.devices()}; card: {card}")
    with stage("model compile"):
        tnf = compile_model(parse_fzn(INSTANCE))
    log(f"compiled model: V={tnf.num_vars} P={tnf.num_props}")

    # The EPS root table is off by default here (BENCH_TABLE=1 turns it
    # on): with the pinned -sub 14 split its build is thousands of
    # serial device calls, outside the measured window.
    use_table = bool(int(os.environ.get("BENCH_TABLE", "0")))
    solver = BatchedSolver(tnf, EngineConfig(
        num_dives=DIVES, subproblems_power=14, max_depth=256,
        fp_max_iters=max(CAPS + [FP_CAP, 16]),
        # The EngineConfig defaults the CLI runs with (fixpoint, vd).
        fp_mode=os.environ.get("BENCH_FP_MODE", "fixpoint"),
        fp_layout=os.environ.get("BENCH_FP_LAYOUT", "vd"),
        use_table=use_table))
    if solver.use_table:
        # Deadline for the build: the engine falls back to dive-mode
        # refills on overrun.
        tbl_budget = min(
            float(os.environ.get("BENCH_TABLE_BUDGET_S", "420")),
            max(30.0, 0.4 * remaining()))
        solver._table_deadline = solver.clock() + tbl_budget
        with stage(f"EPS table build (deadline {tbl_budget:.0f}s)"):
            if solver.get_table(0) is None:
                solver.disable_table()  # don't re-attempt in init_state
        log(f"table mode: {solver.use_table}")
    with stage("init_state (compile + table upload)"):
        st = solver.init_state()
    with stage("step program compile"):
        step_fn = solver.make_step_budget()

    def step_n(s):
        return step_fn(s, jnp.int32(CHUNK))[0]

    with stage("first chunk"):
        t0 = time.monotonic()
        st = step_n(st)
        jax.block_until_ready(st)
        first_chunk_s = time.monotonic() - t0
    log(f"step compile {solver.step_compile_time:.1f}s; first {CHUNK} "
        f"steps {first_chunk_s:.2f}s")

    # Fixpoint-cap sweep (the optimum is instance-dependent). The cap
    # plane is traced state: switching costs no recompile, and every
    # sweep chunk is real solve progress under the hold rule.
    def set_cap(s, c):
        return s._replace(fp_cap=jnp.full((DIVES,), c, dtype=jnp.int32))

    best_cap = FP_CAP if FP_CAP > 0 else None
    if best_cap is None:
        rates = {}
        with stage(f"fp_cap sweep {CAPS}"):
            for cap in CAPS:
                if remaining() < MEASURE_S + 30.0:
                    log(f"sweep aborted early (budget): measured {rates}")
                    break
                st = set_cap(st, cap)
                # One rebase chunk so the sample starts at the new cap.
                st = step_n(st)
                n0 = int(np.asarray(jax.device_get(st.nodes)).sum())
                t0 = time.monotonic()
                while time.monotonic() - t0 < SWEEP_S:
                    st = step_n(st)
                    jax.block_until_ready(st.phase)
                n1 = int(np.asarray(jax.device_get(st.nodes)).sum())
                dt = time.monotonic() - t0
                rates[cap] = (n1 - n0) / dt
                log(f"  cap {cap}: {rates[cap]:,.0f} nodes/s "
                    f"({dt:.1f}s sample)")
        best_cap = max(rates, key=rates.get) if rates else 16
        log(f"sweep winner: cap {best_cap}")
    st = set_cap(st, best_cap)
    st = step_n(st)  # rebase at the winning cap
    got0 = jax.device_get((st.nodes, st.deds))
    nodes0 = int(np.asarray(got0[0]).sum())
    deds0 = float(np.asarray(got0[1]).sum())

    t0 = time.monotonic()
    steps = 0
    # Always measure for at least 15s even if a cold compile consumed
    # the budget - a short valid measurement beats a zero division.
    measure_s = max(15.0, min(MEASURE_S, remaining() - 20.0))
    # Bound trajectory is always recorded: nodes/s alone is gameable
    # (a weaker fixpoint inflates nodes while slowing real search
    # progress); the (time, best_bound) curve shows the measured
    # throughput doing real optimization work.
    trajectory = []
    with stage(f"measure window ({measure_s:.0f}s at cap {best_cap})"):
        while time.monotonic() - t0 < measure_s:
            st = step_n(st)
            steps += CHUNK
            if steps % 256 == 0:
                bb = int(jax.device_get(st.best_bound).min())
                trajectory.append((round(time.monotonic() - t0, 2), bb))
        dt_dispatch = time.monotonic() - t0
        got = jax.device_get((st.nodes, st.best_bound, st.fpit, st.deds))
        dt = time.monotonic() - t0
    if dt - dt_dispatch > 1.0:
        log(f"final drain took {dt - dt_dispatch:.1f}s "
            f"(in-flight chunks at window end)")
    log(f"bound trajectory: {trajectory}")
    nodes1 = int(np.asarray(got[0]).sum())
    nodes_per_s = (nodes1 - nodes0) / dt
    bb = int(np.asarray(got[1]).min())
    fpit = int(np.asarray(got[2]).sum())
    deds = float(np.asarray(got[3]).sum()) - deds0
    deds_per_s = deds / dt
    # Time at which the final best bound was first reached (within the
    # trajectory's chunk resolution).
    time_to_bound = next((t for t, b in trajectory if b == bb), dt)
    log(f"steady state: {nodes1 - nodes0} nodes in {dt:.1f}s "
        f"({nodes_per_s:.0f} nodes/s), best_bound={bb} "
        f"(reached @{time_to_bound:.1f}s), fixpoint_iters={fpit}, "
        f"deductions={deds:.3g} ({deds_per_s:.3g}/s)")
    inst_name = os.path.splitext(os.path.basename(INSTANCE))[0]
    out = {
        "metric": f"{inst_name} nodes/s ({DIVES} dives, 1 device)",
        "value": round(nodes_per_s, 1),
        "unit": "nodes/s",
        "device": device,
        "card": card,
        "fp_cap": best_cap,
        "fp_layout": solver.cfg.fp_layout,
        "use_table": bool(solver.use_table),
        "deductions_per_s": round(deds_per_s, 1),
        "best_bound_at_end": bb,
        "measure_window_s": round(dt, 1),
        "time_to_bound_s": round(time_to_bound, 1),
        "bound_trajectory": trajectory[:64],
        "step_compile_s": round(solver.step_compile_time, 2),
        "first_chunk_s": round(first_chunk_s, 2),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
