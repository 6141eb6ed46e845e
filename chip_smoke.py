#!/usr/bin/env python3
"""Smoke test of the solve path on NVIDIA GPUs.

    python chip_smoke.py            # one card, phases 1-5
    python chip_smoke.py --multi    # four cards, the multi-device paths

One card:
  1. device: JAX's default device is a GPU; the card's name and power
     limit (nvidia-smi) and the JAX version.
  2. kernel parity: on golomb13's plan at the auto-sized lane count,
     the propagation kernels equal the numpy rules exactly on 64 random
     sub-boxes of the root (solver/parity.py).
  3. proof: the CLI proves golomb8 optimal at 34, equal to the
     sequential oracle run in this process.
  4. full width: the CLI runs golomb13 (competition size) with -t 60000
     from whatever state the compile cache is in; every printed
     solution passes the checker, and rates and times are printed. A
     separate cache check then runs golomb13 briefly again and prints
     its step compile time beside the first run's.
  5. other archs: -arch hybrid and -a enumeration on the satisfaction
     variant of golomb8 (length <= 34) equal the oracle.

--multi runs only the two multi-device paths and what they are
compared with: `-hosts 4` (one process per card over jax.distributed)
and `-arch multi` (one process, a "dives" mesh over the four cards),
each proving golomb8 (beside the oracle) and solving golomb13 (beside
phase 4's single-card run). It prints the node rate of each `-hosts`
process and the devices that hold the mesh's sharded state.

Each run prints one line as it ends; a failed phase raises, so the
script exits non-zero and prints no result. The last line of stdout is
`{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}`.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks", "gen"))

from golomb import OPTIMUM, golomb_fzn  # noqa: E402
from turbo_tpu.frontend.fzn import parse_fzn  # noqa: E402
from turbo_tpu.utils.checker import (check_printed,  # noqa: E402
                                     parse_printed_solutions)
from turbo_tpu.utils.device import enable_compile_cache  # noqa: E402

G8 = os.path.join(REPO, "benchmarks", "golomb8.fzn")
G13 = os.path.join(REPO, "benchmarks", "golomb13.fzn")


def result_line(devices) -> str:
    """The script's last line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def cards() -> list:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def parse_stats(text: str) -> dict:
    """The `%%%mzn-stat:` lines of a run (the last value of a key wins)."""
    stats = {}
    for line in text.splitlines():
        if line.startswith("%%%mzn-stat: "):
            key, _, val = line[len("%%%mzn-stat: "):].partition("=")
            stats[key] = val.strip('"')
    return stats


def run_cli(args) -> tuple:
    """cli.main in this process; returns (stdout text, stats)."""
    from turbo_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(args))
    if rc != 0:
        raise RuntimeError(f"cli {args} exited {rc}")
    text = buf.getvalue()
    return text, parse_stats(text)


def checked(model, text: str, what: str) -> int:
    """Number of printed solutions; raises unless there is at least one
    and every one passes the checker."""
    res = check_printed(model, text)
    if not res:
        raise AssertionError(f"{what}: no solution printed")
    bad = [b for b in res if b]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(res)} printed "
                             f"solutions fail the checker: {bad[0][:3]}")
    return len(res)


def objective(stats: dict, what: str) -> int:
    if "objective" not in stats:
        raise AssertionError(f"{what}: no objective reported")
    return int(stats["objective"])


def proven(text: str, stats: dict, expect: int, what: str) -> None:
    if "==========" not in text:
        raise AssertionError(f"{what}: optimality not proven")
    if objective(stats, what) != expect:
        raise AssertionError(f"{what}: objective {stats['objective']} "
                             f"!= {expect}")


def rates(stats: dict) -> str:
    solve = float(stats["solveTime"])
    nodes = int(stats["nodes"])
    return (f"nodes/s {nodes / solve:.1f}, deductions/s "
            f"{int(stats['num_deductions']) / solve:.4g}, sweeps/node "
            f"{int(stats['fixpoint_iterations']) / max(nodes, 1):.2f}, "
            f"initTime "
            f"{float(stats['initTime']):.3f}s, compileTime "
            f"{stats.get('compileTime', 'n/a ')}s, solveTime {solve:.3f}s, "
            f"best {stats.get('objective')} at {stats.get('best_obj_time')}s, "
            f"fixpoint/search time per lane {stats.get('fixpoint_time')}/"
            f"{stats.get('search_time')}s (split fitted from chunk times)")


def marks(model, text: str) -> set:
    m = len([v for v in model.vars if v.name.startswith("x_")])
    return {tuple(s[f"x_{i}"] for i in range(m))
            for s in parse_printed_solutions(model, text)}


def phase_device(expect_count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"phase 1 device: JAX's default device is "
                         f"{devs[0].platform!r}, not a GPU")
    if len(devs) < expect_count:
        raise SystemExit(f"phase 1 device: {len(devs)} GPUs, need "
                         f"{expect_count}")
    return devs


def phase_parity(card: str):
    from turbo_tpu.compile.model import compile_model
    from turbo_tpu.solver.parity import check_kernel_parity
    from turbo_tpu.solver.plan import auto_num_dives, build_plan

    t = time.monotonic()
    tnf = compile_model(parse_fzn(G13))
    plan = build_plan(tnf)
    D = auto_num_dives(tnf)
    r = check_kernel_parity(tnf, plan, D, num_boxes=64)
    print(f"phase 2 kernel parity: golomb13 plan (V={plan.V}, P={plan.P}) "
          f"at D={D} lanes on {r['boxes']} random sub-boxes of the root: "
          f"one sweep (dv and vd layouts), the AC-1 fixpoint (dv, vd), the "
          f"WAC1 fixpoint, entailment and failure flags equal the numpy "
          f"rules exactly (int32/int64 arithmetic, no floating point; "
          f"{r['failed']} boxes fail, up to {r['max_sweeps']} sweeps) "
          f"[{time.monotonic() - t:.1f}s, {card}]", flush=True)


def phase_proof(card: str):
    model = parse_fzn(G8)
    text, st = run_cli([G8, "-s", "-t", "120000"])
    proven(text, st, OPTIMUM[8], "golomb8 proof")
    n = checked(model, text, "golomb8 proof")
    otext, ost = run_cli([G8, "-arch", "cpu", "-s", "-t", "120000"])
    proven(otext, ost, OPTIMUM[8], "golomb8 oracle")
    print(f"phase 3 proof: golomb8 proven optimal at {st['objective']} "
          f"(oracle: {ost['objective']}, proven), {n} printed solution "
          f"passes the checker; solveTime {float(st['solveTime']):.3f}s, "
          f"{st['nodes']} nodes (oracle {float(ost['solveTime']):.3f}s) "
          f"[{card}]", flush=True)


def phase_full_width(card: str, timeout_ms: int = 60000):
    from turbo_tpu.utils.device import compile_cache_dir

    model = parse_fzn(G13)
    text, st = run_cli([G13, "-s", "-i", "-t", str(timeout_ms)])
    n = checked(model, text, "golomb13")
    if objective(st, "golomb13") < OPTIMUM[13]:
        raise AssertionError(f"golomb13: objective {st['objective']} "
                             f"below the known optimum {OPTIMUM[13]}")
    print(f"phase 4 full width: golomb13 -t {timeout_ms}: {n} printed "
          f"solutions pass the checker; {rates(st)} [{card}]", flush=True)
    _, again = run_cli([G13, "-s", "-t", "2000"])
    print(f"phase 4 compile cache: {compile_cache_dir()}; a second "
          f"golomb13 run's compileTime {again.get('compileTime')}s "
          f"(first run {st.get('compileTime')}s), initTime "
          f"{float(again['initTime']):.3f}s (first run "
          f"{float(st['initTime']):.3f}s)", flush=True)


def phase_other_archs(card: str, m: int = 8):
    with tempfile.TemporaryDirectory() as d:
        sat = os.path.join(d, f"golomb{m}_sat.fzn")
        with open(sat, "w") as f:
            f.write(golomb_fzn(m, max_length=OPTIMUM[m]))
        model = parse_fzn(sat)
        otext, _ = run_cli([sat, "-arch", "cpu", "-a", "-s"])
        want = marks(model, otext)
        if not want or "==========" not in otext:
            raise AssertionError("golomb8 satisfaction: the oracle found "
                                 "no complete solution set")
        htext, hst = run_cli([sat, "-arch", "hybrid", "-s", "-t", "120000"])
        checked(model, htext, "hybrid")
        if not marks(model, htext) <= want:
            raise AssertionError(f"hybrid solution {marks(model, htext)} "
                                 f"not among the oracle's {want}")
        atext, ast = run_cli([sat, "-a", "-s", "-t", "120000"])
        checked(model, atext, "-a")
        got = marks(model, atext)
        if got != want or "==========" not in atext:
            raise AssertionError(f"-a enumerated {got}, oracle {want}")
    print(f"phase 5 other archs: golomb{m} length <= {OPTIMUM[m]}: hybrid "
          f"found {sorted(marks(model, htext))} in "
          f"{float(hst['solveTime']):.3f}s; -a enumerated all {len(got)} "
          f"solutions in {float(ast['solveTime']):.3f}s; both equal the "
          f"oracle's {len(want)} [{card}]", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_hosts(model_path: str, n: int, timeout_ms: int) -> tuple:
    """`-hosts n` run: one CLI process per card (CUDA_VISIBLE_DEVICES),
    rendezvous on localhost. Returns (host 0's stdout, stats)."""
    port = _free_port()
    procs = []
    try:
        for i in range(n):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(i))
            cmd = [sys.executable, "-m", "turbo_tpu.cli", model_path,
                   "-hosts", str(n), "-host_id", str(i), "-coordinator",
                   f"localhost:{port}", "-s", "-i", "-t", str(timeout_ms)]
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, env=env, text=True,
                stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL))
        out, _ = procs[0].communicate(timeout=timeout_ms / 1000 * 3 + 300)
        for p in procs[1:]:
            p.wait(timeout=120)
        rcs = [p.returncode for p in procs]
        if any(rcs):
            raise RuntimeError(f"-hosts {n} on {model_path}: exit codes {rcs}")
        return out, parse_stats(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def multi(card: str, big: str = G13, timeout_ms: int = 60000):
    """The two four-card paths and what they are compared with: each
    proves golomb8 (equal to the oracle) and solves `big`; the
    single-card answer on golomb13 is phase 4's."""
    m8, mb = parse_fzn(G8), parse_fzn(big)
    name = os.path.splitext(os.path.basename(big))[0]
    # The oracle is numpy: it runs beside the card runs, in a process
    # that JAX_PLATFORMS=cpu keeps off the cards.
    oracle = subprocess.Popen(
        [sys.executable, "-m", "turbo_tpu.cli", G8, "-arch", "cpu", "-s",
         "-t", "120000"], cwd=REPO, text=True, stdout=subprocess.PIPE,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        devs = _multi_runs(card, m8, mb, big, name, timeout_ms)
        otext, _ = oracle.communicate(timeout=600)
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.wait()
    if oracle.returncode:
        raise RuntimeError(f"oracle on golomb8 exited {oracle.returncode}")
    ost = parse_stats(otext)
    proven(otext, ost, OPTIMUM[8], "golomb8 oracle")
    print(f"multi reference: the oracle proves golomb8 at "
          f"{ost['objective']} (solveTime {float(ost['solveTime']):.3f}s); "
          f"the single-card {name} run is phase 4 of the one-card smoke",
          flush=True)
    return devs


def _multi_runs(card, m8, mb, big, name, timeout_ms):
    # One process per card first: this process must not hold the cards
    # (a JAX process reserves most of each card it opens).
    text, st = run_hosts(G8, 4, 120000)
    proven(text, st, OPTIMUM[8], "-hosts 4 golomb8")
    checked(m8, text, "-hosts 4 golomb8")
    print(f"multi -hosts 4: golomb8 proven at {st['objective']} "
          f"(solveTime {float(st['solveTime']):.3f}s) [{card}]", flush=True)
    text, stb = run_hosts(big, 4, timeout_ms)
    n = checked(mb, text, f"-hosts 4 {name}")
    solve = float(stb["solveTime"])
    per = [f"{int(x) / solve:.1f}" for x in stb["host_nodes"].split(",")]
    print(f"multi -hosts 4: {name} -t {timeout_ms}: {n} solutions pass "
          f"the checker, {rates(stb)}; nodes/s per process "
          f"{', '.join(per)} [{card}]", flush=True)

    devs = phase_device(4)
    from turbo_tpu.compile.model import compile_model
    from turbo_tpu.parallel.mesh import ShardedSolver
    from turbo_tpu.solver.engine import EngineConfig

    sh = ShardedSolver(compile_model(m8),
                       EngineConfig(num_dives=16, use_table=False))
    ids = sorted(d.id for d in sh.init_state().lb.sharding.device_set)
    if len(ids) != 4:
        raise AssertionError(f"-arch multi state on devices {ids}")
    text, st = run_cli([G8, "-arch", "multi", "-s", "-t", "120000"])
    proven(text, st, OPTIMUM[8], "-arch multi golomb8")
    checked(m8, text, "-arch multi golomb8")
    print(f"multi -arch multi: state sharded over devices {ids}; golomb8 "
          f"proven at {st['objective']} (solveTime "
          f"{float(st['solveTime']):.3f}s, initTime "
          f"{float(st['initTime']):.3f}s) [{card}]", flush=True)
    text, stm = run_cli([big, "-arch", "multi", "-s", "-i", "-t",
                         str(timeout_ms)])
    n = checked(mb, text, f"-arch multi {name}")
    print(f"multi -arch multi: {name} -t {timeout_ms}: {n} solutions pass "
          f"the checker, {rates(stm)} [{card}]", flush=True)
    return devs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card paths (-hosts 4, -arch multi)")
    a = ap.parse_args(argv)
    enable_compile_cache()
    import jax

    if a.multi:
        names = cards()
        print(f"phase 1 device: {len(names)} cards: {' | '.join(names)}; "
              f"jax {jax.__version__}", flush=True)
        multi(names[0])
    else:
        devs = phase_device(1)
        card = cards()[0]
        print(f"phase 1 device: {card}; {devs[0].device_kind} "
              f"x{len(devs)}; jax {jax.__version__}", flush=True)
        phase_parity(card)
        phase_proof(card)
        phase_full_width(card)
        phase_other_archs(card)
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
