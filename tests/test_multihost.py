"""Multi-host EPS tests: steal-plan determinism, range reseeding,
external-bound injection, and a real two-process CPU run over
jax.distributed (SURVEY.md §7 stage 6)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from turbo_tpu.frontend.fzn import parse_fzn_text
from turbo_tpu.compile.model import compile_model
from turbo_tpu.parallel.multihost import plan_host_steal, reseed_ranges
from turbo_tpu.solver.engine import BatchedSolver, EngineConfig

from instances import MODELS, model_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = 1 << 30


def test_plan_host_steal_basic():
    # Host 1 dry, host 0 rich: host 1 steals half of host 0's richest
    # shard; plan must be identical no matter which host computes it.
    next_mat = np.array([[10, 50], [99, 99]], dtype=np.int64)
    limit_mat = np.array([[40, 60], [99, 99]], dtype=np.int64)
    idle = np.array([False, True])
    moves = plan_host_steal(next_mat, limit_mat, idle)
    assert moves == [(1, 0, 0, 25, 40)]
    # Donor keeps [10,25), thief takes [25,40): the union is unchanged.


def test_plan_host_steal_no_donor():
    next_mat = np.array([[40], [99]], dtype=np.int64)
    limit_mat = np.array([[41], [99]], dtype=np.int64)  # rem=1: too small
    idle = np.array([False, True])
    assert plan_host_steal(next_mat, limit_mat, idle) == []


def test_plan_host_steal_two_thieves_disjoint():
    next_mat = np.array([[0], [99], [99]], dtype=np.int64)
    limit_mat = np.array([[100], [99], [99]], dtype=np.int64)
    idle = np.array([False, True, True])
    moves = plan_host_steal(next_mat, limit_mat, idle)
    # Sequential plan: ranges must not overlap.
    assert len(moves) == 2
    spans = sorted((m[3], m[4]) for m in moves)
    assert spans[0][1] <= spans[1][0]


def test_reseed_ranges_covers_stolen_range():
    tnf = compile_model(parse_fzn_text(MODELS["times_div"][0]))
    s = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=6,
                                        max_depth=64), num_shards=2)
    import jax
    sts = [s.init_state(shard_idx=i) for i in range(2)]
    st = jax.tree.map(lambda *x: np.concatenate(
        [np.asarray(v) for v in x]), *sts)
    out = reseed_ranges(st, 4, 2, s.plan.lb0, s.plan.ub0, 40, 64)
    covered = set()
    for sh in range(2):
        base = int(out.subp[sh * 4])
        lim = int(out.sub_limit[sh * 4])
        covered.update(range(base, lim))
    assert covered == set(range(40, 64))


def test_ext_bound_prunes_like_remote_incumbent():
    """Injecting ext_bound=B makes the engine search only for solutions
    strictly better than B (the multi-host bound-sharing contract)."""
    import jax
    import jax.numpy as jnp

    tnf = compile_model(parse_fzn_text(MODELS["times_div"][0]))  # opt 12

    class Injected(BatchedSolver):
        def __init__(self, tnf, cfg, bound):
            super().__init__(tnf, cfg)
            self._bound = bound

        def init_state(self, shard_idx=0):
            st = super().init_state(shard_idx)
            return st._replace(ext_bound=jnp.full_like(st.ext_bound,
                                                       self._bound))

    # use_table=False: the multi-host architecture always runs in dive
    # mode (MultiHostSolver forces it — a thief cannot gather another
    # process's table), and this test injects ext_bound after init, so
    # the table builder could not have seen it.
    cfg = EngineConfig(num_dives=8, subproblems_power=5, max_depth=64,
                       use_table=False)
    r1 = Injected(tnf, cfg, 13).solve(timeout_s=120, chunk=16)
    assert r1.status == "optimal" and r1.objective == 12
    r2 = Injected(tnf, cfg, 12).solve(timeout_s=120, chunk=16)
    # Remote already has 12: nothing strictly better exists; the local
    # search drains exhaustively without a local incumbent.
    assert r2.best_lb is None and r2.exhaustive


WORKER = r"""
import os, sys
ndev = sys.argv[5] if len(sys.argv) > 5 else "2"
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
import jax
jax.config.update("jax_platforms", "cpu")
pid, n, port, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                      sys.argv[4])
from turbo_tpu.parallel.multihost import MultiHostSolver, init_distributed
init_distributed(f"localhost:{port}", n, pid)
from turbo_tpu.frontend.fzn import parse_fzn
from turbo_tpu.compile.model import compile_model
from turbo_tpu.solver.engine import EngineConfig
tnf = compile_model(parse_fzn(path))
s = MultiHostSolver(tnf, EngineConfig(num_dives=4, subproblems_power=6,
                                      max_depth=64))
r = s.solve(timeout_s=300, chunk=8)
print(f"RESULT {pid} {r.status} {r.objective} {int(r.exhaustive)}",
      flush=True)
"""


@pytest.mark.slow
@pytest.mark.parametrize("inst", [
    "times_div",
    # Maximize: the final all-host reduction must pick the LARGEST
    # original-space objective (a min() here once shipped the worst
    # incumbent as "optimal").
    "knapsack",
])
def test_two_process_solve_agrees(inst, tmp_path):
    """Two real processes over jax.distributed (CPU, localhost): both
    must report the same global optimum, exhaustively."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(i), "2", str(port),
         model_path(tmp_path, inst)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (out, err)
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert line, (out, err)
        outs.append(line[0].split())
    for pid, parts in enumerate(outs):
        assert parts[2] == "optimal", outs
        assert parts[3] == str(MODELS[inst][1]), outs
        assert parts[4] == "1", outs


@pytest.mark.slow
def test_two_process_asymmetric_device_counts(tmp_path):
    """Heterogeneous hosts: host 0 runs 2 virtual
    devices, host 1 runs 4. Shard offsets come from the allgathered
    per-host device counts, so the 6 global shards partition the
    subproblem space exactly and both hosts prove the same optimum."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(i), "2", str(port),
         model_path(tmp_path, "times_div"), dev],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i, dev in enumerate(["2", "4"])]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (out, err)
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert line, (out, err)
        outs.append(line[0].split())
    for parts in outs:
        assert parts[2] == "optimal", outs
        assert parts[3] == "12", outs
        assert parts[4] == "1", outs


@pytest.mark.slow
def test_cli_multihost_two_processes(tmp_path):
    """CLI-level multi-host run (-hosts/-host_id/-coordinator): host 0
    prints the solution + proof + GLOBAL stats; host 1 stays silent on
    stdout (solns2out must see exactly one stream)."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "turbo_tpu.cli",
         model_path(tmp_path, "times_div"),
         "-s", "-or", "4", "-sub", "6", "-platform", "cpu",
         "-hosts", "2", "-host_id", str(i),
         "-coordinator", f"localhost:{port}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (out, err)
        outs.append(out)
    assert "p = 12;" in outs[0], outs[0]
    assert "==========" in outs[0], outs[0]
    # Global subproblem accounting: solved + skipped == 2^6.
    import re
    solved = int(re.search(r"eps_solved_subproblems=(\d+)", outs[0])[1])
    skipped = int(re.search(r"eps_skipped_subproblems=(\d+)", outs[0])[1])
    assert solved + skipped == 64, outs[0]
    # Per-process node counts add up to the global one.
    nodes = int(re.search(r"%%%mzn-stat: nodes=(\d+)", outs[0])[1])
    per = re.search(r'host_nodes="([\d,]+)"', outs[0])[1].split(",")
    assert len(per) == 2 and sum(map(int, per)) == nodes, outs[0]
    assert outs[1].strip() == "", outs[1]


WORKER_R5 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid, n, port, ck, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4], sys.argv[5])
from turbo_tpu.parallel.multihost import MultiHostSolver, init_distributed
init_distributed(f"localhost:{port}", n, pid)
from turbo_tpu.frontend.fzn import parse_fzn
from turbo_tpu.compile.model import compile_model
from turbo_tpu.solver.engine import EngineConfig
tnf = compile_model(parse_fzn(path))
s = MultiHostSolver(tnf, EngineConfig(num_dives=4, subproblems_power=6,
                                      max_depth=64))
imps = []
r1 = s.solve(timeout_s=300, chunk=2, node_limit=40, checkpoint_path=ck,
             on_improve=lambda lb: imps.append(list(lb)))
r2 = s.solve(timeout_s=300, chunk=8, checkpoint_path=ck,
             on_improve=lambda lb: imps.append(list(lb)))
print(f"RESULT {pid} {r1.status} {r2.status} {r2.objective} "
      f"{int(r2.exhaustive)} {len(imps)}", flush=True)
"""


@pytest.mark.slow
def test_two_process_i_cutnodes_checkpoint(tmp_path):
    """Multi-host -i / -cutnodes / -checkpoint:
    a node-budgeted first run stops early and checkpoints on every
    host; a second collective solve resumes from the per-host files and
    proves the optimum; the global improving incumbent streams through
    on_improve on both hosts."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ck = str(tmp_path / "mh.ckpt")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER_R5, str(i), "2", str(port), ck,
         model_path(tmp_path, "times_div")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (out, err)
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert line, (out, err)
        outs.append(line[0].split())
    # Per-host checkpoint files were written.
    assert os.path.exists(ck + ".h0") and os.path.exists(ck + ".h1")
    for parts in outs:
        # Run 1 was cut by the global node budget (not exhaustive)...
        assert parts[2] in ("sat", "unknown"), outs
        # ...run 2 resumed and proved the optimum.
        assert parts[3] == "optimal", outs
        assert parts[4] == "12", outs
        assert parts[5] == "1", outs
        # At least one global incumbent improvement streamed.
        assert int(parts[6]) >= 1, outs
