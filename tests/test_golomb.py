"""The in-repo Golomb instances, the kernel parity check the smoke test
runs at full width, and the run-time plumbing around the solve path:
the compile cache, platform selection, the trace split and the smoke
script's result line."""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from turbo_tpu.compile.model import compile_model
from turbo_tpu.frontend.fzn import parse_fzn, parse_fzn_text
from turbo_tpu.solver.engine import BatchedSolver, EngineConfig
from turbo_tpu.solver.oracle import solve as oracle_solve
from turbo_tpu.solver.parity import check_kernel_parity
from turbo_tpu.solver.plan import build_plan

from instances import GOLOMB8, OPTIMUM, REPO, golomb_fzn

ENV = dict(os.environ, JAX_PLATFORMS="cpu")


@pytest.mark.parametrize("m", [8, 13])
def test_generator_matches_committed_instance(m):
    with open(os.path.join(REPO, "benchmarks", f"golomb{m}.fzn")) as f:
        assert f.read() == golomb_fzn(m)


def test_golomb7_proven_by_engine():
    tnf = compile_model(parse_fzn_text(golomb_fzn(7)))
    r = BatchedSolver(tnf, EngineConfig(num_dives=64)).solve(timeout_s=300)
    assert r.status == "optimal" and r.exhaustive
    assert r.objective == OPTIMUM[7] == 25


def test_golomb7_proven_by_oracle():
    tnf = compile_model(parse_fzn_text(golomb_fzn(7)))
    r = oracle_solve(tnf, timeout_s=300)
    assert r.status == "optimal"
    assert r.objective == OPTIMUM[7]


def test_golomb8_kernel_parity():
    """The check of smoke phase 2, at a CPU-sized lane count: sweep,
    fixpoints and flags equal the numpy rules exactly."""
    tnf = compile_model(parse_fzn(GOLOMB8))
    plan = build_plan(tnf)
    r = check_kernel_parity(tnf, plan, num_dives=16, num_boxes=8)
    assert r["boxes"] == 8 and r["lanes"] == 16
    assert r["max_sweeps"] >= 2


@pytest.mark.parametrize("cap", [8, 16])
def test_init_state_fp_cap_follows_config(cap):
    """fp_max_iters is baked into the init program as the fp_cap
    plane's fill value: solvers differing only in it must each see
    their own cap."""
    tnf = compile_model(parse_fzn_text(golomb_fzn(5)))
    s = BatchedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=3,
                                        max_depth=64, fp_max_iters=cap))
    assert (np.asarray(s.init_state().fp_cap) == cap).all()


def _py(code, env=None, timeout=180):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=env or ENV, capture_output=True, text=True,
                          timeout=timeout)


def test_compile_cache_defaults_to_checkout():
    env = {k: v for k, v in ENV.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    r = _py("import jax; from turbo_tpu.utils.device import "
            "enable_compile_cache; d = enable_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)", env)
    assert r.returncode == 0, r.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there
    and nothing is written under the checkout."""
    cache = str(tmp_path / "cache")
    env = dict(ENV, JAX_COMPILATION_CACHE_DIR=cache,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
    before = os.path.exists(os.path.join(REPO, ".jax_cache"))
    r = _py("import jax, jax.numpy as jnp; from turbo_tpu.utils.device "
            "import enable_compile_cache; print(enable_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir); "
            "jax.jit(lambda x: x * 3 + 1)(jnp.arange(5)).block_until_ready()",
            env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [cache, cache]
    assert os.listdir(cache)
    assert os.path.exists(os.path.join(REPO, ".jax_cache")) == before


PLATFORM_RUN = r"""
import os, subprocess, sys
class NoPython(subprocess.Popen):
    def __init__(self, args, *a, **k):
        argv = [args] if isinstance(args, str) else list(args)
        if "python" in os.path.basename(str(argv[0])):
            raise AssertionError(f"a probe process was started: {argv}")
        super().__init__(args, *a, **k)
subprocess.Popen = NoPython
from turbo_tpu.cli import main
sys.exit(main([sys.argv[1], "-arch", "barebones", "-platform",
               sys.argv[2], "-or", "4", "-sub", "3", "-t", "60000"]))
"""


def test_cli_platform_flag_starts_no_probe(tmp_path):
    """-platform cpu goes straight to the CPU backend: no probe process
    is started (starting a Python process raises here)."""
    m = tmp_path / "g5.fzn"
    m.write_text(golomb_fzn(5))
    env = {k: v for k, v in ENV.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", PLATFORM_RUN, str(m), "cpu"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stderr
    assert "==========" in r.stdout
    assert f", {OPTIMUM[5]}]);" in r.stdout


def test_cli_unknown_platform_raises(tmp_path):
    """An unknown platform is an error, never a fallback to another."""
    m = tmp_path / "g4.fzn"
    m.write_text(golomb_fzn(4))
    env = {k: v for k, v in ENV.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", PLATFORM_RUN, str(m),
                        "nosuchplatform"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode != 0
    assert "----------" not in r.stdout
    assert "nosuchplatform" in r.stderr


def test_check_printed_accepts_solutions_and_flags_a_broken_one(tmp_path):
    """The smoke test's solution check: every block the CLI printed
    passes; a block with one mark moved fails, naming the constraint."""
    from turbo_tpu.utils.checker import check_printed, parse_printed_solutions

    m = tmp_path / "g5.fzn"
    m.write_text(golomb_fzn(5))
    r = subprocess.run(
        [sys.executable, "-m", "turbo_tpu.cli", str(m), "-arch", "cpu",
         "-i", "-s"], cwd=REPO, env=ENV, capture_output=True, text=True,
        timeout=180)
    assert r.returncode == 0, r.stderr
    model = parse_fzn_text(golomb_fzn(5))
    sols = parse_printed_solutions(model, r.stdout)
    assert sols and sols[-1]["x_4"] == OPTIMUM[5]
    assert all(not bad for bad in check_printed(model, r.stdout))
    last = r.stdout.rstrip().split("----------")[-2].strip().splitlines()[-1]
    marks = last[last.index("[") + 1:last.index("]")].split(", ")
    broken = last.replace(", ".join(marks), ", ".join(
        marks[:2] + [marks[1]] + marks[3:]))
    bad = check_printed(model, broken + "\n----------\n")
    assert len(bad) == 1 and any("int_lt" in b for b in bad[0])


def _event(dur, **stats):
    return types.SimpleNamespace(duration_ns=dur, stats=list(stats.items()))


def _plane(name, lines):
    return types.SimpleNamespace(name=name, lines=[
        types.SimpleNamespace(name=n, events=ev) for n, ev in lines])


def test_profile_split_on_gpu_plane_events():
    """Kernels on /device:GPU planes are split by the fixpoint scope of
    their hlo_op; derived timeline lines, host planes and events with
    no instruction are not counted; command buffers are unattributed."""
    from turbo_tpu.solver.profile_split import device_kernel_events, split

    hlo = "\n".join([
        '  %fusion.3 = s32[8]{0} fusion(%a), metadata={op_name='
        '"jit(step)/while/body/fixpoint/sweep/max"}',
        '  %loop_select_fusion = s32[8]{0} fusion(%b), metadata={op_name='
        '"jit(step)/while/body/fixpoint/clamp"}',
        '  %input_reduce_fusion.2 = s32[] fusion(%c), metadata={op_name='
        '"jit(step)/while/body/branch/argmin"}',
        '  ROOT %copy.1 = s32[8]{0} copy(%d), metadata={op_name='
        '"jit(step)/select"}',
    ])
    stream = "Stream #13(MemcpyD2H,MemcpyD2D,Compute)"
    planes = [
        _plane("/device:GPU:0", [
            (stream, [_event(700, hlo_op="fusion.3"),
                      _event(100, hlo_op="loop_select_fusion"),
                      _event(150, hlo_op="input_reduce_fusion.2"),
                      _event(50, hlo_op="copy.1"),
                      # Runtime suffix drift: fusion.7 resolves by base.
                      _event(20, hlo_op="fusion.7"),
                      _event(5000, hlo_op="command_buffer"),
                      _event(30, memcpy_details="kind_src:device"),
                      _event(0, hlo_op="fusion.3")]),
            ("XLA Ops", [_event(999, hlo_op="fusion.3")]),
            ("XLA Modules", [_event(9999, hlo_op="fusion.3")]),
        ]),
        _plane("/device:GPU:1", [(stream, [_event(40, hlo_op="copy.1")])]),
        _plane("/host:CPU", [("tf_XLACpu", [_event(500, hlo_op="fusion.3")])]),
    ]
    names = [n for n, _ in device_kernel_events(planes)]
    assert names == ["fusion.3", "loop_select_fusion",
                     "input_reduce_fusion.2", "copy.1", "fusion.7",
                     "command_buffer", "copy.1"]
    assert split(planes, hlo) == (700 + 100 + 20, 150 + 50 + 40, 5000)


def test_smoke_result_line():
    """The smoke script's last line: exactly the device as JAX reports
    it, in the contract's key order."""
    sys.path.insert(0, REPO)
    import chip_smoke

    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.result_line([dev] * 4))["device"][
        "count"] == 4


def test_smoke_refuses_cpu():
    """Without an accelerator the smoke script stops before any phase
    and prints no result line."""
    r = _py("import sys; sys.argv = ['chip_smoke.py']; import chip_smoke; "
            "sys.exit(chip_smoke.main([]))")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr
