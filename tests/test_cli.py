"""End-to-end CLI tests (CPU backend)."""
import json
import os
import subprocess
import sys

import pytest

from instances import MODELS, model_path

ENV = dict(os.environ, JAX_PLATFORMS="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args, timeout=180):
    # jax.config platform override happens in-process; use env + -c shim.
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; from turbo_tpu.cli import main;"
        f"sys.exit(main({list(args)!r}))"
    )
    return subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_cpu_arch(tmp_path):
    r = run_cli(model_path(tmp_path, "golomb6"),
                "-arch", "cpu", "-s", "-t", "60000")
    assert r.returncode == 0, r.stderr
    assert "==========" in r.stdout          # optimality proven
    assert f"objective={MODELS['golomb6'][1]}" in r.stdout
    assert "%%%mzn-stat: nodes=" in r.stdout


def test_cli_barebones_arch(tmp_path):
    r = run_cli(model_path(tmp_path, "linear_reif"), "-arch", "barebones",
                "-or", "8", "-sub", "4", "-s", "-t", "60000")
    assert r.returncode == 0, r.stderr
    assert "==========" in r.stdout
    assert f"b = {MODELS['linear_reif'][1]};" in r.stdout
    # Per-phase timer stats (statistics.hpp:355-371 parity).
    for key in ("fixpoint_time=", "search_time=", "dive_time=",
                "wait_cpu_time=", "transfer_gpu2cpu_time=",
                "cumulative_time_block_sec=", "num_blocks=",
                "first_block_idle_time=", "num_blocks_done="):
        assert f"%%%mzn-stat: {key}" in r.stdout, key


@pytest.mark.parametrize("name", ["barebones", "gpu", "tpu"])
def test_arch_aliases_select_the_batched_engine(name):
    from turbo_tpu.utils.config import parse_args

    assert parse_args(["m.fzn"]).arch == "barebones"
    assert parse_args(["m.fzn", "-arch", name]).arch == "barebones"


def test_cli_satisfaction_all_solutions():
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".fzn", delete=False) as f:
        f.write("var 1..2: x :: output_var;\nsolve satisfy;\n")
        path = f.name
    r = run_cli(path, "-arch", "cpu", "-a")
    assert r.returncode == 0, r.stderr
    # Entailment-based solution detection yields solution *cubes*
    # (matching the reference's num_active==0 rule): an unconstrained
    # model is one cube, printed once, search exhausted.
    assert r.stdout.count("----------") >= 1
    assert "==========" in r.stdout


def test_cli_unsat(tmp_path):
    m = tmp_path / "false.fzn"
    m.write_text("var 1..3: x :: output_var;\nconstraint int_lt(x, 1);\n"
                 "solve satisfy;\n")
    r = run_cli(str(m), "-arch", "cpu")
    assert "=====UNSATISFIABLE=====" in r.stdout


def test_cli_all_solutions_and_config_echo(tmp_path):
    m = tmp_path / "m.fzn"
    m.write_text("""var 1..3: x :: output_var;
var 1..3: y :: output_var;
constraint int_lt(x, y);
solve satisfy;
""")
    r = run_cli(str(m), "-arch", "cpu", "-a", "-s", "-t", "30000")
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("----------") == 3   # x<y in 1..3: 3 solutions
    assert "==========" in r.stdout            # exhaustive enumeration
    assert "%%%mzn-stat: num_solutions=3" in r.stdout
    for key in ("command_line=", "problem_path=", "arch=", "or_nodes=",
                "free_search=", "timeout_ms="):
        assert f"%%%mzn-stat: {key}" in r.stdout, key


def test_cli_parity_flags(tmp_path):
    """Reference flag surface (config.cpp:128-220): -timeout overrides
    -t, -hardware/-version are echoed, -globalmem/-p accepted."""
    m = tmp_path / "m.fzn"
    m.write_text("var 1..2: x :: output_var;\nsolve satisfy;\n")
    r = run_cli(str(m), "-arch", "cpu", "-s", "-t", "1000",
                "-timeout", "90000", "-hardware", "CPU;RAM;GPU H100",
                "-version", "9.9.9-test", "-globalmem", "-p", "8")
    assert r.returncode == 0, r.stderr
    assert "%%%mzn-stat: timeout_ms=90000" in r.stdout
    assert '%%%mzn-stat: hardware="CPU;RAM;GPU H100"' in r.stdout
    assert '%%%mzn-stat: version="9.9.9-test"' in r.stdout
    assert "%%%mzn-stat: or_nodes=8" in r.stdout


def test_cli_or_p_exclusive(tmp_path):
    m = tmp_path / "m.fzn"
    m.write_text("var 1..2: x;\nsolve satisfy;\n")
    r = run_cli(str(m), "-or", "4", "-p", "4")
    assert r.returncode != 0
    assert "-or and -p" in r.stderr


def test_cli_fp_echo(tmp_path):
    m = tmp_path / "m.fzn"
    m.write_text("""var 1..4: x :: output_var;
var 1..4: y :: output_var;
constraint int_lt(x, y);
solve minimize x;
""")
    r = run_cli(str(m), "-arch", "barebones", "-s", "-fp", "wac1",
                "-wac1_threshold", "2", "-sub", "2", "-or", "4",
                "-t", "60000")
    assert r.returncode == 0, r.stderr
    assert '%%%mzn-stat: fixpoint="wac1"' in r.stdout
    assert "%%%mzn-stat: wac1_threshold=2" in r.stdout
    assert "x = 1;" in r.stdout
    assert "==========" in r.stdout
