"""Nothing the benchmark runs loads JAX or the JAX package ``ku``, compared
by whole top-level names (``ku_torch`` is not ``ku``); the reference loads
no part of the port either. Each check runs in a fresh process."""

import json
import shutil
import subprocess
import sys

import pytest

from kubench.harness import main, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "ku")
LOADED = ("import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"{code}\n{LOADED}"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def check_runs_load_neither_jax_nor_ku(root=spec.ROOT) -> set:
    """Runs every cell of the BENCHMARK.json at ``root`` on the CPU at its
    ``"small"`` size, correct, and reads each metric's reader, in one fresh
    process; returns the top-level modules it then holds."""
    code = f"""
import sys, time, torch
from pathlib import Path
sys.path.insert(0, {str(spec.ROOT)!r})
from kubench.harness import main, spec
root = Path({str(root)!r})
bench = spec.load_benchmark(root)
for cell in [w["name"] for w in bench["workloads"]]:
    r = main.run_cell(cell, 7, 0.05, False, time.perf_counter(), device=torch.device("cpu"),
                      small=True, root=root)
    assert r["correct"], r
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
import kubench.calibrate
"""
    loaded = loaded_after(code)
    assert not loaded & set(FORBIDDEN)
    return loaded


def test_a_run_loads_neither_jax_nor_ku():
    assert "ku_torch" in check_runs_load_neither_jax_nor_ku()


def test_the_reference_loads_nothing_of_the_port():
    loaded = loaded_after("import kubench.reference.cd, kubench.reference.philox")
    assert not loaded & set(FORBIDDEN + ("ku_torch",))


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("ku_torch", "ku_torch.ebm", "kubench", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert main.forbidden_modules() == [m for m in main.forbidden_modules()
                                        if m.split(".")[0] in FORBIDDEN]
    assert not {"ku_torch", "ku_torch.ebm", "kubench", "jaxtyping"} & set(main.forbidden_modules())
    monkeypatch.setitem(sys.modules, "ku.ebm", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert {"ku.ebm", "jaxlib.xla"} <= set(main.forbidden_modules())


def run_py(cwd):
    return subprocess.run([sys.executable, "kubench/run.py", "--workload", "rbm_mnist.cd1",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


def no_result(out):
    return not any(line.startswith("{") and '"correct"' in line
                   for line in out.stdout.splitlines())


def test_without_a_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run's refusal without one")
    out = run_py(spec.ROOT)
    assert out.returncode == main.EXIT_NO_CARD and no_result(out)
    assert "no card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "kubench",
                    ignore=shutil.ignore_patterns("_run", "__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and no_result(out)
