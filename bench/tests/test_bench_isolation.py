"""What the benchmark may load and read: no JAX and no JAX package (top-level
names compared whole, since the port's name starts with the JAX package's),
no port in the plain reference, nothing of the JAX package's benchmark
folder; and a run that
finds no card fails instead of falling back."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
OLD_BENCH = "benchmarks" + "/"     # the JAX package's benchmark folder
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro"}
    assert OLD_BENCH not in path.read_text()


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "plainref").glob("*.py")):
        assert "repro_torch" not in imported(path), path
        assert imported(path) <= {"__future__", "math", "typing", "torch",
                                  "numpy", "plainref"}, path


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]


def _run(cwd: Path, env=None):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen2-0.5b.sweep-2k",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_a_run_without_a_card_fails(card_absent):
    out = _run(ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA" in out.stderr


def test_a_run_with_only_the_benchmark_files_fails(tmp_path, card_absent):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_benchmark_json_names_its_command():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["command"] == ["python3", "bench/run.py"]
    assert os.path.exists(ROOT / spec["command"][1])
