"""The port stands alone: no module of repro_torch (nor chip_smoke.py)
imports jax or the reference package, and the port serves with jax
unimportable."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_serves_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "from repro_torch.configs import smoke_config\n"
        "from repro_torch.runtime.executor import ServeExecutor\n"
        "cfg = smoke_config('qwen2-0.5b')\n"
        "ex = ServeExecutor(cfg, slots=2, max_len=32, device='cpu')\n"
        "ex.submit(np.arange(24, dtype=np.int32).reshape(3, 8), max_new=3)\n"
        "assert ex.drain() == 3\n"
        "print('served', ex.wq.counts()['FINISHED'])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "served 3" in out.stdout
