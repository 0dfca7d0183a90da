"""The port stands alone: no module of repro_torch (nor chip_smoke.py, nor
the example twins) imports jax or the reference package, the port serves
and trains with jax unimportable, and a replica process (and the primary
that feeds it) runs with jax, the reference package and torch all
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
    + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "examples").glob("torch_*.py"))


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
        "for arch in ('qwen2-0.5b', 'mamba2-1.3b', 'recurrentgemma-9b'):\n"
        "    cfg = smoke_config(arch)\n"
        "    ex = ServeExecutor(cfg, slots=2, max_len=32, device='cpu')\n"
        "    ex.submit(np.arange(24, dtype=np.int32).reshape(3, 8),\n"
        "              max_new=3)\n"
        "    assert ex.drain() == 3\n"
        "    print('served', ex.wq.counts()['FINISHED'], arch)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "served 3 qwen2-0.5b" in out.stdout
    assert "served 3 mamba2-1.3b" in out.stdout
    assert "served 3 recurrentgemma-9b" in out.stdout


def test_port_trains_with_jax_blocked():
    """``python -m repro_torch.launch.train`` with jax and the reference
    unimportable: two store-driven steps of the smoke qwen2 on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.launch import train\n"
        "train.main(['--arch', 'qwen2-0.5b', '--smoke', '--device', 'cpu',\n"
        "            '--steps', '2', '--workers', '2'])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "trained 2 steps on cpu" in out.stdout


def test_port_replica_runs_with_jax_repro_and_torch_blocked(tmp_path):
    """A ``sitecustomize`` blocks jax, repro and torch in every interpreter
    started here, so also in the spawned replica processes: a primary
    with a shipped replica and a two-shard router with remote replicas
    sync, sweep and promote without any of them."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\n"
        "for name in ('jax', 'repro', 'torch'):\n"
        "    sys.modules[name] = None\n")
    script = tmp_path / "replica_drill.py"
    script.write_text(
        "import numpy as np\n"
        "from repro_torch.core import ShardRouter, WorkQueue\n"
        "from repro_torch.core.replication import ShippedDeltaReplicator\n"
        "if __name__ == '__main__':\n"
        "    wq = WorkQueue(2, device='cpu')\n"
        "    rep = ShippedDeltaReplicator(wq)\n"
        "    wq.add_tasks(0, 8)\n"
        "    wq.claim_all(k=1, now=1.0)\n"
        "    rep.sync()\n"
        "    assert rep.remote_sweep(2.0)['q4'] == 8\n"
        "    assert rep.promote().counts()['READY'] == 8\n"
        "    rep.close()\n"
        "    r = ShardRouter(2, 2, replicate='remote', device='cpu')\n"
        "    r.add_tasks(0, 16, now=0.0)\n"
        "    r.claim_all(k=1, now=1.0)\n"
        "    assert r.remote_sweep(2.0)['q4'] == 16\n"
        "    r.fail_shard(0)\n"
        "    r.promote_shard(0)\n"
        "    r.close()\n"
        "    import sys\n"
        "    assert 'torch' not in {k for k, v in sys.modules.items() if v}\n"
        "    print('replicas ran')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, str(script)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "replicas ran" in out.stdout


def test_port_trains_and_serves_sharded_with_jax_blocked():
    """The multi-device modules (``sharding``, ``launch/mesh.py``,
    ``launch/shardrules.py``, ``data/sharding.py``, the ``local_map``
    wrappers and ``moe_ffn_ep``) with jax and the reference unimportable:
    a gloo process group of one rank on the CPU, a 1 x 1 mesh, one sharded
    train step of the smoke granite and a sharded prefill and decode
    step."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import dataclasses, torch\n"
        "from repro_torch.configs import SHAPES, get_config, smoke_config\n"
        "from repro_torch.data.sharding import place_batch\n"
        "from repro_torch.launch import shardrules as SR\n"
        "from repro_torch.launch.mesh import make_host_mesh\n"
        "from repro_torch.launch.steps import (init_train_state,\n"
        "    make_prefill_step, make_serve_step, make_train_step)\n"
        "arch = 'granite-moe-3b-a800m'\n"
        "cfg = smoke_config(arch)\n"
        "mesh = make_host_mesh('cpu')\n"
        "shape = dataclasses.replace(SHAPES['train_4k'], seq_len=16,\n"
        "                            global_batch=2)\n"
        "rules = SR.make_rules(get_config(arch), shape, mesh)\n"
        "state = init_train_state(cfg, torch.Generator().manual_seed(0),\n"
        "                         rules=rules, device='cpu')\n"
        "tok = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32)\n"
        "batch = {'tokens': tok, 'labels': tok}\n"
        "batch = place_batch(batch, SR.batch_shardings(cfg, rules, batch))\n"
        "state, met = make_train_step(cfg, rules)(state, batch, {'lr': 1e-3})\n"
        "assert torch.isfinite(torch.as_tensor(float(met['loss'])))\n"
        "nxt, cache = make_prefill_step(cfg, rules, 20)(state['params'],\n"
        "                                               {'tokens': tok})\n"
        "nxt, cache, lp = make_serve_step(cfg, rules)(state['params'], nxt,\n"
        "                                             cache)\n"
        "print('sharded', tuple(nxt.shape), type(cache['layers']['k'])\n"
        "      .__name__)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "sharded (2, 1) DTensor" in out.stdout
