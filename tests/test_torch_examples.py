"""The twins of the four examples (``examples/torch_*.py``) run to their end
on the CPU with small step counts, in this process; without a card their
default device (``cuda``) refuses to start."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = {"torch_quickstart": ["--steps", "8"],
         "torch_serve_continuous_batching": [],
         "torch_parameter_sweep_steering": ["--steps", "4"],
         "torch_fault_tolerance_demo": []}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_runs_on_cpu(name, capsys):
    _load(name).main(TWINS[name] + ["--device", "cpu"])
    out = capsys.readouterr().out
    want = {"torch_quickstart": "done in",
            "torch_serve_continuous_batching": "served 15 requests",
            "torch_parameter_sweep_steering": "provenance:",
            "torch_fault_tolerance_demo": "[restart] restored step 18"}
    assert want[name] in out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(TWINS[name])
