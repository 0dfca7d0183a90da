"""Rehearsal of chip_smoke.py on the CPU at smoke size: its serve, serve
check and claim phases run the port's plain versions here (the kernel phase
needs the card), and main() refuses to run without a card."""
import importlib.util
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_phases_on_cpu(chip_smoke, capsys):
    cfg = smoke_config("qwen2-0.5b")
    serve = chip_smoke.phase_serve(cfg, "cpu", requests=3, prompt_len=21,
                                   max_new=4, slots=2, max_len=40)
    res = serve["result"]
    assert res["finished"] == 3 and res["tokens_generated"] == 12
    assert res["launches"] == {"flash_attention": 0, "decode_attention": 0}
    check = chip_smoke.phase_serve_check(serve["executor"], prompt_len=9,
                                         steps=2)
    assert [s["max_abs_err"] for s in check["steps"]] == [0.0, 0.0, 0.0]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["serve", "serve_check"]


def test_claim_phase_on_cpu(chip_smoke):
    res = chip_smoke.phase_claim("cpu", tasks=3000, workers=16, rounds=2)
    assert res["equal_to_host_path"] and res["tasks_claimed"] == 16 * 2 * 5
    assert res["launches"] == {"wq_claim": 0}


def test_main_refuses_without_a_card(chip_smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out
