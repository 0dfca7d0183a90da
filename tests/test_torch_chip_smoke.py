"""Rehearsal of chip_smoke.py on the CPU at smoke size: its serve, serve
check, claim, train and train check phases run the port's plain versions
here (the kernel phase and the profiles need the card), and main() refuses
to run without a card."""
import importlib.util
import json
import pathlib

import numpy as np
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


def test_ssm_serve_phases_on_cpu(chip_smoke, capsys):
    cfg = smoke_config("mamba2-1.3b")
    serve = chip_smoke.phase_serve(cfg, "cpu", requests=3, prompt_len=21,
                                   max_new=4, slots=2, max_len=40)
    res = serve["result"]
    assert res["finished"] == 3 and res["tokens_generated"] == 12
    assert res["launches"] == {"ssd_scan": 0}
    check = chip_smoke.phase_serve_check(serve["executor"], prompt_len=19,
                                         steps=3)
    assert [s["max_abs_err"] for s in check["steps"]] == [0.0] * 4
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["phase"], x["arch"]) for x in lines] == \
        [("serve", "mamba2-1.3b"), ("serve_check", "mamba2-1.3b")]


def test_hybrid_serve_phases_on_cpu(chip_smoke, capsys):
    """recurrentgemma smoke (window 8): the serve, and the serve check on a
    4-layer cut (one group and one tail layer) with a prompt longer than the
    window, so the ring wraps in the prefill."""
    cfg = smoke_config("recurrentgemma-9b")
    serve = chip_smoke.phase_serve(cfg, "cpu", requests=3, prompt_len=21,
                                   max_new=4, slots=2, max_len=40)
    res = serve["result"]
    assert res["finished"] == 3 and res["tokens_generated"] == 12
    assert res["launches"] == {"rglru_scan": 0, "flash_attention": 0,
                               "decode_attention": 0}
    assert res["init_peak_mem_bytes"] is None
    check = chip_smoke.phase_hybrid_check(cfg, "cpu", prompt_len=21)
    assert check["layers"] == 4 and check["prompt_len"] == 21
    assert [s["max_abs_err"] for s in check["steps"]] == [0.0] * 4
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["phase"], x["arch"]) for x in lines] == \
        [("serve", "recurrentgemma-9b"), ("serve_check", "recurrentgemma-9b")]


@pytest.mark.parametrize("arch,want", [
    ("qwen2-0.5b", {"flash_attention": 192, "decode_attention": 5952}),
    ("mamba2-1.3b", {"ssd_scan": 384}),
    ("recurrentgemma-9b", {"rglru_scan": 208, "flash_attention": 96,
                           "decode_attention": 2976}),
])
def test_serve_launch_counts_of_the_full_configs(chip_smoke, arch, want):
    """Launches the full-width serve (8 requests, 32 new tokens) must show:
    recurrentgemma-9b's 26 rec and 12 attention layers are counted from its
    pattern (12 groups of (rec, rec, attn), then 2 tail rec layers)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    assert chip_smoke.SERVE_LAUNCHES[cfg.family](cfg, 8, 32) == want


@pytest.mark.parametrize("s,hq,hkv,dh,window", [
    (1000, 14, 2, 64, 0),           # qwen2-0.5b's prefill
    (1000, 16, 1, 256, 2048),       # recurrentgemma-9b's, window not biting
    (4096, 16, 1, 256, 2048),       # window biting
])
def test_flash_bound_counts_3xtf32_products(chip_smoke, s, hq, hkv, dh,
                                            window):
    """The fp32 flash rows' bound: 3x the pair operations at the TF32 rate
    (the kernel's route), with the fp32-FMA bound as ``bound_before_ms``;
    bf16 at its own rate. Operations bind at these shapes."""
    pairs = chip_smoke.flash_pairs(s, window)
    assert pairs == (s * (s + 1) // 2 if not window or s <= window else
                     window * (window + 1) // 2 + (s - window) * window)
    ops = 4.0 * pairs * dh * hq
    b = chip_smoke.flash_bound(s, hq, hkv, dh, torch.float32, window)
    assert b["bound_by"] == "operations" and b["useful_ops"] == ops
    assert b["ops"] == 3.0 * ops
    assert b["bound_ms"] == pytest.approx(3.0 * ops / 495e12 * 1e3)
    assert b["bound_before_ms"] == pytest.approx(ops / 67e12 * 1e3)
    assert b["bytes"] == 4 * 2 * s * dh * (hq + hkv)
    bf = chip_smoke.flash_bound(s, hq, hkv, dh, torch.bfloat16, window)
    assert bf["bound_ms"] == pytest.approx(ops / 989e12 * 1e3)
    assert "bound_before_ms" not in bf


def test_per_call_us_counts_lost_records(chip_smoke):
    """A kernel's device time per call is its mean record times the records
    one call makes, so a profile that lost a few records reads as a whole
    one (a kernel launched once and one launched twice a call)."""
    whole = {"fa": (1400.0, 20), "two": (800.0, 40)}
    lossy = {"fa": (1330.0, 19), "two": (600.0, 30)}
    for kernels in (whole, lossy):
        assert chip_smoke.per_call_us(kernels, 20) == pytest.approx(
            {"fa": 70.0, "two": 40.0})


def test_claim_phase_on_cpu(chip_smoke):
    res = chip_smoke.phase_claim("cpu", tasks=3000, workers=16, rounds=2)
    assert res["equal_to_host_path"] and res["tasks_claimed"] == 16 * 2 * 5
    assert res["launches"] == {"wq_claim": 0}


def test_claim_phase_reports_wall_ms_on_cpu(chip_smoke):
    """Each claim_all's wall ms on both paths, rounds x (k 1, k 4) of each;
    the kernel's device time is read only on a card."""
    res = chip_smoke.phase_claim("cpu", tasks=2000, workers=8, rounds=3)
    walls = res["claim_all_wall_ms"]
    assert sorted(walls) == ["device", "host"]
    assert all(len(v) == 2 * 3 and min(v) > 0 for v in walls.values())
    assert res["kernel_device_ms"] is None


def test_train_phases_on_cpu(chip_smoke, capsys):
    """The train phase (smoke qwen2 with remat, device claims through the
    claim op's plain version) and the card-vs-CPU train check, run CPU
    against CPU here: equal to the bit."""
    import dataclasses
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b"), remat=True)
    train = chip_smoke.phase_train(cfg, "cpu", steps=4, workers=2,
                                   seq_len=32, batch=4)
    ex = train["executor"]
    ex.close()
    res = train["result"]
    assert res["steps"] == 4 and len(res["losses"]) == 4
    assert res["launches"] == {"flash_attention": 0,
                               "flash_attention_bwd": 0, "wq_claim": 0}
    assert res["peak_mem_bytes"] is None and res["seconds"] > 0
    check = chip_smoke.phase_train_check(cfg, "cpu", batch=2, seq_len=64)
    assert check["loss"][0] == check["loss"][1]
    assert check["max_grad_err_over_largest"] == 0.0
    assert "layers.0.mlp.down.weight" in check["params"]
    assert all(p["max_abs_err"] == 0.0 for p in check["params"].values())
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["train", "train_check"]


def test_train_launch_counts_of_the_full_config(chip_smoke):
    """qwen2-0.5b, 6 steps on 2 workers: 24 layers x 6 steps, the forward
    twice (remat recomputes it in the backward), 3 claim ticks."""
    from repro_torch.configs import get_config
    assert chip_smoke.train_launches(get_config("qwen2-0.5b"), 6, 3) == {
        "flash_attention": 288, "flash_attention_bwd": 144, "wq_claim": 3}


@pytest.mark.parametrize("b,s,hq,hkv,dh,window,dtype", [
    (8, 2048, 14, 2, 64, 0, "bfloat16"),     # qwen2-0.5b's train shape
    (1, 1031, 14, 2, 64, 0, "float32"),
    (1, 2048, 14, 2, 64, 700, "float32"),
])
def test_flash_bwd_bound_counts_the_functions_work(chip_smoke, b, s, hq, hkv,
                                                    dh, window, dtype):
    """10 dh Hq operations per visible pair and batch row, against q, k, v,
    o, dO, dq, dk, dv moved once: bf16 at its tensor rate (989 TFLOP/s);
    fp32 on the kernel's route, 3x the operations at the TF32 rate (495),
    with the fp32-FMA bound (67) as ``bound_before_ms``."""
    dt = getattr(torch, dtype)
    ops = 10.0 * b * chip_smoke.flash_pairs(s, window) * dh * hq
    bnd = chip_smoke.flash_bwd_bound(b, s, hq, hkv, dh, dt, window)
    assert bnd["bound_by"] == "operations"
    if dt == torch.bfloat16:
        assert bnd["ops"] == ops and "bound_before_ms" not in bnd
        assert bnd["bound_ms"] == pytest.approx(ops / 989e12 * 1e3)
    else:
        assert bnd["useful_ops"] == ops and bnd["ops"] == 3.0 * ops
        assert bnd["bound_ms"] == pytest.approx(3.0 * ops / 495e12 * 1e3)
        assert bnd["bound_before_ms"] == pytest.approx(ops / 67e12 * 1e3)
    elt = 2 if dt == torch.bfloat16 else 4
    assert bnd["bytes"] == elt * b * s * dh * 4 * (hq + hkv)


def test_profile_records_lost_are_counted(chip_smoke):
    """A profile of 2 calls (the serve and train profiles): a kernel whose
    records are not a multiple of 2 lost some, reported by name, and its
    time per call is counted whole."""
    kernels = {"fa": (300.0, 3), "gemm": (400.0, 4)}
    assert chip_smoke.records_lost(kernels, 2) == {"fa": 1}
    assert chip_smoke.per_call_us(kernels, 2) == {"fa": 200.0,
                                                   "gemm": 200.0}


def test_main_refuses_without_a_card(chip_smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_ssm_and_hybrid_train_phases_on_cpu(chip_smoke, capsys, arch):
    """The train phase and the card-vs-CPU train check of the SSM and
    hybrid families (smoke configs with remat; the hybrid's check without
    the optimizer step, as on the card), run CPU against CPU here: equal to
    the bit, every task finished with a finite loss."""
    import dataclasses
    cfg = dataclasses.replace(smoke_config(arch), remat=True)
    train = chip_smoke.phase_train(cfg, "cpu", steps=4, workers=2,
                                   seq_len=32, batch=4, reduced="smoke")
    train["executor"].close()
    res = train["result"]
    assert res["steps"] == 4 and np.isfinite(res["losses"]).all()
    assert res["reduced"] == "smoke" and res["param_count"] > 0
    assert set(res["launches"]) == set(chip_smoke.train_launches(cfg, 4, 2))
    step = arch == "mamba2-1.3b"
    check = chip_smoke.phase_train_check(
        cfg, "cpu", layers=len(cfg.rglru.pattern) if cfg.rglru else 2,
        batch=2, seq_len=32, step=step, prefixes=("layers.0.mixer.",))
    assert check["loss"][0] == check["loss"][1]
    assert check["max_grad_err_over_largest"] == 0.0
    if step:
        assert "layers.0.mixer.A_log" in check["params"]
        assert all(p["max_abs_err"] == 0.0 for p in check["params"].values())
    else:
        assert check["params"] is None
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["train", "train_check"]


def test_train_launch_counts_of_the_ssm_and_hybrid_runs(chip_smoke):
    """mamba2-1.3b, 6 steps: 48 SSM layers, the SSD scan forward twice
    (remat) and its backward once a layer and step; recurrentgemma-9b cut
    to 8 layers (2 groups + 2 tail: 6 rec and 2 attention layers), 6 steps
    of 4 microbatches: the RG-LRU scan and flash at width 256 likewise, per
    microbatch; 3 claim ticks each."""
    import dataclasses
    from repro_torch.configs import get_config
    assert chip_smoke.train_launches(get_config("mamba2-1.3b"), 6, 3) == {
        "ssd_scan": 576, "ssd_scan_bwd": 288, "wq_claim": 3}
    hcut = dataclasses.replace(get_config("recurrentgemma-9b"),
                               num_layers=chip_smoke.HYBRID_TRAIN_LAYERS)
    assert chip_smoke.train_launches(hcut, 6, 3) == {
        "rglru_scan": 288, "rglru_scan_bwd": 144, "flash_attention": 96,
        "flash_attention_bwd": 48, "wq_claim": 3}


def test_ssd_bwd_bound_of_the_train_shape(chip_smoke):
    """mamba2-1.3b's train shape (BH 512, S 2048, P 64, N 128, chunk 256,
    one B/C row per batch row): the chunked backward's useful flop, tripled
    on its 3xTF32 route, bind against the 855 MB of inputs and gradients."""
    ops, nbytes = chip_smoke.ssd_bwd_ops_bytes(512, 2048, 64, 128, 256, 64)
    pairs = 8 * 256 * 257 // 2
    assert ops == 2.0 * (3 * 8 * pairs * 128 + 512 * (2 * pairs * 64
                                                      + 5 * 2048 * 64 * 128))
    assert nbytes == 4 * (3 * 512 * 2048 * 64 + 4 * 8 * 2048 * 128
                          + 4 * 512 * 2048)
    bound = chip_smoke._bound(nbytes, 3.0 * ops, "tf32")
    assert bound["bound_by"] == "operations"
    ops, nbytes = chip_smoke.rglru_bwd_ops_bytes(1, 4096, 4096)
    assert nbytes == 20 * 4096 * 4096
    assert chip_smoke._bound(nbytes, ops, torch.float32)["bound_by"] == \
        "bytes"


def test_train_history_steps_both_devices_alike_on_cpu():
    """``scripts/train_history.py``'s two histories, both run on the CPU
    here (smoke mamba2, two SSD chunks): the same params and batches give
    the same losses and grad norms to the bit, a new loss every step."""
    spec = importlib.util.spec_from_file_location(
        "train_history", ROOT / "scripts" / "train_history.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = smoke_config("mamba2-1.3b")
    dcfg = mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=2 * cfg.ssm.chunk,
                          batch_size=2)
    first, second = mod.history(cfg, dcfg, 3, 3e-3, 0, "cpu")
    assert first == second and len(first) == 3
    assert all(np.isfinite(v).all() for v in first)
    assert len({loss for loss, _ in first}) == 3   # every step moved the params
