"""Rehearsal of chip_smoke.py on the CPU at smoke size: its serve, serve
check, claim, control-plane, train and train check phases run the port's plain versions
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
    ("granite-moe-3b-a800m", {"flash_attention": 256,
                              "decode_attention": 7936}),
    ("qwen2-vl-2b", {"flash_attention": 224, "decode_attention": 6944}),
    # 24 encoder layers and 24 decoder layers of self- and cross-attention
    # a prefill; the decoder's two a layer and decode step
    ("seamless-m4t-large-v2", {"flash_attention": 576,
                               "decode_attention": 11904}),
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


def test_control_plane_phase_on_cpu(chip_smoke, tmp_path, capsys):
    """The control-plane phase at a small size (2,000 tasks, 4 shards of 8
    workers, every shard claiming through the claim op's plain version;
    the smoke qwen2 for the sharded train run): every check passes, and
    the record carries each timing the card fills in."""
    res = chip_smoke.phase_control_plane(
        "cpu", tasks=2000, workers_per_shard=8, rounds=2,
        train_cfg=smoke_config("qwen2-0.5b"), train_seq_len=32,
        ckpt_dir=str(tmp_path / "ckpt"))
    assert res["workers"] == 32 and res["tasks_claimed"] > 0
    assert res["log_records_truncated"] > 0
    assert res["stranded_claims_requeued"] > 0 and res["rebalanced_tasks"] > 0
    assert len(res["version_vector"]) == 4
    walls = res["claim_all_wall_ms"]
    assert sorted(walls) == ["device_sharded", "host_oracle"]
    assert len(walls["device_sharded"]) == 2 * 2 + 3
    for key in ("replica_sync_ms", "remote_sweep_ms", "promote_s",
                "checkpoint_save_s", "checkpoint_restore_s", "rebalance_ms"):
        assert res[key] > 0, key
    assert res["launches"] == {"wq_claim": 0}
    assert res["kernel_device_ms"] is None
    train = res["train"]
    assert train["steps"] == 6 and len(train["losses"]) == 6
    assert train["launches"] == {"flash_attention": 0,
                                 "flash_attention_bwd": 0, "wq_claim": 0}
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "control_plane"
    assert not (tmp_path / "ckpt").exists()


def test_claim_launch_count_follows_the_scan_start(chip_smoke):
    """The launches the phase expects of a claim_all: one per live shard
    that claims on the device and has rows left to scan."""
    from repro_torch.core import ShardRouter
    r = ShardRouter(2, 2, device="cpu", device_claim=True)
    assert chip_smoke._launching_shards(r) == 0          # empty stores
    r.add_tasks(0, 4, now=0.0)
    assert chip_smoke._launching_shards(r) == 2
    box = {"want": 0}
    chip_smoke._count_claim_launches(r, box)
    for _ in range(3):
        r.claim_all(k=1, now=1.0)
    assert box["want"] == 2 + 2 + 0     # both drained by the second
    r.fail_shard(1)
    assert chip_smoke._launching_shards(r) == 0
    r.close()


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


def test_moe_serve_phases_on_cpu(chip_smoke, capsys):
    """granite-moe (smoke) through the executor, and its check on a 2-layer
    cut through the model bundle, CPU against CPU: equal to the bit."""
    cfg = smoke_config("granite-moe-3b-a800m")
    serve = chip_smoke.phase_serve(cfg, "cpu", requests=3, prompt_len=21,
                                   max_new=4, slots=2, max_len=40)
    assert serve["result"]["finished"] == 3
    assert serve["result"]["launches"] == {"flash_attention": 0,
                                           "decode_attention": 0}
    check = chip_smoke.phase_family_check(cfg, "cpu", prompt_len=9)
    assert check["layers"] == 2
    assert [s["max_abs_err"] for s in check["steps"]] == [0.0] * 4
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["serve", "serve_check"]


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_bundle_serve_phases_on_cpu(chip_smoke, capsys, arch):
    """The VLM and enc-dec families served through the model bundle (2
    requests; enc-dec: one of cross_kv_len frames and one of fewer), then
    the check on a 2-layer cut, CPU against CPU: equal to the bit."""
    cfg = smoke_config(arch)
    res = chip_smoke.phase_serve_bundle(cfg, "cpu", requests=2,
                                        prompt_len=12, frames=[16, 10],
                                        max_new=4, max_len=40)
    assert res["finished"] == 2 and res["tokens_generated"] == 8
    assert res["launches"] == {"flash_attention": 0, "decode_attention": 0}
    assert res["frames"] == ([16, 10] if cfg.family == "encdec" else None)
    check = chip_smoke.phase_family_check(cfg, "cpu", prompt_len=9,
                                          frames=10)
    assert [s["max_abs_err"] for s in check["steps"]] == [0.0] * 4
    assert check["prompt_len"] == 9
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["phase"], x["arch"]) for x in lines] == \
        [("serve", arch), ("serve_check", arch)]


def test_grid_positions_are_three_streams(chip_smoke):
    pos = chip_smoke.grid_positions(100, 40)
    assert pos.shape == (3, 1, 100) and pos.dtype == np.int32
    assert (pos[0] == 0).all() and pos[1, 0, 41] == 1 and pos[2, 0, 41] == 1
    assert len({tuple(p) for p in pos[:, 0].T}) == 100


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2"])
def test_new_family_train_phases_on_cpu(chip_smoke, capsys, arch):
    """The train phase and its card-vs-CPU check for the MoE, VLM and
    enc-dec families (smoke configs with remat), CPU against CPU here."""
    import dataclasses
    cfg = dataclasses.replace(smoke_config(arch), remat=True)
    train = chip_smoke.phase_train(cfg, "cpu", steps=4, workers=2,
                                   seq_len=32, batch=4)
    train["executor"].close()
    res = train["result"]
    assert res["steps"] == 4 and np.isfinite(res["losses"]).all()
    assert set(res["launches"]) == set(chip_smoke.train_launches(cfg, 4, 2))
    prefixes = {"moe": ("layers.0.moe.",), "vlm": ("layers.0.attn.",),
                "encdec": ("encoder.0.", "decoder.0.")}[cfg.family]
    check = chip_smoke.phase_train_check(cfg, "cpu", batch=2, seq_len=32,
                                         prefixes=prefixes)
    assert check["loss"][0] == check["loss"][1]
    assert check["max_grad_err_over_largest"] == 0.0
    assert any(k.startswith(prefixes) for k in check["params"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["train", "train_check"]


def test_train_launch_counts_of_the_new_families(chip_smoke):
    """6 steps on 2 workers, the forward twice (remat): granite cut to
    MOE_TRAIN_LAYERS in its 4 microbatches; qwen2-vl's 28 layers;
    seamless's 24 encoder layers and 24 decoder layers' self- and
    cross-attention."""
    import dataclasses
    from repro_torch.configs import get_config
    n = chip_smoke.MOE_TRAIN_LAYERS
    gcut = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                               num_layers=n)
    assert chip_smoke.train_launches(gcut, 6, 3) == {
        "flash_attention": n * 6 * 4 * 2, "flash_attention_bwd": n * 6 * 4,
        "wq_claim": 3}
    assert chip_smoke.train_launches(get_config("qwen2-vl-2b"), 6, 3) == {
        "flash_attention": 336, "flash_attention_bwd": 168, "wq_claim": 3}
    assert chip_smoke.train_launches(get_config("seamless-m4t-large-v2"),
                                     6, 3) == {
        "flash_attention": 864, "flash_attention_bwd": 432, "wq_claim": 3}


def test_flash_bounds_of_the_cross_shapes(chip_smoke):
    """Not causal: every query sees every key (Sq x Skv pairs), q and o
    counted at Sq, k and v at Skv; a causal square shape keeps its count."""
    assert chip_smoke.flash_pairs(64, skv=4096, causal=False) == 64 * 4096
    assert chip_smoke.flash_pairs(300, skv=100) == 100 * 101 // 2 + 200 * 100
    assert chip_smoke.flash_pairs(2048, 700) == \
        700 * 701 // 2 + (2048 - 700) * 700
    b = chip_smoke.flash_bound(64, 16, 16, 64, torch.float32, skv=4096,
                               causal=False)
    assert b["useful_ops"] == 4.0 * 64 * 4096 * 64 * 16
    assert b["bytes"] == 4 * 2 * 64 * (64 * 16 + 4096 * 16)
    bb = chip_smoke.flash_bwd_bound(8, 256, 16, 16, 64, torch.bfloat16,
                                    skv=2048, causal=False)
    assert bb["ops"] == 10.0 * 8 * 256 * 2048 * 64 * 16
    assert bb["bytes"] == 2 * 8 * 64 * 4 * (256 * 16 + 2048 * 16)


def test_route_pin_replays_the_first_runs_experts(chip_smoke):
    """The check's second run takes the first run's experts, weighed by its
    own probabilities, and counts the tokens it would have routed
    otherwise; the layers route by their own top-k again after each run."""
    from repro_torch.models import moe
    cfg = smoke_config("granite-moe-3b-a800m")
    mod = moe.MoE(torch.Generator().manual_seed(0), cfg, torch.float32)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((64, cfg.d_model)),
                        dtype=torch.float32)
    x2 = x + 0.5 * torch.as_tensor(rng.standard_normal(x.shape),
                                   dtype=torch.float32)
    pin = chip_smoke.RoutePin(cfg)
    w0, idx0, _ = pin.run("record", (mod,), moe.route, mod, x, cfg)
    assert mod.pin is None
    _, own, _ = moe.route(mod, x, cfg)
    assert torch.equal(own, idx0)      # recording leaves the choice alone
    _, own, _ = moe.route(mod, x2, cfg)
    w1, idx1, _ = pin.run("replay", (mod,), moe.route, mod, x2, cfg)
    assert mod.pin is None
    assert torch.equal(idx1, idx0)
    moved = int((own != idx0).any(-1).sum())
    assert 0 < moved < 64
    assert pin.summary() == {"route_differences": moved,
                             "route_decisions": 64,
                             "route_differences_limit": 2}
    assert torch.allclose(w1.sum(-1), torch.ones(64))
    assert chip_smoke.RoutePin(smoke_config("qwen2-0.5b")).summary() == {}


@pytest.mark.parametrize("differences,decisions,ok", [
    (2, 80, True), (3, 80, False),           # at least 2 tokens
    (8, 8192, True), (9, 8192, False),       # 1e-3 of the decisions
    (40, 64, False)])
def test_route_pin_check_bounds_the_flips(chip_smoke, differences,
                                          decisions, ok):
    """More flipped tokens than the larger of 2 and 1e-3 of the decisions
    fail the check: a wrong router or top-k on the card would flip most."""
    pin = chip_smoke.RoutePin(smoke_config("granite-moe-3b-a800m"))
    pin.differences, pin.decisions = differences, decisions
    if ok:
        pin.check()
    else:
        with pytest.raises(AssertionError, match="routing decisions"):
            pin.check()


def test_family_shapes_split_each_runs_launches(chip_smoke):
    """The kernel rows of the MoE, VLM and enc-dec paths: the shares of one
    kernel's launches in one run sum to 1, each a whole number of the run's
    launches (seamless: a third of its flash launches a prefill part, with
    the short request's frames apart; half its decode launches each)."""
    import dataclasses
    from fractions import Fraction
    from repro_torch.configs import get_config
    fams = tuple(get_config(a) for a in ("granite-moe-3b-a800m",
                                         "qwen2-vl-2b",
                                         "seamless-m4t-large-v2"))
    gcut = dataclasses.replace(fams[0],
                               num_layers=chip_smoke.MOE_TRAIN_LAYERS)
    runs = {}
    for c in fams:
        runs[c.name] = chip_smoke.SERVE_LAUNCHES[c.family](c, 8, 32)
        runs[f"{c.name} train"] = chip_smoke.train_launches(
            gcut if c is fams[0] else c, 6, 3)
    total = {}
    for kernel, arch, share, kw in chip_smoke.family_shapes(fams):
        n = runs[arch][kernel] * share
        assert n.denominator == 1 and n > 0
        total[kernel, arch] = total.get((kernel, arch), 0) + share
    assert set(total.values()) == {Fraction(1)}
    assert {k for k, _ in total} == {"flash_attention", "decode_attention",
                                     "flash_attention_bwd"}
    e = fams[2].name
    assert {(kw["s"], kw.get("skv", 0), share * 576)
            for k, a, share, kw in chip_smoke.family_shapes(fams)
            if (k, a) == ("flash_attention", e)} == {
        (4096, 0, 168), (2500, 0, 24), (64, 4096, 168), (64, 2500, 24),
        (64, 0, 192)}


def test_kernels_line_picks_each_runs_rows(chip_smoke):
    """The kernels line from synthetic rows of every case: each (kernel,
    run) entry carries the row of its own kernel and shape (the family
    train runs' claim entries the claim kernel's row, not another kernel's
    of the same arch), and a run's launches split by shape sum to its
    count."""
    from repro_torch.configs import get_config
    cfg, scfg, hcfg = (get_config(a) for a in
                       ("qwen2-0.5b", "mamba2-1.3b", "recurrentgemma-9b"))
    fams = tuple(get_config(a) for a in ("granite-moe-3b-a800m",
                                         "qwen2-vl-2b",
                                         "seamless-m4t-large-v2"))
    made = iter(range(1, 1000))

    def row(kernel, **kw):
        return {"kernel": kernel, "arch": None, "max_abs_err": 0.0,
                "ms": float(next(made)), "plain_ms": 1.0, "bound_ms": 0.1,
                "bound_by": "bytes", "library_ms": None, "device_ms": 1.0,
                **kw}

    train, s_train, h_train = (f"{c.name} train" for c in (cfg, scfg, hcfg))
    rows = [row("wq_claim", n=100_000, workers=936, k=1),
            row("flash_attention", arch=train, dtype="bfloat16"),
            row("wq_claim", arch=train, n=6, workers=2, k=1),
            row("flash_attention_bwd", arch=train),
            row("flash_attention", arch=cfg.name, dtype="float32"),
            row("flash_attention", arch=hcfg.name, shape_q=[1, 1000, 16, 256]),
            row("decode_attention", arch=cfg.name, kv_len=1000,
                dtype="bfloat16"),
            row("decode_attention", arch=hcfg.name, kv_len=1001, window=0),
            row("ssd_scan", case="main"), row("ssd_scan", case="train"),
            row("ssd_scan_bwd", case="train"),
            row("rglru_scan", case="main"), row("rglru_scan", case="train"),
            row("rglru_scan_bwd", case="train"),
            row("flash_attention", arch=h_train),
            row("flash_attention_bwd", arch=h_train),
            row("wq_claim", arch=chip_smoke.CONTROL_PLANE, n=25_000,
                workers=234, k=1),
            row("wq_claim", arch=chip_smoke.SHARDED_TRAIN, n=4, workers=2,
                k=1),
            row("flash_attention", arch=chip_smoke.SHARDED_TRAIN),
            row("flash_attention_bwd", arch=chip_smoke.SHARDED_TRAIN)]
    extra = [(row(k, **{x: kw[x] for x in ("arch", "causal") if x in kw}),
              arch, share)
             for k, arch, share, kw in chip_smoke.family_shapes(fams)]
    launches = {None: {"wq_claim": 6},
                train: chip_smoke.train_launches(cfg, 6, 3),
                s_train: chip_smoke.train_launches(scfg, 6, 3),
                h_train: chip_smoke.train_launches(hcfg, 6, 3),
                cfg.name: {"flash_attention": 192, "decode_attention": 5952},
                hcfg.name: {"flash_attention": 96, "decode_attention": 2976,
                            "rglru_scan": 208},
                scfg.name: {"ssd_scan": 384},
                chip_smoke.CONTROL_PLANE: {"wq_claim": 40},
                chip_smoke.SHARDED_TRAIN: chip_smoke.train_launches(cfg, 6,
                                                                    5)}
    for c in fams:
        launches[c.name] = chip_smoke.SERVE_LAUNCHES[c.family](c, 8, 32)
        launches[f"{c.name} train"] = chip_smoke.train_launches(c, 6, 3)
    line = chip_smoke.kernels_line(cfg, scfg, hcfg, fams, rows, extra,
                                   launches)["kernels"]
    claim_ms = rows[2]["ms"]
    claims = [e for e in line if e["name"] == "wq_claim"]
    assert len(claims) == 9
    own = {chip_smoke.CONTROL_PLANE: rows[-4]["ms"],
           chip_smoke.SHARDED_TRAIN: rows[-3]["ms"]}
    assert all(e["ms"] == own.get(e["arch"], claim_ms)
               for e in claims if e["arch"])
    sharded = {e["name"]: e["ms"] for e in line
               if e["arch"] == chip_smoke.SHARDED_TRAIN}
    assert sharded == {"wq_claim": rows[-3]["ms"],
                       "flash_attention": rows[-2]["ms"],
                       "flash_attention_bwd": rows[-1]["ms"]}
    by_run = {}
    for e in line:
        by_run[e["name"], e["arch"]] = by_run.get((e["name"], e["arch"]),
                                                  0) + e["launches"]
    assert by_run == {(k, a): n for a, run in launches.items()
                      for k, n in run.items()}
    seamless = [e for e in line if e["arch"] == fams[2].name
                and e["name"] == "decode_attention"]
    assert [(e["launches"], e["launches_share"]) for e in seamless] == \
        [(5952, "1/2"), (5952, "1/2")]
