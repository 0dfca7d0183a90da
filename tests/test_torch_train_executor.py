"""The port's store-driven trainer on the CPU: twins of the reference's
executor tests (``tests/test_system.py``) and of its checkpoint and data
tests (``tests/test_checkpoint_and_data.py``), the 24-step loss history
held against the reference's executor from the same init, the port's
``store.npz`` read by the reference's checkpointer, the control-plane
arms (replica and remote analysts, shards, sharded checkpoints), and the
``repro_torch.launch.train`` command line; the executor and the command
line also for the SSM, hybrid, MoE, VLM and enc-dec families,
and the checkpoint round trip of the MoE, VLM and enc-dec state."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.runtime.executor import TrainExecutor as JaxTrainExecutor  # noqa: E402
from repro_torch import flags  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import _leaves as ck_leaves  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import WorkQueue  # noqa: E402
from repro_torch.data.pipeline import DataConfig, Prefetcher, batch_for  # noqa: E402
from repro_torch.interop import train_state_from_jax  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import init_train_state  # noqa: E402
from repro_torch.runtime.executor import TrainExecutor  # noqa: E402

# the 24-step loss history, port against reference from the same init: both
# in fp32, the per-step losses drift apart only by the sums' order, carried
# through 24 AdamW steps at lr 3e-3 (2.3e-7 when this test was written)
HISTORY_REL_TOL = 1e-5


def small_data(cfg):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)


def _executor(cfg=None, **kw):
    cfg = cfg or smoke_config("qwen2-0.5b")
    kw.setdefault("num_workers", 2)
    return TrainExecutor(cfg, data_cfg=small_data(cfg), device="cpu", **kw)


def _state(cfg, seed=0):
    return init_train_state(cfg, torch.Generator().manual_seed(seed))


def _leaves(state):
    out = {f"params/{n}": p for n, p in state["params"].named_parameters()}
    out["opt/step"] = state["opt"]["step"]
    for mom, d in state["opt"]["inner"].items():
        out.update({f"opt/{mom}/{n}": t for n, t in d.items()})
    return out


# ------------------------------------------------------------ test_system
def test_train_executor_reduces_loss_and_records_provenance():
    """Twin of test_system.py:19, and the per-step loss history of 24 steps
    held against the reference's executor started from the same params."""
    jcfg = jax_smoke_config("qwen2-0.5b")
    ref = JaxTrainExecutor(jcfg, num_workers=2,
                           data_cfg=jpipeline.DataConfig(
                               vocab_size=jcfg.vocab_size, seq_len=32,
                               batch_size=4), base_lr=3e-3)
    cfg = smoke_config("qwen2-0.5b")
    ex = _executor(cfg, base_lr=3e-3)
    ex.state = train_state_from_jax(cfg, jax.tree.map(np.asarray, ref.state),
                                    ex.state["params"])
    for e in (ref, ex):
        e.submit_steps(24)
    want = ref.run()
    hist = ex.run()
    ex.close()
    assert len(hist) == 24
    first = np.mean([h["loss"] for h in hist[:6]])
    last = np.mean([h["loss"] for h in hist[-6:]])
    assert last < first, (first, last)     # synthetic language is learnable
    # provenance: every task carries its loss in the domain columns
    out0 = ex.wq.store.col("out0")
    assert np.isfinite(out0[:24]).all()
    assert np.array_equal(out0[:24], [h["loss"] for h in hist])
    assert ex.wq.counts()["FINISHED"] == 24
    got = np.array([h["loss"] for h in hist])
    ref_loss = np.array([h["loss"] for h in want])
    assert np.abs(got - ref_loss).max() <= HISTORY_REL_TOL * ref_loss.max()
    assert np.allclose([h["grad_norm"] for h in hist],
                       [h["grad_norm"] for h in want], rtol=HISTORY_REL_TOL)


def test_train_executor_steers_on_snapshots_with_device_claims():
    """Steering sweeps run on the analyst thread against store snapshots,
    and ``flags.device_claims()`` routes each tick's claim_all through the
    claim op (its plain version on the CPU)."""
    with flags.device_claims():
        ex = _executor(steer_every=2)
    assert ex.wq.device_claim
    ex.submit_steps(6)
    ex.run()
    ex.close()
    assert ex.last_steering is not None
    assert ex.last_steering["q4"] in (0, 2)   # the sweep at step 6 or 4
    assert ex.wq.counts()["FINISHED"] == 6


def test_train_executor_survives_worker_failure_and_failover():
    """Twin of test_system.py:55."""
    ex = _executor(num_workers=3)
    ex.submit_steps(9)
    ex.tick()
    ex.fail_worker(1)                      # node loss mid-flight
    ex.promote_secondary()                 # supervisor loss
    ex.run()
    assert ex.wq.counts()["FINISHED"] == 9
    assert ex.steering.q4_tasks_left() == 0
    assert ex.supervisor.state.generation == 1


def test_train_executor_steering_prune_reduces_work():
    """Twin of test_system.py:67."""
    ex = _executor()
    ex.submit_steps(6, lr_scale=1.0, sweep_id=0)
    ex.submit_steps(6, lr_scale=8.0, sweep_id=1)   # diverging member
    ex.tick()
    # user steers: prune the high-lr sweep member (paper Q8/data reduction)
    pruned = ex.steering.prune("in0", 7.0, 9.0)
    assert pruned > 0
    ex.run()
    c = ex.wq.counts()
    assert c["PRUNED"] == pruned
    assert c["FINISHED"] + c["PRUNED"] == 12


def test_checkpoint_resume_mid_workflow(tmp_path):
    """Twin of test_system.py:82."""
    ck = Checkpointer(str(tmp_path), async_write=False)
    ex = _executor(checkpointer=ck, checkpoint_every=4)
    ex.submit_steps(8)
    for _ in range(4):
        ex.tick()
    ck.save(ex.step, ex.state, ex.wq)      # explicit cut, then "crash"
    step, state, wq = ck.restore(_state(ex.cfg, seed=5))
    left = (wq.counts()["READY"] + wq.counts()["RUNNING"]
            + wq.counts()["BLOCKED"])
    assert wq.counts()["FINISHED"] == step
    assert left == 8 - step
    want = _leaves(ex.state)
    for k, t in _leaves(state).items():
        assert torch.equal(t, want[k]), k


# ---------------------------------------------- test_checkpoint_and_data
def test_checkpoint_roundtrip(tmp_path):
    """Twin of test_checkpoint_and_data.py:17 (restored into a state from
    another seed, so that equal leaves mean restored ones)."""
    cfg = smoke_config("qwen2-0.5b")
    state = _state(cfg)
    wq = WorkQueue(num_workers=2, device="cpu")
    wq.add_tasks(0, 6)
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(10, state, wq)
    step, restored, wq2 = ck.restore(_state(cfg, seed=1))
    assert step == 10
    want = _leaves(state)
    got = _leaves(restored)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert wq2.store.n_rows == 6
    assert wq2.num_workers == 2
    manifest = json.loads((tmp_path / "step_00000010" /
                           "manifest.json").read_text())
    assert manifest["has_store"] and "params/embed.weight" in \
        manifest["leaves"]


def test_checkpoint_roundtrip_bf16(tmp_path):
    """bf16 leaves are stored as their bit patterns and come back equal."""
    state = {"w": torch.randn(5, 3).to(torch.bfloat16),
             "n": {"s": torch.tensor(7, dtype=torch.int32)}}
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, state)
    _, got, wq = ck.restore({"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                             "n": {"s": torch.tensor(0, dtype=torch.int32)}})
    assert wq is None
    assert torch.equal(got["w"], state["w"]) and int(got["n"]["s"]) == 7


def test_checkpoint_gc_and_latest(tmp_path):
    """Twin of test_checkpoint_and_data.py:32."""
    state = _state(smoke_config("qwen2-0.5b"))
    ck = Checkpointer(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert ck.latest_step() == 4
    dirs = sorted(p.name for p in tmp_path.iterdir())
    assert dirs == ["step_00000003", "step_00000004"]


def test_checkpoint_detects_corruption(tmp_path):
    """Twin of test_checkpoint_and_data.py:43."""
    state = _state(smoke_config("qwen2-0.5b"))
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, state)
    d = tmp_path / "step_00000001"
    with np.load(d / "arrays.npz") as z:
        flat = {k: z[k].copy() for k in z.files}
    key = next(iter(flat))
    flat[key] = flat[key] + 1.0
    np.savez(d / "arrays.npz", **flat)
    with pytest.raises(IOError):
        ck.restore(state)


def test_torn_checkpoint_is_skipped(tmp_path):
    """A step whose manifest is torn is skipped: latest_step and restore
    fall back to the previous complete step."""
    state = _state(smoke_config("qwen2-0.5b"))
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, state)
    ck.save(2, state)
    (tmp_path / "step_00000002" / "manifest.json").write_text("{trunc")
    assert ck.latest_step() == 1
    assert ck.restore(state)[0] == 1
    with pytest.raises(IOError):
        ck.restore(state, step=2)


def test_async_checkpoint_completes(tmp_path):
    """Twin of test_checkpoint_and_data.py:58."""
    state = _state(smoke_config("qwen2-0.5b"))
    ck = Checkpointer(str(tmp_path), async_write=True)
    ck.save(7, state)
    ck.wait()
    assert ck.latest_step() == 7


def test_data_pipeline_deterministic_per_shard():
    """Twin of test_checkpoint_and_data.py:67; the batches are the
    reference's, bit for bit."""
    cfg = smoke_config("qwen2-0.5b")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)
    b1 = batch_for(cfg, dc, 7)
    b2 = batch_for(cfg, dc, 7)
    b3 = batch_for(cfg, dc, 8)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert (b1["tokens"] != b3["tokens"]).any()
    # labels are next-token shifted
    assert b1["labels"].shape == b1["tokens"].shape
    jcfg = jax_smoke_config("qwen2-0.5b")
    for shard in (0, 7, 1 << 19):
        want = jpipeline.batch_for(jcfg, jpipeline.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=32, batch_size=4), shard)
        got = batch_for(cfg, dc, shard)
        assert all(np.array_equal(got[k], want[k]) and
                   got[k].dtype == want[k].dtype for k in want)


def test_data_pipeline_families():
    """Twin of test_checkpoint_and_data.py:79 (the enc-dec frames, the VLM
    patch embeddings and M-RoPE positions, the SSM tokens), each batch the
    reference's, bit for bit."""
    for arch in ("seamless-m4t-large-v2", "qwen2-vl-2b", "mamba2-1.3b"):
        cfg = smoke_config(arch)
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)
        b = batch_for(cfg, dc, 0)
        if cfg.family == "encdec":
            assert b["frames"].shape[-1] == cfg.d_model
        elif cfg.embed_stub:
            assert b["embeds"].shape == (2, 16, cfg.d_model)
        else:
            assert b["tokens"].shape == (2, 16)
        want = jpipeline.batch_for(jax_smoke_config(arch), jpipeline.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=16, batch_size=2), 0)
        assert b.keys() == want.keys()
        assert all(np.array_equal(b[k], want[k]) and b[k].dtype == want[k].dtype
                   for k in want)


def test_prefetcher_returns_the_shard_batch():
    cfg = smoke_config("qwen2-0.5b")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)
    pf = Prefetcher(cfg, dc)
    pf.prefetch(3)
    got = pf.get(3)
    assert np.array_equal(got["tokens"], batch_for(cfg, dc, 3)["tokens"])
    assert np.array_equal(pf.get(4)["tokens"], batch_for(cfg, dc, 4)["tokens"])


def test_reference_reads_the_ports_store(tmp_path):
    """``store.npz`` is the reference's format: its checkpointer loads the
    port's into equal columns."""
    ex = _executor()
    ex.submit_steps(4)
    ex.run()
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(ex.step, ex.state, ex.wq)
    store, meta = JaxCheckpointer._load_store(
        tmp_path / f"step_{ex.step:08d}" / "store.npz")
    assert meta["num_workers"] == 2 and store.n_rows == ex.wq.store.n_rows
    for name in ex.wq.store.cols:
        assert np.array_equal(store.col(name), ex.wq.store.col(name),
                              equal_nan=True), name


# -------------------------------------------- the control-plane arms
CONTROL_PLANE_ARMS = ["analyst_replica", "analyst_remote", "shards",
                      "checkpoint_router", "unknown_analyst",
                      "resume_of_another_kind"]


@pytest.mark.parametrize("arm", CONTROL_PLANE_ARMS)
def test_control_plane_arms_run_on_the_cpu(tmp_path, arm):
    """Each arm of the executor and the checkpointer that needs the
    replication and sharding modules runs to its end: the replica analyst
    (in-process delta replica, its columns the live ones), the remote
    analyst (a replica process; its sweeps run there), two shards behind
    the router (scatter-gather sweeps), and the sharded checkpoint saved
    from and restored into a router; an unknown analyst still raises, and
    so does a resume from a checkpoint of the other kind (a queue into a
    sharded executor, a router into an unsharded one)."""
    cfg = smoke_config("qwen2-0.5b")
    if arm == "unknown_analyst":
        with pytest.raises(ValueError, match="unknown analyst"):
            TrainExecutor(cfg, device="cpu", analyst="nope")
        return
    if arm == "resume_of_another_kind":
        from repro_torch.core import ShardRouter
        sharded = _executor(cfg, shards=2, num_workers=4)
        single = _executor(cfg)
        for ex, other in ((sharded, WorkQueue(4, device="cpu")),
                          (single, ShardRouter(2, 2, device="cpu"))):
            keep = (ex.router, ex.wq, ex.step)
            with pytest.raises(ValueError, match="cannot resume"):
                ex.resume(3, ex.state, other)
            assert (ex.router, ex.wq, ex.step) == keep
            if isinstance(other, ShardRouter):
                other.close()
            ex.close()
        return
    kw = {"analyst_replica": {"analyst": "replica"},
          "analyst_remote": {"analyst": "remote"},
          "shards": {"shards": 2, "num_workers": 4},
          "checkpoint_router": {"shards": 2, "num_workers": 4,
                                "analyst": "replica"}}[arm]
    ck = Checkpointer(str(tmp_path), async_write=False)
    ex = _executor(cfg, steer_every=2, checkpointer=ck, checkpoint_every=2,
                   **kw)
    ex.submit_steps(4)
    hist = ex.run()
    assert len(hist) == 4 and ex.last_steering is not None
    if ex.router is None:
        assert ex.wq.counts()["FINISHED"] == 4
        assert ex.replica.records_applied > 0
        if arm == "analyst_remote":
            assert ex.replica.remote_pid != os.getpid()
        else:
            view = ex.replica.snapshot_view()
            for n in ex.wq.store.cols:
                assert np.array_equal(view.col(n), ex.wq.store.col(n),
                                      equal_nan=True), n
    else:
        assert ex.router.tasks_left() == 0
        assert isinstance(ex.last_steering["version"], list)
    ex.close()
    if arm == "checkpoint_router":
        step, state, router = ck.restore(_state(cfg, seed=3),
                                         router_kw={"device": "cpu",
                                                    "replicate": "delta"})
        assert step == 4 and router.num_shards == 2
        assert sum(int(sh.wq.counts()["FINISHED"])
                   for sh in router.shards) == 4
        want = _leaves(ex.state)
        assert all(torch.equal(t, want[k])
                   for k, t in _leaves(state).items())
        # a sharded resume drives the restored router
        ex2 = _executor(cfg, steer_every=2, **kw)
        ex2.resume(step, state, router)
        assert ex2.router is router and ex2.wq is router.shards[0].wq
        ex2.submit_steps(2)
        assert len(ex2.run()) == 2 and ex2.step == 6
        assert sum(int(sh.wq.counts()["FINISHED"])
                   for sh in router.shards) == 6
        assert router.shards[0].supervisor is not None
        ex2.close()


def test_train_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainExecutor(smoke_config("qwen2-0.5b"))


def test_train_command_line(capsys, tmp_path):
    """python -m repro_torch.launch.train --arch qwen2-0.5b --smoke
    --device cpu --steps 2, then again with --ckpt-dir and --resume: the
    resumed run picks up the checkpoint's queue and step and trains its 2
    new steps (the reference's command trains none after a resume)."""
    args = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--steps",
            "2", "--workers", "2"]
    train_cli.main(args)
    assert "trained 2 steps on cpu" in capsys.readouterr().out
    ck = ["--ckpt-dir", str(tmp_path)]
    train_cli.main(args + ck)
    train_cli.main(args + ck + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert out.count("trained 2 steps on cpu") == 2
    _, _, wq = Checkpointer(str(tmp_path)).restore(
        _state(smoke_config("qwen2-0.5b")))
    assert wq.counts()["FINISHED"] == 4


# --------------------------------------------- the SSM and hybrid families
def _executor_matches_reference(arch):
    """4 store-driven steps on 2 workers with device claims (the claim
    kernel's plain version on the CPU) and steering on snapshots: every
    task FINISHED with a finite loss written back to the store, and the
    loss history the reference's executor gives from the same init (the
    history test's limit)."""
    cfg = smoke_config(arch)
    jcfg = jax_smoke_config(arch)
    jex = JaxTrainExecutor(jcfg, num_workers=2, steer_every=2,
                           data_cfg=jpipeline.DataConfig(
                               vocab_size=cfg.vocab_size, seq_len=32,
                               batch_size=4))
    with flags.device_claims(True):
        ex = _executor(cfg, steer_every=2)
    assert ex.wq.device_claim
    ex.state = train_state_from_jax(
        cfg, jax.tree.map(np.asarray, jex.state), ex.state["params"])
    for e in (ex, jex):
        e.submit_steps(4)
    hist, jhist = ex.run(), jex.run()
    ex.close()
    losses = [h["loss"] for h in hist]
    assert len(hist) == 4 == ex.wq.counts()["FINISHED"]
    assert np.isfinite(losses).all()
    assert np.array_equal(np.sort(ex.wq.store.col("out0")[:4]),
                          np.sort(losses))
    assert ex.last_steering is not None
    np.testing.assert_allclose(losses, [h["loss"] for h in jhist],
                               rtol=HISTORY_REL_TOL)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_train_executor_trains_the_ssm_and_hybrid_families(arch):
    _executor_matches_reference(arch)


# ------------------------------------ the MoE, VLM and enc-dec families
NEW_FAMILIES = ["granite-moe-3b-a800m", "qwen2-vl-2b",
                "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_train_executor_trains_the_moe_vlm_and_encdec_families(arch):
    """As the SSM and hybrid twin: the batches are the pipeline's patch
    embeddings and M-RoPE positions (VLM) or frames and tokens (enc-dec);
    the MoE loss carries its aux term."""
    _executor_matches_reference(arch)


@pytest.mark.parametrize("arch", NEW_FAMILIES + ["kimi-k2-1t-a32b"])
def test_checkpoint_roundtrip_new_families(tmp_path, arch):
    """The expert slabs, the router, the encoder and decoder stacks and
    their optimizer state (kimi-k2: Adafactor's statistics keyed by the
    reference's leaves, ``layers/moe/up``, ...) save and restore equal."""
    cfg = smoke_config(arch)
    state = _state(cfg)
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(3, state)
    step, restored, _ = ck.restore(_state(cfg, seed=1))
    assert step == 3
    flat = lambda st: dict(ck_leaves(st))      # noqa: E731
    want, got = flat(state), flat(restored)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    if cfg.moe is not None:
        assert any(".moe.up" in k for k in want)
    if cfg.optimizer == "adafactor":
        assert "opt/inner/layers/moe/up/vr" in want


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_train_command_line_moe_vlm_encdec(capsys, arch):
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "2", "--workers", "2", "--seq-len", "32", "--batch",
                    "4"])
    assert "trained 2 steps on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_train_command_line_ssm_and_hybrid(capsys, arch):
    """python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu --steps 2 trains its 2 steps."""
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "2", "--workers", "2", "--seq-len", "32", "--batch",
                    "4"])
    assert "trained 2 steps on cpu" in capsys.readouterr().out
