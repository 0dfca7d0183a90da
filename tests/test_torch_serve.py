"""The port's ServeExecutor: a twin of the reference's serve test on the CPU,
greedy outputs identical to the reference executor (Pallas kernels in
interpret mode) on converted params, for the dense, SSM, hybrid and MoE
families; the VLM and enc-dec families, which the reference's executor
cannot serve (it feeds token prompts alone), fail in the port as they fail
there; and no silent move to the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.runtime.executor import ServeExecutor as JaxServeExecutor  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.interop import load_jax_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.executor import ServeExecutor  # noqa: E402


def _prompts(cfg, n=5, s=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, s)).astype(np.int32)


def test_serve_executor_continuous_batching():
    cfg = smoke_config("qwen2-0.5b")
    ex = ServeExecutor(cfg, slots=2, max_len=48, device="cpu")
    ids = ex.submit(_prompts(cfg), max_new=5)
    n = ex.drain()
    assert n == 5
    for t in ids:
        out = ex.wq.store.blobs[int(t)]["output"]
        assert len(out) == 5
    assert ex.wq.counts()["FINISHED"] == 5
    assert (ex.wq.store.col("out0")[:5] == 5.0).all()


def _greedy_parity(arch):
    """Both executors on the same (converted) params and prompts: the same
    greedy outputs, token for token, and the same store."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), attn_impl="pallas")
    ref = JaxServeExecutor(jcfg, slots=2, max_len=48)
    cfg = smoke_config(arch)
    ex = ServeExecutor(cfg, slots=2, max_len=48, device="cpu")
    ex.set_params(load_jax_params(ex.params,
                                  jax.tree.map(np.asarray, ref.params)))
    prompts = _prompts(cfg, s=9, seed=3)
    ids_ref = ref.submit(prompts, max_new=6)
    ids = ex.submit(prompts, max_new=6)
    assert ref.drain() == ex.drain() == 5
    for a, b in zip(ids_ref, ids):
        assert np.array_equal(ref.wq.store.blobs[int(a)]["output"],
                              ex.wq.store.blobs[int(b)]["output"])
    assert np.array_equal(ref.wq.store.col("status"),
                          ex.wq.store.col("status"))


def test_greedy_outputs_identical_to_reference_executor():
    _greedy_parity("qwen2-0.5b")


def test_ssm_greedy_outputs_identical_to_reference_executor():
    """mamba2: the reference prefills with its chunked SSD form, the port
    with the plain scan the CPU dispatch reaches."""
    _greedy_parity("mamba2-1.3b")


def test_hybrid_greedy_outputs_identical_to_reference_executor():
    """recurrentgemma (smoke: window 8, so the 9-token prompts wrap the ring
    of K/V in the prefill and again while decoding): the reference prefills
    with its associative scan, the port with the plain scan the CPU
    dispatch reaches."""
    _greedy_parity("recurrentgemma-9b")


def test_moe_greedy_outputs_identical_to_reference_executor():
    """granite-moe (smoke: 4 experts, top 2, sort dispatch): capacity 1 a
    token at decode, as in the reference."""
    _greedy_parity("granite-moe-3b-a800m")


@pytest.mark.parametrize("arch,key", [("qwen2-vl-2b", "embeds"),
                                      ("seamless-m4t-large-v2", "frames")])
def test_executor_fails_for_vlm_and_encdec_as_the_reference_does(arch, key):
    """Both executors admit a request by prefilling its token prompt alone,
    so the VLM prefill misses its patch embeddings and the enc-dec prefill
    its frames: the same KeyError on both sides. The port serves these
    families through the model bundle's prefill / decode_step instead
    (``tests/test_torch_vlm.py``, ``tests/test_torch_encdec.py``)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), attn_impl="pallas")
    ref = JaxServeExecutor(jcfg, slots=1, max_len=32)
    ex = ServeExecutor(smoke_config(arch), slots=1, max_len=32,
                       device="cpu")
    prompts = _prompts(jcfg, n=1)
    for e in (ref, ex):
        e.submit(prompts, max_new=2)
        with pytest.raises(KeyError, match=key):
            e.drain()


def test_max_len_cap_finishes_early():
    cfg = smoke_config("qwen2-0.5b")
    ex = ServeExecutor(cfg, slots=1, max_len=12, device="cpu")
    (tid,) = ex.submit(_prompts(cfg, n=1, s=8), max_new=10)
    assert ex.drain() == 1
    # the cache holds 8 prompt tokens; decode stops at idx == max_len - 1
    assert len(ex.wq.store.blobs[int(tid)]["output"]) == 4


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeExecutor(smoke_config("qwen2-0.5b"))


def test_cli_serves_on_requested_device(capsys):
    serve.main(["--smoke", "--requests", "3", "--slots", "2", "--max-new",
                "3", "--device", "cpu"])
    assert "served 3 requests" in capsys.readouterr().out


def test_cli_serves_mamba2_on_cpu(capsys):
    serve.main(["--arch", "mamba2-1.3b", "--smoke", "--requests", "3",
                "--slots", "2", "--max-new", "3", "--device", "cpu"])
    assert "served 3 requests" in capsys.readouterr().out


def test_cli_serves_granite_moe_on_cpu(capsys):
    serve.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--requests",
                "3", "--slots", "2", "--max-new", "3", "--device", "cpu"])
    assert "served 3 requests" in capsys.readouterr().out


def test_cli_serves_recurrentgemma_on_cpu(capsys):
    serve.main(["--arch", "recurrentgemma-9b", "--smoke", "--requests", "3",
                "--slots", "2", "--max-new", "3", "--device", "cpu"])
    assert "served 3 requests" in capsys.readouterr().out
