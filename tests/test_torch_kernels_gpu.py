"""Each CUDA kernel of the port against its plain PyTorch version on the
card. Marked ``gpu``: whether a card is present is decided in a fixture, so
every process collects the same tests; without a card they skip.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import WorkQueue  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.wq_claim.kernel import wq_claim_fwd  # noqa: E402
from repro_torch.kernels.wq_claim.ref import wq_claim_ref  # noqa: E402
from repro_torch.models.attention import _sdpa  # noqa: E402
from repro_torch.runtime.executor import ServeExecutor  # noqa: E402

pytestmark = pytest.mark.gpu

# fp32: the kernel sums in another order than the plain einsum. bf16: both
# sides compute in fp32 and round the output to bf16 once, so an element may
# also differ by one bf16 step of its value, 2**-7 * |ref|; a key dropped or
# added at a ragged kv_len moves outputs by far more.
FP32_TOL = 2e-5


def _assert_close(got, want):
    """Every element within the per-element limit above."""
    assert got.dtype == want.dtype
    tol = FP32_TOL
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                           device=dev).to(dtype)


@pytest.mark.parametrize("n,w,k", [
    (1, 1, 1), (1000, 1, 3), (1024, 7, 1), (5000, 16, 4), (100_000, 936, 1),
    (262_144, 64, 4), (70_001, 13_000, 2),      # W past the shared-memory path
])
def test_wq_claim_kernel_equals_plain(dev, n, w, k):
    rng = np.random.default_rng(n + w)
    status = torch.as_tensor(rng.choice([0, 1, 2, 3, 4], n).astype(np.int32),
                             device=dev)
    worker = torch.as_tensor(rng.integers(-2, w + 2, n).astype(np.int32),
                             device=dev)
    got = wq_claim_fwd(status, worker, num_workers=w, k=k)
    want = wq_claim_ref(status, worker, num_workers=w, k=k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window,dtype", [
    (1, 1000, 14, 2, 64, True, 0, torch.float32),
    (1, 1000, 14, 2, 64, True, 0, torch.bfloat16),
    (2, 333, 4, 4, 128, False, 0, torch.float32),
    (1, 200, 2, 1, 112, True, 64, torch.float32),
    (1, 130, 8, 2, 256, True, 0, torch.bfloat16),
    (3, 1, 4, 2, 64, True, 0, torch.float32),
])
def test_flash_kernel_equals_plain(dev, b, s, hq, hkv, dh, causal, window,
                                   dtype):
    rng = np.random.default_rng(s)
    q = _randn(rng, (b, s, hq, dh), dtype, dev)
    k, v = (_randn(rng, (b, s, hkv, dh), dtype, dev) for _ in range(2))
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _assert_close(got, want)


@pytest.mark.parametrize("b,smax,hq,hkv,dh,kv_len,dtype", [
    (1, 4096, 14, 2, 64, 1, torch.bfloat16),
    (1, 4096, 14, 2, 64, 1031, torch.bfloat16),
    (1, 4096, 14, 2, 64, 1031, torch.float32),
    (1, 4096, 14, 2, 64, 4096, torch.bfloat16),
    (2, 1024, 4, 2, 64, 700, torch.float32),
    (1, 2048, 8, 1, 128, 2048, torch.float32),
    (2, 1024, 4, 4, 112, 513, torch.float32),
    (1, 300, 32, 2, 256, 299, torch.bfloat16),   # 16 query heads per KV head
])
def test_decode_kernel_equals_plain(dev, b, smax, hq, hkv, dh, kv_len,
                                    dtype):
    rng = np.random.default_rng(kv_len)
    q = _randn(rng, (b, 1, hq, dh), dtype, dev)
    k, v = (_randn(rng, (b, smax, hkv, dh), dtype, dev) for _ in range(2))
    kvl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    got = decode_attention_fwd(q, k, v, kvl)
    want = decode_attention_ref(q, k, v, kvl)
    torch.cuda.synchronize()
    _assert_close(got, want)


def test_dispatch_launches_kernels_or_raises(dev):
    q = torch.zeros((1, 4, 2, 64), device=dev)
    reset_launch_counts()
    kops.flash_attention(q, q, q)
    kops.decode_attention(q[:, :1], q, q,
                          kv_len=torch.tensor([3], dtype=torch.int32,
                                              device=dev))
    kops.wq_claim(torch.full((5,), 2, dtype=torch.int32, device=dev),
                  torch.zeros(5, dtype=torch.int32, device=dev),
                  num_workers=1, k=2)
    _sdpa(q[:, :1], q[:, :1], q[:, :1], causal=True)   # 1-token prefill
    assert launch_counts() == {"wq_claim": 1, "flash_attention": 2,
                               "decode_attention": 1}
    with pytest.raises(TypeError):
        kops.flash_attention(q.half(), q.half(), q.half())


def test_device_claim_queue_on_card(dev):
    a = WorkQueue(num_workers=9, device_claim=True, device=dev)
    b = WorkQueue(num_workers=9, device="cpu")
    for q in (a, b):
        q.add_tasks(0, 500)
    for r, k in enumerate((1, 4, 2)):
        got, want = a.claim_all(k=k, now=float(r)), \
            b.claim_all_reference(k=k, now=float(r))
        assert all(np.array_equal(got[w], want[w]) for w in want)


def test_serve_on_card_matches_cpu(dev):
    cfg = smoke_config("qwen2-0.5b")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 70)).astype(np.int32)
    outs = {}
    for name in ("cuda", "cpu"):
        ex = ServeExecutor(cfg, slots=2, max_len=96, device=name)
        if name == "cpu":
            ex.set_params(copy.deepcopy(outs["params"]).to("cpu"))
        outs["params"] = ex.params
        ids = ex.submit(prompts, max_new=6)
        assert ex.drain() == 3
        outs[name] = [ex.wq.store.blobs[int(t)]["output"] for t in ids]
    assert all(np.array_equal(a, b) for a, b in zip(outs["cuda"],
                                                    outs["cpu"]))
