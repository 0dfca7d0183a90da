"""The cross-entropy of the chunked LM-head loss: the plain version against
autograd of the chain it stands for, the routes ``chunked_xent`` takes by
what its tensors show (CPU and meta: the plain chain as before; a DTensor:
the vocabulary-split terms; the card: the kernels through
``CrossEntropyFn``), and, marked ``gpu``, the kernels on the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cross_entropy.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.cross_entropy import ops as ce_ops  # noqa: E402
from repro_torch.kernels.cross_entropy.kernel import (  # noqa: E402
    cross_entropy_bwd, cross_entropy_fwd)
from repro_torch.kernels.cross_entropy.ref import (  # noqa: E402
    cross_entropy_bwd_ref, cross_entropy_ref)
from repro_torch.models import transformer as T  # noqa: E402


def _chain(logits, labels):
    """The loss terms as the port computed them before the kernels (and the
    reference computes them): the logits cast to fp32, their logsumexp and
    the label's logit."""
    lf = logits.float()
    return torch.logsumexp(lf, dim=-1), \
        torch.gather(lf, -1, labels[..., None].long())[..., 0]


def _old_xent_chunk(xi, table, li):
    logz, gold = _chain(xi @ table.T, li)
    return torch.sum(logz - gold)


def _old_chunked_xent(cfg, x, table, labels):
    b, s, _ = x.shape
    chunk = min(cfg.loss_chunk, s)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        tot = tot + checkpoint(_old_xent_chunk, x[:, c:c + chunk], table,
                               labels[:, c:c + chunk], use_reentrant=False,
                               preserve_rng_state=False)
    return tot / (b * s)


def _rows(rows, v, dtype, seed, device="cpu", scale=4.0):
    """Logits [rows, v] ~ scale N(0, 1) and labels [rows] with the first at
    0 and the second at v - 1 (int64), made with numpy."""
    rng = np.random.default_rng(seed)
    logits = torch.as_tensor(scale * rng.standard_normal((rows, v)),
                             dtype=torch.float32).to(dtype).to(device)
    labels = rng.integers(0, v, rows)
    labels[0], labels[1] = 0, v - 1
    return logits, torch.as_tensor(labels, device=device)


def _grad_out(kind, rows, device="cpu"):
    """The loss rows' gradient: one value for every row, expanded as a
    sum's backward gives it (stride 0), or one value a row; neither 1."""
    if kind == "scalar":
        return torch.tensor(0.37, device=device).expand(rows)
    rng = np.random.default_rng(rows)
    return torch.as_tensor(rng.uniform(-2.0, 2.0, rows),
                           dtype=torch.float32, device=device)


def _close(got, want, rel):
    """Every element within ``rel`` of its value, plus one bf16 step of
    it where the result is bf16 (both sides compute in fp32 and round
    once; a last-bit difference in fp32 can move that rounding)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = rel * want.float().abs() + 1e-30
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), float((diff / tol).max())


# ------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [1000, 50277])
def test_ref_forward_is_the_chain(v, dtype):
    logits, labels = _rows(6, v, dtype, seed=v)
    lse, gold = cross_entropy_ref(logits, labels)
    want_lse, want_gold = _chain(logits, labels)
    assert lse.dtype == gold.dtype == torch.float32
    assert torch.equal(lse, want_lse) and torch.equal(gold, want_gold)
    assert gold[0] == logits[0, 0].float() and \
        gold[1] == logits[1, v - 1].float()


@pytest.mark.parametrize("g_kind", ["scalar", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [1000, 50277])
def test_ref_backward_is_autograd_of_the_chain(v, dtype, g_kind):
    """The plain backward against autograd of the chain, labels at 0 and
    at V - 1 among them, for a gradient of the rows' loss that is not 1:
    fp32 to a few rounding steps (autograd adds g p and -g at the label
    apart), bf16 to one step of the result."""
    logits, labels = _rows(6, v, dtype, seed=v + 1)
    g = _grad_out(g_kind, 6)
    leaf = logits.clone().requires_grad_()
    lse, gold = _chain(leaf, labels)
    want, = torch.autograd.grad(lse - gold, leaf, g)
    got = cross_entropy_bwd_ref(logits, labels, lse.detach(), g)
    _close(got, want, 1e-6)
    for r, col in ((0, 0), (1, v - 1)):    # the labels' columns
        assert float(got[r, col]) < 0 < float(g[r]) or \
            float(got[r, col]) > 0 > float(g[r])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_xent_on_the_cpu_is_the_chain(dtype):
    """CPU tensors take the plain chain: the loss and both gradients equal,
    to the bit, what the chain gave before the kernels."""
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b"), loss_chunk=8)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 32, 16)),
                        dtype=torch.float32).to(dtype)
    table = torch.as_tensor(rng.standard_normal((300, 16)),
                            dtype=torch.float32).to(dtype)
    labels = torch.as_tensor(rng.integers(0, 300, (2, 33)),
                             dtype=torch.int32)[:, 1:]   # as batch_for cuts
    got, want = [], []
    for fn, out in ((T.chunked_xent, got), (_old_chunked_xent, want)):
        xs, ts = x.clone().requires_grad_(), table.clone().requires_grad_()
        loss = fn(cfg, xs, ts, labels)
        out += [loss, *torch.autograd.grad(loss, (xs, ts))]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_chunked_xent_on_meta_takes_the_plain_chain(monkeypatch):
    """Meta tensors (the dry run's count) take the plain version: the same
    operations as before, no launcher reached."""
    calls = []
    monkeypatch.setattr(ce_ops, "cross_entropy_ref",
                        lambda *a: calls.append(1) or cross_entropy_ref(*a))
    monkeypatch.setattr(ce_ops, "by_rows", lambda *a: pytest.fail("kernels"))
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b"), loss_chunk=8)
    x = torch.empty((2, 32, 16), dtype=torch.bfloat16,
                    device="meta").requires_grad_()
    table = torch.empty((300, 16), dtype=torch.bfloat16, device="meta")
    labels = torch.empty((2, 32), dtype=torch.int32, device="meta")
    loss = T.chunked_xent(cfg, x, table, labels)
    assert loss.device.type == "meta" and loss.shape == () and \
        loss.dtype == torch.float32
    assert len(calls) == 4
    gx, = torch.autograd.grad(loss, x)
    assert gx.shape == x.shape and gx.device.type == "meta"


def test_dtensor_logits_keep_the_vocab_split_terms(monkeypatch):
    """A DTensor's logits (a one-rank mesh, the vocabulary split over
    "model") join their slices' terms as before and never reach the
    kernels' dispatcher; the loss equals the plain chain's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    monkeypatch.setattr(kops, "cross_entropy",
                        lambda *a: pytest.fail("dispatcher reached"))
    split = []
    vocab = T._vocab_split_terms
    monkeypatch.setattr(T, "_vocab_split_terms",
                        lambda *a: split.append(1) or vocab(*a))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        rng = np.random.default_rng(1)
        xi = torch.as_tensor(rng.standard_normal((2, 8, 16)),
                             dtype=torch.float32)
        table = torch.as_tensor(rng.standard_normal((300, 16)),
                                dtype=torch.float32)
        li = torch.as_tensor(rng.integers(0, 300, (2, 8)))
        got = T._xent_chunk(distribute_tensor(xi, mesh, [Replicate()]),
                            distribute_tensor(table, mesh, [Shard(0)]),
                            distribute_tensor(li, mesh, [Replicate()]))
        assert split == [1]
        torch.testing.assert_close(got.full_tensor(),
                                   _old_xent_chunk(xi, table, li))
    finally:
        dist.destroy_process_group()


def test_launchers_refuse_cpu_tensors():
    logits, labels = _rows(4, 100, torch.float32, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        cross_entropy_fwd(logits, labels)
    lse, _ = cross_entropy_ref(logits, labels)
    with pytest.raises(ValueError, match="CUDA"):
        cross_entropy_bwd(logits, labels, lse, torch.ones(4))


def test_kernels_route_under_the_chunks_checkpoint(monkeypatch):
    """The kernels' route (``by_rows`` and ``CrossEntropyFn``) driven on the
    CPU with the plain versions standing in for the launchers: each chunk's
    forward runs twice (the checkpoint's recompute), its backward once, on
    the logits as the GEMM gives them (bf16, not cast), with the rows'
    gradient as the sum's backward expands it (all strides 0: one value
    for every row, read from device memory, not copied); loss and
    gradients those of the plain chain."""
    seen = {"fwd": 0, "bwd": 0, "strides": set(), "dtypes": set()}

    def fwd(logits, labels):
        seen["fwd"] += 1
        seen["dtypes"].add(logits.dtype)
        return cross_entropy_ref(logits, labels)

    def bwd(logits, labels, lse, g):
        seen["bwd"] += 1
        seen["strides"].add(g.stride())
        return cross_entropy_bwd_ref(logits, labels, lse, g)

    monkeypatch.setattr(ce_ops, "cross_entropy_fwd", fwd)
    monkeypatch.setattr(ce_ops, "cross_entropy_bwd", bwd)
    monkeypatch.setattr(kops, "cross_entropy", ce_ops.by_rows)
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b"), loss_chunk=8)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((2, 32, 16)),
                        dtype=torch.bfloat16)
    table = torch.as_tensor(rng.standard_normal((300, 16)),
                            dtype=torch.bfloat16)
    labels = torch.as_tensor(rng.integers(0, 300, (2, 32)),
                             dtype=torch.int32)
    got, want = [], []
    for fn, out in ((T.chunked_xent, got), (_old_chunked_xent, want)):
        xs, ts = x.clone().requires_grad_(), table.clone().requires_grad_()
        loss = fn(cfg, xs, ts, labels)
        out += [loss, *torch.autograd.grad(loss, (xs, ts))]
    chunks = 32 // 8
    assert seen["fwd"] == 2 * chunks and seen["bwd"] == chunks
    assert seen["strides"] == {(0,)} and seen["dtypes"] == {torch.bfloat16}
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                   atol=1e-4)


# --------------------------------------------------------------- the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# lse: the kernel sums 2^(l log2 e - m) on the special-function unit (~2
# ulp a term) in another order than torch's logsumexp. The gradient: each
# side rounds the exponent's argument (l - lse, or l log2 e - lse log2 e)
# to fp32, half an ulp of up to ~40 at these logits (scale 4), ~2.4e-6 of
# a small p each, before the exp; then both round once to the logits'
# dtype
LSE_REL, GRAD_REL = 2e-6, 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,v", [(4096, 151936), (1000, 50277)])
def test_kernels_against_the_plain_version(dev, rows, v, dtype):
    """At qwen2-0.5b's chunk (16 x 256 rows of 151,936) and at a ragged V
    (50,277: every row starts off a 16-byte boundary), in bf16 and fp32:
    lse within LSE_REL, the gold logit exact, the gradient for a scalar and
    a per-row upstream gradient within GRAD_REL (plus one step of a bf16
    result), labels at 0 and V - 1 among them; repeats bit-identical."""
    logits, labels = _rows(rows, v, dtype, seed=rows + v, device=dev)
    lse, gold = cross_entropy_fwd(logits, labels)
    want_lse, want_gold = cross_entropy_ref(logits, labels)
    _close(lse, want_lse, LSE_REL)
    assert torch.equal(gold, want_gold)
    again = cross_entropy_fwd(logits, labels)
    assert torch.equal(again[0], lse) and torch.equal(again[1], gold)
    for kind in ("scalar", "rows"):
        g = _grad_out(kind, rows, device=dev)
        got = cross_entropy_bwd(logits, labels, lse, g)
        _close(got, cross_entropy_bwd_ref(logits, labels, want_lse, g),
               GRAD_REL)
        assert torch.equal(got, cross_entropy_bwd(logits, labels, lse, g))
    # int32 labels read the same columns
    lab32 = labels.to(torch.int32)
    assert torch.equal(cross_entropy_fwd(logits, lab32)[1], gold)


@pytest.mark.gpu
def test_chunked_xent_launches_the_kernels_on_card(dev):
    """``chunked_xent`` on the card: 2 forward launches a chunk (the
    checkpoint's recompute) and 1 backward; loss and gradients those of
    the CPU's plain chain on the same inputs in fp32."""
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b"), loss_chunk=256)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1024, 64)).astype(np.float32)
    table = rng.standard_normal((1000, 64)).astype(np.float32) * 0.3
    labels = rng.integers(0, 1000, (2, 1024)).astype(np.int32)
    out = {}
    for d in ("cpu", dev):
        xs = torch.as_tensor(x, device=d).requires_grad_()
        ts = torch.as_tensor(table, device=d).requires_grad_()
        reset_launch_counts()
        loss = T.chunked_xent(cfg, xs, ts, torch.as_tensor(labels, device=d))
        out[str(d)] = [loss, *torch.autograd.grad(loss, (xs, ts))]
        counts = launch_counts()
    assert counts["cross_entropy"] == 2 * 4 and \
        counts["cross_entropy_bwd"] == 4
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_loss_backward_adds_no_host_sync(dev):
    """The loss's forward and backward (bf16, as trained) under
    ``set_sync_debug_mode("error")``: no call waits for the card, the
    backward reading its upstream gradient from device memory."""
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b"), loss_chunk=256)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((2, 512, 64)),
                        dtype=torch.bfloat16, device=dev).requires_grad_()
    table = torch.as_tensor(rng.standard_normal((1000, 64)),
                            dtype=torch.bfloat16, device=dev)
    labels = torch.as_tensor(rng.integers(0, 1000, (2, 512)), device=dev)

    def step():
        loss = T.chunked_xent(cfg, x, table, labels)
        return torch.autograd.grad(loss, x)[0]

    step()                     # builds and loads the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gx = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(gx.float()).all())
