"""The port's dropless MoE dispatch, its grouped product, Granite's four
multipliers and the MoE layer's spans and counters, on the CPU.

The dropless path (``moe_ffn_dropless``) is held against the exact
all-experts oracle (``moe_ffn_dense``) on the same weights, in fp32:
output, aux loss and every gradient, with a skewed routing that leaves an
expert without a token, and with a ``pin``. Limits: 1e-5 of each tensor's
largest magnitude (fp32 sums in another order). Then: repeated runs agree
to the bit; ``kernels.ops.grouped_mm``'s CPU loop is the per-group
products; the multipliers at their defaults compute what the formulas
before them computed, bit for bit and op for op, and Granite's values
what a hand-written formula gives; the spans and counters appear only
with the tracer on.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

E, K, D, F = 8, 2, 16, 8


def _cfg(**kw) -> ModelConfig:
    return ModelConfig(
        name="tiny-moe", family="moe", num_layers=1, d_model=D, num_heads=4,
        num_kv_heads=2, head_dim=4, d_ff=F, vocab_size=64, loss_chunk=8,
        moe=MoEConfig(num_experts=E, top_k=K, expert_ff=F,
                      aux_loss_weight=0.01, dispatch="dropless"),
        dtype="float32", **kw)


def _layer(seed=1):
    return M.MoE(torch.Generator().manual_seed(seed), _cfg(), torch.float32)


def _oracle(p):
    """The dropless layer's weights in the oracle's layout."""
    return types.SimpleNamespace(router=p.router, gate=p.gate_up[..., :F],
                                 up=p.gate_up[..., F:], down=p.down,
                                 pin=p.pin)


def _run(fn, p, x, g):
    out, aux = fn(p, x, _cfg())
    leaves = [x, p.router, p.gate_up, p.down] if hasattr(p, "gate_up") \
        else [x]
    return out, aux, torch.autograd.grad((out * g).sum() + aux, leaves)


def _skewed(p, x):
    """Positive inputs, expert 0's router column large and expert E-1's
    negative: expert 0 takes nearly every token, E-1 none."""
    with torch.no_grad():
        p.router[:, 0] = 0.5
        p.router[:, E - 1] = -1.0
    return x.abs() + 0.1


def _pinned(p, x):
    """Every token pinned to experts t % 3 and (t + 1) % 3: the others
    empty."""
    def pin(idx):
        t = torch.arange(idx.shape[0])[:, None]
        return torch.remainder(t + torch.arange(K)[None, :], 3)
    p.pin = pin
    return x


def test_the_dropless_layer_stores_exactly_its_experts():
    p = _layer()
    assert {n: tuple(t.shape) for n, t in p.named_parameters()} == {
        "router": (D, E), "gate_up": (E, D, 2 * F), "down": (E, F, D)}


@pytest.mark.parametrize("case", [_skewed, _pinned],
                         ids=lambda f: f.__name__.strip("_"))
def test_dropless_equals_the_dense_oracle(case):
    p = _layer()
    x = case(p, torch.randn(2, 7, D, generator=torch.Generator()
                            .manual_seed(2))).requires_grad_(True)
    _, idx, _, counts = M._route(p, x.detach().reshape(-1, D), _cfg())
    assert float(counts.min()) == 0.0 and float(counts.sum()) == 14 * K
    g = torch.randn(2, 7, D, generator=torch.Generator().manual_seed(3))
    out, aux, grads = _run(M.moe_ffn_dropless, p, x, g)
    q = _oracle(p)
    want, want_aux = M.moe_ffn_dense(q, x, _cfg())
    want_grads = torch.autograd.grad(
        (want * g).sum() + want_aux, [x, p.router, p.gate_up, p.down])
    assert float((out - want).abs().max().detach()) <= 1e-5 * float(
        want.abs().max().detach())
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    for name, a, b in zip(("x", "router", "gate_up", "down"), grads,
                          want_grads):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), \
            name
    # the empty expert's weights get no gradient
    empty = int(torch.argmin(counts))
    assert float(grads[2][empty].abs().max()) == 0.0
    assert float(grads[3][empty].abs().max()) == 0.0


def test_dropless_runs_repeat_to_the_bit():
    p = _layer()
    x = torch.randn(3, 5, D, generator=torch.Generator().manual_seed(4),
                    requires_grad=True)
    g = torch.randn(3, 5, D, generator=torch.Generator().manual_seed(5))
    a, b = _run(M.moe_ffn_dropless, p, x, g), \
        _run(M.moe_ffn_dropless, p, x, g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(u, v) for u, v in zip(a[2], b[2]))


@pytest.mark.parametrize("n,e", [(1000, 40), (37, 5), (8, 3)])
def test_sorted_positions_are_the_stable_sort_by_expert(n, e):
    flat = torch.randint(0, e, (n,), generator=torch.Generator()
                         .manual_seed(n))
    want = torch.empty(n, dtype=torch.long).scatter_(
        0, torch.argsort(flat, stable=True), torch.arange(n))
    assert torch.equal(M._sorted_positions(flat, e), want)


def test_moe_ffn_takes_the_dropless_path():
    p = _layer()
    x = torch.randn(2, 3, D, generator=torch.Generator().manual_seed(6))
    got, want = M.moe_ffn(p, x, _cfg()), M.moe_ffn_dropless(p, x, _cfg())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_mm_cpu_loop_is_the_per_group_products(dtype):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(11, 6, generator=gen).to(dtype).requires_grad_(True)
    w = torch.randn(4, 6, 5, generator=gen).to(dtype).requires_grad_(True)
    offs = torch.tensor([3, 3, 9, 11], dtype=torch.int32)   # group 1 empty
    got = kops.grouped_mm(x, w, offs)
    want = torch.cat([x[0:3] @ w[0], x[3:9] @ w[2], x[9:11] @ w[3]])
    assert got.shape == (11, 5) and got.dtype == dtype
    assert torch.equal(got, want)
    g = torch.randn(11, 5, generator=gen).to(dtype)
    gx, gw = torch.autograd.grad(got, (x, w), g)
    wx, ww = torch.autograd.grad(want, (x, w), g)
    assert torch.equal(gx, wx) and torch.equal(gw, ww)
    assert float(gw[1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# Granite's multipliers
# ---------------------------------------------------------------------------
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _loss_grads_ops(cfg, params, batch):
    with _Ops() as rec:
        loss, _ = build_model(cfg).train_loss(params, batch)
        grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss, grads, rec.ops


def _before(monkeypatch):
    """The formulas the multipliers' code replaced, as they were."""
    monkeypatch.setattr(T, "_res", lambda cfg, x, out: x + out)
    monkeypatch.setattr(T, "_head_input", lambda cfg, x: x)
    monkeypatch.setattr(T, "_scale_embeds", lambda cfg, x: x)
    chunking = A._chunking
    monkeypatch.setattr(A, "_chunking", lambda cfg: {
        k: v for k, v in chunking(cfg).items() if k != "scale"})


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b"])
def test_default_multipliers_compute_what_the_formulas_before_did(
        arch, monkeypatch):
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    assert (cfg.embedding_multiplier, cfg.attention_multiplier,
            cfg.residual_multiplier, cfg.logits_scaling) == (1, 0, 1, 1)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    loss, grads, ops = _loss_grads_ops(cfg, params, batch)
    _before(monkeypatch)
    loss0, grads0, ops0 = _loss_grads_ops(cfg, params, batch)
    assert loss.item().hex() == loss0.item().hex()
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    assert ops == ops0


def _hand_loss(cfg, p, batch):
    """Granite's forward written out: one attention layer and one MoE
    layer (the exact oracle) with the four multipliers, the mean
    cross-entropy over the logits divided by ``logits_scaling``, plus the
    weighted aux loss."""
    lp = p.layers[0]
    x = p.embed.weight[batch["tokens"]] * cfg.embedding_multiplier
    h = lp.ln1(x)
    b, s, _ = x.shape
    pos = torch.arange(s)[None, :]
    q = L.apply_rope(lp.attn.q(h).reshape(b, s, 4, 4), pos, cfg.rope_theta)
    k = L.apply_rope(lp.attn.k(h).reshape(b, s, 2, 4), pos, cfg.rope_theta)
    v = lp.attn.v(h).reshape(b, s, 2, 4)
    att = A.sdpa_ref(q, k, v, causal=True, scale=cfg.attention_multiplier)
    x = x + cfg.residual_multiplier * lp.attn.o(att.reshape(b, s, 16))
    out, aux = M.moe_ffn_dense(_oracle(lp.moe), lp.ln2(x), cfg)
    x = x + cfg.residual_multiplier * out
    logits = p.final_norm(x) @ p.embed.weight.T / cfg.logits_scaling
    xent = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), batch["labels"].reshape(-1))
    return xent + cfg.moe.aux_loss_weight * aux


def test_granite_multipliers_match_the_hand_formula():
    cfg = _cfg(embedding_multiplier=12.0, attention_multiplier=0.015625,
               residual_multiplier=0.22, logits_scaling=6.0,
               tie_embeddings=True, rope_theta=10000.0)
    assert repr(cfg) == repr(dataclasses.replace(
        cfg, embedding_multiplier=1.0, attention_multiplier=0.0,
        residual_multiplier=1.0, logits_scaling=1.0))
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    loss, _ = build_model(cfg).train_loss(params, batch)
    want = _hand_loss(cfg, params, batch)
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    got = torch.autograd.grad(loss, list(params.parameters()))
    ref = torch.autograd.grad(want, list(params.parameters()))
    for (n, _), a, r in zip(params.named_parameters(), got, ref):
        assert float((a - r).abs().max()) <= 1e-5 * float(
            r.abs().max() + 1e-12), n
    # each multiplier moves the loss
    for field, neutral in (("embedding_multiplier", 1.0),
                           ("attention_multiplier", 0.0),
                           ("residual_multiplier", 1.0),
                           ("logits_scaling", 1.0)):
        other = dataclasses.replace(cfg, **{field: neutral})
        assert float(build_model(other).train_loss(params, batch)[0]) \
            != float(loss), field


def test_flash_reference_takes_a_scale():
    from repro_torch.kernels.flash_attention import ref
    gen = torch.Generator().manual_seed(8)
    q = torch.randn(1, 9, 4, 8, generator=gen, requires_grad=True)
    k = torch.randn(1, 9, 2, 8, generator=gen, requires_grad=True)
    v = torch.randn(1, 9, 2, 8, generator=gen, requires_grad=True)
    o = ref.flash_attention_ref(q, k, v, scale=0.05)
    want = A.sdpa_ref(q, k, v, causal=True, scale=0.05)
    assert torch.allclose(o, want, atol=1e-6)
    assert not torch.allclose(o, ref.flash_attention_ref(q, k, v), atol=1e-3)
    do = torch.randn_like(o)
    lse = ref.flash_attention_lse_ref(q, k, scale=0.05)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, scale=0.05)
    auto = torch.autograd.grad(want, (q, k, v), do)
    for a, b in zip(got, auto):
        assert torch.allclose(a, b, atol=1e-5)


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------
def test_moe_spans_and_counters_only_with_the_tracer_on():
    p = _layer()
    x = torch.randn(2, 5, D, generator=torch.Generator().manual_seed(9))
    was = trace.enabled()
    trace.take()
    try:
        trace.enable(False)
        M.moe_ffn_dropless(p, x, _cfg())
        assert trace.take() == []
        trace.enable(True)
        M.moe_ffn_dropless(p, x, _cfg())
        recs = trace.take()
    finally:
        trace.enable(was)
    spans = [r.name for r in recs if isinstance(r, trace.Span)]
    assert sorted(spans) == ["moe.combine", "moe.dispatch", "moe.experts",
                             "moe.route"]
    counters = [r for r in recs if isinstance(r, trace.Counter)]
    assert [c.name for c in counters] == ["moe.expert_load"]
    load = counters[0].value
    assert isinstance(load, list) and len(load) == E
    assert sum(load) == 10 * K and counters[0].wall_s == 0.0
