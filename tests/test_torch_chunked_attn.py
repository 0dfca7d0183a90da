"""The port's chunked attention (``models/chunked_attn.py``) against the
reference's on the same numpy inputs: the twin of
``tests/test_models_consistency.py::test_property_chunked_attention_matches_ref``
(the same strategy, both packages' ``chunked_sdpa``, 1e-5), its gradients
against autograd through the port's ``sdpa_ref`` (1e-5), and a model whose
``attn_impl`` is ``"chunked"`` on the CPU against the reference's with the
same params."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.chunked_attn import chunked_sdpa as jax_chunked_sdpa  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.interop import load_jax_params  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.chunked_attn import chunked_sdpa  # noqa: E402

TOL = 1e-5


def _qkv(seed, s, hq, hkv, dh=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, s, h, dh)).astype(np.float32)
                 for h in (hq, hkv, hkv))


@settings(max_examples=8, deadline=None)
@given(s=st.sampled_from([64, 128, 256]),
       hq=st.sampled_from([2, 4]), g=st.sampled_from([1, 2]),
       causal=st.booleans(), packed=st.booleans(),
       qc=st.sampled_from([16, 32, 64]))
def test_property_chunked_attention_matches_reference(s, hq, g, causal,
                                                      packed, qc):
    hkv = max(1, hq // g)
    q, k, v = _qkv(s + hq + qc, s, hq, hkv)
    ref = np.asarray(jax_chunked_sdpa(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      q_chunk=qc, packed=packed))
    got = chunked_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=causal, q_chunk=qc,
                       packed=packed).numpy()
    assert np.abs(got - ref).max() < TOL
    plain = A.sdpa_ref(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=causal).numpy()
    assert np.abs(got - plain).max() < TOL


@pytest.mark.parametrize("causal,packed,window,qc", [
    (True, False, 0, 16), (True, True, 0, 16), (False, False, 0, 32),
    (True, False, 24, 16), (True, True, 0, 64)])   # 64: one chunk, odd n
def test_gradients_match_autograd_of_sdpa_ref(causal, packed, window, qc):
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(7, 64, 4, 2))
    dout = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 64, 4, 16)).astype(np.float32))
    got = torch.autograd.grad(
        (chunked_sdpa(q, k, v, causal=causal, window=window, q_chunk=qc,
                      packed=packed) * dout).sum(), (q, k, v))
    want = torch.autograd.grad(
        (A.sdpa_ref(q, k, v, causal=causal, window=window) * dout).sum(),
        (q, k, v))
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() < TOL


def test_query_length_must_split_into_chunks():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 48, 2, 2))
    with pytest.raises(ValueError, match="multiple of q_chunk"):
        chunked_sdpa(q, k, v, causal=True, q_chunk=32)


@pytest.mark.parametrize("packed", [False, True])
def test_model_with_chunked_attention_matches_reference(packed):
    """The smoke qwen2's loss and prefill logits with ``attn_impl =
    "chunked"`` (4 chunks of 16 over 64 tokens) against the reference's
    on the same params."""
    upd = dict(attn_impl="chunked", q_chunk=16, packed_causal=packed)
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-0.5b"), **upd)
    tcfg = dataclasses.replace(smoke_config("qwen2-0.5b"), **upd)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = TT.init_params(tcfg, torch.Generator().manual_seed(1))
    load_jax_params(model, jax.tree.map(np.asarray, params))
    tok = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 65)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    ref_loss, _ = JT.train_loss(jcfg, params,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    got_loss, _ = TT.train_loss(tcfg, model,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert abs(float(got_loss.detach()) - float(ref_loss)) < TOL
    ref_logits, _ = JT.prefill(jcfg, params,
                               {"tokens": jnp.asarray(batch["tokens"])}, 80)
    with torch.no_grad():
        got_logits, _ = TT.prefill(tcfg, model,
                                   {"tokens": torch.from_numpy(
                                       batch["tokens"])}, 80)
    assert np.abs(got_logits.numpy() - np.asarray(ref_logits)).max() < 1e-4
