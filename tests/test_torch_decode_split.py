"""The split of the decode attention kernel, checked on the CPU: how many
blocks ``num_splits`` gives (a pure function of the SM count and the
shapes), and a plain-PyTorch model of the kernel's scheme (tile-wise online
softmax within each split, then the splits merged cluster by cluster and the
cluster partials merged last) against the port's plain version and the
reference's oracles. Tolerance: the reference's own, 2e-5 in fp32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    CLUSTER, MAX_SPLITS, MIN_CHUNK, num_splits)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402

H100_SMS = 132
TILE = 16     # cache positions per tile (csrc/decode_attention.cu kTile)


@pytest.mark.parametrize("batch,hkv,smax", [
    (1, 1, 2048),    # recurrentgemma-9b's ring
    (1, 2, 4096),    # qwen2-0.5b's cache
    (1, 1, 4096),    # recurrentgemma-9b with a linear cache
])
def test_num_splits_fill_the_card(batch, hkv, smax):
    nsplit = num_splits(H100_SMS, batch, hkv, smax)
    assert batch * hkv * nsplit >= H100_SMS
    assert batch * hkv * nsplit <= 2 * H100_SMS
    assert nsplit % CLUSTER == 0


@pytest.mark.parametrize("sms", [16, 132, 1000])
@pytest.mark.parametrize("batch,hkv", [(1, 1), (1, 2), (2, 8), (64, 8)])
@pytest.mark.parametrize("smax", [1, 8, 40, 300, 2048, 4096, 32768])
def test_num_splits_never_below_min_chunk(sms, batch, hkv, smax):
    """Whole clusters, no more than the kernel's last merge holds, and no
    split shorter than MIN_CHUNK positions of a full cache unless one
    cluster is already too many."""
    nsplit = num_splits(sms, batch, hkv, smax)
    assert nsplit >= CLUSTER and nsplit % CLUSTER == 0
    assert nsplit <= MAX_SPLITS
    if nsplit > CLUSTER:
        assert smax / nsplit >= MIN_CHUNK


def _merge(parts):
    """(m, l, acc) partials merged as the kernel merges them: factors
    exp(m_k - M), none where every partial is empty (M = -inf)."""
    m = torch.stack([p[0] for p in parts])
    mx = m.amax(0)
    f = torch.where(mx == -torch.inf, torch.zeros_like(m),
                    torch.exp(m - mx))
    lsum = (f * torch.stack([p[1] for p in parts])).sum(0)
    acc = (f[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    return mx, lsum, acc


def split_decode_model(q, k, v, kv_len, window, nsplit):
    """The kernel's scheme in plain PyTorch (fp32): split s covers
    ceil(live / nsplit) live positions from max(0, kv_len - window); within
    it, tiles of TILE positions update (m, l, acc) with one max, one exp per
    score and one rescale per tile; the splits merge in clusters of
    CLUSTER, then the cluster partials merge."""
    b, _, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, hkv, g, dh)
    lo = max(0, kv_len - window) if window else 0
    chunk = -(-(kv_len - lo) // nsplit)
    parts = []
    for sp in range(nsplit):
        start, end = lo + sp * chunk, min(lo + (sp + 1) * chunk, kv_len)
        m = torch.full((b, hkv, g), -torch.inf)
        lsum = torch.zeros((b, hkv, g))
        acc = torch.zeros((b, hkv, g, dh))
        for t0 in range(start, end, TILE):
            t1 = min(t0 + TILE, end)
            s = torch.einsum("bhgd,bthd->bhgt", qg, k[:, t0:t1].float()) \
                * dh ** -0.5
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mn)
            p = torch.exp(s - mn[..., None])
            lsum = lsum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgt,bthd->bhgd", p, v[:, t0:t1].float())
            m = mn
        parts.append((m, lsum, acc))
    clusters = [_merge(parts[i:i + CLUSTER])
                for i in range(0, nsplit, CLUSTER)]
    _, lsum, acc = _merge(clusters)
    out = acc / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, hq, dh).to(q.dtype)


@pytest.mark.parametrize("hq,hkv", [(14, 2), (16, 1)])   # G 7 and 16
@pytest.mark.parametrize("window", [0, 700])
@pytest.mark.parametrize("kv_len", [1, 5, 1031, 2048])
def test_split_model_matches_ref_and_oracle(hq, hkv, window, kv_len):
    smax, dh = 2048, 32
    rng = np.random.default_rng(kv_len + hq)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((1, 1, hq, dh), (1, smax, hkv, dh), (1, smax, hkv, dh)))
    nsplit = num_splits(H100_SMS, 1, hkv, smax)
    got = split_decode_model(*map(torch.as_tensor, (q, k, v)), kv_len,
                             window, nsplit)
    want = decode_attention_ref(*map(torch.as_tensor, (q, k, v)),
                                torch.tensor([kv_len], dtype=torch.int32),
                                window)
    assert float((got - want).abs().max()) < 2e-5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if window:
        oracle = JA.sdpa_ref(jq, jk, jv, causal=True, window=window,
                             q_offset=kv_len - 1, kv_len=kv_len)
    else:
        oracle = jax_decode_ref(jq, jk, jv, kv_len)
    assert float(np.abs(got.numpy() - np.asarray(oracle)).max()) < 2e-5
