"""The ``local_map`` wrappers of the port's kernels on the card: at world 1
(a process group of one rank, a 1 x 1 ("data", "model") mesh), each
wrapper given DTensors computes what the direct kernel call computes on
the whole tensors, bit for bit (one rank's shard is the whole tensor), and
launches the kernel (no plain version). Marked ``gpu``: whether a card is
present is decided in a fixture; without a card they skip.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_spmd_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.sharding import from_full, full_tensor  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh("cuda")


def _t(rng, shape, dtype=torch.float32):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                           device="cuda").to(dtype)


def _d(x, mesh):
    from torch.distributed.tensor import Replicate
    return from_full(x, mesh, [Replicate()] * mesh.ndim)


def _same(got, want, kernel):
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    for g, w in zip(outs, wants):
        assert torch.equal(full_tensor(g), w), kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_on_mesh_is_the_kernel(mesh, dtype):
    rng = np.random.default_rng(0)
    q = _t(rng, (2, 300, 14, 64), dtype)
    k, v = (_t(rng, (2, 300, 2, 64), dtype) for _ in range(2))
    want = kops.flash_attention(q, k, v, causal=True)
    reset_launch_counts()
    got = kops.flash_attention(_d(q, mesh), _d(k, mesh), _d(v, mesh),
                               causal=True)
    assert launch_counts()["flash_attention"] == 1
    _same(got, want, "flash_attention")


def test_flash_attention_backward_on_mesh_is_the_kernels(mesh):
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng, (1, 257, h, 64), torch.bfloat16).requires_grad_(True)
               for h in (12, 4, 4))
    out = kops.flash_attention(q, k, v, causal=True)
    do = _t(rng, out.shape, torch.bfloat16)
    want = torch.autograd.grad(out, (q, k, v), do)
    dq, dk, dv = (_d(t.detach(), mesh).requires_grad_(True)
                  for t in (q, k, v))
    reset_launch_counts()
    got = kops.flash_attention(dq, dk, dv, causal=True)
    grads = torch.autograd.grad(got, (dq, dk, dv), _d(do, mesh))
    assert launch_counts()["flash_attention_bwd"] == 1
    for g, w in zip(grads, want):
        assert torch.equal(full_tensor(g), w)


def test_decode_attention_on_mesh_is_the_kernel(mesh):
    rng = np.random.default_rng(2)
    q = _t(rng, (2, 1, 24, 64), torch.bfloat16)
    k, v = (_t(rng, (2, 1100, 8, 64), torch.bfloat16) for _ in range(2))
    n = torch.full((1,), 1000, dtype=torch.int32, device="cuda")
    want = kops.decode_attention(q, k, v, kv_len=n)
    reset_launch_counts()
    got = kops.decode_attention(_d(q, mesh), _d(k, mesh), _d(v, mesh),
                                kv_len=n)
    assert launch_counts()["decode_attention"] == 1
    _same(got, want, "decode_attention")


def test_ssd_scan_on_mesh_is_the_kernel(mesh):
    rng = np.random.default_rng(3)
    b, h, s, p, n = 2, 8, 300, 64, 128
    x = _t(rng, (b * h, s, p))
    bm, cm = (_t(rng, (b, s, n)) for _ in range(2))
    dt = torch.nn.functional.softplus(_t(rng, (b * h, s))) * 0.1
    da = -dt * 0.5
    want = kops.ssd_scan(x, bm, cm, dt, da, chunk=256, heads_per_bc=h)
    reset_launch_counts()
    got = kops.ssd_scan(*(_d(t, mesh) for t in (x, bm, cm, dt, da)),
                        chunk=256, heads_per_bc=h)
    assert launch_counts()["ssd_scan"] == 1
    _same(got, want, "ssd_scan")


def test_rglru_scan_on_mesh_is_the_kernel(mesh):
    rng = np.random.default_rng(4)
    a = torch.sigmoid(_t(rng, (2, 300, 512)))
    u = _t(rng, (2, 300, 512))
    want = kops.rglru_scan(a, u)
    reset_launch_counts()
    got = kops.rglru_scan(_d(a, mesh), _d(u, mesh))
    assert launch_counts()["rglru_scan"] == 1
    _same(got, want, "rglru_scan")
