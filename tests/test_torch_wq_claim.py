"""The port's claim op (plain PyTorch version, CPU) against the reference's
oracle and its Pallas kernel in interpret mode, on the same numpy inputs.
Integer results: equal, not close."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.wq_claim.ops import wq_claim as jax_wq_claim  # noqa: E402
from repro.kernels.wq_claim.ops import wq_claim_columns as jax_columns  # noqa: E402
from repro.kernels.wq_claim.ref import wq_claim_ref as jax_wq_claim_ref  # noqa: E402
from repro_torch.kernels.wq_claim.kernel import wq_claim_fwd  # noqa: E402
from repro_torch.kernels.wq_claim.ops import wq_claim, wq_claim_columns  # noqa: E402


def _both(status, worker, w, k):
    got = wq_claim(torch.as_tensor(status), torch.as_tensor(worker),
                   num_workers=w, k=k)
    ref = jax_wq_claim_ref(jnp.asarray(status), jnp.asarray(worker),
                           num_workers=w, k=k)
    pal = jax_wq_claim(jnp.asarray(status), jnp.asarray(worker),
                       num_workers=w, k=k, interpret=True)
    return [t.numpy() for t in got], ref, pal


@settings(max_examples=10, deadline=None)
@given(n=st.sampled_from([512, 1000, 2048, 5000]), w=st.integers(1, 16),
       k=st.integers(1, 4), seed=st.integers(0, 5))
def test_property_plain_claim_equals_reference(n, w, k, seed):
    rng = np.random.default_rng(seed)
    status = rng.choice([0, 2, 3, 4], n, p=[.1, .5, .2, .2]).astype(np.int32)
    worker = rng.integers(0, w, n).astype(np.int32)
    (gs, gc), ref, pal = _both(status, worker, w, k)
    for want in (ref, pal):
        assert np.array_equal(gs, np.asarray(want[0]))
        assert np.array_equal(gc, np.asarray(want[1]))
    claimed = gc == 1
    assert np.bincount(worker[claimed], minlength=w).max(initial=0) <= k


@pytest.mark.parametrize("n,w,k", [(700, 5, 1), (3000, 9, 3)])
def test_out_of_range_workers_claimed_at_rank_zero(n, w, k):
    """Worker ids outside [0, W) get rank 0: claimed whenever READY, past
    any budget, exactly as the reference oracle and kernel do."""
    rng = np.random.default_rng(n)
    status = rng.choice([0, 2, 3], n, p=[.2, .6, .2]).astype(np.int32)
    worker = rng.integers(-3, w + 4, n).astype(np.int32)
    (gs, gc), ref, pal = _both(status, worker, w, k)
    for want in (ref, pal):
        assert np.array_equal(gs, np.asarray(want[0]))
        assert np.array_equal(gc, np.asarray(want[1]))
    orphan = ((worker < 0) | (worker >= w)) & (status == 2)
    assert orphan.any() and (gc[orphan] == 1).all()


def test_columns_bridge_matches_reference_bridge():
    rng = np.random.default_rng(7)
    status = rng.choice([1, 2, 3, 4], 1500).astype(np.int32)
    worker = rng.integers(0, 6, 1500).astype(np.int32)
    got = wq_claim_columns(status, worker, num_workers=6, k=2, device="cpu")
    want = jax_columns(status, worker, num_workers=6, k=2, interpret=True)
    assert got[0].dtype == bool and got[1].dtype == np.int32
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    empty = wq_claim_columns(status[:0], worker[:0], num_workers=6,
                             device="cpu")
    assert empty[0].shape == (0,) and empty[1].shape == (0,)


def test_kernel_launcher_refuses_cpu_tensors():
    """The CUDA launcher never computes on the CPU: it raises, and its
    launch count does not move."""
    before = wq_claim_fwd.launches
    s = torch.full((8,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        wq_claim_fwd(s, torch.zeros(8, dtype=torch.int32), num_workers=1, k=1)
    assert wq_claim_fwd.launches == before
