"""The traffic a sweep mix makes from ``--seed``: the same seed gives the
same backlog and batches, another seed the same set of tasks and sizes in
another order on other data; the batches are the port's data pipeline's."""
from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from benchlib import cells, traffic, weights

MIXES = sorted(p.stem for p in (cells.BENCH / "mixes").glob("*.json"))
SEEDS = (2**31 + 17, 3000000019)


@pytest.mark.parametrize("mix", MIXES)
def test_backlog_is_deterministic_in_the_seed(mix):
    m = cells.load_json(cells.BENCH / "mixes" / f"{mix}.json")
    a, b = (traffic.sweep_backlog(m, s) for s in SEEDS)
    assert np.array_equal(a, traffic.sweep_backlog(m, SEEDS[0]))
    assert a.shape == (m["members"] * m["steps_per_member"], 3)
    assert not np.array_equal(a, b)
    # the same tasks (member, lr scale) in another order, each on a shard
    # of its own
    assert Counter(map(tuple, a[:, [0, 2]])) == Counter(map(tuple,
                                                           b[:, [0, 2]]))
    assert len(np.unique(a[:, 1])) == len(a)
    lo, hi = m["lr_scale_range"]
    assert a[:, 0].min() == pytest.approx(lo) and \
        a[:, 0].max() == pytest.approx(hi)


@pytest.mark.parametrize("seed", SEEDS)
def test_batches_are_the_ports_pipeline(seed):
    from repro_torch.data.pipeline import DataConfig, shard_batch
    cfg = DataConfig(vocab_size=151936, seq_len=64, batch_size=3,
                     seed=traffic.data_seed(seed))
    for shard in (0, 7, (1 << 20) - 1):
        want = shard_batch(cfg, shard)
        got = traffic.shard_batch(151936, 64, 3, traffic.data_seed(seed),
                                  shard)
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_weights_are_deterministic_in_the_seed():
    m = cells.cell("qwen2-0.5b.sweep-2k").model
    m = dict(m, num_layers=1, vocab_size=64)
    spec = cells.cell("qwen2-0.5b.sweep-2k").reference().param_spec(m)
    a, b, c = (dict(weights.leaves(spec, s, "cpu")) for s in (5, 5, 6))
    assert all(bool((a[n] == b[n]).all()) for n in a)
    assert not bool((a["embed.weight"] == c["embed.weight"]).all())
    assert float(a["layers.0.ln1.scale"].min()) == 1.0
