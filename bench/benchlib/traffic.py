"""Traffic from a mix file and ``--seed``.

A sweep's backlog: ``members`` members on a log grid of learning-rate
scales, ``steps_per_member`` step-tasks each, every task on a data shard
of its own, inserted into the store in an order drawn from the seed. Every
seed gives the same set of tasks and sizes, in another order, on other
shards.

A task's batch: a copy of the port's synthetic token stream
(``data/pipeline.py::shard_batch``: Zipf unigrams with bigram structure),
so that the reference is handed the batch the program reads without
calling the program.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

SHARD_SPACE = 1 << 20


def data_seed(seed: int) -> int:
    """The data pipeline's seed for a run: the run's seed, in 32 bits."""
    return seed & 0xFFFFFFFF


def sweep_backlog(mix: dict, seed: int) -> np.ndarray:
    """[members * steps_per_member, 3] domain inputs in insertion order:
    lr scale, data shard, member id."""
    rng = np.random.default_rng(seed)
    members, steps = mix["members"], mix["steps_per_member"]
    lo, hi = mix["lr_scale_range"]
    scales = np.geomspace(lo, hi, members)
    n = members * steps
    if n > SHARD_SPACE:
        raise ValueError(f"{n} tasks do not fit {SHARD_SPACE} shards")
    member = np.repeat(np.arange(members), steps)
    shard = (rng.integers(0, SHARD_SPACE) + np.arange(n)) % SHARD_SPACE
    order = rng.permutation(n)
    return np.stack([scales[member[order]], shard[order].astype(np.float64),
                     member[order].astype(np.float64)], axis=1)


def shard_batch(vocab: int, seq: int, rows: int, seed: int, shard: int,
                zipf_a: float = 1.3) -> Dict[str, np.ndarray]:
    """The batch of data shard ``shard``: tokens and next-token labels."""
    rng = np.random.default_rng((seed << 32) ^ shard)
    base = rng.zipf(zipf_a, size=(rows, seq + 1)) % vocab
    follow = (base * 31 + 7) % vocab
    mask = rng.random((rows, seq + 1)) < 0.5
    stream = np.where(mask, np.roll(follow, 1, axis=1), base).astype(np.int32)
    return {"tokens": stream[:, :seq], "labels": stream[:, 1:]}
