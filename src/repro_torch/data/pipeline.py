"""Deterministic synthetic data pipeline.

Each task row in the work queue references a data shard id; the pipeline
deterministically regenerates that shard from (seed, shard_id) — which makes
task retry after worker failure bit-identical (the fault-tolerance story
depends on this) and avoids any filesystem dependency in tests.

The token stream is a structured synthetic language (Zipf unigrams + local
bigram structure) so models actually reduce loss during the example runs —
a flat-random stream has no learnable signal.

A copy of the reference's ``repro/data/pipeline.py`` (numpy only, so the
batches are bit-identical to the reference's); the executor moves them to
its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.3


def shard_batch(cfg: DataConfig, shard_id: int) -> Dict[str, np.ndarray]:
    """Deterministic batch for a shard id: tokens + next-token labels."""
    rng = np.random.default_rng((cfg.seed << 32) ^ shard_id)
    b, s, v = cfg.batch_size, cfg.seq_len, cfg.vocab_size
    base = rng.zipf(cfg.zipf_a, size=(b, s + 1)) % v
    # bigram structure: with p=0.5, token t+1 = f(token t)
    follow = (base * 31 + 7) % v
    mask = rng.random((b, s + 1)) < 0.5
    stream = np.where(mask, np.roll(follow, 1, axis=1), base).astype(np.int32)
    return {"tokens": stream[:, :s], "labels": stream[:, 1:]}


def embed_stub_batch(cfg: DataConfig, model_cfg: ModelConfig,
                     shard_id: int) -> Dict[str, np.ndarray]:
    """Precomputed frame/patch embeddings for the [audio]/[vlm] stub archs."""
    rng = np.random.default_rng((cfg.seed << 32) ^ shard_id ^ 0xA5A5)
    b, s = cfg.batch_size, cfg.seq_len
    d = model_cfg.d_model
    tok = shard_batch(cfg, shard_id)
    out: Dict[str, np.ndarray] = {
        "embeds": rng.standard_normal((b, s, d)).astype(np.float32) * 0.1,
        "labels": tok["labels"],
    }
    if model_cfg.mrope:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                              (3, b, s)).copy()
        out["mrope_positions"] = pos
    return out


def batch_for(model_cfg: ModelConfig, data_cfg: DataConfig,
              shard_id: int) -> Dict[str, np.ndarray]:
    if model_cfg.family == "encdec":
        rng = np.random.default_rng((data_cfg.seed << 32) ^ shard_id ^ 0xE5)
        b, s = data_cfg.batch_size, data_cfg.seq_len
        tok = shard_batch(dataclasses.replace(data_cfg,
                                              seq_len=max(8, s // 8)),
                          shard_id)
        return {"frames": rng.standard_normal(
                    (b, s, model_cfg.d_model)).astype(np.float32) * 0.1,
                "tokens": tok["tokens"], "labels": tok["labels"]}
    if model_cfg.embed_stub:
        return embed_stub_batch(data_cfg, model_cfg, shard_id)
    return shard_batch(data_cfg, shard_id)


class Prefetcher:
    """Double-buffered host-side prefetch (overlaps data gen with compute)."""

    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig):
        import threading
        self.model_cfg, self.data_cfg = model_cfg, data_cfg
        self._next: Optional[Dict[str, np.ndarray]] = None
        self._tid: Optional[int] = None
        self._thread: Optional[threading.Thread] = None

    def prefetch(self, shard_id: int) -> None:
        import threading

        def work():
            self._next = batch_for(self.model_cfg, self.data_cfg, shard_id)
            self._tid = shard_id
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def get(self, shard_id: int) -> Dict[str, np.ndarray]:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._tid == shard_id and self._next is not None:
            out, self._next, self._tid = self._next, None, None
            return out
        return batch_for(self.model_cfg, self.data_cfg, shard_id)
