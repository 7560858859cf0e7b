"""Deterministic synthetic token pipeline: the port's copy of
``src/repro/training/data.py`` (numpy only), kept equal to it outside this
docstring and the imports (``tests/test_torch_training.py`` checks both the
source and the batches).

Produces an infinite stream of (tokens, labels) batches with a
Zipf-distributed vocabulary and injected n-gram structure (so small models
have something learnable and loss visibly decreases in the examples).
Sharded host feed: each data-parallel host slice draws a disjoint
deterministic key stream — resumable from (seed, step) alone, which is what
checkpoint/restart needs (no pipeline state to snapshot).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    n_codebooks: int = 0
    structure: bool = True     # inject learnable bigram structure


class SyntheticDataset:
    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        # fixed learnable bigram successor table
        rng = np.random.default_rng(cfg.seed ^ 0xBEEF)
        self._succ = rng.integers(0, cfg.vocab_size,
                                  size=cfg.vocab_size).astype(np.int32)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 31 + self.host_id)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        shape = (self.local_batch, cfg.seq_len + 1)
        if cfg.n_codebooks:
            shape = shape + (cfg.n_codebooks,)
        x = rng.zipf(cfg.zipf_a, size=shape).astype(np.int64)
        x = np.clip(x - 1, 0, cfg.vocab_size - 1).astype(np.int32)
        if cfg.structure and not cfg.n_codebooks:
            # half of the positions follow the deterministic bigram table
            follow = rng.random((self.local_batch, cfg.seq_len)) < 0.5
            for t in range(1, cfg.seq_len + 1):
                x[:, t] = np.where(follow[:, t - 1],
                                   self._succ[x[:, t - 1]], x[:, t])
        return {"tokens": x[:, :-1].copy(), "labels": x[:, 1:].copy()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
