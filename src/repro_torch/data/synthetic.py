"""Deterministic synthetic token pipeline, a copy of
``repro.data.synthetic``: the same seed gives the same numpy batches.

Zipf-distributed token streams with a planted bigram structure, so that a
model trained on them shows a falling loss. Batches are made on the host as
numpy and moved to the device by ``device_batch``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SyntheticDataset:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    frontend_tokens: int = 0
    d_model: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # planted bigram table: each token has a likely successor
        self._succ = rng.integers(0, self.vocab_size, size=(self.vocab_size,))
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._zipf = p / p.sum()

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.batch_size, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab_size, size=B, p=self._zipf)
        for t in range(S):
            follow = rng.random(B) < 0.8
            rand = rng.choice(self.vocab_size, size=B, p=self._zipf)
            toks[:, t + 1] = np.where(follow, self._succ[toks[:, t]], rand)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend_tokens:
            out["prefix"] = rng.standard_normal(
                (B, self.frontend_tokens, self.d_model)).astype(np.float32)
        return out

    def device_batch(self, step: int, device) -> dict:
        """``batch(step)`` as tensors on ``device``: tokens and labels in
        int64, the index type of PyTorch's gathers."""
        out = {}
        for k, v in self.batch(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.long() if k in ("tokens", "labels") else t).to(device)
        return out
