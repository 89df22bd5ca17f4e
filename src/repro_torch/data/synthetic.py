"""Synthetic LM data: the port's own copy of the JAX package's
``repro/data/synthetic.py`` ``SyntheticLM`` (numpy only), so that both
packages draw the same batches, bit for bit, from the same seed.

A deterministic, learnable token stream: a Zipf-distributed unigram base
with an order-2 Markov overlay, so the loss has real structure to learn.
Host-sharded: each data-parallel host slices its batch rows.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0,
                 zipf_a: float = 1.2, markov_weight: float = 0.7):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        v = vocab_size
        base = 1.0 / np.arange(1, v + 1) ** zipf_a
        self.base = base / base.sum()
        # sparse order-1 transition structure: each token prefers 4 successors
        g = np.random.default_rng(seed + 1)
        self.succ = g.integers(0, v, size=(v, 4))
        self.markov_weight = markov_weight

    def sample_batch(self, batch: int) -> np.ndarray:
        v = self.vocab_size
        out = np.empty((batch, self.seq_len), np.int32)
        prev = self.rng.choice(v, size=batch, p=self.base)
        out[:, 0] = prev
        for t in range(1, self.seq_len):
            use_markov = self.rng.random(batch) < self.markov_weight
            succ_pick = self.succ[prev, self.rng.integers(0, 4, size=batch)]
            base_pick = self.rng.choice(v, size=batch, p=self.base)
            prev = np.where(use_markov, succ_pick, base_pick).astype(np.int32)
            out[:, t] = prev
        return out

    def reseed_sampler(self, seed: int) -> "SyntheticLM":
        """Fresh sampling stream over the SAME token distribution (same Zipf
        base + Markov map) — for held-out evaluation."""
        self.rng = np.random.default_rng(seed)
        return self

    def batches(self, batch: int, *, host_id: int = 0,
                num_hosts: int = 1) -> Iterator[dict]:
        """Infinite stream of host-local shards of a global batch."""
        assert batch % num_hosts == 0
        local = batch // num_hosts
        while True:
            full = self.sample_batch(batch)
            yield {"tokens": full[host_id * local:(host_id + 1) * local]}
