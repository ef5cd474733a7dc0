"""Synthetic token pipeline for LM training — a copy of
`repro.data.tokens` (numpy only): the same batches for the same seed.

Generates structured sequences (a mixture of n-gram-ish Markov chains) so the
loss actually decreases during the example runs — pure-uniform tokens give a
flat loss and hide training bugs.  Deterministic per (seed, step, node).
The batches are host arrays; the training entry points copy each tick's
``tokens [M, b, S + 1]`` to the card once (`device_batch`), as
`repro_torch.sim.tasks` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    batch_per_node: int
    num_nodes: int
    seed: int = 0
    order: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 1024)  # active vocabulary
        self._v = v
        # sparse-ish Markov transition: each token has ~8 likely successors
        succ = rng.integers(0, v, (v, 8))
        self._succ = succ

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        m, b, s = self.num_nodes, self.batch_per_node, self.seq_len
        toks = np.empty((m, b, s + 1), np.int32)
        cur = rng.integers(0, self._v, (m, b))
        toks[..., 0] = cur
        for t in range(1, s + 1):
            choice = rng.integers(0, 8, (m, b))
            nxt = self._succ[cur, choice]
            # 10% random restarts for entropy
            mask = rng.random((m, b)) < 0.1
            nxt = np.where(mask, rng.integers(0, self._v, (m, b)), nxt)
            toks[..., t] = nxt
            cur = nxt
        return {"tokens": toks}


def synthetic_token_batch(vocab: int, shape: tuple, *, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, min(vocab, 1024), shape).astype(np.int32)


def device_batch(batch: dict, device: torch.device) -> dict:
    """A host batch (`TokenPipeline.batch`) as tensors on ``device``: one
    copy a leaf."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
