"""Deterministic, resumable data pipelines: the port's own copy of the
JAX package's ``data/pipeline.py`` (pure numpy, so the batches are the
reference's bit for bit).

Fault-tolerance contract: a batch is a pure function of (seed, step), so
restart-from-checkpoint needs no pipeline state beyond the step counter —
the standard trick large training jobs use to make the input pipeline
trivially elastic (any host can compute any shard of any step).  Batches
are numpy arrays; the trainer moves them to its device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLMData:
    """Markov-chain token stream: learnable structure (loss goes well below
    the uniform-entropy floor) while remaining fully synthetic."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, order_bias: float = 0.8):
        self.vocab, self.batch, self.seq = vocab_size, batch, seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        # sparse "grammar": each token strongly prefers a few successors
        self.succ = rng.integers(0, vocab_size, size=(vocab_size, 4))
        self.order_bias = order_bias

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        follow = rng.random((self.batch, self.seq)) < self.order_bias
        choice = rng.integers(0, 4, (self.batch, self.seq))
        rand = rng.integers(0, self.vocab, (self.batch, self.seq))
        for t in range(self.seq):
            nxt = self.succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileLMData:
    """Flat binary token file (uint16/uint32), sharded by step index."""

    def __init__(self, path: str, vocab_size: int, batch: int, seq_len: int,
                 dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab, self.batch, self.seq = vocab_size, batch, seq_len
        self.tokens_per_batch = batch * (seq_len + 1)
        self.num_batches = len(self.data) // self.tokens_per_batch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        i = (step % self.num_batches) * self.tokens_per_batch
        chunk = np.asarray(self.data[i:i + self.tokens_per_batch],
                           dtype=np.int32)
        chunk = chunk.reshape(self.batch, self.seq + 1) % self.vocab
        return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:].copy()}
