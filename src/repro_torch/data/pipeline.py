"""Deterministic synthetic token stream (numpy only).

A copy of ``repro.data.pipeline.TokenStream``: an LM token stream with
Zipfian unigram statistics and Markov bigram structure; ``batch(step)`` is
a pure function of ``(seed, step)``, so both packages draw the same prompts.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TokenStream:
    """Markov-chain token stream: batch(step) is deterministic in (seed, step)."""

    vocab_size: int
    batch_size: int  # per-host batch
    seq_len: int
    seed: int = 0
    num_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # Zipfian emission per hidden state; Markov transitions between states.
        self._trans = rng.dirichlet(np.full(self.num_states, 0.2),
                                    size=self.num_states).astype(np.float32)
        ranks = np.arange(1, self.vocab_size + 1)
        zipf = 1.0 / ranks**1.1
        emissions = []
        for s in range(self.num_states):
            w = zipf * rng.lognormal(0, 1.0, size=self.vocab_size)
            emissions.append(w / w.sum())
        self._emit = np.stack(emissions)  # (states, vocab)
        self._emit_cum = np.cumsum(self._emit, axis=1)
        self._trans_cum = np.cumsum(self._trans, axis=1)

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.batch_size, self.seq_len
        state = rng.integers(0, self.num_states, size=b)
        toks = np.empty((b, s + 1), dtype=np.int32)
        u_tok = rng.random((b, s + 1), dtype=np.float32)
        u_state = rng.random((b, s + 1), dtype=np.float32)
        for t in range(s + 1):
            toks[:, t] = (
                self._emit_cum[state] < u_tok[:, t, None]).sum(axis=1)
            state = (self._trans_cum[state] < u_state[:, t, None]).sum(axis=1)
        toks = np.clip(toks, 0, self.vocab_size - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
