"""Deterministic synthetic data (numpy only), copies of
``repro.data.pipeline``'s sources, bit-equal to them for the same seed:

  * :class:`TokenStream` — an LM token stream with Zipfian unigram
    statistics and Markov bigram structure; ``batch(step)`` is a pure
    function of ``(seed, step)``, so both packages draw the same prompts;
  * :func:`synthetic_mnist` — 28×28 10-class "digit blobs" for the paper's
    SFC MLP case study;
  * :func:`synthetic_cifar` — 32×32×3 10-class structured images for the
    paper's ResNet-9 case study.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Tuple

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


class BatchSpec(NamedTuple):
    """Shape and dtype of one batch entry (the port's stand-in for a
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: np.dtype


def token_batch_specs(batch: int, seq: int) -> dict:
    """Shapes and dtypes of one LM training batch."""
    return {"tokens": BatchSpec((batch, seq), np.dtype(np.int32)),
            "labels": BatchSpec((batch, seq), np.dtype(np.int32))}


def synthetic_mnist(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 784) float32 in [0,1] + (n,) int labels; 10 separable classes."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    protos = rng.random((10, 784), dtype=np.float32)
    # low intrinsic dimension: each class = prototype + low-rank jitter
    basis = rng.normal(size=(10, 16, 784)).astype(np.float32) * 0.05
    coeff = rng.normal(size=(n, 16)).astype(np.float32)
    x = protos[labels] + np.einsum("nk,nkd->nd", coeff, basis[labels])
    return np.clip(x, 0, 1).astype(np.float32), labels.astype(np.int32)


def synthetic_cifar(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 32, 32, 3) float32 + (n,) int labels; 10 texture/shape classes."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    imgs = np.empty((n, 32, 32, 3), dtype=np.float32)
    freqs = rng.uniform(1, 6, size=(10, 3, 2)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, size=(10, 3)).astype(np.float32)
    for i in range(n):
        c = labels[i]
        for ch in range(3):
            f = freqs[c, ch]
            base = np.sin(2 * np.pi * (f[0] * xx + f[1] * yy) + phases[c, ch])
            imgs[i, :, :, ch] = 0.5 + 0.4 * base
    imgs += rng.normal(0, 0.05, size=imgs.shape).astype(np.float32)
    return np.clip(imgs, 0, 1), labels.astype(np.int32)
