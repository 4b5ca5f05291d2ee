"""Greedy sampling for the serving stack, and the per-request
:class:`SamplingParams` (the greedy part of ``repro.serving.sampling``).

Greedy (temperature 0) is the argmax of the float32 logits, first index on
ties as ``jnp.argmax``.  Temperature / top-k / top-p sampling needs the
counter-derived per-request streams of the JAX package (ROADMAP A8); until
then a request with a temperature above 0 raises.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side only).

    ``temperature == 0`` is greedy argmax (``top_k``/``top_p``/``seed`` are
    then irrelevant); ``top_k == 0`` and ``top_p == 1`` disable their
    filters.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not 0 <= self.seed < 2**32:
            raise ValueError(f"seed must fit in uint32, got {self.seed}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0


def batch_rows(rows_reqs: List[Tuple[int, object]], batch: int):
    """Per-row sampling arrays ``(seed, t, temperature, top_k, top_p)`` for
    a batch from ``(row, request)`` pairs; inactive rows are greedy.  ``t``
    is the emission index of the next token, ``len(req.generated)``."""
    seed = np.zeros((batch,), np.uint32)
    t = np.zeros((batch,), np.int32)
    temp = np.zeros((batch,), np.float32)
    top_k = np.zeros((batch,), np.int32)
    top_p = np.ones((batch,), np.float32)
    for row, req in rows_reqs:
        sp = req.sampling
        seed[row] = sp.seed
        t[row] = len(req.generated)
        temp[row] = sp.temperature
        top_k[row] = sp.top_k
        top_p[row] = sp.top_p
    return seed, t, temp, top_k, top_p


def sample_tokens(logits: torch.Tensor, temperature: np.ndarray) -> np.ndarray:
    """``logits (B, V)`` → ``(B,)`` int32 tokens on the host.  Greedy rows
    only: a row with a temperature above 0 raises (not ported yet)."""
    if np.any(temperature > 0):
        raise NotImplementedError(
            "temperature > 0 sampling is not ported yet (ROADMAP A8)")
    return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
