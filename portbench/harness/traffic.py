"""The one traffic generator: a mix file (``traffic/<mix>.json``) of
parameters → the requests of one run, from ``--seed``.

Lengths and arrival gaps are quantiles of the mix's stated distributions
on an even grid, shuffled into one order by the mix's ``schedule_seed``:
every run serves the same requests at the same times, and the run's seed
draws their prompt tokens and sampling seeds (and the weights).  A tail
latency at four fifths of the knee moves by a factor of two with the
order of long prompts among the arrivals, far more than between two runs
of one order, so the order is part of the mix and not of the seed.

A length spec is ``{"median": m, "sigma": s, "min": lo, "max": hi}``: a
lognormal of that median and log-sd, rounded and clipped to ``[lo, hi]``.
Keys of a serving mix:

- ``schedule_seed``: the order of the lengths and gaps (and which
  requests are greedy);
- ``arrival``: ``"backlog"`` (every request submitted at the start) or
  ``"poisson"`` (open loop at ``rate_per_s``, exponential gaps);
- ``requests`` (backlog) or, open loop, as many as arrive over the run's
  horizon;
- ``prompt_len``, ``output_len``, and ``max_total`` (prompt + output);
- ``sampling``: ``null`` (greedy) or ``{"temperature", "top_k",
  "top_p"}``, with one request in ``greedy_every`` greedy instead;
- ``engine``: the engine's knobs (``max_batch``, ``max_len``,
  ``page_size``, ``prefill_chunk``, ``prefix_cache``).
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Req:
    """One generated request: its prompt, output budget, sampling (``None``
    greedy) and due time in seconds from the start of arrivals."""
    prompt: List[int]
    max_new: int
    sampling: Optional[Dict]
    due: float


def load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of one seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF,
                                  int.from_bytes(stream.encode()[:8], "little")])


def grid_lengths(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles ``(i + ½)/n`` of the spec's lognormal,
    rounded and clipped."""
    nd = NormalDist()
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    vals = [round(math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n)))
            for i in range(n)]
    return np.clip(np.asarray(vals, dtype=np.int64), spec["min"], spec["max"])


def grid_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` exponential inter-arrival gaps of mean ``1/rate`` at the
    quantiles ``(i + ½)/n``."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def request_count(mix: Dict, horizon_s: float) -> int:
    if mix["arrival"] == "backlog":
        return int(mix["requests"])
    return int(math.ceil(mix["rate_per_s"] * horizon_s))


def generate(mix: Dict, seed: int, vocab: int, horizon_s: float) -> List[Req]:
    """The requests of one run, in arrival order."""
    n = request_count(mix, horizon_s)
    g = rng(mix.get("schedule_seed", seed), "order")
    plen = g.permutation(grid_lengths(mix["prompt_len"], n))
    olen = g.permutation(grid_lengths(mix["output_len"], n))
    olen = np.minimum(olen, mix["max_total"] - plen)
    if mix["arrival"] == "backlog":
        due = np.zeros(n)
    else:
        due = np.cumsum(g.permutation(grid_gaps(mix["rate_per_s"], n)))
    sampled = np.zeros(n, dtype=bool)
    if mix.get("sampling"):
        every = int(mix.get("greedy_every", 0))
        greedy = (np.arange(n) % every == 0) if every else np.zeros(n, bool)
        sampled = ~g.permutation(greedy)
    toks = rng(seed, "tokens")
    seeds = rng(seed, "sampling").integers(0, 2**32, size=n)
    out = []
    for i in range(n):
        sp = (dict(mix["sampling"], seed=int(seeds[i])) if sampled[i]
              else None)
        out.append(Req(prompt=toks.integers(0, vocab, size=int(plen[i])).tolist(),
                       max_new=int(olen[i]), sampling=sp, due=float(due[i])))
    return out
