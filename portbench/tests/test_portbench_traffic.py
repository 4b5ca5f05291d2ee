"""The traffic generator: deterministic per seed, lengths in the stated
ranges, the same sizes for every seed in another order."""
import json
from pathlib import Path

import pytest

from portbench.harness import traffic as TR

ROOT = Path(__file__).resolve().parents[2]
MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "portbench" / "traffic").glob("*.json")}
SERVING = sorted(k for k, m in MIXES.items() if "arrival" in m)
VOCAB = 151936


def _gen(name, seed, horizon=115.0):
    return TR.generate(MIXES[name], seed, VOCAB, horizon)


@pytest.mark.parametrize("name", SERVING)
def test_deterministic_per_seed(name):
    a, b, c = _gen(name, 2**31 + 5), _gen(name, 2**31 + 5), _gen(name, 12)
    assert a == b
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("name", SERVING)
def test_lengths_in_stated_ranges(name):
    mix = MIXES[name]
    for r in _gen(name, 7):
        assert mix["prompt_len"]["min"] <= len(r.prompt) <= mix["prompt_len"]["max"]
        assert r.max_new <= mix["output_len"]["max"]
        assert len(r.prompt) + r.max_new <= mix["max_total"]
        assert len(r.prompt) + r.max_new <= mix["engine"]["max_len"]
        assert all(0 <= t < VOCAB for t in r.prompt)


def test_stated_ranges_are_the_issue_s():
    bd, co = MIXES["batch-decode"], MIXES["chat-open"]
    assert (bd["prompt_len"]["min"], bd["prompt_len"]["median"],
            bd["prompt_len"]["max"]) == (64, 128, 256)
    assert (bd["output_len"]["min"], bd["output_len"]["median"],
            bd["output_len"]["max"]) == (256, 448, 768)
    assert (co["prompt_len"]["min"], co["prompt_len"]["median"],
            co["prompt_len"]["max"]) == (64, 256, 1024)
    assert (co["output_len"]["min"], co["output_len"]["median"],
            co["output_len"]["max"]) == (16, 96, 384)
    assert bd["engine"] == {"max_batch": 32, "max_len": 1024, "page_size": 16,
                            "prefill_chunk": 128, "prefix_cache": True}
    assert co["engine"] == {"max_batch": 32, "max_len": 1536, "page_size": 16,
                            "prefill_chunk": 256, "prefix_cache": True}


@pytest.mark.parametrize("name", SERVING)
def test_every_seed_serves_the_same_schedule(name):
    a, b = _gen(name, 1), _gen(name, 2**31 + 3)
    assert [(len(r.prompt), r.max_new, r.due, r.sampling is None) for r in a] == \
        [(len(r.prompt), r.max_new, r.due, r.sampling is None) for r in b]
    other = dict(MIXES[name], schedule_seed=MIXES[name]["schedule_seed"] + 1)
    c = TR.generate(other, 1, VOCAB, 115.0)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in c)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]


def test_backlog_and_open_loop():
    bd = _gen("batch-decode", 3)
    assert len(bd) == MIXES["batch-decode"]["requests"]
    assert all(r.due == 0 and r.sampling is None for r in bd)
    co = _gen("chat-open", 3, horizon=100.0)
    rate = MIXES["chat-open"]["rate_per_s"]
    assert len(co) == int(-(-rate * 100.0 // 1))
    assert all(x.due < y.due for x, y in zip(co, co[1:]))
    greedy = sum(r.sampling is None for r in co)
    assert greedy == -(-len(co) // MIXES["chat-open"]["greedy_every"])
    seeds = {r.sampling["seed"] for r in co if r.sampling}
    assert len(seeds) == len(co) - greedy


def test_grid_quantiles():
    spec = {"median": 100, "sigma": 0.5, "min": 1, "max": 10**6}
    lens = TR.grid_lengths(spec, 101)
    assert lens[50] == 100 and list(lens) == sorted(lens)
    gaps = TR.grid_gaps(2.0, 10_000)
    assert abs(gaps.mean() - 0.5) < 0.01
