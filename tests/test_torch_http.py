"""The port's HTTP front end and the launcher's observability flags.

``repro_torch.serving.http.AsyncServer`` over a real socket on an
ephemeral port, driving the port's engine (the tests of
``tests/test_http.py`` on the port): NDJSON token streams equal the
offline engine's (shared prefixes included), a client disconnect cancels
its request, per-tenant token buckets answer 429 with a positive integer
``Retry-After``, ``/slo``, ``/debug/quality``, ``/metrics`` and
``/healthz`` answer, ``X-Request-Id`` round-trips, and bad requests get
4xx.  The launcher run with ``--metrics``, ``--trace-out``,
``--slo-report`` and ``--profile-every`` writes files the port's validator
CLI accepts, with the streams of the same run without the flags.
"""
import asyncio
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.models.model import init_params
from repro_torch.serving import (AsyncServer, QualityProbe, Recorder,
                                 ServeEngine, validate_prometheus)
from repro_torch.serving.http import _TokenBucket

ROOT = Path(__file__).resolve().parents[1]
STEM = [5, 1, 4, 1, 5, 9, 2, 6, 5, 3]


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


def _engine(setup, **kw):
    cfg, params = setup
    opts = dict(max_batch=2, max_len=64, compute_dtype=torch.float32,
                device="cpu")
    return ServeEngine(params, cfg, **{**opts, **kw})


# -- tiny HTTP/1.1 client helpers -------------------------------------------


async def _request(port, method, path, body=None, headers=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    head = f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
    for k, v in (headers or {}).items():
        head += f"{k}: {v}\r\n"
    if payload:
        head += f"Content-Length: {len(payload)}\r\n"
    writer.write(head.encode() + b"\r\n" + payload)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    hdrs = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        hdrs[k.strip().lower()] = v.strip()
    return reader, writer, status, hdrs


async def _read_chunk(reader):
    """One chunked-transfer chunk, or None on the terminating chunk."""
    n = int((await reader.readline()).strip() or b"0", 16)
    if n == 0:
        return None
    data = await reader.readexactly(n)
    await reader.readline()  # trailing CRLF
    return data


async def _read_body(reader, hdrs):
    if hdrs.get("transfer-encoding") == "chunked":
        out = b""
        while True:
            c = await _read_chunk(reader)
            if c is None:
                return out
            out += c
    return await reader.readexactly(int(hdrs.get("content-length", 0)))


async def _stream_tokens(port, prompt, max_new, tenant=None):
    reader, writer, status, hdrs = await _request(
        port, "POST", "/v1/generate",
        body={"prompt": prompt, "max_new_tokens": max_new},
        headers={"X-Tenant": tenant} if tenant else None)
    assert status == 200, status
    recs = [json.loads(ln)
            for ln in (await _read_body(reader, hdrs)).decode().splitlines()]
    writer.close()
    final = recs[-1]
    assert final.get("done") is True
    tokens = [r["token"] for r in recs[:-1]]
    assert tokens == final["tokens"]
    return final["tokens"]


def _serve(server, body):
    async def main():
        await server.start()
        try:
            return await body(server.port)
        finally:
            await server.stop()

    return asyncio.run(main())


# -- tests -------------------------------------------------------------------


def test_http_streams_equal_offline_shared_prefix(setup):
    prompts = [STEM + [7, 7, 7], STEM + [7, 7, 7], STEM + [8, 8]]
    cold = _engine(setup, page_size=4, prefill_chunk=4, prefix_cache=False)
    want = [cold.submit(p, max_new_tokens=6) for p in prompts]
    cold.run_until_drained()
    want = [h.tokens() for h in want]

    rec = Recorder(trace=False)
    eng = _engine(setup, page_size=4, prefill_chunk=4, recorder=rec)

    async def body(port):
        first = await _stream_tokens(port, prompts[0], 6)
        rest = await asyncio.gather(_stream_tokens(port, prompts[1], 6),
                                    _stream_tokens(port, prompts[2], 6))
        return [first] + list(rest)

    assert _serve(AsyncServer(eng, port=0), body) == want
    v = rec.registry.value
    assert v("serve_prefix_lookups_total", result="hit") > 0
    assert v("serve_prefix_reused_tokens_total") > 0
    assert v("serve_generated_tokens_total") == 18
    eng.sched.check_invariants()


def test_http_disconnect_cancels_request(setup):
    rec = Recorder(trace=False)
    eng = _engine(setup, page_size=4, prefill_chunk=4, recorder=rec)

    async def body(port):
        reader, writer, status, _ = await _request(
            port, "POST", "/v1/generate",
            body={"prompt": STEM, "max_new_tokens": 48})
        assert status == 200
        assert await _read_chunk(reader) is not None  # one token landed
        writer.close()  # walk away mid-stream
        for _ in range(500):
            if not eng.has_work:
                break
            await asyncio.sleep(0.02)

    _serve(AsyncServer(eng, port=0), body)
    assert not eng.has_work
    assert rec.registry.value("serve_requests_cancelled_total") == 1
    eng.sched.check_invariants()


@pytest.mark.parametrize("rate,lo,hi", [(100.0, 1, 1), (0.01, 90, 101)])
def test_token_bucket_retry_after_is_positive_integer(rate, lo, hi):
    bucket = _TokenBucket(rate=rate, burst=1)
    assert bucket.try_take() and not bucket.try_take()
    r = bucket.retry_after()
    assert isinstance(r, int) and lo <= r <= hi


def test_http_per_tenant_rate_limit(setup):
    eng = _engine(setup)

    async def body(port):
        a1 = await _stream_tokens(port, [1, 2, 3], 2, tenant="a")
        assert len(a1) == 2
        _, w, status, hdrs = await _request(
            port, "POST", "/v1/generate",
            body={"prompt": [1, 2, 3], "max_new_tokens": 2},
            headers={"X-Tenant": "a"})
        assert status == 429 and int(hdrs["retry-after"]) >= 900
        w.close()
        b1 = await _stream_tokens(port, [1, 2, 3], 2, tenant="b")
        assert b1 == a1  # a fresh bucket, the same stream

    _serve(AsyncServer(eng, port=0, rate_limit=0.001, rate_burst=1), body)


def test_http_slo_quality_and_request_id(setup):
    cfg, params = setup
    rec = Recorder()
    rec.quality = QualityProbe(rec.registry, rate=1.0, dense_params=params)
    eng = _engine(setup, recorder=rec)

    async def body(port):
        r, w, status, hdrs = await _request(
            port, "POST", "/v1/generate",
            body={"prompt": STEM, "max_new_tokens": 3},
            headers={"X-Request-Id": "corr-42"})
        assert status == 200
        recs = [json.loads(ln) for ln in
                (await _read_body(r, hdrs)).decode().splitlines()]
        assert recs[-1]["done"] is True
        assert recs[-1]["client_request_id"] == "corr-42"
        w.close()
        r, w, status, hdrs = await _request(port, "GET", "/slo")
        assert status == 200
        slo = json.loads(await _read_body(r, hdrs))
        assert slo["ttft_samples"] == 1 and slo["tok_s"] > 0
        assert "error_budget_remaining" in slo
        w.close()
        r, w, status, hdrs = await _request(port, "GET", "/debug/quality")
        assert status == 200
        q = json.loads(await _read_body(r, hdrs))
        assert q["enabled"] is True and q["probe_errors"] == 0
        w.close()

    _serve(AsyncServer(eng, port=0), body)
    inst = [e for e in rec.to_chrome()["traceEvents"] if e["ph"] == "i"]
    assert any(e["name"] == "x-request-id" and e["args"]["id"] == "corr-42"
               for e in inst)

    eng2 = _engine(setup, max_batch=1, recorder=Recorder(trace=False))

    async def no_probe(port):
        _, w, status, _ = await _request(port, "GET", "/debug/quality")
        assert status == 404
        w.close()

    _serve(AsyncServer(eng2, port=0), no_probe)


def test_http_health_metrics_and_errors(setup):
    rec = Recorder(trace=False)
    eng = _engine(setup, recorder=rec)

    async def body(port):
        r, w, status, hdrs = await _request(port, "GET", "/healthz")
        assert status == 200 and (await _read_body(r, hdrs)) == b"ok\n"
        w.close()
        await _stream_tokens(port, [1, 2, 3], 2)
        r, w, status, hdrs = await _request(port, "GET", "/metrics")
        assert status == 200
        text = (await _read_body(r, hdrs)).decode()
        assert "serve_requests_submitted_total 1" in text
        assert validate_prometheus(text) == []
        w.close()
        for method, path, payload, want in (
                ("GET", "/nope", None, 404),
                ("POST", "/v1/generate", {"max_new_tokens": 2}, 400),
                ("POST", "/v1/generate", {"prompt": "x"}, 400)):
            _, w, status, _ = await _request(port, method, path, payload)
            assert status == want, (path, payload)
            w.close()

    _serve(AsyncServer(eng, port=0), body)

    async def no_recorder(port):
        for path in ("/metrics", "/slo"):
            _, w, status, _ = await _request(port, "GET", path)
            assert status == 404
            w.close()

    _serve(AsyncServer(_engine(setup), port=0), no_recorder)


# -- the launcher ------------------------------------------------------------


_LAUNCH = ["--arch", "qwen3-14b", "--reduced", "--amm", "--device", "cpu",
           "--requests", "3", "--max-new", "4"]


def _launch(capsys, extra):
    port_serve.main(_LAUNCH + extra)
    out = capsys.readouterr().out
    return out, re.findall(r"^  req \d+: .*$", out, flags=re.M)


def test_launcher_observability_flags(capsys, tmp_path):
    _, plain = _launch(capsys, [])
    m, t = tmp_path / "serve.prom", tmp_path / "trace.json"
    out, observed = _launch(capsys, [
        "--metrics", str(m), "--trace-out", str(t), "--slo-report",
        "--profile-every", "2"])
    assert observed == plain and len(plain) == 3
    assert "── serving metrics" in out and "── slo health" in out
    assert "kernel_profiled_steps_total" in out
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.obs", "--metrics",
         str(m), "--trace", str(t)], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "metrics OK" in proc.stdout and "trace OK" in proc.stdout
    assert 'lutmu_dispatch_total{backend="ref"' in m.read_text()
    lanes = {e["args"]["name"] for e in json.loads(t.read_text())["traceEvents"]
             if e["ph"] == "M"}
    assert {"engine", "kernels"} <= lanes


@pytest.mark.parametrize("flag,item", [
    pytest.param(["--slots", "2"], None, id="flag0-A10"),
    pytest.param(["--mesh", "2x2"], "torchrun", id="flag1-A11")])
def test_launcher_unported_flags_name_their_item(flag, item, capsys):
    """``--mesh`` (ROADMAP A11, refused until ported) needs a world of D·M
    ranks and names the launcher that starts them.  ``--slots`` (A10,
    refused until ported) now serves: ``--slots 2`` is the deprecated spelling of
    ``--max-batch 2``, the same streams; with ``--engine fixed`` too."""
    if item is None:
        _, slots = _launch(capsys, flag)
        assert len(slots) == 3
        assert _launch(capsys, ["--max-batch", "2"])[1] == slots
        assert _launch(capsys, flag + ["--engine", "fixed"])[1] == slots
        return
    with pytest.raises(SystemExit, match=item):
        port_serve.main(_LAUNCH + flag)
