"""Asyncio streaming front-end over the port's serving engines (stdlib
only), the port's own copy of ``repro.serving.http``.

``AsyncServer`` owns the engine's step loop while serving: one background
driver task steps the engine whenever it has work, and every concurrent
request stream rides the shared per-step signal (``wait_step``) instead
of stepping the engine itself — so N streams cost N row slots, not N
drivers.  The wire protocol is deliberately minimal HTTP/1.1:

``POST /v1/generate``
    JSON body ``{"prompt": [ints], "max_new_tokens": n, "temperature":
    t, "top_k": k, "top_p": p, "seed": s, "tenant": "name"}`` (prompt
    required, the rest optional).  The response streams newline-
    delimited JSON (chunked transfer encoding): one ``{"token": t,
    "index": i}`` object per generated token as it lands, then a final
    ``{"done": true, "request_id": uid, "tokens": [...]}`` record.
    Backpressure is real: each line awaits ``writer.drain()``, so a slow
    client stalls only its own stream.  A client that disconnects
    mid-stream gets its request cancelled on the next token (rows and
    pages free immediately; prefix-index pages survive for reuse).

``GET /metrics``
    Prometheus text-format exposition of the engine recorder's registry
    (404 when the engine runs the NullRecorder).

``GET /slo``
    JSON snapshot of the recorder's SLO health layer (sliding-window
    tok/s, TTFT/TPOT p50/p99, acceptance drift, error budgets and
    threshold violations — ``serving/obs.py::SloTracker``).  404 when
    the engine runs the NullRecorder.

``GET /debug/quality``
    JSON snapshot of the approximation-quality probe
    (``serving/quality.py``): per-layer relative-error summaries,
    codebook dead-bucket counts and dequant saturation fractions.  404
    when no probe is attached (start serve with ``--quality-probe``).

``GET /healthz``
    ``200 ok`` — liveness for the CI smoke job.

Requests may carry an ``X-Request-Id`` header: the id is attached to
the engine request (``Request.client_request_id``), echoed as a trace
instant on the request's tracer lane, and included in the stream's
final NDJSON record — so one id correlates the client log line, the
Perfetto lane and the server stream.

The engine is stepped from the event loop (``engine.step()`` blocks it
for one step: on the card, one program replay and the sampled tokens'
copy to the host).

Per-tenant rate limiting is a token bucket (``--rate-limit`` requests
per second, burst ``--rate-burst``) keyed on the ``X-Tenant`` header
(JSON ``tenant`` field as fallback); an empty bucket answers ``429``
with ``Retry-After``.  Streams are bit-identical to the CLI/offline
path by construction — the server never touches tokens, it only relays
what the engine's (unchanged) step loop produced.
"""
from __future__ import annotations

import asyncio
import json
import math
import time
from typing import Dict, Optional

from repro_torch.serving.obs import log

_MAX_BODY = 1 << 20  # 1 MiB of JSON is far beyond any real prompt here


class _TokenBucket:
    """Classic token bucket: ``rate`` refills/s up to ``burst``."""

    __slots__ = ("rate", "burst", "tokens", "t")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t = time.monotonic()

    def try_take(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after(self) -> int:
        """Whole seconds until the bucket can serve one request.

        ``Retry-After`` is an integer header (RFC 9110 §10.2.3): the true
        deficit ``(1 - tokens) / rate`` is fractional, and naive rounding
        turns any sub-second wait into ``Retry-After: 0`` — which clients
        read as "retry immediately", defeating the limiter.  Ceil the
        deficit and clamp to at least one second instead.
        """
        deficit = max(0.0, 1.0 - self.tokens)
        return max(1, math.ceil(deficit / self.rate))


class AsyncServer:
    """Serve ``engine`` over HTTP with per-request token streaming."""

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 rate_limit: Optional[float] = None,
                 rate_burst: Optional[float] = None):
        self.engine = engine
        self.host = host
        self.port = port  # 0 = ephemeral; replaced by the bound port
        self.rate_limit = rate_limit
        self.rate_burst = rate_burst if rate_burst is not None else (
            max(1.0, rate_limit) if rate_limit else None)
        self._buckets: Dict[str, _TokenBucket] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._driver_task: Optional[asyncio.Task] = None
        self._step_evt = asyncio.Event()   # re-armed after every step
        self._work_evt = asyncio.Event()   # set by submits, wakes the driver
        self._stopping = False
        self.requests_served = 0

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        """Bind the socket and take over the engine's step loop."""
        self.engine._driver = self
        self._driver_task = asyncio.ensure_future(self._drive())
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log("http", f"serving on {self.host}:{self.port}")

    async def stop(self) -> None:
        self._stopping = True
        self._work_evt.set()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._driver_task is not None:
            await self._driver_task
        self.engine._driver = None

    async def serve_forever(self) -> None:
        await self._server.serve_forever()

    # -- the shared step driver --------------------------------------------
    async def _drive(self) -> None:
        """Step the engine while it has work; park on ``_work_evt``
        otherwise.  Each step fires ``_step_evt`` once for every stream
        currently waiting (the event is swapped, not reused, so a waiter
        can never miss a step or double-count one)."""
        while not self._stopping:
            if self.engine.has_work:
                self.engine.step()
                evt, self._step_evt = self._step_evt, asyncio.Event()
                evt.set()
                await asyncio.sleep(0)  # let streams flush between steps
            else:
                self._work_evt.clear()
                # wake also fires on stop(); loop re-checks _stopping
                await self._work_evt.wait()
        # release any stream still parked on the final event
        self._step_evt.set()

    async def wait_step(self) -> None:
        """Await the next completed engine step (RequestHandle.stream
        calls this instead of stepping when a server owns the engine)."""
        self._work_evt.set()
        await self._step_evt.wait()

    # -- connection handling -----------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            method, path, headers, body = await self._read_request(reader)
            if method is None:
                return
            if method == "GET" and path == "/healthz":
                await self._plain(writer, 200, "ok\n")
            elif method == "GET" and path == "/metrics":
                await self._metrics(writer)
            elif method == "GET" and path == "/slo":
                await self._slo(writer)
            elif method == "GET" and path == "/debug/quality":
                await self._quality(writer)
            elif method == "POST" and path == "/v1/generate":
                await self._generate(reader, writer, headers, body)
            else:
                await self._plain(writer, 404, "not found\n")
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None, None, None, None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None, None, None, None
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            key, _, val = line.decode("latin-1").partition(":")
            headers[key.strip().lower()] = val.strip()
        n = int(headers.get("content-length", 0))
        body = await reader.readexactly(min(n, _MAX_BODY)) if n else b""
        return method, path, headers, body

    async def _plain(self, writer, status: int, text: str,
                     extra: str = "") -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests",
                  500: "Internal Server Error"}.get(status, "OK")
        data = text.encode()
        writer.write((f"HTTP/1.1 {status} {reason}\r\n"
                      f"Content-Type: text/plain; charset=utf-8\r\n"
                      f"Content-Length: {len(data)}\r\n{extra}"
                      "Connection: close\r\n\r\n").encode() + data)
        await writer.drain()

    async def _metrics(self, writer) -> None:
        obs = getattr(self.engine, "obs", None)
        if not obs:
            await self._plain(
                writer, 404,
                "engine has no recorder (start serve with --metrics)\n")
            return
        await self._plain(writer, 200, obs.to_prometheus())

    async def _slo(self, writer) -> None:
        obs = getattr(self.engine, "obs", None)
        slo = getattr(obs, "slo", None) if obs else None
        if slo is None:
            await self._plain(
                writer, 404,
                "engine has no recorder (start serve with --metrics)\n")
            return
        await self._json(writer, slo.snapshot())

    async def _quality(self, writer) -> None:
        obs = getattr(self.engine, "obs", None)
        quality = getattr(obs, "quality", None) if obs else None
        if quality is None:
            await self._plain(
                writer, 404, "engine has no quality probe (start serve "
                "with --quality-probe)\n")
            return
        await self._json(writer, quality.snapshot())

    async def _json(self, writer, obj: dict) -> None:
        data = json.dumps(obj, sort_keys=True).encode()
        writer.write((f"HTTP/1.1 200 OK\r\n"
                      f"Content-Type: application/json\r\n"
                      f"Content-Length: {len(data)}\r\n"
                      "Connection: close\r\n\r\n").encode() + data)
        await writer.drain()

    # -- streaming generation ----------------------------------------------
    def _check_rate(self, tenant: str) -> Optional[int]:
        """``None`` when admitted, else the ``Retry-After`` seconds."""
        if not self.rate_limit:
            return None
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = _TokenBucket(
                self.rate_limit, self.rate_burst)
        if bucket.try_take():
            return None
        return bucket.retry_after()

    async def _generate(self, reader, writer, headers, body) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
            prompt = [int(t) for t in spec["prompt"]]
        except (ValueError, KeyError, TypeError):
            await self._plain(writer, 400,
                              'body must be JSON with "prompt": [ints]\n')
            return
        tenant = headers.get("x-tenant") or spec.get("tenant") or "default"
        retry = self._check_rate(tenant)
        if retry is not None:
            await self._plain(writer, 429,
                              f"tenant {tenant!r} over rate limit\n",
                              extra=f"Retry-After: {retry}\r\n")
            return

        from repro_torch.serving.sampling import SamplingParams
        sampling = SamplingParams(
            temperature=float(spec.get("temperature", 0.0)),
            top_k=int(spec.get("top_k", 0)),
            top_p=float(spec.get("top_p", 1.0)),
            seed=int(spec.get("seed", 0)))
        handle = self.engine.submit(
            prompt, sampling=sampling,
            max_new_tokens=int(spec.get("max_new_tokens", 16)),
            eos_id=spec.get("eos_id"))
        client_rid = headers.get("x-request-id")
        if client_rid:
            handle._req.client_request_id = client_rid
            obs = getattr(self.engine, "obs", None)
            if obs:
                obs.on_request_id(handle._req, client_rid)
        self._work_evt.set()
        self.requests_served += 1

        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()

        # EOF on the request socket = client went away; poll it per token
        monitor = asyncio.ensure_future(reader.read())
        cancelled = False
        try:
            i = 0
            async for tok in handle.stream():
                if monitor.done():
                    cancelled = True
                    break
                await self._chunk(writer,
                                  {"token": int(tok), "index": i})
                i += 1
            if not cancelled:
                final = {"done": True, "request_id": handle.request_id,
                         "tokens": [int(t) for t in handle.tokens()]}
                if client_rid:
                    final["client_request_id"] = client_rid
                await self._chunk(writer, final)
                writer.write(b"0\r\n\r\n")
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            cancelled = True
        finally:
            monitor.cancel()
            if cancelled and not handle.done:
                handle.cancel()
                log("http", f"req {handle.request_id}: client disconnected, "
                    "cancelled")

    async def _chunk(self, writer, obj: dict) -> None:
        data = (json.dumps(obj, separators=(",", ":")) + "\n").encode()
        writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        await writer.drain()  # backpressure: slow reader stalls its stream
