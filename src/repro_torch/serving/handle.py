"""The public per-request handle every engine's ``submit`` returns.

Host-side Python, ported almost verbatim from ``repro.serving.handle``.

A :class:`RequestHandle` wraps the scheduler-internal
:class:`~repro_torch.serving.scheduler.Request` with the supported surface —
``request_id``, ``status``, ``tokens()``, ``cancel()`` and the async
``stream()`` the HTTP layer serves from — while delegating unknown
attributes to the wrapped request, so existing call sites reading
``.generated`` / ``.done`` / ``.uid`` keep working unchanged.

``stream()`` is engine-driving: awaiting it steps the engine until the
request finishes (cooperatively — one engine step per event-loop turn).
When a server driver owns the engine (``engine._driver``, set by the HTTP
front-end of a later slice), the handle instead waits on its shared step
signal so concurrent streams ride one driver loop.
"""
from __future__ import annotations

import asyncio
from typing import AsyncIterator, List

from repro_torch.serving import scheduler as SCH

#: handle lifecycle states (`RequestHandle.status`)
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"


class RequestHandle:
    """Public view of a submitted request (all engines return one)."""

    __slots__ = ("_engine", "_req")

    def __init__(self, engine, req: SCH.Request):
        self._engine = engine
        self._req = req

    # -- the supported surface --------------------------------------------
    @property
    def request_id(self) -> int:
        return self._req.uid

    @property
    def status(self) -> str:
        """``queued`` | ``running`` | ``done`` | ``cancelled``."""
        if self._req.cancelled:
            return CANCELLED
        if self._req.done:
            return DONE
        if self._req.state == SCH.WAITING:
            return QUEUED
        return RUNNING

    def tokens(self) -> List[int]:
        """Snapshot of the tokens generated so far."""
        return list(self._req.generated)

    def cancel(self) -> bool:
        """Drop the request wherever it is; frees its row/pages."""
        return self._engine.cancel(self._req.uid)

    async def stream(self) -> AsyncIterator[int]:
        """Yield generated tokens as they land, finishing with the
        request.  Cooperative: each wait either steps the engine (no
        server attached) or awaits the server driver's step signal."""
        sent = 0
        while True:
            gen = self._req.generated
            while sent < len(gen):
                yield gen[sent]
                sent += 1
            if self._req.done:
                return
            await self._engine._advance_async()

    def result(self, max_steps: int = 10000) -> List[int]:
        """Block until the request finishes (stepping the engine) and
        return its tokens — the synchronous convenience mirror of
        :meth:`stream`."""
        steps = 0
        while not self._req.done:
            if steps >= max_steps:
                raise RuntimeError(
                    f"result(): {max_steps} steps exhausted with request "
                    f"{self._req.uid} still live")
            self._engine.step()
            steps += 1
        return list(self._req.generated)

    # -- back-compat -------------------------------------------------------
    def __getattr__(self, name: str):
        # delegate everything else (.generated, .done, .uid, .prompt, ...)
        # to the wrapped request so pre-handle call sites keep working
        return getattr(self._req, name)

    def __repr__(self) -> str:
        return (f"RequestHandle(id={self._req.uid}, status={self.status!r}, "
                f"tokens={len(self._req.generated)})")


async def _step_engine_async(engine) -> None:
    """Default ``_advance_async``: one engine step per event-loop turn
    when no server driver owns the engine."""
    drv = getattr(engine, "_driver", None)
    if drv is not None:
        await drv.wait_step()
        return
    if engine.has_work:
        engine.step()
    await asyncio.sleep(0)
