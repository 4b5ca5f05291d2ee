"""The parts of ``repro.serving.obs`` the host-side serving modules import:
the leveled logger and the falsy no-op recorder.

The metrics registry, tracer and ``Recorder`` join with the rest of
serving (ROADMAP A9).  Every hook site in the scheduler, allocator and
prefix index is guarded by ``if self.obs:``, so ``NULL_RECORDER`` costs one
truthiness check.
"""
from __future__ import annotations

import os

_LOG_LEVELS = {"debug": 10, "info": 20, "quiet": 100}


def _log_threshold() -> int:
    return _LOG_LEVELS.get(os.environ.get("REPRO_LOG", "info").strip().lower(),
                           _LOG_LEVELS["info"])


def log_enabled(level: str = "info") -> bool:
    return _LOG_LEVELS[level] >= _log_threshold()


def log(tag: str, msg: str, *, level: str = "info") -> None:
    """``[tag] msg`` to stdout when ``level`` clears ``REPRO_LOG``
    (debug|info|quiet, default info)."""
    if log_enabled(level):
        print(f"[{tag}] {msg}")


class NullRecorder:
    """The default recorder: falsy, and every hook is the same no-op."""

    __slots__ = ()
    enabled = False

    def __bool__(self) -> bool:
        return False

    @staticmethod
    def _noop(*args, **kwargs) -> None:
        return None

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return self._noop


NULL_RECORDER = NullRecorder()
