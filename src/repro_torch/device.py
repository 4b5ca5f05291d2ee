"""Device resolution, a generator for shapes only, and a synced stage
clock, shared by the port's entry points."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  A CUDA device without CUDA raises — nothing carries on
    quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


class MetaGenerator(torch.Generator):
    """A host generator whose ``device`` reads ``meta``: the init functions,
    which draw on their generator's device, then build tensors with shapes
    and dtypes but no storage (torch's random ops accept a host generator
    for ``meta`` tensors and draw nothing)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


class StageClock:
    """Host seconds per named stage, summed over calls.  A stage starts and
    ends with a device sync when CUDA is in use, so it holds its own
    device work and none of another's."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


def stage(clock: Optional[StageClock], name: str):
    """``clock.stage(name)``, or no timing without a clock."""
    return clock.stage(name) if clock is not None else contextlib.nullcontext()
