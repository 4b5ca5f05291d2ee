"""Host ranges for ``torch.profiler``, paid for only while it records.

``annotate(name)`` is a ``record_function`` range while the profiler is
on and a shared no-op context otherwise, so the program can label its
phases (the serving engine's step spans, a step program's staging and
launch, the ResNet-9 layers) at one ``_profiler_enabled()`` check each
when nobody is profiling.  A profiler trace then puts each device idle
gap down to the program's innermost range around it.
"""
from __future__ import annotations

import contextlib

import torch

NO_RANGE = contextlib.nullcontext()  # reentrant, shared: allocates nothing


def annotate(name: str):
    """A ``record_function(name)`` range while ``torch.profiler`` records,
    else a no-op context (the same object each call: nothing allocated)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NO_RANGE
