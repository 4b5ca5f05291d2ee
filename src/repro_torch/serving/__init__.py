"""Public serving surface of the port: :func:`load_engine` builds the
paged :class:`ServeEngine` (or, for the families without a paged layout or
with ``engine="fixed"``, the :class:`FixedSlotEngine`) from params, an
``amm_lm`` artifact or a bundle's target half, or a
:class:`SpeculativeEngine` (draft-propose / target-verify rounds on top of
the paged engine) from a bundle or an artifact pair; ``submit()`` returns
a :class:`RequestHandle`.  :class:`AsyncServer` serves an engine over HTTP;
a :class:`Recorder` (with an optional :class:`KernelProfiler` and
:class:`QualityProbe`) observes it.
"""
from repro_torch.serving.engine import (FixedSlotEngine, Request,  # noqa: F401
                                        ServeEngine, make_engine)
from repro_torch.serving.handle import RequestHandle  # noqa: F401
from repro_torch.serving.http import AsyncServer  # noqa: F401
from repro_torch.serving.kv_cache import (PageAllocator, PagedKVCache,  # noqa: F401
                                          PageError)
from repro_torch.serving.loader import load_engine  # noqa: F401
from repro_torch.serving.obs import (NULL_RECORDER, MetricsRegistry,  # noqa: F401
                                     NullRecorder, Recorder, SloThresholds,
                                     SloTracker, Tracer, log, slo_report,
                                     summary_table, validate_chrome_trace,
                                     validate_prometheus)
from repro_torch.serving.prefix import RadixPrefixIndex  # noqa: F401
from repro_torch.serving.profiler import (KernelProfiler,  # noqa: F401
                                          attach_dispatch_hook)
from repro_torch.serving.quality import QualityProbe  # noqa: F401
from repro_torch.serving.sampling import SamplingParams  # noqa: F401
from repro_torch.serving.scheduler import Scheduler, StepPlan  # noqa: F401
from repro_torch.serving.speculative import SpeculativeEngine  # noqa: F401

__all__ = [
    # factory + per-request handle (the supported front door)
    "load_engine",
    "RequestHandle",
    "AsyncServer",
    # engines (constructors are public; prefer load_engine)
    "ServeEngine",
    "FixedSlotEngine",
    "SpeculativeEngine",
    "make_engine",
    # request/sampling types
    "Request",
    "SamplingParams",
    # paged KV + prefix reuse
    "PagedKVCache",
    "PageAllocator",
    "PageError",
    "RadixPrefixIndex",
    "Scheduler",
    "StepPlan",
    # observability
    "Recorder",
    "NullRecorder",
    "NULL_RECORDER",
    "MetricsRegistry",
    "Tracer",
    "log",
    "summary_table",
    "validate_prometheus",
    "validate_chrome_trace",
    "QualityProbe",
    "KernelProfiler",
    "attach_dispatch_hook",
    "SloTracker",
    "SloThresholds",
    "slo_report",
]
