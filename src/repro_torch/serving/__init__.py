"""Public serving surface of the port: :func:`load_engine` builds the
paged :class:`ServeEngine` from params, an ``amm_lm`` artifact or a bundle's
target half, or a :class:`SpeculativeEngine` (draft-propose / target-verify
rounds on top of it) from a bundle or an artifact pair; ``submit()`` returns
a :class:`RequestHandle`.
"""
from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serving.handle import RequestHandle  # noqa: F401
from repro_torch.serving.kv_cache import (PageAllocator, PagedKVCache,  # noqa: F401
                                          PageError)
from repro_torch.serving.loader import load_engine  # noqa: F401
from repro_torch.serving.obs import NULL_RECORDER, NullRecorder, log  # noqa: F401
from repro_torch.serving.prefix import RadixPrefixIndex  # noqa: F401
from repro_torch.serving.sampling import SamplingParams  # noqa: F401
from repro_torch.serving.scheduler import Scheduler, StepPlan  # noqa: F401
from repro_torch.serving.speculative import SpeculativeEngine  # noqa: F401

__all__ = [
    "load_engine", "RequestHandle", "ServeEngine", "SpeculativeEngine",
    "Request",
    "SamplingParams", "PagedKVCache", "PageAllocator", "PageError",
    "RadixPrefixIndex", "Scheduler", "StepPlan", "NULL_RECORDER",
    "NullRecorder", "log",
]
