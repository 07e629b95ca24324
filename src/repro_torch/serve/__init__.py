"""Continuous-batching serving over slot KV pools (torch twin of
``repro.serve``): engine step primitives, slab or paged pools (page
tables, copy-on-write prefix sharing, LRU eviction), a scheduler with one
pool per KV tier, priority preemption, chunked prefill and mid-flight
admission, greedy and seeded temperature sampling (``threefry.py``), an
SLO policy (typed admission, KV-tier downgrade priced by the paper's cost
model, deadlines), a fault-fenced dispatch, speculative decoding with a
low-precision draft twin, metrics."""
from repro_torch.runtime.fault_tolerance import (RetryBudget,  # noqa: F401
                                                 StepFault)

from .engine import ServeConfig, ServingEngine  # noqa: F401
from .kv_pool import (KVCachePool, PagedKVPool, PageAllocator,  # noqa: F401
                      bytes_per_page, bytes_per_slot, pages_for_budget,
                      slots_for_budget)
from .request import Request, RequestState, SamplingParams  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
from .slo import Rejection, SLOPolicy  # noqa: F401
from .spec import DraftEngine, SpecConfig, SpecPlanner  # noqa: F401
