"""Continuous-batching serving over a slot KV pool (torch twin of the slab
path of ``repro.serve``): engine step primitives, FCFS scheduler with
chunked prefill and mid-flight admission, greedy sampling, metrics."""
from .engine import ServeConfig, ServingEngine  # noqa: F401
from .kv_pool import KVCachePool  # noqa: F401
from .request import Request, RequestState, SamplingParams  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
