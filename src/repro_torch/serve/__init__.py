"""Continuous-batching serving over slot KV pools (torch twin of the slab
path of ``repro.serve``): engine step primitives, a scheduler with one pool
per KV tier, priority preemption, chunked prefill and mid-flight admission,
greedy and seeded temperature sampling (``threefry.py``), metrics."""
from .engine import ServeConfig, ServingEngine  # noqa: F401
from .kv_pool import KVCachePool, bytes_per_slot, slots_for_budget  # noqa: F401
from .request import Request, RequestState, SamplingParams  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
