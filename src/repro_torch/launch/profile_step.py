"""Where a serving step's time goes on the card: wall time vs device time.

  PYTHONPATH=src python -m repro_torch.launch.profile_step --arch granite-8b
  PYTHONPATH=src python -m repro_torch.launch.profile_step --arch minitron-8b

Builds the model on the card, fills every slot with one prefill chunk,
then times (a) prefill chunks and (b) decode steps over all slots: host
wall per step (ending in a device sync) and, from one ``torch.profiler``
pass over the same steps, the device time of every kernel.  Prints one
JSON object: per step kind, the wall ms, the device-busy ms (sum of kernel
durations), the idle share 1 - busy / wall, and the kernels ranked by
device time.  Device numbers come only from the profiler's CUDA activity;
when it reports none they are null.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import transformer as T
from repro_torch.models.common import QuantMaker
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.serve.engine import resolve_device


def _kernel_times(prof, steps: int):
    """[(kernel name, device ms per step)] from a profiler run, largest
    first; device-side events only."""
    per = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per[evt.name] = (per.get(evt.name, 0.0)
                             + evt.time_range.elapsed_us() / 1e3)
    return sorted(((n, t / steps) for n, t in per.items()),
                  key=lambda kv: -kv[1])


def measure(step, steps: int, dev, top=12):
    """Host wall ms per call of ``step`` (ending in a device sync), then one
    profiler pass: device-busy ms, idle share and the ``top`` kernels by
    time (all of them for ``top=None``)."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize(dev)
    kernels = _kernel_times(prof, steps)
    busy = sum(t for _, t in kernels) if kernels else None
    return {"steps": steps, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "kernels": [{"name": n[:80], "ms": t} for n, t in kernels[:top]]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--kv-dtype", default="bf16", help="bf16 | int8 | fp8")
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    with torch.no_grad():
        params = T.build_params(cfg, QuantMaker(args.seed, device=dev))
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=512, n_slots=args.n_slots, prefill_chunk=args.chunk,
        policy=PrecisionPolicy(kv=args.kv_dtype), device=str(dev)))
    pool = engine.new_pool()
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(1, cfg.vocab, (args.chunk,)).astype(np.int32)
    for _ in range(args.n_slots):
        slot = pool.alloc()
        engine.prefill_chunk_into_slot(pool, slot, prompt, 0)
    tokens = np.ones((args.n_slots,), np.int32)

    def prefill():      # rewrites slot 0's first chunk (lengths unchanged)
        engine.prefill_chunk_into_slot(pool, 0, prompt, 0)

    def decode():       # the write lands where the next real write goes
        engine.decode_slots(pool, tokens)

    prefill()
    decode()           # warm-up: kernel build and first launches
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev), "arch": cfg.name,
        "kv": args.kv_dtype, "n_slots": args.n_slots, "chunk": args.chunk,
        "prefill_chunk": measure(prefill, args.steps, dev),
        "decode_step": measure(decode, args.steps, dev)}))


if __name__ == "__main__":
    main()
