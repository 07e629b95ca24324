"""One-shot serving driver: synthesize a quantized checkpoint on the device
and serve a batch of random prompts through the continuous-batching
scheduler.

  python -m repro_torch.launch.serve --arch granite-8b \
      [--batch 8 --prompt-len 128 --max-new 32 --kv-dtype int8]
  python -m repro_torch.launch.serve --arch minitron-8b     # W8A8
  python -m repro_torch.launch.serve --arch granite-8b \
      --tiers bf16,int8,fp8 --cache-budget-mb 600 --temperature 0.8

(``PYTHONPATH=src`` from the repository root.)  A warm-up generation of one
token runs off the clock first; the timed run prints one JSON report:
serving metrics, device time per generated token, peak device memory, and
the kernel launch counts of the timed run.  ``--tiers`` serves the KV tiers
named side by side from one engine (one pool per tier, the requests'
``kv_policy`` round-robin over them); ``--cache-budget-mb`` sizes every
pool from that budget (10^6 bytes a MB) instead of ``--n-slots``;
``--temperature`` samples every request with its seeded threefry keys.
``--smoke`` serves the 2-layer config; ``--device cpu`` runs the kernels'
plain versions.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.common import QuantMaker
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine)
from repro_torch.serve.engine import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--kv-dtype", default="bf16", help="bf16 | int8 | fp8")
    ap.add_argument("--tiers", default=None,
                    help="comma-separated KV tiers served side by side")
    ap.add_argument("--cache-budget-mb", type=float, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--max-burst", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = T.build_params(cfg, QuantMaker(args.seed, device=dev))
    tiers = args.tiers.split(",") if args.tiers else None
    budget = None if args.cache_budget_mb is None \
        else int(args.cache_budget_mb * 1e6)
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=args.prompt_len + args.max_new, n_slots=args.n_slots,
        prefill_chunk=args.prefill_chunk, max_burst=args.max_burst,
        cache_budget_bytes=budget, policy=PrecisionPolicy(kv=args.kv_dtype),
        device=str(dev)))
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab, (args.batch, args.prompt_len))

    def serve(batch):
        sched = Scheduler(engine, tiers=tiers)
        reqs = [sched.submit(Request(
            prompt=p, kv_policy=tiers[i % len(tiers)] if tiers else None,
            sampling=SamplingParams(temperature=args.temperature,
                                    max_new_tokens=args.max_new,
                                    seed=args.seed)))
            for i, p in enumerate(batch)]
        sched.run()
        return sched, reqs

    serve(prompts[:len(tiers) if tiers else 1])             # warm-up
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    sched, reqs = serve(prompts)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report = sched.metrics.report()
    report.update(
        arch=cfg.name, kv=args.tiers or engine.policy.kv,
        temperature=args.temperature, device=str(dev),
        device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
        build_s=build_s, launches=ops.launch_counts(),
        peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        first_output=reqs[0].output_tokens[:8])
    print(json.dumps(report))


if __name__ == "__main__":
    main()
