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

Serving policy: ``--slo-max-waiting N`` / ``--slo-max-queue-delay-s S`` /
``--slo-downgrade FROM:TO --slo-high-s H --slo-low-s L`` /
``--slo-max-step-s S`` attach an ``SLOPolicy`` (typed admission, KV-tier
downgrade with hysteresis, cost-model burst and chunk planning);
``--slo-protect-priority P`` exempts classes <= P from rejection
(``--priority-mix`` assigns seeded classes).  Its thresholds are seconds
of the paper's V80 cost model, not wall seconds.  ``--fault-rate R`` arms
a seeded fault injector after the warm-up: each dispatch dies or returns
poisoned ids with probability R (half each), and the scheduler recovers
by requeueing, up to ``--max-fault-retries`` faults a request.

  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --device cpu --tiers bf16,int8 --priority-mix 0:0.25,2:0.75 \
      --slo-max-waiting 4 --slo-downgrade bf16:int8 --slo-high-s 0.5 \
      --slo-low-s 0.1 --fault-rate 0.1

Speculative decoding: ``--spec`` drafts on a twin of the engine over the
same weights at ``--spec-draft-kv`` (a KV tier, or a ``PrecisionPolicy``
JSON file for the whole draft policy) and verifies each window in one
target dispatch; ``--spec-k`` is the draft length (k_init = k_max),
``--spec-corrupt`` garbles every draft (acceptance 0, the output
unchanged).  The report gains the ``spec`` block and the planner's
snapshot.

  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --device cpu --spec --spec-k 4 --temperature 0.8

The static-batch families (the recurrent ``--arch xlstm-350m`` and
``--arch zamba2-7b``, the VLM ``--arch phi-3-vision-4.2b`` and the audio
encoder-decoder ``--arch whisper-medium``) are served
by the engine's static-batch loop (``ServingEngine.generate``, the
reference's ``_generate_legacy``): one warm-up generation at the real
shapes, then the timed one; the report gives the generated shape, tokens
a second, the kernel launches and the peak memory.  The VLM's prompts
start with [batch, n_patches, d_model] patch embeddings drawn from
``--seed`` at the embedding table's scale (0.02 x a standard normal: the
stub of the vision frontend's output); ``prompt_len`` counts the tokens
only, ``n_patches`` stands beside it.  The audio model's batch carries
[batch, n_frames, d_model] frame embeddings drawn the same way (the stub
of the conv frontend's output), which its encoder reads; ``n_frames``
stands beside ``prompt_len``.  The scheduler's flags (tiers,
budgets, SLO, faults, spec, trace) do not apply there.

  python -m repro_torch.launch.serve --arch zamba2-7b --smoke --device cpu
  python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --smoke \
      --device cpu
  python -m repro_torch.launch.serve --arch whisper-medium --smoke \
      --device cpu

Observability: ``--trace PATH`` writes a Chrome trace of the timed run
(each request's WAITING / PREFILL / DECODE spans, one event per prefill
chunk and decode dispatch; open it in Perfetto or chrome://tracing);
``--metrics-out PATH`` writes the metrics registry's Prometheus-style
exposition at PATH and a snapshot a second (scheduler clock) at
PATH.jsonl.  Either flag also attaches the model-vs-measured profiler,
and the report gains ``model_measured`` (the paper's V80 cost model over
the host wall of each dispatch: the model seconds are the FPGA's, not a
figure for the card).  Without them the scheduler runs with ``obs=None``.

  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --device cpu --trace t.json --metrics-out m.prom
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import (ARCH_IDS, FRONTEND_INPUTS,
                                 STATIC_BATCH_FAMILIES, get_config)
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.common import QuantMaker
from repro_torch.obs import (MetricsRegistry, Observability, SnapshotWriter,
                             StepProfiler, Tracer)
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine, SLOPolicy,
                               SpecConfig)
from repro_torch.serve.engine import resolve_device


def add_policy_args(ap: argparse.ArgumentParser) -> None:
    """The ``--slo-*`` and fault flags (``build_slo``,
    ``build_fault_injector``)."""
    ap.add_argument("--slo-max-waiting", type=int, default=None)
    ap.add_argument("--slo-max-queue-delay-s", type=float, default=None)
    ap.add_argument("--slo-protect-priority", type=int, default=0)
    ap.add_argument("--slo-downgrade", default=None, metavar="FROM:TO")
    ap.add_argument("--slo-high-s", type=float, default=None)
    ap.add_argument("--slo-low-s", type=float, default=None)
    ap.add_argument("--slo-max-step-s", type=float, default=None)
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--max-fault-retries", type=int, default=3)


def build_slo(args) -> Optional[SLOPolicy]:
    """An ``SLOPolicy`` from the --slo-* flags, or None when none given."""
    downgrade = None
    if args.slo_downgrade:
        src, dst = args.slo_downgrade.split(":")
        downgrade = {src: dst}
    if not any([args.slo_max_waiting, args.slo_max_queue_delay_s,
                downgrade, args.slo_max_step_s]):
        return None
    return SLOPolicy(
        max_waiting=args.slo_max_waiting,
        max_queue_delay_s=args.slo_max_queue_delay_s,
        protect_priority=args.slo_protect_priority,
        downgrade_map=downgrade,
        downgrade_high_s=args.slo_high_s,
        downgrade_low_s=args.slo_low_s,
        max_step_s=args.slo_max_step_s)


def build_fault_injector(args) -> Tuple[Optional[Callable], Callable]:
    """(injector, arm): a seeded ``(kind, seq) -> mode`` injector that
    stays quiet until ``arm()`` (call it after the warm-up).  Its own
    generator, ``default_rng(seed + 7919)``, is consulted once per
    dispatch in dispatch order; half its faults kill the dispatch, half
    poison its ids ('nan'; a prefill chunk is killed either way)."""
    if not args.fault_rate:
        return None, lambda: None
    frng = np.random.default_rng(args.seed + 7919)
    armed = []

    def injector(kind, seq):
        if not armed or frng.random() >= args.fault_rate:
            return None
        return "nan" if frng.random() < 0.5 else "injected"

    return injector, lambda: armed.append(True)


def add_spec_args(ap: argparse.ArgumentParser) -> None:
    """The ``--spec*`` flags (``build_spec``)."""
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding with a low-precision draft")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft length (k_init = k_max)")
    ap.add_argument("--spec-draft-kv", default="int8",
                    help="the draft's KV tier, or a PrecisionPolicy JSON "
                         "file for the whole draft policy")
    ap.add_argument("--spec-corrupt", action="store_true",
                    help="garble every draft (acceptance 0)")


def build_spec(args) -> Optional[SpecConfig]:
    """A ``SpecConfig`` from the --spec* flags, or None without --spec."""
    if not args.spec:
        return None
    draft_kv, draft_policy = args.spec_draft_kv, None
    if os.path.exists(args.spec_draft_kv):
        with open(args.spec_draft_kv) as f:
            draft_policy = PrecisionPolicy.from_json(f.read())
        draft_kv = draft_policy.kv
    return SpecConfig(draft_kv=draft_kv, draft_policy=draft_policy,
                      k_max=args.spec_k, k_init=args.spec_k,
                      corrupt_drafts=args.spec_corrupt)


def build_obs(args, cfg) -> Optional[Observability]:
    """The bundle the --trace / --metrics-out flags ask for (the
    reference's ``launch/serve.py``): a tracer for --trace, a registry and
    its snapshots at PATH.jsonl for --metrics-out, the profiler for
    either; None without them."""
    if not (args.trace or args.metrics_out):
        return None
    registry = MetricsRegistry() if args.metrics_out else None
    return Observability(
        tracer=Tracer() if args.trace else None, registry=registry,
        profiler=StepProfiler(cfg),
        snapshots=SnapshotWriter(registry, args.metrics_out + ".jsonl")
        if registry is not None else None)


def write_obs(obs: Optional[Observability], args, report: dict) -> None:
    """Write the trace and the exposition, and add ``model_measured`` and
    the sinks' counts to ``report``."""
    if obs is None:
        return
    if obs.tracer is not None:
        obs.tracer.write(args.trace)
        report["trace_events"] = len(obs.tracer)
    if obs.profiler.n_records:
        report["model_measured"] = obs.profiler.report()
    if obs.registry is not None:
        with open(args.metrics_out, "w") as f:
            f.write(obs.registry.expose())
        report["metrics_snapshots"] = obs.snapshots.n_written


def parse_priority_mix(spec: Optional[str]):
    """'0:0.25,2:0.75' -> ([0, 2], [0.25, 0.75]) (weights normalized)."""
    if not spec:
        return [0], [1.0]
    classes, weights = [], []
    for part in spec.split(","):
        prio, w = part.split(":")
        classes.append(int(prio))
        weights.append(float(w))
    total = sum(weights)
    if total <= 0:
        raise SystemExit("--priority-mix weights must sum > 0")
    return classes, [w / total for w in weights]


def draw_frontend(cfg, rows: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The stub frontend's output a static batch carries, bf16, drawn from
    ``seed`` at the embedding table's scale (0.02 x a standard normal):
    ``{"patches": [rows, n_patches, d_model]}`` for the VLM, ``{"frames":
    [rows, n_frames, d_model]}`` for the audio model, {} for the other
    families."""
    if cfg.family not in FRONTEND_INPUTS:
        return {}
    key, length = FRONTEND_INPUTS[cfg.family]
    gen = torch.Generator(device=device).manual_seed(seed)
    return {key: (torch.randn((rows, getattr(cfg, length), cfg.d_model),
                              generator=gen, device=device)
                  * 0.02).to(torch.bfloat16)}


def serve_static(engine: ServingEngine, args, batch: dict, dev,
                 build_s: float) -> dict:
    """A static-batch family through ``generate``'s static-batch loop: a
    warm-up generation at the real shapes, then the timed one."""
    if args.tiers or args.spec or args.trace or args.metrics_out \
            or args.fault_rate or args.cache_budget_mb is not None \
            or build_slo(args) is not None:
        raise SystemExit(f"{engine.cfg.name}: the static-batch loop takes "
                         "none of the scheduler's flags")
    engine.generate(batch, max_new_tokens=args.max_new, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(batch, max_new_tokens=args.max_new,
                          seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    new_tokens = int(out["lengths"].sum())
    return {
        "arch": engine.cfg.name, "batch": out["batch"],
        "prompt_len": out["prompt_len"], "n_patches": engine.cfg.n_patches,
        "n_frames": engine.cfg.n_frames,
        "kv": engine.policy.kv,
        "temperature": args.temperature, "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "build_s": build_s, "generate_s": wall, "new_tokens": new_tokens,
        "tokens_per_s": new_tokens / wall,
        "finish_reasons": out["finish_reasons"],
        "launches": ops.launch_counts(),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "first_output": out["generated"][0, :8].tolist()}


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
    ap.add_argument("--priority-mix", default=None,
                    help="seeded classes, e.g. 0:0.25,2:0.75")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace of the timed run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics exposition at PATH and its "
                         "snapshots at PATH.jsonl")
    add_policy_args(ap)
    add_spec_args(ap)
    args = ap.parse_args(argv)
    spec = build_spec(args)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = T.build_params(cfg, QuantMaker(args.seed, device=dev))
    tiers = args.tiers.split(",") if args.tiers else None
    budget = None if args.cache_budget_mb is None \
        else int(args.cache_budget_mb * 1e6)
    injector, arm_faults = build_fault_injector(args)
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=args.prompt_len + args.max_new, n_slots=args.n_slots,
        temperature=args.temperature,
        prefill_chunk=args.prefill_chunk, max_burst=args.max_burst,
        cache_budget_bytes=budget, policy=PrecisionPolicy(kv=args.kv_dtype),
        device=str(dev), fault_injector=injector,
        max_fault_retries=args.max_fault_retries))
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab, (args.batch, args.prompt_len))
    if cfg.family in STATIC_BATCH_FAMILIES:
        batch = {"tokens": prompts,
                 **draw_frontend(cfg, args.batch, args.seed, dev)}
        print(json.dumps(serve_static(engine, args, batch, dev, build_s)))
        return
    classes, weights = parse_priority_mix(args.priority_mix)
    prios = rng.choice(classes, size=args.batch, p=weights)

    def serve(batch, slo=None, obs=None):
        sched = Scheduler(engine, tiers=tiers, slo=slo, spec=spec, obs=obs)
        reqs = [sched.submit(Request(
            prompt=p, kv_policy=tiers[i % len(tiers)] if tiers else None,
            priority=int(prios[i]),
            sampling=SamplingParams(temperature=args.temperature,
                                    max_new_tokens=args.max_new,
                                    seed=args.seed)))
            for i, p in enumerate(batch)]
        sched.run()
        return sched, reqs

    serve(prompts[:len(tiers) if tiers else 1])             # warm-up
    arm_faults()
    slo = build_slo(args)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    obs = build_obs(args, cfg)
    ops.reset_launch_counts()
    sched, reqs = serve(prompts, slo, obs)
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
    if slo is not None:
        report["slo"] = slo.snapshot()
    if spec is not None:
        report["spec_planner"] = sched.spec_planner.snapshot()
    write_obs(obs, args, report)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
