"""Where a serving step's time goes on the card: wall time vs device time.

  PYTHONPATH=src python -m repro_torch.launch.profile_step --arch granite-8b
  PYTHONPATH=src python -m repro_torch.launch.profile_step --arch minitron-8b
  PYTHONPATH=src python -m repro_torch.launch.profile_step --temperature 0.8
  PYTHONPATH=src python -m repro_torch.launch.profile_step --paged
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch qwen3-moe-30b-a3b [--chunk 128]
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch deepseek-v2-236b --layers 8

Builds the model on the card (at full width; ``--layers`` cuts the depth
of a model that does not fit the card: deepseek-v2-236b runs 8 of its 60
layers), fills every slot with one prefill chunk, then times (a) prefill
chunks and (b) decode steps over all slots: host wall per step (ending in
a device sync) and, from one ``torch.profiler`` pass over the same steps, the device time of every kernel.  Prints one
JSON object: per step kind, the wall ms, the device-busy ms (sum of kernel
durations), the idle share 1 - busy / wall, and the kernels ranked by
device time.  With ``--temperature`` every row also samples at that
temperature with its own threefry keys: (c) the decode step so, and (d)
the sampler alone (``sample_rows`` on [n_slots, vocab] f32 logits), so (c)
minus (b) and (d) are the sampler's cost.  With ``--paged`` the same slots
are also filled in a fully provisioned paged pool (pages of one prefill
chunk) and (e) its prefill chunks and (f) its decode steps are timed the
same way, beside (g) the page gather alone: every layer's K and V virtual
slabs gathered through the full page table, as a decode step gathers
them.  ``paged_minus_slab_ms`` lists, by kernel name, the device time per
step that a paged step adds to the slab one (the gather's indexing
kernels and the writes through the table).  For a MoE model (h) one
layer's MoE block alone, at the decode step's rows and at one prefill
chunk, splits its device time between the expert-grouped K1 / K2 kernels
and the torch ops around them (router matmul, routing, dispatch,
combine), and ``moe_share`` is the layers' MoE blocks' part of the whole
step's device time (``--chunk 128`` and up gives capacity buffers past 8
rows: grouped K2).  Device numbers come only from the profiler's CUDA
activity; when it reports none they are null.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.common import QuantMaker
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.serve.engine import resolve_device
from repro_torch.quant.kv_cache import gather_pages
from repro_torch.serve.sampling import batched_step_keys, sample_rows


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


def _by_name(kernels):
    """{kernel name: ms} from ``measure``'s list (names cut to 80 chars
    may repeat: summed)."""
    out = {}
    for k in kernels:
        out[k["name"]] = out.get(k["name"], 0.0) + k["ms"]
    return out


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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--layers", type=int, default=None,
                    help="run this many layers at full width")
    ap.add_argument("--paged", action="store_true",
                    help="also time the steps on a paged pool")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
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
    out = {"device": torch.cuda.get_device_name(dev), "arch": cfg.name,
           "layers": cfg.n_layers, "kv": args.kv_dtype,
           "n_slots": args.n_slots, "chunk": args.chunk,
           "prefill_chunk": measure(prefill, args.steps, dev, top=None),
           "decode_step": measure(decode, args.steps, dev, top=None)}
    slab = {k: out[k] for k in ("prefill_chunk", "decode_step")}
    for k in slab:
        out[k] = dict(slab[k], kernels=slab[k]["kernels"][:12])
    if args.temperature > 0:
        n = args.n_slots
        keys = batched_step_keys(np.full(n, args.seed), np.arange(n),
                                 np.zeros(n), 1)[:, 0]
        temps = np.full((n,), args.temperature, np.float32)
        logits = torch.randn((n, cfg.vocab), device=dev,
                             generator=torch.Generator(dev).manual_seed(0))

        def decode_temperature():
            engine.decode_slots(pool, tokens, keys, temps)

        def sampler():
            sample_rows(logits, keys, temps).cpu()

        decode_temperature()
        out.update(temperature=args.temperature,
                   decode_step_temperature=measure(decode_temperature,
                                                   args.steps, dev),
                   sampler=measure(sampler, args.steps, dev))
    if args.paged:
        out.update(paged_steps(cfg, params, args, prompt, tokens, dev, slab))
    if cfg.family == "moe":
        out["moe_layer"] = moe_layer_steps(cfg, params, args, dev, slab)
    print(json.dumps(out))


# the expert-grouped kernels' name in the profiler: the persistent body
# that grouped K1 and K2 launch
GROUPED_KERNELS = ("grouped_gemv_kernel",)


def moe_layer_steps(cfg, params, args, dev, slab):
    """(h) layer 0's MoE block alone on random bf16 inputs at the decode
    step's [n_slots, 1, D] and a prefill chunk's [1, chunk, D]: device ms
    of the grouped kernels and of the other (torch) ops, and the MoE
    blocks' share (n_layers x the block) of ``slab``'s whole steps."""
    mcfg = MOE.moe_cfg(cfg)
    blk = params.layers[0].moe
    gen = torch.Generator(dev).manual_seed(args.seed)
    out = {}
    for kind, shape in (("decode_step", (args.n_slots, 1)),
                        ("prefill_chunk", (1, args.chunk))):
        x = torch.randn((*shape, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)

        def step():
            with torch.no_grad():
                MOE.moe_forward(blk, mcfg, x)

        step()
        res = measure(step, args.steps, dev, top=None)
        kern = _by_name(res["kernels"])
        grouped = sum(t for n, t in kern.items()
                      if any(g in n for g in GROUPED_KERNELS))
        busy, whole = res["device_busy_ms"], slab[kind]["device_busy_ms"]
        out[kind] = dict(
            res, kernels=res["kernels"][:12], grouped_kernels_ms=grouped,
            torch_ops_ms=None if busy is None else busy - grouped,
            moe_share=(None if busy is None or not whole
                       else cfg.n_layers * busy / whole))
    return out


def paged_steps(cfg, params, args, prompt, tokens, dev, slab):
    """(e) prefill chunks, (f) decode steps and (g) the page gather alone on
    a fully provisioned paged pool holding the same slots; ``slab`` holds
    the slab pool's steps, every kernel listed, for the difference."""
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=512, n_slots=args.n_slots, prefill_chunk=args.chunk,
        paged=True, policy=PrecisionPolicy(kv=args.kv_dtype),
        device=str(dev)))
    pool = engine.new_pool()
    for _ in range(args.n_slots):
        slot, _, _ = pool.admit(prompt, 1)
        engine.prefill_chunk_into_slot(pool, slot, prompt, 0)
    pool.ensure_decode(range(args.n_slots), 1)
    table = torch.as_tensor(pool.page_table, dtype=torch.int64, device=dev)

    def prefill():      # rewrites slot 0's first chunk (lengths unchanged)
        engine.prefill_chunk_into_slot(pool, 0, prompt, 0)

    def decode():
        engine.decode_slots(pool, tokens)

    def gather():       # what one decode step gathers, every layer
        k_all, v_all = pool.cache
        for layer in range(cfg.n_layers):
            gather_pages(k_all[layer], table)
            gather_pages(v_all[layer], table)

    prefill()
    decode()
    gather()
    out = {"page_size": pool.page_size, "n_pages": pool.n_pages,
           "arena_bytes": pool.cache_bytes}
    for kind, step in (("prefill_chunk", prefill), ("decode_step", decode)):
        res = measure(step, args.steps, dev, top=None)
        base, mine = _by_name(slab[kind]["kernels"]), _by_name(res["kernels"])
        extra = sorted(((n, mine.get(n, 0.0) - base.get(n, 0.0))
                        for n in set(base) | set(mine)),
                       key=lambda kv: -kv[1])
        out[kind] = dict(res, kernels=res["kernels"][:12],
                         paged_minus_slab_ms=[{"name": n, "ms": t}
                                              for n, t in extra[:8]])
    out["gather"] = measure(gather, args.steps, dev)
    return {"paged": out}


if __name__ == "__main__":
    main()
