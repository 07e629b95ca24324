"""Device time of the packed-matmul and decode-attention wrappers at the
shapes of ``chip_smoke.py``'s kernel phase, for an A/B of two trees.

Imports ``repro_torch`` from the path, so the same file times another
checkout's kernels (their wrappers take the same arguments):

  PYTHONPATH=src python src/repro_torch/launch/kernel_times.py --label new
  PYTHONPATH=/path/to/other/src python src/repro_torch/launch/kernel_times.py \\
      --label parent

Cases: K1 (``packed_gemv``, M = 8) and K2 (``packed_matmul``, M = 64) for
the three packed schemes on the four linear shapes of granite-8b; K3 / K4
(``gqa_decode_attention``) on the bf16, int8 and fp8 slabs of the table
case (B 8, H 32, Hk 8, Dh 128, Sk 1024, ragged lengths).  Each time is the
median of 20 calls timed with CUDA events, the L2 cache flushed before each
call, as in ``chip_smoke.py``; ``host_us`` is the host's time per call
(50 calls, no sync between).  ``--profile`` adds each case's device ms
per kernel name from ``torch.profiler`` (10 warm calls, L2 not flushed).
Prints one JSON line per case and a last line with the card's name and
power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.kernels.decode_attention import gqa_decode_attention
from repro_torch.kernels.packed_matmul import packed_gemv, packed_matmul
from repro_torch.quant.kv_cache import QuantizedKV
from repro_torch.quant.schemes import (get_kv_scheme, get_scheme,
                                       kv_quantize, quantize_weights)

LINEAR_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
SCHEMES = ["awq_int4", "mxfp4", "fp8"]
ATTN_LENS = [1024, 1, 37, 512, 1000, 300, 768, 64]


def time_ms(fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median device ms of ``fn`` (CUDA events; a 256 MB write flushes L2
    and a device spin covers the host's launch before each call)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds per call of ``fn``: the wrapper's own cost (checks,
    allocation, launch), with the device left to catch up after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def kernel_split(fn, reps: int = 10) -> dict:
    """{kernel name: device ms per call} over ``reps`` calls of ``fn``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name[:60]
            per[name] = per.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
    return {n: t / reps for n, t in per.items()}


def weights(scheme_name: str, k: int, n: int, gen, dev):
    """The packed weights of ``chip_smoke.make_packed_weights``."""
    scheme = get_scheme(scheme_name)
    if scheme_name == "awq_int4":
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        return scheme, *quantize_weights(scheme, w)
    per = 32 // scheme.weight_bits
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // per, n), generator=gen,
                           device=dev, dtype=torch.int64).to(torch.int32)
    if scheme_name == "mxfp4":
        exps = torch.randint(-12, -6, (k // 32, n), generator=gen, device=dev)
        return scheme, packed, torch.exp2(exps.to(torch.float32))
    scales = torch.rand((1, n), generator=gen, device=dev) * 1e-4 + 1e-4
    return scheme, packed, scales


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def emit(fn, **case):
        case["ms"] = time_ms(fn, flush)
        case["host_us"] = host_us(fn)
        if args.profile:
            case["kernels"] = kernel_split(fn)
        print(json.dumps({"label": args.label, **case}), flush=True)

    for scheme_name in SCHEMES:
        for k, n in LINEAR_SHAPES:
            scheme, packed, scales = weights(scheme_name, k, n, gen, dev)
            for name, fn, m in (("packed_gemv", packed_gemv, 8),
                                ("packed_matmul", packed_matmul, 64)):
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                emit(lambda: fn(x, packed, scales, scheme), name=name,
                     scheme=scheme_name, m=m, k=k, n=n)

    b, h, hk, dh, sk = 8, 32, 8, 128, 1024
    lens = torch.tensor(ATTN_LENS, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    v = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    for tier in ("bf16", "int8", "fp8"):
        if tier == "bf16":
            kc, vc = k.to(torch.bfloat16), v.to(torch.bfloat16)
        else:
            scheme = get_kv_scheme(tier)
            kc = QuantizedKV(*kv_quantize(scheme, k), tier)
            vc = QuantizedKV(*kv_quantize(scheme, v), tier)
        emit(lambda: gqa_decode_attention(q, kc, vc, lens),
             name="decode_attention", kv=tier, b=b, h=h, hk=hk, dh=dh, sk=sk)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
