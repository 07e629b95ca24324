"""Device time of the packed-matmul, int8-matmul, decode-attention and
virtual-DSP wrappers at the shapes of ``chip_smoke.py``'s kernel phase,
for an A/B of two trees.

Imports ``repro_torch`` from the path, so the same file times another
checkout's kernels (their wrappers take the same arguments):

  PYTHONPATH=src python src/repro_torch/launch/kernel_times.py --label new
  PYTHONPATH=/path/to/other/src python src/repro_torch/launch/kernel_times.py \\
      --label parent

Cases: K1 (``packed_gemv``, M = 1 and 8) and K2 (``packed_matmul``, M =
64) for the three packed schemes on the four linear shapes of granite-8b;
K5 (``w8a8_matmul``, M = 1, 8 and 64) on minitron-8b's four linear shapes
and at K = 4100, each beside ``torch._int_mm`` with the same epilogue
(``library_ms``: M padded to 32 rows, K with zero codes to a multiple of
16, as that call needs); K3 / K4 (``gqa_decode_attention``) on the bf16, int8 and fp8 slabs of the
table case (B 8, H 32, Hk 8, Dh 128, Sk 1024, ragged lengths); K6
(``virtual_dsp_multiply`` on int4 x bf16, int32, and ``packed_multiply``
on fp32 x int16, int64, each at the Table VII GEMV's 50,331,648 lane MACs);
the expert-grouped wrappers on qwen3-moe-30b-a3b's awq_int4 expert stacks
(128 experts; 2048 x 768 and 768 x 2048) at ``chip_smoke.py``'s cases
(``grouped``): ``packed_gemv_grouped`` (grouped K1, M <= 8) at the decode
step's 64 (row, expert) pairs of M = 1 and a 64-token chunk's 128
capacity buffers of M = 5; ``packed_matmul_grouped`` (grouped K2, the M >
8 route) at the buffers of a 128-, 256- and 512-token chunk (M = 10, 20,
40); both at 40 groups of M = 3 over 8 experts (``repeats``); and, with
``grouped_probe``, grouped K1 at variants of the decode pairs: sorted by
expert, only their distinct experts, one row's 8 pairs (G = 8), one pair
(G = 1) and 64 distinct experts.  Which body runs a case is the tree's:
in older trees grouped K2 is K2's ``packed_mma_kernel`` with a grid axis
over the groups; in this one both wrappers launch the persistent
``grouped_gemv_kernel``, with items of 8 rows at M <= 8 and of 16 / 32
rows past it.  ``--lift-k1`` also times ``packed_gemv_grouped`` at the M
> 8 cases, on an older tree whose grouped K1 takes only M <= 8: its
source is rebuilt with the kernel's M <= 8 check lifted and the wrapper's
cap raised, so its body runs those buffers in items of 8 rows.
``--kernels`` picks some of ``gemv``, ``matmul``, ``w8a8``, ``attention``,
``vdsp``, ``grouped``, ``grouped_probe``.
``--patch NAME=VALUE`` (repeatable) rebuilds the tree's
``csrc/packed_matmul.cu`` with ``constexpr int NAME = VALUE;`` apart, in
``build/ablation/``, and times that build in place of the wrapper's (e.g.
a deeper ring; ``launch/grouped_ablation.py`` builds variants of other
kinds the same way).  Each time is the
median of 20 calls timed with CUDA events, the L2 cache flushed before each
call, as in ``chip_smoke.py``; ``host_us`` is the host's time per call
(50 calls, no sync between).  ``--profile`` adds each case's device ms
per kernel name from ``torch.profiler`` (10 warm calls, L2 not flushed).
Prints one JSON line per case and a last line with the card's name and
power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import time

import torch

from repro_torch.core import packing as P
from repro_torch.kernels import build
from repro_torch.kernels import packed_matmul as PM
from repro_torch.kernels.decode_attention import gqa_decode_attention
from repro_torch.kernels.packed_matmul import (packed_gemv,
                                               packed_gemv_grouped,
                                               packed_matmul,
                                               packed_matmul_grouped)
from repro_torch.models.common import QuantMaker
from repro_torch.kernels.w8a8_matmul import w8a8_matmul
from repro_torch.kernels.xtramac_mac import virtual_dsp_multiply
from repro_torch.quant.kv_cache import QuantizedKV
from repro_torch.quant.schemes import (get_kv_scheme, get_scheme,
                                       kv_quantize, quantize_activations_int8,
                                       quantize_weights)

LINEAR_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
W8A8_SHAPES = [(4096, 4096), (4096, 1024), (4096, 16384), (16384, 4096),
               (4100, 4096)]
SCHEMES = ["awq_int4", "mxfp4", "fp8"]
ATTN_LENS = [1024, 1, 37, 512, 1000, 300, 768, 64]
LANE_MACS = 50_331_648          # the paper's Table VII GEMV (1, 4096, 12288)
KERNEL_SETS = ("gemv", "matmul", "w8a8", "attention", "vdsp", "grouped")
# qwen3-moe-30b-a3b's expert stacks and chip_smoke.py's grouped K1 cases
QWEN3_EXPERTS, QWEN3_TOP_K, QWEN3_ROWS = 128, 8, 8
QWEN3_EXPERT_SHAPES = [(2048, 768), (768, 2048)]
GROUPED_CASES = [("decode", QWEN3_ROWS * QWEN3_TOP_K, 1),
                 ("prefill64", QWEN3_EXPERTS, 5),
                 ("prefill128", QWEN3_EXPERTS, 10),
                 ("prefill256", QWEN3_EXPERTS, 20),
                 ("prefill512", QWEN3_EXPERTS, 40),
                 ("repeats", 40, 3)]
# grouped K1's check of M <= 8 in an older source, and the same lifted
LIFT_K1 = ("if (M < 1 || M > 8 || N % 4 != 0 || ldx % 8 != 0 ||",
           "if (M < 1 || M > 64 || N % 4 != 0 || ldx % 8 != 0 ||")


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


def grouped_layout(label, g, m, gen, dev):
    """(expert ids [G], rows [G]) int32 on the card, as
    ``chip_smoke.grouped_layout`` draws them: each decode row's top-8
    distinct experts, 8 experts over 40 groups (the first 4 empty), or
    capacity buffers (expert e in group e) of 0-M rows."""
    if label == "decode":
        experts = torch.stack([
            torch.randperm(QWEN3_EXPERTS, generator=gen, device=dev)
            [:QWEN3_TOP_K] for _ in range(QWEN3_ROWS)]).reshape(-1)
        rows = torch.ones(g, dtype=torch.int64, device=dev)
    elif label == "repeats":    # 8 experts over 40 groups, some empty
        experts = torch.randint(0, 8, (g,), generator=gen, device=dev)
        rows = torch.randint(0, m + 1, (g,), generator=gen, device=dev)
        rows[:4] = 0
    else:
        experts = torch.arange(g, device=dev)
        rows = torch.randint(0, m + 1, (g,), generator=gen, device=dev)
    return experts.to(torch.int32), rows.to(torch.int32)


def grouped_probes(experts):
    """Variants of the decode pairs' layout ``experts`` [64] (label, ids):
    sorted by expert, the distinct experts alone, the first row's 8 pairs,
    one pair, and 64 distinct experts."""
    distinct = torch.unique(experts)
    return [("decode_sorted", torch.sort(experts).values),
            ("decode_dedup", distinct.to(torch.int32)),
            ("decode_row", experts[:QWEN3_TOP_K]),
            ("single", experts[:1]),
            ("distinct64", torch.arange(64, dtype=torch.int32,
                                        device=experts.device))]


def grouped_kernels(label, m, lift_k1=False):
    """The wrappers a grouped case runs through: grouped K1 at M <= 8 (also
    past it with ``lift_k1``), grouped K2 past it, both at ``repeats``."""
    k1 = m <= 8 or lift_k1 or label == "repeats"
    k2 = m > 8 or label == "repeats"
    return [fn for fn, on in ((packed_gemv_grouped, k1),
                              (packed_matmul_grouped, k2)) if on]


def lift_k1_cap(src: str) -> str:
    """An older source with grouped K1's M <= 8 check lifted
    (``LIFT_K1``), and the wrapper's cap raised to match."""
    if src.count(LIFT_K1[0]) != 1:
        raise SystemExit("kernel_times: --lift-k1 needs a grouped K1 that "
                         "checks M <= 8 (an older source)")
    PM.GEMV_MAX_M = 64
    return src.replace(*LIFT_K1)


def patched_library(patches, source=None, lift_k1=False):
    """``source`` (default: the tree's ``csrc/packed_matmul.cu``) with each
    ``constexpr int NAME = ...;`` of ``patches`` {NAME: VALUE} replaced
    (and, with ``lift_k1``, grouped K1's M <= 8 check lifted), built with
    ``nvcc`` into ``build/ablation/`` and installed as the library the
    wrappers load."""
    src = open(source or build.CSRC / "packed_matmul.cu").read()
    if lift_k1:
        src = lift_k1_cap(src)
    for name, value in patches.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise SystemExit(f"kernel_times: no constexpr int {name}")
    out = build.BUILD_DIR.parent / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(src.encode()).hexdigest()[:12]
    cu, so = out / f"packed_matmul-{tag}.cu", out / f"packed_matmul-{tag}.so"
    cu.write_text(src)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in PM._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    build._LOADED["packed_matmul"] = lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--kernels", default=",".join(KERNEL_SETS),
                    help="comma-separated subset of " + ", ".join(
                        KERNEL_SETS + ("grouped_probe",)))
    ap.add_argument("--patch", action="append", default=[],
                    metavar="NAME=VALUE")
    ap.add_argument("--lift-k1", action="store_true",
                    help="also time grouped K1 past M = 8 (an older "
                    "tree whose grouped K1 takes M <= 8 only)")
    args = ap.parse_args(argv)
    only = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    if args.patch or args.lift_k1:
        patched_library(dict(p.split("=", 1) for p in args.patch),
                        lift_k1=args.lift_k1)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def emit(fn, library=None, **case):
        case["ms"] = time_ms(fn, flush)
        if library is not None:
            case["library_ms"] = time_ms(library, flush)
        case["host_us"] = host_us(fn)
        if args.profile:
            case["kernels"] = kernel_split(fn)
        print(json.dumps({"label": args.label, **case}), flush=True)

    legs = [(name, fn, m) for name, fn, m, kind in (
        ("packed_gemv", packed_gemv, 1, "gemv"),
        ("packed_gemv", packed_gemv, 8, "gemv"),
        ("packed_matmul", packed_matmul, 64, "matmul")) if kind in only]
    for scheme_name in SCHEMES if legs else ():
        for k, n in LINEAR_SHAPES:
            scheme, packed, scales = weights(scheme_name, k, n, gen, dev)
            for name, fn, m in legs:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                emit(lambda: fn(x, packed, scales, scheme), name=name,
                     scheme=scheme_name, m=m, k=k, n=n)

    for k, n in W8A8_SHAPES if "w8a8" in only else ():
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        codes, scales = quantize_weights(get_scheme("w8a8"), w)
        wt = codes.t().contiguous()
        del w, codes
        lib_k = -(-k // 16) * 16
        wl = torch.zeros((n, lib_k), dtype=torch.int8, device=dev)
        wl[:, :k] = wt
        for m in (1, 8, 64):
            xc, xs = quantize_activations_int8(
                torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16))
            xl = torch.zeros((max(m, 32), lib_k), dtype=torch.int8,
                             device=dev)
            xl[:m, :k] = xc
            emit(lambda: w8a8_matmul(xc, xs, wt, scales),
                 library=lambda: torch._int_mm(xl, wl.t()).to(
                     torch.float32) * (scales * xs),
                 name="w8a8_matmul", m=m, k=k, n=n)
        del wt, wl, scales

    b, h, hk, dh, sk = 8, 32, 8, 128, 1024
    for tier in ("bf16", "int8", "fp8") if "attention" in only else ():
        lens = torch.tensor(ATTN_LENS, dtype=torch.int32, device=dev)
        q = torch.randn((b, 1, h, dh), generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
        v = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
        if tier == "bf16":
            kc, vc = k.to(torch.bfloat16), v.to(torch.bfloat16)
        else:
            scheme = get_kv_scheme(tier)
            kc = QuantizedKV(*kv_quantize(scheme, k), tier)
            vc = QuantizedKV(*kv_quantize(scheme, v), tier)
        emit(lambda: gqa_decode_attention(q, kc, vc, lens),
             name="decode_attention", kv=tier, b=b, h=h, hk=hk, dh=dh, sk=sk)

    vdsp = [(("int4", "bf16"), 4, torch.int32, virtual_dsp_multiply),
            (("fp32", "int16"), None, torch.int64,
             lambda a, b, p: P.packed_multiply(p, a, b))]
    for pair, cap, dtype, fn in vdsp if "vdsp" in only else ():
        plan = P.solve_lane_plan(*pair, max_parallelism=cap)
        t = LANE_MACS // plan.parallelism
        a = torch.randint(0, P.max_magnitude(plan.fmt_a) + 1,
                          (t, len(plan.offsets_a)), generator=gen,
                          device=dev, dtype=dtype)
        bm = torch.randint(0, P.max_magnitude(plan.fmt_b) + 1,
                           (t, len(plan.offsets_b)), generator=gen,
                           device=dev, dtype=dtype)
        emit(lambda: fn(a, bm, plan), name="virtual_dsp_multiply",
             pair="x".join(pair), dtype=str(dtype).split(".")[-1], t=t,
             p=plan.parallelism)
        del a, bm
    probe = "grouped_probe" in only
    mk = QuantMaker(5, device=dev)
    for k, n in QWEN3_EXPERT_SHAPES if {"grouped", "grouped_probe"} & only \
            else ():
        with torch.no_grad():
            leaf = mk.dense("moe.w_up", k, n, "awq_int4",
                            experts=QWEN3_EXPERTS)
        per_expert = (leaf.packed[0].numel() + leaf.scales[0].numel()) * 4
        for label, g, m in GROUPED_CASES:
            experts, rows = grouped_layout(label, g, m, gen, dev)
            base = "grouped" in only or (probe and label == "decode")
            cases = [(label, experts, rows)] if base else []
            if probe and label == "decode":
                cases += [(name, ids, rows[:len(ids)])
                          for name, ids in grouped_probes(experts)]
            for name, ids, live in cases:
                x = torch.randn((len(ids), m, k), generator=gen,
                                device=dev).to(torch.bfloat16)
                used = len(torch.unique(ids[live > 0]))
                for kernel in grouped_kernels(label, m, args.lift_k1):
                    emit(lambda: kernel(
                        x, leaf.packed, leaf.scales, leaf.scheme, ids, live),
                        name=kernel.__name__, case=name, g=len(ids), m=m,
                        k=k, n=n, experts=used, rows=int(live.sum()),
                        expert_bytes=used * per_expert,
                        patch=args.patch or None)
        del leaf
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
