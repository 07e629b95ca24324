"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases (a failed check is reported at once and makes the run exit
non-zero after the last phase; exceptions are not caught):
  0. the card's name and power limit, torch and CUDA versions;
  1. build every CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a,
     one process per source, all started together);
  2. every kernel against its plain torch version at its path's
     full-width shapes, timed with CUDA events (L2 flushed before each
     launch) beside its bound, its plain version and one library call:
     the packed GEMV (K1, M = 1, 8) and the tensor-core packed matmul (K2,
     M = 9, 64, 100) for three schemes on granite's four linear shapes,
     plus K2 on a ragged N (1000) and on decode leaves with N % 4 != 0
     (1022) that the dispatch routes to it; decode attention (K3 / K4) in
     three KV tiers on four head layouts (Dh 128, 192, 64, 112), also
     with zero-length rows (equal weights over the slab); the int8 matmul
     (also at K = 4100, zero-padded) and the virtual-DSP lane multiply
     (K6, the counterpart of ``repro/kernels/xtramac_mac.py``) must match
     their plain versions exactly, K6 for every paper datatype pair at the
     Table VII GEMV size (50,331,648 lane MACs: T = 50,331,648 / P issues);
  3. the MAC datapath (``repro_torch.core``, the counterpart of
     ``repro/core``): ``xtramac_packed`` for six Fig. 6 datatype
     combinations, 50,331,648 lane MACs each from random bit patterns
     (NaN, inf and subnormal codes included), its Stage-2 multiply on K6,
     held bit for bit against the plain path, against unpacked per-lane
     MACs (``per_lane_reference``) and, on 4,096 sampled lane MACs, against
     the exact oracle ``core/ref_mac.mac_exact``; then the cycle-level
     ``XtraMACPipeline`` over 64 issues that switch datatype every cycle
     (latency 4, II 1, every result checked); K6 must launch exactly once
     per ``xtramac_packed`` call and once per pipeline issue;
  then, for granite-8b (AWQ-int4, 36 layers) and minitron-8b (W8A8,
  squared-ReLU FFN, 32 layers), each at full width with random weights
  from a seed, one model after the other:
  4. the model: one prefill chunk and 4 decode steps through the kernels
     and through the plain versions, bf16 and int8 KV, logits within 5 %
     of the logit scale (``launch/logit_spread.logit_check``); minitron
     also runs the plain path with decode attention summed in the kernel's
     split-KV order, the witness that decides where the kernels miss 5 %
     (``logit_spread.witness_check``; PERF.md);
  5. serving: ServingEngine + Scheduler (8 slots, max_len 512, prefill
     chunk 64, bursts of up to 8) serve 6 seeded requests with staggered
     arrivals, once with bf16 KV and once with int8 KV; the kernels'
     launch counters are reset just before and read just after.  granite's
     tokens are checked against each request served alone; minitron's
     against a repeat of the same run (under W8A8 a row's activations are
     quantized with one scale per call, over its batch-mates too, so a
     request served alone may differ).
The second-to-last line is the ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``.  Every case is also written to
``chiprun_out/chip_smoke.json``.  The script imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import mac as M  # noqa: E402
from repro_torch.core import packing as P  # noqa: E402
from repro_torch.core.pipeline import Op, XtraMACPipeline  # noqa: E402
from repro_torch.core.ref_mac import mac_exact  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, gqa_decode_attention)
from repro_torch.kernels.packed_matmul import (  # noqa: E402
    packed_gemv, packed_matmul, packed_matmul_plain)
from repro_torch.kernels.w8a8_matmul import (  # noqa: E402
    w8a8_matmul, w8a8_matmul_plain)
from repro_torch.kernels.xtramac_mac import (  # noqa: E402
    REF_MAX_STRIDE, check_reference_domain, virtual_dsp_multiply,
    virtual_dsp_plain)
from repro_torch.launch import logit_spread as LS  # noqa: E402
from repro_torch.launch.profile_datapath import (  # noqa: E402
    DATAPATH_COMBOS, TABLE_VII_LANE_MACS, random_operands)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import QuantMaker  # noqa: E402
from repro_torch.quant.kv_cache import QuantizedKV, cache_read  # noqa: E402
from repro_torch.quant.policy import PrecisionPolicy  # noqa: E402
from repro_torch.quant.schemes import (  # noqa: E402
    dequantize, get_kv_scheme, get_scheme, kv_quantize,
    quantize_activations_int8, quantize_weights)
from repro_torch.serve import (Request, SamplingParams, Scheduler,  # noqa: E402
                               ServeConfig, ServingEngine)

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
# 32-bit integer instructions on the CUDA cores: 132 SMs x 64 INT32 lanes
# x 1.98 GHz boost clock (Hopper architecture white paper)
INT32_OPS = 132 * 64 * 1.98e9

KERNELS = {
    "packed_gemv": ("src/repro_torch/csrc/packed_matmul.cu",
                    "src/repro/kernels/packed_matmul.py:84"),
    "packed_matmul": ("src/repro_torch/csrc/packed_matmul.cu",
                      "src/repro/kernels/packed_matmul.py:84"),
    "w8a8_matmul": ("src/repro_torch/csrc/w8a8_matmul.cu",
                    "src/repro/kernels/packed_matmul.py:203"),
    "decode_attention_bf16": ("src/repro_torch/csrc/decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:137"),
    "decode_attention_quant": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:144"),
    "virtual_dsp_multiply": ("src/repro_torch/csrc/xtramac_mac.cu",
                             "src/repro/kernels/xtramac_mac.py:71"),
}
# the kernels each path must launch, and those it must not
PATH_KERNELS = {
    "xtramac-datapath": ("virtual_dsp_multiply",),
    "granite-8b": ("packed_gemv", "packed_matmul", "decode_attention_bf16",
                   "decode_attention_quant"),
    "minitron-8b": ("w8a8_matmul", "decode_attention_bf16",
                    "decode_attention_quant"),
}
LINEAR_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
MATMUL_ROWS = (9, 64, 100)          # K2: the prefill chunk (64) and beside
# (scheme, M, N) at K = 4096: a ragged N edge, and decode leaves with
# N % 4 != 0 that the dispatch sends to K2
RAGGED_LEAVES = [("awq_int4", 64, 1000), ("awq_int4", 8, 1022),
                 ("fp8", 8, 1022)]
# K = 4100 (not a multiple of 16): the int8 kernel on zero-padded copies
W8A8_SHAPES = [(4096, 4096), (4096, 1024), (4096, 16384), (16384, 4096),
               (4100, 4096)]
# decode attention: granite / minitron (the table case), nemotron-4-340b
# (d_head 192, GQA 96 / 8), qwen3-moe (64, 32 / 4), zamba2-7b (112, 32 / 32)
ATTN_LENS = [1024, 1, 37, 512, 1000, 300, 768, 64]
ATTN_LAYOUTS = [dict(h=32, hk=8, dh=128), dict(h=96, hk=8, dh=192),
                dict(h=32, hk=4, dh=64), dict(h=32, hk=32, dh=112)]
SCHEMES = ["awq_int4", "mxfp4", "fp8"]
# matmul tolerance of the reference's kernel tests; decode attention to one
# bf16 ulp (outputs are rounded to bf16; the sums differ only in order);
# model logits: LS.logit_check
MM_RTOL, MM_ATOL = 2e-3, 1e-3
ORACLE_SAMPLES = 4096
PIPELINE_ISSUES = 64
ATTN_RTOL, ATTN_ATOL = 2.0 ** -7, 1e-5

FAILED_CHECKS = []


def require(cond: bool, msg: str) -> None:
    """Record a failed check (reported now, fatal after the last phase)."""
    if not cond:
        FAILED_CHECKS.append(msg)
        print(f"CHECK FAILED: {msg}", file=sys.stderr, flush=True)


def log(*a) -> None:
    print(*a, flush=True)


class Timer:
    """Median device time of one call, from CUDA events around each call,
    with the L2 cache flushed (a 256 MB write) before every call: the
    serving loop reads each weight and KV byte cold.  A ~2 ms device spin
    before the start event keeps the stream busy while the host runs the
    wrapper, so the events time the device work and not the host's; the
    median drops a call whose host thread was held up past the spin."""

    SPIN_CYCLES = 4_000_000

    def __init__(self, device):
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device=device)
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e1 = torch.cuda.Event(enable_timing=True)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.e0.record()
            fn()
            self.e1.record()
            self.e1.synchronize()
            times.append(self.e0.elapsed_time(self.e1))
        return float(np.median(times))


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def make_packed_weights(scheme_name: str, k: int, n: int, gen, dev):
    """awq_int4: quantized normal weights; mxfp4 / fp8: uniformly random
    code words with scales that keep outputs O(1)."""
    scheme = get_scheme(scheme_name)
    if scheme_name == "awq_int4":
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        return scheme, *quantize_weights(scheme, w)
    per = 32 // scheme.weight_bits
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // per, n), generator=gen,
                           device=dev, dtype=torch.int64).to(torch.int32)
    if scheme_name == "mxfp4":
        exps = torch.randint(-12, -6, (k // 32, n), generator=gen, device=dev)
        scales = torch.exp2(exps.to(torch.float32))
    else:
        scales = torch.rand((1, n), generator=gen, device=dev) * 1e-4 + 1e-4
    return scheme, packed, scales


def packed_case(timer: Timer, name, fn, scheme, packed, scales, w_bf16, m,
                gen, dev, launch_name):
    """One packed linear leaf: ``fn`` (a wrapper, or the dispatch) against
    ``packed_matmul_plain`` at the reference's kernel tolerance, timed
    beside its bound, its plain version and ``x @ W_bf16``.  ``fn`` must
    launch ``launch_name`` once."""
    k, n = w_bf16.shape
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    before = ops.launch_counts()[launch_name]
    got = fn(x, packed, scales, scheme)
    launched = ops.launch_counts()[launch_name] - before
    want = packed_matmul_plain(x, packed, scales, scheme)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL))
    b, by = bound_ms(nbytes(x, packed, scales, got), 2.0 * m * k * n)
    case = {
        "name": name, "scheme": scheme.name, "m": m, "k": k, "n": n,
        "max_abs_err": err, "max_rel_err": err / float(want.abs().max()),
        "max_abs_out": float(want.abs().max()), "ok": ok,
        "ms": timer.ms(lambda: fn(x, packed, scales, scheme)),
        "plain_ms": timer.ms(lambda: packed_matmul_plain(
            x, packed, scales, scheme)),
        "library_ms": timer.ms(lambda: x @ w_bf16),
        "library": "torch.matmul(x bf16, dequantized W bf16)",
        "bound_ms": b, "bound_by": by}
    log(json.dumps(case))
    require(ok, f"{name} {scheme.name} M={m} K={k} N={n}: max |err| {err}")
    require(launched == 1, f"{name} {scheme.name} M={m} K={k} N={n}: "
                           f"{launched} {launch_name} launches, not 1")
    return case


def leaf_matmul(x, packed, scales, scheme):
    """A packed leaf through the model's dispatch, f32 out."""
    return ops.quantized_matmul(x, packed, scales, scheme,
                                out_dtype=torch.float32)


def kernel_phase(timer: Timer, gen, dev, chunk: int):
    cases = []
    for scheme_name in SCHEMES:
        for k, n in LINEAR_SHAPES:
            scheme, packed, scales = make_packed_weights(
                scheme_name, k, n, gen, dev)
            w_bf16 = dequantize(scheme, packed, scales, (k, n)).to(
                torch.bfloat16)
            for kind, fn, ms_list in (
                    ("packed_gemv", packed_gemv, (1, 8)),
                    ("packed_matmul", packed_matmul, MATMUL_ROWS)):
                for m in ms_list:
                    cases.append(packed_case(timer, kind, fn, scheme, packed,
                                             scales, w_bf16, m, gen, dev,
                                             kind))
            del packed, scales, w_bf16
    # K2 beyond the served shapes: a ragged N edge, and decode leaves the
    # GEMV does not take (N % 4 != 0), which the dispatch routes to K2
    for scheme_name, m, n in RAGGED_LEAVES:
        scheme, packed, scales = make_packed_weights(scheme_name, 4096, n,
                                                     gen, dev)
        w_bf16 = dequantize(scheme, packed, scales, (4096, n)).to(
            torch.bfloat16)
        cases.append(packed_case(timer, "packed_matmul", leaf_matmul, scheme,
                                 packed, scales, w_bf16, m, gen, dev,
                                 "packed_matmul"))
    cases += w8a8_cases(timer, gen, dev, chunk)
    for layout in ATTN_LAYOUTS:
        cases += attention_cases(timer, gen, dev, **layout)
    cases += empty_row_cases(gen, dev)
    cases += vdsp_cases(timer, gen, dev)
    return cases


def w8a8_cases(timer: Timer, gen, dev, chunk: int):
    """The int8 matmul at minitron-8b's four linear shapes, at decode (M =
    1, 8) and prefill (M = chunk) rows: exactly equal to its plain version
    (int32 sums are exact), timed beside its bound (bytes; int8 ops at the
    tensor cores' peak), its plain version and ``torch._int_mm`` with the
    same epilogue."""
    scheme = get_scheme("w8a8")
    cases = []
    for k, n in W8A8_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        codes, scales = quantize_weights(scheme, w)
        wt = codes.t().contiguous()              # the kernel's [N, K] layout
        del w, codes
        for m in (1, 8, chunk):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            xc, xs = quantize_activations_int8(x)
            got = w8a8_matmul(xc, xs, wt, scales)
            want = w8a8_matmul_plain(xc, xs, wt, scales)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.equal(got, want))
            b, by = bound_ms(nbytes(xc, xs, wt, scales, got), 2.0 * m * k * n,
                             INT8_OPS)
            # _int_mm takes more than 16 rows and K % 8 == 0: decode rows
            # are padded to 32, K with zero codes to a multiple of 16
            lib_m, lib_k = max(m, 32), -(-k // 16) * 16
            xl = torch.zeros((lib_m, lib_k), dtype=torch.int8, device=dev)
            xl[:m, :k] = xc
            wl = wt
            if lib_k != k:
                wl = torch.zeros((n, lib_k), dtype=torch.int8, device=dev)
                wl[:, :k] = wt

            def library():
                return torch._int_mm(xl, wl.t()).to(torch.float32) \
                    * (scales * xs)

            case = {
                "name": "w8a8_matmul", "m": m, "k": k, "n": n,
                "max_abs_err": err, "max_abs_out": float(want.abs().max()),
                "ok": ok,
                "ms": timer.ms(lambda: w8a8_matmul(xc, xs, wt, scales)),
                "plain_ms": timer.ms(lambda: w8a8_matmul_plain(
                    xc, xs, wt, scales)),
                "library_ms": timer.ms(library),
                "library": "torch._int_mm(x int8, W int8) + epilogue"
                           + (f", M padded to {lib_m}" if lib_m != m else "")
                           + (f", K padded to {lib_k}" if lib_k != k else ""),
                "bound_ms": b, "bound_by": by}
            cases.append(case)
            log(json.dumps(case))
            require(ok, f"w8a8_matmul M={m} K={k} N={n}: max |err| {err} "
                        "(must be 0)")
        del wt, scales
    return cases


def attention_cases(timer: Timer, gen, dev, b=8, h=32, hk=8, dh=128, sk=1024):
    lens = torch.tensor(ATTN_LENS, dtype=torch.int32, device=dev)[:b]
    q = torch.randn((b, 1, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    v = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    k_bf, v_bf = k.to(torch.bfloat16), v.to(torch.bfloat16)
    # the library yardstick: SDPA over the bf16 slab with a ragged mask
    kt, vt = k_bf.transpose(1, 2).contiguous(), v_bf.transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(sk, device=dev)[None, :] < lens[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    valid = int(lens.sum())
    cases = []
    for tier in ("bf16", "int8", "fp8"):
        if tier == "bf16":
            kc, vc, elem = k_bf, v_bf, 2
        else:
            scheme = get_kv_scheme(tier)
            kc = QuantizedKV(*kv_quantize(scheme, k), tier)
            vc = QuantizedKV(*kv_quantize(scheme, v), tier)
            elem = 1
        name = "decode_attention_bf16" if tier == "bf16" \
            else "decode_attention_quant"
        got = gqa_decode_attention(q, kc, vc, lens)
        want = decode_attention_plain(q, kc, vc, lens)
        torch.cuda.synchronize()
        gf, wf = got.to(torch.float32), want.to(torch.float32)
        err = float((gf - wf).abs().max())
        ok = bool(torch.allclose(gf, wf, rtol=ATTN_RTOL, atol=ATTN_ATOL))
        kv_bytes = 2 * valid * hk * (dh * elem + (4 if tier != "bf16" else 0))
        b_ms, by = bound_ms(kv_bytes + nbytes(q, got, lens),
                            4.0 * valid * h * dh)
        case = {"name": name, "kv": tier, "b": b, "h": h, "hk": hk, "dh": dh,
                "sk": sk, "kv_valid_len": lens.tolist(), "max_abs_err": err,
                "max_rel_err": err / float(wf.abs().max()),
                "max_abs_out": float(wf.abs().max()), "ok": ok,
                "ms": timer.ms(lambda: gqa_decode_attention(q, kc, vc, lens)),
                "plain_ms": timer.ms(lambda: decode_attention_plain(
                    q, kc, vc, lens)),
                "library_ms": timer.ms(library),
                "library": "scaled_dot_product_attention over the bf16 slab",
                "bound_ms": b_ms, "bound_by": by}
        cases.append(case)
        log(json.dumps(case))
        require(ok, f"{name} kv={tier}: max |err| {err}")
    return cases


def empty_row_cases(gen, dev, b=8, h=32, hk=8, dh=128, sk=512):
    """Decode attention with zero-length rows, as the reference computes
    it: every score masked alike, so equal weights over all Sk positions
    (the mean of V).  Kernel against plain version, bf16 and int8 slabs."""
    lens = torch.tensor([0, 1, 37, 512, 0, 300, 100, 64], dtype=torch.int32,
                        device=dev)[:b]
    q = torch.randn((b, 1, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    v = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    cases = []
    for tier in ("bf16", "int8"):
        if tier == "bf16":
            kc, vc = k.to(torch.bfloat16), v.to(torch.bfloat16)
            name = "decode_attention_bf16"
        else:
            scheme = get_kv_scheme(tier)
            kc = QuantizedKV(*kv_quantize(scheme, k), tier)
            vc = QuantizedKV(*kv_quantize(scheme, v), tier)
            name = "decode_attention_quant"
        got = gqa_decode_attention(q, kc, vc, lens).to(torch.float32)
        want = decode_attention_plain(q, kc, vc, lens).to(torch.float32)
        mean_v = cache_read(vc, torch.float32).to(torch.float32)[0].mean(0)
        row0 = got[0, 0].reshape(hk, h // hk, dh)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL))
        mean_ok = bool(torch.allclose(row0, mean_v[:, None].expand_as(row0),
                                      rtol=ATTN_RTOL, atol=ATTN_ATOL))
        case = {"name": name, "kv": tier, "empty_rows": True,
                "kv_valid_len": lens.tolist(), "max_abs_err": err,
                "ok": ok, "empty_row_is_mean_of_v": mean_ok}
        cases.append(case)
        log(json.dumps(case))
        require(ok, f"{name} kv={tier} with empty rows: max |err| {err}")
        require(mean_ok, f"{name} kv={tier}: an empty row is not the mean "
                         "of V over the slab")
    return cases


def vdsp_plans():
    """(pair, cap, plan, draw) of every K6 case: each paper pair under the
    capped plan, the beyond-paper pairs uncapped where their lanes fit the
    reference kernel's domain, and all magnitudes at their maximum."""
    plans = [(pair, 4, P.solve_lane_plan(*pair, max_parallelism=4), "random")
             for pair in P.PAPER_PARALLELISM]
    for pair in P.SOLVER_BEYOND_PAPER:
        plan = P.solve_lane_plan(*pair)
        if plan.stride <= REF_MAX_STRIDE:
            plans.append((pair, None, plan, "random"))
    plans.append((("bf16", "bf16"), 4,
                  P.solve_lane_plan("bf16", "bf16", max_parallelism=4), "max"))
    return plans


def vdsp_case(timer, gen, dev, pair, cap, plan, draw, dtype, fn, plain_fn):
    """One K6 case at T = 50,331,648 / P: kernel ``fn`` against
    ``plain_fn`` bit for bit, timed beside its bound, the plain version and
    the broadcast multiply ``(a[:, :, None] * b[:, None, :]).flatten(1)``,
    which computes the same lanes where magnitudes stay within the
    format's maximum (lane isolation; lanes are i-major)."""
    t = TABLE_VII_LANE_MACS // plan.parallelism
    n_a, n_b = len(plan.offsets_a), len(plan.offsets_b)
    if draw == "max":
        a = torch.full((t, n_a), (1 << plan.w_a) - 1, dtype=dtype, device=dev)
        b = torch.full((t, n_b), (1 << plan.w_b) - 1, dtype=dtype, device=dev)
    else:
        a = torch.randint(0, P.max_magnitude(plan.fmt_a) + 1, (t, n_a),
                          generator=gen, device=dev, dtype=dtype)
        b = torch.randint(0, P.max_magnitude(plan.fmt_b) + 1, (t, n_b),
                          generator=gen, device=dev, dtype=dtype)

    def library():
        return (a[:, :, None] * b[:, None, :]).flatten(1)

    got = fn(a, b, plan)
    want = plain_fn(a, b, plan)
    lib = library()
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    ok = bool(torch.equal(got, want))
    lib_ok = bool(torch.equal(lib, want))
    elem = torch.empty((), dtype=dtype).element_size()
    b_ms, by = bound_ms(t * (n_a + n_b + plan.parallelism) * elem,
                        t * (n_a + n_b + 1 + plan.parallelism), INT32_OPS)
    case = {"name": "virtual_dsp_multiply", "pair": "x".join(pair),
            "cap": cap, "draw": draw, "dtype": str(dtype).split(".")[-1],
            "t": t, "p": plan.parallelism, "stride": plan.stride,
            "max_abs_err": err, "ok": ok, "library_equal": lib_ok,
            "ms": timer.ms(lambda: fn(a, b, plan)),
            "plain_ms": timer.ms(lambda: plain_fn(a, b, plan)),
            "library_ms": timer.ms(library),
            "library": "(a[:, :, None] * b[:, None, :]).flatten(1)",
            "bound_ms": b_ms, "bound_by": by}
    log(json.dumps(case))
    require(ok, f"virtual_dsp_multiply {case['pair']} cap={cap} {draw} "
                f"{case['dtype']}: max |err| {err} (must be 0)")
    require(lib_ok, f"virtual_dsp_multiply {case['pair']} cap={cap} {draw}: "
                    "lanes differ from a_i * b_j")
    return case


def vdsp_cases(timer, gen, dev):
    """K6 in its int32 instantiation (``virtual_dsp_multiply``) for every
    case of ``vdsp_plans``, and its int64 one (``packed_multiply``) on a
    40-bit lane (fp32 x int16), which the int32 entry must refuse."""
    cases = []
    for pair, cap, plan, draw in vdsp_plans():
        cases.append(vdsp_case(
            timer, gen, dev, pair, cap, plan, draw, torch.int32,
            virtual_dsp_multiply,
            lambda a, b, p: virtual_dsp_plain(a, b, p).to(torch.int32)))
    plan = P.solve_lane_plan("fp32", "int16")
    try:
        check_reference_domain(plan)
        refused = False
    except ValueError:
        refused = True
    require(refused, "virtual_dsp_multiply accepted a 40-bit lane")
    cases.append(vdsp_case(
        timer, gen, dev, ("fp32", "int16"), None, plan, "random", torch.int64,
        lambda a, b, p: P.packed_multiply(p, a, b),
        lambda a, b, p: P.packed_multiply(p, a, b, plain=True)))
    return cases


# ---------------------------------------------------------------------------
# Phase 3: the MAC datapath through K6
# ---------------------------------------------------------------------------
def special_codes(fmt, bits):
    """How many NaN, inf and subnormal codes ``bits`` holds (floats)."""
    if not fmt.is_float:
        return {}
    _, e, m = fmt.fields(bits)
    return {"nan": int(fmt.is_nan(bits).sum()),
            "inf": int(fmt.is_inf(bits).sum()),
            "subnormal": int(((e == 0) & (m != 0)).sum())}


def datapath_combo(combo, gen, dev, rng):
    """``xtramac_packed`` at 50,331,648 lane MACs of one combination, held
    to the plain path, to per-lane MACs and to the exact oracle."""
    cfg = M.MacConfig.make(*combo)
    plan = P.solve_lane_plan(cfg.fmt_a, cfg.fmt_b, max_parallelism=4)
    t, lanes = TABLE_VII_LANE_MACS // plan.parallelism, plan.parallelism
    a, b, c = random_operands(cfg, plan, gen, dev, TABLE_VII_LANE_MACS)
    before = ops.launch_counts()["virtual_dsp_multiply"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = P.xtramac_packed(cfg, plan, a, b, c)
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - t0
    kernel_launches = ops.launch_counts()["virtual_dsp_multiply"] - before
    plain_ok = bool(torch.equal(got, P.xtramac_packed(cfg, plan, a, b, c,
                                                      plain=True)))
    lane_ok = bool(torch.equal(got, P.per_lane_reference(cfg, plan, a, b, c)))
    # the exact oracle on sampled (issue, lane) pairs
    rows = torch.as_tensor(rng.integers(0, t, ORACLE_SAMPLES), device=dev)
    cols = rng.integers(0, lanes, ORACLE_SAMPLES)
    a_h, b_h, c_h = (x[rows].cpu().numpy() for x in (a, b, c))
    sampled = got[rows, torch.as_tensor(cols, device=dev)].cpu().numpy()
    pos = plan.lane_positions
    want = [mac_exact(cfg.fmt_a, cfg.fmt_b, cfg.fmt_c, cfg.fmt_p,
                      a_h[k, pos[l][0]], b_h[k, pos[l][1]], c_h[k, l])
            for k, l in enumerate(cols)]
    oracle_bad = int((sampled != np.asarray(want, np.int64)).sum())
    specials = {"a": special_codes(cfg.fmt_a, a),
                "b": special_codes(cfg.fmt_b, b),
                "c": special_codes(cfg.fmt_c, c)}
    case = {"combo": cfg.name, "p": lanes, "t": t, "lane_macs": t * lanes,
            "packed_call_s": packed_s, "kernel_launches": kernel_launches,
            "equal_to_plain": plain_ok, "equal_to_per_lane": lane_ok,
            "oracle_samples": ORACLE_SAMPLES, "oracle_mismatches": oracle_bad,
            "special_codes": specials}
    log(json.dumps(case))
    require(tuple(got.shape) == (t, lanes) and bool(
        ((got >= 0) & (got < (1 << cfg.fmt_p.bits))).all()),
        f"datapath {cfg.name}: output {tuple(got.shape)} or codes outside "
        f"{cfg.fmt_p.name}")
    require(kernel_launches == 1, f"datapath {cfg.name}: {kernel_launches} "
                                  "K6 launches in one xtramac_packed call")
    require(plain_ok, f"datapath {cfg.name}: K6 path differs from the plain "
                      "path")
    require(lane_ok, f"datapath {cfg.name}: packed lanes differ from "
                     "per-lane MACs")
    require(oracle_bad == 0, f"datapath {cfg.name}: {oracle_bad} of "
                             f"{ORACLE_SAMPLES} samples differ from mac_exact")
    for port, fmt in (("a", cfg.fmt_a), ("b", cfg.fmt_b), ("c", cfg.fmt_c)):
        if fmt.is_float:
            need = ["subnormal"] + (["nan"] if fmt.special_rule != "none"
                                    else []) \
                + (["inf"] if fmt.special_rule == "ieee" else [])
            require(all(specials[port][k] > 0 for k in need),
                    f"datapath {cfg.name}: operand {port} lacks special "
                    f"codes {specials[port]}")
    return case


def pipeline_case(dev, rng):
    """``XtraMACPipeline`` (int4 x bf16 and bf16 x bf16, the reference's
    fig6_parallelism setup) over 64 issues that switch datatype every
    cycle: no result before cycle 4, then one per cycle (II 1), each equal
    to unpacked per-lane MACs."""
    cfgs = [M.MacConfig.make("int4", "bf16", "bf16", "bf16"),
            M.MacConfig.make("bf16", "bf16", "bf16", "bf16")]
    pipe = XtraMACPipeline(cfgs, device=dev)
    issues = []
    for i in range(PIPELINE_ISSUES):
        cfg, plan = cfgs[i % 2], pipe.plans[i % 2]
        issues.append(Op(i % 2,
                         rng.integers(0, 1 << cfg.fmt_a.bits,
                                      len(plan.offsets_a)),
                         rng.integers(0, 1 << cfg.fmt_b.bits,
                                      len(plan.offsets_b)),
                         rng.integers(0, 1 << cfg.fmt_c.bits,
                                      plan.parallelism)))
    t0 = time.perf_counter()
    outs = [pipe.step(op) for op in issues]
    outs += [pipe.step(None) for _ in range(pipe.latency)]
    wall = time.perf_counter() - t0
    first = next(i for i, o in enumerate(outs) if o is not None)
    results = outs[first:]
    ii_one = all(o is not None for o in results) \
        and len(results) == len(issues)
    bad = 0
    for op, got in zip(issues, results):
        cfg, plan = cfgs[op.dtype_sel], pipe.plans[op.dtype_sel]
        want = P.per_lane_reference(
            cfg, plan, *(torch.as_tensor(x, device=dev)[None]
                         for x in (op.a_bits, op.b_bits, op.c_bits)))[0]
        bad += int(not np.array_equal(got, want.cpu().numpy()))
    case = {"pipeline": [c.name for c in cfgs], "issues": len(issues),
            "latency": pipe.latency, "first_result_cycle": first,
            "ii_one": ii_one, "mismatches": bad, "wall_s": wall}
    log(json.dumps(case))
    require(pipe.latency == 4 and first == 4,
            f"pipeline: latency {pipe.latency}, first result at cycle {first}")
    require(ii_one, "pipeline: not one result per cycle")
    require(bad == 0, f"pipeline: {bad} issues differ from per-lane MACs")
    return case


def datapath_phase(gen, dev, seed=3):
    rng = np.random.default_rng(seed)
    combos = [datapath_combo(combo, gen, dev, rng)
              for combo in DATAPATH_COMBOS]
    torch.cuda.empty_cache()
    return {"combos": combos, "pipeline": pipeline_case(dev, rng)}


# ---------------------------------------------------------------------------
# Phase 4: the model through the kernels and through the plain versions
# ---------------------------------------------------------------------------
def model_phase(cfg, params, dev, chunk: int, rows=8, steps=4, seed=1,
                witness=None):
    """Teacher-forced through the kernels, then through the plain versions
    fed the kernel run's ids; held to ``logit_check`` (why that bound:
    ``launch/logit_spread.py`` and PERF.md).  ``witness`` names a
    ``logit_spread`` variant (plain math in the kernels' summation order,
    no kernel) whose spread from the plain run is recorded beside the
    kernels'; where the kernels miss the bound, ``witness_check`` decides."""
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab, (rows, chunk)),
                              device=dev)
    out = {}
    for tier in ("bf16", "int8"):
        got, ids = LS.teacher_forced(cfg, params, prompts, steps, kv=tier,
                                     plain=False)
        want, _ = LS.teacher_forced(cfg, params, prompts, steps, kv=tier,
                                    plain=True, feed=ids)
        out[tier] = res = LS.logit_check(got, want)
        if witness is not None:
            plain, replace = LS.RUNS[witness]
            with LS.plain_ops(replace):
                wit, _ = LS.teacher_forced(cfg, params, prompts, steps,
                                           kv=tier, plain=plain, feed=ids)
            res["witness"] = {"variant": witness, **LS.logit_check(wit, want)}
        log(json.dumps({"model_phase": cfg.name, "kv": tier, **res}))
        require(res["finite"], f"{cfg.name}: non-finite logits ({tier})")
        ok = res["logits_ok"]
        if not ok and witness is not None:
            ok = res["witness_rule_ok"] = LS.witness_check(res,
                                                           res["witness"])
        require(ok, f"{cfg.name}: model logits kernel vs plain ({tier}): "
                    f"max diff {res['max_abs_logit_diff']}")
        require(res["greedy_agree"],
                f"{cfg.name}: greedy tokens disagree ({tier})")
    return out


# ---------------------------------------------------------------------------
# Phase 5: serving through the engine and scheduler
# ---------------------------------------------------------------------------
def serve_requests(cfg, seed=2, n=6, new_tokens=32):
    rng = np.random.default_rng(seed)
    lens = rng.integers(96, 257, n)
    return [rng.integers(1, cfg.vocab, (int(p),)).astype(np.int32)
            for p in lens], new_tokens


def serve_tier(cfg, params, tier, prompts, new_tokens, chunk, dev):
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=512, n_slots=8, prefill_chunk=chunk, max_burst=8,
        policy=PrecisionPolicy(kv=tier), device=str(dev)))
    sched = Scheduler(engine)
    # staggered arrivals: two at once, then one every 4 scheduler steps, so
    # later requests are admitted while earlier ones decode
    pending = list(enumerate(prompts))
    reqs, mid_flight = [], 0
    sync(dev)
    t0 = time.perf_counter()
    while pending or sched.has_work:
        if pending and (not reqs or len(reqs) < 2
                        or sched.n_steps % 4 == 0):
            i, p = pending.pop(0)
            decoding = any(r.n_generated > 0 for r in reqs
                           if not r.is_finished)
            mid_flight += int(decoding)
            reqs.append(sched.submit(Request(
                prompt=p, sampling=SamplingParams(max_new_tokens=new_tokens))))
        sched.step()
    sync(dev)
    wall = time.perf_counter() - t0
    for r in reqs:
        require(r.is_finished and r.n_generated == new_tokens,
                f"request {r.id} finished with {r.n_generated} tokens")
        require(all(0 <= t < cfg.vocab for t in r.output_tokens),
                f"request {r.id} emitted an id outside the vocabulary")
    rep = sched.metrics.report()
    rep.update(kv=tier, admitted_mid_flight=mid_flight, host_wall_s=wall)
    return engine, reqs, rep


def serve_phase(cfg, params, chunk, dev):
    """Both KV tiers through the scheduler, the launch counters reset just
    before and read just after; then the path's own checks."""
    prompts, new_tokens = serve_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runs = [serve_tier(cfg, params, tier, prompts, new_tokens, chunk, dev)
            for tier in ("bf16", "int8")]
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plan = PrecisionPolicy().resolved_plan(cfg)
    n_w8a8 = sum(s == "w8a8" for s in plan.values())
    forwards = 0
    reports = []
    for engine, reqs, rep in runs:
        rep["peak_memory_bytes"] = peak
        log(json.dumps({"serve": rep, "arch": cfg.name}))
        require(rep["admitted_mid_flight"] > 0,
                f"{cfg.name} ({rep['kv']}): no mid-flight admission")
        forwards += rep["decode_token_steps"] + sum(
            -(-len(p) // chunk) for p in prompts)
        if n_w8a8:
            # W8A8 quantizes every row of a linear's call with one scale
            # (the reference's kernels/ops.py:327), so a request's tokens
            # depend on its batch-mates and a solo run may differ; the
            # same run repeated must give the same tokens
            _, again, _ = serve_tier(cfg, params, rep["kv"], prompts,
                                     new_tokens, chunk, dev)
            require([r.output_tokens for r in again]
                    == [r.output_tokens for r in reqs],
                    f"{cfg.name} ({rep['kv']}): a repeated serve run gave "
                    "other tokens")
        else:
            # greedy output must not depend on batch-mates or admission
            for r in reqs[-2:]:
                solo = engine.generate(r.prompt[None],
                                       max_new_tokens=new_tokens)
                require(list(solo["generated"][0]) == r.output_tokens,
                        f"request {r.id} ({rep['kv']}) differs from its "
                        "solo run")
        reports.append(rep)
    log(json.dumps({"serve_launches": launches, "arch": cfg.name}))
    check_path_launches(cfg.name, launches)
    # every W8A8 leaf call of every forward (prefill chunk or decode step)
    # went through the int8 kernel
    want = n_w8a8 * cfg.n_layers * forwards
    require(launches["w8a8_matmul"] == want,
            f"{cfg.name}: {launches['w8a8_matmul']} int8 kernel launches, "
            f"{want} W8A8 leaf calls")
    return reports, launches


def check_path_launches(path: str, launches) -> None:
    """Every kernel of ``path`` launched in its run, and no other."""
    for name in KERNELS:
        if name in PATH_KERNELS[path]:
            require(launches[name] > 0, f"{path}: {name} was not launched")
        else:
            require(launches[name] == 0,
                    f"{path}: {name} ran on a path it is not on")


# ---------------------------------------------------------------------------
def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log(smi)

    t0 = time.perf_counter()
    build.build()
    log(json.dumps({"build_s": time.perf_counter() - t0}))

    chunk = 64
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(dev)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    result["cases"] = cases = kernel_phase(timer, gen, dev, chunk)
    log(json.dumps({"kernel_phase_s": time.perf_counter() - t0}))
    del timer
    torch.cuda.empty_cache()

    # the MAC datapath: launch counts set to 0 just before, read just after
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    result["datapath"] = datapath_phase(gen, dev)
    launches_by_path = {"xtramac-datapath": ops.launch_counts()}
    result["datapath"].update(
        seconds=time.perf_counter() - t0,
        launches=launches_by_path["xtramac-datapath"],
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    log(json.dumps({"datapath_phase_s": result["datapath"]["seconds"],
                    "peak_memory_bytes":
                        result["datapath"]["peak_memory_bytes"],
                    "launches": launches_by_path["xtramac-datapath"]}))
    check_path_launches("xtramac-datapath",
                        launches_by_path["xtramac-datapath"])
    want = len(DATAPATH_COMBOS) + PIPELINE_ISSUES
    got = launches_by_path["xtramac-datapath"]["virtual_dsp_multiply"]
    require(got == want, f"datapath: {got} K6 launches, {want} xtramac_packed "
                         "calls and pipeline issues")
    for arch, witness in (("granite-8b", None),
                          ("minitron-8b", "plain_splitkv")):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        with torch.no_grad():
            params = T.build_params(cfg, QuantMaker(0, device=dev))
        torch.cuda.synchronize()
        log(json.dumps({"arch": arch,
                        "build_params_s": time.perf_counter() - t0,
                        "param_bytes": sum(nbytes(b)
                                           for b in params.buffers())}))
        t0 = time.perf_counter()
        model = model_phase(cfg, params, dev, chunk, witness=witness)
        serve, launches_by_path[arch] = serve_phase(cfg, params, chunk, dev)
        result[arch] = {"model": model, "serve": serve,
                        "launches": launches_by_path[arch],
                        "model_and_serve_s": time.perf_counter() - t0}
        log(json.dumps({"arch": arch, "model_and_serve_s":
                        result[arch]["model_and_serve_s"]}))
        del params                  # free the card for the next model
        torch.cuda.empty_cache()

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)

    # one summary entry per kernel: the worst error over its cases, times
    # at its path's own shape (decode M = 8 slots, prefill M = 64, the
    # widest linear; int8 KV for the quantized attention; K6 on int4 x bf16
    # at the Table VII size); launches over every path's run
    rep_case = {"packed_gemv": dict(scheme="awq_int4", m=8, k=4096, n=14336),
                "packed_matmul": dict(scheme="awq_int4", m=chunk, k=4096,
                                      n=14336),
                "w8a8_matmul": dict(m=8, k=4096, n=16384),
                "decode_attention_bf16": dict(kv="bf16", h=32, dh=128),
                "decode_attention_quant": dict(kv="int8", h=32, dh=128),
                "virtual_dsp_multiply": dict(pair="int4xbf16", cap=4,
                                             draw="random", dtype="int32")}
    summary = []
    for name, (source, replaces) in KERNELS.items():
        mine = [c for c in cases if c["name"] == name]
        rep = next(c for c in mine if "ms" in c and all(
            c.get(k) == v for k, v in rep_case[name].items()))
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[name] for n in launches_by_path.values()),
            "launches_by_path": {a: n[name]
                                 for a, n in launches_by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "case": {k: rep[k] for k in rep_case[name]}})
    log(json.dumps({"kernels": summary}))
    if FAILED_CHECKS:
        sys.exit(f"chip_smoke: {len(FAILED_CHECKS)} check(s) failed: "
                 + "; ".join(FAILED_CHECKS))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
