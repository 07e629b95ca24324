"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases (a failed check is reported at once and makes the run exit
non-zero after the last phase; exceptions are not caught):
  0. the card's name and power limit, torch and CUDA versions;
  1. build every CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  2. every kernel against its plain torch version at the serving path's
     full-width shapes, timed with CUDA events (L2 flushed before each
     launch) beside its bound, its plain version and one library call;
  3. granite-8b at full width (36 layers, random weights from a seed): one
     prefill chunk and 4 decode steps through the kernels and through the
     plain versions, bf16 and int8 KV;
  4. serving: ServingEngine + Scheduler at full width (8 slots, max_len
     512, prefill chunk 64, bursts of up to 8) serve 6 seeded requests
     with staggered arrivals, once with bf16 KV and once with int8 KV; the
     kernels' launch counters are reset just before and read just after;
     the served tokens are checked against each request served alone.
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
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, gqa_decode_attention)
from repro_torch.kernels.packed_matmul import (  # noqa: E402
    packed_gemv, packed_matmul, packed_matmul_plain)
from repro_torch.launch import logit_spread as LS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import QuantMaker  # noqa: E402
from repro_torch.quant.kv_cache import QuantizedKV  # noqa: E402
from repro_torch.quant.policy import PrecisionPolicy  # noqa: E402
from repro_torch.quant.schemes import (  # noqa: E402
    dequantize, get_kv_scheme, get_scheme, kv_quantize, quantize_weights)
from repro_torch.serve import (Request, SamplingParams, Scheduler,  # noqa: E402
                               ServeConfig, ServingEngine)

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

KERNELS = {
    "packed_gemv": ("src/repro_torch/csrc/packed_matmul.cu",
                    "src/repro/kernels/packed_matmul.py:84"),
    "packed_matmul": ("src/repro_torch/csrc/packed_matmul.cu",
                      "src/repro/kernels/packed_matmul.py:84"),
    "decode_attention_bf16": ("src/repro_torch/csrc/decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:137"),
    "decode_attention_quant": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:144"),
}
LINEAR_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
SCHEMES = ["awq_int4", "mxfp4", "fp8"]
# matmul tolerance of the reference's kernel tests; decode attention to one
# bf16 ulp (outputs are rounded to bf16; the sums differ only in order);
# model logits: LS.logit_check
MM_RTOL, MM_ATOL = 2e-3, 1e-3
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
    """Mean device time of one call, from CUDA events around each call,
    with the L2 cache flushed (a 256 MB write) before every call: the
    serving loop reads each weight and KV byte cold.  A ~2 ms device spin
    before the start event keeps the stream busy while the host runs the
    wrapper, so the events time the device work and not the host's."""

    SPIN_CYCLES = 4_000_000

    def __init__(self, device):
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device=device)
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e1 = torch.cuda.Event(enable_timing=True)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.e0.record()
            fn()
            self.e1.record()
            self.e1.synchronize()
            total += self.e0.elapsed_time(self.e1)
        return total / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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


def kernel_phase(timer: Timer, gen, dev, chunk: int):
    cases = []
    for kind, ms_list in (("packed_gemv", (1, 8)), ("packed_matmul", (chunk,))):
        fn = packed_gemv if kind == "packed_gemv" else packed_matmul
        for scheme_name in SCHEMES:
            for k, n in LINEAR_SHAPES:
                scheme, packed, scales = make_packed_weights(
                    scheme_name, k, n, gen, dev)
                w_bf16 = dequantize(scheme, packed, scales, (k, n)).to(
                    torch.bfloat16)
                for m in ms_list:
                    x = torch.randn((m, k), generator=gen,
                                    device=dev).to(torch.bfloat16)
                    got = fn(x, packed, scales, scheme)
                    want = packed_matmul_plain(x, packed, scales, scheme)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    ok = bool(torch.allclose(got, want, rtol=MM_RTOL,
                                             atol=MM_ATOL))
                    b, by = bound_ms(nbytes(x, packed, scales, got),
                                     2.0 * m * k * n)
                    case = {
                        "name": kind, "scheme": scheme_name, "m": m, "k": k,
                        "n": n, "max_abs_err": err,
                        "max_rel_err": err / float(want.abs().max()),
                        "max_abs_out": float(want.abs().max()), "ok": ok,
                        "ms": timer.ms(lambda: fn(x, packed, scales, scheme)),
                        "plain_ms": timer.ms(lambda: packed_matmul_plain(
                            x, packed, scales, scheme)),
                        "library_ms": timer.ms(lambda: x @ w_bf16),
                        "library": "torch.matmul(x bf16, dequantized W bf16)",
                        "bound_ms": b, "bound_by": by}
                    cases.append(case)
                    log(json.dumps(case))
                    require(ok, f"{kind} {scheme_name} M={m} K={k} N={n}: "
                                f"max |err| {err}")
                del packed, scales, w_bf16
    cases += attention_cases(timer, gen, dev)
    return cases


def attention_cases(timer: Timer, gen, dev, b=8, h=32, hk=8, dh=128, sk=1024):
    lens = torch.tensor([1024, 1, 37, 512, 1000, 300, 768, 64],
                        dtype=torch.int32, device=dev)[:b]
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


# ---------------------------------------------------------------------------
# Phase 3: the model through the kernels and through the plain versions
# ---------------------------------------------------------------------------
def model_phase(cfg, params, dev, chunk: int, rows=8, steps=4, seed=1):
    """Teacher-forced through the kernels, then through the plain versions
    fed the kernel run's ids; held to ``logit_check`` (why that bound:
    ``launch/logit_spread.py`` and PERF.md)."""
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
        log(json.dumps({"model_phase": tier, **res}))
        require(res["finite"], f"non-finite logits ({tier})")
        require(res["logits_ok"], f"model logits kernel vs plain ({tier}): "
                                  f"max diff {res['max_abs_logit_diff']}")
        require(res["greedy_agree"], f"greedy tokens disagree ({tier})")
    return out


# ---------------------------------------------------------------------------
# Phase 4: serving through the engine and scheduler
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
    prompts, new_tokens = serve_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runs = [serve_tier(cfg, params, tier, prompts, new_tokens, chunk, dev)
            for tier in ("bf16", "int8")]
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    reports = []
    for engine, reqs, rep in runs:
        rep["peak_memory_bytes"] = peak
        log(json.dumps({"serve": rep}))
        require(rep["admitted_mid_flight"] > 0, "no mid-flight admission")
        # greedy output must not depend on batch-mates or admission time
        for r in reqs[-2:]:
            solo = engine.generate(r.prompt[None], max_new_tokens=new_tokens)
            require(list(solo["generated"][0]) == r.output_tokens,
                    f"request {r.id} ({rep['kv']}) differs from its solo run")
        reports.append(rep)
    log(json.dumps({"serve_launches": launches}))
    for name in KERNELS:
        require(launches[name] > 0, f"{name} was not launched while serving")
    return reports, launches


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

    cfg = get_config("granite-8b")
    chunk = 64
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(dev)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    result["cases"] = cases = kernel_phase(timer, gen, dev, chunk)

    t0 = time.perf_counter()
    with torch.no_grad():
        params = T.build_params(cfg, QuantMaker(0, device=dev))
    torch.cuda.synchronize()
    log(json.dumps({"build_params_s": time.perf_counter() - t0,
                    "param_bytes": sum(nbytes(b) for b in params.buffers())}))
    result["model"] = model_phase(cfg, params, dev, chunk)
    result["serve"], launches = serve_phase(cfg, params, chunk, dev)
    result["launches"] = launches

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)

    # one summary entry per kernel: the worst error over its cases, times
    # at the serving path's own shape (decode M = 8 slots, prefill M = 64,
    # the widest linear; int8 KV for the quantized attention)
    rep_case = {"packed_gemv": dict(scheme="awq_int4", m=8, k=4096, n=14336),
                "packed_matmul": dict(scheme="awq_int4", m=chunk, k=4096,
                                      n=14336),
                "decode_attention_bf16": dict(kv="bf16"),
                "decode_attention_quant": dict(kv="int8")}
    summary = []
    for name, (source, replaces) in KERNELS.items():
        mine = [c for c in cases if c["name"] == name]
        rep = next(c for c in mine if all(c.get(k) == v for k, v in
                                          rep_case[name].items()))
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
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
