"""What holds grouped K1 (``packed_gemv_grouped``) at its time: the kernel
as built beside two variants of it, each timed with the L2 cache flushed
by a 256 MB write (as ``chip_smoke.py`` and ``kernel_times.py`` flush it)
and by a 256 MB read.

  PYTHONPATH=src python -m repro_torch.launch.grouped_ablation

Variants of ``csrc/packed_matmul.cu``, built apart into ``build/ablation/``
and loaded in place of the wrappers' library (``kernel_times.
patched_library``):

  built    the kernel as it is;
  no_math  the consumers skip every chunk's decode, mma and folds (the
           copies, the work list, the handshakes and the stores remain);
  no_copy  the producer issues no copy, only the stages' arrivals (the
           math runs on whatever the ring holds).

A write flush leaves the L2 full of dirty lines, which the timed call's
reads evict and write back; a read flush leaves it clean, as a serving
step mostly finds it.  Cases: ``kernel_times.py``'s grouped K1 cases (the
decode step's 64 pairs and a 64-token chunk's buffers of 5 on qwen3-moe's
two expert leaves).  Each time is the median of 20 calls (CUDA events).
Prints one JSON line per case and the card's name and power limit.  Needs
a CUDA card.
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.packed_matmul import packed_gemv_grouped
from repro_torch.launch import kernel_times as KT
from repro_torch.models.common import QuantMaker

# (old, new) text of each variant; every old text occurs once in the source
VARIANTS = {
    "built": [],
    "no_math": [
        ("if (chunk_k0 + CHUNK_K <= K) {", "if (false) {"),
        ("} else if (chunk_k0 < K) {", "} else if (false) {")],
    "no_copy": [
        ("mbar_expect_tx(&full[slot], F::WORD_BYTES + nsrc * xbytes +\n"
         "                                          scale_rows * COLS * 4);",
         "mbar_arrive(&full[slot]);"),
        ("if (lane < CW) {\n          tma_tile(",
         "if (lane < 0) {\n          tma_tile("),
        ("} else if (lane == CW) {", "} else if (lane < 0) {"),
        ("} else if (lane < CW + 1 + nsrc) {", "} else if (lane < 0) {")],
}


def variant_source(name: str) -> str:
    """The path of variant ``name`` of the tree's packed_matmul.cu."""
    src = (build.CSRC / "packed_matmul.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"grouped_ablation: {name}: {old!r} not found "
                             "once")
        src = src.replace(old, new)
    out = build.BUILD_DIR.parent / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"grouped_{name}.cu"
    path.write_text(src)
    return str(path)


def time_ms(fn, flush, read: bool, reps: int = 20, warmup: int = 3):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if read:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(4_000_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("grouped_ablation: no CUDA device")
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    mk = QuantMaker(5, device=dev)
    for k, n in KT.QWEN3_EXPERT_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(k)
        with torch.no_grad():
            leaf = mk.dense("moe.w_up", k, n, "awq_int4",
                            experts=KT.QWEN3_EXPERTS)
        cases = []
        for label, g, m, _ in KT.GROUPED_CASES[:2]:
            experts, rows = KT.grouped_layout(label, g, m, gen, dev)
            x = torch.randn((g, m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            cases.append((label, x, experts, rows))
        for name in VARIANTS:
            KT.patched_library({}, variant_source(name))
            for label, x, experts, rows in cases:
                def fn():
                    packed_gemv_grouped(x, leaf.packed, leaf.scales,
                                        leaf.scheme, experts, rows)
                print(json.dumps({
                    "variant": name, "case": label, "k": k, "n": n,
                    "experts": len(torch.unique(experts[rows > 0])),
                    "write_flush_ms": time_ms(fn, flush, read=False),
                    "read_flush_ms": time_ms(fn, flush, read=True)}),
                    flush=True)
        del leaf
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
