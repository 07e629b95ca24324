"""What holds the persistent grouped body (``grouped_gemv_kernel``) at its
time: the kernel as built beside two variants of it, each timed with the
L2 cache flushed by a 256 MB write (as ``chip_smoke.py`` and
``kernel_times.py`` flush it) and by a 256 MB read.

  PYTHONPATH=src python -m repro_torch.launch.grouped_ablation \
      [--cases prefill128,prefill512] [--lift-k1]

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
step mostly finds it.  Cases: ``kernel_times.py``'s grouped cases on
qwen3-moe's two expert leaves (``--cases`` picks some), each through the
wrapper that runs it on the persistent body: ``packed_gemv_grouped`` at M
<= 8; past it ``packed_matmul_grouped`` (in this tree the same body with
items of 16 / 32 rows) or, with ``--lift-k1`` on an older tree, grouped K1
with its M <= 8 cap lifted (items of 8 rows; ``kernel_times.py
--lift-k1``).  Each time is the median of 20 calls (CUDA events).  Prints
one JSON line per case and the card's name and power limit.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.packed_matmul import (packed_gemv_grouped,
                                               packed_matmul_grouped)
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
        ("for (int c = lane; c < CW + 1 + nsrc; c += 32) {",
         "for (int c = lane; c < 0; c += 32) {")],
}
# no_copy of an older source, whose producer lanes issued one copy each
LANE_COPIES_NO_COPY = [
    VARIANTS["no_copy"][0],
    ("if (lane < CW) {\n          tma_tile(",
     "if (lane < 0) {\n          tma_tile("),
    ("} else if (lane == CW) {", "} else if (lane < 0) {"),
    ("} else if (lane < CW + 1 + nsrc) {", "} else if (lane < 0) {")]


def variant_source(name: str, lift_k1: bool = False) -> str:
    """The path of variant ``name`` of the tree's packed_matmul.cu (with
    ``lift_k1``, grouped K1's M <= 8 check lifted)."""
    src = (build.CSRC / "packed_matmul.cu").read_text()
    if lift_k1:
        src = KT.lift_k1_cap(src)
    edits = VARIANTS[name]
    if name == "no_copy" and lift_k1:
        edits = LANE_COPIES_NO_COPY
    for old, new in edits:
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(c[0] for c in
                                                KT.GROUPED_CASES))
    ap.add_argument("--lift-k1", action="store_true",
                    help="run M > 8 through grouped K1 (an older tree "
                    "whose grouped K1 takes M <= 8 only)")
    args = ap.parse_args(argv)
    wanted = args.cases.split(",")
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
        for label, g, m in KT.GROUPED_CASES:    # every case's draws
            experts, rows = KT.grouped_layout(label, g, m, gen, dev)
            x = torch.randn((g, m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            if label not in wanted:
                continue
            kernel = (packed_gemv_grouped if m <= 8 or args.lift_k1
                      else packed_matmul_grouped)
            cases.append((label, kernel, x, experts, rows))
        for name in VARIANTS:
            KT.patched_library({}, variant_source(name, args.lift_k1))
            for label, kernel, x, experts, rows in cases:
                def fn():
                    kernel(x, leaf.packed, leaf.scales, leaf.scheme,
                           experts, rows)
                print(json.dumps({
                    "variant": name, "case": label, "k": k, "n": n,
                    "m": x.shape[1], "kernel": kernel.__name__,
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
