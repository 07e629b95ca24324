"""Where a packed XtraMAC datapath call's time goes on the card: wall time
vs device time.

  PYTHONPATH=src python -m repro_torch.launch.profile_datapath

For each datatype combination of the datapath workload (the six Fig. 6
combinations of the reference's packing and MAC tests), one
``core.packing.xtramac_packed`` call at the paper's Table VII GEMV size
(1 x 4096 x 12288 = 50,331,648 lane MACs, T = 50,331,648 / P issues) on
seeded random bit patterns: host wall ms per call (ending in a device
sync), and from one ``torch.profiler`` pass the device-busy ms, the idle
share, every kernel ranked by device time and the virtual-DSP kernel K6's
share of it (``k6_ms``).  Prints one JSON object.  ``chip_smoke.py`` runs
the same workload in its datapath phase.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import mac as M
from repro_torch.core import packing as P
from repro_torch.launch.profile_step import measure
from repro_torch.serve.engine import resolve_device

# the paper's Table VII GEMV (1, 4096, 12288): lane MACs per combination
TABLE_VII_LANE_MACS = 1 * 4096 * 12288
DATAPATH_COMBOS = [("int4", "bf16", "bf16", "bf16"),
                   ("fp8_e4m3", "fp8_e4m3", "bf16", "bf16"),
                   ("bf16", "bf16", "bf16", "bf16"),
                   ("int8", "int8", "int32", "int32"),
                   ("fp4_e2m1", "bf16", "bf16", "bf16"),
                   ("fp8_e4m3", "fp16", "fp16", "fp16")]


def random_operands(cfg, plan, gen, dev, lane_macs=TABLE_VII_LANE_MACS):
    """Uniform random bit patterns (specials and subnormals included) for
    ``lane_macs`` lane MACs: a [T, n_a], b [T, n_b], c [T, P] int64."""
    t = lane_macs // plan.parallelism
    return (torch.randint(0, 1 << cfg.fmt_a.bits, (t, len(plan.offsets_a)),
                          generator=gen, device=dev),
            torch.randint(0, 1 << cfg.fmt_b.bits, (t, len(plan.offsets_b)),
                          generator=gen, device=dev),
            torch.randint(0, 1 << min(cfg.fmt_c.bits, 32),
                          (t, plan.parallelism), generator=gen, device=dev))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"device": torch.cuda.get_device_name(dev),
           "lane_macs": TABLE_VII_LANE_MACS, "combos": []}
    for combo in DATAPATH_COMBOS:
        cfg = M.MacConfig.make(*combo)
        plan = P.solve_lane_plan(cfg.fmt_a, cfg.fmt_b, max_parallelism=4)
        a, b, c = random_operands(cfg, plan, gen, dev)

        def call():
            P.xtramac_packed(cfg, plan, a, b, c)

        call()             # warm-up: kernel build and first launches
        res = measure(call, args.steps, dev, top=None)
        res["k6_ms"] = sum(k["ms"] for k in res["kernels"]
                           if "vdsp_kernel" in k["name"])
        out["combos"].append({"combo": cfg.name, "p": plan.parallelism,
                              **res})
        del a, b, c
    print(json.dumps(out))


if __name__ == "__main__":
    main()
