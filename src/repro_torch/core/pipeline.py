"""Cycle-level emulator of the XtraMAC four-stage pipeline (Section IV);
torch twin of ``repro/core/pipeline.py``.

Models the architecture of Fig. 5:
  * N datatype configurations chosen at synthesis time; all mapping /
    reconstruction submodules instantiated statically.
  * A datatype-select signal registered at entry and carried through
    matched delay slices (it is consumed at Stage 1 AND Stage 4).
  * Operand C delayed to meet the Stage-2 products at Stage 3.
  * Fixed logical depth of 4 stages; per-stage extra registers can be
    configured at "synthesis" time (`stage_cycles`), trading latency for
    fmax while the initiation interval stays 1.

The emulator issues ONE operation per cycle (II = 1) and returns the result
exactly ``latency`` cycles later, independent of per-cycle datatype
switching — the paper's headline pipeline property.  Each issue's operands
go to ``device``; Stage 2 is ``packed_multiply``, so on a CUDA device every
issue is one launch of the virtual-DSP kernel with one row.  Stage 4 hands
the results to the host as Python ints (one device sync per issue), and
each result is an int64 numpy array, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import mac as M
from .formats import as_int64
from .packing import LanePlan, packed_multiply, solve_lane_plan


@dataclasses.dataclass
class Op:
    """One pipeline issue: per-lane raw bit patterns + the datatype select."""
    dtype_sel: int
    a_bits: np.ndarray  # [n_a]
    b_bits: np.ndarray  # [n_b]
    c_bits: np.ndarray  # [P]


class XtraMACPipeline:
    """Four-stage pipelined XtraMAC instance supporting N datatypes."""

    def __init__(self, configs: Sequence[M.MacConfig],
                 stage_cycles: Tuple[int, int, int, int] = (1, 1, 1, 1),
                 max_parallelism: int = 4, device="cuda"):
        assert len(stage_cycles) == 4 and all(c >= 1 for c in stage_cycles)
        self.configs = list(configs)
        self.stage_cycles = stage_cycles
        self.device = torch.device(device)
        self.plans: List[LanePlan] = [
            solve_lane_plan(c.fmt_a, c.fmt_b, max_parallelism=max_parallelism)
            for c in self.configs
        ]
        # P of the instance = max parallelism across supported datatypes (IV-A)
        self.parallelism = max(p.parallelism for p in self.plans)
        self.latency = sum(stage_cycles)
        # matched delay slices: one register queue per stage boundary
        self._queue: List[Optional[np.ndarray]] = [None] * self.latency
        self.cycle = 0

    # -- combinational stage functions (evaluated when the op ENTERS a stage) --
    def _stage1_map(self, op: Op):
        cfg = self.configs[op.dtype_sel]
        da = M.map_operand(cfg.fmt_a, as_int64(op.a_bits, self.device))
        db = M.map_operand(cfg.fmt_b, as_int64(op.b_bits, self.device))
        return (op.dtype_sel, da, db, as_int64(op.c_bits, self.device))

    def _stage2_multiply_post(self, state):
        sel, da, db, c_bits = state
        plan = self.plans[sel]
        prods = packed_multiply(plan, da.mag, db.mag)  # single DSP multiply
        lanes = []
        for lane, (i, j, _) in enumerate(plan.lane_positions):
            sign, exp, nan, inf = M.product_flags(
                M.Decoded(*(f[i] for f in da)), M.Decoded(*(f[j] for f in db)))
            lanes.append(M.Product(sign, prods[lane], exp, nan, inf))
        return (sel, lanes, c_bits)

    def _stage3_accumulate(self, state):
        sel, lanes, c_bits = state
        cfg = self.configs[sel]
        dc = M.map_operand(cfg.fmt_c, c_bits)
        outs = []
        for lane, prod in enumerate(lanes):
            dcl = M.Decoded(*(f[lane] for f in dc))
            if cfg.is_int_accumulate:
                outs.append(("int", M.accumulate_int(cfg.fmt_p, prod, dcl)))
            else:
                outs.append(("fp", M.accumulate_float(cfg.fmt_p, prod, dcl)))
        return (sel, outs)

    def _stage4_select(self, state):
        sel, outs = state
        cfg = self.configs[sel]
        final = []
        for kind, value in outs:
            if kind == "int":
                final.append(int(value))
            else:
                final.append(int(M.select_output(cfg.fmt_p, *value)))
        return np.array(final, dtype=np.int64)

    # -- temporal sequencing ------------------------------------------------
    def step(self, op: Optional[Op]) -> Optional[np.ndarray]:
        """Advance one clock cycle. Issues ``op`` (or a bubble if None) and
        returns the result of the op issued ``latency`` cycles ago."""
        # Evaluate the whole datapath when the op enters (combinational blocks
        # are pure functions of the registered operands; matched delays mean
        # the 4-stage sequencing only changes WHEN results appear, not WHAT
        # they are).  The queue models the register slices.
        result = self._queue.pop(0)
        if op is not None:
            s1 = self._stage1_map(op)
            s2 = self._stage2_multiply_post(s1)
            s3 = self._stage3_accumulate(s2)
            out = self._stage4_select(s3)
        else:
            out = None
        self._queue.append(out)
        self.cycle += 1
        return result

    def run(self, ops: Sequence[Op]) -> List[np.ndarray]:
        """Issue one op per cycle (II=1); drain; return results in order."""
        results = []
        for op in ops:
            r = self.step(op)
            if r is not None:
                results.append(r)
        for _ in range(self.latency):
            r = self.step(None)
            if r is not None:
                results.append(r)
        assert len(results) == len(ops)
        return results
