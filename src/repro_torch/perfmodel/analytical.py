"""Analytical decode-latency model (paper §VI-D, Figs. 1 / 14; copy of
``repro/perfmodel/analytical.py`` up to ``spec_round_latency``).

Transformer decode alternates memory phases (weight streaming from HBM)
and compute phases (MAC-array limited), with idealized streaming and
on-chip activation reuse:

    t_layer = max( weight_bytes / BW,  batch * MACs / (units * freq) )

The MAC-unit count is the resource budget over the per-operation LUT /
FF / DSP cost of the arithmetic unit: the vendor baseline instantiates the
AMD FP-operator profiles, XtraMAC its per-lane costs (Tables III-V).  With
``engine_model`` the compute phase runs instead on the channel-streaming
GEMV engine of ``core/gemv_engine.py`` at the scheme's lane count.

MAC counting per decode token (context L):
  projections / FFN (quantized):  N_proj_params   MACs  (scheme datatype)
  attention QK^T + PV (BF16):     2 * L * H * dh * n_layers

Every number this module returns is in the paper's FPGA model (V80 by
default), not a measurement of the card the port runs on.  The serving
policy (``serve/slo.py``) prices its decisions in these seconds, a
speculative round too (``spec_round_latency``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

from repro_torch.configs import ModelConfig
from repro_torch.core.gemv_engine import GemvEngineConfig
from repro_torch.core.resource_model import (TABLE_III, TABLE_IV, TABLE_V,
                                             Resources)
from repro_torch.launch.roofline import model_params

from .hardware import V80, FPGAProfile

# Every deployment executes both the scheme's quantized MACs (projections,
# FFN) and bf16 MACs (attention).  The vendor baseline replicates both
# datapaths per slot (Fig. 2b); XtraMAC shares one runtime-switching
# instance (Table III) whose lanes serve both phases.
#
# scheme -> (vendor per-slot = quant IP + bf16 IP, (quant lanes, bf16
#            lanes) per vendor slot, xtramac switching instance, (quant
#            lanes, bf16 lanes) per instance)
_VENDOR_BF16 = TABLE_V["vendor"]["bf16"]

_DEPLOY = {
    "awq_int4": (TABLE_IV[("int8", "bf16")][0], (1, 1),
                 TABLE_III["I:int4xbf16+bf16"], (2, 2)),
    "w8a8": (TABLE_V["vendor"]["int8"].scale(2) + _VENDOR_BF16, (2, 1),
             TABLE_III["II:int8xint8+int32|bf16"], (2, 2)),
    "fp8": (TABLE_IV[("fp8_e4m3", "bf16")][0], (1, 1),
            TABLE_III["III:fp8xfp8+bf16|bf16"], (4, 2)),
    "mxfp4": (TABLE_IV[("fp4_e2m1", "bf16")][0], (1, 1),
              TABLE_III["IV:fp4xbf16+bf16|bf16"], (2, 2)),
}

_SCHEME_WEIGHT_BITS = {"awq_int4": 4, "mxfp4": 4, "fp8": 8, "w8a8": 8,
                       "bf16": 16}


def gemv_engine_for(scheme: str, fpga: FPGAProfile = V80) -> GemvEngineConfig:
    """The channel-streaming GEMV engine (paper §VI-C) for ``scheme`` on
    ``fpga``: lanes ``N_MAC = channel_bits / (w_bits * P)`` at the
    scheme's weight bits, the profile's HBM bandwidth and power, the
    U55c's channel geometry."""
    return GemvEngineConfig(
        hbm_bw_gbps=fpga.hbm_gbps, power_w=fpga.power_w,
        weight_bits=min(_SCHEME_WEIGHT_BITS[scheme], 16))


@functools.lru_cache(maxsize=64)
def _param_split(cfg: ModelConfig) -> Dict[str, float]:
    """Active parameters by role: {'proj': projections and FFN (and
    norms), 'emb': embedding + lm_head}.  Memoized per config."""
    p = model_params(cfg)
    # embedding + lm_head stream once per token too, in bf16
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return {"proj": p["active"] - emb, "emb": float(emb)}


def mac_distribution(cfg: ModelConfig, scheme: str, context: int
                     ) -> Dict[str, float]:
    """Fig. 1: fraction of decode MACs per datatype combination."""
    split = _param_split(cfg)
    proj_macs = split["proj"]                # embeddings: lookup, no MAC
    lm_head_macs = cfg.vocab * cfg.d_model
    attn_macs = 2.0 * context * cfg.n_heads * cfg.head_dim * cfg.n_layers
    total = proj_macs + lm_head_macs + attn_macs
    combos = {"awq_int4": "INT4xBF16", "mxfp4": "FP4xBF16",
              "fp8": "FP8xFP8", "w8a8": "INT8xINT8", "bf16": "BF16xBF16"}
    dist = {combos[scheme]: proj_macs / total}
    dist["BF16xBF16"] = dist.get("BF16xBF16", 0.0) + \
        (attn_macs + lm_head_macs) / total
    return dist


def mac_unit_budget(per_op: Resources, fpga: FPGAProfile) -> int:
    """How many MAC lanes the fabric budget supports."""
    lut_lim = fpga.usable_fraction * fpga.luts / max(per_op.lut, 1e-9)
    ff_lim = fpga.usable_fraction * fpga.ffs / max(per_op.ff, 1e-9)
    dsp_lim = fpga.usable_fraction * fpga.dsps / max(per_op.dsp, 1e-9)
    return int(min(lut_lim, ff_lim, dsp_lim))


def decode_latency(cfg: ModelConfig, scheme: str, *, batch: int, context: int,
                   design: str, fpga: FPGAProfile = V80,
                   kv_bytes_per_token: Optional[float] = None,
                   engine_model: Optional[GemvEngineConfig] = None
                   ) -> Dict[str, float]:
    """One decode step under the two-phase streaming model.

    ``kv_bytes_per_token`` overrides the default bf16 KV cost (K and V, 2 B
    x Hk x dh x L per cached position): a quantized KV tier streams fewer
    bytes per position.  ``engine_model`` routes the compute phase through
    the GEMV engine (quantized projections at its lane count for the
    scheme's weight bits, attention at the bf16 lane count) and derates
    the memory phase by the engine's HBM utilization; without it the
    fabric unit budget of ``design`` ('xtramac' or 'vendor') prices it."""
    split = _param_split(cfg)
    w_bits = _SCHEME_WEIGHT_BITS[scheme]
    weight_bytes = split["proj"] * w_bits / 8.0 + split["emb"] * 2.0
    if kv_bytes_per_token is None:
        kv_bytes_per_token = \
            2.0 * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers
    kv_bytes = context * float(kv_bytes_per_token)
    bw = fpga.hbm_gbps * 1e9
    if engine_model is not None:
        bw *= engine_model.hbm_utilization
    t_mem = (weight_bytes + batch * kv_bytes) / bw

    proj_macs = split["proj"] + cfg.vocab * cfg.d_model
    attn_macs = 2.0 * context * cfg.n_heads * cfg.head_dim * cfg.n_layers
    if engine_model is not None:
        eng_q = dataclasses.replace(engine_model,
                                    weight_bits=min(w_bits, 16))
        eng_b = dataclasses.replace(engine_model, weight_bits=16)
        units_q, units_b = eng_q.macs_per_cycle, eng_b.macs_per_cycle
        t_compute = batch * (
            proj_macs / (units_q * eng_q.freq_hz)
            + attn_macs / (units_b * eng_b.freq_hz))
    else:
        vendor_slot, (vq, vb), xtra_inst, (xq, xb) = _DEPLOY[scheme]
        if design == "vendor":
            slots = mac_unit_budget(vendor_slot, fpga)
            units_q, units_b = slots * vq, slots * vb
        else:
            slots = mac_unit_budget(xtra_inst, fpga)
            units_q, units_b = slots * xq, slots * xb
        freq = fpga.freq_mhz * 1e6
        t_compute = batch * (proj_macs / (units_q * freq)
                             + attn_macs / (units_b * freq))
    return {"t_mem_s": t_mem, "t_compute_s": t_compute,
            "t_total_s": max(t_mem, t_compute),
            "bound": "memory" if t_mem >= t_compute else "compute",
            "units_quant": units_q, "units_bf16": units_b}


def spec_round_latency(cfg: ModelConfig, *, k: int, batch: int, context: int,
                       design: str = "xtramac",
                       draft_scheme: str = "awq_int4",
                       target_scheme: str = "w8a8",
                       acceptance: float = 0.7,
                       kv_bytes_per_token: Optional[float] = None,
                       draft_kv_bytes_per_token: Optional[float] = None,
                       fpga: FPGAProfile = V80,
                       use_engine_model: bool = True) -> Dict[str, float]:
    """One speculative decode round in the paper's FPGA model: K draft
    steps at the draft scheme and KV tier plus one (K+1)-position verify
    at the target's.  Every time it returns is in model-seconds of
    ``fpga`` (the V80 by default), not of the card the port runs on.

    The verify streams the target weights and KV once (its memory phase
    is a plain step's) while its compute phase covers K+1 positions a
    row, so the window costs about one plain step where the MAC array
    has compute headroom and K+1 steps on the channel-streaming GEMV
    engine, whose lanes match HBM.  This prices a single-weight-stream
    verify; the serving engine runs the window as K+1 chained decode
    steps in one dispatch (``serve/engine.py`` ``verify_slots``).

    ``acceptance`` a is the per-position acceptance rate: a row emits
    E = (1 - a^(K+1)) / (1 - a) tokens a round in expectation.  Returns
    the round's time, the per-token time t_round / E, a plain step's
    per-token time at the target precision and their ratio (> 1:
    speculation wins)."""
    assert k >= 1 and 0.0 <= acceptance < 1.0
    eng_d = gemv_engine_for(draft_scheme, fpga) if use_engine_model else None
    eng_t = gemv_engine_for(target_scheme, fpga) if use_engine_model else None
    draft = decode_latency(
        cfg, draft_scheme, batch=batch, context=context, design=design,
        fpga=fpga, kv_bytes_per_token=draft_kv_bytes_per_token,
        engine_model=eng_d)
    target = decode_latency(
        cfg, target_scheme, batch=batch, context=context, design=design,
        fpga=fpga, kv_bytes_per_token=kv_bytes_per_token,
        engine_model=eng_t)
    t_draft = k * draft["t_total_s"]
    t_verify = max(target["t_mem_s"], (k + 1) * target["t_compute_s"])
    t_round = t_draft + t_verify
    a = acceptance
    e_tokens = (1.0 - a ** (k + 1)) / (1.0 - a) if a > 0 else 1.0
    t_plain = target["t_total_s"]
    return {
        "t_draft_s": t_draft, "t_verify_s": t_verify,
        "t_round_s": t_round,
        "expected_tokens_per_row": e_tokens,
        "t_per_token_s": t_round / e_tokens,
        "t_plain_per_token_s": t_plain,
        "speedup": t_plain / (t_round / e_tokens),
        "verify_bound": "memory"
        if target["t_mem_s"] >= (k + 1) * target["t_compute_s"]
        else "compute",
    }
