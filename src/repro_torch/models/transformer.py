"""The dense transformer family: parameters, forward, KV cache (torch twin
of the dense path of ``repro/models/transformer.py``).

``forward`` runs the reference's serving modes as a loop over layers:
  * ``prefill_chunk`` — S new positions written at an int ``cache_index``;
    attention over the cache (earlier chunks are already there); logits for
    every chunk position;
  * ``decode`` — one token per row, a [B] ``cache_index`` (every pool slot
    at its own length), attention through the fused decode kernel.

The cache is ``(k, v)``: stacked per-layer slabs [L, B, Smax, Hk, Dh] (bf16
or ``QuantizedKV``), written in place.  ``plain=True`` runs every kernel's
plain version instead (the on-card reference for the kernels).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.quant.kv_cache import kv_slab

from . import attention as A
from .common import QuantMaker, activate, apply_linear, rms_norm

MODES = ("prefill_chunk", "decode")


def attn_cfg(cfg: ModelConfig) -> A.AttnConfig:
    return A.AttnConfig(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
                        use_rope=cfg.use_rope, kv_chunk=cfg.kv_chunk)


def check_supported(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.norm != "rms" or cfg.tie_embeddings
            or not cfg.gated_ffn or cfg.activation != "silu"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense family with RMS norm, a "
            "gated SiLU FFN and an untied lm_head so far")


class Block(nn.Module):
    """One transformer block: RMS norm, GQA attention, RMS norm, FFN."""

    def __init__(self, ln1, attn: dict, ln2, ffn: dict):
        super().__init__()
        self.register_buffer("ln1", ln1)
        self.attn = nn.ModuleDict(attn)
        self.register_buffer("ln2", ln2)
        self.ffn = nn.ModuleDict(ffn)


class DenseLM(nn.Module):
    """Parameters of a dense model: embedding, blocks, final norm, head."""

    def __init__(self, embed, layers, ln_f, lm_head: nn.Module):
        super().__init__()
        self.register_buffer("embed", embed)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("ln_f", ln_f)
        self.lm_head = lm_head


def build_params(cfg: ModelConfig, mk: QuantMaker) -> DenseLM:
    """Walk the dense family's leaves (same logical names as the reference's
    Maker walk) with ``mk``, one layer at a time."""
    check_supported(cfg)
    d, h, hk, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    sp, sf = cfg.scheme_proj, cfg.scheme_ffn
    embed = mk.table("embed", cfg.vocab, d)
    layers = []
    for _ in range(cfg.n_layers):
        attn = {"wq": mk.dense("attn.wq", d, h * dh, sp),
                "wk": mk.dense("attn.wk", d, hk * dh, sp),
                "wv": mk.dense("attn.wv", d, hk * dh, sp),
                "wo": mk.dense("attn.wo", h * dh, d, sp)}
        ffn = {"w_gate": mk.dense("ffn.w_gate", d, f, sf),
               "w_up": mk.dense("ffn.w_up", d, f, sf),
               "w_down": mk.dense("ffn.w_down", f, d, sf)}
        layers.append(Block(mk.norm("ln1", d), attn, mk.norm("ln2", d), ffn))
    ln_f = mk.norm("ln_f", d)
    lm_head = mk.dense("lm_head", d, cfg.vocab, None)
    return DenseLM(embed, layers, ln_f, lm_head)


def _ffn(cfg: ModelConfig, p: nn.ModuleDict, x, plain: bool):
    g = apply_linear(p["w_gate"], x, plain=plain)
    u = apply_linear(p["w_up"], x, plain=plain)
    h = (activate(cfg.activation, g.to(torch.float32))
         * u.to(torch.float32)).to(torch.bfloat16)
    return apply_linear(p["w_down"], h, plain=plain)


def _logits(params: DenseLM, x, plain: bool):
    x = rms_norm(x, params.ln_f)
    return apply_linear(params.lm_head, x, out_dtype=torch.float32,
                        plain=plain)


def forward(cfg: ModelConfig, params: DenseLM, tokens: torch.Tensor, *,
            cache: Tuple, cache_index, mode: str, need_logits: bool = True,
            plain: bool = False,
            layer_out: Optional[list] = None) -> Optional[torch.Tensor]:
    """tokens [B, S] -> logits [B, S, V] f32 (None when ``need_logits`` is
    False: the lm-head is skipped).  ``cache`` is updated in place.  A
    ``layer_out`` list gets the residual stream [B, S, D] after every layer
    appended (a diagnostic: ``launch/logit_spread.py``)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; the port runs {MODES}")
    acfg = attn_cfg(cfg)
    x = params.embed[tokens].to(torch.bfloat16)
    k_all, v_all = cache
    for l, blk in enumerate(params.layers):
        h = rms_norm(x, blk.ln1)
        x = x + A.gqa_forward(blk.attn, acfg, h, cache=(k_all[l], v_all[l]),
                              cache_index=cache_index, plain=plain)
        x = x + _ffn(cfg, blk.ffn, rms_norm(x, blk.ln2), plain)
        if layer_out is not None:
            layer_out.append(x)
    return _logits(params, x, plain) if need_logits else None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               kv_dtype="bf16", device="cuda") -> Tuple:
    """Zeroed (k, v) cache: stacked slabs [L, batch, max_len, Hk, Dh] at
    ``kv_dtype`` ('bf16' | 'int8' | 'fp8')."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (kv_slab(shape, kv_dtype, device), kv_slab(shape, kv_dtype, device))
