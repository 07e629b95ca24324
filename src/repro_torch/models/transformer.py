"""The dense and MoE transformer families: parameters, forward, KV cache
(torch twin of the dense / MoE path of ``repro/models/transformer.py``; a
MoE block holds ``moe`` — router, expert stacks and any shared experts,
``models/moe.py`` — in place of ``ffn``; with ``use_mla`` the block's
attention is DeepSeek-V2's latent attention, ``attention.mla_forward``).

``forward`` runs the reference's serving modes as a loop over layers:
  * ``prefill_chunk`` — S new positions written at an int ``cache_index``;
    attention over the cache (earlier chunks are already there); logits for
    every chunk position;
  * ``decode`` — one token per row, a [B] ``cache_index`` (every pool slot
    at its own length), attention through the fused decode kernel.

The cache is ``(k, v)``: stacked per-layer slabs [L, B, Smax, Hk, Dh] (bf16
or ``QuantizedKV``), written in place (MLA: ``(c_kv, k_rope)``, bf16
[L, B, Smax, kv_lora] and [L, B, Smax, d_head_rope]); with a
``page_table`` [B, pages_per_slot], page arenas [L, n_pages, page_size,
Hk, Dh] instead (paged pools, GQA only: each layer writes through the
table and reads the gathered virtual slabs).  ``plain=True`` runs every
kernel's plain version instead (the on-card reference for the kernels).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.quant.kv_cache import kv_dtype_name, kv_slab

from . import attention as A
from . import moe as MOE
from .common import QuantMaker, activate, apply_linear, rms_norm

MODES = ("prefill_chunk", "decode")


def attn_cfg(cfg: ModelConfig) -> A.AttnConfig:
    return A.AttnConfig(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
                        use_rope=cfg.use_rope, kv_chunk=cfg.kv_chunk)


def mla_cfg(cfg: ModelConfig) -> A.MLAConfig:
    return A.MLAConfig(n_heads=cfg.n_heads, q_lora=cfg.q_lora,
                       kv_lora=cfg.kv_lora, d_head_nope=cfg.d_head_nope,
                       d_head_rope=cfg.d_head_rope, d_head_v=cfg.d_head_v,
                       rope_theta=cfg.rope_theta, kv_chunk=cfg.kv_chunk)


def check_supported(cfg: ModelConfig) -> None:
    ffn = (cfg.gated_ffn, cfg.activation)
    moe = cfg.family == "moe" and cfg.n_experts > 0 and cfg.top_k > 0
    if (cfg.family not in ("dense", "moe") or (cfg.family == "moe") != moe
            or cfg.norm != "rms" or cfg.tie_embeddings
            or ffn not in ((True, "silu"), (False, "relu2"), (False, "gelu"))
            or (moe and ffn != (True, "silu"))):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense family with RMS norm, a "
            "gated SiLU or non-gated squared-ReLU / GELU FFN, and the MoE "
            "family with gated SiLU experts (routed, and shared where the "
            "config has them), both with GQA or MLA attention and an "
            "untied lm_head")


class Block(nn.Module):
    """One transformer block: RMS norm, attention (GQA, or MLA's leaves),
    RMS norm, then the FFN (``ffn``) or the MoE layer (``moe``: router,
    expert stacks, shared experts)."""

    def __init__(self, ln1, attn: dict, ln2, ffn: Optional[dict] = None,
                 moe: Optional[dict] = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block holds an FFN or a MoE layer")
        self.register_buffer("ln1", ln1)
        self.attn = nn.ModuleDict(attn)
        self.register_buffer("ln2", ln2)
        if moe is None:
            self.ffn = nn.ModuleDict(ffn)
        else:
            self.moe = nn.ModuleDict(moe)


class DenseLM(nn.Module):
    """Parameters of a model: embedding, blocks, final norm, head."""

    def __init__(self, embed, layers, ln_f, lm_head: nn.Module):
        super().__init__()
        self.register_buffer("embed", embed)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("ln_f", ln_f)
        self.lm_head = lm_head


def build_params(cfg: ModelConfig, mk: QuantMaker) -> DenseLM:
    """Walk the family's leaves (same logical names as the reference's
    Maker walk) with ``mk``, one layer at a time."""
    check_supported(cfg)
    d, h, hk, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    sp, sf = cfg.scheme_proj, cfg.scheme_ffn
    embed = mk.table("embed", cfg.vocab, d)
    layers = []
    for _ in range(cfg.n_layers):
        if cfg.use_mla:
            attn = A.mla_params(mk, mla_cfg(cfg), d, sp)
        else:
            attn = {"wq": mk.dense("attn.wq", d, h * dh, sp),
                    "wk": mk.dense("attn.wk", d, hk * dh, sp),
                    "wv": mk.dense("attn.wv", d, hk * dh, sp),
                    "wo": mk.dense("attn.wo", h * dh, d, sp)}
        if cfg.family == "moe":
            layers.append(Block(mk.norm("ln1", d), attn, mk.norm("ln2", d),
                                moe=MOE.moe_params(mk, cfg)))
            continue
        if cfg.gated_ffn:
            ffn = {"w_gate": mk.dense("ffn.w_gate", d, f, sf),
                   "w_up": mk.dense("ffn.w_up", d, f, sf),
                   "w_down": mk.dense("ffn.w_down", f, d, sf)}
        else:
            ffn = {"w_in": mk.dense("ffn.w_in", d, f, sf),
                   "w_out": mk.dense("ffn.w_out", f, d, sf)}
        layers.append(Block(mk.norm("ln1", d), attn, mk.norm("ln2", d), ffn))
    ln_f = mk.norm("ln_f", d)
    lm_head = mk.dense("lm_head", d, cfg.vocab, None)
    return DenseLM(embed, layers, ln_f, lm_head)


def _ffn(cfg: ModelConfig, p: nn.ModuleDict, x, plain: bool):
    if not cfg.gated_ffn:
        # the reference keeps the non-gated activation in bf16
        h = activate(cfg.activation, apply_linear(p["w_in"], x, plain=plain))
        return apply_linear(p["w_out"], h.to(torch.bfloat16), plain=plain)
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
            plain: bool = False, page_table: Optional[torch.Tensor] = None,
            layer_out: Optional[list] = None,
            routes: Optional[MOE.Routes] = None) -> Optional[torch.Tensor]:
    """tokens [B, S] -> logits [B, S, V] f32 (None when ``need_logits`` is
    False: the lm-head is skipped).  ``cache`` is updated in place.  A
    ``layer_out`` list gets the residual stream [B, S, D] after every layer
    appended (a diagnostic: ``launch/logit_spread.py``); ``routes`` (MoE)
    records every layer's expert ids, or replays those it holds (a
    diagnostic: ``chip_smoke.py`` holds the kernel path to the plain path
    on the kernel path's routes)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; the port runs {MODES}")
    if cfg.use_mla:
        acfg, attention = mla_cfg(cfg), A.mla_forward
    else:
        acfg, attention = attn_cfg(cfg), A.gqa_forward
    mcfg = MOE.moe_cfg(cfg) if cfg.family == "moe" else None
    x = params.embed[tokens].to(torch.bfloat16)
    k_all, v_all = cache
    for l, blk in enumerate(params.layers):
        h = rms_norm(x, blk.ln1)
        x = x + attention(blk.attn, acfg, h, cache=(k_all[l], v_all[l]),
                          cache_index=cache_index, plain=plain,
                          page_table=page_table)
        h = rms_norm(x, blk.ln2)
        if mcfg is not None:
            x = x + MOE.moe_forward(blk.moe, mcfg, h, plain=plain,
                                    routes=routes)
        else:
            x = x + _ffn(cfg, blk.ffn, h, plain)
        if layer_out is not None:
            layer_out.append(x)
    return _logits(params, x, plain) if need_logits else None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               kv_dtype="bf16", device="cuda") -> Tuple:
    """Zeroed (k, v) cache: stacked slabs [L, batch, max_len, Hk, Dh] at
    ``kv_dtype`` ('bf16' | 'int8' | 'fp8').  MLA: the latent cache (c_kv
    [L, batch, max_len, kv_lora], k_rope [L, batch, max_len,
    d_head_rope]), bf16 only (``mla_cache_spec``)."""
    if cfg.use_mla:
        if kv_dtype_name(kv_dtype) != "bf16":
            raise ValueError(
                f"kv_dtype={kv_dtype!r}: KV quantization covers the GQA "
                "per-head cache; the MLA latent cache is already compressed "
                "(kv_lora per token) and stays bf16")
        lead = (cfg.n_layers, batch, max_len)
        return (kv_slab(lead + (cfg.kv_lora,), "bf16", device),
                kv_slab(lead + (cfg.d_head_rope,), "bf16", device))
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (kv_slab(shape, kv_dtype, device), kv_slab(shape, kv_dtype, device))
