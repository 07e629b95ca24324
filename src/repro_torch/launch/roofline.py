"""Parameter counts of a model configuration (the ``model_params`` of
``repro/launch/roofline.py``), from the shapes of the port's layout:
nothing is allocated, at any width.

The count is the unquantized one (every linear a [K, N] matrix), as the
reference counts its abstract parameter tree built with
``quantize=False``: the token embedding, the final norm, the ``lm_head``
unless tied, and per layer two norms, the attention (GQA: the q / k / v /
o projections; MLA: ``w_dkv``, ``w_uk``, ``w_uv``, ``wo``, ``w_dq`` and
``w_uq`` — or one dense ``w_uq`` without a query low rank — and the
``kv_norm`` / ``q_norm`` gammas) and the FFN (gate, up, down; or in,
out) or, for a MoE model, the router [D, E], every expert's gate, up and
down and the shared experts (always on, one gated FFN of
``n_shared_experts`` expert widths).  The active count keeps ``top_k`` of
``n_experts`` of the routed experts' weights, as the reference computes
it.  The VLM counts as the dense model it is (tied: no ``lm_head``; its
patch embeddings are inputs, not parameters).  The recurrent families count their blocks' leaves: xLSTM's mLSTM
(``w_up``, ``conv_w``, ``w_q`` / ``w_k`` / ``w_v``, ``w_if``, ``if_bias``,
``norm``, ``w_out``) and sLSTM (``w_gates``, ``r_gates``, ``b_gates``,
``norm``, ``w_out``) blocks with a norm each (and an FFN a block where
``d_ff``), Zamba2's Mamba-2 blocks (``w_zx``, ``w_bc``, ``w_dt``, the two
convs, ``A_log``, ``dt_bias``, ``D``, ``norm``, ``w_out``) with a norm
each and one shared attention + FFN block.  The audio encoder-decoder
counts its tied embedding, final LayerNorm (gamma and beta), encoder
blocks (two LayerNorms, the attention, the FFN), ``enc_pos`` [n_frames,
D], ``enc_ln_f``, decoder blocks (the encoder block's leaves plus
``ln_x`` and the cross-attention's q / k / v / o) and ``dec_pos``
[``DEC_POSITIONS``, D].
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import RECURRENT_FAMILIES, ModelConfig
from repro_torch.models.transformer import DEC_POSITIONS


def _norm(cfg: ModelConfig) -> int:
    return cfg.d_model * (2 if cfg.norm == "layer" else 1)


def _attention(cfg: ModelConfig) -> int:
    d, h = cfg.d_model, cfg.n_heads
    if not cfg.use_mla:
        dh = cfg.head_dim
        return d * h * dh * 2 + d * cfg.n_kv_heads * dh * 2
    lora, rope = cfg.kv_lora, cfg.d_head_rope
    qk = h * (cfg.d_head_nope + rope)
    n = (d * (lora + rope) + lora + lora * h * cfg.d_head_nope
         + lora * h * cfg.d_head_v + h * cfg.d_head_v * d)
    if cfg.q_lora:
        return n + d * cfg.q_lora + cfg.q_lora + cfg.q_lora * qk
    return n + d * qk


def model_params(cfg: ModelConfig) -> Dict[str, float]:
    """{'total', 'active'} parameter counts (equal for a dense model)."""
    if cfg.family in RECURRENT_FAMILIES:
        total = float(_recurrent(cfg))
        return {"total": total, "active": total}
    if cfg.family == "audio":
        total = float(_audio(cfg))
        return {"total": total, "active": total}
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"model_params: family {cfg.family!r} is not ported")
    d = cfg.d_model
    expert = 0
    if cfg.n_experts:
        f = cfg.moe_d_ff or cfg.d_ff
        expert = cfg.n_experts * 3 * d * f
        ffn = d * cfg.n_experts + expert + 3 * d * f * cfg.n_shared_experts
    else:
        ffn = _ffn(cfg)
    layer = 2 * _norm(cfg) + _attention(cfg) + ffn
    total = cfg.vocab * d + _norm(cfg) + cfg.n_layers * layer
    if not cfg.tie_embeddings:
        total += d * cfg.vocab
    active = total
    if cfg.n_experts and cfg.top_k:
        active = total - cfg.n_layers * expert * (
            1 - cfg.top_k / cfg.n_experts)
    return {"total": float(total), "active": float(active)}


def _ffn(cfg: ModelConfig) -> int:
    return cfg.d_model * cfg.d_ff * (3 if cfg.gated_ffn else 2)


def _audio(cfg: ModelConfig) -> int:
    d, le = cfg.d_model, cfg.encoder_layers
    block = 2 * _norm(cfg) + _attention(cfg) + _ffn(cfg)
    enc = le * block + cfg.n_frames * d + _norm(cfg)
    dec = (cfg.n_layers - le) * (block + _norm(cfg) + _attention(cfg)) \
        + DEC_POSITIONS * d
    return cfg.vocab * d + _norm(cfg) + enc + dec      # tied: no lm_head


def _recurrent(cfg: ModelConfig) -> int:
    d, width = cfg.d_model, 4                   # the blocks' conv width
    di = cfg.ssm_expand * d
    total = cfg.vocab * d + _norm(cfg)          # tied: no lm_head
    if cfg.family == "ssm":
        g, per, nh = cfg.n_layers // cfg.slstm_every, cfg.slstm_every, \
            cfg.n_heads
        mlstm = (d * 2 * di + width * di + 3 * di * di + di * 2 * nh
                 + 2 * nh + di + di * d)
        slstm = (d * 4 * d + 4 * nh * (d // nh) ** 2 + 4 * d + d + d * d)
        return total + g * (per - 1) * (mlstm + _norm(cfg)) \
            + g * (slstm + _norm(cfg))
    ds, nh = cfg.ssm_state, di // cfg.ssm_d_head
    mamba = (d * 2 * di + d * 2 * ds + d * nh + width * di + width * 2 * ds
             + 3 * nh + di + di * d)
    shared = 2 * _norm(cfg) + _attention(cfg) + _ffn(cfg)
    return total + cfg.n_layers * (mamba + _norm(cfg)) + shared
