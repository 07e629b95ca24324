"""Parameter counts of a model configuration (the ``model_params`` of
``repro/launch/roofline.py``), from the shapes of the port's layout:
nothing is allocated, at any width.

The count is the unquantized one (every linear a [K, N] matrix), as the
reference counts its abstract parameter tree built with
``quantize=False``: the token embedding, the final norm, the ``lm_head``
unless tied, and per layer two norms, the q / k / v / o projections and
the FFN (gate, up, down; or in, out) or, for a MoE model, the router
[D, E] and every expert's gate, up and down (shared experts, always on,
as one gated FFN of ``n_shared_experts`` expert widths).  The active count
keeps ``top_k`` of ``n_experts`` of the routed experts' weights, as the
reference computes it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import ModelConfig


def _norm(cfg: ModelConfig) -> int:
    return cfg.d_model * (2 if cfg.norm == "layer" else 1)


def model_params(cfg: ModelConfig) -> Dict[str, float]:
    """{'total', 'active'} parameter counts (equal for a dense model)."""
    if cfg.family not in ("dense", "moe") or cfg.use_mla:
        raise NotImplementedError(
            f"model_params: family {cfg.family!r} "
            f"{'with MLA ' if cfg.use_mla else ''}is not ported")
    d, dh = cfg.d_model, cfg.head_dim
    attn = d * cfg.n_heads * dh * 2 + d * cfg.n_kv_heads * dh * 2
    expert = 0
    if cfg.n_experts:
        f = cfg.moe_d_ff or cfg.d_ff
        expert = cfg.n_experts * 3 * d * f
        ffn = d * cfg.n_experts + expert + 3 * d * f * cfg.n_shared_experts
    else:
        ffn = d * cfg.d_ff * (3 if cfg.gated_ffn else 2)
    layer = 2 * _norm(cfg) + attn + ffn
    total = cfg.vocab * d + _norm(cfg) + cfg.n_layers * layer
    if not cfg.tie_embeddings:
        total += d * cfg.vocab
    active = total
    if cfg.n_experts and cfg.top_k:
        active = total - cfg.n_layers * expert * (
            1 - cfg.top_k / cfg.n_experts)
    return {"total": float(total), "active": float(active)}
