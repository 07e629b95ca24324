"""Parameter counts of a model configuration (the ``model_params`` of
``repro/launch/roofline.py``), from the shapes of the port's dense layout:
nothing is allocated, at any width.

The count is the unquantized one (every linear a [K, N] matrix), as the
reference counts its abstract parameter tree built with
``quantize=False``: the token embedding, the final norm, the ``lm_head``
unless tied, and per layer two norms, the q / k / v / o projections and
the FFN (gate, up, down; or in, out).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import ModelConfig


def _norm(cfg: ModelConfig) -> int:
    return cfg.d_model * (2 if cfg.norm == "layer" else 1)


def model_params(cfg: ModelConfig) -> Dict[str, float]:
    """{'total', 'active'} parameter counts (equal for a dense model)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model_params: family {cfg.family!r} is not ported")
    d, dh = cfg.d_model, cfg.head_dim
    attn = d * cfg.n_heads * dh * 2 + d * cfg.n_kv_heads * dh * 2
    ffn = d * cfg.d_ff * (3 if cfg.gated_ffn else 2)
    layer = 2 * _norm(cfg) + attn + ffn
    total = cfg.vocab * d + _norm(cfg) + cfg.n_layers * layer
    if not cfg.tie_embeddings:
        total += d * cfg.vocab
    return {"total": float(total), "active": float(total)}
