"""Model configurations served by the port (``--arch <id>`` resolves here).

``ModelConfig`` is the subset of ``repro.models.transformer.ModelConfig``
the dense serving path reads, with the same field names and defaults, so a
config of the reference maps onto this one field for field.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # only "dense" is served by the port so far
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    activation: str = "silu"
    gated_ffn: bool = True
    norm: str = "rms"
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = True
    scheme_proj: Optional[str] = None    # attention projection weights
    scheme_ffn: Optional[str] = None     # FFN weights
    kv_chunk: int = 512

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads


_ARCH_MODULES: Dict[str, str] = {
    "granite-8b": "granite_8b",
    "minitron-8b": "minitron_8b",
    "starcoder2-15b": "starcoder2_15b",
    "nemotron-4-340b": "nemotron_4_340b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.SMOKE if smoke else mod.FULL
