"""Model configurations served by the port (``--arch <id>`` resolves here).

``ModelConfig`` is the subset of ``repro.models.transformer.ModelConfig``
the serving paths read (dense; MoE with GQA or MLA attention, with or
without shared experts; the recurrent xLSTM (``ssm``) and Zamba2
(``hybrid``) families; the VLM (``vlm``: a dense GQA model whose prompt
starts with ``n_patches`` precomputed patch embeddings); the audio
encoder-decoder (``audio``: ``encoder_layers`` non-causal blocks over
``n_frames`` precomputed frame embeddings, then ``n_layers -
encoder_layers`` decoder blocks with cross-attention)), with the same
field names and defaults, so a config of the reference maps onto this one
field for field.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional


# the families that keep recurrent state
RECURRENT_FAMILIES = ("ssm", "hybrid")
# the families no slot pool or scheduler holds: the engine serves them
# through its static-batch loop (the VLM's patch prefix and the audio
# model's frames are per-request inputs the pool's chunked prefill does
# not carry, as in the reference)
STATIC_BATCH_FAMILIES = RECURRENT_FAMILIES + ("vlm", "audio")
# the stub frontends' outputs a batch carries: family -> (batch key, the
# config field of its rows); each is [B, rows, d_model]
FRONTEND_INPUTS = {"vlm": ("patches", "n_patches"),
                   "audio": ("frames", "n_frames")}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
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
    scheme_ffn: Optional[str] = None     # FFN / expert weights
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek-V2's latent attention) ---
    use_mla: bool = False
    q_lora: int = 0             # query low-rank dim (0 = dense q projection)
    kv_lora: int = 0            # compressed KV latent dim (the cached one)
    d_head_nope: int = 128
    d_head_rope: int = 64
    d_head_v: int = 128
    # --- SSM / hybrid ---
    ssm_state: int = 64
    ssm_d_head: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    slstm_every: int = 8        # xlstm: every 8th block is sLSTM
    attn_every: int = 6         # zamba2: shared attn block every 6 mamba
    # --- frontend stub: precomputed embeddings arrive as inputs ---
    n_patches: int = 0          # vlm: patch embeddings [B, n_patches, d]
    n_frames: int = 0           # audio: encoder frames [B, n_frames, d]
    encoder_layers: int = 0     # audio enc-dec split
    kv_chunk: int = 512

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads


_ARCH_MODULES: Dict[str, str] = {
    "granite-8b": "granite_8b",
    "minitron-8b": "minitron_8b",
    "starcoder2-15b": "starcoder2_15b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "xlstm-350m": "xlstm_350m",
    "zamba2-7b": "zamba2_7b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "whisper-medium": "whisper_medium",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.SMOKE if smoke else mod.FULL
