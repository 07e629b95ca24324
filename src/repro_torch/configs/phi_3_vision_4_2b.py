"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H d_ff=8192 vocab=32064.
phi3-mini backbone + CLIP frontend (a stub: the prompt carries precomputed
patch embeddings [B, 256, d_model]).  [hf:microsoft/Phi-3-vision-128k]

Quantization plan: FP8 weights on the projections and FFN (run as FP8 x
BF16, the reference's route), tied embeddings.  Same values as
``repro/configs/phi_3_vision_4_2b.py``.
"""
from . import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32_064,
    n_patches=256,
    activation="silu", gated_ffn=True, tie_embeddings=True,
    scheme_proj="fp8", scheme_ffn="fp8",
)

SMOKE = ModelConfig(
    name="phi3v-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=512,
    n_patches=4,
    activation="silu", gated_ffn=True, tie_embeddings=True,
    scheme_proj="fp8", scheme_ffn="fp8",
    kv_chunk=64,
)
