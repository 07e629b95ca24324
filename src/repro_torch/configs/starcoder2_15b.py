"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152.  GQA + RoPE, GELU non-gated FFN.  [arXiv:2402.19173]

Quantization plan: MXFP4 (FP4 x BF16 + BF16 MACs, UE8M0 power-of-two
scales) on every projection and FFN weight, bf16 ``lm_head``.  Same values
as ``repro/configs/starcoder2_15b.py`` (its ``microbatches`` is a training
knob the serving port does not read).
"""
from . import ModelConfig

FULL = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_head=128,
    d_ff=24_576, vocab=49_152,
    activation="gelu", gated_ffn=False, tie_embeddings=False,
    scheme_proj="mxfp4", scheme_ffn="mxfp4",
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
    activation="gelu", gated_ffn=False, tie_embeddings=False,
    scheme_proj="mxfp4", scheme_ffn="mxfp4",
    kv_chunk=64,
)
