"""granite-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152.  Llama-architecture code model.  [arXiv:2405.04324]

Quantization plan: AWQ INT4 on every projection and FFN weight, bf16
``lm_head``.  Same values as ``repro/configs/granite_8b.py``.
"""
from . import ModelConfig

FULL = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14_336, vocab=49_152,
    activation="silu", gated_ffn=True, tie_embeddings=False,
    scheme_proj="awq_int4", scheme_ffn="awq_int4",
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
    activation="silu", gated_ffn=True, tie_embeddings=False,
    scheme_proj="awq_int4", scheme_ffn="awq_int4",
    kv_chunk=64,
)
