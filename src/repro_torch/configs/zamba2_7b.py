"""zamba2-7b [hybrid] — 81L d_model=3584 32H d_ff=14336 vocab=32000,
ssm_state=64.  Mamba2 backbone + ONE shared attention block applied every
6 Mamba blocks (weights reused; each application keeps its own KV cache).
[arXiv:2411.15242]

Quantization plan: AWQ INT4 on the Mamba projections and the shared
block, tied embeddings.  Same values as ``repro/configs/zamba2_7b.py``
(its training knob ``microbatches`` left out).
"""
from . import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=112,
    d_ff=14_336, vocab=32_000,
    ssm_state=64, ssm_d_head=64, ssm_expand=2, ssm_chunk=128, attn_every=6,
    activation="silu", gated_ffn=True, tie_embeddings=True,
    scheme_proj="awq_int4", scheme_ffn="awq_int4",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=512,
    ssm_state=16, ssm_d_head=16, ssm_expand=2, ssm_chunk=16, attn_every=2,
    activation="silu", gated_ffn=True, tie_embeddings=True,
    scheme_proj="awq_int4", scheme_ffn="awq_int4",
    kv_chunk=64,
)
