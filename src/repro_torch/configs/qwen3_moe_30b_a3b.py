"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]

Quantization plan (paper Fig. 1, Qwen3-AWQ): AWQ-style INT4 on every
projection and expert (INT4 x BF16 + BF16 MACs), a bf16 router and
``lm_head``.  Same values as ``repro/configs/qwen3_moe_30b_a3b.py`` (its
``microbatches`` and ``ssm_chunk`` are knobs the serving port does not
read).
"""
from . import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=64,
    d_ff=768, vocab=151_936,
    n_experts=128, top_k=8, moe_d_ff=768,
    activation="silu", gated_ffn=True, tie_embeddings=False,
    scheme_proj="awq_int4", scheme_ffn="awq_int4",
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab=512,
    n_experts=8, top_k=2, moe_d_ff=96,
    activation="silu", gated_ffn=True, tie_embeddings=False,
    scheme_proj="awq_int4", scheme_ffn="awq_int4",
    kv_chunk=64,
)
