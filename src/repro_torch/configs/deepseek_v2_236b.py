"""deepseek-v2-236b [moe] — 60L d_model=5120 128H MLA (kv_lora=512)
d_ff=1536 (per routed expert) vocab=102400, 2 shared + 160 routed top-6.
[arXiv:2405.04434]

MLA: q_lora=1536, kv_lora=512, d_head 128 (nope) + 64 (rope), d_v=128;
the cache holds the latent and the shared rope key (kv_lora + d_head_rope
bf16 values a token a layer), decode runs the absorbed-latent form.
Quantization plan: fp8 (E4M3, per-channel scales) on every projection,
expert and shared-expert weight; a bf16 router and ``lm_head``.  Same
values as ``repro/configs/deepseek_v2_236b.py`` (its ``microbatches`` is
a training knob the serving port does not read).  FULL does not fit one
card (about 3.97 GB of fp8 weights a layer); the card runs it at full
width with fewer layers (``dataclasses.replace(FULL, n_layers=...)``).
"""
from . import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102_400,
    n_experts=160, top_k=6, n_shared_experts=2, moe_d_ff=1536,
    use_mla=True, q_lora=1536, kv_lora=512,
    d_head_nope=128, d_head_rope=64, d_head_v=128,
    activation="silu", gated_ffn=True, tie_embeddings=False,
    scheme_proj="fp8", scheme_ffn="fp8",
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512,
    n_experts=8, top_k=2, n_shared_experts=2, moe_d_ff=96,
    use_mla=True, q_lora=48, kv_lora=32,
    d_head_nope=16, d_head_rope=8, d_head_v=16,
    activation="silu", gated_ffn=True, tie_embeddings=False,
    scheme_proj="fp8", scheme_ffn="fp8",
    kv_chunk=64,
)
