"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000.  Width/depth-pruned Nemotron-4: squared-ReLU, non-gated FFN.
[arXiv:2407.14679]

Quantization plan: W8A8 (SmoothQuant-style) on every projection and FFN
weight -> INT8 x INT8 -> INT32 MACs; bf16 ``lm_head``.  Same values as
``repro/configs/minitron_8b.py`` (its ``microbatches`` is a training knob
the serving port does not read).
"""
from . import ModelConfig

FULL = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=16_384, vocab=256_000,
    activation="relu2", gated_ffn=False, tie_embeddings=False,
    scheme_proj="w8a8", scheme_ffn="w8a8",
)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
    activation="relu2", gated_ffn=False, tie_embeddings=False,
    scheme_proj="w8a8", scheme_ffn="w8a8",
    kv_chunk=64,
)
