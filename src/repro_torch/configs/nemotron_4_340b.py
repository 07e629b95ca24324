"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_head=192
d_ff=73728 vocab=256000.  Squared-ReLU, non-gated FFN.  [arXiv:2402.16819]

Quantization plan: MXFP4 (FP4 x BF16 + BF16 MACs) on every projection and
FFN weight, bf16 ``lm_head``.  Same values as
``repro/configs/nemotron_4_340b.py`` (its ``microbatches`` is a training
knob the serving port does not read).  FULL does not fit one card (about
331 B weights); the card runs it at full width with fewer layers
(``dataclasses.replace(FULL, n_layers=...)``).
"""
from . import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18_432, n_heads=96, n_kv_heads=8, d_head=192,
    d_ff=73_728, vocab=256_000,
    activation="relu2", gated_ffn=False, tie_embeddings=False,
    scheme_proj="mxfp4", scheme_ffn="mxfp4",
)

SMOKE = ModelConfig(
    name="nemotron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512,
    activation="relu2", gated_ffn=False, tie_embeddings=False,
    scheme_proj="mxfp4", scheme_ffn="mxfp4",
    kv_chunk=64,
)
