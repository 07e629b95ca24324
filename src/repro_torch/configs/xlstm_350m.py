"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM ratio — every 8th block is sLSTM).
[arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own up-projection (no separate FFN).
Quantization plan: W8A8 (INT8xINT8+INT32 MACs) on the block projections,
tied embeddings.  Same values as ``repro/configs/xlstm_350m.py``.
"""
from . import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50_304,
    slstm_every=8, ssm_expand=2, ssm_chunk=128,
    use_rope=False, tie_embeddings=True,
    scheme_proj="w8a8", scheme_ffn="w8a8",
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=512,
    slstm_every=2, ssm_expand=2, ssm_chunk=16,
    use_rope=False, tie_embeddings=True,
    scheme_proj="w8a8", scheme_ffn="w8a8",
)
