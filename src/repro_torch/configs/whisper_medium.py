"""whisper-medium [audio] — encoder-decoder, 24 encoder + 24 decoder
layers, d_model=1024 16H d_ff=4096 vocab=51865.  The conv frontend is a
stub: the batch carries precomputed frame embeddings [B, 1500, d_model].
[arXiv:2212.04356]

LayerNorm with a bias, non-gated GELU FFN, learned positions (no RoPE),
tied embeddings.  Quantization plan: W8A8 on the projections (self- and
cross-attention) and the FFN.  Same values as
``repro/configs/whisper_medium.py``.
"""
from . import ModelConfig

FULL = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=48, encoder_layers=24,    # 24 enc + 24 dec
    d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab=51_865,
    n_frames=1500,
    activation="gelu", gated_ffn=False, norm="layer",
    use_rope=False, tie_embeddings=True,
    scheme_proj="w8a8", scheme_ffn="w8a8",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=4, encoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=512,
    n_frames=8,
    activation="gelu", gated_ffn=False, norm="layer",
    use_rope=False, tie_embeddings=True,
    scheme_proj="w8a8", scheme_ffn="w8a8",
    kv_chunk=64,
)
