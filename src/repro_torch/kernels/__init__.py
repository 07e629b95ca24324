"""Hand-written CUDA kernels for Hopper (``sm_90a``) with plain-torch twins.

``packed_matmul``    packed-weight GEMV (M <= 8) and tiled matmul (M > 8)
``decode_attention`` split-KV flash-decode over bf16 / int8 / fp8 KV slabs
``ops``              the dispatch the model layer calls
``build``            nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries
"""
