"""PyTorch/CUDA port of the XtraMAC serving stack (``repro``) for one NVIDIA
Hopper GPU.

Module names mirror ``repro``: ``quant`` (packed weight/KV codecs),
``kernels`` (hand-written CUDA kernels for ``sm_90a`` with plain-torch
twins), ``models`` (the dense transformer family), ``serve`` (KV slab pool,
engine step primitives, FCFS scheduler) and ``launch`` (drivers).  The
package imports neither JAX nor ``repro``: it keeps its own copies of the
host-side definitions it needs.

Entry points run on ``device="cuda"`` unless the caller passes another
device; CPU tensors take the kernels' plain versions (the tests), CUDA
tensors launch the kernels.
"""
