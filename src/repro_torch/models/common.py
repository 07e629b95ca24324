"""Shared model-layer pieces: linear leaves, the weight maker, numerics.

Linear leaves keep the reference's ``[K, N]`` layout (x @ W):
  * ``QLinear``     packed int32 codes [K/per, N] + f32 scales as buffers;
                    applied through ``kernels.ops.quantized_matmul``;
  * ``DenseLinear`` a bf16 [K, N] weight (``lm_head``); applied with
                    ``torch.matmul``, as the reference leaves it to XLA.

``QuantMaker`` draws normal weights from a ``torch.Generator`` on the
target device and quantizes each leaf there, one layer at a time, so a
full-width model is built on the card in seconds.  Its random draws differ
from the reference's ``jax.random`` ones; tests that compare the two build
weights with the reference and convert them (``repro_torch.bridge``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.ops import quantized_matmul
from repro_torch.quant.schemes import get_scheme, quantize_weights


class QLinear(nn.Module):
    """Packed quantized linear weights [K, N]: codes + group scales."""

    def __init__(self, packed: torch.Tensor, scales: torch.Tensor,
                 scheme_name: str, shape: Tuple[int, int],
                 name: Optional[str] = None):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scales", scales)
        self.scheme_name = scheme_name
        self.scheme = get_scheme(scheme_name)
        self.shape = tuple(shape)
        self.name = name

    def extra_repr(self) -> str:
        return f"{self.scheme_name}, {self.shape}, {self.name}"


class DenseLinear(nn.Module):
    """Dense bf16 linear weights [K, N]."""

    def __init__(self, weight: torch.Tensor, name: Optional[str] = None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.name = name


def apply_linear(leaf: nn.Module, x: torch.Tensor, out_dtype=torch.bfloat16,
                 plain: bool = False) -> torch.Tensor:
    """x [..., K] @ leaf -> [..., N] in ``out_dtype``."""
    if isinstance(leaf, QLinear):
        return quantized_matmul(x, leaf.packed, leaf.scales, leaf.scheme,
                                out_dtype=out_dtype, plain=plain)
    w = leaf.weight
    return torch.matmul(x.to(w.dtype), w).to(out_dtype)


class QuantMaker:
    """Builds leaves from seeded normal draws, quantized on ``device``.

    ``plan``: per-leaf scheme overrides keyed by logical name ("attn.wo",
    "ffn.w_down", ...); a plan entry wins over the config's scheme, and
    'bf16' (or None) keeps the leaf dense."""

    def __init__(self, seed: int, *, device, plan: Optional[Dict[str, str]] = None):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.plan = dict(plan or {})

    def _normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32)

    def dense(self, name: str, k: int, n: int, scheme: Optional[str] = None):
        scheme = self.plan.get(name, scheme) or "bf16"
        w = self._normal(k, n) / math.sqrt(k)
        if scheme == "bf16":
            return DenseLinear(w.to(torch.bfloat16), name)
        packed, scales = quantize_weights(get_scheme(scheme), w)
        return QLinear(packed, scales, scheme, (k, n), name)

    def table(self, name: str, rows: int, cols: int, scale: float = 0.02):
        return (self._normal(rows, cols) * scale).to(torch.bfloat16)

    def norm(self, name: str, dim: int):
        return torch.ones(dim, dtype=torch.float32, device=self.device)


# ---------------------------------------------------------------------------
# Numerics helpers (same f32 / bf16 staging as the reference)
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def activate(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "silu":
        return torch.nn.functional.silu(x)
    raise NotImplementedError(f"activation {kind!r} is not ported yet")


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S] int -> rotated x (same dtype)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
