"""Shared model-layer pieces: linear leaves, the weight maker, numerics.

Linear leaves keep the reference's ``[K, N]`` layout (x @ W):
  * ``QLinear``     packed int32 codes [K/per, N] + f32 scales as buffers
                    (w8a8: raw int8 codes, stored transposed [N, K] for
                    the int8 kernel); applied through
                    ``kernels.ops.quantized_matmul``.  An expert stack
                    holds [E, K/per, N] words and [E, K/G, N] scales,
                    contiguous (each expert's slice 16-byte aligned when
                    N % 4 == 0), applied through
                    ``kernels.ops.grouped_quantized_matmul``;
  * ``DenseLinear`` a bf16 [K, N] weight (``lm_head``); applied with
                    ``torch.matmul``, as the reference leaves it to XLA;
  * ``Norm``        a norm's f32 gamma inside a layer's leaf dict (MLA's
                    ``q_norm`` / ``kv_norm``), or a LayerNorm's f32 gamma
                    and beta (the audio model's norms; ``apply_norm``).

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
from repro_torch.quant.schemes import (dequantize, get_scheme,
                                      quantize_weights)


class QLinear(nn.Module):
    """Quantized linear weights [K, N]: codes + group scales.

    Takes the codes in the reference's layout: packed int32 words
    [K/per, N], or for w8a8 raw int8 codes [K, N].  w8a8 codes are kept
    transposed, [N, K] (each output column's K codes contiguous, the layout
    the int8 kernel reads); ``reference_codes()`` gives them back as
    [K, N]."""

    def __init__(self, packed: torch.Tensor, scales: torch.Tensor,
                 scheme_name: str, shape: Tuple[int, int],
                 name: Optional[str] = None):
        super().__init__()
        self.scheme_name = scheme_name
        self.scheme = get_scheme(scheme_name)
        if not self.scheme.packed:
            if packed.dim() != 2:
                raise ValueError(f"{name}: w8a8 leaves are not stacked")
            packed = packed.t().contiguous()
        self.register_buffer("packed", packed)
        self.register_buffer("scales", scales)
        # the leaf dequantized to bf16, made on first use (``dense_bf16``)
        self.register_buffer("dense", None, persistent=False)
        self.shape = tuple(shape)
        self.name = name

    def reference_codes(self) -> torch.Tensor:
        """The codes in the reference's layout (w8a8: int8 [K, N])."""
        return self.packed if self.scheme.packed else self.packed.t()

    def dense_bf16(self) -> torch.Tensor:
        """The weights [K, N] dequantized (code x group scale in f32, as
        the reference's ``dequantize``) and rounded to bf16: made once, on
        first use, and kept beside the codes (MLA's absorbed decode reads
        ``w_uk`` / ``w_uv`` so every step)."""
        if self.dense is None:
            if not self.scheme.packed:
                raise NotImplementedError(
                    f"{self.name}: dense_bf16 dequantizes the packed "
                    f"schemes, not {self.scheme_name!r}")
            self.dense = dequantize(self.scheme, self.packed, self.scales,
                                    self.shape).to(torch.bfloat16)
        return self.dense

    def extra_repr(self) -> str:
        return f"{self.scheme_name}, {self.shape}, {self.name}"


class DenseLinear(nn.Module):
    """Dense bf16 linear weights [K, N]."""

    def __init__(self, weight: torch.Tensor, name: Optional[str] = None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.name = name


class Norm(nn.Module):
    """A norm's f32 gamma [dim] as a module leaf; with a ``bias`` (the
    beta [dim]) it is a LayerNorm, else an RMS norm (``apply_norm``)."""

    def __init__(self, weight: torch.Tensor, name: Optional[str] = None,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)
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

    def dense(self, name: str, k: int, n: int, scheme: Optional[str] = None,
              experts: int = 0):
        """One [K, N] leaf, or with ``experts`` a stack of that many,
        each quantized as its own [K, N] leaf (the reference's per-slice
        loop, ``repro/models/common.py:QuantMaker.dense``)."""
        scheme = self.plan.get(name, scheme) or "bf16"
        if experts:
            return self._expert_stack(name, experts, k, n, scheme)
        w = self._normal(k, n).div_(math.sqrt(k))   # in place: one f32 copy
        if scheme == "bf16":
            return DenseLinear(w.to(torch.bfloat16), name)
        packed, scales = quantize_weights(get_scheme(scheme), w)
        return QLinear(packed, scales, scheme, (k, n), name)

    def _expert_stack(self, name: str, e: int, k: int, n: int, scheme: str):
        """[E, K, N] draws quantized in one call as the [K, E N] leaf of
        the experts side by side: the quantizer's groups run along K
        within one column, so each expert's codes and scales are those of
        its own [K, N] leaf, bit for bit."""
        sch = get_scheme(scheme)
        if not sch.packed:
            raise NotImplementedError(
                f"{name}: the port stacks experts in the packed schemes, "
                f"not {scheme!r}")
        w = self._normal(e, k, n).div_(math.sqrt(k))
        packed, scales = quantize_weights(
            sch, w.transpose(0, 1).reshape(k, e * n))
        del w
        return QLinear(packed.reshape(-1, e, n).transpose(0, 1).contiguous(),
                       scales.reshape(-1, e, n).transpose(0, 1).contiguous(),
                       scheme, (k, n), name)

    def table(self, name: str, rows: int, cols: int, scale: float = 0.02,
              lead: Tuple[int, ...] = ()):
        """A bf16 [*lead, rows, cols] table of normal draws times
        ``scale`` (the reference's ``Maker.table``; ``lead`` holds the
        dims it stacks in front, as sLSTM's [4, heads] recurrent
        matrices)."""
        return self._normal(*lead, rows, cols).mul_(scale).to(torch.bfloat16)

    def norm(self, name: str, dim: int):
        return torch.ones(dim, dtype=torch.float32, device=self.device)

    def vector(self, name: str, dim: int, init: float = 0.0):
        """An f32 [dim] vector filled with ``init`` (biases, decay
        parameters)."""
        return torch.full((dim,), init, dtype=torch.float32,
                          device=self.device)


# ---------------------------------------------------------------------------
# Numerics helpers (same f32 / bf16 staging as the reference)
# ---------------------------------------------------------------------------
def tied_logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """x [..., D] bf16 @ embed [V, D].T -> [..., V] f32: the tied lm-head,
    products of the bf16 operands summed in f32 (the reference's
    ``einsum(..., preferred_element_type=f32)``; a bf16 matmul would round
    the logits to bf16)."""
    return torch.matmul(x.to(torch.float32), embed.to(torch.float32).t())


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``layer_norm``: in f32, the mean and the variance
    with correction 0 (``jnp.var``: the sum of squared deviations over n),
    then cast back.  Not ``torch.var``: its default is unbiased, and its
    CPU reduction is no sum followed by a division."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.sum((xf - mu) ** 2, dim=-1, keepdim=True) / xf.shape[-1]
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def apply_norm(norm: "Norm", x: torch.Tensor) -> torch.Tensor:
    """A ``Norm`` leaf on x: LayerNorm where it carries a beta, else RMS."""
    if norm.bias is not None:
        return layer_norm(x, norm.weight, norm.bias)
    return rms_norm(x, norm.weight)


def activate(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "silu":
        return torch.nn.functional.silu(x)
    if kind == "gelu":
        return gelu_tanh(x)
    if kind == "relu2":      # nemotron squared-ReLU, in x's dtype
        r = torch.relu(x)
        return r * r
    raise NotImplementedError(f"activation {kind!r} is not ported yet")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation) as the reference evaluates it:
    op by op in x's dtype, each result rounded, with the constants
    sqrt(2/pi) and 0.044715 rounded to that dtype first."""
    # not F.gelu(approximate='tanh'): fused in f32, it rounds once and moves
    # 43 % of bf16 N(0, 3) inputs off the reference's result
    c, a = torch.tensor([math.sqrt(2 / math.pi), 0.044715], dtype=x.dtype,
                        device=x.device)
    inner = c * (x + a * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


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
