"""The kernel dispatch the model layer calls (torch twin of
``repro/kernels/ops.py``).

``quantized_matmul`` routes a packed linear to the GEMV kernel for M <= 8
rows (the reference's ``ops.py:336`` predicate) where that kernel takes
the leaf, and to the tensor-core matmul kernel otherwise (any M, N and
alignment), and a w8a8 linear to the int8 matmul kernel after quantizing
all of its input rows with one per-tensor scale (``ops.py:327``: under
W8A8 a row's output depends on the other rows of the call, by design);
``grouped_quantized_matmul`` is the counterpart of the reference's
``jax.vmap(apply_linear)`` over an expert stack (``repro/models/moe.py``):
one launch of the persistent expert-grouped body, counted as grouped K1
for M <= 8 rows a group and as grouped K2 past it (routed by M alone: the
same ``ops.py:336`` predicate); ``fused_decode_attention`` routes Sq == 1
attention to the flash-decode kernel.  Dense bf16 leaves (the ``lm_head``)
are not kernels: ``models/common.apply_linear`` gives them to
``torch.matmul``.

``plain=True`` computes the same function with the kernels' plain versions
on any device — the reference the on-card checks hold the kernels to.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.quant.schemes import quantize_activations_int8

from . import decode_attention as _da
from . import packed_matmul as _pm
from . import w8a8_matmul as _w8
from . import xtramac_mac as _xm
from .decode_attention import decode_attention_plain, gqa_decode_attention
from .packed_matmul import (gemv_takes, packed_gemv, packed_gemv_grouped,
                            packed_grouped_plain, packed_matmul,
                            packed_matmul_grouped, packed_matmul_plain)
from .w8a8_matmul import w8a8_matmul, w8a8_matmul_plain
from .xtramac_mac import (virtual_dsp_multiply,  # noqa: F401  (re-export)
                          virtual_dsp_plain)


def linear_route(scheme, m: int, k: int, n: int, packed_ptr: int,
                 scales_ptr: int) -> str:
    """Which kernel a quantized linear leaf takes on the card: "w8a8" (K5,
    which takes any K and alignment as they are), "gemv" (K1) or "matmul"
    (K2).  ``*_ptr`` are the operands' device addresses."""
    if scheme.name == "w8a8":
        return "w8a8"
    return "gemv" if gemv_takes(m, n, packed_ptr, scales_ptr) else "matmul"


def quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, scheme, *,
                     out_dtype=torch.bfloat16,
                     plain: bool = False) -> torch.Tensor:
    """x [..., K] @ quantized W [K, N] -> [..., N] in ``out_dtype``.
    ``packed``: int32 words [K/per, N] for the packed schemes, int8 codes
    transposed [N, K] for w8a8."""
    lead = x.shape[:-1]
    if scheme.name == "w8a8":
        x_codes, x_scale = quantize_activations_int8(
            x.reshape(-1, x.shape[-1]))
        fn = w8a8_matmul_plain if plain else w8a8_matmul
        out = fn(x_codes, x_scale, packed, scales)
        return out.reshape(*lead, -1).to(out_dtype)
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()
    if plain:
        out = packed_matmul_plain(x2, packed, scales, scheme)
    elif linear_route(scheme, *x2.shape, packed.shape[1], packed.data_ptr(),
                      scales.data_ptr()) == "gemv":
        out = packed_gemv(x2, packed, scales, scheme)
    else:
        out = packed_matmul(x2, packed, scales, scheme)
    return out.reshape(*lead, -1).to(out_dtype)


def grouped_quantized_matmul(x: torch.Tensor, leaf, expert_idx: torch.Tensor,
                             rows: torch.Tensor, *,
                             out_dtype=torch.bfloat16,
                             plain: bool = False) -> torch.Tensor:
    """x [G, M, K] @ the expert stack ``leaf`` (a ``QLinear`` of words [E,
    K/per, N] and scales [E, K/G, N]) -> [G, M, N] in ``out_dtype``: group
    g through expert ``expert_idx[g]`` ([G] int32 on x's device), rows
    past ``rows[g]`` ([G] int32) zero.  One launch of the grouped body:
    grouped K1 for M <= 8, grouped K2 past it; a stack the body does not
    take raises (``packed_matmul.grouped_refusal``)."""
    scheme = getattr(leaf, "scheme", None)      # None: a dense bf16 stack
    if scheme is None or not scheme.packed:
        raise NotImplementedError(
            f"{leaf.name}: the port runs expert stacks in the packed "
            f"schemes, not {getattr(scheme, 'name', 'bf16')!r}")
    x3 = x.to(torch.bfloat16).contiguous()
    args = (x3, leaf.packed, leaf.scales, scheme, expert_idx, rows)
    if plain:
        out = packed_grouped_plain(*args)
    elif x3.shape[1] <= _pm.GEMV_MAX_M:
        out = packed_gemv_grouped(*args)
    else:
        out = packed_matmul_grouped(*args)
    return out.to(out_dtype)


def fused_decode_attention(q: torch.Tensor, k_cache, v_cache,
                           kv_valid_len: torch.Tensor, *,
                           plain: bool = False) -> torch.Tensor:
    if plain:
        return decode_attention_plain(q, k_cache, v_cache, kv_valid_len)
    return gqa_decode_attention(q, k_cache, v_cache, kv_valid_len)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {**_pm.launches, **_w8.launches, **_da.launches, **_xm.launches}


def format_launch_counts() -> Dict[str, int]:
    """K1 / K2 launches by weight format and K3 / K4 launches by KV format
    since the last reset, keyed "wrapper:format"."""
    return {f"{name}:{fmt}": n for counts in (_pm.format_launches,
                                             _da.format_launches)
            for (name, fmt), n in counts.items()}


def grouped_launch_counts() -> Dict[str, int]:
    """Expert-grouped K1 / K2 launches by the rows M of a group since the
    last reset, keyed "wrapper:M=<M>"."""
    return {f"{name}:M={m}": n
            for (name, m), n in _pm.grouped_row_launches.items()}


def reset_launch_counts() -> None:
    for counts in (_pm.launches, _w8.launches, _da.launches, _xm.launches):
        for name in counts:
            counts[name] = 0
    _pm.format_launches.clear()
    _pm.grouped_row_launches.clear()
    _da.format_launches.clear()
