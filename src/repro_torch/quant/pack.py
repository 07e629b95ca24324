"""Sub-byte code packing into int32 words, little-endian along K.

Layout (identical to ``repro/quant/pack.py``): ``packed[k // per, n]`` holds
codes ``k .. k+per-1`` of column ``n``, code i at bits [i*bits, (i+1)*bits).
INT4/FP4 pack 8 codes per word, INT8/FP8 pack 4.
"""
from __future__ import annotations

import torch


def codes_per_word(bits: int) -> int:
    if 32 % bits:
        raise ValueError(f"bits={bits} must divide 32")
    return 32 // bits


def to_int32_words(words64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 words with the same bits."""
    return torch.where(words64 >= 2 ** 31, words64 - 2 ** 32,
                       words64).to(torch.int32)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes: unsigned values < 2^bits, shape [K, ...] -> int32 [K/per, ...]."""
    per = codes_per_word(bits)
    k = codes.shape[0]
    if k % per:
        raise ValueError(f"K={k} not divisible by {per}")
    c = codes.to(torch.int64).reshape((k // per, per) + tuple(codes.shape[1:]))
    word = torch.zeros((k // per,) + tuple(codes.shape[1:]), dtype=torch.int64,
                       device=codes.device)
    for i in range(per):
        word |= c[:, i] << (i * bits)
    return to_int32_words(word)


def unpack_codes(words: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 [Kw, ...] -> unsigned codes int32 [Kw*per, ...]."""
    per = codes_per_word(bits)
    mask = (1 << bits) - 1
    parts = [(words >> (i * bits)) & mask for i in range(per)]
    stacked = torch.stack(parts, dim=1)                 # [Kw, per, ...]
    return stacked.reshape((words.shape[0] * per,) + tuple(words.shape[1:]))
