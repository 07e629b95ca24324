"""GQA self-attention with a KV cache (torch twin of the GQA path of
``repro/models/attention.py``).

Two execution modes, as in the reference:
  * ``attend`` — plain torch, for prefill chunks: dense (one score block)
    or chunked online softmax over KV chunks, with the reference's bf16
    staging (bf16 inputs, f32-accumulated products stored as bf16, f32
    softmax).  It is not a TPU kernel in the reference either.
  * Sq == 1 decode goes to ``kernels.ops.fused_decode_attention``: the
    flash-decode kernel reads the (packed) slab directly.

Shapes: x [B, S, D]; heads [B, S, H, Dh]; KV slabs [B, Smax, Hk, Dh]
(bf16 or ``QuantizedKV``).  Cache writes go into the slab in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.ops import fused_decode_attention
from repro_torch.quant.kv_cache import (cache_read, cache_write_rows,
                                        cache_write_slice)

from .common import apply_linear, apply_rope

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    use_rope: bool = True
    kv_chunk: int = 512


def _bf16_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16-storage contraction: f32 accumulation, bf16 result."""
    return torch.einsum(eq, a.to(torch.float32),
                        b.to(torch.float32)).to(torch.bfloat16)


def _scale(dh: int, device) -> torch.Tensor:
    """1/sqrt(Dh) in f32, then bf16 (the reference's ``scale.astype``)."""
    return (1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                          device=device))).to(torch.bfloat16)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_offset=0, kv_chunk: int = 512,
           kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal softmax attention.  q [B,Sq,H,Dh]; k,v [B,Sk,Hk,Dh] ->
    [B,Sq,H,Dh].

    ``q_offset``: absolute position of q[0] (int or [B] tensor);
    ``kv_valid_len``: optional [B] count of valid KV positions."""
    sq, sk = q.shape[1], k.shape[1]
    if sq == 1 or sk <= kv_chunk or sk % kv_chunk != 0:
        return _attend_dense(q, k, v, q_offset=q_offset,
                             kv_valid_len=kv_valid_len)
    return _attend_chunked(q, k, v, q_offset=q_offset, kv_chunk=kv_chunk,
                           kv_valid_len=kv_valid_len)


def _mask_bias(q_offset, sq, sk, k_offset, kv_valid_len, device):
    """[B or 1, Sq, Sk] additive f32 bias (0 or -1e30)."""
    q_off = torch.as_tensor(q_offset, device=device).reshape(-1, 1, 1)
    qpos = q_off + torch.arange(sq, device=device)[None, :, None]
    kpos = k_offset + torch.arange(sk, device=device)[None, None, :]
    ok = (kpos <= qpos).expand(qpos.shape[0], sq, sk)
    zero = torch.zeros((), device=device)
    neg = torch.full((), _NEG, device=device)
    bias = torch.where(ok, zero, neg)
    if kv_valid_len is not None:
        valid = kpos < kv_valid_len.to(device)[:, None, None]
        bias = torch.where(valid, bias, neg)
    return bias


def _attend_dense(q, k, v, *, q_offset, kv_valid_len):
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // hk
    qg = (q * _scale(dh, q.device)).reshape(b, sq, hk, rep, dh)
    s = _bf16_einsum("bqhrd,bkhd->bhrqk", qg, k).to(torch.float32)
    s = s.reshape(b, h, sq, sk)
    s = s + _mask_bias(q_offset, sq, sk, 0, kv_valid_len, q.device)[:, None]
    p = torch.softmax(s, dim=-1)
    pg = p.reshape(b, hk, rep, sq, sk).to(v.dtype)
    out = _bf16_einsum("bhrqk,bkhd->bqhrd", pg, v)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _attend_chunked(q, k, v, *, q_offset, kv_chunk, kv_valid_len):
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // hk
    qg = (q * _scale(dh, q.device)).reshape(b, sq, hk, rep, dh)
    m = torch.full((b, h, sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for idx in range(sk // kv_chunk):
        sl = slice(idx * kv_chunk, (idx + 1) * kv_chunk)
        s = _bf16_einsum("bqhrd,bkhd->bhrqk", qg, k[:, sl]).to(torch.float32)
        s = s.reshape(b, h, sq, kv_chunk)
        s = s + _mask_bias(q_offset, sq, kv_chunk, idx * kv_chunk,
                           kv_valid_len, q.device)[:, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pg = p.reshape(b, hk, rep, sq, kv_chunk).to(v.dtype)
        pv = _bf16_einsum("bhrqk,bkhd->bhrqd", pg, v[:, sl]).to(torch.float32)
        acc = acc * corr[..., None] + pv.reshape(b, h, sq, dv)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]      # [b, h, sq, dv]
    return out.transpose(1, 2).reshape(b, sq, h, dv).to(q.dtype)


def gqa_forward(params: nn.ModuleDict, cfg: AttnConfig, x: torch.Tensor, *,
                cache: Tuple, cache_index, plain: bool = False):
    """x [B, S, D] -> out [B, S, D]; writes the new K/V into ``cache``.

    ``cache`` = (k_slab, v_slab) [B, Smax, Hk, Dh] views of the pool,
    updated in place.  ``cache_index``: an int offset (prefill chunk: S
    positions written at ``cache_index``, attention over the slab) or a [B]
    tensor (decode, S == 1: row i writes and attends at its own length,
    through the fused decode kernel)."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = apply_linear(params["wq"], x, plain=plain).reshape(b, s, h, dh)
    k = apply_linear(params["wk"], x, plain=plain).reshape(b, s, hk, dh)
    v = apply_linear(params["wv"], x, plain=plain).reshape(b, s, hk, dh)

    per_row = torch.is_tensor(cache_index) and cache_index.dim() == 1
    steps = torch.arange(s, device=x.device)[None, :]
    positions = (cache_index[:, None] + steps) if per_row \
        else (cache_index + steps)                             # [B or 1, S]
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    k_cache, v_cache = cache
    if per_row:
        if s != 1:
            raise ValueError("per-row cache_index is the decode (S == 1) path")
        rows = torch.arange(b, device=x.device)
        cache_write_rows(k_cache, k, rows, cache_index)
        cache_write_rows(v_cache, v, rows, cache_index)
        valid = (cache_index + s).to(torch.int32)
    else:
        cache_write_slice(k_cache, k, cache_index)
        cache_write_slice(v_cache, v, cache_index)
        valid = torch.full((b,), cache_index + s, dtype=torch.int32,
                           device=x.device)

    if s == 1:
        out = fused_decode_attention(q, k_cache, v_cache, valid, plain=plain)
    else:
        out = attend(q, cache_read(k_cache), cache_read(v_cache),
                     q_offset=cache_index, kv_chunk=cfg.kv_chunk,
                     kv_valid_len=valid)
    return apply_linear(params["wo"], out.reshape(b, s, h * dh), plain=plain)
