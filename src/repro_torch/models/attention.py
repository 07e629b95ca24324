"""GQA and MLA self-attention with a KV cache, and cross-attention (torch
twin of the GQA, MLA and cross-attention paths of
``repro/models/attention.py``).

Two execution modes, as in the reference:
  * ``attend`` — plain torch, for prefill chunks: dense (one score block)
    or chunked online softmax over KV chunks, with the reference's bf16
    staging (bf16 inputs, f32-accumulated products stored as bf16, f32
    softmax).  It is not a TPU kernel in the reference either.
  * Sq == 1 decode goes to ``kernels.ops.fused_decode_attention``: the
    flash-decode kernel reads the (packed) slab directly.

Non-causal attention (``AttnConfig.causal`` False: the audio model's
encoder, with no cache) and ``cross_attn_forward`` (its decoder's queries
over the encoder output, K / V projected from it at every call, as the
reference does) run ``attend`` with every key allowed.

Shapes: x [B, S, D]; heads [B, S, H, Dh]; KV slabs [B, Smax, Hk, Dh]
(bf16 or ``QuantizedKV``).  Cache writes go into the slab in place.  With
a page table the cache is a page arena instead: the new rows are written
through the table, and the rows' virtual slabs are gathered for the read.

MLA (DeepSeek-V2, ``mla_forward``) caches a head-less latent c_kv [B,
Smax, kv_lora] and one shared rope key [B, Smax, d_head_rope], both bf16.
A prefill chunk expands K / V out of the whole latent slab (``w_uk`` /
``w_uv``, the packed matmul at M = B Smax) and runs ``attend``; decode
runs the absorbed form, scores and values in latent space, as plain bf16
contractions (the reference's ``jnp.einsum``: no Pallas kernel there
either).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.ops import fused_decode_attention
from repro_torch.quant.kv_cache import (cache_read, cache_write_pages,
                                        cache_write_rows, cache_write_slice,
                                        gather_pages)

from .common import (Norm, QLinear, QuantMaker, apply_linear, apply_rope,
                     rms_norm)

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
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
           causal: bool = True, q_offset=0, kv_chunk: int = 512,
           kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention, causal or not.  q [B,Sq,H,Dh]; k,v [B,Sk,Hk,Dh]
    -> [B,Sq,H,Dh].

    ``q_offset``: absolute position of q[0] (int or [B] tensor);
    ``kv_valid_len``: optional [B] count of valid KV positions."""
    sq, sk = q.shape[1], k.shape[1]
    if sq == 1 or sk <= kv_chunk or sk % kv_chunk != 0:
        return _attend_dense(q, k, v, causal=causal, q_offset=q_offset,
                             kv_valid_len=kv_valid_len)
    return _attend_chunked(q, k, v, causal=causal, q_offset=q_offset,
                           kv_chunk=kv_chunk, kv_valid_len=kv_valid_len)


def _mask_bias(causal, q_offset, sq, sk, k_offset, kv_valid_len, device):
    """[B or 1, Sq, Sk] additive f32 bias (0 or -1e30): keys after the
    query masked where ``causal``, none otherwise, then keys past
    ``kv_valid_len``."""
    q_off = torch.as_tensor(q_offset, device=device).reshape(-1, 1, 1)
    qpos = q_off + torch.arange(sq, device=device)[None, :, None]
    kpos = k_offset + torch.arange(sk, device=device)[None, None, :]
    ok = (kpos <= qpos) if causal else torch.ones((1, 1, sk), dtype=torch.bool,
                                                   device=device)
    ok = ok.expand(qpos.shape[0], sq, sk)
    zero = torch.zeros((), device=device)
    neg = torch.full((), _NEG, device=device)
    bias = torch.where(ok, zero, neg)
    if kv_valid_len is not None:
        valid = kpos < kv_valid_len.to(device)[:, None, None]
        bias = torch.where(valid, bias, neg)
    return bias


def _attend_dense(q, k, v, *, causal, q_offset, kv_valid_len):
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // hk
    qg = (q * _scale(dh, q.device)).reshape(b, sq, hk, rep, dh)
    s = _bf16_einsum("bqhrd,bkhd->bhrqk", qg, k).to(torch.float32)
    s = s.reshape(b, h, sq, sk)
    s = s + _mask_bias(causal, q_offset, sq, sk, 0, kv_valid_len,
                       q.device)[:, None]
    p = torch.softmax(s, dim=-1)
    pg = p.reshape(b, hk, rep, sq, sk).to(v.dtype)
    out = _bf16_einsum("bhrqk,bkhd->bqhrd", pg, v)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _attend_chunked(q, k, v, *, causal, q_offset, kv_chunk, kv_valid_len):
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
        s = s + _mask_bias(causal, q_offset, sq, kv_chunk, idx * kv_chunk,
                           kv_valid_len, q.device)[:, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + torch.sum(p, dim=-1)
        pg = p.reshape(b, hk, rep, sq, kv_chunk).to(v.dtype)
        pv = _bf16_einsum("bhrqk,bkhd->bhrqd", pg, v[:, sl]).to(torch.float32)
        acc = acc * corr[..., None] + pv.reshape(b, h, sq, dv)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]      # [b, h, sq, dv]
    return out.transpose(1, 2).reshape(b, sq, h, dv).to(q.dtype)


def gqa_forward(params: nn.ModuleDict, cfg: AttnConfig, x: torch.Tensor, *,
                cache: Optional[Tuple], cache_index, plain: bool = False,
                page_table: Optional[torch.Tensor] = None,
                attend_local: bool = False):
    """x [B, S, D] -> out [B, S, D]; writes the new K/V into ``cache``.

    ``cache`` = (k_slab, v_slab) [B, Smax, Hk, Dh] views of the pool,
    updated in place.  ``cache_index``: an int offset (prefill chunk: S
    positions written at ``cache_index``, attention over the slab; S == 1:
    every row at that length, through the fused decode kernel) or a [B]
    tensor (decode, S == 1: row i writes and attends at its own length,
    through the fused decode kernel).  ``attend_local`` (a prefill from an
    empty cache, the static-batch loop's): the slab is written, and the
    attention runs over the fresh k / v alone, as the reference's.  With
    no ``cache`` (mode ``train``, ``cache_index`` 0) nothing is written and
    the attention is causal over the fresh k / v, as the reference's
    forward with ``cache=None``; with ``cfg.causal`` False (the audio
    encoder) it runs that way with every key allowed, and a cache raises.

    ``page_table`` [B, pages_per_slot] int64 (paged pools): ``cache`` is
    then a page arena [n_pages, page_size, Hk, Dh] per slab; the rows are
    written through the table and the attention reads each row's gathered
    virtual slab, the same bytes at the same [row, position] as a slab
    pool holds."""
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

    if cache is None:
        if per_row or cache_index != 0:
            raise ValueError("attention without a cache starts at "
                             "position 0")
        out = attend(q, k, v, causal=cfg.causal, q_offset=0,
                     kv_chunk=cfg.kv_chunk)
        return apply_linear(params["wo"], out.reshape(b, s, h * dh),
                            plain=plain)
    if not cfg.causal:
        raise ValueError("non-causal self-attention (the audio encoder) "
                         "runs without a cache")
    k_cache, v_cache = cache
    if per_row and s != 1:
        raise ValueError("per-row cache_index is the decode (S == 1) path")
    if page_table is not None:
        pos = positions.expand(b, s)
        cache_write_pages(k_cache, k, page_table, pos)
        cache_write_pages(v_cache, v, page_table, pos)
        k_cache = gather_pages(k_cache, page_table)
        v_cache = gather_pages(v_cache, page_table)
        valid = (pos[:, -1] + 1).to(torch.int32)
    elif per_row:
        rows = torch.arange(b, device=x.device)
        cache_write_rows(k_cache, k, rows, cache_index)
        cache_write_rows(v_cache, v, rows, cache_index)
        valid = (cache_index + s).to(torch.int32)
    else:
        cache_write_slice(k_cache, k, cache_index)
        cache_write_slice(v_cache, v, cache_index)
        valid = torch.full((b,), cache_index + s, dtype=torch.int32,
                           device=x.device)

    if attend_local:
        out = attend(q, k, v, q_offset=0, kv_chunk=cfg.kv_chunk)
    elif s == 1:
        out = fused_decode_attention(q, k_cache, v_cache, valid, plain=plain)
    else:
        out = attend(q, cache_read(k_cache), cache_read(v_cache),
                     q_offset=cache_index, kv_chunk=cfg.kv_chunk,
                     kv_valid_len=valid)
    return apply_linear(params["wo"], out.reshape(b, s, h * dh), plain=plain)


def cross_attn_forward(params: nn.ModuleDict, cfg: AttnConfig,
                       x: torch.Tensor, enc: torch.Tensor, *,
                       plain: bool = False) -> torch.Tensor:
    """x [B, Sq, D] attends over enc [B, Sk, D] (the audio decoder's
    cross-attention): q from x, k / v projected from ``enc`` at every call
    (the reference's: no cross K / V cache), no mask, no rope."""
    b, sq, _ = x.shape
    sk = enc.shape[1]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = apply_linear(params["wq"], x, plain=plain).reshape(b, sq, h, dh)
    k = apply_linear(params["wk"], enc, plain=plain).reshape(b, sk, hk, dh)
    v = apply_linear(params["wv"], enc, plain=plain).reshape(b, sk, hk, dh)
    out = attend(q, k, v, causal=False, kv_chunk=cfg.kv_chunk)
    return apply_linear(params["wo"], out.reshape(b, sq, h * dh),
                        plain=plain)


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLAConfig:
    n_heads: int
    q_lora: int          # query low-rank dim (0 = dense q projection)
    kv_lora: int         # compressed KV latent dim (the cached quantity)
    d_head_nope: int     # per-head non-rope dim
    d_head_rope: int     # shared rope dim
    d_head_v: int        # per-head value dim
    rope_theta: float = 10000.0
    kv_chunk: int = 512


def mla_params(mk: QuantMaker, cfg: MLAConfig, d_model: int,
               scheme: Optional[str]) -> dict:
    """One layer's MLA leaves, in the reference's walk order and under its
    names (``mla_params``); the two norms' f32 gammas as ``Norm`` leaves."""
    d, h = d_model, cfg.n_heads
    qk = h * (cfg.d_head_nope + cfg.d_head_rope)
    p = {"w_dkv": mk.dense("attn.w_dkv", d, cfg.kv_lora + cfg.d_head_rope,
                           scheme),
         "kv_norm": Norm(mk.norm("attn.kv_norm", cfg.kv_lora),
                         "attn.kv_norm"),
         "w_uk": mk.dense("attn.w_uk", cfg.kv_lora, h * cfg.d_head_nope,
                          scheme),
         "w_uv": mk.dense("attn.w_uv", cfg.kv_lora, h * cfg.d_head_v, scheme),
         "wo": mk.dense("attn.wo", h * cfg.d_head_v, d, scheme)}
    if cfg.q_lora:
        p["w_dq"] = mk.dense("attn.w_dq", d, cfg.q_lora, scheme)
        p["q_norm"] = Norm(mk.norm("attn.q_norm", cfg.q_lora),
                           "attn.q_norm")
        p["w_uq"] = mk.dense("attn.w_uq", cfg.q_lora, qk, scheme)
    else:
        p["w_uq"] = mk.dense("attn.w_uq", d, qk, scheme)
    return p


def _mla_queries(params: nn.ModuleDict, cfg: MLAConfig, x: torch.Tensor,
                 positions: torch.Tensor, plain: bool):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope] rotated)."""
    b, s, _ = x.shape
    if cfg.q_lora:
        cq = rms_norm(apply_linear(params["w_dq"], x, plain=plain),
                      params["q_norm"].weight)
        q = apply_linear(params["w_uq"], cq, plain=plain)
    else:
        q = apply_linear(params["w_uq"], x, plain=plain)
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head_nope + cfg.d_head_rope)
    q_nope, q_rope = q.split([cfg.d_head_nope, cfg.d_head_rope], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_forward(params: nn.ModuleDict, cfg: MLAConfig, x: torch.Tensor, *,
                cache: Tuple, cache_index, plain: bool = False,
                page_table: Optional[torch.Tensor] = None):
    """x [B, S, D] -> out [B, S, D]; writes the new latent and rope key
    into ``cache`` = (c_kv [B, Smax, kv_lora], k_rope [B, Smax, rope]) in
    place.  ``cache_index``: an int offset (a prefill chunk: S positions
    written there, K / V expanded over the slab) or a [B] tensor (decode,
    S == 1: row i writes and attends at its own length, absorbed).  Paged
    MLA pools are not ported: a ``page_table`` raises."""
    if page_table is not None:
        raise NotImplementedError("paged MLA pools are not ported: the "
                                  "latent cache is a slab")
    b, s, _ = x.shape
    per_row = torch.is_tensor(cache_index) and cache_index.dim() == 1
    if per_row and s != 1:
        raise ValueError("per-row cache_index is the decode (S == 1) path")
    steps = torch.arange(s, device=x.device)[None, :]
    positions = (cache_index[:, None] + steps) if per_row \
        else (cache_index + steps)                             # [B or 1, S]
    q_nope, q_rope = _mla_queries(params, cfg, x, positions, plain)

    ckr = apply_linear(params["w_dkv"], x, plain=plain)
    c_kv, k_rope = ckr.split([cfg.kv_lora, cfg.d_head_rope], dim=-1)
    c_kv = rms_norm(c_kv, params["kv_norm"].weight)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]

    c_cache, r_cache = cache
    if per_row:
        rows = torch.arange(b, device=x.device)
        cache_write_rows(c_cache, c_kv, rows, cache_index)
        cache_write_rows(r_cache, k_rope, rows, cache_index)
        valid = (cache_index + s).to(torch.int32)
    else:
        cache_write_slice(c_cache, c_kv, cache_index)
        cache_write_slice(r_cache, k_rope, cache_index)
        valid = torch.full((b,), cache_index + s, dtype=torch.int32,
                           device=x.device)
    if s == 1:
        out = _mla_decode_absorbed(params, cfg, q_nope, q_rope, c_cache,
                                   r_cache, valid)
    else:
        out = _mla_expanded(params, cfg, q_nope, q_rope, c_cache, r_cache,
                            valid, cache_index, plain)
    return apply_linear(params["wo"], out.reshape(b, s, -1), plain=plain)


def _mla_expanded(params, cfg: MLAConfig, q_nope, q_rope, c_kv, k_rope,
                  valid, q_off, plain: bool):
    """K / V expanded out of the latent slab per head (the shared rope key
    folded in as extra head dims), then ``attend`` with queries of nope +
    rope and values of d_head_v dims."""
    b, sk = c_kv.shape[0], c_kv.shape[1]
    h = cfg.n_heads
    k_nope = apply_linear(params["w_uk"], c_kv, plain=plain).reshape(
        b, sk, h, cfg.d_head_nope)
    v = apply_linear(params["w_uv"], c_kv, plain=plain).reshape(
        b, sk, h, cfg.d_head_v)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, sk, h, cfg.d_head_rope)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    return attend(q_full, k_full, v, q_offset=q_off, kv_chunk=cfg.kv_chunk,
                  kv_valid_len=valid)


def _mla_decode_absorbed(params, cfg: MLAConfig, q_nope, q_rope, c_kv,
                         k_rope, valid):
    """Absorbed decode: ``w_uk`` folded into the query, scores and values
    in latent space, ``w_uv`` applied on the way out; K / V are never
    expanded.  Each contraction is bf16 storage over f32 sums; the latent
    and rope scores are each rounded to bf16, added in f32 and scaled by
    an f32 1/sqrt(nope + rope) after the sum, as the reference does."""
    sk = c_kv.shape[1]
    h, lora = cfg.n_heads, cfg.kv_lora
    w_uk = _dense_bf16(params["w_uk"]).reshape(lora, h, cfg.d_head_nope)
    q_lat = _bf16_einsum("bqhd,lhd->bqhl", q_nope, w_uk)
    scale = 1.0 / torch.sqrt(torch.tensor(
        float(cfg.d_head_nope + cfg.d_head_rope), dtype=torch.float32,
        device=q_nope.device))
    s_lat = _bf16_einsum("bqhl,bkl->bhqk", q_lat, c_kv)
    s_rope = _bf16_einsum("bqhd,bkd->bhqk", q_rope, k_rope)
    s = (s_lat.to(torch.float32) + s_rope.to(torch.float32)) * scale
    kpos = torch.arange(sk, device=s.device)[None, None, None, :]
    s = torch.where(kpos < valid.to(s.device)[:, None, None, None], s,
                    torch.full((), _NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    o_lat = _bf16_einsum("bhqk,bkl->bqhl", p.to(torch.bfloat16), c_kv)
    w_uv = _dense_bf16(params["w_uv"]).reshape(lora, h, cfg.d_head_v)
    return _bf16_einsum("bqhl,lhd->bqhd", o_lat, w_uv)


def _dense_bf16(leaf: nn.Module) -> torch.Tensor:
    """A linear leaf's weight [K, N] as bf16 (a quantized leaf dequantized
    once and kept, ``QLinear.dense_bf16``)."""
    return leaf.dense_bf16() if isinstance(leaf, QLinear) else leaf.weight
