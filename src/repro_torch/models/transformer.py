"""The model families: parameters, forward, cache (torch twin of
``repro/models/transformer.py``).  Dense and MoE models are a ``DenseLM``
(a MoE block holds ``moe`` — router, expert stacks and any shared experts,
``models/moe.py`` — in place of ``ffn``; with ``use_mla`` the block's
attention is DeepSeek-V2's latent attention, ``attention.mla_forward``).
The recurrent families are a ``RecurrentLM`` with tied embeddings:
xLSTM (``ssm``: groups of ``slstm_every - 1`` mLSTM blocks and one sLSTM
block) and Zamba2 (``hybrid``: Mamba-2 blocks with ONE shared attention +
FFN block applied after every ``attn_every`` of them, each application
with its own KV slab), ``models/ssm.py``.  The VLM (``vlm``) is a dense
GQA ``DenseLM`` with tied embeddings (no ``lm_head``: the logits are
``tied_logits`` over the embedding table) whose prompt starts with
``n_patches`` precomputed patch embeddings (``patches`` [B, Np, D], the
stub of the vision frontend's output), put before the token embeddings.
The audio family (``audio``, whisper) is an ``EncDecLM`` with tied
embeddings and LayerNorms with a bias (``common.Norm`` leaves): its
encoder runs ``encoder_layers`` non-causal blocks over ``frames`` [B,
n_frames, D] (the stub of the conv frontend's output) plus the learned
``enc_pos``, then ``enc_ln_f``; its decoder blocks add a cross-attention
over the encoder output (``attention.cross_attn_forward``) between the
self-attention and the FFN, the tokens at learned positions ``dec_pos``.

``forward`` runs the reference's serving modes as a loop over layers:
  * ``prefill_chunk`` (dense / MoE) — S new positions written at an int
    ``cache_index``; attention over the cache (earlier chunks are already
    there); logits for every chunk position;
  * ``prefill`` (the static-batch families: recurrent, VLM and audio) — a
    whole prompt (the VLM's patches first; the audio model's encoder over
    its frames first, its output written into the cache) from an empty
    cache at index 0, attention over the fresh k / v; logits of the last
    position only;
  * ``decode`` — one token per row: a [B] ``cache_index`` (every pool slot
    at its own length; dense / MoE) or an int (every row at that length;
    the static-batch loop: for the VLM, positions go on after the patch
    prefix; the audio decoder cross-attends over the cached encoder
    output), attention through the fused decode kernel;
  * ``train`` (dense, VLM and audio) — no cache: causal attention over the
    sequence's own k / v and logits for every position (the VLM's cover
    patches + tokens; the audio model runs its encoder first), the
    reference's ``cache=None`` forward that ``ServingEngine.score`` reads.

The dense / MoE cache is ``(k, v)``: stacked per-layer slabs [L, B, Smax,
Hk, Dh] (bf16 or ``QuantizedKV``), written in place (MLA: ``(c_kv,
k_rope)``, bf16 [L, B, Smax, kv_lora] and [L, B, Smax, d_head_rope]); with a
``page_table`` [B, pages_per_slot], page arenas [L, n_pages, page_size,
Hk, Dh] instead (paged pools, GQA only: each layer writes through the
table and reads the gathered virtual slabs).  The recurrent caches are
the reference's trees of stacked tensors, written in place: xLSTM
``{"mlstm": {"state": SSMState [g, per-1, B, ...], "conv": [g, per-1, B,
W-1, di]}, "slstm": SLSTMState [g, B, D]}``; Zamba2 ``{"groups": {"mamba":
{"state": SSMState [g, per, B, ...], "conv": (x, bc) [g, per, B, W-1,
...]}, "attn": (k, v) [g, B, Smax, Hk, Dh]}, "tail": {"state", "conv"}
[rem, ...]}`` (states f32, conv states bf16, KV slabs at the tier).  The
audio cache is ``{"enc": bf16 [B, n_frames, D], "dec": (k, v) [L_dec, B,
Smax, Hk, Dh]}``, the encoder output written by the prefill in place.
``plain=True`` runs every kernel's plain version instead (the on-card
reference for the kernels).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

from repro_torch.configs import (RECURRENT_FAMILIES, STATIC_BATCH_FAMILIES,
                                 ModelConfig)
from repro_torch.quant.kv_cache import kv_dtype_name, kv_slab

from . import attention as A
from . import moe as MOE
from . import ssm as S
from .common import (Norm, QuantMaker, activate, apply_linear, apply_norm,
                     rms_norm, tied_logits)

MODES = ("prefill_chunk", "prefill", "decode", "train")
# rows of the audio decoder's learned position table (the reference's
# ``dec_pos``)
DEC_POSITIONS = 32768


def attn_cfg(cfg: ModelConfig) -> A.AttnConfig:
    return A.AttnConfig(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
                        use_rope=cfg.use_rope, kv_chunk=cfg.kv_chunk)


def mla_cfg(cfg: ModelConfig) -> A.MLAConfig:
    return A.MLAConfig(n_heads=cfg.n_heads, q_lora=cfg.q_lora,
                       kv_lora=cfg.kv_lora, d_head_nope=cfg.d_head_nope,
                       d_head_rope=cfg.d_head_rope, d_head_v=cfg.d_head_v,
                       rope_theta=cfg.rope_theta, kv_chunk=cfg.kv_chunk)


def mamba_cfg(cfg: ModelConfig) -> S.Mamba2Config:
    return S.Mamba2Config(d_model=cfg.d_model, d_state=cfg.ssm_state,
                          d_head=cfg.ssm_d_head, expand=cfg.ssm_expand,
                          chunk=cfg.ssm_chunk, scheme=cfg.scheme_proj)


def mlstm_cfg(cfg: ModelConfig) -> S.MLSTMConfig:
    return S.MLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                         expand=cfg.ssm_expand, chunk=cfg.ssm_chunk,
                         scheme=cfg.scheme_proj)


def slstm_cfg(cfg: ModelConfig) -> S.SLSTMConfig:
    return S.SLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                         scheme=cfg.scheme_proj)


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family in RECURRENT_FAMILIES:
        _check_recurrent(cfg)
        return
    if cfg.family == "vlm":
        _check_vlm(cfg)
        return
    if cfg.family == "audio":
        _check_audio(cfg)
        return
    ffn = (cfg.gated_ffn, cfg.activation)
    moe = cfg.family == "moe" and cfg.n_experts > 0 and cfg.top_k > 0
    if (cfg.family not in ("dense", "moe") or (cfg.family == "moe") != moe
            or cfg.norm != "rms" or cfg.tie_embeddings
            or ffn not in ((True, "silu"), (False, "relu2"), (False, "gelu"))
            or (moe and ffn != (True, "silu"))):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense family with RMS norm, a "
            "gated SiLU or non-gated squared-ReLU / GELU FFN, and the MoE "
            "family with gated SiLU experts (routed, and shared where the "
            "config has them), both with GQA or MLA attention and an "
            "untied lm_head")


def _check_vlm(cfg: ModelConfig) -> None:
    """The VLM as the reference builds it: a dense GQA stack with tied
    embeddings and a gated SiLU FFN."""
    if (cfg.norm != "rms" or not cfg.tie_embeddings or cfg.n_experts
            or cfg.use_mla or cfg.n_patches <= 0
            or (cfg.gated_ffn, cfg.activation) != (True, "silu")):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the VLM family as a dense GQA "
            "model with RMS norm, a gated SiLU FFN, tied embeddings and a "
            "patch prefix (n_patches > 0)")


def _check_audio(cfg: ModelConfig) -> None:
    """The audio encoder-decoder as the reference builds it: LayerNorms,
    GQA self-attention, learned positions, tied embeddings."""
    ffn = (cfg.gated_ffn, cfg.activation)
    if (cfg.norm != "layer" or not cfg.tie_embeddings or cfg.use_rope
            or cfg.n_experts or cfg.use_mla or cfg.n_frames <= 0
            or not 0 < cfg.encoder_layers < cfg.n_layers
            or ffn not in ((True, "silu"), (False, "relu2"),
                           (False, "gelu"))):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the audio family as an encoder-"
            "decoder with LayerNorm, GQA attention at learned positions (no "
            "rope), a dense FFN, tied embeddings, n_frames > 0 and 0 < "
            "encoder_layers < n_layers")


def _check_recurrent(cfg: ModelConfig) -> None:
    ssm = cfg.family == "ssm"
    if (cfg.norm != "rms" or not cfg.tie_embeddings or cfg.n_experts
            or cfg.use_mla
            or (ssm and (cfg.d_ff or cfg.n_layers % cfg.slstm_every))
            or (not ssm
                and (cfg.gated_ffn, cfg.activation) != (True, "silu"))):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the recurrent families with RMS "
            "norm and tied embeddings: xLSTM (ssm) with no separate FFN and "
            "whole groups of slstm_every blocks, and Zamba2 (hybrid) with a "
            "GQA + gated SiLU FFN shared block")


class Block(nn.Module):
    """One transformer block: RMS norm, attention (GQA, or MLA's leaves),
    RMS norm, then the FFN (``ffn``) or the MoE layer (``moe``: router,
    expert stacks, shared experts)."""

    def __init__(self, ln1, attn: dict, ln2, ffn: Optional[dict] = None,
                 moe: Optional[dict] = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block holds an FFN or a MoE layer")
        self.register_buffer("ln1", ln1)
        self.attn = nn.ModuleDict(attn)
        self.register_buffer("ln2", ln2)
        if moe is None:
            self.ffn = nn.ModuleDict(ffn)
        else:
            self.moe = nn.ModuleDict(moe)


class DenseLM(nn.Module):
    """Parameters of a model: embedding, blocks, final norm, head (None
    with tied embeddings: the VLM)."""

    def __init__(self, embed, layers, ln_f, lm_head: Optional[nn.Module]):
        super().__init__()
        self.register_buffer("embed", embed)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("ln_f", ln_f)
        self.lm_head = lm_head


class RecurrentLM(nn.Module):
    """Parameters of a recurrent-family model (tied embeddings: no
    lm_head).  xLSTM: ``mlstm`` [g (per-1)] and ``slstm`` [g] blocks,
    group-major; Zamba2: ``mamba`` [L] blocks and the one ``shared_attn``
    ``Block``.  Each recurrent block is a ``RecurrentBlock``."""

    def __init__(self, family: str, embed, ln_f, *, mlstm=(), slstm=(),
                 mamba=(), shared_attn: Optional[Block] = None):
        super().__init__()
        self.family = family
        self.register_buffer("embed", embed)
        self.register_buffer("ln_f", ln_f)
        self.mlstm = nn.ModuleList(mlstm)
        self.slstm = nn.ModuleList(slstm)
        self.mamba = nn.ModuleList(mamba)
        self.shared_attn = shared_attn


class RecurrentBlock(nn.Module):
    """A pre-norm recurrent block: the RMS gamma ``ln1`` and the leaves
    ``p`` (``ssm.Leaves``)."""

    def __init__(self, ln1, p: S.Leaves):
        super().__init__()
        self.register_buffer("ln1", ln1)
        self.p = p


class AudioBlock(nn.Module):
    """One block of the audio encoder-decoder: LayerNorm leaves
    (``common.Norm`` with a beta) ``ln1``, ``ln2`` and, in a decoder
    block, ``ln_x``; the self-attention ``attn``, the decoder's
    cross-attention ``xattn`` (None in an encoder block) and the FFN."""

    def __init__(self, ln1: Norm, attn: dict, ln2: Norm, ffn: dict,
                 ln_x: Optional[Norm] = None, xattn: Optional[dict] = None):
        super().__init__()
        if (ln_x is None) != (xattn is None):
            raise ValueError("a decoder block holds ln_x and xattn together")
        self.ln1 = ln1
        self.attn = nn.ModuleDict(attn)
        self.ln_x = ln_x
        self.xattn = None if xattn is None else nn.ModuleDict(xattn)
        self.ln2 = ln2
        self.ffn = nn.ModuleDict(ffn)


class EncDecLM(nn.Module):
    """Parameters of the audio encoder-decoder (tied embeddings: no
    lm_head): the token ``embed``, ``enc_layers`` (``AudioBlock``s), the
    learned ``enc_pos`` [n_frames, D], ``enc_ln_f``, ``dec_layers``
    (``AudioBlock``s with cross-attention), ``dec_pos`` [DEC_POSITIONS, D]
    and ``ln_f``; the tables bf16, the norms ``common.Norm`` leaves."""

    def __init__(self, embed, enc_layers, enc_pos, enc_ln_f: Norm,
                 dec_layers, dec_pos, ln_f: Norm):
        super().__init__()
        self.register_buffer("embed", embed)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.register_buffer("enc_pos", enc_pos)
        self.enc_ln_f = enc_ln_f
        self.dec_layers = nn.ModuleList(dec_layers)
        self.register_buffer("dec_pos", dec_pos)
        self.ln_f = ln_f


def _attn_params(cfg: ModelConfig, mk: QuantMaker) -> dict:
    d, h, hk, dh, sp = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.scheme_proj)
    return {"wq": mk.dense("attn.wq", d, h * dh, sp),
            "wk": mk.dense("attn.wk", d, hk * dh, sp),
            "wv": mk.dense("attn.wv", d, hk * dh, sp),
            "wo": mk.dense("attn.wo", h * dh, d, sp)}


def _ffn_params(cfg: ModelConfig, mk: QuantMaker) -> dict:
    d, f, sf = cfg.d_model, cfg.d_ff, cfg.scheme_ffn
    if cfg.gated_ffn:
        return {"w_gate": mk.dense("ffn.w_gate", d, f, sf),
                "w_up": mk.dense("ffn.w_up", d, f, sf),
                "w_down": mk.dense("ffn.w_down", f, d, sf)}
    return {"w_in": mk.dense("ffn.w_in", d, f, sf),
            "w_out": mk.dense("ffn.w_out", f, d, sf)}


def _build_recurrent(cfg: ModelConfig, mk: QuantMaker) -> RecurrentLM:
    """The reference's walk order: embed, ln_f, then the family's blocks
    (xLSTM: the mLSTM blocks group by group, then the sLSTM blocks;
    Zamba2: the Mamba blocks, then the shared block)."""
    d = cfg.d_model
    embed = mk.table("embed", cfg.vocab, d)
    ln_f = mk.norm("ln_f", d)
    if cfg.family == "ssm":
        g = cfg.n_layers // cfg.slstm_every
        mlstm = [RecurrentBlock(mk.norm("ln1", d),
                                S.mlstm_params(mk, mlstm_cfg(cfg)))
                 for _ in range(g * (cfg.slstm_every - 1))]
        slstm = [RecurrentBlock(mk.norm("ln1", d),
                                S.slstm_params(mk, slstm_cfg(cfg)))
                 for _ in range(g)]
        return RecurrentLM("ssm", embed, ln_f, mlstm=mlstm, slstm=slstm)
    mamba = [RecurrentBlock(mk.norm("ln1", d),
                            S.mamba2_params(mk, mamba_cfg(cfg)))
             for _ in range(cfg.n_layers)]
    shared = Block(mk.norm("ln1", d), _attn_params(cfg, mk),
                   mk.norm("ln2", d), _ffn_params(cfg, mk))
    return RecurrentLM("hybrid", embed, ln_f, mamba=mamba,
                       shared_attn=shared)


def _layer_norm(mk: QuantMaker, name: str, d: int) -> Norm:
    """A LayerNorm leaf: gamma ``name`` (ones) and beta ``name.b`` (zeros),
    as the reference's ``_norm_params`` makes them."""
    return Norm(mk.norm(name, d), name, bias=mk.vector(name + ".b", d))


def _build_audio(cfg: ModelConfig, mk: QuantMaker) -> EncDecLM:
    """The reference's walk order: embed, ln_f, the encoder blocks,
    enc_pos, enc_ln_f, the decoder blocks, dec_pos; a block's leaves in
    the order ln1, attn, (ln_x, xattn,) ln2, ffn."""
    d = cfg.d_model
    embed = mk.table("embed", cfg.vocab, d)
    ln_f = _layer_norm(mk, "ln_f", d)

    def block(cross: bool) -> AudioBlock:
        ln1, attn = _layer_norm(mk, "ln1", d), _attn_params(cfg, mk)
        xattn = {}
        if cross:
            xattn = {"ln_x": _layer_norm(mk, "ln_x", d),
                     "xattn": _attn_params(cfg, mk)}
        ln2 = _layer_norm(mk, "ln2", d)
        return AudioBlock(ln1, attn, ln2, _ffn_params(cfg, mk), **xattn)

    enc = [block(False) for _ in range(cfg.encoder_layers)]
    enc_pos = mk.table("enc_pos", cfg.n_frames, d)
    enc_ln_f = _layer_norm(mk, "enc_ln_f", d)
    dec = [block(True) for _ in range(cfg.n_layers - cfg.encoder_layers)]
    dec_pos = mk.table("dec_pos", DEC_POSITIONS, d)
    return EncDecLM(embed, enc, enc_pos, enc_ln_f, dec, dec_pos, ln_f)


def linear_leaves(params: nn.Module):
    """(logical name, leaf) of every linear leaf of a parameter module,
    by its place in the tree: the shared experts under their ``ffn.*``
    names, the recurrent blocks' leaves as ``ssm.*``, the audio decoder's
    cross-attention leaves as ``attn.*`` (the reference's names for them);
    norms and tables are no linear leaves."""
    if isinstance(params, EncDecLM):
        for blk in (*params.enc_layers, *params.dec_layers):
            for group, prefix in (("attn", "attn"), ("xattn", "attn"),
                                  ("ffn", "ffn")):
                for name, leaf in (getattr(blk, group) or {}).items():
                    yield f"{prefix}.{name}", leaf
        return
    if isinstance(params, RecurrentLM):
        for blk in (*params.mlstm, *params.slstm, *params.mamba):
            for name, leaf in blk.p.items():
                if isinstance(leaf, nn.Module):
                    yield f"ssm.{name}", leaf
        blocks = [params.shared_attn] if params.shared_attn is not None \
            else []
    else:
        if params.lm_head is not None:
            yield "lm_head", params.lm_head
        blocks = params.layers
    for blk in blocks:
        for group in ("attn", "ffn", "moe"):
            for name, leaf in getattr(blk, group, {}).items():
                if not isinstance(leaf, Norm):
                    yield MOE.SHARED_LEAVES.get(name, f"{group}.{name}"), leaf


def build_params(cfg: ModelConfig, mk: QuantMaker) -> nn.Module:
    """Walk the family's leaves (same logical names as the reference's
    Maker walk) with ``mk``, one layer at a time."""
    check_supported(cfg)
    if cfg.family in RECURRENT_FAMILIES:
        return _build_recurrent(cfg, mk)
    if cfg.family == "audio":
        return _build_audio(cfg, mk)
    d = cfg.d_model
    embed = mk.table("embed", cfg.vocab, d)
    layers = []
    for _ in range(cfg.n_layers):
        attn = A.mla_params(mk, mla_cfg(cfg), d, cfg.scheme_proj) \
            if cfg.use_mla else _attn_params(cfg, mk)
        if cfg.family == "moe":
            layers.append(Block(mk.norm("ln1", d), attn, mk.norm("ln2", d),
                                moe=MOE.moe_params(mk, cfg)))
        else:
            layers.append(Block(mk.norm("ln1", d), attn, mk.norm("ln2", d),
                                _ffn_params(cfg, mk)))
    ln_f = mk.norm("ln_f", d)
    lm_head = None if cfg.tie_embeddings \
        else mk.dense("lm_head", d, cfg.vocab, None)
    return DenseLM(embed, layers, ln_f, lm_head)


def _ffn(cfg: ModelConfig, p: nn.ModuleDict, x, plain: bool):
    if not cfg.gated_ffn:
        # the reference keeps the non-gated activation in bf16
        h = activate(cfg.activation, apply_linear(p["w_in"], x, plain=plain))
        return apply_linear(p["w_out"], h.to(torch.bfloat16), plain=plain)
    g = apply_linear(p["w_gate"], x, plain=plain)
    u = apply_linear(p["w_up"], x, plain=plain)
    h = (activate(cfg.activation, g.to(torch.float32))
         * u.to(torch.float32)).to(torch.bfloat16)
    return apply_linear(p["w_down"], h, plain=plain)


def _logits(cfg: ModelConfig, params, x, plain: bool):
    x = apply_norm(params.ln_f, x) if cfg.norm == "layer" \
        else rms_norm(x, params.ln_f)
    if cfg.tie_embeddings:                  # the reference's einsum
        return tied_logits(x, params.embed)
    return apply_linear(params.lm_head, x, out_dtype=torch.float32,
                        plain=plain)


def forward(cfg: ModelConfig, params: DenseLM, tokens: torch.Tensor, *,
            cache, cache_index, mode: str, need_logits: bool = True,
            plain: bool = False, page_table: Optional[torch.Tensor] = None,
            layer_out: Optional[list] = None,
            routes: Optional[MOE.Routes] = None,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """tokens [B, S] -> logits [B, S, V] f32 (None when ``need_logits`` is
    False: the lm-head is skipped).  ``cache`` is updated in place (None in
    mode ``train``).  ``patches`` [B, Np, D] (the VLM's prefill and train
    modes, and only there) go before the token embeddings as bf16, so the
    prefill writes Np + S positions and the train logits cover Np + S.
    ``frames`` [B, n_frames, D] (the audio model's prefill and train
    modes, and only there) are its encoder's input; a decode step reads
    the encoder output the prefill left in the cache.  A ``layer_out``
    list gets the residual stream [B, S, D] after every layer appended
    (the audio model's: after every decoder layer; a diagnostic:
    ``launch/logit_spread.py``); ``routes`` (MoE)
    records every layer's expert ids, or replays those it holds (a
    diagnostic: ``chip_smoke.py`` holds the kernel path to the plain path
    on the kernel path's routes)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; the port runs {MODES}")
    if mode == "train" and (cfg.family not in ("dense", "vlm", "audio")
                            or cfg.use_mla):
        raise NotImplementedError(
            f"{cfg.name}: mode 'train' runs the dense GQA, VLM and audio "
            "families; "
            "the reference's MoE train mode (routing with capacity drops) "
            "and the recurrent families' (scans from a zero state) are not "
            "ported")
    if (patches is not None) != (cfg.family == "vlm"
                                 and mode in ("prefill", "train")):
        raise ValueError(
            "patches go with the VLM's 'prefill' and 'train' modes and "
            "nowhere else: a VLM decode step continues after the patch "
            "prefix already in the cache")
    if (frames is not None) != (cfg.family == "audio"
                                and mode in ("prefill", "train")):
        raise ValueError(
            "frames go with the audio model's 'prefill' and 'train' modes "
            "and nowhere else: an audio decode step reads the encoder "
            "output already in the cache")
    if (cache is None) != (mode == "train"):
        raise ValueError("mode 'train' runs without a cache, every other "
                         "mode with one")
    if cfg.family in RECURRENT_FAMILIES:
        if mode == "prefill_chunk" or page_table is not None \
                or routes is not None:
            raise ValueError(
                f"{cfg.name}: the recurrent families run 'prefill' from an "
                "empty cache and 'decode' at an int index (the static-batch "
                "loop), without page tables or routes")
        return _forward_recurrent(cfg, params, tokens, cache, cache_index,
                                  mode, need_logits, plain, layer_out)
    static = cfg.family in STATIC_BATCH_FAMILIES
    if mode == "prefill" and not static:
        raise ValueError("mode 'prefill' is the static-batch families' "
                         "prefill; dense / MoE models run 'prefill_chunk'")
    if mode == "prefill_chunk" and static:
        raise ValueError(f"{cfg.name}: a static-batch family runs the "
                         "static-batch loop's 'prefill' from an empty "
                         "cache, not a slot pool's 'prefill_chunk'")
    if cfg.family == "audio":
        if page_table is not None or routes is not None:
            raise ValueError(f"{cfg.name}: the audio model runs without "
                             "page tables or routes")
        return _forward_audio(cfg, params, tokens, cache, cache_index, mode,
                              need_logits, plain, layer_out, frames)
    if cfg.use_mla:
        acfg, attention = mla_cfg(cfg), A.mla_forward
    else:
        acfg, attention = attn_cfg(cfg), A.gqa_forward
    if mode == "prefill":
        if cache_index != 0:
            raise ValueError("a static-batch prefill starts from an empty "
                             "cache at index 0")
        attention = functools.partial(attention, attend_local=True)
    mcfg = MOE.moe_cfg(cfg) if cfg.family == "moe" else None
    x = params.embed[tokens].to(torch.bfloat16)
    if patches is not None:
        x = torch.cat([patches.to(torch.bfloat16), x], dim=1)
    for l, blk in enumerate(params.layers):
        x = _block(cfg, blk, x, acfg, attention, mcfg,
                   cache=None if cache is None else (cache[0][l],
                                                     cache[1][l]),
                   cache_index=cache_index, plain=plain,
                   page_table=page_table, routes=routes)
        if layer_out is not None:
            layer_out.append(x)
    if mode == "prefill":       # the loop reads the last position only
        x = x[:, -1:]
    return _logits(cfg, params, x, plain) if need_logits else None


def _block(cfg: ModelConfig, blk: Block, x, acfg, attention, mcfg, *, cache,
           cache_index, plain: bool, page_table=None, routes=None):
    """One transformer block: x + attention(norm(x)), then + FFN / MoE."""
    h = rms_norm(x, blk.ln1)
    x = x + attention(blk.attn, acfg, h, cache=cache, cache_index=cache_index,
                      plain=plain, page_table=page_table)
    h = rms_norm(x, blk.ln2)
    if mcfg is not None:
        return x + MOE.moe_forward(blk.moe, mcfg, h, plain=plain,
                                   routes=routes)
    return x + _ffn(cfg, blk.ffn, h, plain)


def _audio_block(cfg: ModelConfig, blk: AudioBlock, x, acfg, attention, *,
                 cache, cache_index, enc, plain: bool):
    """x + self-attention(LN(x)); in a decoder block + cross-attention
    (LN(x)) over ``enc``; then + FFN(LN(x))."""
    h = apply_norm(blk.ln1, x)
    x = x + attention(blk.attn, acfg, h, cache=cache, cache_index=cache_index,
                      plain=plain)
    if blk.xattn is not None:
        x = x + A.cross_attn_forward(blk.xattn, acfg, apply_norm(blk.ln_x, x),
                                     enc, plain=plain)
    return x + _ffn(cfg, blk.ffn, apply_norm(blk.ln2, x), plain)


def _forward_audio(cfg: ModelConfig, params: EncDecLM, tokens, cache,
                   cache_index, mode: str, need_logits: bool, plain: bool,
                   layer_out: Optional[list], frames):
    """The reference's ``_forward_audio``.  Modes ``train`` and
    ``prefill`` run the encoder over ``frames`` (+ ``enc_pos``, bf16),
    ``encoder_layers`` non-causal blocks, then ``enc_ln_f``; a prefill
    writes its output into ``cache["enc"]``, and a decode step reads it
    there.  The decoder: tokens at ``dec_pos[index : index + S]`` (index 0
    but in decode), causal blocks with cross-attention over the encoder
    output; a prefill attends over its own k / v and returns the logits of
    the last position only."""
    if mode == "prefill" and cache_index != 0:
        raise ValueError("an audio prefill starts from an empty cache at "
                         "index 0")
    if mode == "decode" and torch.is_tensor(cache_index):
        raise ValueError("an audio decode step runs every row at one int "
                         "index (the static-batch loop)")
    acfg = attn_cfg(cfg)
    if mode == "decode":
        enc = cache["enc"]
    else:
        ecfg = dataclasses.replace(acfg, causal=False)
        enc = frames.to(torch.bfloat16) \
            + params.enc_pos[None, :frames.shape[1]].to(torch.bfloat16)
        for blk in params.enc_layers:
            enc = _audio_block(cfg, blk, enc, ecfg, A.gqa_forward, cache=None,
                               cache_index=0, enc=None, plain=plain)
        enc = apply_norm(params.enc_ln_f, enc)
        if cache is not None:
            cache["enc"].copy_(enc)
    s = tokens.shape[1]
    base = cache_index if mode == "decode" else 0
    x = params.embed[tokens].to(torch.bfloat16) \
        + params.dec_pos[None, base:base + s].to(torch.bfloat16)
    attention = functools.partial(A.gqa_forward,
                                  attend_local=mode == "prefill")
    for l, blk in enumerate(params.dec_layers):
        x = _audio_block(cfg, blk, x, acfg, attention,
                         cache=None if cache is None else (
                             cache["dec"][0][l], cache["dec"][1][l]),
                         cache_index=cache_index, enc=enc, plain=plain)
        if layer_out is not None:
            layer_out.append(x)
    if mode == "prefill":
        x = x[:, -1:]
    return _logits(cfg, params, x, plain) if need_logits else None


def _forward_recurrent(cfg: ModelConfig, params: RecurrentLM, tokens, cache,
                       cache_index, mode: str, need_logits: bool,
                       plain: bool, layer_out: Optional[list]):
    """The xLSTM / Zamba2 stack over ``cache`` (updated in place); a
    prefill returns the logits of the last position only."""
    if mode == "prefill" and cache_index != 0:
        raise ValueError("a recurrent prefill starts from an empty cache at "
                         "index 0")
    if mode == "decode" and (tokens.shape[1] != 1 or torch.is_tensor(
            cache_index) and cache_index.dim()):
        raise ValueError("a recurrent decode step takes one token a row at "
                         "an int index")
    x = params.embed[tokens].to(torch.bfloat16)
    run = _forward_xlstm if cfg.family == "ssm" else _forward_zamba
    x = run(cfg, params, x, cache, cache_index, mode, plain, layer_out)
    if mode == "prefill":
        x = x[:, -1:]
    if not need_logits:
        return None
    return tied_logits(rms_norm(x, params.ln_f), params.embed)


def _recurrent_block(fn, bcfg, blk: RecurrentBlock, x, cache: dict, idx,
                     plain: bool):
    """x + fn(norm(x)) for an mLSTM or Mamba-2 block, its state and conv
    state read from ``cache`` at ``idx`` and written back in place."""
    state = S.SSMState(*(a[idx] for a in cache["state"]))
    conv = cache["conv"]
    conv_in = tuple(a[idx] for a in conv) if isinstance(conv, tuple) \
        else conv[idx]
    out, (new_state, new_conv) = fn(blk.p, bcfg, rms_norm(x, blk.ln1),
                                    state=state, conv_state=conv_in,
                                    plain=plain)
    for a, v in zip(cache["state"], new_state):
        a[idx].copy_(v)
    if isinstance(conv, tuple):
        for a, v in zip(conv, new_conv):
            a[idx].copy_(v)
    else:
        conv[idx].copy_(new_conv)
    return x + out


def _forward_xlstm(cfg, params, x, cache, cache_index, mode, plain,
                   layer_out):
    """g groups of (per - 1) mLSTM blocks then one sLSTM block."""
    per = cfg.slstm_every
    mc, sc = mlstm_cfg(cfg), slstm_cfg(cfg)
    for gi in range(cfg.n_layers // per):
        for j in range(per - 1):
            x = _recurrent_block(S.mlstm_forward, mc,
                                 params.mlstm[gi * (per - 1) + j], x,
                                 cache["mlstm"], (gi, j), plain)
            if layer_out is not None:
                layer_out.append(x)
        blk, st = params.slstm[gi], cache["slstm"]
        out, new = S.slstm_forward(blk.p, sc, rms_norm(x, blk.ln1),
                                   state=S.SLSTMState(*(a[gi] for a in st)),
                                   plain=plain)
        for a, v in zip(st, new):
            a[gi].copy_(v)
        x = x + out
        if layer_out is not None:
            layer_out.append(x)
    return x


def _forward_zamba(cfg, params, x, cache, cache_index, mode, plain,
                   layer_out):
    """g groups of ``attn_every`` Mamba-2 blocks, each group followed by
    the shared block over the group's own KV slab; then the remaining
    Mamba-2 blocks with no attention."""
    per = cfg.attn_every
    g, rem = divmod(cfg.n_layers, per)
    mc, acfg = mamba_cfg(cfg), attn_cfg(cfg)
    attention = functools.partial(A.gqa_forward,
                                  attend_local=mode == "prefill")
    groups = cache["groups"]
    k_all, v_all = groups["attn"]
    for gi in range(g):
        for j in range(per):
            x = _recurrent_block(S.mamba2_forward, mc,
                                 params.mamba[gi * per + j], x,
                                 groups["mamba"], (gi, j), plain)
            if layer_out is not None:
                layer_out.append(x)
        x = _block(cfg, params.shared_attn, x, acfg, attention, None,
                   cache=(k_all[gi], v_all[gi]), cache_index=cache_index,
                   plain=plain)
        if layer_out is not None:
            layer_out.append(x)
    for r in range(rem):
        x = _recurrent_block(S.mamba2_forward, mc, params.mamba[g * per + r],
                             x, cache["tail"], (r,), plain)
        if layer_out is not None:
            layer_out.append(x)
    return x


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               kv_dtype="bf16", device="cuda"):
    """Zeroed (k, v) cache: stacked slabs [L, batch, max_len, Hk, Dh] at
    ``kv_dtype`` ('bf16' | 'int8' | 'fp8').  MLA: the latent cache (c_kv
    [L, batch, max_len, kv_lora], k_rope [L, batch, max_len,
    d_head_rope]), bf16 only (``mla_cache_spec``).  The recurrent
    families: the trees of the module docstring (the hybrid's KV slabs at
    ``kv_dtype``, recurrent state in its own dtypes).  The VLM's is the
    dense one, ``max_len`` counting the patch prefix too.  The audio
    model's: ``{"enc": bf16 [batch, n_frames, D], "dec": (k, v) [L_dec,
    batch, max_len, Hk, Dh]}``, the decoder's slabs at ``kv_dtype``."""
    if cfg.family in RECURRENT_FAMILIES:
        return _recurrent_cache(cfg, batch, max_len, kv_dtype, device)
    if cfg.family == "audio":
        shape = (cfg.n_layers - cfg.encoder_layers, batch, max_len,
                 cfg.n_kv_heads, cfg.head_dim)
        return {"enc": torch.zeros((batch, cfg.n_frames, cfg.d_model),
                                   dtype=torch.bfloat16, device=device),
                "dec": (kv_slab(shape, kv_dtype, device),
                        kv_slab(shape, kv_dtype, device))}
    if cfg.use_mla:
        if kv_dtype_name(kv_dtype) != "bf16":
            raise ValueError(
                f"kv_dtype={kv_dtype!r}: KV quantization covers the GQA "
                "per-head cache; the MLA latent cache is already compressed "
                "(kv_lora per token) and stays bf16")
        lead = (cfg.n_layers, batch, max_len)
        return (kv_slab(lead + (cfg.kv_lora,), "bf16", device),
                kv_slab(lead + (cfg.d_head_rope,), "bf16", device))
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (kv_slab(shape, kv_dtype, device), kv_slab(shape, kv_dtype, device))


def _recurrent_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype,
                     device) -> dict:
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def recurrent(lead, states, conv):
        conv = tuple(zeros(lead + c, torch.bfloat16) for c in conv) \
            if isinstance(conv[0], tuple) else zeros(lead + conv,
                                                     torch.bfloat16)
        return {"state": S.SSMState(*(zeros(lead + sh, torch.float32)
                                      for sh in states)), "conv": conv}

    if cfg.family == "ssm":
        g = cfg.n_layers // cfg.slstm_every
        return {"mlstm": recurrent((g, cfg.slstm_every - 1),
                                   *S.mlstm_state_shapes(mlstm_cfg(cfg),
                                                         batch)),
                "slstm": S.SLSTMState(*(
                    zeros((g,) + sh, torch.float32)
                    for sh in S.slstm_state_shapes(slstm_cfg(cfg), batch)))}
    g, rem = divmod(cfg.n_layers, cfg.attn_every)
    shapes = S.mamba2_state_shapes(mamba_cfg(cfg), batch)
    kv = (g, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"groups": {"mamba": recurrent((g, cfg.attn_every), *shapes),
                       "attn": (kv_slab(kv, kv_dtype, device),
                                kv_slab(kv, kv_dtype, device))},
            "tail": recurrent((rem,), *shapes)}
