"""Parameter conversion between the JAX package's tree and the port.

``params_from_numpy(cfg, tree)`` takes the reference's dense- or
MoE-family parameter tree with every array already converted to numpy
(e.g. ``jax.tree_util.tree_map(np.asarray, params)``): a nested dict whose
layer leaves are stacked along a leading [L] axis (expert stacks along
[L, E]), and whose quantized leaves are objects with ``packed``,
``scales``, ``scheme_name``, ``shape`` and ``name`` attributes.  MLA
layers carry ``w_dq``, ``q_norm``, ``w_uq``, ``w_dkv``, ``kv_norm``,
``w_uk``, ``w_uv`` and ``wo`` (the norms' gammas go across as f32
``Norm`` leaves), MoE layers with shared experts ``shared_gate`` /
``shared_up`` / ``shared_down``.  Packed int32 words and f32 scales are
copied bit for bit in the same ``[K/per, N]`` layout, w8a8's raw int8
codes bit for bit from ``[K, N]`` (``QLinear`` keeps them transposed);
bf16 arrays (numpy's ``bfloat16`` extension dtype) are copied by their
16-bit patterns.  The recurrent families' trees go across as well:
xLSTM's ``mlstm`` leaves stacked [g, per-1, ...] and ``slstm`` leaves
[g, ...] (``r_gates`` [g, 4, nh, dh, dh]) with their ``mlstm_ln`` /
``slstm_ln`` gammas, and Zamba2's ``mamba`` leaves [L, ...] with
``mamba_ln`` and the unstacked ``shared_attn`` block; a key starting
``w_`` is a linear leaf, any other a table, vector or norm.  A tied model
(the VLM, the audio model) has no ``lm_head`` on either side.  The audio
tree (whisper) holds ``enc_layers`` [Le] and ``dec_layers`` [Ld] blocks
(a decoder block adds ``ln_x`` and the cross-attention ``xattn``), the
position tables ``enc_pos`` / ``dec_pos`` and ``enc_ln_f``; its every norm
is a LayerNorm ``{"g", "b"}``, both carried across (``common.Norm`` with
a bias).  A key the reader does not map (a norm's ``b`` where the family
has RMS norms, an unknown leaf or table) raises ValueError: nothing is
dropped.
``params_to_numpy`` is the inverse, returning quantized leaves as
``NumpyQLinear`` records and bf16 tensors as their int16 bit patterns
(numpy has no bfloat16 of its own).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import RECURRENT_FAMILIES, ModelConfig
from repro_torch.models.common import DenseLinear, Norm, QLinear
from repro_torch.models.moe import SHARED_LEAVES
from repro_torch.models.ssm import Leaves
from repro_torch.models.transformer import (AudioBlock, Block, DenseLM,
                                            EncDecLM, RecurrentBlock,
                                            RecurrentLM, check_supported)


@dataclasses.dataclass
class NumpyQLinear:
    packed: np.ndarray
    scales: np.ndarray
    scheme_name: str
    shape: Tuple[int, int]
    name: Optional[str] = None


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _check_keys(tree: Dict[str, Any], allowed, where: str) -> None:
    """Raise on a key of ``tree`` the reader does not map."""
    unknown = sorted(set(tree) - set(allowed))
    if unknown:
        raise ValueError(f"{where}: no mapping for {unknown} (the reader "
                         f"maps {sorted(allowed)})")


def _gamma(ln: Dict[str, Any], where: str):
    """An RMS norm's gamma, from its ``{"g": ...}`` dict."""
    _check_keys(ln, ("g",), where)
    return ln["g"]


def _leaf(leaf, layer: Optional[int], name: str, device):
    if name.endswith("_norm"):
        return Norm(_tensor(np.asarray(leaf)[layer], device), name)
    if hasattr(leaf, "packed"):
        pick = (lambda a: np.asarray(a)[layer]) if layer is not None \
            else np.asarray
        return QLinear(_tensor(pick(leaf.packed), device),
                       _tensor(pick(leaf.scales), device), leaf.scheme_name,
                       tuple(leaf.shape), getattr(leaf, "name", None) or name)
    w = np.asarray(leaf)
    return DenseLinear(_tensor(w[layer] if layer is not None else w, device),
                       name)


def _recurrent_block(block: Dict[str, Any], ln, idx, device):
    """One recurrent block at stack index ``idx`` of the reference's
    stacked block dict and its norm gamma."""
    leaves = {k: (_leaf(v, idx, f"ssm.{k}", device) if k.startswith("w_")
                  else _tensor(np.asarray(v)[idx], device))
              for k, v in block.items()}
    return RecurrentBlock(_tensor(np.asarray(_gamma(ln, "a recurrent "
                                                    "norm"))[idx], device),
                          Leaves(leaves))


def _block_from_numpy(tree: Dict[str, Any], layer, device) -> Block:
    """A transformer block (at ``layer`` of the stacks, or unstacked with
    ``layer`` None)."""
    def pick(a):
        return np.asarray(a) if layer is None else np.asarray(a)[layer]

    mlp = "moe" if "moe" in tree else "ffn"
    _check_keys(tree, ("ln1", "attn", "ln2", mlp), "a transformer block")
    attn = {k: _leaf(v, layer, f"attn.{k}", device)
            for k, v in tree["attn"].items()}
    ffn = {k: _leaf(v, layer, SHARED_LEAVES.get(k, f"{mlp}.{k}"), device)
           for k, v in tree[mlp].items()}
    return Block(_tensor(pick(_gamma(tree["ln1"], "ln1")), device), attn,
                 _tensor(pick(_gamma(tree["ln2"], "ln2")), device),
                 **{mlp: ffn})


def _layer_norm(ln: Dict[str, Any], layer, name: str, device) -> Norm:
    """A LayerNorm leaf (gamma ``g`` and beta ``b``) at ``layer`` of its
    stack (unstacked with ``layer`` None)."""
    _check_keys(ln, ("g", "b"), name)
    pick = np.asarray if layer is None else (lambda a: np.asarray(a)[layer])
    return Norm(_tensor(pick(ln["g"]), device), name,
                bias=_tensor(pick(ln["b"]), device))


def _audio_block(tree: Dict[str, Any], layer: int, device) -> AudioBlock:
    """An encoder block, or with ``ln_x`` / ``xattn`` a decoder block, at
    ``layer`` of the stacks; the cross-attention leaves keep the
    reference's ``attn.*`` names."""
    _check_keys(tree, ("ln1", "attn", "ln_x", "xattn", "ln2", "ffn"),
                "an audio block")

    def leaves(group, prefix):
        return {k: _leaf(v, layer, f"{prefix}.{k}", device)
                for k, v in tree[group].items()}

    cross = {}
    if "xattn" in tree or "ln_x" in tree:
        cross = {"ln_x": _layer_norm(tree["ln_x"], layer, "ln_x", device),
                 "xattn": leaves("xattn", "attn")}
    return AudioBlock(_layer_norm(tree["ln1"], layer, "ln1", device),
                      leaves("attn", "attn"),
                      _layer_norm(tree["ln2"], layer, "ln2", device),
                      leaves("ffn", "ffn"), **cross)


def _audio_from_numpy(cfg: ModelConfig, tree, device) -> EncDecLM:
    _check_keys(tree, ("embed", "ln_f", "enc_layers", "enc_pos", "enc_ln_f",
                       "dec_layers", "dec_pos"), "the audio tree")
    le = cfg.encoder_layers
    return EncDecLM(
        _tensor(tree["embed"], device),
        [_audio_block(tree["enc_layers"], l, device) for l in range(le)],
        _tensor(tree["enc_pos"], device),
        _layer_norm(tree["enc_ln_f"], None, "enc_ln_f", device),
        [_audio_block(tree["dec_layers"], l, device)
         for l in range(cfg.n_layers - le)],
        _tensor(tree["dec_pos"], device),
        _layer_norm(tree["ln_f"], None, "ln_f", device))


def _recurrent_from_numpy(cfg: ModelConfig, tree, device) -> RecurrentLM:
    blocks = ("mlstm", "mlstm_ln", "slstm", "slstm_ln") \
        if cfg.family == "ssm" else ("mamba", "mamba_ln", "shared_attn")
    _check_keys(tree, ("embed", "ln_f") + blocks, f"the {cfg.family} tree")
    embed = _tensor(tree["embed"], device)
    ln_f = _tensor(_gamma(tree["ln_f"], "ln_f"), device)
    if cfg.family == "ssm":
        g, per = cfg.n_layers // cfg.slstm_every, cfg.slstm_every
        mlstm = [_recurrent_block(tree["mlstm"], tree["mlstm_ln"], (gi, j),
                                  device)
                 for gi in range(g) for j in range(per - 1)]
        slstm = [_recurrent_block(tree["slstm"], tree["slstm_ln"], gi, device)
                 for gi in range(g)]
        return RecurrentLM("ssm", embed, ln_f, mlstm=mlstm, slstm=slstm)
    mamba = [_recurrent_block(tree["mamba"], tree["mamba_ln"], l, device)
             for l in range(cfg.n_layers)]
    return RecurrentLM("hybrid", embed, ln_f, mamba=mamba,
                       shared_attn=_block_from_numpy(tree["shared_attn"],
                                                     None, device))


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], *,
                      device="cuda"):
    check_supported(cfg)
    if cfg.family in RECURRENT_FAMILIES:
        return _recurrent_from_numpy(cfg, tree, device)
    if cfg.family == "audio":
        return _audio_from_numpy(cfg, tree, device)
    _check_keys(tree, ("embed", "ln_f", "layers")
                + (() if cfg.tie_embeddings else ("lm_head",)),
                f"the {cfg.family} tree")
    layers = [_block_from_numpy(tree["layers"], l, device)
              for l in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings \
        else _leaf(tree["lm_head"], None, "lm_head", device)
    return DenseLM(_tensor(tree["embed"], device), layers,
                   _tensor(_gamma(tree["ln_f"], "ln_f"), device), head)


def _leaf_of(mods, lead=None):
    """Leaves of several layers stacked (reshaped to ``lead`` + their own
    shape when given)."""
    def stack(arrays):
        a = np.stack(arrays)
        return a if lead is None else a.reshape(lead + a.shape[1:])

    first = mods[0]
    if isinstance(first, QLinear):
        return NumpyQLinear(stack([_array(m.reference_codes()) for m in mods]),
                            stack([_array(m.scales) for m in mods]),
                            first.scheme_name, first.shape, first.name)
    if isinstance(first, torch.Tensor):
        return stack([_array(m) for m in mods])
    return stack([_array(m.weight) for m in mods])


def _blocks_to_numpy(blocks, lead=None) -> Dict[str, Any]:
    """Transformer blocks as the reference's stacked block dict (one block
    unstacked when ``lead`` is ())."""
    mlp = "moe" if hasattr(blocks[0], "moe") else "ffn"
    return {
        "ln1": {"g": _leaf_of([b.ln1 for b in blocks], lead)},
        "attn": {k: _leaf_of([b.attn[k] for b in blocks], lead)
                 for k in blocks[0].attn},
        "ln2": {"g": _leaf_of([b.ln2 for b in blocks], lead)},
        mlp: {k: _leaf_of([getattr(b, mlp)[k] for b in blocks], lead)
              for k in getattr(blocks[0], mlp)},
    }


def _norm_to_numpy(norms, lead=None) -> Dict[str, Any]:
    """``Norm`` leaves as the reference's ``{"g"[, "b"]}`` dict."""
    out = {"g": _leaf_of([n.weight for n in norms], lead)}
    if norms[0].bias is not None:
        out["b"] = _leaf_of([n.bias for n in norms], lead)
    return out


def _audio_to_numpy(params: EncDecLM) -> Dict[str, Any]:
    def blocks(mods):
        out = {"ln1": _norm_to_numpy([b.ln1 for b in mods]),
               "attn": {k: _leaf_of([b.attn[k] for b in mods])
                        for k in mods[0].attn},
               "ln2": _norm_to_numpy([b.ln2 for b in mods]),
               "ffn": {k: _leaf_of([b.ffn[k] for b in mods])
                       for k in mods[0].ffn}}
        if mods[0].xattn is not None:
            out["ln_x"] = _norm_to_numpy([b.ln_x for b in mods])
            out["xattn"] = {k: _leaf_of([b.xattn[k] for b in mods])
                            for k in mods[0].xattn}
        return out

    return {"embed": _array(params.embed),
            "ln_f": _norm_to_numpy([params.ln_f], ()),
            "enc_layers": blocks(list(params.enc_layers)),
            "enc_pos": _array(params.enc_pos),
            "enc_ln_f": _norm_to_numpy([params.enc_ln_f], ()),
            "dec_layers": blocks(list(params.dec_layers)),
            "dec_pos": _array(params.dec_pos)}


def _recurrent_to_numpy(params: RecurrentLM) -> Dict[str, Any]:
    def blocks(mods, lead):
        return ({k: _leaf_of([m.p[k] for m in mods], lead)
                 for k in mods[0].p.names},
                {"g": _leaf_of([m.ln1 for m in mods], lead)})

    out = {"embed": _array(params.embed), "ln_f": {"g": _array(params.ln_f)}}
    if params.family == "ssm":
        g = len(params.slstm)
        out["mlstm"], out["mlstm_ln"] = blocks(
            list(params.mlstm), (g, len(params.mlstm) // g))
        out["slstm"], out["slstm_ln"] = blocks(list(params.slstm), None)
        return out
    out["mamba"], out["mamba_ln"] = blocks(list(params.mamba), None)
    out["shared_attn"] = _blocks_to_numpy([params.shared_attn], ())
    return out


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's parameters as the reference's stacked numpy tree."""
    if isinstance(params, RecurrentLM):
        return _recurrent_to_numpy(params)
    if isinstance(params, EncDecLM):
        return _audio_to_numpy(params)
    out = {"embed": _array(params.embed), "ln_f": {"g": _array(params.ln_f)},
           "layers": _blocks_to_numpy(list(params.layers))}
    head = params.lm_head
    if head is not None:
        out["lm_head"] = NumpyQLinear(
            _array(head.reference_codes()), _array(head.scales),
            head.scheme_name, head.shape, head.name) \
            if isinstance(head, QLinear) else _array(head.weight)
    return out
