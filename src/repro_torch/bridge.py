"""Parameter conversion between the JAX package's tree and the port.

``params_from_numpy(cfg, tree)`` takes the reference's dense-family
parameter tree with every array already converted to numpy (e.g.
``jax.tree_util.tree_map(np.asarray, params)``): a nested dict whose
layer leaves are stacked along a leading [L] axis, and whose quantized
leaves are objects with ``packed``, ``scales``, ``scheme_name``, ``shape``
and ``name`` attributes.  Packed int32 words and f32 scales are copied bit
for bit in the same ``[K/per, N]`` layout; bf16 arrays (numpy's
``bfloat16`` extension dtype) are copied by their 16-bit patterns.
``params_to_numpy`` is the inverse, returning quantized leaves as
``NumpyQLinear`` records and bf16 tensors as their int16 bit patterns
(numpy has no bfloat16 of its own).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.common import DenseLinear, QLinear
from repro_torch.models.transformer import Block, DenseLM, check_supported


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


def _leaf(leaf, layer: Optional[int], name: str, device):
    if hasattr(leaf, "packed"):
        pick = (lambda a: np.asarray(a)[layer]) if layer is not None \
            else np.asarray
        return QLinear(_tensor(pick(leaf.packed), device),
                       _tensor(pick(leaf.scales), device), leaf.scheme_name,
                       tuple(leaf.shape), getattr(leaf, "name", None) or name)
    w = np.asarray(leaf)
    return DenseLinear(_tensor(w[layer] if layer is not None else w, device),
                       name)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], *,
                      device="cuda") -> DenseLM:
    check_supported(cfg)
    lay = tree["layers"]
    layers = []
    for l in range(cfg.n_layers):
        attn = {k: _leaf(v, l, f"attn.{k}", device)
                for k, v in lay["attn"].items()}
        ffn = {k: _leaf(v, l, f"ffn.{k}", device)
               for k, v in lay["ffn"].items()}
        layers.append(Block(_tensor(np.asarray(lay["ln1"]["g"])[l], device),
                            attn,
                            _tensor(np.asarray(lay["ln2"]["g"])[l], device),
                            ffn))
    return DenseLM(_tensor(tree["embed"], device), layers,
                   _tensor(tree["ln_f"]["g"], device),
                   _leaf(tree["lm_head"], None, "lm_head", device))


def params_to_numpy(params: DenseLM) -> Dict[str, Any]:
    """The port's parameters as the reference's stacked numpy tree."""
    def leaf_of(mods):
        first = mods[0]
        if isinstance(first, QLinear):
            return NumpyQLinear(
                np.stack([_array(m.packed) for m in mods]),
                np.stack([_array(m.scales) for m in mods]),
                first.scheme_name, first.shape, first.name)
        return np.stack([_array(m.weight) for m in mods])

    blocks = list(params.layers)
    layers = {
        "ln1": {"g": np.stack([_array(b.ln1) for b in blocks])},
        "attn": {k: leaf_of([b.attn[k] for b in blocks])
                 for k in blocks[0].attn},
        "ln2": {"g": np.stack([_array(b.ln2) for b in blocks])},
        "ffn": {k: leaf_of([b.ffn[k] for b in blocks]) for k in blocks[0].ffn},
    }
    head = params.lm_head
    lm_head = NumpyQLinear(_array(head.packed), _array(head.scales),
                           head.scheme_name, head.shape, head.name) \
        if isinstance(head, QLinear) else _array(head.weight)
    return {"embed": _array(params.embed),
            "ln_f": {"g": _array(params.ln_f)},
            "lm_head": lm_head, "layers": layers}
