"""PrecisionPolicy — the part of ``repro/quant/policy.py`` the port reads.

``weights``: ordered (leaf-name glob, scheme) pairs, first match wins; an
unmatched leaf keeps its config default.  ``kv``: the KV-cache tier
('bf16' | 'int8' | 'fp8').  The reference's ``kernel`` field has no
counterpart: the port always runs its kernels on a CUDA device.

JSON form (``to_dict`` / ``to_json`` / ``from_dict`` / ``from_json``): the
reference's, so a policy file moves between the two packages.  The port
writes ``kernel`` as the reference's default, ``'auto'``, and on reading
checks it against the reference's modes and drops it.

Validation is eager: unknown names raise at construction, and
``validate_for(cfg)`` raises the config incompatibilities (a pattern that
matches no leaf, a K that the scheme's packing word or scale group does not
divide, a quantized KV tier on an MLA model or on a ``d_head`` not
divisible by 4).  The port
serves the packed schemes, w8a8 (raw int8 codes) and bf16.
"""
from __future__ import annotations

import dataclasses
import json
from fnmatch import fnmatchcase
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.configs import RECURRENT_FAMILIES

from .pack import codes_per_word
from .schemes import KV_SCHEMES, SCHEMES, effective_group, get_scheme

KV_TIERS = ("bf16",) + tuple(sorted(KV_SCHEMES))
# the reference's kernel routes, read from a policy file and dropped
KERNEL_MODES = ("auto", "jnp", "pallas")


def validate_kv_tier(tier, cfg=None) -> str:
    """Canonical tier name, validated (optionally against a config)."""
    name = "bf16" if tier is None else tier
    if name not in KV_TIERS:
        raise ValueError(
            f"unknown KV tier {tier!r}; valid tiers: {list(KV_TIERS)}")
    if cfg is not None and name != "bf16" and getattr(cfg, "use_mla", False):
        raise ValueError(
            f"kv tier {name!r}: KV quantization covers the GQA per-head "
            "cache; the MLA latent cache is already compressed and stays "
            "bf16 — use 'bf16' for MLA models")
    if cfg is not None and name != "bf16" and cfg.head_dim % 4:
        raise ValueError(
            f"kv tier {name!r}: d_head={cfg.head_dim} is not divisible by "
            "4 (quantized KV packs 4 codes per int32 word) — use 'bf16'")
    return name


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    weights: Tuple[Tuple[str, str], ...] = ()
    kv: str = "bf16"

    def __post_init__(self):
        w = self.weights
        if isinstance(w, Mapping):
            w = tuple(w.items())
        w = tuple((str(p), str(s)) for p, s in w)
        for pat, scheme in w:
            if scheme not in SCHEMES:
                raise ValueError(
                    f"policy weights[{pat!r}]: unknown scheme {scheme!r}; "
                    f"valid schemes: {sorted(SCHEMES)}")
        object.__setattr__(self, "weights", w)
        object.__setattr__(self, "kv", validate_kv_tier(self.kv))

    def resolve(self, name: str, default=None) -> str:
        for pat, scheme in self.weights:
            if fnmatchcase(name, pat):
                return scheme
        return default if default is not None else "bf16"

    def resolved_plan(self, cfg) -> Dict[str, str]:
        """{leaf name -> scheme} over every dense leaf of ``cfg``."""
        return {name: self.resolve(name, default)
                for name, (_, _, default) in leaf_info(cfg).items()}

    def validate_for(self, cfg) -> "PrecisionPolicy":
        info = leaf_info(cfg)
        for pat, _ in self.weights:
            if not any(fnmatchcase(n, pat) for n in info):
                raise ValueError(
                    f"policy weights pattern {pat!r} matches no leaf of "
                    f"{cfg.name!r}; leaves: {sorted(info)}")
        for name, (k, _, default) in info.items():
            scheme_name = self.resolve(name, default)
            if scheme_name == "bf16":
                continue
            s = get_scheme(scheme_name)
            if k % effective_group(s.group_size, k):
                raise ValueError(
                    f"policy: leaf {name!r} has K={k}, not divisible by "
                    f"{scheme_name!r}'s scale group {s.group_size}")
            if s.packed and k % codes_per_word(s.weight_bits):
                raise ValueError(
                    f"policy: leaf {name!r} has K={k}, not packable "
                    f"{codes_per_word(s.weight_bits)}-per-int32-word")
        validate_kv_tier(self.kv, cfg)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {"weights": [list(p) for p in self.weights],
                "kv": self.kv, "kernel": "auto"}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PrecisionPolicy":
        unknown = set(d) - {"weights", "kv", "kernel"}
        if unknown:
            raise ValueError(
                f"policy dict has unknown keys {sorted(unknown)}; "
                "expected {'weights', 'kv', 'kernel'}")
        kernel = d.get("kernel", "auto")
        if kernel not in KERNEL_MODES:
            raise ValueError(
                f"policy kernel={kernel!r}; valid modes: "
                f"{list(KERNEL_MODES)}")
        return cls(weights=tuple(tuple(p) for p in d.get("weights", ())),
                   kv=d.get("kv", "bf16"))

    @classmethod
    def from_json(cls, s: str) -> "PrecisionPolicy":
        return cls.from_dict(json.loads(s))


def leaf_info(cfg) -> Dict[str, Tuple[int, int, str]]:
    """{logical leaf name -> (K, N, config-default scheme)} of the families
    the port serves (dense: gated or non-gated FFN; MoE: GQA or MLA
    attention, a bf16 router and per-expert gated FFN stacks, each
    expert's leaf [K, N], and shared experts as one gated FFN under the
    ``ffn.*`` names; xLSTM's mLSTM / sLSTM and Zamba2's Mamba-2 leaves as
    ``ssm.*``, with the bf16 ``ssm.w_dt`` / ``ssm.w_if``, and Zamba2's
    shared block as ``attn.*`` / ``ffn.*``; the VLM's, the dense family's;
    the ``lm_head`` unless the embeddings are tied) — the names ``repro``'s Maker walk gives the same
    leaves, so a rule for ``ffn.*`` reaches the shared experts as it does
    there.  Where two leaves share a name (mLSTM's and sLSTM's
    ``ssm.w_out``), the later one's shape stands, as in the reference's
    walk."""
    d, h, hk, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    sp = cfg.scheme_proj or "bf16"
    sf = cfg.scheme_ffn or "bf16"
    if cfg.family in RECURRENT_FAMILIES:
        return _recurrent_leaf_info(cfg, sp, sf)
    if cfg.use_mla:
        qk = h * (cfg.d_head_nope + cfg.d_head_rope)
        info = {"attn.w_dkv": (d, cfg.kv_lora + cfg.d_head_rope, sp),
                "attn.w_uk": (cfg.kv_lora, h * cfg.d_head_nope, sp),
                "attn.w_uv": (cfg.kv_lora, h * cfg.d_head_v, sp),
                "attn.wo": (h * cfg.d_head_v, d, sp)}
        if cfg.q_lora:
            info.update({"attn.w_dq": (d, cfg.q_lora, sp),
                         "attn.w_uq": (cfg.q_lora, qk, sp)})
        else:
            info["attn.w_uq"] = (d, qk, sp)
    else:
        info = {"attn.wq": (d, h * dh, sp), "attn.wk": (d, hk * dh, sp),
                "attn.wv": (d, hk * dh, sp), "attn.wo": (h * dh, d, sp)}
    if cfg.n_experts:
        fe = cfg.moe_d_ff or f
        info.update({"moe.router": (d, cfg.n_experts, "bf16"),
                     "moe.w_gate": (d, fe, sf), "moe.w_up": (d, fe, sf),
                     "moe.w_down": (fe, d, sf)})
        if cfg.n_shared_experts:
            fs = fe * cfg.n_shared_experts
            info.update({"ffn.w_gate": (d, fs, sf), "ffn.w_up": (d, fs, sf),
                         "ffn.w_down": (fs, d, sf)})
    else:
        info.update(_ffn_info(cfg, sf))
    if not cfg.tie_embeddings:
        info["lm_head"] = (d, cfg.vocab, "bf16")
    return info


def _ffn_info(cfg, sf: str) -> Dict[str, Tuple[int, int, str]]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.gated_ffn:
        return {"ffn.w_gate": (d, f, sf), "ffn.w_up": (d, f, sf),
                "ffn.w_down": (f, d, sf)}
    return {"ffn.w_in": (d, f, sf), "ffn.w_out": (f, d, sf)}


def _recurrent_leaf_info(cfg, sp: str, sf: str):
    """The served recurrent configs (``check_supported``): tied, and an
    FFN only in Zamba2's shared block."""
    d, di = cfg.d_model, cfg.ssm_expand * cfg.d_model
    if cfg.family == "ssm":
        return {"ssm.w_up": (d, 2 * di, sp), "ssm.w_q": (di, di, sp),
                "ssm.w_k": (di, di, sp), "ssm.w_v": (di, di, sp),
                "ssm.w_if": (di, 2 * cfg.n_heads, "bf16"),
                # sLSTM's [D, D] (walked after mLSTM's [di, D])
                "ssm.w_out": (d, d, sp), "ssm.w_gates": (d, 4 * d, sp)}
    ds, nh = cfg.ssm_state, di // cfg.ssm_d_head
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    info = {"ssm.w_zx": (d, 2 * di, sp), "ssm.w_bc": (d, 2 * ds, sp),
            "ssm.w_dt": (d, nh, "bf16"), "ssm.w_out": (di, d, sp),
            "attn.wq": (d, h * dh, sp), "attn.wk": (d, hk * dh, sp),
            "attn.wv": (d, hk * dh, sp), "attn.wo": (h * dh, d, sp)}
    info.update(_ffn_info(cfg, sf))
    return info
