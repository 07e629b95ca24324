"""PrecisionPolicy — the part of ``repro/quant/policy.py`` the port reads.

``weights``: ordered (leaf-name glob, scheme) pairs, first match wins; an
unmatched leaf keeps its config default.  ``kv``: the KV-cache tier
('bf16' | 'int8' | 'fp8').  The reference's ``kernel`` field has no
counterpart: the port always runs its kernels on a CUDA device.

Validation is eager: unknown names raise at construction, and
``validate_for(cfg)`` raises the config incompatibilities (a pattern that
matches no leaf, a K that the scheme's packing word or scale group does not
divide, a quantized KV tier on a ``d_head`` not divisible by 4).
"""
from __future__ import annotations

import dataclasses
from fnmatch import fnmatchcase
from typing import Dict, Mapping, Tuple

from .pack import codes_per_word
from .schemes import KV_SCHEMES, SCHEMES, effective_group, get_scheme

KV_TIERS = ("bf16",) + tuple(sorted(KV_SCHEMES))


def validate_kv_tier(tier, cfg=None) -> str:
    """Canonical tier name, validated (optionally against a config)."""
    name = "bf16" if tier is None else tier
    if name not in KV_TIERS:
        raise ValueError(
            f"unknown KV tier {tier!r}; valid tiers: {list(KV_TIERS)}")
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
            if not s.packed:
                raise ValueError(
                    f"policy: leaf {name!r} asks for {scheme_name!r}, which "
                    "the port does not serve yet (packed schemes and bf16)")
            if k % effective_group(s.group_size, k):
                raise ValueError(
                    f"policy: leaf {name!r} has K={k}, not divisible by "
                    f"{scheme_name!r}'s scale group {s.group_size}")
            if k % codes_per_word(s.weight_bits):
                raise ValueError(
                    f"policy: leaf {name!r} has K={k}, not packable "
                    f"{codes_per_word(s.weight_bits)}-per-int32-word")
        validate_kv_tier(self.kv, cfg)
        return self


def leaf_info(cfg) -> Dict[str, Tuple[int, int, str]]:
    """{logical leaf name -> (K, N, config-default scheme)} of the dense
    family the port serves (gated FFN, untied ``lm_head``) — the names
    ``repro``'s Maker walk gives the same leaves."""
    d, h, hk, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    sp = cfg.scheme_proj or "bf16"
    sf = cfg.scheme_ffn or "bf16"
    return {"attn.wq": (d, h * dh, sp), "attn.wk": (d, hk * dh, sp),
            "attn.wv": (d, hk * dh, sp), "attn.wo": (h * dh, d, sp),
            "ffn.w_gate": (d, f, sf), "ffn.w_up": (d, f, sf),
            "ffn.w_down": (f, d, sf), "lm_head": (d, cfg.vocab, "bf16")}
