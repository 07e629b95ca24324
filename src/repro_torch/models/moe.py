"""Mixture-of-Experts with capacity dispatch (torch twin of
``repro/models/moe.py``, the serving path: no auxiliary loss).

Routing and dispatch follow the reference step for step, all on the
device (no host sync: no ``.item()``, no boolean-mask indexing, no
``unique``):
  * ``route``: router logits from the bf16 router (bf16-rounded, then
    f32), softmax, top-k with ties to the lower expert id (as
    ``jax.lax.top_k``; a stable descending sort, since ``torch.topk``
    leaves the order of ties unspecified), renormalised gates;
  * ``dispatch_ranks``: token-major ranks from a one-hot cumsum, ``keep =
    rank < capacity`` (GShard: a token ranked past an expert's capacity is
    dropped);
  * each batch row is its own routing group (the reference's
    ``moe_groups=None``), with the capacity taken from the row's padded
    length: a decode step's single token gets capacity 1 (drop-free); a
    64-token prefill chunk max(4, ceil(64 x 8 x 1.25 / 128)) = 5.

The expert FFN runs each leaf as ONE launch over groups of rows
(``kernels.ops.grouped_quantized_matmul``), in one of two layouts:
  * decode (S = 1): G = B x top_k (row, expert) pairs of one row each —
    the reference computes every expert of a row's [E, 1, D] buffer, but
    only the row's top-k are read back;
  * a prefill chunk (S > 1): G = B x E capacity buffers of C rows, expert
    e's buffer holding its kept tokens by rank, rows past its count zero
    (the kernels skip them, and a buffer with no token reads no weight).
The combine gathers each (token, k) slot's output, multiplies by its
gate (zero where dropped) in bf16 and sums over k, as ``_moe_group``.
Shared experts (DeepSeek-V2: always on, one gated FFN of
``n_shared_experts`` expert widths, leaves ``shared_gate`` / ``shared_up``
/ ``shared_down`` under the logical names ``ffn.w_*``) run on every token
through the packed linear kernels, and their output is added to the
combined routed output in bf16.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels.ops import grouped_quantized_matmul

from .common import QuantMaker, activate, apply_linear


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """What routing and the expert FFN read (the reference's
    ``MoEConfig``, whose gates every config renormalizes to sum 1)."""
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    n_shared_experts: int = 0


# the shared experts' leaves and their logical names (the reference's Maker
# walk names them as a dense gated FFN's)
SHARED_LEAVES = {"shared_gate": "ffn.w_gate", "shared_up": "ffn.w_up",
                 "shared_down": "ffn.w_down"}


def moe_cfg(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor,
                     activation=cfg.activation,
                     n_shared_experts=cfg.n_shared_experts)


def moe_params(mk: QuantMaker, cfg: ModelConfig) -> dict:
    """One layer's router (bf16 always), expert stacks and shared experts,
    in the reference's walk order and by its logical names."""
    d, f, e, s = (cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts,
                  cfg.scheme_ffn)
    p = {"router": mk.dense("moe.router", d, e, None),
         "w_gate": mk.dense("moe.w_gate", d, f, s, experts=e),
         "w_up": mk.dense("moe.w_up", d, f, s, experts=e),
         "w_down": mk.dense("moe.w_down", f, d, s, experts=e)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_gate"] = mk.dense("ffn.w_gate", d, fs, s)
        p["shared_up"] = mk.dense("ffn.w_up", d, fs, s)
        p["shared_down"] = mk.dense("ffn.w_down", fs, d, s)
    return p


def capacity(group_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert in a routing group of ``group_tokens`` tokens."""
    if group_tokens == 1:
        # a single token's top-k experts are distinct: every rank is 0
        return 1
    c = math.ceil(group_tokens * cfg.top_k * cfg.capacity_factor
                  / cfg.n_experts)
    return max(4, c)


class Routes:
    """The expert ids of every MoE call of a run, in call order (a
    diagnostic, like ``forward``'s ``layer_out``): recorded, or — built
    from a recorded run's ``ids`` — replayed, so that a second run takes
    the first run's experts (each with its own gates)."""

    def __init__(self, replay: Optional[List[torch.Tensor]] = None):
        self.replaying = replay is not None
        self.ids: List[torch.Tensor] = list(replay or [])
        self._next = 0

    def take(self, idx_fn):
        """The ids of the next call: replayed, or ``idx_fn()`` recorded."""
        if self.replaying:
            idx = self.ids[self._next]
            self._next += 1
            return idx
        idx = idx_fn()
        self.ids.append(idx)
        return idx


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, largest first, ties
    to the lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def route(x: torch.Tensor, router: nn.Module, cfg: MoEConfig, *,
          plain: bool = False, routes: Optional[Routes] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [..., D] -> gates [..., k] f32 (renormalized to sum 1), idx [...,
    k] int64, probs [..., E] f32 (``_route``)."""
    logits = apply_linear(router, x, out_dtype=torch.float32, plain=plain)
    probs = torch.softmax(logits, dim=-1)
    if routes is None:
        idx = top_k(probs, cfg.top_k)
    else:
        idx = routes.take(lambda: top_k(probs, cfg.top_k))
    gates = probs.gather(-1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def dispatch_ranks(idx: torch.Tensor, n_experts: int, cap: int):
    """idx [..., T, k] -> (flat_e, rank, keep), each [..., T k] token-major
    (``_dispatch_ranks``; ``...`` are independent routing groups)."""
    flat_e = idx.reshape(*idx.shape[:-2], -1)
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)    # [.., Tk, E]
    ranks = torch.cumsum(onehot, dim=-2) - onehot
    rank = ranks.gather(-1, flat_e[..., None])[..., 0]
    return flat_e, rank, rank < cap


def expert_ffn(p: nn.ModuleDict, cfg: MoEConfig, x: torch.Tensor,
               expert_idx: torch.Tensor, rows: torch.Tensor, *,
               plain: bool = False) -> torch.Tensor:
    """x [G, M, D] bf16 -> [G, M, D] bf16 through expert ``expert_idx[g]``'s
    gated FFN (``_expert_ffn``); rows past ``rows[g]`` come out zero."""
    def linear(name, h):
        return grouped_quantized_matmul(h, p[name], expert_idx, rows,
                                        plain=plain)

    g = linear("w_gate", x)
    u = linear("w_up", x)
    h = (activate(cfg.activation, g.to(torch.float32))
         * u.to(torch.float32)).to(torch.bfloat16)
    return linear("w_down", h)


def moe_forward(p: nn.ModuleDict, cfg: MoEConfig, x: torch.Tensor, *,
                plain: bool = False,
                routes: Optional[Routes] = None) -> torch.Tensor:
    """x [B, S, D] bf16 -> [B, S, D] bf16, each batch row its own routing
    group of S tokens; plus the shared experts' output where there are
    any."""
    y = _routed(p, cfg, x, plain=plain, routes=routes)
    if not cfg.n_shared_experts:
        return y
    g = apply_linear(p["shared_gate"], x, plain=plain)
    u = apply_linear(p["shared_up"], x, plain=plain)
    h = (activate(cfg.activation, g.to(torch.float32))
         * u.to(torch.float32)).to(torch.bfloat16)
    return y + apply_linear(p["shared_down"], h, plain=plain)


def _routed(p: nn.ModuleDict, cfg: MoEConfig, x: torch.Tensor, *,
            plain: bool, routes: Optional[Routes]) -> torch.Tensor:
    """The routed experts' combined output [B, S, D] bf16."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gates, idx, _ = route(x, p["router"], cfg, plain=plain, routes=routes)
    dev = x.device
    if s == 1:
        # capacity 1 holds each token's k distinct experts: every pair kept
        xg = x.expand(b, k, d).reshape(b * k, 1, d)
        rows = torch.ones((b * k,), dtype=torch.int32, device=dev)
        out = expert_ffn(p, cfg, xg, idx.reshape(-1).to(torch.int32), rows,
                         plain=plain)
        return combine(out.reshape(b, k, d), gates,
                       torch.ones((b, k), dtype=torch.bool, device=dev))
    cap = capacity(s, cfg)
    flat_e, rank, keep = dispatch_ranks(idx, e, cap)             # [B, S k]
    base = (torch.arange(b, device=dev)[:, None] * e + flat_e) * cap
    slot = base + torch.clamp(rank, max=cap - 1)
    # kept (expert, rank) slots are distinct; dropped tokens write a spare
    # row past the buffers
    dest = torch.where(keep, slot, torch.full_like(slot, b * e * cap))
    buf = torch.zeros((b * e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[dest.reshape(-1)] = x.repeat_interleave(k, dim=1).reshape(-1, d)
    count = torch.zeros((b, e), dtype=torch.int64, device=dev)
    count.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    rows = torch.clamp(count, max=cap).reshape(-1).to(torch.int32)
    experts = torch.arange(e, dtype=torch.int32, device=dev).repeat(b)
    out = expert_ffn(p, cfg, buf[:-1].view(b * e, cap, d), experts, rows,
                     plain=plain)
    y = out.reshape(b * e * cap, d)[slot.reshape(-1)].reshape(b, s * k, d)
    return combine(y, gates, keep)


def combine(out_rows: torch.Tensor, gates: torch.Tensor,
            keep: torch.Tensor) -> torch.Tensor:
    """out_rows [B, T k, D] bf16 (each (token, k) slot's expert output),
    gates [B, T, k] f32, keep [B, T k] -> [B, T, D]: each output times
    its gate (0 where dropped) in bf16, summed over k (``_moe_group``)."""
    b, tk, d = out_rows.shape
    k = gates.shape[-1]
    w = (gates.reshape(b, tk) * keep).to(torch.bfloat16)
    return (out_rows * w[..., None]).reshape(b, tk // k, k, d).sum(dim=2)
