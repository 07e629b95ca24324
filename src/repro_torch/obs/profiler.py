"""Model-vs-measured profiler (torch twin of ``repro/obs/profiler.py``):
each dispatch's wall joined to the paper's analytical model
(``perfmodel/analytical.py``), and ``step_cost``, the static count of a
decode step's FLOPs and bytes.

The analytical model prices what a decode step of a given shape (cohort
rows, mean context, KV bytes a position at the pool's tier) costs on the
paper's V80 FPGA; the profiler records what each dispatch took on the
scheduler's host wall, and ``report()`` joins the two into a
model / measured ratio per step shape and per KV tier.  The model seconds
are the FPGA's, not a figure for the card the port runs on: the ratio's
signal is relative (across tiers and shapes).  Recording only appends a
tuple; the model is priced in ``report()``, memoized per shape.  With the
same records the report is the reference's byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.models.common import DenseLinear, QLinear
from repro_torch.perfmodel.analytical import (_DEPLOY, decode_latency,
                                              gemv_engine_for)


@dataclasses.dataclass(frozen=True)
class _DecodeRec:
    tier: str
    k: int                 # planned burst length (token-steps)
    rows: int              # cohort rows of the dispatch
    context: int           # the cohort's mean committed context
    kv_bytes_per_token: int
    wall_s: float


@dataclasses.dataclass(frozen=True)
class _PrefillRec:
    tier: str
    n_tokens: int          # tokens the chunk wrote
    wall_s: float


class StepProfiler:
    """Join each dispatch's wall to the analytical model.

    ``design`` is the deployment priced ('xtramac' or 'vendor');
    ``scheme`` defaults to the config's projection scheme and falls back
    to 'w8a8' where the model has no deployment for it (the report says
    so in ``scheme_fallback``).  The MACs are priced on the
    channel-streaming GEMV engine of the scheme (``gemv_engine_for``), as
    the reference's default.  The walls are the scheduler's (its clock
    pair around each dispatch)."""

    def __init__(self, cfg, *, design: str = "xtramac",
                 scheme: Optional[str] = None):
        self.cfg = cfg
        self.design = design
        want = scheme or cfg.scheme_proj or "w8a8"
        self.scheme = want if want in _DEPLOY else "w8a8"
        self.scheme_fallback = self.scheme != want
        self.engine_model = gemv_engine_for(self.scheme)
        self._decode: List[_DecodeRec] = []
        self._prefill: List[_PrefillRec] = []
        self._model_memo: Dict = {}

    def record_decode(self, *, tier: str, k: int, rows: int, context: int,
                      kv_bytes_per_token: int, wall_s: float) -> None:
        self._decode.append(_DecodeRec(tier, int(k), int(rows),
                                       int(context), int(kv_bytes_per_token),
                                       float(wall_s)))

    def record_prefill(self, *, tier: str, n_tokens: int,
                       wall_s: float) -> None:
        self._prefill.append(_PrefillRec(tier, int(n_tokens), float(wall_s)))

    @property
    def n_records(self) -> int:
        return len(self._decode) + len(self._prefill)

    def _model_step_s(self, rows: int, context: int,
                      kv_bytes_per_token: int) -> float:
        """The model's seconds for one decode token-step of this shape."""
        key = (rows, context, kv_bytes_per_token)
        t = self._model_memo.get(key)
        if t is None:
            t = decode_latency(
                self.cfg, self.scheme, batch=max(rows, 1),
                context=max(context, 1), design=self.design,
                kv_bytes_per_token=kv_bytes_per_token,
                engine_model=self.engine_model)["t_total_s"]
            self._model_memo[key] = t
        return t

    def report(self) -> Dict:
        """Dispatches grouped by (kind, tier, K, rows), model against
        measured; ``per_tier`` sums the decode dispatches of each tier.
        Prefill groups are measured only (``model_s`` None: the model
        covers decode)."""
        groups: Dict = {}
        for r in self._decode:
            g = groups.setdefault(("decode", r.tier, r.k, r.rows), {
                "kind": "decode", "tier": r.tier, "k": r.k, "rows": r.rows,
                "n": 0, "measured_s": 0.0, "model_s": 0.0, "_ctx": 0})
            g["n"] += 1
            g["measured_s"] += r.wall_s
            g["model_s"] += r.k * self._model_step_s(
                r.rows, r.context, r.kv_bytes_per_token)
            g["_ctx"] += r.context
        for r in self._prefill:
            g = groups.setdefault(("prefill", r.tier, r.n_tokens), {
                "kind": "prefill_chunk", "tier": r.tier,
                "n_tokens": r.n_tokens, "n": 0, "measured_s": 0.0,
                "model_s": None})
            g["n"] += 1
            g["measured_s"] += r.wall_s

        rows = []
        for key in sorted(groups, key=str):
            g = dict(groups[key])
            ctx = g.pop("_ctx", None)
            if ctx is not None:
                g["context_mean"] = round(ctx / g["n"], 1)
            g["measured_s"] = round(g["measured_s"], 6)
            if g["model_s"] is not None:
                g["model_s"] = round(g["model_s"], 9)
                g["model_over_measured"] = (
                    round(g["model_s"] / g["measured_s"], 6)
                    if g["measured_s"] > 0 else None)
            rows.append(g)

        per_tier: Dict[str, Dict] = {}
        for r in self._decode:
            t = per_tier.setdefault(r.tier, {"dispatches": 0,
                                             "token_steps": 0,
                                             "measured_s": 0.0,
                                             "model_s": 0.0})
            t["dispatches"] += 1
            t["token_steps"] += r.k
            t["measured_s"] += r.wall_s
            t["model_s"] += r.k * self._model_step_s(
                r.rows, r.context, r.kv_bytes_per_token)
        for t in per_tier.values():
            t["measured_s"] = round(t["measured_s"], 6)
            t["model_s"] = round(t["model_s"], 9)
            t["model_over_measured"] = (
                round(t["model_s"] / t["measured_s"], 6)
                if t["measured_s"] > 0 else None)

        eng = self.engine_model
        return {"design": self.design, "scheme": self.scheme,
                "scheme_fallback": self.scheme_fallback,
                "mac_pricing": {
                    "weight_bits": eng.weight_bits,
                    "lanes_quant": eng.macs_per_cycle,
                    "hbm_utilization": eng.hbm_utilization},
                "groups": rows,
                "per_tier": {k: per_tier[k] for k in sorted(per_tier)}}


def step_cost(engine, pool, k: int = 1,
              context: Optional[int] = None) -> Dict:
    """FLOPs and bytes of one decode dispatch over every slot of ``pool``
    (``k`` > 1: a burst of k token-steps), counted from the model's leaves
    and the pool's geometry; nothing on the serving path is tallied.

    ``flops``: 2 x result elements x contracted length over every matrix
    product of a token-step (each linear leaf, the lm_head, and attention's
    q.k and p.v over ``context`` positions a row and head), the definition
    of the reference's ``compiled_step_cost`` (``launch/hlo_analysis.py``),
    whose decode program attends over the slab's whole capacity: the
    default ``context``.  ``hbm_bytes`` is the port's own count of a
    token-step's device-memory traffic: every parameter buffer but the
    embedding table once (packed words, scales, norms, the lm_head), the
    embedding rows gathered, ``context`` positions of KV read a row at the
    pool's bytes a position (scales included), one position written a
    row, and the f32 logits written by the head and read by the sampler.
    Activations between kernels are not counted.  One card: no collective
    bytes.  Counts the dense family; a MoE or MLA model raises."""
    cfg = engine.cfg
    if cfg.family != "dense" or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: step_cost counts the dense decoder's step "
            "(family 'dense', GQA attention)")
    n = pool.n_slots
    ctx = pool.capacity if context is None else int(context)
    paged = bool(pool.paged)
    linear_macs = 0
    for mod in engine.params.modules():
        if isinstance(mod, QLinear):
            kk, nn = mod.shape
            linear_macs += kk * nn
        elif isinstance(mod, DenseLinear):
            kk, nn = mod.weight.shape
            linear_macs += kk * nn
    attn_macs = 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * ctx
    flops_row = 2.0 * (linear_macs + attn_macs)
    weight_bytes = sum(b.numel() * b.element_size()
                       for name, b in engine.params.named_buffers()
                       if name != "embed")
    embed = engine.params.embed
    bpt = pool.bytes_per_token
    bytes_step = (weight_bytes
                  + n * cfg.d_model * embed.element_size()
                  + n * ctx * bpt + n * bpt
                  + 2 * n * cfg.vocab * 4)
    steps = k * n
    flops = flops_row * steps
    hbm_bytes = float(bytes_step * k)
    return {"k": k, "n_slots": n, "kv_dtype": pool.kv_dtype,
            "paged": paged, **({"n_pages": pool.n_pages} if paged else {}),
            "context": ctx, "flops": flops, "hbm_bytes": hbm_bytes,
            "collective_bytes": 0.0,
            "flops_per_token_step": round(flops / steps, 1),
            "hbm_bytes_per_token_step": round(hbm_bytes / steps, 1)}
