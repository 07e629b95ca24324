"""Speculative decoding with low-precision drafts (torch twin of
``repro/serve/spec.py``).

A draft engine runs the target's own weights under an aggressive KV tier
(int8 by default) and proposes K tokens a row; one target dispatch
verifies the window [last, d_1..d_K] and the host emits the longest
agreeing prefix plus the target's own next sample.

**The contract**: every emitted token equals the plain decode's token bit
for bit, greedy and seeded temperature rows, slab and paged pools, at any
acceptance rate.  The draft samples its own logits with the request's real
per-(id, n_generated) keys; the verify samples the target's token g_j at
every window position j with the same keys, as S = K+1 chained decode
steps (``ServingEngine.verify_slots``), each the plain step's body.  The
host emits g_0..g_m, m the longest prefix with g_{j-1} == d_j: each
emitted g_j was sampled by the target from a context of emitted tokens,
with the key a plain step would have used.  A fully rejected round still
emits g_0, the plain step's token.

**Rollback** is a length: the verify writes S positions of target KV and
the host commits ``lengths[slot] += n_emit``.  The positions past it are
masked by the valid length at every later read and overwritten by the
slot's next writes, as a burst's frozen rows are; on a paged pool the
scheduler pins the S-wide window first (``ensure_decode(slots, S,
rems)``).

**Draft KV**: one slab pool per target tier, slot ids mirrored.  The
draft burst writes draft KV for inputs [last, d_1..d_{K-1}], which on the
accepted prefix are the committed tokens, so setting the draft's lengths
to the target's rolls it back.  A fully accepted round (the bonus token's
position was never drafted) and plain or prefill rounds while the draft
sat idle leave a deficit; ``catch_up`` closes it by replaying the
committed tokens through the draft's prefill chunks (KV only, no host
sync).

**K controller** (``SpecPlanner``): an acceptance EMA walks K along a
power-of-two ladder; a collapse at K = 1 falls back to plain bursts for a
cooldown that grows with each consecutive collapse, and after
``max_collapses`` of them speculation stays off.  The scheduler
speculates only while nothing waits and no prefill is in flight, the
conditions under which it plans bursts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.quant.policy import PrecisionPolicy, validate_kv_tier


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (``Scheduler(engine, spec=...)``).

    ``draft_kv``: the draft engine's KV tier (the weights are the
    target's); ``draft_policy`` replaces the whole draft policy instead.
    ``k_max``: draft-length ceiling of the power-of-two ladder;
    ``k_init``: the rung speculation starts at.  ``accept_floor``: an EMA
    acceptance below it at K = 1 collapses to plain bursts;
    ``accept_raise``: above it K doubles.  ``ema_alpha``: the newest
    round's weight.  ``cooldown_rounds`` / ``cooldown_backoff`` /
    ``max_cooldown_rounds``: plain rounds after a collapse, growing by the
    backoff with each consecutive collapse, capped.  ``max_collapses``:
    consecutive collapses after which speculation stays off.
    ``corrupt_drafts``: garble every draft token (acceptance exactly 0), a
    seeded way to drive the fallback; the output must not change."""
    draft_kv: str = "int8"
    draft_policy: Optional[PrecisionPolicy] = None
    k_max: int = 4
    k_init: int = 2
    accept_floor: float = 0.2
    accept_raise: float = 0.8
    ema_alpha: float = 0.5
    cooldown_rounds: int = 4
    cooldown_backoff: int = 2
    max_cooldown_rounds: int = 64
    max_collapses: int = 3
    corrupt_drafts: bool = False

    def __post_init__(self):
        if self.draft_policy is None:
            validate_kv_tier(self.draft_kv)
        if self.k_max < 1 or self.k_init < 1 or self.k_init > self.k_max:
            raise ValueError(
                f"need 1 <= k_init <= k_max, got k_init={self.k_init} "
                f"k_max={self.k_max}")
        if not 0.0 <= self.accept_floor <= self.accept_raise <= 1.0:
            raise ValueError("need 0 <= accept_floor <= accept_raise <= 1")


class DraftEngine:
    """The target engine's cheap twin: a second ``ServingEngine`` over the
    target's parameter module itself (no copy, no re-quantization) with
    the draft policy (default: the target's at ``draft_kv``), cached on
    the target per ``policy.to_json()``.  Its pools are slabs (their state
    is rolled back by a length every round and never shared), and it has
    no fault injector: the scheduler fences the draft dispatches under
    the target's.  A quantized-KV draft of an MLA model is refused
    (``validate_kv_tier``: the latent cache stays bf16).  Pool state is
    per ``DraftEngine``: one pool per target tier with mirrored slot ids, and each slot's draft length (-1: stale,
    the slot was freed or never drafted)."""

    def __init__(self, engine, cfg: SpecConfig):
        from .engine import ServingEngine
        self.cfg = cfg
        self.target = engine
        policy = cfg.draft_policy
        if policy is None:
            policy = dataclasses.replace(
                engine.policy, kv=validate_kv_tier(cfg.draft_kv, engine.cfg))
        key = policy.to_json()
        inner = engine.draft_engines.get(key)
        if inner is None:
            scfg = dataclasses.replace(
                engine.scfg, policy=policy, paged=False,
                cache_budget_bytes=None, fault_injector=None)
            inner = ServingEngine(engine.cfg, engine.params, scfg)
            engine.draft_engines[key] = inner
        self.engine = inner
        self.pools: Dict[str, object] = {}          # target tier -> pool
        self.draft_len: Dict[str, np.ndarray] = {}  # target tier -> [n_slots]

    def pool_for(self, tier: str, target_pool):
        """The draft pool mirroring ``target_pool`` (built on first use)."""
        pool = self.pools.get(tier)
        if pool is None:
            pool = self.engine.new_pool(n_slots=target_pool.n_slots,
                                        max_len=target_pool.max_len)
            self.pools[tier] = pool
            self.draft_len[tier] = np.full((target_pool.n_slots,), -1,
                                           np.int64)
        return pool

    def release(self, tier: str, slot: int) -> None:
        """The target slot was freed (retire, preempt, fault): its draft
        state is stale; the next request there catches up from its own
        tokens."""
        lens = self.draft_len.get(tier)
        if lens is not None:
            lens[slot] = -1

    def catch_up(self, tier: str, target_pool, rows: List[Tuple]) -> int:
        """Bring each (request, slot) row's draft KV up to the target's
        committed length by replaying the committed tokens (prompt +
        outputs[:-1]) through the draft's prefill chunks, KV only.  Chunks
        restart at the chunk boundary below the draft's length; rewriting
        correct positions writes the same bytes.  Returns the chunks
        dispatched."""
        pool = self.pool_for(tier, target_pool)
        lens = self.draft_len[tier]
        c = self.engine.scfg.prefill_chunk
        dispatches = 0
        for req, slot in rows:
            want = int(target_pool.lengths[slot])
            have = int(lens[slot])
            if have >= want:
                pool.lengths[slot] = want
                lens[slot] = want
                continue
            committed = np.concatenate(
                [req.prompt, np.asarray(req.output_tokens[:-1], np.int32)]) \
                if req.n_generated > 1 else req.prompt
            assert committed.size == want, (committed.size, want)
            padded, n = self.engine.pad_prompt(committed)
            start = max(0, have) // c * c
            pool.lengths[slot] = start
            for off in range(start, n, c):
                self.engine.prefill_chunk_into_slot(
                    pool, slot, padded, off, prompt_len=n,
                    need_logits=False)
                dispatches += 1
            lens[slot] = want
        return dispatches

    def draft_burst(self, tier: str, target_pool, rows: List[Tuple],
                    k: int, key_schedule: np.ndarray,
                    temps: np.ndarray) -> np.ndarray:
        """K draft steps on the draft pool: the engine's decode burst at the
        draft tier.  ``key_schedule`` [K, n, 2] holds each row's real keys
        for tokens n_generated..n_generated+K-1 (those the verify uses at
        positions j < K).  EOS is off (-1): the draft never stops early.
        Returns the proposals d_1..d_K, [K, n_slots] int32 (inactive slots
        carry garbage the caller ignores)."""
        pool = self.pool_for(tier, target_pool)
        n = pool.n_slots
        tokens = np.zeros((n,), np.int32)
        active = np.zeros((n,), bool)
        rem = np.zeros((n,), np.int32)
        eos = np.full((n,), -1, np.int32)
        for req, slot in rows:
            tokens[slot] = req.last_token
            active[slot] = True
            rem[slot] = k
        toks, _ = self.engine.decode_burst(
            pool, tokens, key_schedule, temps, active, rem, eos)
        if self.cfg.corrupt_drafts:
            # acceptance exactly 0, ids still in the vocabulary
            toks = (toks + 1) % self.target.cfg.vocab
        return toks

    def sync_lengths(self, tier: str, target_pool,
                     rows: List[Tuple]) -> None:
        """After the round: on the accepted prefix the draft's inputs were
        the committed tokens, so its state up to the target's new length
        is right and everything past it is garbage the next write
        overwrites."""
        pool = self.pools[tier]
        lens = self.draft_len[tier]
        for req, slot in rows:
            want = int(target_pool.lengths[slot])
            # a fully accepted round emits K+1 tokens but drafts K inputs:
            # the next round's catch_up closes the deficit of one
            got = min(int(pool.lengths[slot]), want)
            pool.lengths[slot] = got
            lens[slot] = got


class SpecPlanner:
    """Acceptance-EMA K controller with a plain-burst fallback: the EMA
    walks K along [1, k_max] in powers of two; a collapse at K = 1 (EMA
    below ``accept_floor``) runs plain bursts for a cooldown that grows by
    ``cooldown_backoff`` with each consecutive collapse (a healthy round
    resets it); probes re-enter at K = 1, and after ``max_collapses``
    consecutive collapses speculation stays off."""

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg
        self.k = cfg.k_init
        self.ema: Optional[float] = None     # None until the first round
        self.cooldown = 0                    # plain rounds left
        self.off = False                     # for good
        self._next_cooldown = cfg.cooldown_rounds
        self._consecutive_collapses = 0
        self.n_spec_rounds = 0
        self.n_plain_fallbacks = 0
        self.n_collapses = 0

    @property
    def active(self) -> bool:
        """Whether the next eligible round would speculate."""
        return not self.off and self.cooldown == 0

    def plan(self, rows, pool) -> int:
        """K for this round, or 0 for the plain path.  Each row's verify
        window must fit its slot (lengths + K + 1 <= max_len) and its
        budget must exceed one token; K rounds down to a power of two."""
        if self.off:
            self.n_plain_fallbacks += 1
            return 0
        if self.cooldown > 0:
            self.cooldown -= 1
            self.n_plain_fallbacks += 1
            return 0
        k = self.k
        for req, slot in rows:
            budget = req.sampling.max_new_tokens - req.n_generated
            if budget < 2:
                return 0
            capacity = pool.max_len - int(pool.lengths[slot]) - 1
            k = min(k, budget - 1, capacity)
        if k < 1:
            return 0
        return 1 << (k.bit_length() - 1)

    def expected_tokens_per_round(self) -> float:
        """Expected tokens a row emits a round at the current EMA a and K
        (geometric acceptance): (1 - a^(K+1)) / (1 - a); the SLO policy's
        drain estimate reads it."""
        a = min(max(self.ema if self.ema is not None else 0.5, 0.0), 0.999)
        return float((1.0 - a ** (self.k + 1)) / (1.0 - a))

    def observe(self, drafted: int, accepted: int) -> None:
        """Fold one spec round's outcome into the controller."""
        self.n_spec_rounds += 1
        rate = accepted / drafted if drafted else 0.0
        self.ema = rate if self.ema is None else (
            self.cfg.ema_alpha * rate
            + (1.0 - self.cfg.ema_alpha) * self.ema)
        if rate >= self.cfg.accept_floor:
            self._consecutive_collapses = 0
        if self.ema >= self.cfg.accept_raise:
            self.k = min(self.k * 2, self.cfg.k_max)
            self._next_cooldown = self.cfg.cooldown_rounds
        elif self.ema < self.cfg.accept_floor:
            if self.k > 1:
                self.k = max(1, self.k // 2)
            else:
                # collapsed at the bottom rung: plain bursts for a while,
                # a fresh EMA for the probe, a longer cooldown next time
                self.n_collapses += 1
                self._consecutive_collapses += 1
                if self._consecutive_collapses >= self.cfg.max_collapses:
                    self.off = True
                self.cooldown = self._next_cooldown
                self._next_cooldown = min(
                    self._next_cooldown * self.cfg.cooldown_backoff,
                    self.cfg.max_cooldown_rounds)
                self.ema = None
                self.k = 1

    def snapshot(self) -> Dict:
        return {"k": self.k,
                "acceptance_ema": None if self.ema is None
                else round(self.ema, 4),
                "cooldown": self.cooldown,
                "off": self.off,
                "spec_rounds": self.n_spec_rounds,
                "plain_fallbacks": self.n_plain_fallbacks,
                "collapses": self.n_collapses}


def accept_longest_prefix(draft: np.ndarray, verified: np.ndarray,
                          eos_id: int, rem: int) -> Tuple[int, int]:
    """Acceptance for one row: ``draft`` [K] proposals d_1..d_K,
    ``verified`` [K+1] target samples g_0..g_K.  Returns (n_emit,
    n_accepted): emit g_0..g_{n_emit-1}, the longest prefix with
    g_{j-1} == d_j plus the target's next sample, cut at the first
    emitted EOS and at the row's remaining budget ``rem``; n_accepted of
    them were draft matches (n_emit - n_accepted is 0 or 1)."""
    k = int(draft.shape[0])
    m = 0
    while m < k and int(verified[m]) == int(draft[m]):
        m += 1
    n_emit = min(m + 1, rem)
    if eos_id >= 0:
        for j in range(n_emit):
            if int(verified[j]) == eos_id:
                n_emit = j + 1
                break
    n_accepted = min(m, n_emit)
    return n_emit, n_accepted
