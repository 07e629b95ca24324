"""Serving engine: step primitives over a slot KV pool (torch twin of the
slab path of ``repro/serve/engine.py``).

  * ``prefill_chunk_into_slot`` — write one fixed-size chunk of a prompt
    into its slot; the final chunk returns its [C, V] logits (earlier
    chunks skip the lm-head).
  * ``decode_slots`` — one decode step for every pool slot (row i writes
    and attends at ``pool.lengths[i]``), sampling on the device (greedy,
    or seeded temperature rows by their threefry keys): only the
    [n_slots] int32 ids cross to the host.  Inactive slots ride along;
    their write lands where the slot's next real write goes.
  * ``decode_burst`` — K decode steps as one device-side loop: tokens,
    lengths and per-row stop masks stay on the device, step t samples
    with the keys of row t of the [K, n_slots, 2] schedule, and one
    transfer at the end brings the [K, n_slots] ids and emit mask to the
    host.
  * ``verify_slots`` — a speculative window [last, d_1..d_K] of every slot
    as S = K+1 chained decode steps in one dispatch, each the burst's
    step; lengths advance on the device, one transfer brings the [S,
    n_slots] samples back, and ``pool.lengths`` is left to the caller.

``generate`` serves a batch dict (``tokens`` [B, S], plus ``patches``
[B, Np, D] for the VLM, ``frames`` [B, n_frames, D] for the audio model)
in one call, as the reference's does: the dense and MoE families through
a private scheduler, the static-batch families (xLSTM, Zamba2, the VLM,
the audio model) through the reference's static-batch loop
(``_generate_legacy``): one cache of the batch at prefix + prompt + new
tokens (the prefix being the VLM's patches), one prefill from it empty,
then decode steps of every row at one index, sampled by the legacy rule
(``sampling.sample_static``), stopping early once every row has met its
EOS.  ``score`` is the reference's teacher-forced mean NLL per row (mode
``train``; dense, VLM and audio).

``new_pool`` builds a slot pool at any KV tier (dense / MoE only: a
static-batch family's pool raises ValueError); one
engine's parameters serve every tier's pool (the scheduler holds one pool
per tier).  With
``cache_budget_bytes`` the slot count comes from the budget and the tier's
bytes per slot.  With ``ServeConfig.paged`` the pool is a ``PagedKVPool``
instead: the budget buys arena pages, the slot count stays the config's,
and every step also takes the page table (on the device once per
dispatch; a burst indexes it with its device-side lengths).  The caller
pins each decode step's write window first (``PagedKVPool.ensure_decode``;
the prefill step pins its own chunk).  Weights, the pools and all step
tensors live on ``ServeConfig.device`` ("cuda" by default; the tests pass
"cpu", where the kernels' plain versions run).  The pool cache is updated
in place.

Fault injection (``ServeConfig.fault_injector``): a hook consulted once per
dispatch, before it runs, as ``(kind, seq)`` with kind 'prefill', 'decode',
'burst' or 'verify' and ``seq`` the engine's dispatch count since it was
built.  It
returns None (no fault), 'nan' (a decode step or burst runs and returns
ids of -1, as a poisoned sampler would; a prefill chunk raises instead) or
any other tag, raised as ``StepFault(tag)`` in place of the dispatch.  The
scheduler recovers from ``StepFault`` alone; any other error (a CUDA
error, a kernel that fails to build or launch) ends the run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import (FRONTEND_INPUTS, STATIC_BATCH_FAMILIES,
                                 ModelConfig)
from repro_torch.models import transformer as T
from repro_torch.models.common import QLinear
from repro_torch.quant.policy import PrecisionPolicy, validate_kv_tier
from repro_torch.runtime.fault_tolerance import StepFault

from .kv_pool import (KVCachePool, PagedKVPool, check_poolable,
                      pages_for_budget, slots_for_budget)
from .sampling import sample_on_device, sample_static, sampler_inputs
from .threefry import prng_key, split

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512        # per-slot KV capacity (prompt + new tokens)
    temperature: float = 0.0  # one-shot generate's sampling (<= 0: greedy)
    eos_id: int = -1          # -1: never stop early (one-shot generate)
    n_slots: int = 8          # KV pool width = decode batch
    # cache-memory budget per pool: when set, ``new_pool`` derives the slot
    # count from the tier's bytes per slot instead of taking ``n_slots``
    cache_budget_bytes: Optional[int] = None
    prefill_chunk: int = 16   # chunked-prefill granularity
    max_burst: int = 8        # cap on decode-burst length K (1 = no bursts)
    # paged KV: one page arena per pool with page tables, copy-on-write
    # prefix sharing and LRU eviction; ``page_size`` 0 is the prefill
    # chunk, any other value must be a multiple of it
    paged: bool = False
    page_size: int = 0
    # weight schemes the parameters must carry, and the KV-cache tier
    policy: PrecisionPolicy = PrecisionPolicy()
    device: str = "cuda"
    # fault-injection hook ``(kind, seq) -> None | 'nan' | tag`` (module
    # docstring); None disables it at no cost
    fault_injector: Optional[Callable[[str, int], Optional[str]]] = None
    # step faults one request may survive (each a preempt-and-requeue with
    # exponential backoff) before it retires with finish_reason='fault'
    max_fault_retries: int = 3


def resolve_device(device) -> torch.device:
    """The device to serve on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available (pass "
            "device='cpu' to run the kernels' plain versions)")
    return dev


def leaf_schemes(params) -> Dict[str, str]:
    """{logical leaf name -> scheme} of a parameter module
    (``T.linear_leaves``: the shared experts under their ``ffn.*`` names,
    recurrent leaves as ``ssm.*``); raises when the layers disagree."""
    found: Dict[str, set] = {}
    for logical, leaf in T.linear_leaves(params):
        found.setdefault(logical, set()).add(_scheme(leaf))
    mixed = sorted(n for n, s in found.items() if len(s) > 1)
    if mixed:
        raise ValueError(f"layers disagree on the schemes of {mixed}")
    return {n: s.pop() for n, s in found.items()}


def _scheme(leaf) -> str:
    return leaf.scheme_name if isinstance(leaf, QLinear) else "bf16"


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig):
        """Validates the policy against ``cfg`` and the parameters against
        the policy (every leaf carries the scheme the policy resolves for
        it), then moves the parameters to the serving device."""
        T.check_supported(cfg)
        self.cfg = cfg
        self.scfg = serve_cfg
        self.device = resolve_device(serve_cfg.device)
        self.policy = serve_cfg.policy.validate_for(cfg)
        plan, have = self.policy.resolved_plan(cfg), leaf_schemes(params)
        if plan != have:
            diff = sorted(n for n in plan if plan[n] != have.get(n))
            raise ValueError(
                f"parameters do not carry the policy's schemes at {diff} "
                "(build them with QuantMaker(plan=policy.resolved_plan(cfg)))")
        self.params = params.to(self.device)
        c = serve_cfg.prefill_chunk
        if serve_cfg.page_size < 0 or serve_cfg.page_size % c:
            raise ValueError(f"page_size {serve_cfg.page_size} must be 0 "
                             f"(the prefill chunk) or a multiple of {c}")
        # dispatches seen by the fault injector (advances whenever one is
        # configured)
        self._fault_seq = 0
        # speculative decoding's draft twins over these parameters, by
        # draft policy JSON (``spec.DraftEngine``)
        self.draft_engines: Dict[str, "ServingEngine"] = {}

    # ------------------------------------------------------------------
    def new_pool(self, n_slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 kv_dtype: Optional[str] = None):
        """A slot pool at KV tier ``kv_dtype`` (default: the policy's),
        ``max_len`` positions a slot (default: the config's; capacity
        rounded up to whole prefill chunks).  Without ``n_slots`` the
        width is budget-derived when ``cache_budget_bytes`` is set, else
        the config's ``n_slots``.  Paged: a ``PagedKVPool`` of the
        config's ``n_slots`` (or ``n_slots``), its arena sized from the
        budget when one is set, else fully provisioned."""
        check_poolable(self.cfg, "ServingEngine.new_pool")
        tier = self.policy.kv if kv_dtype is None \
            else validate_kv_tier(kv_dtype, self.cfg)
        max_len = max_len or self.scfg.max_len
        c = self.scfg.prefill_chunk
        if self.scfg.paged:
            page_size = self.scfg.page_size or c
            n_pages = None
            if self.scfg.cache_budget_bytes is not None:
                n_pages = pages_for_budget(
                    self.cfg, max_len, self.scfg.cache_budget_bytes,
                    kv_dtype=tier, page_size=page_size, align=c)
            return PagedKVPool(self.cfg, n_slots or self.scfg.n_slots,
                               max_len, kv_dtype=tier, align=c,
                               page_size=page_size, n_pages=n_pages,
                               device=self.device)
        if n_slots is None:
            n_slots = self.scfg.n_slots \
                if self.scfg.cache_budget_bytes is None else slots_for_budget(
                    self.cfg, max_len, self.scfg.cache_budget_bytes,
                    kv_dtype=tier, align=c)
        return KVCachePool(self.cfg, n_slots, max_len, kv_dtype=tier,
                           align=c, device=self.device)

    def pad_prompt(self, prompt: np.ndarray):
        """(prompt zero-padded to whole chunks, true length)."""
        c = self.scfg.prefill_chunk
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = int(prompt.size)
        if n == 0:
            raise ValueError("empty prompt")
        padded = np.zeros((-(-n // c) * c,), np.int32)
        padded[:n] = prompt
        return padded, n

    def _inject_fault(self, kind: str) -> Optional[str]:
        """Consult the fault injector for one dispatch of ``kind``: 'nan'
        when a decode dispatch's ids are to be poisoned, None for no
        fault; a kill (or 'nan' on a prefill chunk) raises ``StepFault``."""
        fi = self.scfg.fault_injector
        if fi is None:
            return None
        self._fault_seq += 1
        mode = fi(kind, self._fault_seq)
        if not mode:
            return None
        if mode == "nan" and kind != "prefill":
            return "nan"
        raise StepFault(str(mode), f"{kind} dispatch #{self._fault_seq}")

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    @torch.no_grad()
    def prefill_chunk_into_slot(self, pool: KVCachePool, slot: int,
                                prompt: np.ndarray, offset: int, *,
                                prompt_len: Optional[int] = None,
                                need_logits: bool = True):
        """Write prompt[offset : offset+C] into ``slot`` and advance
        ``pool.lengths[slot]``.  With ``prompt_len`` given, ``prompt`` is
        the padded buffer from ``pad_prompt``.  The prompt's final chunk
        returns its [C, V] f32 logits on the device (pad positions carry
        garbage); other chunks return None."""
        c = self.scfg.prefill_chunk
        if prompt_len is None:
            prompt, prompt_len = self.pad_prompt(prompt)
        n = min(c, prompt_len - offset)
        if n <= 0 or offset + n > pool.max_len:
            raise ValueError(f"bad prefill chunk at offset {offset} "
                             f"(prompt {prompt_len}, capacity {pool.max_len})")
        final = (offset + n >= prompt_len) and need_logits
        self._inject_fault("prefill")
        chunk = self._tensor(prompt[offset:offset + c][None])
        if pool.paged:
            # pin the chunk's write window (a fresh page, or the copy of a
            # shared one on a full-cover prefix hit) before the write
            pool.ensure(slot, offset + c)
            cache, table = pool.cache, self._tensor(
                pool.page_table[slot:slot + 1])
        else:
            cache = tuple(slab[:, slot:slot + 1] for slab in pool.cache)
            table = None
        logits = T.forward(self.cfg, self.params, chunk, cache=cache,
                           cache_index=offset, mode="prefill_chunk",
                           need_logits=final, page_table=table)
        pool.lengths[slot] = offset + n
        return logits[0] if final else None

    def prefill_into_slots(self, pool: KVCachePool, slots: Sequence[int],
                           prompts: Sequence[np.ndarray]) -> List:
        """Chunked prefill of each (slot, prompt); returns the [V] logits at
        each prompt's last position."""
        c = self.scfg.prefill_chunk
        out = []
        for slot, prompt in zip(slots, prompts):
            padded, n = self.pad_prompt(prompt)
            logits = None
            for off in range(0, n, c):
                logits = self.prefill_chunk_into_slot(pool, slot, padded, off,
                                                      prompt_len=n)
            out.append(logits[(n - 1) % c])
        return out

    def _page_table(self, pool) -> Optional[torch.Tensor]:
        """The pool's page table on the device (None for a slab pool).  The
        caller has pinned every row's write window."""
        return self._tensor(pool.page_table) if pool.paged else None

    def _decode_logits(self, pool: KVCachePool, tokens: torch.Tensor,
                       lengths: torch.Tensor,
                       table: Optional[torch.Tensor]) -> torch.Tensor:
        logits = T.forward(self.cfg, self.params, tokens[:, None],
                           cache=pool.cache, cache_index=lengths,
                           mode="decode", page_table=table)
        return logits[:, -1]

    @torch.no_grad()
    def decode_slots(self, pool: KVCachePool, tokens: np.ndarray,
                     keys: Optional[np.ndarray] = None,
                     temps: Optional[np.ndarray] = None) -> np.ndarray:
        """One decode step over every slot; ``tokens`` [n_slots], ``keys``
        [n_slots, 2] uint32 and ``temps`` [n_slots] (both default to
        greedy).  Returns the [n_slots] sampled ids.  The caller commits
        the write by incrementing ``pool.lengths`` for its active rows."""
        n = pool.n_slots
        poison = self._inject_fault("decode")
        keys, t, hot = sampler_inputs(keys, temps, n, self.device)
        toks = self._tensor(np.asarray(tokens).reshape(n))
        logits = self._decode_logits(pool, toks, self._tensor(pool.lengths),
                                     self._page_table(pool))
        out = sample_on_device(logits, keys, t, hot).cpu().numpy()
        if poison is not None:
            # out-of-vocabulary ids, as a NaN-saturated sampler would give:
            # the scheduler's guard must catch them
            out = np.full_like(out, -1)
        return out

    @torch.no_grad()
    def decode_slots_with_logits(self, pool: KVCachePool,
                                 tokens: np.ndarray) -> torch.Tensor:
        """``decode_slots`` returning the [n_slots, V] f32 logits instead."""
        toks = self._tensor(np.asarray(tokens).reshape(pool.n_slots))
        return self._decode_logits(pool, toks, self._tensor(pool.lengths),
                                   self._page_table(pool))

    @torch.no_grad()
    def decode_burst(self, pool: KVCachePool, tokens: np.ndarray,
                     keys: np.ndarray, temps: np.ndarray,
                     active: np.ndarray, remaining: np.ndarray,
                     eos_ids: np.ndarray):
        """K = ``keys.shape[0]`` consecutive decode steps with the state on
        the device; row i of ``keys[t]`` [K, n_slots, 2] is row i's key for
        its t-th token of the burst, ``temps`` [n_slots] its temperature.

        ``active`` [n_slots] marks live rows, ``remaining`` their max-new
        budget left, ``eos_ids`` their stop id (-1 never).  A row stops
        after sampling its EOS, exhausting its budget, or reaching the slot
        capacity; stopped rows ride along like inactive slots.  Returns
        (tokens [K, n_slots] int32, valid [K, n_slots] bool) on the host —
        token (t, i) was emitted iff valid[t, i] — and commits
        ``pool.lengths`` for every emitted token."""
        n = pool.n_slots
        k = keys.shape[0]
        if keys.shape != (k, n, 2):
            raise ValueError(f"key schedule {keys.shape} is not [K, {n}, 2]")
        poison = self._inject_fault("burst")
        keys, t_dev, hot = sampler_inputs(keys, temps, n, self.device)
        toks = self._tensor(np.asarray(tokens).reshape(n))
        lengths = self._tensor(pool.lengths)
        act = self._tensor(active, torch.bool)
        rem = self._tensor(remaining)
        eos = self._tensor(eos_ids)
        table = self._page_table(pool)
        out = torch.empty((2, k, n), dtype=torch.int64, device=self.device)
        for t in range(k):
            sampled = sample_on_device(
                self._decode_logits(pool, toks, lengths, table),
                None if keys is None else keys[t], t_dev, hot)
            step = act.to(torch.int64)
            lengths = lengths + step
            rem = rem - step
            stop_eos = (eos >= 0) & (sampled == eos)
            still = act & ~stop_eos & (rem > 0) & (lengths < pool.max_len - 1)
            toks = torch.where(act, sampled.to(torch.int64), toks)
            out[0, t] = sampled
            out[1, t] = step
            act = still
        host = out.cpu().numpy()                   # the burst's one sync
        toks_h, valid = host[0].astype(np.int32), host[1].astype(bool)
        if poison is not None:
            toks_h = np.full_like(toks_h, -1)
        pool.lengths += valid.sum(axis=0).astype(np.int32)
        return toks_h, valid

    @torch.no_grad()
    def verify_slots(self, pool: KVCachePool, tokens: np.ndarray,
                     key_schedule: np.ndarray,
                     temperatures: np.ndarray) -> np.ndarray:
        """Speculative verify over every slot: ``tokens`` [n_slots, S] is
        row i's window [last_committed, d_1..d_K], written at
        ``pool.lengths[i]`` .. +S-1; ``key_schedule`` [S, n_slots, 2] holds
        each row's keys for tokens n_generated .. +K.  Returns the target's
        samples [S, n_slots] int32, g_j at position j.

        The window runs as S chained decode steps, each the burst's step
        (the decode forward at M = n_slots, then the sampler with
        ``key_schedule[j]``), so every g_j takes the kernels and the
        summation order of the plain decode step.  Scoring the window as
        one S-wide prefill pass would route to the prefill matmul and
        another attention order, whose last-bit differences temperature
        rows turn into other tokens.  ``pool.lengths`` is not committed:
        the caller commits the emitted count, which is the rollback (the
        positions past it are masked at every later read).  A paged pool's
        S-wide window must be pinned first (``ensure_decode(slots, S,
        rems)``); the table holds for the whole window."""
        n = pool.n_slots
        tokens = np.asarray(tokens, np.int32).reshape(n, -1)
        s = tokens.shape[1]
        if key_schedule.shape != (s, n, 2):
            raise ValueError(
                f"key schedule {key_schedule.shape} is not [{s}, {n}, 2]")
        poison = self._inject_fault("verify")
        keys, t_dev, hot = sampler_inputs(key_schedule, temperatures, n,
                                          self.device)
        window = self._tensor(np.ascontiguousarray(tokens.T))   # [S, n]
        lengths = self._tensor(pool.lengths)
        table = self._page_table(pool)
        out = torch.empty((s, n), dtype=torch.int32, device=self.device)
        for j in range(s):
            out[j] = sample_on_device(
                self._decode_logits(pool, window[j], lengths + j, table),
                None if keys is None else keys[j], t_dev, hot)
        sampled = out.cpu().numpy()              # the window's one sync
        if poison is not None:
            sampled = np.full_like(sampled, -1)
        return sampled

    # ------------------------------------------------------------------
    def _batch_inputs(self, batch: Dict):
        """(tokens [B, S] int32 on the host, the frontend inputs on the
        device as ``T.forward`` keywords): ``patches`` [B, n_patches, D]
        must come with a VLM's batch and with no other, ``frames`` [B,
        n_frames, D] with an audio model's and with no other."""
        if not isinstance(batch, Mapping):
            raise TypeError("a batch is the reference's dict {'tokens': "
                            "[B, S], ...}, not an array")
        tokens = np.asarray(batch["tokens"], np.int32)
        inputs = {}
        for family, (key, rows) in FRONTEND_INPUTS.items():
            given = batch.get(key)
            if (self.cfg.family == family) != (given is not None):
                raise ValueError(f"{self.cfg.name}: a batch carries "
                                 f"{key!r} exactly when the model's family "
                                 f"is {family!r}")
            if given is None:
                continue
            given = given.to(self.device) if torch.is_tensor(given) \
                else torch.as_tensor(np.asarray(given, np.float32),
                                     device=self.device)
            want = (tokens.shape[0], getattr(self.cfg, rows),
                    self.cfg.d_model)
            if tuple(given.shape) != want:
                raise ValueError(f"{key} {tuple(given.shape)}, not {want}")
            inputs[key] = given
        return tokens, inputs

    def generate(self, batch: Dict, *, max_new_tokens: int, seed: int = 0,
                 obs=None) -> Dict:
        """One-shot generation for a batch dict at
        ``ServeConfig.temperature`` and ``seed``: ``tokens`` [B, S], plus
        ``patches`` [B, n_patches, d_model] for the VLM or ``frames`` [B,
        n_frames, d_model] for the audio model.  Dense / MoE: the
        rows go through a private scheduler (row i is request id i), to
        which ``obs`` (a ``repro_torch.obs.Observability`` bundle, or None)
        is handed.  The static-batch families: the static-batch loop, which
        has no scheduler and ignores ``obs``.  Returns generated ids [B, T]
        (zero-padded), ``prompt_len`` (S, the prefix not counted),
        ``batch``, per-row lengths and finish reasons; dense / MoE also the
        scheduler's ``decode_dispatches``, ``decode_token_steps``,
        ``burst_hist`` and ``host_syncs``, as the reference's."""
        tokens, inputs = self._batch_inputs(batch)
        if self.cfg.family in STATIC_BATCH_FAMILIES:
            return self._generate_legacy(tokens, inputs, max_new_tokens,
                                         seed)
        from .request import Request, SamplingParams
        from .scheduler import Scheduler

        b, s = tokens.shape
        if s + max_new_tokens > self.scfg.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        sched = Scheduler(self, obs=obs)
        reqs = [sched.submit(Request(prompt=tokens[i], sampling=SamplingParams(
            temperature=self.scfg.temperature, max_new_tokens=max_new_tokens,
            eos_id=self.scfg.eos_id, seed=seed))) for i in range(b)]
        sched.run()
        width = max(r.n_generated for r in reqs)
        gen = np.zeros((b, width), np.int32)
        for i, r in enumerate(reqs):
            gen[i, :r.n_generated] = r.output_tokens
        m = sched.metrics
        return {"generated": gen, "prompt_len": s, "batch": b,
                "lengths": np.array([r.n_generated for r in reqs], np.int32),
                "finish_reasons": [r.finish_reason for r in reqs],
                "decode_dispatches": m.decode_dispatches,
                "decode_token_steps": m.decode_token_steps,
                "host_syncs": sched.n_host_syncs,
                "burst_hist": dict(m.burst_hist)}

    @torch.no_grad()
    def _generate_legacy(self, tokens: np.ndarray, inputs: Dict,
                         max_new_tokens: int, seed: int) -> Dict:
        """The reference's static-batch loop (``_generate_legacy``): one
        cache of prefix + S + ``max_new_tokens`` positions (the prefix
        being the VLM's ``n_patches``, else 0; the audio model's cache also
        holds its encoder output), the prefill taking the frontend
        ``inputs`` (``_batch_inputs``), the first token from the
        prefill's last-position logits with the key ``PRNGKey(seed)``
        itself, then ``max_new_tokens - 1`` decode steps of every row at
        index ``prefix + S + i``, each sampled with ``sub`` of ``key, sub =
        split(key)``; the batch stops early once every row has sampled
        ``eos_id``, and each row's ids after its first EOS are masked to 0.
        ``max_len`` bounds S + ``max_new_tokens``, the prefix not counted,
        as the reference's check does."""
        cfg, scfg = self.cfg, self.scfg
        b, s = tokens.shape
        prefix = cfg.n_patches if cfg.family == "vlm" else 0
        if s + max_new_tokens > scfg.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        cache = T.init_cache(cfg, b, prefix + s + max_new_tokens,
                             kv_dtype=self.policy.kv, device=self.device)
        logits = T.forward(cfg, self.params, self._tensor(tokens),
                           cache=cache, cache_index=0, mode="prefill",
                           **inputs)[:, -1]
        key = prng_key(seed)
        tok = sample_static(logits, key, scfg.temperature)
        out = [tok.cpu().numpy()]
        finished = np.zeros((b,), bool)
        index = prefix + s
        for i in range(max_new_tokens - 1):
            key, sub = split(key)
            logits = T.forward(cfg, self.params, tok[:, None].to(torch.int64),
                               cache=cache, cache_index=index + i,
                               mode="decode")[:, -1]
            tok = sample_static(logits, sub, scfg.temperature)
            out.append(tok.cpu().numpy())
            if scfg.eos_id >= 0:
                finished |= out[-1] == scfg.eos_id
                if finished.all():   # the whole batch is done
                    break
        gen = np.stack(out, axis=1)
        lengths = np.full((b,), gen.shape[1], np.int32)
        reasons = ["length"] * b
        if scfg.eos_id >= 0:
            # mask each row after its first EOS (a static batch cannot
            # retire rows early)
            eos = gen == scfg.eos_id
            keep = (np.cumsum(eos, axis=1) - eos) == 0
            gen = np.where(keep, gen, 0)
            lengths = keep.sum(1).astype(np.int32)
            reasons = ["eos" if eos[i].any() else "length" for i in range(b)]
        return {"generated": gen, "prompt_len": s, "batch": b,
                "lengths": lengths, "finish_reasons": reasons}

    @torch.no_grad()
    def train_logits(self, batch: Dict) -> torch.Tensor:
        """The teacher-forced logits of the batch's token positions [B, S,
        V] f32 (mode ``train``; a VLM's patch rows dropped)."""
        tokens, inputs = self._batch_inputs(batch)
        logits = T.forward(self.cfg, self.params, self._tensor(tokens),
                           cache=None, cache_index=0, mode="train", **inputs)
        return logits[:, logits.shape[1] - tokens.shape[1]:]

    def score(self, batch: Dict) -> np.ndarray:
        """Teacher-forced mean NLL per row [B] f32 (the reference's
        ``score``, a serving-quality check): ``batch`` as for ``generate``
        plus ``labels`` [B, S], positions with a label < 0 left out."""
        return mean_nll(self.train_logits(batch), batch["labels"])


def mean_nll(logits: torch.Tensor, labels) -> np.ndarray:
    """Mean over each row's positions with a label >= 0 of logsumexp -
    the label's logit, in f32 (``logits`` [B, S, V], ``labels`` [B, S])."""
    lf = logits.to(torch.float32)
    labels = torch.as_tensor(np.asarray(labels), device=lf.device).long()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels >= 0
    nll = torch.where(mask, lse - gold, torch.zeros((), device=lf.device))
    return (nll.sum(-1) / mask.sum(-1).to(torch.float32)).cpu().numpy()
