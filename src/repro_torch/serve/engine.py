"""Serving engine: step primitives over a slot KV pool (torch twin of the
slab path of ``repro/serve/engine.py``).

  * ``prefill_chunk_into_slot`` — write one fixed-size chunk of a prompt
    into its slot; the final chunk returns its [C, V] logits (earlier
    chunks skip the lm-head).
  * ``decode_slots`` — one decode step for every pool slot (row i writes
    and attends at ``pool.lengths[i]``), greedy sampling on the device:
    only the [n_slots] int32 ids cross to the host.  Inactive slots ride
    along; their write lands where the slot's next real write goes.
  * ``decode_burst`` — K decode steps as one device-side loop: tokens,
    lengths and per-row stop masks stay on the device, and one transfer at
    the end brings the [K, n_slots] ids and emit mask to the host.

Weights, the pool and all step tensors live on ``ServeConfig.device``
("cuda" by default; the tests pass "cpu", where the kernels' plain
versions run).  The pool cache is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import QLinear
from repro_torch.quant.policy import PrecisionPolicy

from .kv_pool import KVCachePool
from .sampling import sample_rows


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512        # per-slot KV capacity (prompt + new tokens)
    eos_id: int = -1          # -1: never stop early (one-shot generate)
    n_slots: int = 8          # KV pool width = decode batch
    prefill_chunk: int = 16   # chunked-prefill granularity
    max_burst: int = 8        # cap on decode-burst length K (1 = no bursts)
    # weight schemes the parameters must carry, and the KV-cache tier
    policy: PrecisionPolicy = PrecisionPolicy()
    device: str = "cuda"


def resolve_device(device) -> torch.device:
    """The device to serve on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available (pass "
            "device='cpu' to run the kernels' plain versions)")
    return dev


def leaf_schemes(params: T.DenseLM) -> Dict[str, str]:
    """{logical leaf name -> scheme} of a parameter module; raises when
    the layers disagree."""
    found: Dict[str, set] = {"lm_head": {_scheme(params.lm_head)}}
    for blk in params.layers:
        for group in ("attn", "ffn"):
            for name, leaf in getattr(blk, group).items():
                found.setdefault(f"{group}.{name}", set()).add(_scheme(leaf))
    mixed = sorted(n for n, s in found.items() if len(s) > 1)
    if mixed:
        raise ValueError(f"layers disagree on the schemes of {mixed}")
    return {n: s.pop() for n, s in found.items()}


def _scheme(leaf) -> str:
    return leaf.scheme_name if isinstance(leaf, QLinear) else "bf16"


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: T.DenseLM,
                 serve_cfg: ServeConfig):
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

    # ------------------------------------------------------------------
    def new_pool(self) -> KVCachePool:
        """A slot pool at the policy's KV tier, ``n_slots`` x ``max_len``
        (capacity rounded up to whole prefill chunks)."""
        return KVCachePool(self.cfg, self.scfg.n_slots, self.scfg.max_len,
                           kv_dtype=self.policy.kv,
                           align=self.scfg.prefill_chunk, device=self.device)

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
        chunk = self._tensor(prompt[offset:offset + c][None])
        slot_cache = tuple(slab[:, slot:slot + 1] for slab in pool.cache)
        logits = T.forward(self.cfg, self.params, chunk, cache=slot_cache,
                           cache_index=offset, mode="prefill_chunk",
                           need_logits=final)
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

    def _decode_logits(self, pool: KVCachePool, tokens: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
        logits = T.forward(self.cfg, self.params, tokens[:, None],
                           cache=pool.cache, cache_index=lengths,
                           mode="decode")
        return logits[:, -1]

    @torch.no_grad()
    def decode_slots(self, pool: KVCachePool, tokens: np.ndarray) -> np.ndarray:
        """One decode step over every slot; ``tokens`` [n_slots].  Returns
        the [n_slots] greedy ids.  The caller commits the write by
        incrementing ``pool.lengths`` for its active rows."""
        toks = self._tensor(np.asarray(tokens).reshape(pool.n_slots))
        logits = self._decode_logits(pool, toks, self._tensor(pool.lengths))
        return sample_rows(logits).cpu().numpy()

    @torch.no_grad()
    def decode_slots_with_logits(self, pool: KVCachePool,
                                 tokens: np.ndarray) -> torch.Tensor:
        """``decode_slots`` returning the [n_slots, V] f32 logits instead."""
        toks = self._tensor(np.asarray(tokens).reshape(pool.n_slots))
        return self._decode_logits(pool, toks, self._tensor(pool.lengths))

    @torch.no_grad()
    def decode_burst(self, pool: KVCachePool, tokens: np.ndarray, k: int,
                     active: np.ndarray, remaining: np.ndarray,
                     eos_ids: np.ndarray):
        """K consecutive decode steps with the state on the device.

        ``active`` [n_slots] marks live rows, ``remaining`` their max-new
        budget left, ``eos_ids`` their stop id (-1 never).  A row stops
        after sampling its EOS, exhausting its budget, or reaching the slot
        capacity; stopped rows ride along like inactive slots.  Returns
        (tokens [K, n_slots] int32, valid [K, n_slots] bool) on the host —
        token (t, i) was emitted iff valid[t, i] — and commits
        ``pool.lengths`` for every emitted token."""
        n = pool.n_slots
        toks = self._tensor(np.asarray(tokens).reshape(n))
        lengths = self._tensor(pool.lengths)
        act = self._tensor(active, torch.bool)
        rem = self._tensor(remaining)
        eos = self._tensor(eos_ids)
        out = torch.empty((2, k, n), dtype=torch.int64, device=self.device)
        for t in range(k):
            sampled = sample_rows(self._decode_logits(pool, toks, lengths))
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
        pool.lengths += valid.sum(axis=0).astype(np.int32)
        return toks_h, valid

    # ------------------------------------------------------------------
    def generate(self, tokens: np.ndarray, *, max_new_tokens: int) -> Dict:
        """One-shot greedy generation for a batch of prompts [B, S]: every
        row goes through a private scheduler.  Returns generated ids
        [B, T] (zero-padded), per-row lengths and finish reasons."""
        from .request import Request, SamplingParams
        from .scheduler import Scheduler

        tokens = np.asarray(tokens, np.int32)
        b, s = tokens.shape
        if s + max_new_tokens > self.scfg.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        sched = Scheduler(self)
        reqs = [sched.submit(Request(prompt=tokens[i], sampling=SamplingParams(
            max_new_tokens=max_new_tokens, eos_id=self.scfg.eos_id)))
            for i in range(b)]
        sched.run()
        width = max(r.n_generated for r in reqs)
        gen = np.zeros((b, width), np.int32)
        for i, r in enumerate(reqs):
            gen[i, :r.n_generated] = r.output_tokens
        return {"generated": gen,
                "lengths": np.array([r.n_generated for r in reqs], np.int32),
                "finish_reasons": [r.finish_reason for r in reqs]}
