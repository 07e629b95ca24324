"""Request state machine: WAITING -> PREFILL -> DECODE -> FINISHED.

WAITING:  submitted, no KV slot yet (admission queue), or preempted and
          requeued with a resume buffer.
PREFILL:  owns a KV slot in its tier's pool; the prompt (or the resume
          buffer) is written chunk by chunk (``prefill_pos`` counts
          committed positions).
DECODE:   prompt in cache; one token per decode step.
FINISHED: retired (EOS, length or slot capacity), or shed by the serving
          policy (rejected at submit, past a deadline, or out of fault
          retries); a held slot is returned.

Randomness is per request and per step: the key of generated token n is
``fold_in(fold_in(PRNGKey(seed), id), n)`` (``threefry.py``), so a
request's output is a pure function of (seed, id, prompt, weights, KV
tier): independent of its slot, of what shares its decode batch, of when
it was admitted and of whether it was preempted and resumed.  (On the
card a resume rewrites the replayed tokens' KV through the prefill
matmul, not the decode GEMV, whose sums round differently: there a
resumed request can part from its unpreempted run at a near tie.)
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from . import threefry


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # <= 0: greedy
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: never stop on a token
    seed: int = 0

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                       # [P] int32 token ids
    sampling: SamplingParams = SamplingParams()
    id: Optional[int] = None                 # assigned by the scheduler
    state: RequestState = RequestState.WAITING
    # requested KV tier ('bf16' | 'int8' | 'fp8'; None: the scheduler's
    # default tier), resolved into ``tier`` at submit.  Tiers share the
    # weights but never a cache slab.
    kv_policy: Optional[str] = None
    tier: Optional[str] = None
    # scheduling class: smaller is more important.  A waiter may preempt a
    # DECODE request of a strictly lower class in its tier.  Priority
    # changes when tokens come, never which.
    priority: int = 0
    # optional SLO deadlines in scheduler-clock seconds from arrival: a
    # request still WAITING past its TTFT deadline, or running past its
    # e2e deadline, retires with finish_reason='deadline_exceeded'
    # (checked once per step from the step's own clock sample)
    ttft_deadline_s: Optional[float] = None
    e2e_deadline_s: Optional[float] = None
    slot: Optional[int] = None               # KV pool slot while admitted
    prefill_pos: int = 0                     # prefill positions in cache
    # prompt positions adopted from a paged pool's prefix cache at
    # admission (0 on a slab pool or a miss); prefill starts past them
    prefix_hit_tokens: int = 0
    prompt_padded: Optional[np.ndarray] = None   # chunk-padded prefill
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    # after a preemption: prompt + every generated token but the last (the
    # last is the next decode input; its KV was never written).  Prefill
    # replays it, emits nothing, and decode goes on at ``n_generated``.
    resume_prompt: Optional[np.ndarray] = None
    n_preemptions: int = 0
    n_faults: int = 0                        # step faults charged to it
    # first scheduler step at which a fault-requeued request may be
    # admitted again (exponential backoff; 0 = at once)
    hold_until_step: int = 0
    # the serving policy's typed verdict when it sheds the request at
    # submit (``slo.Rejection``; finish_reason='rejected')
    rejection: Optional[object] = None
    # the KV tier the serving policy downgraded the request from (None:
    # served at the tier it asked for)
    downgraded_from: Optional[str] = None
    finish_reason: Optional[str] = None
    # ^ eos | length | capacity | rejected | deadline_exceeded | fault
    # timing (scheduler clock); ``last_enqueue_time`` is the latest entry
    # into the queue (submit or requeue), ``admit_time`` the latest exit
    arrival_time: Optional[float] = None
    last_enqueue_time: Optional[float] = None
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    # engine-dispatch id that emitted each token (tokens sharing an id
    # surfaced from one decode burst)
    token_dispatches: List[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def prefill_tokens(self) -> np.ndarray:
        """What prefill commits: the prompt, or the resume buffer."""
        return self.prompt if self.resume_prompt is None \
            else self.resume_prompt

    @property
    def prefill_len(self) -> int:
        return int(self.prefill_tokens.size)

    @property
    def is_resuming(self) -> bool:
        return self.resume_prompt is not None

    @property
    def n_generated(self) -> int:
        return len(self.output_tokens)

    @property
    def last_token(self) -> int:
        return self.output_tokens[-1]

    @property
    def is_finished(self) -> bool:
        return self.state == RequestState.FINISHED

    def step_key(self) -> np.ndarray:
        """[2] uint32 key of generated token ``n_generated``."""
        return self.step_keys(1)[0]

    def step_keys(self, n: int) -> np.ndarray:
        """[n, 2] uint32 keys of tokens ``n_generated .. n_generated+n-1``;
        row t equals ``step_key()`` at that step.  The id is folded in as
        a uint32, as ``jax.random.fold_in`` takes it: an id outside
        [0, 2^32) raises ``OverflowError`` (it would alias id mod 2^32)."""
        rid = self.id or 0
        if not 0 <= rid < 2**32:
            raise OverflowError(
                f"Python integer {rid} out of bounds for uint32 "
                "(request ids are folded into the sampling key as uint32)")
        return threefry.step_keys([self.sampling.seed], [rid],
                                  [self.n_generated], n)[0]
