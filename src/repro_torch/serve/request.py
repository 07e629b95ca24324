"""Request state machine: WAITING -> PREFILL -> DECODE -> FINISHED.

WAITING:  submitted, no KV slot yet (FCFS admission queue).
PREFILL:  owns a KV slot; the prompt is written chunk by chunk
          (``prefill_pos`` counts committed positions).
DECODE:   prompt in cache; one token per decode step.
FINISHED: retired (EOS, length or slot capacity); the slot is returned.

Sampling is greedy, so a request's output is a pure function of (prompt,
weights, KV tier): independent of its slot, of what shares its decode
batch and of when it was admitted.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # greedy only (see serve/sampling.py)
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: never stop on a token

    def __post_init__(self):
        if self.temperature > 0:
            raise NotImplementedError(
                "temperature sampling is not ported yet; use temperature=0")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                       # [P] int32 token ids
    sampling: SamplingParams = SamplingParams()
    id: Optional[int] = None                 # assigned by the scheduler
    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None               # KV pool slot while admitted
    prefill_pos: int = 0                     # prompt positions in cache
    prompt_padded: Optional[np.ndarray] = None   # chunk-padded prompt
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None      # eos | length | capacity
    # timing (scheduler clock)
    arrival_time: Optional[float] = None
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
    def n_generated(self) -> int:
        return len(self.output_tokens)

    @property
    def last_token(self) -> int:
        return self.output_tokens[-1]

    @property
    def is_finished(self) -> bool:
        return self.state == RequestState.FINISHED
