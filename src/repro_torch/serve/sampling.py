"""The serving sampling rule: greedy, one definition for every path.

``sample_rows`` runs on the device inside the decode step and the decode
burst, so only [N] int32 ids cross to the host; ``sample_one`` samples the
first token off a prompt's final prefill-chunk logits.  Temperature
sampling (which must reproduce the reference's threefry key schedule) is
not ported yet: ``SamplingParams`` rejects a temperature above 0.
"""
from __future__ import annotations

import torch


def sample_rows(logits: torch.Tensor) -> torch.Tensor:
    """[N, V] logits -> [N] int32 greedy ids (first maximum on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_one(logits: torch.Tensor) -> int:
    """[V] logits -> one greedy id (a host sync)."""
    return int(sample_rows(logits[None])[0])
