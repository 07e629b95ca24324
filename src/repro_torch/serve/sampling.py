"""The serving sampling rule, one definition for every path (the
reference's ``serve/sampling.py``).

``sample_rows`` takes [N, V] f32 logits, per-row threefry keys [N, 2] and
temperatures [N]: greedy ``argmax`` where t <= 0, elsewhere
``argmax(gumbel(key, V) + logits / max(t, 1e-6))`` (``jax.random.
categorical`` as the reference vmaps it), the first maximum winning ties.
It runs on the logits' device inside the decode step and the decode
burst, so only [N] int32 ids cross to the host; ``sample_one`` samples the
first token off a prompt's final prefill-chunk logits.  The static-batch
loop of the recurrent families samples by the reference's legacy rule
instead (``sample_static``): one key for the whole batch.

Greedy rows never consume their key, and a batch without a temperature
row runs no sampler at all: ``sampler_inputs`` names the temperature rows
(``hot``) from the host's temperatures, once per dispatch, and
``sample_on_device`` samples each step of the dispatch from them.  A
token is a pure function of (seed, request id, step, logits): the keys
come from ``step_keys``, so a token sampled inside a burst equals the
same step run alone.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import threefry


def sampler_inputs(keys, temps, n: int, device):
    """The host side of one sampling dispatch over ``n`` rows, the one place
    the temperature rows are chosen: ``keys`` [n, 2] (or [K, n, 2]) uint32
    and ``temps`` [n] f32 numpy arrays (None: every row greedy) ->
    (keys, temps, hot) on ``device`` for ``sample_on_device``, ``hot`` the
    temperature rows.  Without a temperature row nothing else is moved
    (keys and temps are None)."""
    t = np.zeros((n,), np.float32) if temps is None \
        else np.asarray(temps, np.float32).reshape(n)
    rows = np.flatnonzero(t > 0)
    hot = torch.as_tensor(rows, dtype=torch.int64, device=device)
    if rows.size == 0:
        return None, None, hot
    if keys is None:
        raise ValueError("temperature rows need their sampling keys")
    return (threefry.keys_tensor(keys, device),
            torch.as_tensor(t, device=device), hot)


def sample_on_device(logits: torch.Tensor, keys: Optional[torch.Tensor],
                     temps: Optional[torch.Tensor],
                     hot: torch.Tensor) -> torch.Tensor:
    """[N, V] f32 logits -> [N] int32 ids, from ``sampler_inputs``' device
    tensors (``keys`` [N, 2]): the greedy argmax, with the ``hot`` rows
    replaced by their sampled ids.  No host sync."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if hot.numel() == 0:
        return greedy
    scores = temperature_scores(logits[hot], keys[hot], temps[hot])
    sampled = torch.argmax(scores, dim=-1).to(torch.int32)
    return greedy.index_copy(0, hot, sampled)


def sample_rows(logits: torch.Tensor, keys, temps) -> torch.Tensor:
    """[N, V] f32 logits -> [N] int32 ids.  ``keys`` [N, 2] uint32 and
    ``temps`` [N] f32 on the host (numpy)."""
    return sample_on_device(logits, *sampler_inputs(
        keys, temps, logits.shape[0], logits.device))


def temperature_scores(logits: torch.Tensor, keys,
                       temps: torch.Tensor) -> torch.Tensor:
    """The scores a temperature row's id is the argmax of: ``gumbel(key,
    V) + logits / max(t, 1e-6)``, [R, V] f32 (keys [R, 2], temps [R] on
    the logits' device)."""
    keys = threefry.keys_tensor(keys, logits.device)
    t = torch.clamp_min(temps, 1e-6)[:, None]
    return threefry.gumbel(keys, logits.shape[-1]) + logits / t


def sample_one(logits: torch.Tensor, key, temperature: float) -> int:
    """[V] logits -> one id (a host sync), by ``sample_rows``."""
    return int(sample_rows(logits[None], np.asarray(key).reshape(1, 2),
                           np.array([temperature], np.float32))[0])


def batched_step_keys(seeds, ids, starts, k: int) -> np.ndarray:
    """[R, k, 2] uint32 key schedules on the host: row r, step t is
    ``fold_in(fold_in(PRNGKey(seeds[r]), ids[r]), starts[r] + t)``, equal
    to ``Request.step_keys`` / ``step_key``.  Seeds, ids and starts are
    int32, as the reference takes them: a value outside [-2^31, 2^31)
    raises ``OverflowError``."""
    for name, vals in (("seed", seeds), ("id", ids), ("start", starts)):
        for v in np.asarray(vals).reshape(-1).tolist():
            if not -2**31 <= v < 2**31:
                raise OverflowError(
                    f"Python integer {v} out of bounds for int32 ({name})")
    return threefry.step_keys(seeds, ids, starts, k)


def sample_static(logits: torch.Tensor, key, temperature: float
                  ) -> torch.Tensor:
    """The static-batch loop's rule (the reference's ``ServingEngine.
    _sample``): [B, V] f32 logits -> [B] int32 ids, the argmax at
    ``temperature`` <= 0, else ``jax.random.categorical(key, logits / T)``
    with one key [2] for the whole batch: argmax(gumbel(key, (B, V)) +
    logits / T), the Gumbel draw's element (b, v) at flat index b V + v."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    b, v = logits.shape
    keys = threefry.keys_tensor(np.asarray(key).reshape(1, 2), logits.device)
    noise = threefry.gumbel(keys, b * v).reshape(b, v)
    return torch.argmax(noise + logits / temperature, dim=-1).to(torch.int32)
