"""The parts of ``jax.random`` that the serving sampler runs, bit for bit.

The reference samples with legacy uint32 ``PRNGKey`` arrays under jax's
default settings: ``jax_enable_x64`` off and ``jax_threefry_partitionable``
on.  Under those settings:

  * ``PRNGKey(seed)`` takes the seed as a 32-bit integer: the key is
    ``[0, seed mod 2^32]`` (the high word of a 32-bit seed is 0).
  * ``fold_in(key, d)`` = ``threefry2x32(key, (0, d mod 2^32))``, the two
    output words forming the new key; ``split(key)``'s key i is
    ``fold_in(key, i)``.
  * The random bits of a draw of n elements: element i is ``y0 ^ y1`` of
    ``threefry2x32(key, (i >> 32, i mod 2^32))`` (the partitionable
    layout: one counter pair per element, not one counter array split in
    halves).
  * ``uniform(minval, maxval)``: ``(bits >> 9) | 0x3F800000`` read as an
    f32 in [1, 2), minus 1, times ``maxval - minval``, plus ``minval``,
    then ``max(minval, .)``, all in f32.
  * ``gumbel`` ("low" mode, the default): ``-log(-log(uniform(tiny, 1)))``
    with ``tiny`` the least normal f32.

Every function here takes numpy integer arrays (the host's key schedule:
a few keys per round, exact) or torch int64 tensors (the per-element bits
of a [rows, V] draw, on the logits' device), with 32-bit words held as
int64 values in [0, 2^32): torch has no general uint32 arithmetic on CUDA,
so every sum and shift is masked back to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
F32_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (5 groups of 4, a key injection after
    each), as ``jax._src.prng._threefry2x32_lowering``.  Arguments
    broadcast; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _words(a) -> np.ndarray:
    """Integers (any sign, any width) -> int64 values mod 2^32."""
    return np.asarray(a, dtype=np.int64) & MASK


def prng_key(seed) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` -> [..., 2] uint32 (seed as int32)."""
    lo = _words(seed)
    return np.stack([np.zeros_like(lo), lo], -1).astype(np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: key [..., 2] uint32, data integers
    broadcasting against key[..., 0] -> [..., 2] uint32."""
    key = _words(key)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, _words(data))
    return np.stack(np.broadcast_arrays(y0, y1), -1).astype(np.uint32)


def split(key):
    """``jax.random.split(key)`` -> (key0, key1), each [2] uint32: under
    the partitionable layout key i is ``threefry2x32(key, (0, i))``, the
    same as ``fold_in(key, i)``."""
    both = fold_in(np.asarray(key)[None, :], np.arange(2))
    return both[0], both[1]


def step_keys(seeds, ids, starts, k: int) -> np.ndarray:
    """[R, k, 2] uint32: row r, step t is ``fold_in(fold_in(PRNGKey(
    seeds[r]), ids[r]), starts[r] + t)`` (``batched_step_keys`` and
    ``Request.step_keys`` of the reference)."""
    base = fold_in(prng_key(np.asarray(seeds).reshape(-1)),
                   np.asarray(ids).reshape(-1))                     # [R, 2]
    steps = (np.asarray(starts, np.int64).reshape(-1, 1)
             + np.arange(k, dtype=np.int64))                        # [R, k]
    return fold_in(base[:, None, :], steps)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for each of n elements under each key: keys [R, 2]
    int64 (uint32 values) -> [R, n] int64 in [0, 2^32), on keys' device."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], i >> 32, i & MASK)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for each
    key row -> [R, n] f32.  The multiply-add rounds twice where XLA's CPU
    fuses it into one FMA: the same whenever ``maxval - minval`` rounds to
    1 in f32, as on the sampler's ranges [0, 1) and [tiny, 1)."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` ("low" mode) for each key
    row -> [R, n] f32.  ``log`` is the platform's, so the last ulp may
    differ from XLA's."""
    return -torch.log(-torch.log(uniform(keys, n, F32_TINY, 1.0)))


def keys_tensor(keys, device) -> torch.Tensor:
    """uint32 keys [..., 2] (numpy, or a tensor of any integer dtype) ->
    int64 tensor of their 32-bit values on ``device``."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64) & MASK
    return torch.as_tensor(_words(keys), device=device)
