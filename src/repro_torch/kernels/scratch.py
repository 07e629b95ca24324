"""Zeroed int32 buffers that kernels share across launches on one stream.

K1's column-tile counters and K5's split accumulator and counters are
zero before each launch: the kernel's last block per tile resets what it
used, so launches in stream order can share one buffer per (name, device,
stream) and none is cleared by the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_BUFFERS: Dict[Tuple[str, int, int], torch.Tensor] = {}


def zeroed(name: str, device: torch.device, stream: int,
           numel: int) -> torch.Tensor:
    """The int32 buffer ``name`` for launches on ``stream`` of ``device``,
    at least ``numel`` long and zero; a larger one is made (zeroed) where
    a launch needs more."""
    key = (name, device.index, stream)
    buf = _BUFFERS.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.zeros(max(numel, 1024), dtype=torch.int32, device=device)
        _BUFFERS[key] = buf
    return buf
