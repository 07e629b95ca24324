"""The XtraMAC virtual-DSP packed multiply (paper Eqs. 9-11): CUDA kernel K6
and its plain version.

Torch side of ``csrc/xtramac_mac.cu``, which replaces the Pallas kernel
``repro/kernels/xtramac_mac.py:_vdsp_kernel``.  Per issue t, the lane
magnitudes are OR-ed into two port words at the ``LanePlan`` offsets
(Eq. 9), multiplied once (Eq. 10), and each lane product read back as
``(P >> pos) & (2^stride - 1)`` in ``plan.lane_positions`` order (Eq. 11).

  * ``virtual_dsp_multiply``      — a int32 [T, n_a], b int32 [T, n_b] ->
    int32 [T, P], the counterpart of the reference's entry point, on the
    reference kernel's domain (lane windows of <= 19 bits below bit 48);
  * ``virtual_dsp_multiply_wide`` — [..., n_a], [..., n_b] -> int64
    [..., P] for every plan ``LanePlan.validate`` admits (strides up to 40
    occur); ``core/packing.packed_multiply`` calls it;
  * ``virtual_dsp_plain``         — plain torch on any device (int64 pack,
    multiply, shift and mask).

The two kernel wrappers launch the kernel on CUDA tensors, return the plain
version on CPU tensors and raise for any other device.  ``launches`` counts
kernel launches of both; plain calls do not count.  ``plan`` is any object
with ``offsets_a``, ``offsets_b``, ``stride`` and ``lane_positions`` (the
port's ``core.packing.LanePlan``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from . import build

launches: Dict[str, int] = {"virtual_dsp_multiply": 0}

MAX_PORT_LANES = 16       # per port, the kernel's plan struct
MAX_LANES = 32
# the reference kernel's lane window (_extract_lane: width <= 19, window
# within its three 16-bit limbs)
REF_MAX_STRIDE = 19
REF_MAX_BIT = 48


class _Plan(ctypes.Structure):
    """Mirror of ``VdspLanePlan`` in csrc/xtramac_mac.cu (all 32-bit ints)."""
    _fields_ = [("n_a", ctypes.c_int), ("n_b", ctypes.c_int),
                ("n_lanes", ctypes.c_int), ("stride", ctypes.c_int),
                ("off_a", ctypes.c_int * MAX_PORT_LANES),
                ("off_b", ctypes.c_int * MAX_PORT_LANES),
                ("pos", ctypes.c_int * MAX_LANES)]


_P = ctypes.c_void_p
_SIGNATURE = [_P, _P, _P, ctypes.c_longlong, ctypes.POINTER(_Plan), _P]
_SIGNATURES = {"vdsp_multiply_i32": _SIGNATURE,
               "vdsp_multiply_i64": _SIGNATURE}


def pack_port(offsets: Sequence[int], mags: torch.Tensor) -> torch.Tensor:
    """Eq. (9): mags[..., lane] -> packed port word (int64, <= 27 bits)."""
    mags = mags.to(torch.int64)
    word = torch.zeros(mags.shape[:-1], dtype=torch.int64, device=mags.device)
    for lane, off in enumerate(offsets):
        word = word | (mags[..., lane] << off)
    return word


def virtual_dsp_plain(a_mags: torch.Tensor, b_mags: torch.Tensor,
                      plan) -> torch.Tensor:
    """Eqs. (9)-(11) in plain torch: pack, ONE wide multiply (<= 45 bits,
    exact in int64), shift-and-mask extraction.  a_mags [..., n_a], b_mags
    [..., n_b] -> int64 lane products [..., P]."""
    a_word = pack_port(plan.offsets_a, a_mags)
    b_word = pack_port(plan.offsets_b, b_mags)
    prod = a_word * b_word
    mask = (1 << plan.stride) - 1
    return torch.stack([(prod >> pos) & mask
                        for (_, _, pos) in plan.lane_positions], dim=-1)


def _kernel_plan(plan) -> _Plan:
    n_a, n_b = len(plan.offsets_a), len(plan.offsets_b)
    pos = [p for (_, _, p) in plan.lane_positions]
    if n_a > MAX_PORT_LANES or n_b > MAX_PORT_LANES or len(pos) > MAX_LANES:
        raise ValueError(f"virtual DSP: {n_a} x {n_b} lanes, the kernel takes "
                         f"at most {MAX_PORT_LANES} per port and {MAX_LANES}")
    if not 1 <= plan.stride <= 63 or max(
            (*plan.offsets_a, *plan.offsets_b, *pos)) > 63:
        raise ValueError(f"virtual DSP: stride {plan.stride} or an offset "
                         "outside a 64-bit word")
    return _Plan(n_a, n_b, len(pos), plan.stride,
                 (ctypes.c_int * MAX_PORT_LANES)(*plan.offsets_a),
                 (ctypes.c_int * MAX_PORT_LANES)(*plan.offsets_b),
                 (ctypes.c_int * MAX_LANES)(*pos))


def _launch(a_mags: torch.Tensor, b_mags: torch.Tensor, plan,
            dtype: torch.dtype) -> torch.Tensor:
    """K6 over [..., n_a] x [..., n_b] -> [..., P] in ``dtype`` (int32 or
    int64, inputs cast to it)."""
    kplan = _kernel_plan(plan)
    if a_mags.device != b_mags.device:
        raise ValueError(f"virtual DSP: a on {a_mags.device}, b on "
                         f"{b_mags.device}")
    lead = a_mags.shape[:-1]
    if (a_mags.shape[-1] != kplan.n_a or b_mags.shape[-1] != kplan.n_b
            or b_mags.shape[:-1] != lead):
        raise ValueError(f"virtual DSP: shapes {tuple(a_mags.shape)} x "
                         f"{tuple(b_mags.shape)} for a {kplan.n_a} x "
                         f"{kplan.n_b} lane plan")
    if a_mags.device.type == "cpu":
        return virtual_dsp_plain(a_mags, b_mags, plan).to(dtype)
    if a_mags.device.type != "cuda":
        raise ValueError(f"virtual DSP: no kernel for device {a_mags.device}")
    a = a_mags.to(dtype).contiguous()
    b = b_mags.to(dtype).contiguous()
    out = torch.empty((*lead, kplan.n_lanes), dtype=dtype,
                      device=a_mags.device)
    rows = out.numel() // kplan.n_lanes
    if rows == 0:
        return out
    lib = build.load("xtramac_mac", _SIGNATURES)
    fn = lib.vdsp_multiply_i32 if dtype == torch.int32 else \
        lib.vdsp_multiply_i64
    with torch.cuda.device(a_mags.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows,
                 ctypes.byref(kplan), torch.cuda.current_stream().cuda_stream)
    build.check(lib, "virtual_dsp_multiply", err)
    launches["virtual_dsp_multiply"] += 1
    return out


def check_reference_domain(plan) -> None:
    """Raise ValueError where the reference kernel's lane extraction would
    refuse the plan (a lane window wider than 19 bits or past bit 48)."""
    for (_, _, pos) in plan.lane_positions:
        if plan.stride > REF_MAX_STRIDE or pos + plan.stride > REF_MAX_BIT:
            raise ValueError(
                f"virtual_dsp_multiply: lane window [{pos}, "
                f"{pos + plan.stride}) is outside the reference kernel's "
                f"domain (width <= {REF_MAX_STRIDE}, below bit "
                f"{REF_MAX_BIT}); use virtual_dsp_multiply_wide")


def virtual_dsp_multiply(a_mags: torch.Tensor, b_mags: torch.Tensor,
                         plan) -> torch.Tensor:
    """Packed lane products int32 [T, P] from magnitudes [T, n_a] x
    [T, n_b] (cast to int32, as the reference does)."""
    check_reference_domain(plan)
    if a_mags.dim() != 2:
        raise ValueError("virtual_dsp_multiply: magnitudes must be [T, n]")
    return _launch(a_mags.to(torch.int32), b_mags.to(torch.int32), plan,
                   torch.int32)


def virtual_dsp_multiply_wide(a_mags: torch.Tensor, b_mags: torch.Tensor,
                              plan) -> torch.Tensor:
    """Packed lane products int64 [..., P] for any plan within the kernel's
    64-bit word."""
    return _launch(a_mags, b_mags, plan, torch.int64)
