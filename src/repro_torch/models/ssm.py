"""State-space / linear-recurrence layers: Mamba-2 (SSD), mLSTM, sLSTM
(torch twin of ``repro/models/ssm.py``).

One engine serves Mamba-2 and mLSTM, both matrix-state linear recurrences
    H_t = exp(lf_t) * H_{t-1} + exp(li_t) * k_t v_t^T
    y_t = q_t . H_t                      (optionally normalized, mLSTM)
with a per-head scalar log-decay lf <= 0 and log-gain li.  mLSTM also
carries a normalizer n_t and a log-stabilizer m (exponential input
gating) and outputs (q.H) / max(|q.n|, exp(-m)) in scaled units.  Three
forms compute it, as in the reference, each picked by the same test:
  * ``ssd_step``    one decode step (S == 1 with a state);
  * ``ssd_chunked`` the chunked form (S a multiple of the chunk, and
                    longer than one chunk): masked attention-like products
                    inside a chunk, the state carried across chunks;
  * ``ssd_naive``   the sequential scan (every other S).
They agree to f32 tolerance, not bit for bit.  The normalized chunked
form leaves out a factor exp(L_t) that the reference carries in both its
numerator and denominator, where it underflows at long chunks (R13 of
ROADMAP: the reference's quotient is 0 / 0 there).  States are f32; the conv
states bf16.  The quantized projections go through ``apply_linear`` (the
packed kernels K1 / K2 or the int8 kernel K5); ``w_dt`` and ``w_if`` stay
bf16 (``torch.matmul``).  ``plain=True`` runs the kernels' plain versions.

A block's parameters are a ``Leaves`` module: linear leaves as
submodules, tables, vectors and norms as buffers, all read as ``p[name]``
under the reference's names.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from .common import QuantMaker, apply_linear, rms_norm


class Leaves(nn.Module):
    """One block's leaves by name: linear leaves (``nn.Module``) as
    submodules, tensors as buffers; ``p[name]`` reads either."""

    def __init__(self, leaves: dict):
        super().__init__()
        self.names = tuple(leaves)
        for k, v in leaves.items():
            if isinstance(v, nn.Module):
                self.add_module(k, v)
            else:
                self.register_buffer(k, v)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def items(self):
        return [(k, self[k]) for k in self.names]


class SSMState(NamedTuple):
    """Carried recurrence state.  true_H = Hs * exp(m[..., None, None])."""
    Hs: torch.Tensor   # [B, nh, dk, dv] scaled matrix state
    ns: torch.Tensor   # [B, nh, dk]     scaled normalizer state
    m: torch.Tensor    # [B, nh]         log stabilizer


def init_state(b, nh, dk, dv, device=None) -> SSMState:
    f32 = torch.float32
    return SSMState(torch.zeros((b, nh, dk, dv), dtype=f32, device=device),
                    torch.zeros((b, nh, dk), dtype=f32, device=device),
                    torch.zeros((b, nh), dtype=f32, device=device))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (``F.softplus`` turns linear
    past 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# The three forms of the recurrence
# ---------------------------------------------------------------------------
def _single_step(carry: SSMState, qt, kt, vt, lft, lit, normalize: bool):
    hs, ns, m = carry
    qt, kt, vt = (a.to(torch.float32) for a in (qt, kt, vt))
    m_new = torch.maximum(lft + m, lit) if normalize else torch.zeros_like(m)
    decay = torch.exp(lft + m - m_new)[..., None]
    gain = torch.exp(lit - m_new)[..., None]
    hs = decay[..., None] * hs + (gain * kt)[..., None] * vt[..., None, :]
    ns = decay * ns + gain * kt
    num = torch.einsum("bhk,bhkv->bhv", qt, hs)
    if normalize:
        den = torch.abs(torch.einsum("bhk,bhk->bh", qt, ns))
        den = torch.maximum(den, torch.exp(-m_new))[..., None]
        y = num / den
    else:
        y = num
    return SSMState(hs, ns, m_new), y


def ssd_naive(q, k, v, lf, li, *, normalize: bool,
              state: Optional[SSMState] = None):
    """q, k [B, S, nh, dk]; v [B, S, nh, dv]; lf, li [B, S, nh] -> (y [B,
    S, nh, dv] f32, state): the sequential scan."""
    b, s, nh, dk = q.shape
    st = state if state is not None else init_state(b, nh, dk, v.shape[-1],
                                                    q.device)
    q, k, v, lf, li = (a.to(torch.float32) for a in (q, k, v, lf, li))
    ys = []
    for t in range(s):
        st, y = _single_step(st, q[:, t], k[:, t], v[:, t], lf[:, t],
                             li[:, t], normalize)
        ys.append(y)
    return torch.stack(ys, dim=1), st


def ssd_step(state: SSMState, qt, kt, vt, lft, lit, *, normalize: bool):
    """One decode step; the same math as one ``ssd_naive`` iteration.
    Returns (y [B, nh, dv], state)."""
    st, y = _single_step(state, qt, kt, vt, lft, lit, normalize)
    return y, st


def ssd_chunked(q, k, v, lf, li, *, chunk: int = 128, normalize: bool = False,
                state: Optional[SSMState] = None):
    """The chunked scan (S a multiple of ``chunk``); the same math as
    ``ssd_naive`` to f32 tolerance."""
    b, s, nh, dk = q.shape
    dv = v.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of the chunk {chunk}")
    nc = s // chunk
    hs, ns, m = state if state is not None else init_state(b, nh, dk, dv,
                                                           q.device)

    def chunk_of(a):
        return a.to(torch.float32).reshape(b, nc, chunk, *a.shape[2:])

    qs, ks, vs, lfs, lis = map(chunk_of, (q, k, v, lf, li))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nc):
        qc, kc, vc, lfc, lic = qs[:, c], ks[:, c], vs[:, c], lfs[:, c], \
            lis[:, c]
        cum = torch.cumsum(lfc, dim=1)                  # [B, C, nh] inclusive
        tot = cum[:, -1]                                # [B, nh]
        if normalize:
            # per-step stabilizer s_t = L_t + max(m, cummax_{j<=t}(li_j - L_j))
            cmx = torch.cummax(lic - cum, dim=1).values
            base = torch.maximum(m[:, None], cmx)       # [B, C, nh]
        else:
            base = torch.zeros_like(cum)
        # intra-chunk: W[t, j] = exp(li_j - L_j - base_t + L_t) for j <= t;
        # the exponent overflows to inf above the diagonal, where the
        # select (not a 0 / 1 multiply: inf * 0 is NaN) drops it.
        # Normalized, the reference's num and den both carry exp(L_t), which
        # underflows once a chunk's decay passes ~87 (chunk 128 at a mean
        # log-forget of -0.7: xlstm-350m), and the flushed 0 / 0 is NaN; the
        # port takes the factor out of both (the clamp exp(-base_t) becomes
        # exp(-base_t - L_t)): the same quotient, in units of O(1)
        lt = torch.zeros_like(cum) if normalize else cum
        expo = (lic - cum)[:, None, :, :] + (lt - base)[:, :, None, :]
        w = torch.where(tri, torch.exp(expo), zero)
        scores = torch.einsum("bthd,bjhd->btjh", qc, kc)
        intra = torch.einsum("btjh,bjhv->bthv", scores * w, vc)
        intra_n = torch.einsum("btjh,btjh->bth", scores, w)
        # inter: q_t . H_prev_true * exp(L_t) in the same scaled units
        inter_scale = torch.exp(m[:, None] + lt - base)      # [B, C, nh]
        inter = torch.einsum("bthd,bhdv->bthv", qc, hs) \
            * inter_scale[..., None]
        inter_n = torch.einsum("bthd,bhd->bth", qc, ns) * inter_scale
        num = inter + intra
        if normalize:
            den = torch.maximum(torch.abs(inter_n + intra_n),
                                torch.exp(-base - cum))
            ys.append(num / den[..., None])
        else:
            ys.append(num)
        # the state at the chunk's end
        g = lic + (tot[:, None] - cum)                  # [B, C, nh]
        if normalize:
            m_new = torch.maximum(m + tot, torch.amax(g, dim=1))
        else:
            m_new = torch.zeros_like(m)
        kg = kc * torch.exp(g - m_new[:, None])[..., None]
        hs = hs * torch.exp(m + tot - m_new)[..., None, None] + \
            torch.einsum("bthd,bthv->bhdv", kg, vc)
        ns = ns * torch.exp(m + tot - m_new)[..., None] + kg.sum(dim=1)
        m = m_new
    y = torch.stack(ys, dim=1).reshape(b, s, nh, dv)
    return y, SSMState(hs, ns, m)


def _recurrence(cfg_chunk: int, q, k, v, lf, li, normalize: bool,
                state: Optional[SSMState]):
    """The reference's choice of form, test for test
    (``ssm.py:257-265``, ``:338-346``)."""
    s = q.shape[1]
    if s == 1 and state is not None:
        y, st = ssd_step(state, q[:, 0], k[:, 0], v[:, 0], lf[:, 0],
                         li[:, 0], normalize=normalize)
        return y[:, None], st
    if s % cfg_chunk == 0 and s > cfg_chunk:
        return ssd_chunked(q, k, v, lf, li, chunk=cfg_chunk,
                           normalize=normalize, state=state)
    return ssd_naive(q, k, v, lf, li, normalize=normalize, state=state)


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (the Mamba front conv) with a decode state
# ---------------------------------------------------------------------------
def causal_conv1d(x, w_conv, conv_state=None):
    """x [B, S, C] bf16; w_conv [W, C] depthwise; conv_state [B, W-1, C].
    Returns (y [B, S, C], new_state [B, W-1, C]).  Every product and sum
    is rounded to x's dtype, as the reference evaluates it op by op."""
    width = w_conv.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    ext = torch.cat([conv_state, x], dim=1)             # [B, S+W-1, C]
    s = x.shape[1]
    y = ext[:, 0:s] * w_conv[0][None, None, :]
    for i in range(1, width):
        y = y + ext[:, i:i + s] * w_conv[i][None, None, :]
    return y.to(x.dtype), ext[:, ext.shape[1] - (width - 1):]


def _gated_out(y, z, norm, w_out, plain: bool):
    """rms_norm(y bf16) * silu(z) in bf16, then the out projection."""
    y = rms_norm(y.to(torch.bfloat16), norm) * torch.nn.functional.silu(
        z.to(torch.float32)).to(torch.bfloat16)
    return apply_linear(w_out, y, plain=plain)


# ---------------------------------------------------------------------------
# Mamba-2 block (the zamba2 backbone)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    d_head: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    scheme: Optional[str] = None

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.d_head


def mamba2_params(mk: QuantMaker, cfg: Mamba2Config) -> Leaves:
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    return Leaves({
        "w_zx": mk.dense("ssm.w_zx", d, 2 * di, cfg.scheme),
        "w_bc": mk.dense("ssm.w_bc", d, 2 * ds, cfg.scheme),
        "w_dt": mk.dense("ssm.w_dt", d, nh, None),
        "conv_x": mk.table("ssm.conv_x", cfg.conv_width, di, scale=0.5),
        "conv_bc": mk.table("ssm.conv_bc", cfg.conv_width, 2 * ds, scale=0.5),
        "A_log": mk.vector("ssm.A_log", nh, init=0.0),
        "dt_bias": mk.vector("ssm.dt_bias", nh, init=0.0),
        "D": mk.vector("ssm.D", nh, init=1.0),
        "norm": mk.norm("ssm.norm", di),
        "w_out": mk.dense("ssm.w_out", di, d, cfg.scheme),
    })


def mamba2_forward(params: Leaves, cfg: Mamba2Config, x, *, state=None,
                   conv_state=None, plain: bool = False):
    """x [B, S, D] -> (y [B, S, D], (ssm_state, (conv_x, conv_bc)))."""
    b, s, _ = x.shape
    di, ds, nh, dh = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.d_head
    zx = apply_linear(params["w_zx"], x, plain=plain)
    z, xc = zx.split(di, dim=-1)
    bc = apply_linear(params["w_bc"], x, plain=plain)
    dt = apply_linear(params["w_dt"], x, plain=plain)

    cs_x, cs_bc = conv_state if conv_state is not None else (None, None)
    xc, new_conv_x = causal_conv1d(xc, params["conv_x"], cs_x)
    bc, new_conv_bc = causal_conv1d(bc, params["conv_bc"], cs_bc)
    silu = torch.nn.functional.silu
    xc = silu(xc.to(torch.float32))
    bc = silu(bc.to(torch.float32))
    b_in, c_out = bc.split(ds, dim=-1)

    dt = softplus(dt.to(torch.float32) + params["dt_bias"])     # [B, S, nh]
    a = -torch.exp(params["A_log"].to(torch.float32))           # [nh] < 0
    lf = dt * a                                                 # log decay
    li = torch.log(torch.clamp_min(dt, 1e-9))                   # log gain

    q = c_out[:, :, None, :].expand(b, s, nh, ds)
    k = b_in[:, :, None, :].expand(b, s, nh, ds)
    v = xc.reshape(b, s, nh, dh)
    y, new_state = _recurrence(cfg.chunk, q, k, v, lf, li, False, state)

    y = y + params["D"][None, None, :, None] * v
    return (_gated_out(y.reshape(b, s, di), z, params["norm"],
                       params["w_out"], plain),
            (new_state, (new_conv_x, new_conv_bc)))


def mamba2_state_shapes(cfg: Mamba2Config, batch: int):
    """((Hs, ns, m) f32 shapes, (conv_x, conv_bc) bf16 shapes)."""
    nh, ds, dh = cfg.n_heads, cfg.d_state, cfg.d_head
    return (((batch, nh, ds, dh), (batch, nh, ds), (batch, nh)),
            ((batch, cfg.conv_width - 1, cfg.d_inner),
             (batch, cfg.conv_width - 1, 2 * cfg.d_state)))


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int = 4
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    scheme: Optional[str] = None

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def d_head(self) -> int:
        return self.d_inner // self.n_heads


def mlstm_params(mk: QuantMaker, cfg: MLSTMConfig) -> Leaves:
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
    return Leaves({
        "w_up": mk.dense("ssm.w_up", d, 2 * di, cfg.scheme),   # [x, z]
        "conv_w": mk.table("ssm.conv_w", cfg.conv_width, di, scale=0.5),
        "w_q": mk.dense("ssm.w_q", di, di, cfg.scheme),
        "w_k": mk.dense("ssm.w_k", di, di, cfg.scheme),
        "w_v": mk.dense("ssm.w_v", di, di, cfg.scheme),
        "w_if": mk.dense("ssm.w_if", di, 2 * nh, None),         # gates bf16
        "if_bias": mk.vector("ssm.if_bias", 2 * nh, init=0.0),
        "norm": mk.norm("ssm.norm", di),
        "w_out": mk.dense("ssm.w_out", di, d, cfg.scheme),
    })


def mlstm_forward(params: Leaves, cfg: MLSTMConfig, x, *, state=None,
                  conv_state=None, plain: bool = False):
    """x [B, S, D] -> (y [B, S, D], (ssm_state, conv_state))."""
    b, s, _ = x.shape
    di, nh, dh = cfg.d_inner, cfg.n_heads, cfg.d_head
    up = apply_linear(params["w_up"], x, plain=plain)
    xi, z = up.split(di, dim=-1)
    conv_out, new_conv = causal_conv1d(xi, params["conv_w"], conv_state)
    conv_out = torch.nn.functional.silu(
        conv_out.to(torch.float32)).to(torch.bfloat16)

    q = apply_linear(params["w_q"], conv_out,
                     plain=plain).reshape(b, s, nh, dh)
    # the reference divides the bf16 keys by sqrt(dh) rounded to bf16
    root = torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                   device=x.device)).to(torch.bfloat16)
    k = apply_linear(params["w_k"], conv_out,
                     plain=plain).reshape(b, s, nh, dh) / root
    v = apply_linear(params["w_v"], xi, plain=plain).reshape(b, s, nh, dh)
    gates = apply_linear(params["w_if"], conv_out, out_dtype=torch.float32,
                         plain=plain) + params["if_bias"]
    i_gate, f_gate = gates.split(nh, dim=-1)            # [B, S, nh]
    lf = log_sigmoid(f_gate)
    y, new_state = _recurrence(cfg.chunk, q, k, v, lf, i_gate, True, state)
    return (_gated_out(y.reshape(b, s, di), z, params["norm"],
                       params["w_out"], plain),
            (new_state, new_conv))


def mlstm_state_shapes(cfg: MLSTMConfig, batch: int):
    """((Hs, ns, m) f32 shapes, conv bf16 shape)."""
    nh, dh = cfg.n_heads, cfg.d_head
    return (((batch, nh, dh, dh), (batch, nh, dh), (batch, nh)),
            (batch, cfg.conv_width - 1, cfg.d_inner))


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar recurrence with per-head recurrent mixing
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int = 4
    scheme: Optional[str] = None

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def slstm_params(mk: QuantMaker, cfg: SLSTMConfig) -> Leaves:
    d, nh, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    return Leaves({
        "w_gates": mk.dense("ssm.w_gates", d, 4 * d, cfg.scheme),
        # per-head block-diagonal recurrent matrices, one per gate
        "r_gates": mk.table("ssm.r_gates", dh, dh, scale=0.02, lead=(4, nh)),
        "b_gates": mk.vector("ssm.b_gates", 4 * d, init=0.0),
        "norm": mk.norm("ssm.norm", d),
        "w_out": mk.dense("ssm.w_out", d, d, cfg.scheme),
    })


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, D] cell
    n: torch.Tensor   # [B, D] normalizer
    h: torch.Tensor   # [B, D] hidden (recurrent input)
    m: torch.Tensor   # [B, D] stabilizer


def slstm_init_state(b, d, device=None) -> SLSTMState:
    return SLSTMState(*(torch.zeros((b, d), dtype=torch.float32,
                                    device=device) for _ in range(4)))


def _slstm_step(params: Leaves, cfg: SLSTMConfig, st: SLSTMState, wx_t):
    """wx_t = W x_t [B, 4D] f32; returns (state, h [B, D])."""
    b = wx_t.shape[0]
    d, nh, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    rh = torch.einsum("bhd,ghde->bghe", st.h.reshape(b, nh, dh),
                      params["r_gates"].to(torch.float32)).reshape(b, 4 * d)
    zif = wx_t.to(torch.float32) + rh + params["b_gates"]
    z_t, i_t, f_t, o_t = zif.split(d, dim=-1)
    z_t = torch.tanh(z_t)
    o_t = torch.sigmoid(o_t)
    lf = log_sigmoid(f_t)
    m_new = torch.maximum(lf + st.m, i_t)
    c_new = torch.exp(lf + st.m - m_new) * st.c + torch.exp(i_t - m_new) * z_t
    n_new = torch.exp(lf + st.m - m_new) * st.n + torch.exp(i_t - m_new)
    h_new = o_t * c_new / torch.clamp_min(n_new, 1e-6)
    return SLSTMState(c_new, n_new, h_new, m_new), h_new


def slstm_forward(params: Leaves, cfg: SLSTMConfig, x, *,
                  state: Optional[SLSTMState] = None, plain: bool = False):
    """x [B, S, D] -> (y [B, S, D], state): a sequential loop over S."""
    b, s, d = x.shape
    st = state if state is not None else slstm_init_state(b, d, x.device)
    wx = apply_linear(params["w_gates"], x, out_dtype=torch.float32,
                      plain=plain)                      # [B, S, 4D]
    hs = []
    for t in range(s):
        st, h = _slstm_step(params, cfg, st, wx[:, t])
        hs.append(h)
    y = rms_norm(torch.stack(hs, dim=1).to(torch.bfloat16), params["norm"])
    return apply_linear(params["w_out"], y, plain=plain), st


def slstm_state_shapes(cfg: SLSTMConfig, batch: int):
    """The four f32 [batch, D] shapes of ``SLSTMState``."""
    return tuple((batch, cfg.d_model) for _ in range(4))

