"""Where the logits of the kernel path part from the plain path's: one
full-width model run teacher-forced through several versions of the
matmuls and the decode attention, each held against the plain versions.

  PYTHONPATH=src python -m repro_torch.launch.logit_spread --arch granite-8b

Versions (``VARIANTS``), each run with bf16 and with int8 KV:
  plain_again   the plain versions once more (the run-to-run floor);
  kernels       the CUDA kernels, as serving runs them;
  plain_splitk  plain, but every matmul sums its product over 8 slices of
                K in turn: the plain math in another summation order, with
                no kernel (for w8a8 the int32 sum is exact, so this equals
                plain);
  plain_splitkv plain, but the decode attention walks the sequence in the
                kernel's order (spans of 64 positions; in a span, 4 runs of
                the online-softmax update over 8 positions of each tile of
                32, merged in order; then the spans' merge);
  plain_groupk  plain, but every packed matmul takes K2's association: per
                scale group, x @ codes in f32, times the group's scale,
                summed in group order (w8a8 unchanged: exact);
  drop_split    plain_splitk leaving out the last slice (a split-K reduce
                that loses one partial);
  drop_group    plain leaving out the first weight group (its rows of K)
                of every packed matmul, or the first 128 rows of K (at
                most an eighth) of every w8a8 matmul.
For each version it prints, per layer, the residual stream's difference
from the plain run (max |diff| / max |x|, and the share of elements that
differ), and the logit check that ``chip_smoke.py`` applies
(``logit_check``).  Writes ``chiprun_out/logit_spread.json``.
``--smoke --device cpu`` runs the 2-layer config on the CPU, where the
kernels' wrappers take their plain versions.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops
from repro_torch.kernels.packed_matmul import packed_matmul_grouped
from repro_torch.models import transformer as T
from repro_torch.models.common import QuantMaker
from repro_torch.quant.kv_cache import cache_read
from repro_torch.quant.pack import codes_per_word
from repro_torch.quant.schemes import dequantize, effective_group
from repro_torch.serve.engine import resolve_device

# kernel-path logits vs plain-path logits: the reference engine's 5e-2
# tolerance taken relative to the logit scale (max |logit|), since the
# paths' difference does not shrink with a logit's size (see VARIANTS)
LOGIT_REL_TOL = 5e-2
# a kernel path that misses that bound still passes when a plain path
# summed in the kernels' order (no kernel) spreads at least 1 / factor as
# far (``witness_check``); planted faults spread 10x further (PERF.md)
WITNESS_FACTOR = 1.5
SPLITS = 8
ROWS, CHUNK, STEPS = 8, 64, 4
VARIANTS = ("plain_again", "kernels", "plain_splitk", "plain_splitkv",
            "plain_groupk", "drop_split", "drop_group")


def logit_check(got: torch.Tensor, want: torch.Tensor,
                rel_tol: float = LOGIT_REL_TOL) -> dict:
    """max |got - want| <= rel_tol * max |want|, and equal argmax wherever
    ``want``'s top-2 gap exceeds twice that bound."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = rel_tol * scale
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
    same = got.argmax(-1) == want.argmax(-1)
    return {"finite": bool(torch.isfinite(got).all()),
            "max_abs_logit_diff": err, "max_abs_logit": scale,
            "tolerance": tol, "logits_ok": err <= tol,
            "tokens": int(decided.numel()),
            "decided_tokens": int(decided.sum()),
            "greedy_agree": bool((same | ~decided).all()),
            "argmax_agree_all": int(same.sum())}


def witness_check(res: dict, witness: dict,
                  factor: float = WITNESS_FACTOR) -> bool:
    """The order-only witness rule, for a kernel path whose logits miss
    ``logit_check``'s bound: ``res`` (kernels vs plain) spreads at most
    ``factor`` times as far as ``witness`` (the plain path in the kernels'
    summation order vs plain), both from ``logit_check``."""
    return res["max_abs_logit_diff"] <= factor * witness["max_abs_logit_diff"]


def teacher_forced(cfg, params, prompts: torch.Tensor, steps: int, *,
                   kv: str, plain: bool, max_len: int = 512, feed=None,
                   layer_out=None):
    """One prefill chunk per row (``prompts`` [rows, chunk], each row in its
    own cache slot), then ``steps`` decode steps over all rows, fed
    ``feed`` when given, else each step's greedy ids.  Returns (logits
    [1 + steps, rows, V] f32, the ids fed)."""
    rows, chunk = prompts.shape
    dev = prompts.device
    cache = T.init_cache(cfg, rows, max_len, kv_dtype=kv, device=dev)
    with torch.no_grad():
        last = [T.forward(cfg, params, prompts[r:r + 1],
                          cache=tuple(s[:, r:r + 1] for s in cache),
                          cache_index=0, mode="prefill_chunk", plain=plain,
                          layer_out=layer_out)[0, -1] for r in range(rows)]
        seq = [torch.stack(last)]
        ids = [seq[0].argmax(-1) if feed is None else feed[0]]
        lengths = torch.full((rows,), chunk, dtype=torch.int64, device=dev)
        for t in range(steps):
            lg = T.forward(cfg, params, ids[-1][:, None], cache=cache,
                           cache_index=lengths, mode="decode", plain=plain,
                           layer_out=layer_out)[:, -1]
            seq.append(lg)
            lengths = lengths + 1
            ids.append(lg.argmax(-1) if feed is None else feed[t + 1])
    return torch.stack(seq), ids


def _weights(packed, scales, scheme):
    k = packed.shape[0] * codes_per_word(scheme.weight_bits)
    return dequantize(scheme, packed, scales, (k, packed.shape[1]))


def _slices(k: int, drop=None):
    step = k // SPLITS
    return [slice(s * step, (s + 1) * step) for s in range(SPLITS)
            if s != drop]


def splitk_plain(drop=None):
    """The plain packed matmul summed over SPLITS slices of K in turn,
    leaving out slice ``drop``."""
    def matmul(x, packed, scales, scheme):
        w = _weights(packed, scales, scheme)
        xf = x.to(torch.float32)
        out = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                          device=x.device)
        for sl in _slices(w.shape[0], drop):
            out += xf[:, sl] @ w[sl]
        return out
    return matmul


def drop_group_plain(x, packed, scales, scheme):
    """The plain packed matmul without the first weight group's rows."""
    w = _weights(packed, scales, scheme)
    g = effective_group(scheme.group_size, w.shape[0])
    return x[:, g:].to(torch.float32) @ w[g:]


def _w8a8_rows(rows_of):
    """The plain w8a8 matmul summed over the K slices ``rows_of(K)`` in
    turn (exact integer sums, as in ``w8a8_matmul_plain``)."""
    def matmul(x_codes, x_scale, w_codes_t, w_scales):
        xf, wf = x_codes.to(torch.float64), w_codes_t.to(torch.float64)
        acc = sum(xf[:, sl] @ wf[:, sl].t() for sl in rows_of(xf.shape[1]))
        return acc.to(torch.int32).to(torch.float32) * (w_scales * x_scale)
    return matmul


def _merge(parts):
    """(max, sum, acc) partials merged in order, as the kernel merges its
    warps and its spans."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp(p[0] - m) for p in parts]
    l = sum(p[1] * wi for p, wi in zip(parts, w))
    acc = sum(p[2] * wi for p, wi in zip(parts, w))
    return m, l, acc


def splitkv_attention_plain(q, k_cache, v_cache, kv_valid_len):
    """The plain decode attention in the CUDA kernel's order: the sequence
    cut into the kernel's spans (``DA.split_plan``); in a span, warp w
    walks positions [GROUP w, GROUP (w + 1)) of each tile of ``DA.TILE``
    with the online-softmax update, the warps' (max, sum, acc) merged in
    warp order, then the spans' in span order.  (Positions past a row's
    length change nothing: their weights are exactly 0.)"""
    b, _, h, dh = q.shape
    k = cache_read(k_cache, torch.float32).to(torch.float32)
    v = cache_read(v_cache, torch.float32).to(torch.float32)
    sk, hk = k.shape[1], k.shape[2]
    qg = (q[:, 0].to(torch.float32) * DA.query_scale(dh)).reshape(
        b, hk, h // hk, dh)
    lens = kv_valid_len.to(q.device)[:, None, None, None]
    span, splits = DA.split_plan(sk)
    spans = []
    for sp in range(splits):
        end = min((sp + 1) * span, sk)
        warps = []
        for w in range(DA.WARPS):
            m = torch.full((*qg.shape[:3], 1), DA._NEG, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(qg)
            for t0 in range(sp * span, end, DA.TILE):
                p0 = t0 + DA.GROUP * w
                p1 = min(p0 + DA.GROUP, end)
                if p0 >= p1:
                    continue
                pos = torch.arange(p0, p1, device=q.device)
                s = torch.einsum("bgrd,bkgd->bgrk", qg, k[:, p0:p1])
                s = torch.where(pos < lens, s, torch.full_like(s, DA._NEG))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.einsum("bgrk,bkgd->bgrd", p,
                                                v[:, p0:p1])
                m = m_new
            warps.append((m, l, acc))
        spans.append(_merge(warps))
    _, l, acc = _merge(spans)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, 1, h, dh).to(q.dtype)


@contextlib.contextmanager
def plain_ops(replace):
    """Route the plain path's ``ops`` functions named in ``replace``
    ({name: function}) through the given functions."""
    saved = {name: getattr(ops, name) for name in replace}
    for name, fn in replace.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


RUNS = {  # variant: (plain, {ops function: the version it runs})
    "plain": (True, {}), "plain_again": (True, {}), "kernels": (False, {}),
    "plain_splitk": (True, {
        "packed_matmul_plain": splitk_plain(),
        "w8a8_matmul_plain": _w8a8_rows(_slices)}),
    "plain_splitkv": (True, {
        "decode_attention_plain": splitkv_attention_plain}),
    "plain_groupk": (True, {"packed_matmul_plain": packed_matmul_grouped}),
    "drop_split": (True, {
        "packed_matmul_plain": splitk_plain(drop=SPLITS - 1),
        "w8a8_matmul_plain": _w8a8_rows(
            lambda k: _slices(k, drop=SPLITS - 1))}),
    "drop_group": (True, {
        "packed_matmul_plain": drop_group_plain,
        "w8a8_matmul_plain": _w8a8_rows(
            lambda k: [slice(min(128, k // SPLITS), k)])})}


def layer_spread(got: list, want: list, n_layers: int) -> dict:
    """Per layer, over every forward call: max |diff| / max |x| of the
    residual stream, and the share of its elements that differ."""
    rel, share = [], []
    for l in range(n_layers):
        a, b = got[l::n_layers], want[l::n_layers]
        diff = max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))
        scale = max(float(y.float().abs().max()) for y in b)
        ndiff = sum(int((x != y).sum()) for x, y in zip(a, b))
        rel.append(diff / scale)
        share.append(ndiff / sum(y.numel() for y in b))
    return {"layer_rel_diff": rel, "layer_diff_share": share}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config(args.arch, smoke=args.smoke)
    with torch.no_grad():
        params = T.build_params(cfg, QuantMaker(0, device=dev))
    # chip_smoke.py's model phase: 8 rows, a 64-token chunk, 4 decode steps
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab, (ROWS, CHUNK)),
                              device=dev)
    result = {"device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"), "arch": cfg.name,
              "rows": ROWS, "chunk": CHUNK, "steps": STEPS,
              "runs": []}
    for kv in ("bf16", "int8"):
        logits, layers, feed = {}, {}, None
        # the kernel run first: its greedy ids feed every other run
        for name in ("kernels", "plain",
                     *(v for v in VARIANTS if v != "kernels")):
            plain, replace = RUNS[name]
            layers[name] = []
            with plain_ops(replace):
                logits[name], ids = teacher_forced(
                    cfg, params, prompts, STEPS, kv=kv, plain=plain,
                    feed=feed, layer_out=layers[name])
            feed = feed or ids
        for name in VARIANTS:
            run = {"kv": kv, "variant": name,
                   **logit_check(logits[name], logits["plain"]),
                   **layer_spread(layers[name], layers["plain"],
                                  cfg.n_layers)}
            result["runs"].append(run)
            print(json.dumps(run), flush=True)
        print(f"kv={kv}: residual max |diff| / max |x| vs plain, by layer")
        print("layer " + " ".join(f"{n:>13}" for n in VARIANTS))
        for l in range(cfg.n_layers):
            print(f"{l:5d} " + " ".join(
                f"{r['layer_rel_diff'][l]:13.3e}" for r in result["runs"]
                if r["kv"] == kv), flush=True)
        del logits, layers
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "logit_spread.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
