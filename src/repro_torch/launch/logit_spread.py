"""Where the logits of the kernel path part from the plain path's: one
full-width model run teacher-forced through several versions of the
packed matmul, each held against the plain versions.

  PYTHONPATH=src python -m repro_torch.launch.logit_spread --arch granite-8b

Versions (``VARIANTS``), each run with bf16 and with int8 KV:
  plain_again   the plain versions once more (the run-to-run floor);
  kernels       the CUDA kernels, as serving runs them;
  plain_splitk  plain, but every packed matmul sums its f32 product over
                8 slices of K in turn: the plain math in another f32
                summation order, with no kernel;
  drop_split    plain_splitk leaving out the last slice (a split-K reduce
                that loses one partial);
  drop_group    plain leaving out the first weight group (its rows of K)
                of every packed matmul.
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
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.common import QuantMaker
from repro_torch.quant.pack import codes_per_word
from repro_torch.quant.schemes import dequantize, effective_group
from repro_torch.serve.engine import resolve_device

# kernel-path logits vs plain-path logits: the reference engine's 5e-2
# tolerance taken relative to the logit scale (max |logit|), since the
# paths' difference does not shrink with a logit's size (see VARIANTS)
LOGIT_REL_TOL = 5e-2
SPLITS = 8
ROWS, CHUNK, STEPS = 8, 64, 4
VARIANTS = ("plain_again", "kernels", "plain_splitk", "drop_split",
            "drop_group")


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


def splitk_plain(drop=None):
    """The plain packed matmul summed over SPLITS slices of K in turn,
    leaving out slice ``drop``."""
    def matmul(x, packed, scales, scheme):
        w = _weights(packed, scales, scheme)
        xf = x.to(torch.float32)
        step = w.shape[0] // SPLITS
        out = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                          device=x.device)
        for s in range(SPLITS):
            if s != drop:
                out += xf[:, s * step:(s + 1) * step] @ w[s * step:
                                                          (s + 1) * step]
        return out
    return matmul


def drop_group_plain(x, packed, scales, scheme):
    """The plain packed matmul without the first weight group's rows."""
    w = _weights(packed, scales, scheme)
    g = effective_group(scheme.group_size, w.shape[0])
    return x[:, g:].to(torch.float32) @ w[g:]


@contextlib.contextmanager
def plain_matmul(fn):
    """Route the plain path's packed matmuls through ``fn``."""
    saved = ops.packed_matmul_plain
    ops.packed_matmul_plain = fn or saved
    try:
        yield
    finally:
        ops.packed_matmul_plain = saved


RUNS = {  # variant: (plain, the plain packed matmul it uses)
    "plain": (True, None), "plain_again": (True, None),
    "kernels": (False, None), "plain_splitk": (True, splitk_plain()),
    "drop_split": (True, splitk_plain(drop=SPLITS - 1)),
    "drop_group": (True, drop_group_plain)}


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
            plain, fn = RUNS[name]
            layers[name] = []
            with plain_matmul(fn):
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
