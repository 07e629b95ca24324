"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases (a failed check is reported at once and makes the run exit
non-zero after the last phase; exceptions are not caught):
  0. the card's name and power limit, torch and CUDA versions;
  1. build every CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a,
     one process per source, all started together);
  2. every kernel against its plain torch version at its path's
     full-width shapes (zamba2-7b's and xlstm-350m's among them: K1 at
     M = 4 and K2 at M = 256 and 1024 on each of zamba2's awq_int4
     leaf shapes, 3584 x 14336, 3584 x 128, 7168 x 3584, 3584 x 3584 and
     14336 x 3584, K5 at M = 4 and 1024 on 2048 x 2048, K3 / K4 at 4
     rows of 32 / 32 heads, Dh 112; phi-3-vision-4.2b's: K1 at M = 4 and
     K2 at M = 1280 on its fp8 leaves 3072 x 3072, 3072 x 8192 and 8192 x
     3072, K3 / K4 in three KV tiers at 4 rows of 32 / 32 heads, Dh 96,
     Sk 336; whisper-medium's: K5 at M = 4, 256 and 6000 on its W8A8
     leaves 1024 x 1024, 1024 x 4096 and 4096 x 1024, K3 / K4 at bf16 /
     int8 KV at 4 rows of 16 / 16 heads, Dh 64, Sk 80), timed with CUDA
     events (L2 flushed before each
     launch) beside its bound, its plain version and one library call:
     the packed GEMV (K1, M = 1, 3, 8) and the tensor-core packed matmul (K2,
     M = 9, 64, 100) for three schemes on granite's four linear shapes
     (on its awq_int4 leaves also M = 15, the width of the mixed-tier
     path's int8 / fp8 decode cohorts), plus K2 on a ragged N (1000) and on decode leaves with N % 4 != 0
     (1022) that the dispatch routes to it; decode attention (K3 / K4) in
     three KV tiers on six head layouts (Dh 128, 192, 64, 112, 128 at 48
     / 4 heads, 96), also
     with zero-length rows (equal weights over the slab), and at the
     mixed-tier path's cohorts (int8 / fp8 at B = 15, bf16 at B = 8, over
     slabs of capacity 512); the int8 matmul
     (K5, also at M = 3, at K = 4100 and with x at an unaligned address,
     each taken as it is) and the virtual-DSP lane multiply
     (K6, the counterpart of ``repro/kernels/xtramac_mac.py``) must match
     their plain versions exactly, K6 for every paper datatype pair at the
     Table VII GEMV size (50,331,648 lane MACs: T = 50,331,648 / P issues)
     and, in both instantiations, at a T that is no whole number of its
     row tiles; K1 / K2 also on mxfp4 at starcoder2-15b's four linear
     shapes and on fp8 at its two attention shapes, K1 at M = 8 on
     nemotron-4-340b's 73728 x 18432 leaf (53 splits), and decode
     attention on starcoder2's 48 / 4 heads (Dh 128); the expert-grouped
     K1 / K2 (one launch over a stack of 128 experts, ids and row counts
     read on the card) on qwen3-moe's awq_int4 expert leaves (2048 x 768,
     768 x 2048), both run by one persistent body: grouped K1 at the
     decode step's 64 (row, expert) pairs of one row, at a 64-token
     chunk's 128 capacity buffers of 5 rows and at 16 rows that name one
     expert (two items of its work list), grouped K2 at the buffers of a
     128-, 256- and 512-token chunk (10, 20, 40 rows), both at 40 groups
     of 3 rows over 8 experts (repeated experts, empty groups); rows past
     a group's count must be exactly zero, and the bound counts the bytes
     of the distinct experts the groups read; every grouped case also
     against its plain twin in the body's association and order
     (``packed_gemv_grouped_ordered``); the decode pairs launched again
     one row's 8 pairs at a time (G = 8), and the 128-token chunk's live
     rows launched again one row a group (M = 1, grouped K1), must give
     each row bit for bit; the same grouped checks on deepseek-v2-236b's
     fp8 expert leaves (160 experts, 5120 x 1536 and 1536 x 5120): the
     decode step's 48 pairs (8 rows x top-6), the buffers of a 64-token
     chunk (160 x 4 rows, grouped K1) and of a 256-token one (160 x 12,
     grouped K2, its live rows again at M = 1), and the repeats; K1 at M =
     8 on deepseek's MLA leaves w_dkv (5120 x 576) and w_uq (1536 x
     24576), K2 at M = 512 on w_uk (512 x 16384, the expansion of a slot's
     latent slab); ptxas' register and spill report of the grouped body's
     instantiations (no spills);
  2b. the weight quantizer (run while phase 1's nvcc builds: it launches
     no kernel): ``quantize_weights`` (mxfp4, fp8) on the card
     against the same function on the CPU, words and scales bit for bit,
     on starcoder2's widest leaf (6144 x 24576) and on a leaf whose every
     32-group's absmax / 6 lies on, just below or just above a power of
     two (where the scale takes the reference's f32 log2 rounding);
  3. the MAC datapath (``repro_torch.core``, the counterpart of
     ``repro/core``): ``xtramac_packed`` for six Fig. 6 datatype
     combinations, 50,331,648 lane MACs each from random bit patterns
     (NaN, inf and subnormal codes included), its Stage-2 multiply on K6,
     held bit for bit against the plain path, against unpacked per-lane
     MACs (``per_lane_reference``) and, on 4,096 sampled lane MACs, against
     the exact oracle ``core/ref_mac.mac_exact``; then the cycle-level
     ``XtraMACPipeline`` over 64 issues that switch datatype every cycle
     (latency 4, II 1, every result checked); K6 must launch exactly once
     per ``xtramac_packed`` call and once per pipeline issue;
  then, for granite-8b (AWQ-int4, 36 layers), minitron-8b (W8A8,
  squared-ReLU FFN, at 8 of its 32 layers: the script's time),
  starcoder2-15b (MXFP4, non-gated GELU FFN, at 8 of its 40 layers: the
  script's time, since deepseek-v2's path was added) and
  qwen3-moe-30b-a3b (MoE: 128 experts, top-8, AWQ-int4, at 8 of its 48
  layers: the script's time, since the recurrent families' phase 8), each
  at full width with random weights from a seed quantized on the card, one
  model after the other:
  4. the model: one prefill chunk and 4 decode steps through the kernels
     and through the plain versions, bf16 and int8 KV, logits within 5 %
     of the logit scale (``launch/logit_spread.logit_check``); where the
     kernels miss 5 %, the plain path with decode attention summed in the
     kernel's split-KV order is the witness that decides
     (``logit_spread.witness_check``; PERF.md).  For qwen3-moe a routing
     flip between the paths is not a kernel fault: it prints how many
     (token, layer) expert sets a free plain run picks differently, and
     holds the kernel path to the plain path replaying the kernel path's
     routes (``models/moe.Routes``);
  5. serving: ServingEngine + Scheduler (8 slots, max_len 512, prefill
     chunk 64, bursts of up to 8) serve 6 seeded requests with staggered
     arrivals, once with bf16 KV and once with int8 KV; the kernels'
     launch counters are reset just before and read just after.  granite's
     tokens are checked against each request served alone; minitron's
     against a repeat of the same run (under W8A8 a row's activations are
     quantized with one scale per call, over its batch-mates too, so a
     request served alone may differ); starcoder2's against each request
     served alone, with K1 / K2 launched on its mxfp4 leaves; qwen3-moe's
     every request against itself served alone, with grouped K1 launched
     on its int4 expert leaves at decode (M = 1) and prefill (M = 5) and
     K1 / K2 on its attention leaves;
  5b. after granite's serve phase, on its first 18 of 36 layers (the
     script's time, since phase 9; 5c and 5e too, each cache budget cut
     in the same proportion, so the slots and pages stay): one engine serves
     bf16, int8 and fp8 KV side by side (``granite-8b-tiers``), each pool
     sized from 288 MiB (8 / 15 / 15 slots), 22 requests with a third at
     temperature 0.8 and two high-class bf16 arrivals that preempt two
     decoders; checks (i) every request's 32 tokens in the vocabulary,
     (ii) each request equals its single-tier run bit for bit (greedy and
     temperature rows; the preempted ones by iv), (iii) the int8 run
     repeats at max_burst=1, (iv) a resumed request parts from its
     unpreempted run only at a step whose top-2 gap (teacher-forced) is
     under 5 % of the logit scale, and from its preemption to that step
     its logits, recomputed on the resume's route, are the unpreempted
     run's within ``logit_check``'s bound, (v) one decode dispatch per decoding
     tier a round, (vi) K1 on the 8-row bf16 cohort, K2 on the 15-row
     int8 / fp8 cohorts, K3 and K4 (int8 and fp8) in the one engine, (vii)
     the sampler on the card against the CPU: bits and uniforms bit for
     bit, Gumbel noise within 4 eps x max(|g|, 1), ids but near ties;
  5c. after 5b, on granite's first 18 layers: serving from a paged KV pool
     (``granite-8b-paged``; 8 slots, max_len 512, pages of 64 positions),
     once with bf16 KV from 72 MiB (16 pages) and once with int8 KV from
     36 MiB (15 pages), far below full provisioning (65), so admission is
     page-limited: two 192-token prefixes A and B, A0-A5 = A + a suffix
     (A1, A4 at temperature 0.8), A6 / A7 = A (full-cover hits, one
     copy-on-write each), B0-B5 = B + a suffix once A's requests retired
     (their admission evicts A's cache-only pages), A8, and a priority-0
     B request that preempts; checks (i) every request not preempted
     equals its slab-pool run bit for bit, (ii) a resume adopts its
     registered prompt pages, re-prefills only the tail and is held to its
     unpreempted run by 5b's rule iv, (iii) prefix hits >= 12, copies >= 2,
     evictions >= 1 and a waiter held for pages with a slot free, (iv) the
     allocator's invariants at the end, no page leaked, and after every
     step no shared page under a write position, (v) every page still
     registered at the end holds the bytes it had when registered (sha256
     of codes and scales), (vi) K1, K2, K3 (bf16) and K4 (int8) launched;
  5d. after 5c, on granite's 36 layers: serving under an SLO policy and a
     fenced dispatch (``granite-8b-slo``): one engine, bf16 and int8 pools
     of 8 / 15 slots from 576 MiB each, ``SLOPolicy`` (queue cap, protect
     priority 0, bf16 -> int8 downgrade with hysteresis, cost-model burst
     and chunk planning; thresholds in seconds of the paper's V80 model),
     the seeded fault injector of ``launch/serve.py`` (rate 0.1 from step
     2, half kills, half poisoned ids; 3 retries), an injected clock of 2 s
     a step, 28 bf16 requests (prompts 64-192, 32 new, a third at 0.8) in
     three waves, 4 with a TTFT deadline, 4 at priority 0, 2 with an e2e
     deadline; checks (1) every request finished once, by length,
     rejected, deadline_exceeded or fault, the rejection counts agree, no
     priority-0 rejection, at least one queue_full, one downgrade with the
     policy engaged and released, one deadline_exceeded, faults of both
     kinds, (2) each request that no resume touched equals its rerun
     (final tier, no policy, no injector, same pool widths) bit for bit, or
     a prefix of it, (3) a resumed request is held to its rerun by 5b's
     rule iv, (4) K1, K2, K3 (bf16) and K4 (int8) launched;
  5e. after 5d, on granite's first 18 layers: speculative decoding
     (``granite-8b-spec``): one engine (8 slots, max_len 512, chunk 64,
     bursts of up to 8, bf16 KV), ``SpecConfig(draft_kv="int8", k_init=2,
     k_max=4)``, 10 requests (prompts 64-192, 48 new tokens, 3 at
     temperature 0.8), 8 at step 0 and 2 at step 12 (they stop
     speculation while they wait and prefill, and the draft catches up
     after); runs (A) spec off, (B) spec on, (C) spec on from a paged bf16
     pool of 64-position pages, fully provisioned, (D) spec on with
     corrupt drafts; checks (1) every request of B, C and D emits A's
     tokens bit for bit, (2) B and C accept drafts; C's allocator
     invariants hold and no page leaked, (3) D accepts none, collapses and
     falls back to plain bursts, (4) the accounting identities hold and
     one verify dispatch runs per decoding tier a spec round, (5) in B, K1
     and K3 on the bf16 target, K4 on the int8 draft pool and K2 on
     prefill and on the draft's catch-up chunks; run C carries a tracer
     and a registry (``repro_torch.obs``): one spec_draft and one
     spec_verify event a round on the draft / verify lanes, the
     registry's spec-round and host-sync counters the scheduler's;
  5f. after 5e, on granite's 36 layers: observability
     (``granite-8b-obs``): phase 5's bf16 serve run again with the full
     bundle attached (tracer, registry with JSONL snapshots, the
     model-vs-measured profiler), held to phase 5's obs-off run: the same
     tokens bit for bit, host syncs, decode dispatches, steps, burst
     histogram and K1-K4 launch counts; the trace parses, holds the
     WAITING / PREFILL / DECODE spans of every request, one decode_burst
     event a decode dispatch and one prefill_chunk event a chunk, and the
     registry's counters equal the scheduler's tallies (written to
     ``chiprun_out/granite-8b-obs.trace.json``); it prints the profiler's
     ``per_tier`` (the paper's V80 model seconds over the card's host
     wall: no bound) and ``obs.step_cost`` of the serve pool's decode
     step at K = 1 and 8 (every slot holding one 64-token chunk) beside
     its device-busy ms from one ``torch.profiler`` pass
     (``profile_step.measure``) and the implied bytes/s;
  6. model phases only, at full width and cut depth: qwen3-moe at 4
     layers with 128-token prefill chunks (capacity buffers of 10 rows:
     grouped K2), starcoder2-15b at 4
     layers under fp8 attention / mxfp4 FFN weights with fp8 KV (K1 / K2
     must launch on both formats, K4 on fp8 KV), and nemotron-4-340b at 2
     of its 96 layers (d_model 18432, d_ff 73728, vocab 256000), bf16 and
     int8 KV; each path's launch counts set to 0 just before its model
     phase and read just after;
  7. deepseek-v2-236b (MLA with absorbed-latent decode, 2 shared + 160
     routed fp8 experts, top-6) at full width and 4 of its 60 layers
     (about 3.97 GB of fp8 weights a layer: 60 do not fit the card), bf16
     latent KV only: the model phase (logits on replayed routes within 5 %
     of the logit scale, the free plain run's routing flips printed) and
     the serve phase (6 requests, each equal to its solo run; K1 / K2 on
     its fp8 projection and shared-expert leaves, grouped K1 on its expert
     stacks at decode (M = 1) and prefill (M = 4));
  8. the recurrent families at full width, served by the engine's
     static-batch loop: zamba2-7b (at its first 45 of 81 Mamba-2 layers
     since phase 10: the script's time; one shared attention + FFN block
     applied 7 times, awq_int4; bf16 and int8 KV) and xlstm-350m at full
     depth (21 mLSTM and 3 sLSTM blocks, W8A8): (a)
     the model teacher-forced through the kernels and the plain versions,
     4 rows: a 256-token prefill (the chunked SSD) and 8 decode steps,
     then a 100-token prefill (the sequential SSD), held to ``logit_check``
     (zamba2: ``witness_check`` against the plain path in K1 / K2's
     order where 5 % is missed); (c) one prefill and one decode step with
     their launches counted exactly from the config (zamba2 at 45 layers:
     K2 / K1 184 a call, K3 or K4 7 a decode step; xlstm: K5 111 a call), the
     prefill's wall and a decode step's wall and device-busy ms; (b)
     ``ServingEngine.generate`` on [4, 64] prompts, 16 new tokens, greedy at
     each KV tier: the ids are the kernel path's teacher-forced greedy ids
     bit for bit; at the first tier the plain path's logits on them are
     held as in (a), and the ids equal the plain path's argmax wherever
     its top-2 gap exceeds 0.1 (zamba2: miss it at most 1.5 times as
     often as the witness's argmax, with the residual early in the model
     within 1.5 times the witness's spread);
     a temperature-0.8 run repeats with its seed, and its ids are the
     loop's sampler (``sample_static`` on the key chain) on the kernel
     path's logits teacher-forced on them; the path's launches equal the
     config's exactly;
  9. phi-3-vision-4.2b (``vlm``: 32 layers, d_model 3072, 32 / 32 heads
     of 96, gated SiLU d_ff 8192, vocab 32064, tied embeddings, fp8
     projections and FFN, 256 patch rows) at full width and full depth
     through the same static-batch loop, bf16 and int8 KV, each prompt 256
     patch rows drawn from a seed at the embedding table's scale and 64
     tokens: (a) 4 rows teacher-forced (prefill, 8 decode steps) through
     the kernels and the plain versions, ``logit_check`` (else
     ``witness_check``); (c) one prefill (K2 224 launches: 32 layers x 7
     fp8 leaves at M = 1280) and one decode step (K1 224, K3 or K4 32),
     exactly, with their walls and the step's device-busy ms; (b)
     ``generate`` on ``{"tokens": [4, 64], "patches": [4, 256, 3072]}``,
     16 new tokens, greedy and at 0.8 at both tiers, checked as in 8 (b);
     then the patch check (other patches must move the first token's
     logits past ``logit_check``'s bound) and ``ServingEngine.score``
     (mode ``train``: the kernel path's token logits within
     ``logit_check`` of the plain path's, each NLL finite and the NLL of
     those logits);
 10. whisper-medium (``audio``: 24 non-causal encoder blocks over 1500
     frames, 24 decoder blocks with cross-attention, d_model 1024, 16 / 16
     heads of 64, non-gated GELU d_ff 4096, LayerNorm with a bias, vocab
     51865, tied embeddings, W8A8 on every linear) at full width and full
     depth through the same static-batch loop, bf16 and int8 KV, each
     prompt 1500 frames drawn from a seed at the embedding table's scale
     and 64 tokens, checked as in 9: (a) teacher-forced (prefill, 8 decode
     steps), ``logit_check`` (else ``witness_check`` against the plain path
     with the decode attention in K3 / K4's order); (c) one prefill (K5
     384 launches: 24 encoder layers x 6 at M = 6000, 24 decoder layers x
     10: 8 at M = 256 and the cross-attention's k / v at M = 6000) and one
     decode step (K5 240: 192 at M = 4, 48 at M = 6000, the cross K / V
     recomputed over the encoder output; K3 or K4 24), exactly; (b)
     ``generate`` on ``{"tokens": [4, 64], "frames": [4, 1500, 1024]}``;
     then the frame check (other frames must move the first token's
     logits) and ``score``.
The second-to-last line is the ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``.  Every case is also written to
``chiprun_out/chip_smoke.json``.  The script imports no JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import FRONTEND_INPUTS, get_config  # noqa: E402
from repro_torch.core import mac as M  # noqa: E402
from repro_torch.core import packing as P  # noqa: E402
from repro_torch.core.pipeline import Op, XtraMACPipeline  # noqa: E402
from repro_torch.core.ref_mac import mac_exact  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, gqa_decode_attention)
from repro_torch.kernels.packed_matmul import (  # noqa: E402
    gemv_plan, grouped_fragments, grouped_gemv_plan, packed_gemv,
    packed_gemv_grouped, packed_gemv_grouped_ordered, packed_grouped_plain,
    packed_matmul, packed_matmul_grouped, packed_matmul_plain)
from repro_torch.kernels.w8a8_matmul import (  # noqa: E402
    w8a8_matmul, w8a8_matmul_plain)
from repro_torch.kernels.xtramac_mac import (  # noqa: E402
    REF_MAX_STRIDE, check_reference_domain, virtual_dsp_multiply,
    virtual_dsp_plain)
from repro_torch.launch import logit_spread as LS  # noqa: E402
from repro_torch.launch.serve import (build_fault_injector,  # noqa: E402
                                     draw_frontend)
from repro_torch.launch.profile_datapath import (  # noqa: E402
    DATAPATH_COMBOS, TABLE_VII_LANE_MACS, random_operands)
from repro_torch.launch.profile_step import measure  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.perfmodel.analytical import (  # noqa: E402
    decode_latency, gemv_engine_for)
from repro_torch.models.common import QuantMaker, apply_linear  # noqa: E402
from repro_torch.obs import (MetricsRegistry, Observability,  # noqa: E402
                             PID_REQUESTS, SnapshotWriter, StepProfiler,
                             Tracer, step_cost)
from repro_torch.quant.kv_cache import QuantizedKV, cache_read  # noqa: E402
from repro_torch.quant.policy import PrecisionPolicy  # noqa: E402
from repro_torch.quant.schemes import (  # noqa: E402
    dequantize, get_kv_scheme, get_scheme, kv_quantize, pow2_scale,
    quantize_activations_int8, quantize_weights)
from repro_torch.serve import (Request, RequestState,  # noqa: E402
                               SamplingParams, Scheduler, ServeConfig,
                               ServingEngine, SLOPolicy, SpecConfig)
from repro_torch.serve import threefry  # noqa: E402
from repro_torch.serve.engine import mean_nll  # noqa: E402
from repro_torch.serve.sampling import (  # noqa: E402
    batched_step_keys, sample_rows, sample_static, temperature_scores)

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
# 32-bit integer instructions on the CUDA cores: 132 SMs x 64 INT32 lanes
# x 1.98 GHz boost clock (Hopper architecture white paper)
INT32_OPS = 132 * 64 * 1.98e9

KERNELS = {
    "packed_gemv": ("src/repro_torch/csrc/packed_matmul.cu",
                    "src/repro/kernels/packed_matmul.py:84"),
    "packed_matmul": ("src/repro_torch/csrc/packed_matmul.cu",
                      "src/repro/kernels/packed_matmul.py:84"),
    # the same Pallas kernel, reached through jax.vmap over the experts
    # (src/repro/models/moe.py:93-98)
    "packed_gemv_grouped": ("src/repro_torch/csrc/packed_matmul.cu",
                            "src/repro/kernels/packed_matmul.py:84"),
    "packed_matmul_grouped": ("src/repro_torch/csrc/packed_matmul.cu",
                              "src/repro/kernels/packed_matmul.py:84"),
    "w8a8_matmul": ("src/repro_torch/csrc/w8a8_matmul.cu",
                    "src/repro/kernels/packed_matmul.py:203"),
    "decode_attention_bf16": ("src/repro_torch/csrc/decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:137"),
    "decode_attention_quant": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:144"),
    "virtual_dsp_multiply": ("src/repro_torch/csrc/xtramac_mac.cu",
                             "src/repro/kernels/xtramac_mac.py:71"),
}
# the kernels each path must launch, and those it must not
PATH_KERNELS = {
    "xtramac-datapath": ("virtual_dsp_multiply",),
    "granite-8b": ("packed_gemv", "packed_matmul", "decode_attention_bf16",
                   "decode_attention_quant"),
    "granite-8b-tiers": ("packed_gemv", "packed_matmul",
                         "decode_attention_bf16", "decode_attention_quant"),
    "granite-8b-paged": ("packed_gemv", "packed_matmul",
                         "decode_attention_bf16", "decode_attention_quant"),
    "granite-8b-slo": ("packed_gemv", "packed_matmul",
                       "decode_attention_bf16", "decode_attention_quant"),
    "granite-8b-spec": ("packed_gemv", "packed_matmul",
                        "decode_attention_bf16", "decode_attention_quant"),
    # bf16 KV only: K4 does not run on the observed path
    "granite-8b-obs": ("packed_gemv", "packed_matmul",
                       "decode_attention_bf16"),
    "minitron-8b": ("w8a8_matmul", "decode_attention_bf16",
                    "decode_attention_quant"),
    "starcoder2-15b": ("packed_gemv", "packed_matmul",
                       "decode_attention_bf16", "decode_attention_quant"),
    "starcoder2-15b-mixed": ("packed_gemv", "packed_matmul",
                             "decode_attention_quant"),
    "nemotron-4-340b": ("packed_gemv", "packed_matmul",
                        "decode_attention_bf16", "decode_attention_quant"),
    "qwen3-moe-30b-a3b": ("packed_gemv", "packed_matmul",
                          "packed_gemv_grouped", "decode_attention_bf16",
                          "decode_attention_quant"),
    "qwen3-moe-30b-a3b-chunk128": ("packed_gemv", "packed_matmul",
                                   "packed_gemv_grouped",
                                   "packed_matmul_grouped",
                                   "decode_attention_bf16",
                                   "decode_attention_quant"),
    # MLA decodes absorbed, as plain bf16 contractions (the reference's
    # jnp.einsum): no decode-attention kernel on this path
    "deepseek-v2-236b": ("packed_gemv", "packed_matmul",
                         "packed_gemv_grouped"),
    # the recurrent families through the static-batch loop: Zamba2's
    # awq_int4 Mamba-2 and shared-block leaves and its shared attention's
    # decode (bf16 and int8 KV); xLSTM's W8A8 block leaves (no attention)
    "zamba2-7b": ("packed_gemv", "packed_matmul", "decode_attention_bf16",
                  "decode_attention_quant"),
    "xlstm-350m": ("w8a8_matmul",),
    # the VLM through the static-batch loop: fp8 projections and FFN (the
    # tied head is a plain matmul, as in the reference), bf16 / int8 KV
    "phi-3-vision-4.2b": ("packed_gemv", "packed_matmul",
                          "decode_attention_bf16", "decode_attention_quant"),
    # the audio encoder-decoder through the static-batch loop: W8A8 on
    # every linear (encoder, decoder self- and cross-attention, FFN; the
    # tied head and the attention math stay plain, as in the reference),
    # the decoder's self-attention decode at bf16 / int8 KV
    "whisper-medium": ("w8a8_matmul", "decode_attention_bf16",
                       "decode_attention_quant"),
}
# the launches by format (``ops.format_launch_counts``) each path must make
PATH_FORMATS = {
    "granite-8b-tiers": ("decode_attention_bf16:bf16",
                         "decode_attention_quant:int8",
                         "decode_attention_quant:fp8"),
    "granite-8b-paged": ("decode_attention_bf16:bf16",
                         "decode_attention_quant:int8"),
    "granite-8b-slo": ("decode_attention_bf16:bf16",
                       "decode_attention_quant:int8"),
    "granite-8b-spec": ("decode_attention_bf16:bf16",
                        "decode_attention_quant:int8"),
    "starcoder2-15b": ("packed_gemv:fp4_e2m1", "packed_matmul:fp4_e2m1"),
    "starcoder2-15b-mixed": (
        "packed_gemv:fp4_e2m1", "packed_matmul:fp4_e2m1",
        "packed_gemv:fp8_e4m3", "packed_matmul:fp8_e4m3",
        "decode_attention_quant:fp8"),
    "nemotron-4-340b": ("packed_gemv:fp4_e2m1", "packed_matmul:fp4_e2m1"),
    "qwen3-moe-30b-a3b": ("packed_gemv:int4", "packed_matmul:int4",
                          "packed_gemv_grouped:int4",
                          "decode_attention_bf16:bf16",
                          "decode_attention_quant:int8"),
    "qwen3-moe-30b-a3b-chunk128": ("packed_gemv_grouped:int4",
                                   "packed_matmul_grouped:int4"),
    "deepseek-v2-236b": ("packed_gemv:fp8_e4m3", "packed_matmul:fp8_e4m3",
                         "packed_gemv_grouped:fp8_e4m3"),
    "zamba2-7b": ("packed_gemv:int4", "packed_matmul:int4",
                  "decode_attention_bf16:bf16",
                  "decode_attention_quant:int8"),
    "phi-3-vision-4.2b": ("packed_gemv:fp8_e4m3", "packed_matmul:fp8_e4m3",
                          "decode_attention_bf16:bf16",
                          "decode_attention_quant:int8"),
    "whisper-medium": ("decode_attention_bf16:bf16",
                       "decode_attention_quant:int8"),
}
# the grouped launches by the rows of a group (``ops.grouped_launch_counts``)
# each MoE path must make: decode pairs (M = 1) and the capacity buffers of
# a 64-token chunk (qwen3: C = 5, deepseek: C = 4, grouped K1) or a
# 128-token one (C = 10, K2)
PATH_GROUPED_ROWS = {
    "qwen3-moe-30b-a3b": ("packed_gemv_grouped:M=1",
                          "packed_gemv_grouped:M=5"),
    "qwen3-moe-30b-a3b-chunk128": ("packed_gemv_grouped:M=1",
                                   "packed_matmul_grouped:M=10"),
    "deepseek-v2-236b": ("packed_gemv_grouped:M=1",
                         "packed_gemv_grouped:M=4"),
}
# the model runs: (path, arch, layers (None: all), policy weights, KV
# tiers of the model phase, witness variant, serve phase, the serving
# paths run after the serve phase on the same parameters)
MODEL_RUNS = [
    ("granite-8b", "granite-8b", None, (), ("bf16", "int8"), None, True,
     ("granite-8b-tiers", "granite-8b-paged", "granite-8b-slo",
      "granite-8b-spec", "granite-8b-obs")),
    ("minitron-8b", "minitron-8b", 8, (), ("bf16", "int8"),
     "plain_splitkv", True, ()),
    ("starcoder2-15b", "starcoder2-15b", 8, (), ("bf16", "int8"),
     "plain_splitkv", True, ()),
    # 8 of 48 layers (minitron-8b: 8 of 32): the script's time, since
    # phase 8 (zamba2-7b and xlstm-350m at full depth) was added
    ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", 8, (), ("bf16", "int8"),
     "plain_splitkv", True, ()),
    ("qwen3-moe-30b-a3b-chunk128", "qwen3-moe-30b-a3b", 4, (),
     ("bf16", "int8"), "plain_splitkv", False, ()),
    ("starcoder2-15b-mixed", "starcoder2-15b", 4,
     (("attn.*", "fp8"), ("ffn.*", "mxfp4")), ("fp8",), "plain_splitkv",
     False, ()),
    ("nemotron-4-340b", "nemotron-4-340b", 2, (), ("bf16", "int8"),
     "plain_splitkv", False, ()),
    # 4 of 60 layers (about 3.97 GB of fp8 weights a layer; 8 until
    # phi-3-vision-4.2b's phase 9 took the script's time); the MLA latent
    # cache stays bf16, the only tier
    ("deepseek-v2-236b", "deepseek-v2-236b", 4, (), ("bf16",), None, True,
     ()),
]
# the static-batch families at full width and depth, served by the
# engine's static-batch loop: (path = arch, KV tiers, witness variant of
# the model phase, the model phase's prefills as (prompt tokens,
# teacher-forced decode steps)).  The recurrent ones: 256 tokens take the
# chunked SSD (a multiple of ssm_chunk 128, past one chunk), 100 the
# sequential one; xLSTM has no attention, so no KV tier but the default.
# phi-3-vision-4.2b (phase 9): 256 patch rows + 64 tokens, 8 steps;
# whisper-medium (phase 10): its encoder over 1500 frames, then 64 tokens
# and 8 steps through the decoder (K5's int32 sums are exact: the witness
# sums the decode attention in K3 / K4's order)
RECURRENT_PREFILLS = ((256, 8), (100, 0))
STATIC_RUNS = [("zamba2-7b", ("bf16", "int8"), "plain_groupk",
                RECURRENT_PREFILLS),
               ("xlstm-350m", ("bf16",), None, RECURRENT_PREFILLS),
               ("phi-3-vision-4.2b", ("bf16", "int8"), "plain_groupk",
                ((64, 8),)),
               ("whisper-medium", ("bf16", "int8"), "plain_splitkv",
                ((64, 8),))]
# the static paths run at a cut depth (the script's time, since phase
# 10): zamba2-7b at its first 45 of 81 layers, 7 groups of 6 Mamba-2
# layers each followed by the shared block, then 3 of its tail (81: 13
# groups and 3)
STATIC_LAYERS = {"zamba2-7b": 45}
STATIC_ROWS = 4
# generate: prompt tokens, new tokens, the temperature rows' seed
STATIC_GEN = (64, 16, 7)
# the seeds of the drawn frontend inputs (the VLM's patches, the audio
# model's frames): the served batch's, and the other draw of the frontend
# check
FRONTEND_SEEDS = (5, 6)
# the prefill chunk of a model run where it is not 64: qwen3-moe at 4
# layers with 128-token chunks, whose capacity buffers (C = 10) take K2
MODEL_CHUNKS = {"qwen3-moe-30b-a3b-chunk128": 128}
# granite's serving paths that run at a cut depth (the script's time,
# since phase 9): the first CUT_LAYERS of granite's 36 blocks, every cache
# budget cut in the same proportion (``layer_budget``), so each pool keeps
# the slots and pages it has at full depth.  The SLO path (its thresholds
# are the V80 model's seconds, priced at 36 layers) and the obs path (held
# to phase 5's run) stay at full depth
CUT_EXTRAS = ("granite-8b-tiers", "granite-8b-paged", "granite-8b-spec")
CUT_LAYERS = 18
GRANITE_LAYERS = 36
# the mixed-tier path: one engine, one pool per KV tier, each sized from
# 576 MiB at 36 layers (x 8 KV heads x Dh 128 at capacity 512: 8 bf16 slots
# of 75,497,472 B, 15 int8 / fp8 slots of 38,928,384 B; 288 MiB at 18
# layers: half of each); bf16 requests
# 0-9 (0-7 at priority 5, 8-9 at priority 0), int8 10-15, fp8 16-21; every
# third request of a tier (the tier's index % 3 == 1) samples at 0.8
TIERS = ("bf16", "int8", "fp8")
TIERS_BUDGET = 603_979_776
TIERS_SLOTS = {"bf16": 8, "int8": 15, "fp8": 15}
TIERS_REQUESTS = {"bf16": 10, "int8": 6, "fp8": 6}
TIERS_LOW_CLASS = 8                 # bf16 requests 0-7: priority 5
TIERS_TEMPERATURE, TIERS_SEED = 0.8, 7
# the paged path: granite's parameters, 8 slots, max_len 512, chunk 64, so
# pages of 64 positions: 9,437,184 B bf16 / 4,866,048 B int8 at 36 layers
# (x 8 KV heads x Dh 128, K and V); 144 MiB buys 16 bf16 pages and 72 MiB
# 15 int8 pages, garbage page included (full provisioning: 1 + 8 x 8 = 65);
# at 18 layers half of each (``layer_budget``)
PAGED_BUDGETS = {"bf16": 150_994_944, "int8": 75_497_472}
PAGED_PAGES = {"bf16": 16, "int8": 15}
PAGED_PREFIX = 192                  # tokens of each shared prefix: 3 pages
# suffix tokens after the prefix, by request, in id order (prompt + 32 new
# tokens over 256 positions: 5 pages, 2 of them past the shared ones)
PAGED_SUFFIX = {"A0": 72, "A1": 40, "A2": 16, "A3": 96, "A4": 56, "A5": 24,
                "A6": 0, "A7": 0, "B0": 80, "B1": 48, "B2": 64, "B3": 90,
                "B4": 40, "B5": 72, "A8": 30, "B6": 96}
PAGED_HOT = ("A1", "A4")            # the paged path's temperature rows
PAGED_NEW_TOKENS = 32
PAGED_MAX_STEPS = 2000
# the SLO path (granite-8b-slo): one engine, bf16 and int8 pools from the
# tiers path's 576 MiB each (8 / 15 slots), 28 bf16 requests (prompts
# 64-192 tokens, 32 new) in three waves, an injected clock that advances
# SLO_CLOCK_STEP per scheduler step, and the seeded fault injector of
# ``launch/serve.py`` (rate 0.1 from step 2 on, 3 retries a request).
# SLOPolicy thresholds are seconds of the paper's V80 cost model, chosen
# from the prices the phase prints (granite-8b FULL, awq_int4, xtramac on
# the GEMV engine, context 256: 8.33 ms a token-step at batch 1, 66.6 ms at
# 8, 191.6 ms at 23; compute-bound, so the KV tier does not move them): a
# 23-slot backlog of 24 x 32 new tokens drains in ~6.4 model-seconds before
# prefill, and every 64-token chunk queued adds ~0.19 s.  Wave 1 (16
# arrivals at once) raises the estimate by ~0.5-0.8 s an arrival: past
# SLO_HIGH_S at its 12th (the downgrade engages: bf16 -> int8), and its
# 13th-16th find SLO_MAX_WAITING waiting (queue_full).  Wave 2 arrives at
# step 10 to an estimate under SLO_LOW_S (released), re-engages within the
# wave, and its TTFT deadlines (3 steps of the 2 s clock) are either
# unmeetable at submit (estimate past them) or shed while they wait for a
# bf16 slot; wave 3 arrives to a drained system (released).
# SLO_MAX_STEP_S buys two prefill chunks a round (a chunk is priced as 64
# single-row steps, 0.53 s).
SLO_TIERS = ("bf16", "int8")
SLO_WAVES = (16, 8, 4)              # requests a wave
SLO_TTFT_REQUESTS = 4               # wave 2 opens with these ...
SLO_PRIO0 = 4                       # ... and ends with these at priority 0
SLO_E2E_IDS = (3, 6)                # wave-1 requests with an e2e deadline
SLO_CLOCK_STEP = 2.0                # clock seconds per scheduler step
SLO_WAVE2_STEP = 10                 # wave 2 arrives at this step
SLO_MAX_WAITING = 12
SLO_HIGH_S, SLO_LOW_S, SLO_MAX_STEP_S = 6.5, 5.0, 1.1
SLO_TTFT_DEADLINE_S = 6.0           # clock seconds: 3 steps
SLO_E2E_DEADLINE_S = 30.0           # clock seconds: 15 steps
SLO_FAULT_RATE, SLO_FAULT_ARM_STEP, SLO_FAULT_RETRIES = 0.1, 2, 3
SLO_SEED = 7
SLO_MAX_STEPS = 3000
# the speculative path (granite-8b-spec): 8 slots, 10 bf16 requests
# (prompts 64-192 tokens, 48 new, every third at 0.8), SPEC_EARLY at step 0
# and the rest at SPEC_LATE_STEP; the draft twin at int8 KV, K on the
# ladder 1-2-4 from 2; paged run C from 64-position pages
SPEC_REQUESTS, SPEC_EARLY, SPEC_LATE_STEP = 10, 8, 12
SPEC_NEW_TOKENS = 48
SPEC_SEED = 11
SPEC_PAGE = 64
SPEC_MAX_STEPS = 2000
# the sampler on the card against the CPU: [rows, vocab] f32 draws;
# Gumbel noise within GUMBEL_ULPS ulps of max(|g|, 1) (each platform's
# log is within one ulp of the other's on the same input), ids equal but
# where the CPU's top-2 perturbed scores lie within NEAR_TIE
SAMPLER_ROWS = 15
GUMBEL_ULPS = 4
NEAR_TIE = 1e-5
LINEAR_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# starcoder2-15b: q / o, k / v, FFN in, FFN out (mxfp4; fp8 on the first
# two under the mixed plan); nemotron-4-340b's FFN out at M = 8
STARCODER2_SHAPES = [(6144, 6144), (6144, 512), (6144, 24576), (24576, 6144)]
NEMOTRON_DOWN = (73728, 18432)
GEMV_ROWS = (1, 3, 8)               # K1: decode rows
MATMUL_ROWS = (9, 64, 100)          # K2: the prefill chunk (64) and beside
# K2 at the mixed-tier path's int8 / fp8 decode cohorts (15 slots) on
# granite's (awq_int4) leaves
TIERS_MATMUL_ROWS = (TIERS_SLOTS["int8"],)
# K6 at a T that is no whole number of any body's row tile (256, 512, 1024)
VDSP_RAGGED = 987
# (scheme, M, N) at K = 4096: a ragged N edge, and decode leaves with
# N % 4 != 0 that the dispatch sends to K2
RAGGED_LEAVES = [("awq_int4", 64, 1000), ("awq_int4", 8, 1022),
                 ("fp8", 8, 1022)]
# the expert stacks of the grouped cases: (arch, scheme, experts, top-k,
# expert leaves (K, N), cases (label, G, M), the case whose live rows are
# launched again one a group at M = 1).  qwen3-moe-30b-a3b (awq_int4, 128
# experts): gate / up (2048 x 768) and down (768 x 2048); the decode step's
# pairs (8 rows x top-8, M = 1, every pair one row), a 64-token chunk's
# capacity buffers (128 x C = 5, K1) and a 128-, 256- and 512-token
# chunk's (128 x C = 10, 20, 40, K2), each buffer holding 0-C rows; 16
# pairs of one expert (two items of grouped K1's work list); and 40 groups
# of M = 3 over 8 experts (repeated pairs, empty groups), through K1 and
# K2.  deepseek-v2-236b (fp8, per-channel scales, 160 experts): 5120 x 1536
# and 1536 x 5120; the decode step's 8 x top-6 pairs, the capacity buffers
# of a 64-token chunk (160 x C = 4, K1) and a 256-token one (160 x C = 12,
# K2), and the repeats
GROUPED_STACKS = [
    ("qwen3-moe-30b-a3b", "awq_int4", 128, 8, [(2048, 768), (768, 2048)],
     [("decode", 8 * 8, 1), ("prefill64", 128, 5), ("prefill128", 128, 10),
      ("prefill256", 128, 20), ("prefill512", 128, 40),
      ("one_expert16", 16, 1), ("repeats", 40, 3)], "prefill128"),
    ("deepseek-v2-236b", "fp8", 160, 6, [(5120, 1536), (1536, 5120)],
     [("decode", 8 * 6, 1), ("prefill64", 160, 4), ("prefill256", 160, 12),
      ("repeats", 40, 3)], "prefill256"),
]
# deepseek-v2-236b's MLA leaves beside the kernels' other cases (fp8): K1
# at the decode step's M = 8 on w_dkv (N = 576, the latent and rope key)
# and w_uq; K2 at M = 512 on w_uk (the prefill chunk expands K over the
# slot's whole slab of 512 latents)
MLA_GEMV_SHAPES = [(5120, 576), (1536, 24576)]
MLA_EXPAND = (512, 512, 16384)          # (M, K, N)
# the grouped body against its twin in its own order: the same products
# and folds, with only the tensor cores' order inside a fold's x @ codes
# and the fold's fused multiply-add not replayed (f32 rounding)
ORDERED_RTOL, ORDERED_ATOL = 1e-4, 1e-5
# K = 4100 (not a multiple of 16): the int8 kernel's 4-byte copy body
W8A8_SHAPES = [(4096, 4096), (4096, 1024), (4096, 16384), (16384, 4096),
               (4100, 4096)]
# (M, K, N, byte offset of x): M = 3, and x as a view 5 bytes past a
# 16-byte boundary (the kernel's byte-copy body for x)
W8A8_EXTRA = [(3, 4096, 4096, 0), (8, 4096, 4096, 5)]
# decode attention: granite / minitron (the table case), nemotron-4-340b
# (d_head 192, GQA 96 / 8), qwen3-moe (64, 32 / 4), zamba2-7b (112, 32 / 32),
# starcoder2-15b (128, 48 / 4), phi-3-vision-4.2b (96, 32 / 32)
ATTN_LENS = [1024, 1, 37, 512, 1000, 300, 768, 64]
# the mixed-tier path's decode attention: its cohorts (15 int8 / fp8 rows,
# 8 bf16 rows) over slabs of capacity 512
TIERS_ATTN_LENS = [512, 1, 37, 511, 300, 96, 288, 64, 129, 200, 255, 17,
                   400, 128, 480]
# zamba2-7b's served layout: the static batch's 4 rows at one length in a
# slab of the model phase's capacity (256 prompt + 8 steps), bf16 / int8
ZAMBA_ATTN = dict(b=4, h=32, hk=32, dh=112, sk=264, tiers=("bf16", "int8"),
                  lens=[260] * 4)
# zamba2-7b's awq_int4 leaves at the static batch: w_zx and FFN up (3584 x
# 14336), w_bc (3584 x 128, one column tile: every K1 split over K), w_out
# (7168 x 3584), the shared block's wq / wk / wv / wo (3584 x 3584) and
# FFN down (14336 x 3584); K1 at the decode step's M = 4, K2 at the served
# [4, 64] prefill's M = 256 and the [4, 256] prefill's M = 1024
ZAMBA_LEAVES = [(3584, 14336), (3584, 128), (7168, 3584), (3584, 3584),
                (14336, 3584)]
ZAMBA_ROWS = ((4,), (256, 1024))
# xlstm-350m's W8A8 w_q / w_k / w_v (2048 x 2048) at the decode step's M = 4
# and the [4, 256] prefill's M = 1024
XLSTM_W8A8 = (2048, 2048, (4, 1024))
# phi-3-vision-4.2b's fp8 leaves: q / k / v / o (3072 x 3072), FFN gate /
# up (3072 x 8192) and down (8192 x 3072); K1 at the decode step's M = 4,
# K2 at the [4, 64] prefill's M = 4 x (256 patches + 64 tokens) = 1280
PHI_LEAVES = [(3072, 3072), (3072, 8192), (8192, 3072)]
PHI_ROWS = ((4,), (1280,))
# its decode attention (Dh 96: three lanes of 32 dims): the static batch's
# 4 rows at one length in a slab of the served capacity (256 + 64 + 16)
PHI_ATTN = dict(b=4, h=32, hk=32, dh=96, sk=336, lens=[330] * 4)
# whisper-medium's W8A8 leaves: q / k / v / o (1024 x 1024), FFN in (1024 x
# 4096) and out (4096 x 1024); K5 at the decode step's M = 4, the
# decoder's [4, 64] prefill's M = 256 and the 4 x 1500 frames' M = 6000
# (the encoder, and the cross-attention's k / v at every call)
WHISPER_W8A8 = [(1024, 1024), (1024, 4096), (4096, 1024)]
WHISPER_ROWS = (4, 256, 6000)
# its decoder's self-attention decode (16 / 16 heads, Dh 64): the static
# batch's 4 rows at one length in a slab of the served capacity (64 + 16)
WHISPER_ATTN = dict(b=4, h=16, hk=16, dh=64, sk=80, tiers=("bf16", "int8"),
                    lens=[72] * 4)
ATTN_LAYOUTS = [dict(h=32, hk=8, dh=128), dict(h=96, hk=8, dh=192),
                dict(h=32, hk=4, dh=64), dict(h=32, hk=32, dh=112),
                dict(h=48, hk=4, dh=128), dict(h=32, hk=32, dh=96)]
SCHEMES = ["awq_int4", "mxfp4", "fp8"]
# matmul tolerance of the reference's kernel tests; decode attention to one
# bf16 ulp (outputs are rounded to bf16; the sums differ only in order);
# model logits: LS.logit_check
MM_RTOL, MM_ATOL = 2e-3, 1e-3
ORACLE_SAMPLES = 4096
PIPELINE_ISSUES = 64
ATTN_RTOL, ATTN_ATOL = 2.0 ** -7, 1e-5

FAILED_CHECKS = []
# what each (arch, KV tier) serve run of phase 5 did (tokens, host syncs,
# dispatches, steps, bursts and its launches: ``serve_tally``) and its
# host wall
SERVE_TALLIES = {}
# the decode step whose FLOPs and bytes ``step_cost`` counts beside its
# device time: every slot of the serve pool holding one prefill chunk, at
# K = 1 and a burst of K = 8; {K: calls timed}.  With 8 bursts profiled
# (~46,000 kernel events) the phase took 129 s on an H100, so one burst
STEP_COST_CALLS = {1: 8, 8: 1}


def require(cond: bool, msg: str) -> None:
    """Record a failed check (reported now, fatal after the last phase)."""
    if not cond:
        FAILED_CHECKS.append(msg)
        print(f"CHECK FAILED: {msg}", file=sys.stderr, flush=True)


def log(*a) -> None:
    print(*a, flush=True)


class Timer:
    """Median device time of one call, from CUDA events around each call,
    with the L2 cache flushed (a 256 MB write) before every call: the
    serving loop reads each weight and KV byte cold.  A ~2 ms device spin
    before the start event keeps the stream busy while the host runs the
    wrapper, so the events time the device work and not the host's; the
    median drops a call whose host thread was held up past the spin."""

    SPIN_CYCLES = 4_000_000

    def __init__(self, device):
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device=device)
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e1 = torch.cuda.Event(enable_timing=True)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.e0.record()
            fn()
            self.e1.record()
            self.e1.synchronize()
            times.append(self.e0.elapsed_time(self.e1))
        return float(np.median(times))


def layer_budget(cfg, budget: int) -> int:
    """A granite cache budget (bytes at its 36 layers) for ``cfg``'s
    depth: the same slots and pages at any depth."""
    return budget * cfg.n_layers // GRANITE_LAYERS


def cut_depth(cfg, params, layers: int):
    """(cfg, params) of the first ``layers`` blocks of a dense model, the
    tensors shared with ``params``."""
    return (dataclasses.replace(cfg, n_layers=layers),
            T.DenseLM(params.embed, list(params.layers)[:layers],
                      params.ln_f, params.lm_head))


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def make_packed_weights(scheme_name: str, k: int, n: int, gen, dev):
    """awq_int4: quantized normal weights; mxfp4 / fp8: uniformly random
    code words with scales that keep outputs O(1)."""
    scheme = get_scheme(scheme_name)
    if scheme_name == "awq_int4":
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        return scheme, *quantize_weights(scheme, w)
    per = 32 // scheme.weight_bits
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // per, n), generator=gen,
                           device=dev, dtype=torch.int64).to(torch.int32)
    if scheme_name == "mxfp4":
        exps = torch.randint(-12, -6, (k // 32, n), generator=gen, device=dev)
        scales = torch.exp2(exps.to(torch.float32))
    else:
        scales = torch.rand((1, n), generator=gen, device=dev) * 1e-4 + 1e-4
    return scheme, packed, scales


def packed_case(timer: Timer, name, fn, scheme, packed, scales, w_bf16, m,
                gen, dev, launch_name):
    """One packed linear leaf: ``fn`` (a wrapper, or the dispatch) against
    ``packed_matmul_plain`` at the reference's kernel tolerance, timed
    beside its bound, its plain version and ``x @ W_bf16``.  ``fn`` must
    launch ``launch_name`` once."""
    k, n = w_bf16.shape
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    before = ops.launch_counts()[launch_name]
    got = fn(x, packed, scales, scheme)
    launched = ops.launch_counts()[launch_name] - before
    want = packed_matmul_plain(x, packed, scales, scheme)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL))
    b, by = bound_ms(nbytes(x, packed, scales, got), 2.0 * m * k * n)
    case = {
        "name": name, "scheme": scheme.name, "m": m, "k": k, "n": n,
        "max_abs_err": err, "max_rel_err": err / float(want.abs().max()),
        "max_abs_out": float(want.abs().max()), "ok": ok,
        "ms": timer.ms(lambda: fn(x, packed, scales, scheme)),
        "plain_ms": timer.ms(lambda: packed_matmul_plain(
            x, packed, scales, scheme)),
        "library_ms": timer.ms(lambda: x @ w_bf16),
        "library": "torch.matmul(x bf16, dequantized W bf16)",
        "bound_ms": b, "bound_by": by}
    if launch_name == "packed_gemv":
        case["splits"] = gemv_plan(m, k, n, scheme)[1]
    log(json.dumps(case))
    require(ok, f"{name} {scheme.name} M={m} K={k} N={n}: max |err| {err}")
    require(launched == 1, f"{name} {scheme.name} M={m} K={k} N={n}: "
                           f"{launched} {launch_name} launches, not 1")
    return case


def leaf_matmul(x, packed, scales, scheme):
    """A packed leaf through the model's dispatch, f32 out."""
    return ops.quantized_matmul(x, packed, scales, scheme,
                                out_dtype=torch.float32)


def packed_leaf_cases(timer: Timer, gen, dev, scheme_name, k, n,
                      gemv_rows=GEMV_ROWS, matmul_rows=MATMUL_ROWS):
    """K1 at ``gemv_rows`` and K2 at ``matmul_rows`` on one leaf."""
    scheme, packed, scales = make_packed_weights(scheme_name, k, n, gen, dev)
    w_bf16 = dequantize(scheme, packed, scales, (k, n)).to(torch.bfloat16)
    cases = []
    for kind, fn, ms_list in (("packed_gemv", packed_gemv, gemv_rows),
                              ("packed_matmul", packed_matmul, matmul_rows)):
        for m in ms_list:
            cases.append(packed_case(timer, kind, fn, scheme, packed, scales,
                                     w_bf16, m, gen, dev, kind))
    del packed, scales, w_bf16
    torch.cuda.empty_cache()
    return cases


def kernel_phase(timer: Timer, gen, dev, chunk: int):
    cases = []
    for scheme_name in SCHEMES:
        rows = MATMUL_ROWS + TIERS_MATMUL_ROWS if scheme_name == "awq_int4" \
            else MATMUL_ROWS
        for k, n in LINEAR_SHAPES:
            cases += packed_leaf_cases(timer, gen, dev, scheme_name, k, n,
                                       matmul_rows=rows)
    for k, n in STARCODER2_SHAPES:
        cases += packed_leaf_cases(timer, gen, dev, "mxfp4", k, n)
    for k, n in STARCODER2_SHAPES[:2]:
        cases += packed_leaf_cases(timer, gen, dev, "fp8", k, n)
    # past 32 splits: the x-slice cap of a K1 block at K = 73728
    cases += packed_leaf_cases(timer, gen, dev, "mxfp4", *NEMOTRON_DOWN,
                               gemv_rows=(8,), matmul_rows=())
    # K2 beyond the served shapes: a ragged N edge, and decode leaves the
    # GEMV does not take (N % 4 != 0), which the dispatch routes to K2
    for scheme_name, m, n in RAGGED_LEAVES:
        scheme, packed, scales = make_packed_weights(scheme_name, 4096, n,
                                                     gen, dev)
        w_bf16 = dequantize(scheme, packed, scales, (4096, n)).to(
            torch.bfloat16)
        cases.append(packed_case(timer, "packed_matmul", leaf_matmul, scheme,
                                 packed, scales, w_bf16, m, gen, dev,
                                 "packed_matmul"))
    # deepseek-v2-236b's MLA leaves: K1 at the decode step's 8 rows, K2 at
    # the expansion of a slot's 512 latents
    for k, n in MLA_GEMV_SHAPES:
        cases += packed_leaf_cases(timer, gen, dev, "fp8", k, n,
                                   gemv_rows=(8,), matmul_rows=())
    m, k, n = MLA_EXPAND
    cases += packed_leaf_cases(timer, gen, dev, "fp8", k, n, gemv_rows=(),
                               matmul_rows=(m,))
    for k, n in ZAMBA_LEAVES:
        cases += packed_leaf_cases(timer, gen, dev, "awq_int4", k, n,
                                   gemv_rows=ZAMBA_ROWS[0],
                                   matmul_rows=ZAMBA_ROWS[1])
    for k, n in PHI_LEAVES:
        cases += packed_leaf_cases(timer, gen, dev, "fp8", k, n,
                                   gemv_rows=PHI_ROWS[0],
                                   matmul_rows=PHI_ROWS[1])
    cases += grouped_cases(timer, gen, dev)
    cases += w8a8_cases(timer, gen, dev, chunk)
    k, n, rows = XLSTM_W8A8
    w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
    codes, scales = quantize_weights(get_scheme("w8a8"), w)
    for m in rows:
        cases.append(w8a8_case(timer, gen, dev, m, 0,
                               codes.t().contiguous(), scales))
    del w, codes, scales
    cases += whisper_cases(timer, gen, dev)
    for layout in ATTN_LAYOUTS:
        cases += attention_cases(timer, gen, dev, **layout)
    cases += attention_cases(timer, gen, dev, **ZAMBA_ATTN)
    cases += attention_cases(timer, gen, dev, **PHI_ATTN)
    for tier, b in TIERS_SLOTS.items():
        cases += attention_cases(timer, gen, dev, b=b, sk=512,
                                 tiers=(tier,), lens=TIERS_ATTN_LENS[:b])
    cases += empty_row_cases(gen, dev)
    cases += vdsp_cases(timer, gen, dev)
    return cases


def whisper_cases(timer: Timer, gen, dev):
    """whisper-medium's kernels at its path's shapes: K5 on its three W8A8
    leaf shapes at M = 4, 256 and 6000 (``WHISPER_ROWS``), K3 / K4 on its
    decoder's static batch (``WHISPER_ATTN``)."""
    cases = []
    for k, n in WHISPER_W8A8:
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        codes, scales = quantize_weights(get_scheme("w8a8"), w)
        for m in WHISPER_ROWS:
            cases.append(w8a8_case(timer, gen, dev, m, 0,
                                   codes.t().contiguous(), scales))
        del w, codes, scales
    return cases + attention_cases(timer, gen, dev, **WHISPER_ATTN)


def grouped_layout(label, g, m, gen, dev, n_experts, top_k):
    """(expert ids [G], rows [G]) of a grouped case, int32 on the card."""
    if label == "decode":       # each row's top-k: k distinct experts
        experts = torch.stack([
            torch.randperm(n_experts, generator=gen, device=dev)[:top_k]
            for _ in range(g // top_k)]).reshape(-1)
        rows = torch.ones(g, dtype=torch.int64, device=dev)
    elif label == "repeats":    # 8 experts over 40 groups, some empty
        experts = torch.randint(0, 8, (g,), generator=gen, device=dev)
        rows = torch.randint(0, m + 1, (g,), generator=gen, device=dev)
        rows[:4] = 0
    elif label == "one_expert16":   # 16 rows of one expert: two items
        experts = torch.full((g,), 7, device=dev)
        rows = torch.ones(g, dtype=torch.int64, device=dev)
    else:                       # capacity buffers, expert e in group e
        experts = torch.arange(g, device=dev)
        rows = torch.randint(0, m + 1, (g,), generator=gen, device=dev)
    return experts.to(torch.int32), rows.to(torch.int32)


def grouped_case(timer: Timer, arch, label, name, fn, leaf, w_bf16, x,
                 experts, rows, top_k, alone_at_m1):
    """One expert-grouped launch against ``packed_grouped_plain`` at the
    packed matmul's tolerance, rows past each group's count exactly zero,
    timed beside its bound (the distinct experts' words and scales that
    groups with rows read, the rows of x that hold data, the whole output;
    2 x rows x K x N operations), its plain version and ``torch.bmm`` over
    the groups' experts pre-gathered as bf16.  ``fn`` must launch ``name``
    once."""
    g, m, k = x.shape
    n = leaf.packed.shape[2]
    args = (x, leaf.packed, leaf.scales, leaf.scheme, experts, rows)
    before = ops.launch_counts()[name]
    got = fn(*args)
    launched = ops.launch_counts()[name] - before
    want = packed_grouped_plain(*args)
    torch.cuda.synchronize()
    live = torch.arange(m, device=x.device)[None, :] < rows[:, None]
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL))
    zeros = bool((got[~live] == 0).all())
    used = torch.unique(experts[rows > 0])
    n_rows = int(rows.sum())
    per_expert = nbytes(leaf.packed[0], leaf.scales[0])
    moved = (len(used) * per_expert + n_rows * k * x.element_size()
             + nbytes(got, experts, rows))
    b, by = bound_ms(moved, 2.0 * n_rows * k * n)
    sel = w_bf16[experts.long()]
    case = {
        "name": name, "arch": arch, "case": label, "scheme": leaf.scheme.name,
        "g": g,
        "m": m, "k": k, "n": n, "rows": n_rows, "experts": len(used),
        "max_abs_err": err, "max_rel_err": err / float(want.abs().max()),
        "max_abs_out": float(want.abs().max()), "ok": ok,
        "rows_past_count_zero": zeros,
        "ms": timer.ms(lambda: fn(*args)),
        "plain_ms": timer.ms(lambda: packed_grouped_plain(*args)),
        "library_ms": timer.ms(lambda: torch.bmm(x, sel)),
        "library": "torch.bmm(x bf16, the groups' experts as bf16)",
        "bound_ms": b, "bound_by": by, "bound_bytes": moved}
    del sel
    what = f"{name} {arch} {label} G={g} M={m} K={k} N={n}"
    case.update(grouped_order_checks(what, label, fn, args, got, top_k,
                                     alone_at_m1))
    log(json.dumps(case))
    require(ok, f"{what}: max |err| {err}")
    require(zeros, f"{what}: rows past a group's count are not zero")
    require(launched == 1, f"{what}: {launched} {name} launches, not 1")
    return case


def grouped_order_checks(what, label, fn, args, got, top_k, alone_at_m1):
    """The grouped body beyond the plain version: against its twin in its
    own order of sums (``packed_gemv_grouped_ordered``); for the decode
    pairs, each row's top-k pairs launched alone (G = k) equal to the same
    rows of the whole step's launch bit for bit; for the ``alone_at_m1``
    chunk's buffers (grouped K2, items of 16 rows), each live row launched
    alone in a group of one row (grouped K1, items of 8) equal to its row
    bit for bit (the order is the leaf's, so neither batch-mates nor M move
    a sum)."""
    x, packed, scales, scheme, experts, rows = args
    ordered = packed_gemv_grouped_ordered(*args)
    torch.cuda.synchronize()
    err = float((got - ordered).abs().max())
    ok = bool(torch.allclose(got, ordered, rtol=ORDERED_RTOL,
                             atol=ORDERED_ATOL))
    require(ok, f"{what}: max |err| {err} against its ordered twin")
    out = {"ordered_max_abs_err": err, "ordered_ok": ok,
           "plan": list(grouped_gemv_plan(x.shape[2], packed.shape[2],
                                          scheme))}
    if label == "decode":
        alone = torch.cat([fn(x[i:i + top_k], packed, scales, scheme,
                              experts[i:i + top_k], rows[i:i + top_k])
                           for i in range(0, x.shape[0], top_k)])
        torch.cuda.synchronize()
        same = bool(torch.equal(alone, got))
        require(same, f"{what}: rows launched {top_k} pairs at a time "
                      f"differ from the G = {x.shape[0]} launch")
        out["rows_alone_bit_equal"] = same
    if label == alone_at_m1:
        live = (torch.arange(x.shape[1], device=x.device)[None, :]
                < rows[:, None]).nonzero()
        alone = packed_gemv_grouped(
            x[live[:, 0], live[:, 1]][:, None], packed, scales, scheme,
            experts[live[:, 0]],
            torch.ones(len(live), dtype=torch.int32, device=x.device))
        torch.cuda.synchronize()
        same = bool(torch.equal(alone[:, 0], got[live[:, 0], live[:, 1]]))
        require(same, f"{what}: live rows launched one a group at M = 1 "
                      f"differ from the M = {x.shape[1]} launch")
        out["rows_at_m1_bit_equal"] = same
    return out


def grouped_cases(timer: Timer, gen, dev):
    """Grouped K1 / K2 on each MoE path's expert stacks at its shapes
    (``GROUPED_STACKS``)."""
    cases = []
    mk = QuantMaker(5, device=dev)
    for arch, scheme, n_experts, top_k, shapes, layouts, alone_at_m1 \
            in GROUPED_STACKS:
        for k, n in shapes:
            with torch.no_grad():
                leaf = mk.dense("moe.w_up", k, n, scheme, experts=n_experts)
            w_bf16 = torch.stack([dequantize(leaf.scheme, leaf.packed[e],
                                             leaf.scales[e], (k, n))
                                  .to(torch.bfloat16)
                                  for e in range(n_experts)])
            for label, g, m in layouts:
                experts, rows = grouped_layout(label, g, m, gen, dev,
                                               n_experts, top_k)
                x = torch.randn((g, m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                kernels = (("packed_gemv_grouped", packed_gemv_grouped),
                           ("packed_matmul_grouped", packed_matmul_grouped))
                if label != "repeats":
                    kernels = kernels[:1] if m <= 8 else kernels[1:]
                for name, fn in kernels:
                    cases.append(grouped_case(timer, arch, label, name, fn,
                                              leaf, w_bf16, x, experts, rows,
                                              top_k, alone_at_m1))
            del leaf, w_bf16
            torch.cuda.empty_cache()
    return cases


def w8a8_cases(timer: Timer, gen, dev, chunk: int):
    """The int8 matmul at minitron-8b's four linear shapes and K = 4100, at
    decode (M = 1, 8) and prefill (M = chunk) rows, plus M = 3 and an x at
    a byte offset (W8A8_EXTRA): exactly equal to its plain version (int32
    sums are exact), timed beside its bound (bytes; int8 ops at the tensor
    cores' peak), its plain version and ``torch._int_mm`` with the same
    epilogue."""
    scheme = get_scheme("w8a8")
    cases = []
    for k, n in W8A8_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        codes, scales = quantize_weights(scheme, w)
        wt = codes.t().contiguous()              # the kernel's [N, K] layout
        del w, codes
        rows = [(m, 0) for m in (1, 8, chunk)]
        rows += [(m, off) for m, kk, nn, off in W8A8_EXTRA
                 if (kk, nn) == (k, n)]
        for m, off in rows:
            cases.append(w8a8_case(timer, gen, dev, m, off, wt, scales))
        del wt, scales
    return cases


def w8a8_case(timer: Timer, gen, dev, m: int, x_offset: int, wt, scales):
    n, k = wt.shape
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    xc, xs = quantize_activations_int8(x)
    if x_offset:                # the same codes at an unaligned address
        buf = torch.empty(m * k + 16, dtype=torch.int8, device=dev)
        xc = buf[x_offset:x_offset + m * k].view(m, k)
        xc.copy_(quantize_activations_int8(x)[0])
    got = w8a8_matmul(xc, xs, wt, scales)
    want = w8a8_matmul_plain(xc, xs, wt, scales)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.equal(got, want))
    b, by = bound_ms(nbytes(xc, xs, wt, scales, got), 2.0 * m * k * n,
                     INT8_OPS)
    # _int_mm takes more than 16 rows and K % 8 == 0: decode rows are
    # padded to 32, K with zero codes to a multiple of 16
    lib_m, lib_k = max(m, 32), -(-k // 16) * 16
    xl = torch.zeros((lib_m, lib_k), dtype=torch.int8, device=dev)
    xl[:m, :k] = xc
    wl = wt
    if lib_k != k:
        wl = torch.zeros((n, lib_k), dtype=torch.int8, device=dev)
        wl[:, :k] = wt

    def library():
        return torch._int_mm(xl, wl.t()).to(torch.float32) * (scales * xs)

    case = {
        "name": "w8a8_matmul", "m": m, "k": k, "n": n,
        "x_offset": x_offset, "max_abs_err": err,
        "max_abs_out": float(want.abs().max()), "ok": ok,
        "ms": timer.ms(lambda: w8a8_matmul(xc, xs, wt, scales)),
        "plain_ms": timer.ms(lambda: w8a8_matmul_plain(xc, xs, wt, scales)),
        "library_ms": timer.ms(library),
        "library": "torch._int_mm(x int8, W int8) + epilogue"
                   + (f", M padded to {lib_m}" if lib_m != m else "")
                   + (f", K padded to {lib_k}" if lib_k != k else ""),
        "bound_ms": b, "bound_by": by}
    log(json.dumps(case))
    require(ok, f"w8a8_matmul M={m} K={k} N={n} x+{x_offset}: max |err| "
                f"{err} (must be 0)")
    return case


def attention_cases(timer: Timer, gen, dev, b=8, h=32, hk=8, dh=128, sk=1024,
                    tiers=("bf16", "int8", "fp8"), lens=ATTN_LENS):
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)[:b]
    q = torch.randn((b, 1, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    v = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    k_bf, v_bf = k.to(torch.bfloat16), v.to(torch.bfloat16)
    # the library yardstick: SDPA over the bf16 slab with a ragged mask
    kt, vt = k_bf.transpose(1, 2).contiguous(), v_bf.transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(sk, device=dev)[None, :] < lens[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    valid = int(lens.sum())
    cases = []
    for tier in tiers:
        if tier == "bf16":
            kc, vc, elem = k_bf, v_bf, 2
        else:
            scheme = get_kv_scheme(tier)
            kc = QuantizedKV(*kv_quantize(scheme, k), tier)
            vc = QuantizedKV(*kv_quantize(scheme, v), tier)
            elem = 1
        name = "decode_attention_bf16" if tier == "bf16" \
            else "decode_attention_quant"
        got = gqa_decode_attention(q, kc, vc, lens)
        want = decode_attention_plain(q, kc, vc, lens)
        torch.cuda.synchronize()
        gf, wf = got.to(torch.float32), want.to(torch.float32)
        err = float((gf - wf).abs().max())
        ok = bool(torch.allclose(gf, wf, rtol=ATTN_RTOL, atol=ATTN_ATOL))
        kv_bytes = 2 * valid * hk * (dh * elem + (4 if tier != "bf16" else 0))
        b_ms, by = bound_ms(kv_bytes + nbytes(q, got, lens),
                            4.0 * valid * h * dh)
        case = {"name": name, "kv": tier, "b": b, "h": h, "hk": hk, "dh": dh,
                "sk": sk, "kv_valid_len": lens.tolist(), "max_abs_err": err,
                "max_rel_err": err / float(wf.abs().max()),
                "max_abs_out": float(wf.abs().max()), "ok": ok,
                "ms": timer.ms(lambda: gqa_decode_attention(q, kc, vc, lens)),
                "plain_ms": timer.ms(lambda: decode_attention_plain(
                    q, kc, vc, lens)),
                "library_ms": timer.ms(library),
                "library": "scaled_dot_product_attention over the bf16 slab",
                "bound_ms": b_ms, "bound_by": by}
        cases.append(case)
        log(json.dumps(case))
        require(ok, f"{name} kv={tier} B={b} Sk={sk}: max |err| {err}")
    return cases


def empty_row_cases(gen, dev, b=8, h=32, hk=8, dh=128, sk=512):
    """Decode attention with zero-length rows, as the reference computes
    it: every score masked alike, so equal weights over all Sk positions
    (the mean of V).  Kernel against plain version, bf16 and int8 slabs."""
    lens = torch.tensor([0, 1, 37, 512, 0, 300, 100, 64], dtype=torch.int32,
                        device=dev)[:b]
    q = torch.randn((b, 1, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    v = torch.randn((b, sk, hk, dh), generator=gen, device=dev)
    cases = []
    for tier in ("bf16", "int8"):
        if tier == "bf16":
            kc, vc = k.to(torch.bfloat16), v.to(torch.bfloat16)
            name = "decode_attention_bf16"
        else:
            scheme = get_kv_scheme(tier)
            kc = QuantizedKV(*kv_quantize(scheme, k), tier)
            vc = QuantizedKV(*kv_quantize(scheme, v), tier)
            name = "decode_attention_quant"
        got = gqa_decode_attention(q, kc, vc, lens).to(torch.float32)
        want = decode_attention_plain(q, kc, vc, lens).to(torch.float32)
        mean_v = cache_read(vc, torch.float32).to(torch.float32)[0].mean(0)
        row0 = got[0, 0].reshape(hk, h // hk, dh)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL))
        mean_ok = bool(torch.allclose(row0, mean_v[:, None].expand_as(row0),
                                      rtol=ATTN_RTOL, atol=ATTN_ATOL))
        case = {"name": name, "kv": tier, "empty_rows": True,
                "kv_valid_len": lens.tolist(), "max_abs_err": err,
                "ok": ok, "empty_row_is_mean_of_v": mean_ok}
        cases.append(case)
        log(json.dumps(case))
        require(ok, f"{name} kv={tier} with empty rows: max |err| {err}")
        require(mean_ok, f"{name} kv={tier}: an empty row is not the mean "
                         "of V over the slab")
    return cases


def vdsp_plans():
    """(pair, cap, plan, draw) of every K6 case: each paper pair under the
    capped plan, the beyond-paper pairs uncapped where their lanes fit the
    reference kernel's domain, and all magnitudes at their maximum."""
    plans = [(pair, 4, P.solve_lane_plan(*pair, max_parallelism=4), "random")
             for pair in P.PAPER_PARALLELISM]
    for pair in P.SOLVER_BEYOND_PAPER:
        plan = P.solve_lane_plan(*pair)
        if plan.stride <= REF_MAX_STRIDE:
            plans.append((pair, None, plan, "random"))
    plans.append((("bf16", "bf16"), 4,
                  P.solve_lane_plan("bf16", "bf16", max_parallelism=4), "max"))
    return plans


def vdsp_case(timer, gen, dev, pair, cap, plan, draw, dtype, fn, plain_fn,
              short=0):
    """One K6 case at T = 50,331,648 / P - ``short``: kernel ``fn``
    against ``plain_fn`` bit for bit, timed beside its bound, the plain
    version and the broadcast multiply ``(a[:, :, None] * b[:, None,
    :]).flatten(1)``, which computes the same lanes where magnitudes stay
    within the format's maximum (lane isolation; lanes are i-major)."""
    t = TABLE_VII_LANE_MACS // plan.parallelism - short
    n_a, n_b = len(plan.offsets_a), len(plan.offsets_b)
    if draw == "max":
        a = torch.full((t, n_a), (1 << plan.w_a) - 1, dtype=dtype, device=dev)
        b = torch.full((t, n_b), (1 << plan.w_b) - 1, dtype=dtype, device=dev)
    else:
        a = torch.randint(0, P.max_magnitude(plan.fmt_a) + 1, (t, n_a),
                          generator=gen, device=dev, dtype=dtype)
        b = torch.randint(0, P.max_magnitude(plan.fmt_b) + 1, (t, n_b),
                          generator=gen, device=dev, dtype=dtype)

    def library():
        return (a[:, :, None] * b[:, None, :]).flatten(1)

    got = fn(a, b, plan)
    want = plain_fn(a, b, plan)
    lib = library()
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    ok = bool(torch.equal(got, want))
    lib_ok = bool(torch.equal(lib, want))
    elem = torch.empty((), dtype=dtype).element_size()
    b_ms, by = bound_ms(t * (n_a + n_b + plan.parallelism) * elem,
                        t * (n_a + n_b + 1 + plan.parallelism), INT32_OPS)
    case = {"name": "virtual_dsp_multiply", "pair": "x".join(pair),
            "cap": cap, "draw": draw, "dtype": str(dtype).split(".")[-1],
            "ragged": short > 0,
            "t": t, "p": plan.parallelism, "stride": plan.stride,
            "max_abs_err": err, "ok": ok, "library_equal": lib_ok,
            "ms": timer.ms(lambda: fn(a, b, plan)),
            "plain_ms": timer.ms(lambda: plain_fn(a, b, plan)),
            "library_ms": timer.ms(library),
            "library": "(a[:, :, None] * b[:, None, :]).flatten(1)",
            "bound_ms": b_ms, "bound_by": by}
    log(json.dumps(case))
    require(ok, f"virtual_dsp_multiply {case['pair']} cap={cap} {draw} "
                f"{case['dtype']}: max |err| {err} (must be 0)")
    require(lib_ok, f"virtual_dsp_multiply {case['pair']} cap={cap} {draw}: "
                    "lanes differ from a_i * b_j")
    return case


def vdsp_cases(timer, gen, dev):
    """K6 in its int32 instantiation (``virtual_dsp_multiply``) for every
    case of ``vdsp_plans``, and its int64 one (``packed_multiply``) on a
    40-bit lane (fp32 x int16), which the int32 entry must refuse; then
    both on int4 x bf16 / fp32 x int16 at a ragged T."""
    def int32_case(pair, cap, plan, draw, short=0):
        return vdsp_case(
            timer, gen, dev, pair, cap, plan, draw, torch.int32,
            virtual_dsp_multiply,
            lambda a, b, p: virtual_dsp_plain(a, b, p).to(torch.int32),
            short)

    def int64_case(plan, short=0):
        return vdsp_case(
            timer, gen, dev, ("fp32", "int16"), None, plan, "random",
            torch.int64, lambda a, b, p: P.packed_multiply(p, a, b),
            lambda a, b, p: P.packed_multiply(p, a, b, plain=True), short)

    cases = [int32_case(*case) for case in vdsp_plans()]
    plan = P.solve_lane_plan("fp32", "int16")
    try:
        check_reference_domain(plan)
        refused = False
    except ValueError:
        refused = True
    require(refused, "virtual_dsp_multiply accepted a 40-bit lane")
    cases.append(int64_case(plan))
    cases.append(int32_case(("int4", "bf16"), 4, P.solve_lane_plan(
        "int4", "bf16", max_parallelism=4), "random", VDSP_RAGGED))
    cases.append(int64_case(plan, VDSP_RAGGED))
    return cases


# ---------------------------------------------------------------------------
# Phase 2b: the weight quantizer on the card against the CPU
# ---------------------------------------------------------------------------
def near_pow2_leaf(k: int, gen, dev, reach: int = 16):
    """f32 weights [K, n] whose every 32-group of column c has absmax
    a_c (one entry +-a_c, the rest inside), the a_c every f32 within
    ``reach`` ulps of 3 * 2^m for each m that keeps a_c finite and above
    the 1e-12 floor: a_c / 6 lies on, just below or just above 2^(m-1)."""
    m = torch.arange(-41, 127, dtype=torch.float64)
    centre = (3.0 * torch.exp2(m)).to(torch.float32).view(torch.int32)
    bits = (centre[:, None] + torch.arange(-reach, reach + 1)[None, :]).to(
        torch.int32)
    a = bits.flatten().view(torch.float32)
    a = a[torch.isfinite(a) & (a >= 1e-12)].to(dev)
    n, groups = a.numel(), k // 32
    w = (torch.rand((k, n), generator=gen, device=dev) * 2 - 1) * 0.999 * a
    rows = torch.randint(0, 32, (groups, 1, n), generator=gen, device=dev)
    sign = torch.randint(0, 2, (groups, 1, n), generator=gen,
                         device=dev) * 2 - 1
    w.view(groups, 32, n).scatter_(1, rows, (a * sign).expand(groups, 1, n))
    return w


def quantizer_phase(gen, dev):
    """``quantize_weights`` for mxfp4 and fp8 on the card and on the CPU
    from the same f32 weights: int32 words and f32 scales bit for bit."""
    k, n = STARCODER2_SHAPES[2]
    leaves = {"starcoder2_w_in": torch.randn((k, n), generator=gen,
                                             device=dev) / k ** 0.5,
              "near_pow2_absmax": near_pow2_leaf(k, gen, dev)}
    cases = []
    for leaf, w in leaves.items():
        w_cpu = w.cpu()
        for scheme_name in ("mxfp4", "fp8"):
            scheme = get_scheme(scheme_name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packed, scales = quantize_weights(scheme, w)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want_p, want_s = quantize_weights(scheme, w_cpu)
            cpu_s = time.perf_counter() - t0
            got_p, got_s = packed.cpu(), scales.cpu()
            case = {"quantizer": scheme_name, "leaf": leaf,
                    "k": w.shape[0], "n": w.shape[1],
                    "words_equal": bool(torch.equal(got_p, want_p)),
                    "scales_equal": bool(torch.equal(got_s, want_s)),
                    "words_differing": int((got_p != want_p).sum()),
                    "scales_differing": int((got_s != want_s).sum()),
                    "card_s": card_s, "cpu_s": cpu_s}
            if scheme.scale_pow2:
                # groups whose scale the f32 log2 keeps one exponent below
                # the exact ceil(log2(absmax / 6))
                q = w_cpu.abs().reshape(k // 32, 32, -1).amax(1).clamp(
                    min=1e-12) / torch.tensor(6.0)
                exact = torch.exp2(torch.ceil(torch.log2(q.double())))
                case["groups_below_exact_exponent"] = int(
                    (pow2_scale(q).double() != exact).sum())
            log(json.dumps(case))
            require(case["words_equal"] and case["scales_equal"],
                    f"quantize_weights {scheme_name} on {leaf}: "
                    f"{case['words_differing']} words and "
                    f"{case['scales_differing']} scales differ from the CPU")
            cases.append(case)
            del packed, scales
    require(any(c.get("groups_below_exact_exponent", 0) > 0 for c in cases),
            "the near-power-of-two leaf has no group whose f32 log2 rounds "
            "below the exact exponent")
    del leaves
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# Phase 3: the MAC datapath through K6
# ---------------------------------------------------------------------------
def special_codes(fmt, bits):
    """How many NaN, inf and subnormal codes ``bits`` holds (floats)."""
    if not fmt.is_float:
        return {}
    _, e, m = fmt.fields(bits)
    return {"nan": int(fmt.is_nan(bits).sum()),
            "inf": int(fmt.is_inf(bits).sum()),
            "subnormal": int(((e == 0) & (m != 0)).sum())}


def datapath_combo(combo, gen, dev, rng):
    """``xtramac_packed`` at 50,331,648 lane MACs of one combination, held
    to the plain path, to per-lane MACs and to the exact oracle."""
    cfg = M.MacConfig.make(*combo)
    plan = P.solve_lane_plan(cfg.fmt_a, cfg.fmt_b, max_parallelism=4)
    t, lanes = TABLE_VII_LANE_MACS // plan.parallelism, plan.parallelism
    a, b, c = random_operands(cfg, plan, gen, dev, TABLE_VII_LANE_MACS)
    before = ops.launch_counts()["virtual_dsp_multiply"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = P.xtramac_packed(cfg, plan, a, b, c)
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - t0
    kernel_launches = ops.launch_counts()["virtual_dsp_multiply"] - before
    plain_ok = bool(torch.equal(got, P.xtramac_packed(cfg, plan, a, b, c,
                                                      plain=True)))
    lane_ok = bool(torch.equal(got, P.per_lane_reference(cfg, plan, a, b, c)))
    # the exact oracle on sampled (issue, lane) pairs
    rows = torch.as_tensor(rng.integers(0, t, ORACLE_SAMPLES), device=dev)
    cols = rng.integers(0, lanes, ORACLE_SAMPLES)
    a_h, b_h, c_h = (x[rows].cpu().numpy() for x in (a, b, c))
    sampled = got[rows, torch.as_tensor(cols, device=dev)].cpu().numpy()
    pos = plan.lane_positions
    want = [mac_exact(cfg.fmt_a, cfg.fmt_b, cfg.fmt_c, cfg.fmt_p,
                      a_h[k, pos[l][0]], b_h[k, pos[l][1]], c_h[k, l])
            for k, l in enumerate(cols)]
    oracle_bad = int((sampled != np.asarray(want, np.int64)).sum())
    specials = {"a": special_codes(cfg.fmt_a, a),
                "b": special_codes(cfg.fmt_b, b),
                "c": special_codes(cfg.fmt_c, c)}
    case = {"combo": cfg.name, "p": lanes, "t": t, "lane_macs": t * lanes,
            "packed_call_s": packed_s, "kernel_launches": kernel_launches,
            "equal_to_plain": plain_ok, "equal_to_per_lane": lane_ok,
            "oracle_samples": ORACLE_SAMPLES, "oracle_mismatches": oracle_bad,
            "special_codes": specials}
    log(json.dumps(case))
    require(tuple(got.shape) == (t, lanes) and bool(
        ((got >= 0) & (got < (1 << cfg.fmt_p.bits))).all()),
        f"datapath {cfg.name}: output {tuple(got.shape)} or codes outside "
        f"{cfg.fmt_p.name}")
    require(kernel_launches == 1, f"datapath {cfg.name}: {kernel_launches} "
                                  "K6 launches in one xtramac_packed call")
    require(plain_ok, f"datapath {cfg.name}: K6 path differs from the plain "
                      "path")
    require(lane_ok, f"datapath {cfg.name}: packed lanes differ from "
                     "per-lane MACs")
    require(oracle_bad == 0, f"datapath {cfg.name}: {oracle_bad} of "
                             f"{ORACLE_SAMPLES} samples differ from mac_exact")
    for port, fmt in (("a", cfg.fmt_a), ("b", cfg.fmt_b), ("c", cfg.fmt_c)):
        if fmt.is_float:
            need = ["subnormal"] + (["nan"] if fmt.special_rule != "none"
                                    else []) \
                + (["inf"] if fmt.special_rule == "ieee" else [])
            require(all(specials[port][k] > 0 for k in need),
                    f"datapath {cfg.name}: operand {port} lacks special "
                    f"codes {specials[port]}")
    return case


def pipeline_case(dev, rng):
    """``XtraMACPipeline`` (int4 x bf16 and bf16 x bf16, the reference's
    fig6_parallelism setup) over 64 issues that switch datatype every
    cycle: no result before cycle 4, then one per cycle (II 1), each equal
    to unpacked per-lane MACs."""
    cfgs = [M.MacConfig.make("int4", "bf16", "bf16", "bf16"),
            M.MacConfig.make("bf16", "bf16", "bf16", "bf16")]
    pipe = XtraMACPipeline(cfgs, device=dev)
    issues = []
    for i in range(PIPELINE_ISSUES):
        cfg, plan = cfgs[i % 2], pipe.plans[i % 2]
        issues.append(Op(i % 2,
                         rng.integers(0, 1 << cfg.fmt_a.bits,
                                      len(plan.offsets_a)),
                         rng.integers(0, 1 << cfg.fmt_b.bits,
                                      len(plan.offsets_b)),
                         rng.integers(0, 1 << cfg.fmt_c.bits,
                                      plan.parallelism)))
    t0 = time.perf_counter()
    outs = [pipe.step(op) for op in issues]
    outs += [pipe.step(None) for _ in range(pipe.latency)]
    wall = time.perf_counter() - t0
    first = next(i for i, o in enumerate(outs) if o is not None)
    results = outs[first:]
    ii_one = all(o is not None for o in results) \
        and len(results) == len(issues)
    bad = 0
    for op, got in zip(issues, results):
        cfg, plan = cfgs[op.dtype_sel], pipe.plans[op.dtype_sel]
        want = P.per_lane_reference(
            cfg, plan, *(torch.as_tensor(x, device=dev)[None]
                         for x in (op.a_bits, op.b_bits, op.c_bits)))[0]
        bad += int(not np.array_equal(got, want.cpu().numpy()))
    case = {"pipeline": [c.name for c in cfgs], "issues": len(issues),
            "latency": pipe.latency, "first_result_cycle": first,
            "ii_one": ii_one, "mismatches": bad, "wall_s": wall}
    log(json.dumps(case))
    require(pipe.latency == 4 and first == 4,
            f"pipeline: latency {pipe.latency}, first result at cycle {first}")
    require(ii_one, "pipeline: not one result per cycle")
    require(bad == 0, f"pipeline: {bad} issues differ from per-lane MACs")
    return case


def datapath_phase(gen, dev, seed=3):
    rng = np.random.default_rng(seed)
    combos = [datapath_combo(combo, gen, dev, rng)
              for combo in DATAPATH_COMBOS]
    torch.cuda.empty_cache()
    return {"combos": combos, "pipeline": pipeline_case(dev, rng)}


# ---------------------------------------------------------------------------
# Phase 4: the model through the kernels and through the plain versions
# ---------------------------------------------------------------------------
def model_phase(path, cfg, params, dev, chunk: int, tiers=("bf16", "int8"),
                rows=8, steps=4, seed=1, witness=None, frontend=None):
    """Teacher-forced through the kernels, then through the plain versions
    fed the kernel run's ids; held to ``logit_check`` (why that bound:
    ``launch/logit_spread.py`` and PERF.md), at each KV tier of ``tiers``.
    Where the kernels miss the bound, ``witness`` names the
    ``logit_spread`` variant (plain math in the kernels' summation order,
    no kernel) whose spread from the plain run is recorded beside the
    kernels', and ``witness_check`` decides.  ``frontend``: the VLM's
    ``patches`` [rows, Np, D] prompt prefix, or the audio model's
    ``frames`` [rows, n_frames, D]."""
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab, (rows, chunk)),
                              device=dev)
    moe = cfg.family == "moe"
    out = {}
    for tier in tiers:
        routes = MOE.Routes() if moe else None
        got, ids = LS.teacher_forced(cfg, params, prompts, steps, kv=tier,
                                     plain=False, routes=routes,
                                     frontend=frontend)
        if moe:
            # a routing flip between the paths is not a kernel fault: count
            # the flips of a free plain run, then hold the kernel path to
            # the plain path on the kernel path's routes
            free = MOE.Routes()
            free_logits, _ = LS.teacher_forced(cfg, params, prompts, steps,
                                               kv=tier, plain=True, feed=ids,
                                               routes=free)
            flips = route_flips(routes, free, cfg.n_layers)
            flips["free_run"] = LS.logit_check(got, free_logits)
            del free_logits
        replay = MOE.Routes(routes.ids) if moe else None
        want, _ = LS.teacher_forced(cfg, params, prompts, steps, kv=tier,
                                    plain=True, feed=ids, routes=replay,
                                    frontend=frontend)
        out[tier] = res = LS.logit_check(got, want)
        if moe:
            res["routing"] = flips
        ok = res["logits_ok"]
        if not ok and witness is not None:
            plain, replace = LS.RUNS[witness]
            replay = MOE.Routes(routes.ids) if moe else None
            with LS.plain_ops(replace):
                wit, _ = LS.teacher_forced(cfg, params, prompts, steps,
                                           kv=tier, plain=plain, feed=ids,
                                           routes=replay,
                                           frontend=frontend)
            res["witness"] = {"variant": witness, **LS.logit_check(wit, want)}
            ok = res["witness_rule_ok"] = LS.witness_check(res,
                                                           res["witness"])
        log(json.dumps({"model_phase": path, "kv": tier, **res}))
        require(res["finite"], f"{path}: non-finite logits ({tier})")
        require(ok, f"{path}: model logits kernel vs plain ({tier}): "
                    f"max diff {res['max_abs_logit_diff']}")
        require(res["greedy_agree"],
                f"{path}: greedy tokens disagree ({tier})")
    return out


def route_flips(a: "MOE.Routes", b: "MOE.Routes", n_layers: int) -> dict:
    """How many (token, layer) expert sets differ between two recorded
    runs of the same calls, in all and by layer."""
    by_layer = [0] * n_layers
    total = 0
    for i, (x, y) in enumerate(zip(a.ids, b.ids)):
        differ = (x.sort(-1).values != y.sort(-1).values).any(-1)
        by_layer[i % n_layers] += int(differ.sum())
        total += differ.numel()
    return {"token_layer_sets": total, "differ": sum(by_layer),
            "differ_by_layer": by_layer}


# ---------------------------------------------------------------------------
# Phase 5: serving through the engine and scheduler
# ---------------------------------------------------------------------------
def serve_requests(cfg, seed=2, n=6, new_tokens=32):
    rng = np.random.default_rng(seed)
    lens = rng.integers(96, 257, n)
    return [rng.integers(1, cfg.vocab, (int(p),)).astype(np.int32)
            for p in lens], new_tokens


def serve_tier(cfg, params, tier, prompts, new_tokens, chunk, dev, obs=None):
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=512, n_slots=8, prefill_chunk=chunk, max_burst=8,
        policy=PrecisionPolicy(kv=tier), device=str(dev)))
    sched = Scheduler(engine, obs=obs)
    # staggered arrivals: two at once, then one every 4 scheduler steps, so
    # later requests are admitted while earlier ones decode
    pending = list(enumerate(prompts))
    reqs, mid_flight = [], 0
    sync(dev)
    t0 = time.perf_counter()
    while pending or sched.has_work:
        if pending and (not reqs or len(reqs) < 2
                        or sched.n_steps % 4 == 0):
            i, p = pending.pop(0)
            decoding = any(r.n_generated > 0 for r in reqs
                           if not r.is_finished)
            mid_flight += int(decoding)
            reqs.append(sched.submit(Request(
                prompt=p, sampling=SamplingParams(max_new_tokens=new_tokens))))
        sched.step()
    sync(dev)
    wall = time.perf_counter() - t0
    for r in reqs:
        require(r.is_finished and r.n_generated == new_tokens,
                f"request {r.id} finished with {r.n_generated} tokens")
        require(all(0 <= t < cfg.vocab for t in r.output_tokens),
                f"request {r.id} emitted an id outside the vocabulary")
    rep = sched.metrics.report()
    rep.update(kv=tier, admitted_mid_flight=mid_flight, host_wall_s=wall)
    return engine, reqs, rep, sched


def serve_tally(sched, reqs, launches) -> dict:
    """What an obs-on serve run must repeat of its obs-off run."""
    return {"tokens": [r.output_tokens for r in reqs],
            "n_host_syncs": sched.n_host_syncs,
            "decode_dispatches": sched.n_decode_dispatches,
            "steps": sched.n_steps,
            "burst_hist": dict(sched.metrics.burst_hist),
            "launches": launches}


def serve_phase(cfg, params, chunk, dev, tiers=("bf16", "int8")):
    """Each KV tier of ``tiers`` through the scheduler, the launch counters
    reset just before and read just after; then the path's own checks."""
    prompts, new_tokens = serve_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runs = []
    for tier in tiers:
        before = ops.launch_counts()
        engine, reqs, rep, sched = serve_tier(cfg, params, tier, prompts,
                                              new_tokens, chunk, dev)
        SERVE_TALLIES[(cfg.name, tier)] = (serve_tally(
            sched, reqs, {k: n - before[k]
                          for k, n in ops.launch_counts().items()}),
            rep["host_wall_s"])
        runs.append((engine, reqs, rep))
    launches = ops.launch_counts()
    formats = ops.format_launch_counts()
    grouped = ops.grouped_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plan = PrecisionPolicy().resolved_plan(cfg)
    n_w8a8 = sum(s == "w8a8" for s in plan.values())
    forwards = 0
    reports = []
    for engine, reqs, rep in runs:
        rep["peak_memory_bytes"] = peak
        log(json.dumps({"serve": rep, "arch": cfg.name}))
        require(rep["admitted_mid_flight"] > 0,
                f"{cfg.name} ({rep['kv']}): no mid-flight admission")
        forwards += rep["decode_token_steps"] + sum(
            -(-len(p) // chunk) for p in prompts)
        if n_w8a8:
            # W8A8 quantizes every row of a linear's call with one scale
            # (the reference's kernels/ops.py:327), so a request's tokens
            # depend on its batch-mates and a solo run may differ; the
            # same run repeated must give the same tokens
            _, again, _, _ = serve_tier(cfg, params, rep["kv"], prompts,
                                        new_tokens, chunk, dev)
            require([r.output_tokens for r in again]
                    == [r.output_tokens for r in reqs],
                    f"{cfg.name} ({rep['kv']}): a repeated serve run gave "
                    "other tokens")
        else:
            # greedy output must not depend on batch-mates or admission
            # (MoE: every request, since its routing is per row)
            for r in (reqs if cfg.family == "moe" else reqs[-2:]):
                solo = engine.generate({"tokens": r.prompt[None]},
                                       max_new_tokens=new_tokens)
                require(list(solo["generated"][0]) == r.output_tokens,
                        f"request {r.id} ({rep['kv']}) differs from its "
                        "solo run")
        reports.append(rep)
    log(json.dumps({"serve_launches": launches, "by_format": formats,
                    "grouped_by_rows": grouped, "arch": cfg.name}))
    check_path_launches(cfg.name, launches, formats, grouped)
    # every W8A8 leaf call of every forward (prefill chunk or decode step)
    # went through the int8 kernel
    want = n_w8a8 * cfg.n_layers * forwards
    require(launches["w8a8_matmul"] == want,
            f"{cfg.name}: {launches['w8a8_matmul']} int8 kernel launches, "
            f"{want} W8A8 leaf calls")
    return reports, launches, formats


# ---------------------------------------------------------------------------
# Phase 5b: one engine serves bf16, int8 and fp8 KV side by side
# ---------------------------------------------------------------------------
def tier_requests(cfg):
    """[(id, tier, priority, temperature, prompt)] of the mixed-tier path."""
    prompts, new_tokens = serve_requests(cfg, n=sum(TIERS_REQUESTS.values()))
    specs, i = [], 0
    for tier in TIERS:
        for j in range(TIERS_REQUESTS[tier]):
            prio = 5 if tier == "bf16" and j < TIERS_LOW_CLASS else 0
            temp = TIERS_TEMPERATURE if j % 3 == 1 else 0.0
            specs.append((i, tier, prio, temp, prompts[i]))
            i += 1
    return specs, new_tokens


def make_request(spec, new_tokens, priority=None) -> Request:
    rid, tier, prio, temp, prompt = spec
    return Request(prompt=prompt, id=rid, kv_policy=tier,
                   priority=prio if priority is None else priority,
                   sampling=SamplingParams(temperature=temp,
                                           max_new_tokens=new_tokens,
                                           seed=TIERS_SEED))


def watch_decode_dispatches(sched):
    """Record every decode dispatch of ``sched``'s engine: the round, the
    tier, the tiers with DECODE rows at that moment, and the launches by
    format the dispatch made."""
    log = []
    engine = sched.engine
    for name in ("decode_slots", "decode_burst"):
        def watched(pool, *a, _fn=getattr(engine, name), **kw):
            decoding = sorted({r.tier for r in sched.running.values()
                               if r.state is RequestState.DECODE})
            before = ops.format_launch_counts()
            out = _fn(pool, *a, **kw)
            after = ops.format_launch_counts()
            log.append({"round": sched.n_steps, "tier": pool.kv_dtype,
                        "decoding": decoding,
                        "launches": {k: n - before.get(k, 0)
                                     for k, n in after.items()
                                     if n != before.get(k, 0)}})
            return out
        setattr(engine, name, watched)
    return log


def serve_mixed(engine, specs, new_tokens, dev):
    """The mixed run: the 8 low-class bf16 requests arrive two at once,
    then one every 2 steps; once all 8 decode, the 2 high-class bf16
    requests (their pool is full: they preempt); then the int8 / fp8
    requests one every 4 steps, alternating."""
    sched = Scheduler(engine, tiers=list(TIERS))
    log = watch_decode_dispatches(sched)
    low = [s for s in specs if s[1] == "bf16" and s[2] > 0]
    high = [s for s in specs if s[1] == "bf16" and s[2] == 0]
    int8, fp8 = ([s for s in specs if s[1] == t] for t in ("int8", "fp8"))
    rest = [s for pair in zip(int8, fp8) for s in pair]
    reqs, preempted_at, mid_flight = [], {}, 0

    def submit(spec):
        nonlocal mid_flight
        mid_flight += int(any(r.n_generated > 0 and not r.is_finished
                              for r in reqs))
        reqs.append(sched.submit(make_request(spec, new_tokens)))

    sync(dev)
    t0 = time.perf_counter()
    while low or high or rest or sched.has_work:
        if low and (len(reqs) < 2 or sched.n_steps % 2 == 0):
            submit(low.pop(0))
        elif not low and high and all(r.n_generated > 0 for r in reqs):
            while high:
                submit(high.pop(0))
        elif not low and not high and rest and sched.n_steps % 4 == 0:
            submit(rest.pop(0))
        before = {r.id: r.n_preemptions for r in reqs}
        sched.step()
        for r in reqs:
            if r.n_preemptions > before[r.id]:
                preempted_at.setdefault(r.id, []).append(r.n_generated)
    sync(dev)
    return sched, reqs, log, preempted_at, mid_flight, \
        time.perf_counter() - t0


def serve_single_tier(engine, tier, specs, new_tokens):
    """The tier's requests (same ids, seeds and prompts) through a
    one-tier scheduler of the same pool geometry, one class, all at once:
    {id: tokens}."""
    sched = Scheduler(engine, tiers=[tier])
    reqs = [sched.submit(make_request(s, new_tokens, priority=0))
            for s in specs if s[1] == tier]
    sched.run()
    return {r.id: list(r.output_tokens) for r in reqs}


def replay_logits(engine, spec, tokens, n_slots, resumes=None):
    """A run recomputed teacher-forced on a slab pool, the [T, V] f32
    logits each of ``tokens`` was sampled from: the prompt prefilled into
    one slot of a fresh pool of the same width, then ``tokens`` fed one
    per decode step.  ``resumes`` maps a count of generated tokens to the
    first position a resume re-prefilled there (0 on a slab pool; a paged
    pool's resume starts past its adopted prefix pages): the slot is first
    refilled from that position as the resume refills it, a chunked
    prefill of the prompt and every token but the last
    (``Scheduler._preempt``)."""
    _, tier, _, _, prompt = spec
    pool = engine.new_pool(n_slots=n_slots, kv_dtype=tier)
    slot = pool.alloc()
    rows = engine.prefill_into_slots(pool, [slot], [prompt])
    feed = np.zeros((n_slots,), np.int32)
    c = engine.scfg.prefill_chunk
    for step in range(1, len(tokens)):
        if resumes and step in resumes:
            padded, n = engine.pad_prompt(np.concatenate(
                [prompt, np.asarray(tokens[:step - 1], np.int32)]))
            for off in range(resumes[step], n, c):
                engine.prefill_chunk_into_slot(pool, slot, padded, off,
                                               prompt_len=n,
                                               need_logits=False)
        feed[slot] = tokens[step - 1]
        rows.append(engine.decode_slots_with_logits(pool, feed)[slot])
        pool.lengths[slot] += 1
    return torch.stack(rows)


def decision_scores(spec, logits):
    """(the scores the sampler compared at each token [T, V]: ``logits``,
    or logits / t + Gumbel noise from the step's key; 5 % of the logit
    scale at each step, in the scores' units [T]; the ids the sampler
    picks [T])."""
    rid, _, _, temp, _ = spec
    keys = batched_step_keys([TIERS_SEED], [rid], [0], len(logits))[0]
    temps = np.full((len(logits),), temp, np.float32)
    ids = sample_rows(logits, keys, temps).cpu().numpy()
    bound = LS.LOGIT_REL_TOL * logits.abs().amax(-1)
    if temp <= 0:
        return logits, bound, ids
    t = torch.as_tensor(temps, device=logits.device)
    return temperature_scores(logits, keys, t), bound / temp, ids


def resume_check(single, spec, r, want, resumes, n_slots, path):
    """Check iv for one preempted request ``r``: its unpreempted tokens
    ``want`` recomputed teacher-forced must give ``want``; its own tokens,
    recomputed on the resume's route (``resumes``: {generated count at a
    preemption: first position re-prefilled}), its tokens; from its first
    preemption to the step where it parts from ``want``, its logits within
    ``logit_check``'s bound of the unpreempted run's; and it parts only at
    a top-2 gap under 5 % of the logit scale.  Returns the logged entry."""
    rid = spec[0]
    at = min(resumes)
    same = next((i for i, (a, b) in enumerate(zip(r.output_tokens, want))
                 if a != b), len(want))
    logits = replay_logits(single, spec, want, n_slots)
    scores, bound, ids = decision_scores(spec, logits)
    require(list(ids) == want, f"{path}: request {rid}'s teacher-forced "
                               "recompute does not give its tokens")
    resumed = replay_logits(single, spec, r.output_tokens, n_slots,
                            resumes=resumes)
    require(list(decision_scores(spec, resumed)[2]) == r.output_tokens,
            f"{path}: request {rid}'s resume recomputed teacher-forced "
            "does not give its tokens")
    span = slice(min(at, same), min(same + 1, len(want)))
    held = LS.logit_check(resumed[span], logits[span])
    entry = {"id": rid, "tier": r.tier,
             "temperature": r.sampling.temperature,
             "preempted_at_token": sorted(resumes),
             "resume_prefill_from": [resumes[p] for p in sorted(resumes)],
             "tokens_matched": same,
             "resumed_logits": {
                 "tokens": [span.start, span.stop],
                 "max_abs_logit_diff": held["max_abs_logit_diff"],
                 "tolerance": held["tolerance"]}}
    require(held["finite"] and held["logits_ok"],
            f"{path}: resumed request {rid}'s logits from token {at} "
            f"are not its unpreempted run's: {entry}")
    if same < len(want):
        top2 = scores[same].topk(2).values
        entry.update(gap=float(top2[0] - top2[1]), bound=float(bound[same]))
        require(same >= at and entry["gap"] < entry["bound"],
                f"{path}: resumed request {rid} parts from its "
                f"unpreempted run at token {same}: {entry}")
    log(json.dumps({"resume": entry, "path": path}))
    return entry


def sampler_check(dev):
    """Check vii: the sampler on the card against the same functions on
    the CPU, at the granite tiers' widest cohort (15 rows, vocab 49152)."""
    gen = np.random.default_rng(11)
    v = get_config("granite-8b").vocab
    logits = torch.as_tensor(gen.normal(0, 3, (SAMPLER_ROWS, v)),
                             dtype=torch.float32)
    keys = batched_step_keys(np.full(SAMPLER_ROWS, TIERS_SEED),
                             np.arange(SAMPLER_ROWS),
                             gen.integers(0, 32, SAMPLER_ROWS), 1)[:, 0]
    temps = np.full((SAMPLER_ROWS,), TIERS_TEMPERATURE, np.float32)
    out = {}
    for where in ("cpu", dev):
        k = threefry.keys_tensor(keys, where)
        out[str(where)] = {
            "bits": threefry.random_bits(k, v).cpu(),
            "uniform": threefry.uniform(k, v, threefry.F32_TINY, 1.0).cpu(),
            "gumbel": threefry.gumbel(k, v).cpu(),
            "ids": sample_rows(logits.to(where), keys, temps).cpu()}
    cpu, card = out["cpu"], out[str(dev)]
    g_cpu, g_card = cpu["gumbel"], card["gumbel"]
    ulp = torch.finfo(torch.float32).eps * torch.clamp_min(g_cpu.abs(), 1.0)
    gumbel_ulps = float(((g_card - g_cpu).abs() / ulp).max())
    scores = temperature_scores(logits, keys, torch.as_tensor(temps))
    top2 = scores.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) <= NEAR_TIE
    differ = cpu["ids"] != card["ids"]
    res = {"rows": SAMPLER_ROWS, "vocab": v,
           "bits_equal": bool(torch.equal(cpu["bits"], card["bits"])),
           "uniform_equal": bool(torch.equal(
               cpu["uniform"].view(torch.int32),
               card["uniform"].view(torch.int32))),
           "gumbel_max_ulps": gumbel_ulps,
           "gumbel_elements_differ": int((g_cpu != g_card).sum()),
           "ids_differ": int(differ.sum()), "near_ties": int(near.sum())}
    log(json.dumps({"sampler_card_vs_cpu": res}))
    require(res["bits_equal"], "sampler: random bits differ card vs CPU")
    require(res["uniform_equal"], "sampler: uniforms differ card vs CPU")
    require(gumbel_ulps <= GUMBEL_ULPS,
            f"sampler: Gumbel noise {gumbel_ulps} ulps from the CPU's")
    require(not bool((differ & ~near).any()),
            "sampler: ids differ card vs CPU off a near tie")
    return res


def tiers_phase(cfg, params, chunk, dev):
    """One engine, three KV tiers from one budget, mixed priorities and
    temperatures: checks i-vii of the mixed-tier path.  Launch counts are
    set to 0 just before the mixed run and read just after."""
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=512, prefill_chunk=chunk, max_burst=8,
        cache_budget_bytes=layer_budget(cfg, TIERS_BUDGET), device=str(dev)))
    specs, new_tokens = tier_requests(cfg)
    by_id = {s[0]: s for s in specs}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sched, reqs, dispatches, preempted_at, mid_flight, wall = serve_mixed(
        engine, specs, new_tokens, dev)
    launches = ops.launch_counts()
    formats = ops.format_launch_counts()
    slots = {t: p.n_slots for t, p in sched.pools.items()}
    rep = sched.metrics.report()
    rep.update(admitted_mid_flight=mid_flight, host_wall_s=wall,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               tier_tokens_per_s={
                   t: sum(r.n_generated for r in reqs if r.tier == t)
                   / (max(r.finish_time for r in reqs if r.tier == t)
                      - min(r.arrival_time for r in reqs if r.tier == t))
                   for t in TIERS})
    log(json.dumps({"serve": rep, "path": "granite-8b-tiers"}))
    log(json.dumps({"serve_launches": launches, "by_format": formats,
                    "path": "granite-8b-tiers"}))
    require(slots == TIERS_SLOTS, f"tiers: slots {slots}, not {TIERS_SLOTS}")
    require(rep.get("preemptions", 0) >= 2,
            f"tiers: {rep.get('preemptions', 0)} preemptions, not >= 2")
    require(mid_flight > 0, "tiers: no mid-flight admission")
    # i. every request finishes with its tokens, all in the vocabulary
    for r in reqs:
        require(r.is_finished and r.n_generated == new_tokens,
                f"tiers: request {r.id} finished with {r.n_generated} tokens")
        require(all(0 <= t < cfg.vocab for t in r.output_tokens),
                f"tiers: request {r.id} emitted an id outside the vocabulary")
    # ii. each request is its single-tier run's, bit for bit (the
    # preempted ones: iv); iii. the int8 run repeats at max_burst=1
    single = ServingEngine(cfg, params, engine.scfg)
    solo = {}
    for tier in TIERS:
        solo.update(serve_single_tier(single, tier, specs, new_tokens))
    for r in reqs:
        if r.id not in preempted_at:
            require(r.output_tokens == solo[r.id],
                    f"tiers: request {r.id} ({r.tier}, t={r.sampling.temperature})"
                    " differs from its single-tier run")
    stepwise = serve_single_tier(ServingEngine(cfg, params, dataclasses.replace(
        engine.scfg, max_burst=1)), "int8", specs, new_tokens)
    require(all(stepwise[i] == solo[i] for i in stepwise),
            "tiers: int8 at max_burst=1 differs from its bursts")
    # iv. a preempted request is its unpreempted run up to a step whose
    # top-2 gap (teacher-forced) is under 5 % of the logit scale; from its
    # first preemption to that step, its logits (recomputed teacher-forced
    # on the resume's route, which must give its tokens) are the
    # unpreempted run's within logit_check's bound
    resumes = []
    for rid, points in sorted(preempted_at.items()):
        r = next(q for q in reqs if q.id == rid)
        resumes.append(resume_check(single, by_id[rid], r, solo[rid],
                                    {p: 0 for p in points}, slots[r.tier],
                                    "tiers"))
    # v. one decode dispatch per active tier cohort per round
    rounds = {}
    for d in dispatches:
        rounds.setdefault(d["round"], []).append(d)
    bad = [n for n, ds in rounds.items()
           if sorted(d["tier"] for d in ds) != ds[0]["decoding"]]
    require(not bad, f"tiers: rounds {bad[:5]} did not dispatch once per "
                     "decoding tier")
    # vi. K1 on the 8-row bf16 cohort, K2 on the 15-row cohorts, K3 / K4
    by_tier = {}
    for d in dispatches:
        acc = by_tier.setdefault(d["tier"], {})
        for k, n in d["launches"].items():
            acc[k] = acc.get(k, 0) + n
    log(json.dumps({"decode_launches_by_tier": by_tier}))
    k1 = {t: sum(n for k, n in by_tier.get(t, {}).items()
                 if k.startswith("packed_gemv:")) for t in TIERS}
    k2 = {t: sum(n for k, n in by_tier.get(t, {}).items()
                 if k.startswith("packed_matmul:")) for t in TIERS}
    require(k1["bf16"] > 0 and k2["bf16"] == 0,
            f"tiers: bf16 cohort (8 rows) K1 {k1['bf16']}, K2 {k2['bf16']}")
    for t in ("int8", "fp8"):
        require(k1[t] == 0 and k2[t] > 0,
                f"tiers: {t} cohort (15 rows) K1 {k1[t]}, K2 {k2[t]}")
        require(by_tier.get(t, {}).get(f"decode_attention_quant:{t}", 0) > 0,
                f"tiers: no K4 launch on the {t} cohort")
    check_path_launches("granite-8b-tiers", launches, formats)
    # vii. the sampler on the card against the CPU
    sampler = sampler_check(dev)
    return {"slots": slots, "serve": rep, "resumes": resumes,
            "decode_launches_by_tier": by_tier, "sampler": sampler,
            "rounds": len(rounds)}, launches, formats


# ---------------------------------------------------------------------------
# Phase 5c: serving from a paged KV pool
# ---------------------------------------------------------------------------
def paged_requests(cfg, seed=5):
    """{name: (id, tier, priority, temperature, prompt)} of the paged path:
    two 192-token prefixes A and B from ``seed``, each request its family's
    prefix plus a suffix of ``PAGED_SUFFIX[name]`` tokens (A6 / A7: none,
    full-cover hits); A1 and A4 at temperature 0.8; B6 at priority 0, the
    rest at 5."""
    rng = np.random.default_rng(seed)
    pre = {f: rng.integers(1, cfg.vocab, (PAGED_PREFIX,)).astype(np.int32)
           for f in "AB"}
    specs = {}
    for rid, (name, n) in enumerate(PAGED_SUFFIX.items()):
        prompt = np.concatenate([pre[name[0]], rng.integers(
            1, cfg.vocab, (n,)).astype(np.int32)])
        temp = TIERS_TEMPERATURE if name in PAGED_HOT else 0.0
        specs[name] = (rid, None, 0 if name == "B6" else 5, temp, prompt)
    return specs


def serve_paged(engine, tier, specs, new_tokens, dev):
    """One paged run at ``tier``: A0 first; A1-A7 one every 2 steps once
    A0's prefill has published A's pages; B0 once A0-A7 have retired; B1-B5
    and A8 at once after B0's prefill (more than the arena holds: some wait
    for pages with a slot free); B6 (priority 0) once B0-B4 decode (it
    preempts).  After every step the page invariant is checked: no page
    with refcount > 1 under a running row's write position.  Returns
    (scheduler, {name: request}, observations)."""
    sched = Scheduler(engine, tiers=[tier])
    pool = sched.pools[tier]
    alloc = pool.allocator
    obs = {"page_holds": 0, "invariant_breaks": 0, "digests": {},
           "preempted_at": {}, "resume_from": {}}

    def admit(tokens, max_new, _fn=pool.admit):
        free = pool.n_free
        out = _fn(tokens, max_new)
        obs["page_holds"] += int(out is None and free > 0)
        return out

    def register(slot, tokens, _fn=pool.register_prefix):
        known = dict(alloc.page_key)
        n = _fn(slot, tokens)
        for page, key in alloc.page_key.items():
            if known.get(page) != key:
                obs["digests"][page] = page_digest(pool, page)
        return n

    pool.admit, pool.register_prefix = admit, register
    reqs = {}

    def submit(name):
        rid, _, prio, temp, prompt = specs[name]
        reqs[name] = sched.submit(make_request((rid, tier, prio, temp, prompt),
                                               new_tokens))

    def started(name):
        return name in reqs and reqs[name].n_generated > 0

    queue_a = [f"A{i}" for i in range(1, 8)]
    queue_b = [f"B{i}" for i in range(1, 6)] + ["A8"]
    last = 0
    sync(dev)
    t0 = time.perf_counter()
    submit("A0")
    while sched.has_work or queue_a or queue_b or "B6" not in reqs:
        step = sched.n_steps
        if queue_a and started("A0") and step - last >= 2:
            submit(queue_a.pop(0))
            last = step
        elif not queue_a and "B0" not in reqs and all(
                reqs[f"A{i}"].is_finished for i in range(8)):
            submit("B0")
        elif queue_b and started("B0"):
            while queue_b:
                submit(queue_b.pop(0))
        elif not queue_b and "B6" not in reqs and all(
                started(f"B{i}") for i in range(5)):
            submit("B6")
        before = {n: r.n_preemptions for n, r in reqs.items()}
        if sched.n_steps >= PAGED_MAX_STEPS:
            require(False, f"paged ({tier}): not drained in "
                           f"{PAGED_MAX_STEPS} steps")
            break
        sched.step()
        for n, r in reqs.items():
            if r.n_preemptions > before[n]:
                obs["preempted_at"].setdefault(n, []).append(r.n_generated)
            elif (r.n_preemptions and r.slot is not None
                  and len(obs["resume_from"].get(n, ())) < r.n_preemptions):
                obs["resume_from"].setdefault(n, []).append(
                    r.prefix_hit_tokens)
        for r in sched.running.values():
            pos = int(pool.lengths[r.slot])
            if pos < pool.capacity:
                page = int(pool.page_table[r.slot, pos // pool.page_size])
                obs["invariant_breaks"] += int(
                    page != 0 and alloc.refcounts[page] > 1)
    sync(dev)
    obs["wall_s"] = time.perf_counter() - t0
    return sched, reqs, obs


def page_digest(pool, page: int) -> str:
    """sha256 of one arena page's bytes over every layer, K and V, codes
    and scales."""
    h = hashlib.sha256()
    for slab in pool.cache:
        leaves = [slab.packed, slab.scales] \
            if isinstance(slab, QuantizedKV) else [slab]
        for a in leaves:
            h.update(a[:, page].contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
    return h.hexdigest()


def serve_slab_reference(cfg, params, scfg, tier, specs, new_tokens):
    """The same requests (ids, seeds, prompts) on a slab pool of the same
    width, fully provisioned, one class, all at once: {name: tokens}."""
    engine = ServingEngine(cfg, params, dataclasses.replace(
        scfg, paged=False, cache_budget_bytes=None))
    sched = Scheduler(engine, tiers=[tier])
    reqs = {n: sched.submit(make_request((rid, tier, 0, temp, prompt),
                                         new_tokens))
            for n, (rid, _, _, temp, prompt) in specs.items()}
    sched.run()
    return {n: list(r.output_tokens) for n, r in reqs.items()}


def paged_phase(cfg, params, chunk, dev):
    """granite-8b FULL from a paged pool, bf16 (16 pages) and int8 (15
    pages): checks i-vi of the paged path.  Launch counts are set to 0
    just before the two paged runs and read just after."""
    specs = paged_requests(cfg)
    new_tokens = PAGED_NEW_TOKENS
    base = ServeConfig(paged=True, max_len=512, prefill_chunk=chunk,
                       n_slots=8, max_burst=8, device=str(dev))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runs = {}
    for tier, budget in PAGED_BUDGETS.items():
        engine = ServingEngine(cfg, params, dataclasses.replace(
            base, cache_budget_bytes=layer_budget(cfg, budget),
            policy=PrecisionPolicy(kv=tier)))
        runs[tier] = (engine, *serve_paged(engine, tier, specs, new_tokens,
                                           dev))
    launches = ops.launch_counts()
    formats = ops.format_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"serve_launches": launches, "by_format": formats,
                    "path": "granite-8b-paged"}))
    out = {"tiers": {}}
    for tier, (engine, sched, reqs, obs) in runs.items():
        pool = sched.pools[tier]
        rep = sched.metrics.report()
        res = {"n_pages": pool.n_pages, "page_bytes": pool.cache_bytes
               // pool.n_pages, "arena_bytes": pool.cache_bytes,
               "peak_memory_bytes": peak, "host_wall_s": obs["wall_s"],
               "tokens_per_s": rep["tokens_per_s"],
               "ttft_p50_s": rep["ttft_p50_s"],
               "ttft_hit_p50_s": rep.get("ttft_hit_p50_s"),
               "ttft_miss_p50_s": rep.get("ttft_miss_p50_s"),
               "pages": rep["pages"][tier],
               "prefix_hits": pool.n_prefix_hits,
               "prefix_misses": pool.n_prefix_misses,
               "prefix_hit_tokens": pool.prefix_hit_tokens_total,
               "cow_copies": pool.n_cow_copies,
               "evictions": pool.n_evictions,
               "page_holds": obs["page_holds"],
               "preemptions": rep.get("preemptions", 0),
               "preempted_at": obs["preempted_at"],
               "resume_prefix_hit_tokens": obs["resume_from"]}
        log(json.dumps({"serve": res, "path": "granite-8b-paged",
                        "kv": tier}))
        tag = f"paged ({tier})"
        require(pool.n_pages == PAGED_PAGES[tier],
                f"{tag}: {pool.n_pages} pages, not {PAGED_PAGES[tier]}")
        for n, r in reqs.items():
            require(r.is_finished and r.n_generated == new_tokens,
                    f"{tag}: {n} finished with {r.n_generated} tokens")
            require(all(0 <= t < cfg.vocab for t in r.output_tokens),
                    f"{tag}: {n} emitted an id outside the vocabulary")
        # i. every request not preempted is its slab run's, bit for bit
        slab = serve_slab_reference(cfg, params, engine.scfg, tier, specs,
                                    new_tokens)
        for n, r in reqs.items():
            if n not in obs["preempted_at"]:
                require(r.output_tokens == slab[n],
                        f"{tag}: {n} (t={r.sampling.temperature}) differs "
                        "from its slab run")
        # ii. a resume adopts its registered prompt pages and re-prefills
        # only the tail; held to its unpreempted run by check iv's rule
        require(obs["preempted_at"], f"{tag}: no preemption")
        single = ServingEngine(cfg, params, dataclasses.replace(
            engine.scfg, paged=False, cache_budget_bytes=None))
        res["resumes"] = []
        for n, points in sorted(obs["preempted_at"].items()):
            hits = obs["resume_from"].get(n, [])
            require(len(hits) == len(points) and all(h > 0 for h in hits),
                    f"{tag}: {n}'s resume adopted no prefix pages ({hits})")
            if len(hits) != len(points):
                continue
            rid, _, prio, temp, prompt = specs[n]
            res["resumes"].append(resume_check(
                single, (rid, tier, prio, temp, prompt), reqs[n], slab[n],
                dict(zip(points, hits)), engine.scfg.n_slots,
                f"paged-{tier}"))
        # iii. prefix hits, copies, evictions, a waiter held for pages
        require(pool.n_prefix_hits >= 12,
                f"{tag}: {pool.n_prefix_hits} prefix hits, not >= 12")
        require(pool.n_cow_copies >= 2,
                f"{tag}: {pool.n_cow_copies} COW copies, not >= 2")
        require(pool.n_evictions >= 1, f"{tag}: no eviction")
        require(obs["page_holds"] >= 1,
                f"{tag}: no waiter held for pages with a slot free")
        # iv. the allocator's invariants, no leak, no shared page written to
        try:
            pool.allocator.check()
        except AssertionError as e:
            require(False, f"{tag}: allocator invariant: {e}")
        require(pool.pages_in_use == 0
                and pool.pages_free + pool.pages_cached == pool.n_pages - 1,
                f"{tag}: pages leak: {res['pages']}")
        require(obs["invariant_breaks"] == 0,
                f"{tag}: {obs['invariant_breaks']} shared pages under a "
                "write position")
        # v. every page still registered holds its bytes of registration
        changed = [p for p in pool.allocator.page_key
                   if page_digest(pool, p) != obs["digests"][p]]
        res["registered_pages_checked"] = len(pool.allocator.page_key)
        require(not changed, f"{tag}: registered pages {changed} changed")
        out["tiers"][tier] = res
    # vi. K1 / K2 / K3 (bf16) / K4 (int8) launched, K5 / K6 not
    check_path_launches("granite-8b-paged", launches, formats)
    return out, launches, formats

# ---------------------------------------------------------------------------
# Phase 5d: serving under an SLO policy and a fenced dispatch
# ---------------------------------------------------------------------------
def slo_requests(cfg, seed=SLO_SEED):
    """[{id, wave, priority, temperature, prompt, ttft, e2e}] of the SLO
    path: every request asks for bf16 KV and a third of each wave samples
    at 0.8; wave 2 opens with SLO_TTFT_REQUESTS whose TTFT deadline is
    SLO_TTFT_DEADLINE_S and ends with SLO_PRIO0 at priority 0; the wave-1
    requests SLO_E2E_IDS carry an e2e deadline of SLO_E2E_DEADLINE_S; the
    rest are priority 2 without deadlines."""
    rng = np.random.default_rng(seed)
    specs, rid = [], 0
    for wave, n in enumerate(SLO_WAVES):
        for j in range(n):
            prompt = rng.integers(1, cfg.vocab, (int(rng.integers(64, 193)),))
            specs.append(dict(
                id=rid, wave=wave,
                priority=0 if wave == 1 and j >= n - SLO_PRIO0 else 2,
                temperature=TIERS_TEMPERATURE if j % 3 == 1 else 0.0,
                prompt=prompt.astype(np.int32),
                ttft=SLO_TTFT_DEADLINE_S
                if wave == 1 and j < SLO_TTFT_REQUESTS else None,
                e2e=SLO_E2E_DEADLINE_S
                if wave == 0 and j in SLO_E2E_IDS else None))
            rid += 1
    return specs


def slo_policy() -> SLOPolicy:
    return SLOPolicy(max_waiting=SLO_MAX_WAITING, protect_priority=0,
                     downgrade_map={"bf16": "int8"},
                     downgrade_high_s=SLO_HIGH_S, downgrade_low_s=SLO_LOW_S,
                     max_step_s=SLO_MAX_STEP_S)


def slo_request(spec, new_tokens, tier="bf16", deadlines=True) -> Request:
    return Request(prompt=spec["prompt"], id=spec["id"], kv_policy=tier,
                   priority=spec["priority"],
                   ttft_deadline_s=spec["ttft"] if deadlines else None,
                   e2e_deadline_s=spec["e2e"] if deadlines else None,
                   sampling=SamplingParams(temperature=spec["temperature"],
                                           max_new_tokens=new_tokens,
                                           seed=TIERS_SEED))


def serve_slo(engine, specs, new_tokens, policy, arm_faults, dev,
              tiers=SLO_TIERS):
    """Run A: wave 1 at step 0, wave 2 at step SLO_WAVE2_STEP, wave 3 once
    the system has drained; the clock advances SLO_CLOCK_STEP a step and
    the fault injector is armed at step SLO_FAULT_ARM_STEP.  Returns
    (scheduler, {id: request}, observations)."""
    t = [0.0]
    sched = Scheduler(engine, tiers=tiers, clock=lambda: t[0], slo=policy)
    waves = [[s for s in specs if s["wave"] == w]
             for w in range(len(SLO_WAVES))]
    reqs, obs = {}, {"preempted_at": {}, "submits": [], "degraded": []}

    def submit(spec):
        r = sched.submit(slo_request(spec, new_tokens))
        reqs[r.id] = r
        obs["submits"].append({"id": r.id, "step": sched.n_steps,
                               "estimate_s": policy.last_estimate_s,
                               "degraded": policy.degraded, "tier": r.tier,
                               "rejection": None if r.rejection is None
                               else r.rejection.kind})
        obs["degraded"].append(policy.degraded)

    sync(dev)
    t0 = time.perf_counter()
    for spec in waves[0]:
        submit(spec)
    while sched.has_work or waves[1] or waves[2]:
        if waves[1] and sched.n_steps >= SLO_WAVE2_STEP:
            for spec in waves[1]:
                submit(spec)
            waves[1] = []
        if sched.n_steps == SLO_FAULT_ARM_STEP:
            arm_faults()
        if sched.n_steps >= SLO_MAX_STEPS:
            require(False, f"slo: not drained in {SLO_MAX_STEPS} steps")
            break
        before = {i: r.n_preemptions for i, r in reqs.items()}
        sched.step()
        t[0] += SLO_CLOCK_STEP
        for i, r in reqs.items():
            if r.n_preemptions > before[i]:
                obs["preempted_at"].setdefault(i, []).append(r.n_generated)
        if not sched.has_work and not waves[1] and waves[2]:
            for spec in waves[2]:
                submit(spec)
            waves[2] = []
    sync(dev)
    obs["wall_s"] = time.perf_counter() - t0
    return sched, reqs, obs


def slo_rerun(engine, specs, reqs, new_tokens, slots):
    """Every request run A started, again at its final tier with all its
    new tokens, no deadline, no policy and no injector, one class, on
    pools of run A's widths ``slots``: {id: tokens}."""
    out = {}
    for tier, width in slots.items():
        mine = [s for s in specs if reqs[s["id"]].n_generated > 0
                and reqs[s["id"]].tier == tier]
        if not mine:
            continue
        sched = Scheduler(engine, tiers={tier: width})
        again = [sched.submit(slo_request(dict(s, priority=0), new_tokens,
                                          tier=tier, deadlines=False))
                 for s in mine]
        sched.run()
        out.update({r.id: list(r.output_tokens) for r in again})
    return out


def slo_phase(cfg, params, chunk, dev):
    """granite-8b FULL under an SLOPolicy and a seeded fault injector:
    checks 1-4 of the SLO path (5, its seconds, is the caller's print).
    Launch counts are set to 0 just before run A and read just after."""
    specs = slo_requests(cfg)
    new_tokens = PAGED_NEW_TOKENS
    args = argparse.Namespace(fault_rate=SLO_FAULT_RATE, seed=SLO_SEED)
    injector, arm = build_fault_injector(args)
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=512, prefill_chunk=chunk, max_burst=8,
        cache_budget_bytes=layer_budget(cfg, TIERS_BUDGET), device=str(dev),
        fault_injector=injector, max_fault_retries=SLO_FAULT_RETRIES))
    policy = slo_policy()
    prices = {b: decode_latency(cfg, "awq_int4", batch=b, context=256,
                                design="xtramac",
                                engine_model=gemv_engine_for("awq_int4"))
              ["t_total_s"] for b in (1, 8, 23)}
    log(json.dumps({"slo_model_step_s": prices, "path": "granite-8b-slo"}))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sched, reqs, obs = serve_slo(engine, specs, new_tokens, policy, arm, dev)
    launches = ops.launch_counts()
    formats = ops.format_launch_counts()
    rep = sched.metrics.report()
    slots = {t: p.n_slots for t, p in sched.pools.items()}
    ests = [s["estimate_s"] for s in obs["submits"]]
    res = {"slots": slots, "snapshot": policy.snapshot(),
           "estimates_s": {"first": ests[0], "max": max(ests),
                           "last": ests[-1]},
           "host_wall_s": obs["wall_s"], "steps": sched.n_steps,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "preempted_at": obs["preempted_at"], "submits": obs["submits"]}
    log(json.dumps({"serve": rep, "path": "granite-8b-slo"}))
    log(json.dumps({"slo": {k: v for k, v in res.items() if k != "submits"},
                    "path": "granite-8b-slo"}))
    log(json.dumps({"serve_launches": launches, "by_format": formats,
                    "path": "granite-8b-slo"}))
    require(slots == {t: TIERS_SLOTS[t] for t in SLO_TIERS},
            f"slo: slots {slots}")
    # 1. accounting
    reasons = {"length", "rejected", "deadline_exceeded", "fault"}
    finished = [r.id for r in sched.finished]
    require(sorted(finished) == sorted(reqs) == [s["id"] for s in specs],
            "slo: a request did not finish exactly once")
    for r in reqs.values():
        require(r.is_finished and r.finish_reason in reasons,
                f"slo: request {r.id} finished by {r.finish_reason}")
        require(all(0 <= t < cfg.vocab for t in r.output_tokens),
                f"slo: request {r.id} emitted an id outside the vocabulary")
        require(r.priority > 0 or r.finish_reason != "rejected",
                f"slo: priority-0 request {r.id} was rejected")
    fr, kinds = rep.get("finish_reasons", {}), rep.get("rejection_kinds", {})
    require(rep.get("rejections", 0) == sum(kinds.values())
            == fr.get("rejected", 0),
            f"slo: rejections {rep.get('rejections')}, kinds {kinds}, "
            f"finish reasons {fr}")
    require(kinds.get("queue_full", 0) >= 1, f"slo: no queue_full: {kinds}")
    require(rep.get("downgrades", 0) >= 1, "slo: no downgrade")
    require(any(obs["degraded"]) and not policy.degraded,
            "slo: the downgrade did not engage and release")
    require(fr.get("deadline_exceeded", 0) >= 1, "slo: no deadline shed")
    require(set(rep.get("fault_kinds", {})) >= {"injected", "nan"},
            f"slo: fault kinds {rep.get('fault_kinds')}")
    # 2. requests with no fault and no preemption are their rerun's, bit
    # for bit (a request retired by its deadline or its faults: a prefix
    # of it); 3. faulted or preempted ones by check iv of the tiers path
    single = ServingEngine(cfg, params, dataclasses.replace(
        engine.scfg, fault_injector=None))
    rerun = slo_rerun(single, specs, reqs, new_tokens, slots)
    res["resumes"], res["bit_for_bit"] = [], 0
    for rid, r in sorted(reqs.items()):
        if rid not in rerun:
            continue
        want = rerun[rid][:r.n_generated]
        if r.finish_reason == "length":
            require(r.n_generated == new_tokens,
                    f"slo: request {rid} retired by length early")
        # a request resumed before its last token is held by rule iv; one
        # never preempted, or only before its first token or after its
        # last, emitted every token on the route of an undisturbed run
        points = [p for p in obs["preempted_at"].get(rid, [])
                  if 0 < p < r.n_generated]
        if not points:
            require(r.output_tokens == want,
                    f"slo: request {rid} ({r.tier}, "
                    f"t={r.sampling.temperature}, {r.n_faults} faults) "
                    "differs from its rerun")
            res["bit_for_bit"] += 1
            continue
        spec = (rid, r.tier, r.priority, r.sampling.temperature, r.prompt)
        res["resumes"].append(resume_check(
            single, spec, r, want, {p: 0 for p in points}, slots[r.tier],
            "slo"))
    require(res["bit_for_bit"] >= 4,
            f"slo: {res['bit_for_bit']} fault-free requests checked")
    # 4. K1 (bf16 cohort), K2 (prefill, int8 cohort), K3 and K4 launched
    check_path_launches("granite-8b-slo", launches, formats)
    res["serve"] = rep
    return res, launches, formats


# ---------------------------------------------------------------------------
# Phase 5e: speculative decoding with an int8-KV draft
# ---------------------------------------------------------------------------
def spec_requests(cfg, seed=SPEC_SEED):
    """[(id, temperature, prompt)] of the speculative path."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(SPEC_REQUESTS):
        prompt = rng.integers(1, cfg.vocab, (int(rng.integers(64, 193)),))
        out.append((i, TIERS_TEMPERATURE if i % 3 == 1 else 0.0,
                    prompt.astype(np.int32)))
    return out


def serve_spec(engine, specs, spec, dev, bundle=None):
    """One run of the speculative path: SPEC_EARLY requests at step 0, the
    rest at SPEC_LATE_STEP, with the observability ``bundle`` attached
    (None: none).  Returns (scheduler, {id: request}, log): ``log`` holds
    the host wall, each spec round's draft and verify dispatches by step,
    and the launches by format inside the draft's catch-up."""
    sched = Scheduler(engine, spec=spec, obs=bundle)
    obs = {"verify": [], "draft": [], "catchup_launches": {}}
    if spec is not None:
        verify, draft = engine.verify_slots, sched.draft.draft_burst
        catch_up = sched.draft.catch_up

        def watched_verify(pool, *a, **kw):
            obs["verify"].append((sched.n_steps, pool.kv_dtype))
            return verify(pool, *a, **kw)

        def watched_draft(tier, *a, **kw):
            obs["draft"].append((sched.n_steps, tier))
            return draft(tier, *a, **kw)

        def watched_catch_up(*a, **kw):
            before = ops.format_launch_counts()
            n = catch_up(*a, **kw)
            for k, v in ops.format_launch_counts().items():
                if v != before.get(k, 0):
                    obs["catchup_launches"][k] = \
                        obs["catchup_launches"].get(k, 0) + v \
                        - before.get(k, 0)
            return n

        engine.verify_slots = watched_verify
        sched.draft.draft_burst = watched_draft
        sched.draft.catch_up = watched_catch_up
    reqs = {}

    def submit(rid, temp, prompt):
        reqs[rid] = sched.submit(Request(
            prompt=prompt, id=rid, sampling=SamplingParams(
                temperature=temp, max_new_tokens=SPEC_NEW_TOKENS,
                seed=TIERS_SEED)))

    sync(dev)
    t0 = time.perf_counter()
    for s in specs[:SPEC_EARLY]:
        submit(*s)
    late = list(specs[SPEC_EARLY:])
    while sched.has_work or late:
        if late and sched.n_steps >= SPEC_LATE_STEP:
            for s in late:
                submit(*s)
            late = []
        if sched.n_steps >= SPEC_MAX_STEPS:
            require(False, f"spec: not drained in {SPEC_MAX_STEPS} steps")
            break
        sched.step()
    sync(dev)
    obs["wall_s"] = time.perf_counter() - t0
    if spec is not None:
        del engine.verify_slots            # the engine's own method again
    return sched, reqs, obs


def spec_phase(cfg, params, chunk, dev):
    """granite-8b FULL with speculative decoding: runs A-D and checks 1-5
    of the speculative path.  Launch counts are set to 0 just before run B
    and read just after."""
    t_phase = time.perf_counter()
    specs = spec_requests(cfg)
    base = ServeConfig(max_len=512, n_slots=8, prefill_chunk=chunk,
                       max_burst=8, policy=PrecisionPolicy(kv="bf16"),
                       device=str(dev))
    slab = ServingEngine(cfg, params, base)
    paged = ServingEngine(cfg, params, dataclasses.replace(
        base, paged=True, page_size=SPEC_PAGE))
    spec = SpecConfig(draft_kv="int8", k_init=2, k_max=4)
    runs = {"A": serve_spec(slab, specs, None, dev)}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runs["B"] = serve_spec(slab, specs, spec, dev)
    launches = ops.launch_counts()
    formats = ops.format_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # run C carries a tracer and a registry: the draft / verify lanes and
    # the paged gauges on the card
    bundle = Observability(tracer=Tracer(), registry=MetricsRegistry())
    runs["C"] = serve_spec(paged, specs, spec, dev, bundle)
    runs["D"] = serve_spec(slab, specs, dataclasses.replace(
        spec, corrupt_drafts=True), dev)
    log(json.dumps({"serve_launches": launches, "by_format": formats,
                    "catchup_launches": runs["B"][2]["catchup_launches"],
                    "path": "granite-8b-spec"}))
    card = nvidia_smi()
    out = {"card": card, "peak_memory_bytes_B": peak}
    want = {rid: r.output_tokens for rid, r in runs["A"][1].items()}
    for name, (sched, reqs, obs) in runs.items():
        m = sched.metrics
        rep = m.report()
        tokens = m.total_new_tokens
        res = {"host_wall_s": obs["wall_s"], "steps": sched.n_steps,
               "total_new_tokens": tokens,
               "host_wall_per_token_s": obs["wall_s"] / max(tokens, 1),
               "host_syncs_per_token": sched.n_host_syncs / max(tokens, 1),
               "dispatches_per_token": rep.get("dispatches_per_token"),
               "burst_hist": rep.get("burst_hist"), "spec": rep.get("spec")}
        tag = f"spec ({name})"
        for rid, r in sorted(reqs.items()):
            require(r.is_finished and r.finish_reason == "length"
                    and r.n_generated == SPEC_NEW_TOKENS,
                    f"{tag}: request {rid} finished by {r.finish_reason} "
                    f"with {r.n_generated} tokens")
            require(all(0 <= t < cfg.vocab for t in r.output_tokens),
                    f"{tag}: request {rid} emitted an id outside the "
                    "vocabulary")
        if name != "A":
            # 1. every request is run A's, bit for bit
            for rid, r in sorted(reqs.items()):
                require(r.output_tokens == want[rid],
                        f"{tag}: request {rid} (t={r.sampling.temperature})"
                        " differs from its spec-off run")
            res["planner"] = sched.spec_planner.snapshot()
            # 4. the accounting identities, one verify a tier a round
            require(m.spec_rounds > 0, f"{tag}: no spec round")
            require(m.spec_tokens_drafted == m.spec_tokens_accepted
                    + m.spec_tokens_rejected
                    and m.spec_tokens_emitted == m.spec_tokens_accepted
                    + m.spec_bonus_tokens
                    and tokens == len(m.ttft) + m.decode_tokens_emitted
                    + m.spec_tokens_emitted
                    and 0 < m.spec_bonus_tokens
                    <= m.spec_rounds * base.n_slots,
                    f"{tag}: accounting {rep.get('spec')}")
            rounds = sorted(set(obs["verify"]))
            require(len(obs["verify"]) == len(rounds) == m.spec_rounds
                    == len(obs["draft"]) == m.spec_verify_dispatches,
                    f"{tag}: {len(obs['verify'])} verify dispatches in "
                    f"{len(rounds)} (step, tier) rounds, {m.spec_rounds} "
                    "spec rounds")
        if name in ("B", "C"):
            # 2. drafts accepted
            require(m.spec_tokens_accepted > 0, f"{tag}: nothing accepted")
            require(m.spec_catchup_dispatches > 0, f"{tag}: no catch-up")
        if name == "C":
            pool = sched.pool
            try:
                pool.allocator.check()
            except AssertionError as e:
                require(False, f"{tag}: allocator invariant: {e}")
            require(pool.pages_in_use == 0
                    and pool.pages_free + pool.pages_cached
                    == pool.n_pages - 1,
                    f"{tag}: pages leak: {rep.get('pages')}")
            res["pages"] = rep.get("pages")
            res["obs"] = spec_trace_checks(tag, sched, bundle)
        if name == "D":
            # 3. nothing accepted, a collapse, plain bursts after it
            snap = sched.spec_planner.snapshot()
            require(m.spec_tokens_accepted == 0,
                    f"{tag}: {m.spec_tokens_accepted} corrupt drafts "
                    "accepted")
            require(snap["collapses"] >= 1 and snap["plain_fallbacks"] >= 1,
                    f"{tag}: planner {snap}")
            log(json.dumps({"spec_planner_D": snap,
                            "path": "granite-8b-spec"}))
        out[name] = res
        spec_rep = rep.get("spec") or {}
        log(json.dumps({
            "path": "granite-8b-spec", "run": name,
            "acceptance_rate": spec_rep.get("acceptance_rate"),
            "tokens_per_verify_dispatch":
                spec_rep.get("emitted_per_verify_dispatch"),
            "dispatches_per_token": res["dispatches_per_token"],
            "host_syncs_per_token": res["host_syncs_per_token"],
            "host_wall_per_token_s": res["host_wall_per_token_s"],
            "host_wall_s": obs["wall_s"], "steps": sched.n_steps,
            "card": card}))
    # 5. K1 / K3 on the bf16 target, K4 on the int8 draft, K2 on prefill
    # and on the draft's catch-up chunks
    check_path_launches("granite-8b-spec", launches, formats)
    require(sum(v for k, v in runs["B"][2]["catchup_launches"].items()
                if k.startswith("packed_matmul:")) > 0,
            "spec (B): K2 did not run the draft's catch-up chunks")
    out["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"path": "granite-8b-spec", "phase_s": out["seconds"],
                    "card": card}))
    return out, launches, formats


def spec_trace_checks(tag, sched, bundle) -> dict:
    """A traced spec run: one spec_draft and one spec_verify event a
    round on the tier's draft / verify lanes, the registry's spec and
    sync counters equal to the scheduler's, the paged gauges present."""
    events = json.loads(bundle.tracer.to_json())
    m, reg = sched.metrics, bundle.registry
    names = [e["name"] for e in events]
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
    require(names.count("spec_draft") == names.count("spec_verify")
            == m.spec_rounds > 0,
            f"{tag}: {names.count('spec_draft')} draft / "
            f"{names.count('spec_verify')} verify events, "
            f"{m.spec_rounds} spec rounds")
    require({"draft:bf16", "verify:bf16"} <= lanes,
            f"{tag}: trace lanes {sorted(lanes)}")
    require(reg.get("serve_spec_rounds_total").value(tier="bf16")
            == m.spec_rounds
            and reg.get("serve_host_syncs_total").value()
            == sched.n_host_syncs
            and reg.get("serve_pages") is not None,
            f"{tag}: registry disagrees with the scheduler")
    return {"trace_events": len(events),
            "spec_verify_events": names.count("spec_verify")}


# ---------------------------------------------------------------------------
# Phase 5f: the serve run again with observability attached
# ---------------------------------------------------------------------------
def obs_trace_checks(sched, reqs, obs, prompts, chunk) -> dict:
    """The trace parses; every request has its three spans; one
    decode_burst event a decode dispatch and one prefill_chunk event a
    chunk; the registry's counters equal the scheduler's tallies."""
    events = json.loads(obs.tracer.to_json())
    spans = {(e["tid"], e["name"]) for e in events
             if e["ph"] == "X" and e["pid"] == PID_REQUESTS}
    for r in reqs:
        require(all((r.id, p) in spans
                    for p in ("WAITING", "PREFILL", "DECODE")),
                f"obs: request {r.id} lacks a span")
    names = [e["name"] for e in events]
    n_chunks = sum(-(-len(p) // chunk) for p in prompts)
    require(names.count("decode_burst") == sched.n_decode_dispatches,
            f"obs: {names.count('decode_burst')} decode_burst events, "
            f"{sched.n_decode_dispatches} decode dispatches")
    require(names.count("prefill_chunk") == n_chunks,
            f"obs: {names.count('prefill_chunk')} prefill_chunk events, "
            f"{n_chunks} chunks")
    reg = obs.registry
    tallies = {
        "serve_host_syncs_total": (reg.get("serve_host_syncs_total").value(),
                                   sched.n_host_syncs),
        "serve_scheduler_steps_total": (
            reg.get("serve_scheduler_steps_total").value(), sched.n_steps),
        "serve_decode_dispatches_total": (
            reg.get("serve_decode_dispatches_total").value(tier="bf16"),
            sched.n_decode_dispatches),
        "serve_decode_token_steps_total": (
            reg.get("serve_decode_token_steps_total").value(tier="bf16"),
            sched.n_decode_steps),
        "serve_prefill_chunks_total": (
            reg.get("serve_prefill_chunks_total").value(tier="bf16"),
            n_chunks),
        "serve_admissions_total": (
            reg.get("serve_admissions_total").value(tier="bf16"), len(reqs)),
        "serve_new_tokens_total": (
            reg.get("serve_new_tokens_total").value(tier="bf16"),
            sum(r.n_generated for r in reqs)),
    }
    for name, (got, want) in tallies.items():
        require(got == want, f"obs: registry {name} {got}, scheduler {want}")
    require(obs.snapshots.n_written > 0, "obs: no snapshot written")
    return {"trace_events": len(events), "snapshots": obs.snapshots.n_written,
            "registry": {k: v[0] for k, v in tallies.items()}}


def step_cost_phase(cfg, params, chunk, dev) -> list:
    """``step_cost`` of the serve pool's decode step at K = 1 and 8 beside
    its device-busy ms from one profiler pass (``profile_step.measure``):
    every slot holds one prefill chunk; a burst's lengths are put back
    after each call, so each call decodes from the same context."""
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=512, n_slots=8, prefill_chunk=chunk, max_burst=8,
        policy=PrecisionPolicy(kv="bf16"), device=str(dev)))
    pool = engine.new_pool()
    prompt = np.random.default_rng(0).integers(
        1, cfg.vocab, (chunk,)).astype(np.int32)
    for _ in range(pool.n_slots):
        engine.prefill_chunk_into_slot(pool, pool.alloc(), prompt, 0)
    n = pool.n_slots
    tokens = np.ones((n,), np.int32)
    ctx = pool.lengths.copy()
    out = []
    for k, calls in STEP_COST_CALLS.items():
        t0 = time.perf_counter()
        keys = np.zeros((k, n, 2), np.uint32)
        temps = np.zeros((n,), np.float32)
        live = np.ones((n,), bool)
        rem = np.full((n,), k, np.int32)
        eos = np.full((n,), -1, np.int32)

        def step():
            if k == 1:
                engine.decode_slots(pool, tokens, keys[0], temps)
            else:
                engine.decode_burst(pool, tokens, keys, temps, live, rem,
                                    eos)
                pool.lengths[:] = ctx

        step()
        res = measure(step, calls, dev, top=4)
        # the positions read a row: the chunk, and half the burst's own
        cost = step_cost(engine, pool, k=k,
                         context=int(ctx.mean()) + (k - 1) // 2)
        busy = res["device_busy_ms"]
        out.append(dict(cost, wall_ms=res["wall_ms"], device_busy_ms=busy,
                        idle_share=res["idle_share"],
                        bytes_per_s=(cost["hbm_bytes"] / (busy / 1e3)
                                     if busy else None),
                        flops_per_s=(cost["flops"] / (busy / 1e3)
                                     if busy else None),
                        byte_bound_ms=cost["hbm_bytes"] / HBM_BYTES_PER_S
                        * 1e3, calls=calls, kernels=res["kernels"],
                        seconds=time.perf_counter() - t0))
        require(busy is not None and busy > 0,
                f"step_cost: no device time for the K = {k} step")
    return out


def obs_phase(cfg, params, chunk, dev):
    """granite-8b FULL serves phase 5's bf16 requests again with the full
    bundle (tracer, registry with JSONL snapshots, profiler) attached, held
    to the obs-off run of phase 5: the same tokens, host syncs, decode
    dispatches, steps, bursts and K1-K4 launches; then the trace and the
    registry are read (``obs_trace_checks``) and ``step_cost`` is priced
    beside the decode step's device time.  Launch counts are set to 0 just
    before the observed run and read just after."""
    t_phase = time.perf_counter()
    prompts, new_tokens = serve_requests(cfg)
    base, base_wall = SERVE_TALLIES[(cfg.name, "bf16")]
    with tempfile.TemporaryDirectory() as tmp:
        reg = MetricsRegistry()
        obs = Observability(
            tracer=Tracer(), registry=reg, profiler=StepProfiler(cfg),
            snapshots=SnapshotWriter(reg, os.path.join(tmp, "metrics.jsonl")))
        ops.reset_launch_counts()
        _, reqs, rep, sched = serve_tier(cfg, params, "bf16", prompts,
                                         new_tokens, chunk, dev, obs=obs)
        launches = ops.launch_counts()
        formats = ops.format_launch_counts()
        got = serve_tally(sched, reqs, launches)
        for key, want in base.items():
            require(got[key] == want,
                    f"obs: {key} with obs on differs from obs off: "
                    f"{got[key] if key != 'tokens' else '...'} vs "
                    f"{want if key != 'tokens' else '...'}")
        checks = obs_trace_checks(sched, reqs, obs, prompts, chunk)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        obs.tracer.write(os.path.join(ROOT, "chiprun_out",
                                      "granite-8b-obs.trace.json"))
    report = obs.profiler.report()
    card = nvidia_smi()
    log(json.dumps({"path": "granite-8b-obs",
                    "per_tier": report["per_tier"],
                    "note": "model_s: the paper's V80 cost model; "
                            "measured_s: host wall on the card",
                    "host_wall_s": rep["host_wall_s"],
                    "obs_off_host_wall_s": base_wall,
                    **checks, "card": card}))
    serve_s = time.perf_counter() - t_phase
    costs = step_cost_phase(cfg, params, chunk, dev)
    for c in costs:
        log(json.dumps({"path": "granite-8b-obs", "step_cost": {
            k: v for k, v in c.items() if k != "kernels"}, "card": card}))
    check_path_launches("granite-8b-obs", launches, formats)
    out = {"card": card, "serve": rep, "model_measured": report,
           "trace": checks, "step_cost": costs, "serve_s": serve_s,
           "seconds": time.perf_counter() - t_phase}
    log(json.dumps({"path": "granite-8b-obs", "phase_s": out["seconds"],
                    "serve_s": serve_s, "card": card}))
    return out, launches, formats


# ---------------------------------------------------------------------------
# Phase 8: the recurrent families through the static-batch loop
# ---------------------------------------------------------------------------
def static_leaf_calls(cfg, prefill: bool) -> int:
    """Quantized linear leaf calls of one forward (a prefill, or a decode
    step) of a static-batch model, from the config: xLSTM's mLSTM blocks
    call 5 (w_up, w_q, w_k, w_v, w_out; w_if is bf16) and its sLSTM blocks
    2 (w_gates, w_out); Zamba2's Mamba-2 blocks call 3 (w_zx, w_bc, w_out;
    w_dt is bf16) and each of its shared block's applications 7 (q, k, v, o
    and the gated FFN); the VLM's layers 7 each (its tied head is a plain
    matmul); the audio model's decoder layers 10 each (self-attention q, k,
    v, o, cross-attention q, k, v, o over the encoder output, the FFN's in
    and out), and in a prefill its encoder layers 6 each too."""
    if cfg.family == "audio":
        le = cfg.encoder_layers
        return (cfg.n_layers - le) * 10 + (le * 6 if prefill else 0)
    if cfg.family == "ssm":
        g = cfg.n_layers // cfg.slstm_every
        return g * (cfg.slstm_every - 1) * 5 + g * 2
    if cfg.family == "vlm":
        return cfg.n_layers * 7
    return cfg.n_layers * 3 + (cfg.n_layers // cfg.attn_every) * 7


def attention_calls(cfg) -> int:
    """Decode-attention launches of one decode step: one a shared-block
    application (Zamba2), one a layer (the VLM), one a decoder layer (the
    audio model: its cross-attention is plain), none (xLSTM)."""
    return {"ssm": 0, "hybrid": cfg.n_layers // cfg.attn_every,
            "vlm": cfg.n_layers,
            "audio": cfg.n_layers - cfg.encoder_layers}[cfg.family]


def frontend_of(batch: dict) -> dict:
    """The frontend inputs of a batch (``patches`` / ``frames``) as
    ``T.forward`` keywords."""
    keys = {key for key, _ in FRONTEND_INPUTS.values()}
    return {k: v for k, v in batch.items() if k in keys}


def static_batch(cfg, rows: int, s: int, seed: int, dev) -> dict:
    """A static batch: [rows, s] prompt tokens from ``default_rng(seed)``,
    and the VLM's [rows, Np, D] bf16 patches or the audio model's [rows,
    n_frames, D] bf16 frames drawn on the card from ``FRONTEND_SEEDS[0]``
    (``launch/serve.draw_frontend``)."""
    return {"tokens": np.random.default_rng(seed).integers(
        1, cfg.vocab, (rows, s)).astype(np.int32),
        **draw_frontend(cfg, rows, FRONTEND_SEEDS[0], dev)}


def static_calls(path, cfg, params, dev, tiers) -> dict:
    """One prefill call ([4, 64], from an empty cache; the VLM's 256 patch
    rows first; the audio model's encoder over its 1500 frames first) and
    one decode step at each KV tier, the launch counts reset just before
    and read just after each: exactly ``static_leaf_calls`` launches of K2
    (prefill) or K1 (decode step) for Zamba2 and the VLM, of K5 for xLSTM
    and the audio model, and ``attention_calls`` K3 / K4 launches in a
    decode step (the prefill attends over its own k / v).  Then the
    prefill's wall, and at the first tier a decode step's wall and
    device-busy ms (``profile_step.measure``)."""
    rows, s = STATIC_ROWS, STATIC_GEN[0]
    n_pre, n_dec = static_leaf_calls(cfg, True), static_leaf_calls(cfg, False)
    apps = attention_calls(cfg)
    batch = static_batch(cfg, rows, s, 3, dev)
    prompts = torch.as_tensor(batch["tokens"], device=dev).long()
    frontend = frontend_of(batch)
    index = s + (cfg.n_patches if "patches" in frontend else 0)
    out = {"leaf_calls_a_prefill": n_pre, "leaf_calls_a_decode_step": n_dec}
    for tier in tiers:
        cache = T.init_cache(cfg, rows, index + 2, kv_dtype=tier,
                             device=dev)
        attn = "decode_attention_bf16" if tier == "bf16" \
            else "decode_attention_quant"
        with torch.no_grad():
            sync(dev)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits = T.forward(cfg, params, prompts, cache=cache,
                               cache_index=0, mode="prefill", **frontend)
            sync(dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            pre = ops.launch_counts()
            tok = logits[:, -1].argmax(-1)[:, None]
            ops.reset_launch_counts()
            T.forward(cfg, params, tok, cache=cache, cache_index=index,
                      mode="decode")
            sync(dev)
            dec = ops.launch_counts()
            # one profiler pass a path (each costs 15-20 s, PERF.md); the
            # audio model's encoder prefill gets a second
            step = None if tier != tiers[0] else measure(lambda: T.forward(
                cfg, params, tok, cache=cache, cache_index=index + 1,
                mode="decode"), 4, dev, top=8)
            prefill = cross = None
            if tier == tiers[0] and cfg.family == "audio":
                prefill = measure(lambda: T.forward(
                    cfg, params, prompts, cache=cache, cache_index=0,
                    mode="prefill", **frontend), 2, dev, top=8)
                # the decode step's cross-attention K / V, recomputed over
                # the encoder output at every step (as the reference does)
                cross = measure(lambda: [
                    apply_linear(blk.xattn[w], cache["enc"])
                    for blk in params.dec_layers for w in ("wk", "wv")],
                    2, dev, top=4)
        if cfg.family == "ssm":
            want_pre = {"w8a8_matmul": n_pre}
            want_dec = {"w8a8_matmul": n_dec}
        elif cfg.family == "audio":
            want_pre = {"w8a8_matmul": n_pre}
            want_dec = {"w8a8_matmul": n_dec, attn: apps}
        else:
            want_pre = {"packed_matmul": n_pre}
            want_dec = {"packed_gemv": n_dec, attn: apps}
        for what, got, want in (("prefill", pre, want_pre),
                                ("decode step", dec, want_dec)):
            for name in KERNELS:
                require(got[name] == want.get(name, 0),
                        f"{path} ({tier}): {got[name]} {name} launches in "
                        f"a {what}, not {want.get(name, 0)}")
        out[tier] = rec = {"prefill_rows": rows, "prefill_tokens": s,
                           "prefill_positions": index,
                           "prefill_wall_ms": prefill_ms,
                           "prefill_launches": pre, "decode_launches": dec,
                           "decode_step": step, "prefill": prefill,
                           "cross_kv_of_a_step": cross}
        log(json.dumps({"static_calls": path, "kv": tier,
                        "device": nvidia_smi(), **rec}))
        del cache
    return out


def first_group_spread(cfg, got: list, want: list) -> dict:
    """The residual streams (``layer_out`` lists of a teacher-forced run,
    every call) of ``got`` against ``want`` over zamba2's first group (its
    ``attn_every`` Mamba layers and the shared block): max |diff| / max
    |x| after the first layer (``LS.layer_spread``), and the RMS of the
    diff over the RMS of the streams across the group."""
    n, group = LS.outputs_per_call(cfg), cfg.attn_every + 1
    num, den = [], []
    for l in range(group):
        num.append(sum(float((x.float() - y.float()).pow(2).sum())
                       for x, y in zip(got[l::n], want[l::n])))
        den.append(sum(float(y.float().pow(2).sum()) for y in want[l::n]))
    return {"layer0_rel_max": LS.layer_spread(got, want, n)[
                "layer_rel_diff"][0],
            "group_rel_rms": (sum(num) / sum(den)) ** 0.5,
            "layer_rel_rms": [(a / b) ** 0.5 for a, b in zip(num, den)]}


def static_serve(path, cfg, params, dev, tiers, witness):
    """``ServingEngine.generate`` (the static-batch loop) on [4, 64] prompts
    (the VLM's with 256 drawn patch rows before them; the audio model's
    with 1500 drawn frames), 16 new tokens: greedy at each KV tier, and
    twice at temperature 0.8 with one seed at the first (the VLM: also
    once at every other tier); the launch counts
    set to 0 just before and read just after.  Checks: every run's ids in
    the vocabulary and 16 a row; the temperature run repeats; the launches
    are exactly the config's (one prefill and 15 decode steps a run); the
    greedy ids are the kernel path's own teacher-forced greedy ids, bit
    for bit, and the temperature ids the loop's sampler (``sample_static``
    on the key chain) on the kernel path's logits teacher-forced on them;
    at the first tier, on the greedy ids, the plain path's logits are held
    to the
    kernel path's as in the model phase (``logit_check``, else
    ``witness_check``), and the ids equal the plain path's argmax wherever
    its top-2 gap exceeds 0.1 (some such token required).  Where the
    witness decides (zamba2-7b: a reordered sum moves its logits by up to
    a quarter of their scale, PERF.md), the ids may miss that argmax at
    most ``WITNESS_FACTOR`` times as often as the witness's own argmax
    does, and the residual early in the model spreads at most
    ``WITNESS_FACTOR`` times as far as the witness's
    (``first_group_spread``)."""
    rows, (s, new, seed) = STATIC_ROWS, STATIC_GEN
    batch = static_batch(cfg, rows, s, seed, dev)
    frontend = frontend_of(batch)
    torch.cuda.reset_peak_memory_stats()
    sync(dev)
    ops.reset_launch_counts()
    runs = {}
    for i, tier in enumerate(tiers):
        def engine(temperature):
            return ServingEngine(cfg, params, ServeConfig(
                max_len=s + new, temperature=temperature,
                policy=PrecisionPolicy(kv=tier), device=str(dev)))
        t0 = time.perf_counter()
        greedy = engine(0.0).generate(batch, max_new_tokens=new, seed=0)
        sync(dev)
        runs[tier] = [greedy, time.perf_counter() - t0]
        if i == 0 or cfg.family == "vlm":
            hot = engine(0.8)
            runs[tier] += [hot.generate(batch, max_new_tokens=new,
                                        seed=seed)
                           for _ in range(2 if i == 0 else 1)]
    sync(dev)
    launches = ops.launch_counts()
    formats = ops.format_launch_counts()
    grouped = ops.grouped_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"serve_launches": launches, "by_format": formats,
                    "grouped_by_rows": grouped, "arch": cfg.name}))
    check_path_launches(path, launches, formats, grouped)
    n_pre, n_dec = static_leaf_calls(cfg, True), static_leaf_calls(cfg, False)
    apps = attention_calls(cfg)
    gens = {tier: len(run) - 1 for tier, run in runs.items()}
    if cfg.family in ("ssm", "audio"):
        want = {"w8a8_matmul": sum(gens.values()) * (n_pre
                                                     + (new - 1) * n_dec)}
    else:
        want = {"packed_matmul": sum(gens.values()) * n_pre,
                "packed_gemv": sum(gens.values()) * (new - 1) * n_dec}
    for tier in tiers:
        name = "decode_attention_bf16" if tier == "bf16" \
            else "decode_attention_quant"
        want[name] = want.get(name, 0) + gens[tier] * (new - 1) * apps
    for name in KERNELS:
        require(launches[name] == want.get(name, 0),
                f"{path}: {launches[name]} {name} launches over the "
                f"generate runs, not {want.get(name, 0)}")
    reports = []
    pt = torch.as_tensor(batch["tokens"], device=dev).long()
    for tier, (greedy, wall, *hot) in runs.items():
        for tag, run in (("greedy", greedy),) + tuple(
                (f"temperature {i}", r) for i, r in enumerate(hot)):
            gen_ids = run["generated"]
            require(gen_ids.shape == (rows, new)
                    and (run["lengths"] == new).all(),
                    f"{path} ({tier}, {tag}): generated {gen_ids.shape}")
            require(bool(((gen_ids >= 0) & (gen_ids < cfg.vocab)).all()),
                    f"{path} ({tier}, {tag}): an id outside the vocabulary")
        if len(hot) > 1:
            require(np.array_equal(hot[0]["generated"], hot[1]["generated"]),
                    f"{path} ({tier}): a repeated temperature run gave "
                    "other ids")
        if hot:
            require(np.array_equal(resampled(cfg, params, pt, frontend, tier,
                                             hot[0]["generated"], seed),
                                   hot[0]["generated"]),
                    f"{path} ({tier}): generate's temperature ids are not "
                    "the loop's sampler on the kernel path's teacher-forced "
                    "logits")
        ids = greedy["generated"]
        first = tier == tiers[0]
        kern_l = [] if first and witness is not None else None
        kern, kids = LS.teacher_forced(cfg, params, pt, new - 1, kv=tier,
                                       plain=False, layer_out=kern_l,
                                       frontend=frontend)
        require(np.array_equal(torch.stack(kids, 1).cpu().numpy(), ids),
                f"{path} ({tier}): generate's greedy ids are not the "
                "kernel path's teacher-forced ids")
        rep = {"arch": cfg.name, "kv": tier, "rows": rows,
               "prompt_tokens": s, "new_tokens": new, "greedy_wall_s": wall,
               "tokens_per_s": rows * new / wall,
               "ids_are_teacher_forced": True, "peak_memory_bytes": peak,
               "first_ids": ids[0, :8].tolist()}
        reports.append(rep)
        if not first:                # the plain path: (a) holds this tier
            log(json.dumps({"serve": rep}))
            continue
        plain_l = [] if witness is not None else None
        plain, _ = LS.teacher_forced(cfg, params, pt, new - 1, kv=tier,
                                     plain=True, feed=kids,
                                     layer_out=plain_l, frontend=frontend)
        res = LS.logit_check(kern, plain)
        ok = res["logits_ok"]
        top2 = plain.topk(2, dim=-1).values
        decided = ((top2[..., 0] - top2[..., 1]) > 0.1).cpu().numpy()
        want_ids = plain.argmax(-1).cpu().numpy()          # [new, rows]
        misses = int((want_ids != ids.T)[decided].sum())
        allowed = 0
        if not ok and witness is not None:
            variant, replace = LS.RUNS[witness]
            wit_l = []
            with LS.plain_ops(replace):
                wit, _ = LS.teacher_forced(cfg, params, pt, new - 1, kv=tier,
                                           plain=variant, feed=kids,
                                           layer_out=wit_l,
                                           frontend=frontend)
            res["witness"] = {"variant": witness, **LS.logit_check(wit,
                                                                   plain)}
            ok = res["witness_rule_ok"] = LS.witness_check(res,
                                                           res["witness"])
            # the witness's own argmax misses at the same tokens bound the
            # kernel path's; and the residual early, before depth makes
            # the spread chaotic: after the first Mamba layer (all three
            # of its leaves, K2 at the prefill, K1 at the steps) by its max,
            # and over the first group and its shared block by its RMS
            wit_misses = int((wit.argmax(-1).cpu().numpy()
                              != want_ids)[decided].sum())
            allowed = LS.WITNESS_FACTOR * wit_misses
            spread = {name: first_group_spread(cfg, got, plain_l)
                      for name, got in (("kernels", kern_l), (witness, wit_l))}
            rep.update({"first_group_spread": spread,
                        "witness_misses_gap_0.1": wit_misses})
            for key in ("layer0_rel_max", "group_rel_rms"):
                got, limit = spread["kernels"][key], spread[witness][key]
                require(got <= LS.WITNESS_FACTOR * limit,
                        f"{path} ({tier}): the residual's {key} is {got}, "
                        f"past {LS.WITNESS_FACTOR} x the witness's {limit}")
        rep.update({"logits": res, "tokens": int(decided.size),
                    "tokens_gap_0.1": int(decided.sum()),
                    "misses_gap_0.1": misses, "misses_allowed": allowed,
                    "agree_all": int((want_ids == ids.T).sum())})
        log(json.dumps({"serve": rep}))
        require(res["finite"] and ok,
                f"{path} ({tier}): served logits kernel vs plain: max diff "
                f"{res['max_abs_logit_diff']}")
        require(decided.any(), f"{path} ({tier}): no token's plain top-2 "
                "gap exceeds 0.1: the greedy ids go unchecked")
        require(misses <= allowed,
                f"{path} ({tier}): {misses} greedy ids differ from the plain "
                f"path's argmax where its top-2 gap exceeds 0.1, past "
                f"{allowed}")
    return reports, launches, formats


def resampled(cfg, params, prompts, frontend, tier, ids, seed):
    """The static-batch loop's sampler (``sample_static`` at 0.8 on the key
    chain ``PRNGKey(seed)`` / ``split``) on the kernel path's logits,
    teacher-forced on ``ids`` [rows, T]: [rows, T] ids."""
    feed = [torch.as_tensor(ids[:, t], device=prompts.device).long()
            for t in range(ids.shape[1])]
    logits, _ = LS.teacher_forced(cfg, params, prompts, ids.shape[1] - 1,
                                  kv=tier, plain=False, feed=feed,
                                  frontend=frontend)
    key, out = threefry.prng_key(seed), []
    for t in range(ids.shape[1]):
        if t:
            key, sub = threefry.split(key)
        out.append(sample_static(logits[t], sub if t else key,
                                 0.8).cpu().numpy())
    return np.stack(out, axis=1)


def frontend_checks(path, cfg, params, dev) -> dict:
    """The frontend input (the VLM's patch prefix, the audio model's
    frames) and ``score`` on the served batch ([4, 64] tokens, 256 patch
    rows or 1500 frames): (1) with the same tokens and another draw of the
    frontend (``FRONTEND_SEEDS[1]``) the first token's logits (the kernel
    path's prefill) move past ``logit_check``'s bound, which a dropped or
    ignored prefix, encoder or cross-attention would not; (2)
    ``ServingEngine.score`` with the next token as
    each position's label (row 0's first 8 and every row's last position
    masked): the kernel path's train-mode token logits within
    ``logit_check``'s bound of the plain path's, and every NLL finite and
    the one recomputed from those logits (``engine.mean_nll``)."""
    rows, (s, _, seed) = STATIC_ROWS, STATIC_GEN
    batch = static_batch(cfg, rows, s, seed, dev)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    first = []
    for fseed in FRONTEND_SEEDS:
        cache = T.init_cache(cfg, rows, cfg.n_patches + s, device=dev)
        with torch.no_grad():
            first.append(T.forward(
                cfg, params, tokens, cache=cache, cache_index=0,
                mode="prefill",
                **draw_frontend(cfg, rows, fseed, dev))[:, -1])
        del cache
    moved = LS.logit_check(first[1], first[0])
    key = FRONTEND_INPUTS[cfg.family][0]
    log(json.dumps({"frontend_check": path, "input": key, **moved}))
    require(moved["finite"] and not moved["logits_ok"],
            f"{path}: other {key} moved the first token's logits by "
            f"{moved['max_abs_logit_diff']}, within {moved['tolerance']}")
    labels = np.concatenate([batch["tokens"][:, 1:],
                             np.full((rows, 1), -1, np.int32)], axis=1)
    labels[0, :8] = -1
    engine = ServingEngine(cfg, params, ServeConfig(max_len=s,
                                                    device=str(dev)))
    t0 = time.perf_counter()
    nll = engine.score(dict(batch, labels=labels))
    sync(dev)
    score_s = time.perf_counter() - t0
    kern = engine.train_logits(batch)
    with torch.no_grad():
        plain = T.forward(cfg, params, tokens, cache=None, cache_index=0,
                          mode="train", plain=True,
                          **frontend_of(batch))[:, cfg.n_patches:]
    res = LS.logit_check(kern, plain)
    again = mean_nll(kern, labels)
    out = {"frontend_check": moved, "score": {
        "nll": nll.tolist(), "nll_from_logits": again.tolist(),
        "nll_plain": mean_nll(plain, labels).tolist(), "wall_s": score_s,
        "logits": res}}
    log(json.dumps({"score": path, **out["score"]}))
    require(res["finite"] and res["logits_ok"],
            f"{path}: train-mode logits kernel vs plain: max diff "
            f"{res['max_abs_logit_diff']}, past {res['tolerance']}")
    require(bool(np.isfinite(nll).all()) and nll.shape == (rows,),
            f"{path}: score gave {nll}")
    require(np.allclose(nll, again, rtol=1e-6, atol=0.0),
            f"{path}: score {nll.tolist()} is not the NLL of its logits "
            f"{again.tolist()}")
    return out


def static_phase(path, cfg, params, dev, tiers, witness, prefills):
    """(a) the model teacher-forced through the kernels and the plain
    versions (``model_phase``: 4 rows, each prefill of ``prefills`` with
    its decode steps, at each tier; a prefill alone at the first tier
    only); (c) one prefill and one decode step with exact launch counts,
    and their walls; (b) serving through ``generate``, the path's launch
    counts (``static_serve``); for the VLM and the audio model, the
    frontend and score checks (``frontend_checks``)."""
    frontend = draw_frontend(cfg, STATIC_ROWS, FRONTEND_SEEDS[0], dev)
    out = {}
    for s, steps in prefills:
        # a prefill alone attends over its own k / v, not the KV tier
        out[f"model_prefill_{s}"] = model_phase(
            path, cfg, params, dev, s, tiers=tiers if steps else tiers[:1],
            rows=STATIC_ROWS, steps=steps, witness=witness,
            frontend=frontend)
    out["calls"] = static_calls(path, cfg, params, dev, tiers)
    out["serve"], launches, formats = static_serve(path, cfg, params, dev,
                                                   tiers, witness)
    if cfg.family in FRONTEND_INPUTS:
        out.update(frontend_checks(path, cfg, params, dev))
    return out, launches, formats


def check_path_launches(path: str, launches, formats=None,
                        grouped=None) -> None:
    """Every kernel of ``path`` launched in its run, and no other; on
    every weight / KV format ``PATH_FORMATS`` names for it; and at every
    group height ``PATH_GROUPED_ROWS`` names for it."""
    for name in KERNELS:
        if name in PATH_KERNELS[path]:
            require(launches[name] > 0, f"{path}: {name} was not launched")
        else:
            require(launches[name] == 0,
                    f"{path}: {name} ran on a path it is not on")
    for key in PATH_FORMATS.get(path, ()):
        require(formats.get(key, 0) > 0, f"{path}: no {key} launch")
    for key in PATH_GROUPED_ROWS.get(path, ()):
        require((grouped or {}).get(key, 0) > 0, f"{path}: no {key} launch")


# ---------------------------------------------------------------------------
def grouped_gemv_registers(ptxas_log: str) -> None:
    """ptxas' register and spill report of the grouped body's
    instantiations (``packed_matmul.cu`` built with ``-Xptxas=-v``): 3
    formats x 2 stage heights x 2 K-warp splits x each item height (8, 16,
    32 rows), no spills."""
    report = {fn: r for fn, r in build.ptxas_report(ptxas_log).items()
              if "grouped_gemv_kernel" in fn}
    log(json.dumps({"grouped_gemv_ptxas": report}))
    want = 12 * len({grouped_fragments(m) for m in (1, 16, 17)})
    require(len(report) == want, f"grouped body: {len(report)} "
                                 f"instantiations in ptxas' report, not "
                                 f"{want}")
    for fn, r in report.items():
        require(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0,
                f"grouped body {fn}: spills {r}")


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> None:
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log(smi)

    t0 = time.perf_counter()
    ptxas_logs = {}                 # grouped K1's register report, built
    # apart beside the libraries; the quantizer phase launches no kernel,
    # so it (its CPU reference: ~40 s of host time) runs while nvcc builds,
    # from a generator of its own
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        verbose = pool.submit(build.build, ["packed_matmul"],
                              extra=("-Xptxas=-v",), logs=ptxas_logs)
        quant = pool.submit(quantizer_phase,
                            torch.Generator(device=dev).manual_seed(1), dev)
        build.build()
        verbose.result()
        log(json.dumps({"build_s": time.perf_counter() - t0}))
        quantizer = quant.result()
    log(json.dumps({"build_and_quantizer_phase_s": time.perf_counter() - t0}))
    grouped_gemv_registers(ptxas_logs.get("packed_matmul", ""))

    chunk = 64
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(dev)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    result["cases"] = cases = kernel_phase(timer, gen, dev, chunk)
    log(json.dumps({"kernel_phase_s": time.perf_counter() - t0}))
    del timer
    torch.cuda.empty_cache()
    result["quantizer"] = quantizer

    # the MAC datapath: launch counts set to 0 just before, read just after
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    result["datapath"] = datapath_phase(gen, dev)
    launches_by_path = {"xtramac-datapath": ops.launch_counts()}
    result["datapath"].update(
        seconds=time.perf_counter() - t0,
        launches=launches_by_path["xtramac-datapath"],
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    log(json.dumps({"datapath_phase_s": result["datapath"]["seconds"],
                    "peak_memory_bytes":
                        result["datapath"]["peak_memory_bytes"],
                    "launches": launches_by_path["xtramac-datapath"]}))
    check_path_launches("xtramac-datapath",
                        launches_by_path["xtramac-datapath"])
    want = len(DATAPATH_COMBOS) + PIPELINE_ISSUES
    got = launches_by_path["xtramac-datapath"]["virtual_dsp_multiply"]
    require(got == want, f"datapath: {got} K6 launches, {want} xtramac_packed "
                         "calls and pipeline issues")
    extra_phases = {"granite-8b-tiers": tiers_phase,
                    "granite-8b-paged": paged_phase,
                    "granite-8b-slo": slo_phase,
                    "granite-8b-spec": spec_phase,
                    "granite-8b-obs": obs_phase}
    for path, arch, layers, weights, tiers, witness, serves, extras \
            in MODEL_RUNS:
        cfg = get_config(arch)
        if layers is not None:      # full width, cut depth
            cfg = dataclasses.replace(cfg, n_layers=layers)
        plan = PrecisionPolicy(weights=weights).validate_for(cfg) \
            .resolved_plan(cfg)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            params = T.build_params(cfg, QuantMaker(0, device=dev, plan=plan))
        torch.cuda.synchronize()
        log(json.dumps({"path": path, "layers": cfg.n_layers,
                        "build_params_s": time.perf_counter() - t0,
                        "param_bytes": sum(nbytes(b)
                                           for b in params.buffers()),
                        "peak_memory_bytes": torch.cuda.max_memory_allocated()}))
        t0 = time.perf_counter()
        if not serves:              # this path's run is its model phase
            ops.reset_launch_counts()
        model = model_phase(path, cfg, params, dev,
                            MODEL_CHUNKS.get(path, chunk), tiers=tiers,
                            witness=witness)
        result[path] = {"layers": cfg.n_layers, "policy_weights": weights,
                        "model": model}
        if serves:
            serve, launches, formats = serve_phase(cfg, params, chunk, dev,
                                                   tiers)
            result[path]["serve"] = serve
        else:
            launches = ops.launch_counts()
            formats = ops.format_launch_counts()
            grouped = ops.grouped_launch_counts()
            log(json.dumps({"model_launches": launches, "by_format": formats,
                            "grouped_by_rows": grouped, "path": path}))
            check_path_launches(path, launches, formats, grouped)
        launches_by_path[path] = launches
        result[path].update(launches=launches, launches_by_format=formats,
                            seconds=time.perf_counter() - t0)
        log(json.dumps({"path": path, "model_and_serve_s":
                        result[path]["seconds"]}))
        for extra in extras:
            t0 = time.perf_counter()
            ecfg, eparams = cut_depth(cfg, params, CUT_LAYERS) \
                if extra in CUT_EXTRAS else (cfg, params)
            result[extra], launches, formats = extra_phases[extra](
                ecfg, eparams, chunk, dev)
            launches_by_path[extra] = launches
            result[extra].update(layers=ecfg.n_layers, launches=launches,
                                 launches_by_format=formats,
                                 seconds=time.perf_counter() - t0)
            log(json.dumps({"path": extra, "layers": ecfg.n_layers,
                            "seconds": result[extra]["seconds"]}))
        del params                  # free the card for the next model
        torch.cuda.empty_cache()

    for path, tiers, witness, prefills in STATIC_RUNS:
        cfg = get_config(path)        # full width, full depth but a cut
        if path in STATIC_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=STATIC_LAYERS[path])
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            params = T.build_params(cfg, QuantMaker(0, device=dev))
        torch.cuda.synchronize()
        log(json.dumps({"path": path, "layers": cfg.n_layers,
                        "build_params_s": time.perf_counter() - t0,
                        "param_bytes": sum(nbytes(b)
                                           for b in params.buffers()),
                        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                        "device": smi}))
        t0 = time.perf_counter()
        result[path], launches, formats = static_phase(
            path, cfg, params, dev, tiers, witness, prefills)
        launches_by_path[path] = launches
        result[path].update(layers=cfg.n_layers, launches=launches,
                            launches_by_format=formats,
                            seconds=time.perf_counter() - t0)
        log(json.dumps({"path": path, "model_and_serve_s":
                        result[path]["seconds"]}))
        del params
        torch.cuda.empty_cache()

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)

    # one summary entry per kernel: the worst error over its cases, times
    # at its path's own shape (decode M = 8 slots, prefill M = 64, the
    # widest linear; int8 KV for the quantized attention; K6 on int4 x bf16
    # at the Table VII size); launches over every path's run
    rep_case = {"packed_gemv": dict(scheme="awq_int4", m=8, k=4096, n=14336),
                "packed_matmul": dict(scheme="awq_int4", m=chunk, k=4096,
                                      n=14336),
                "packed_gemv_grouped": dict(arch="qwen3-moe-30b-a3b",
                                            case="decode", k=2048, n=768),
                "packed_matmul_grouped": dict(arch="qwen3-moe-30b-a3b",
                                              case="prefill128", k=2048,
                                              n=768),
                "w8a8_matmul": dict(m=8, k=4096, n=16384, x_offset=0),
                "decode_attention_bf16": dict(kv="bf16", h=32, dh=128),
                "decode_attention_quant": dict(kv="int8", h=32, dh=128),
                "virtual_dsp_multiply": dict(pair="int4xbf16", cap=4,
                                             draw="random", dtype="int32",
                                             ragged=False)}
    summary = []
    for name, (source, replaces) in KERNELS.items():
        mine = [c for c in cases if c["name"] == name]
        rep = next(c for c in mine if "ms" in c and all(
            c.get(k) == v for k, v in rep_case[name].items()))
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[name] for n in launches_by_path.values()),
            "launches_by_path": {a: n[name]
                                 for a, n in launches_by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "case": {k: rep[k] for k in rep_case[name]}})
    log(json.dumps({"chip_smoke_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": summary}))
    if FAILED_CHECKS:
        sys.exit(f"chip_smoke: {len(FAILED_CHECKS)} check(s) failed: "
                 + "; ".join(FAILED_CHECKS))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
