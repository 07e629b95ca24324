"""The port's MoE serving path against the JAX reference at
qwen3-moe-smoke size (8 experts, top-2, AWQ-int4), through the kernels'
plain versions on the CPU:

* the expert-grouped twin (``packed_grouped_plain``, what grouped K1 / K2
  compute) against the reference's ``packed_gemv`` / ``packed_matmul``
  under ``jax.vmap`` over experts, in Pallas interpret mode, on E-stacked
  leaves of the reference's ``QuantMaker`` (awq_int4, mxfp4, fp8; M = 1, 5,
  10; an empty group; a pair list that repeats an expert), at the packed
  matmul's rtol 2e-3 / atol 1e-3;
* routing and dispatch on the same f32 probabilities: top-k ids (planted
  exact ties: the lower expert first), ranks and keep masks exact,
  capacity drops, the capacity taken from the padded chunk length, and
  the combine within one bf16 ulp;
* ``moe_forward`` against ``repro.models.moe.moe_forward`` (Pallas,
  interpret) in prefill-chunk and decode shapes at 5e-2, with routing
  differences counted and each shown to be a near tie (one bf16 ulp)
  between the k-th and (k+1)-th router logits;
* the slice: the port's engine and scheduler against the reference's
  meshless engine, bf16 and int8 KV (teacher-forced logits within 5e-2,
  greedy ids equal where the top-2 gap exceeds 0.1), and a request served
  alone equal to itself batched, bit for bit;
* the parameters (expert stacks quantized as the reference's per-expert
  loop, the bridge both ways, the policy's leaves), ``check_supported``'s
  refusals and ``model_params``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ops import declare_execution
from repro.launch.roofline import model_params as ref_model_params
from repro.models import common as RC
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.quant.policy import leaf_info as ref_leaf_info
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import ops
from repro_torch.kernels.packed_matmul import (packed_gemv_grouped,
                                               packed_grouped_plain,
                                               packed_matmul_grouped)
from repro_torch.launch.roofline import model_params
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.quant.policy import PrecisionPolicy, leaf_info
from repro_torch.quant.schemes import get_scheme, quantize_weights
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine)

ARCH = "qwen3-moe-30b-a3b"
MM_TOL = dict(rtol=2e-3, atol=1e-3)     # the packed-matmul contract
TOL = 5e-2
DECIDED_GAP = 0.1


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (the spacing of bf16 values around it)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))
    return np.exp2(e - 7)


@functools.lru_cache(maxsize=None)
def _smoke():
    cfg = get_config(ARCH, smoke=True)
    params = RT.build_params(cfg, RC.QuantMaker(jax.random.PRNGKey(0)))
    pcfg = port_config(ARCH, smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")
    return cfg, params, pcfg, port


# ---------------------------------------------------------------------------
# The expert-grouped kernels' twin against the reference under vmap
# ---------------------------------------------------------------------------
# (scheme, K, N): awq_int4 in groups of 128, mxfp4 in 32-groups, fp8 per
# channel
GROUPED_LEAVES = {"awq_int4": (256, 96), "mxfp4": (128, 64), "fp8": (128, 48)}
# (expert, rows) of each group: expert 2 twice, an empty group
GROUPS = [(3, None), (0, 1), (2, None), (5, 0), (2, 2), (1, None)]


def _ref_grouped(leaf, x, experts):
    """The reference's per-expert linear, vmapped over the groups' experts
    (``repro/models/moe.py:_expert_ffn``), f32 out."""
    def one(p, s, xe):
        return RC.apply_linear(RC.QLinear(p, s, leaf.scheme_name, leaf.shape,
                                          leaf.name), xe,
                               out_dtype=jnp.float32)
    return jax.vmap(one)(leaf.packed[experts], leaf.scales[experts], x)


@pytest.mark.parametrize("m", [1, 5, 10])
@pytest.mark.parametrize("scheme", list(GROUPED_LEAVES))
def test_grouped_twin_matches_reference_vmap(scheme, m):
    declare_execution(kernel="pallas")
    k, n = GROUPED_LEAVES[scheme]
    n_experts = 6
    mk = RC.QuantMaker(jax.random.PRNGKey(3))
    leaf = mk.dense("moe.w_up", (n_experts,), k, n, scheme=scheme)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((len(GROUPS), m, k)).astype(np.float32)
    experts = np.array([e for e, _ in GROUPS], np.int32)
    rows = np.array([m if r is None else min(r, m) for _, r in GROUPS],
                    np.int32)
    x *= (np.arange(m)[None, :] < rows[:, None])[..., None]
    want = np.asarray(_ref_grouped(leaf, jnp.asarray(x).astype(jnp.bfloat16),
                                   experts))
    pleaf = C.QLinear(torch.from_numpy(np.array(leaf.packed)),
                      torch.from_numpy(np.array(leaf.scales)),
                      scheme, (k, n), leaf.name)
    assert pleaf.packed.shape[0] == n_experts
    args = (_bf16(x), pleaf.packed, pleaf.scales, pleaf.scheme,
            torch.from_numpy(experts), torch.from_numpy(rows))
    got = packed_grouped_plain(*args).numpy()
    np.testing.assert_allclose(got, want, **MM_TOL)
    live = np.arange(m)[None, :] < rows[:, None]
    assert not got[~live].any()             # rows past rows[g]: exact 0
    # on CPU tensors both wrappers and the dispatch take the plain twin
    for fn in (packed_gemv_grouped, packed_matmul_grouped):
        np.testing.assert_array_equal(fn(*args).numpy(), got)
    out = ops.grouped_quantized_matmul(args[0], pleaf, args[4], args[5],
                                       out_dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), got)


def test_grouped_wrappers_refuse_bad_operands():
    leaf = C.QuantMaker(0, device="cpu").dense("moe.w_up", 64, 32, "awq_int4",
                                               experts=3)
    x = torch.zeros((2, 1, 64), dtype=torch.bfloat16)
    experts = torch.tensor([0, 2], dtype=torch.int32)
    rows = torch.ones(2, dtype=torch.int32)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        packed_gemv_grouped(x.to(meta), leaf.packed.to(meta),
                            leaf.scales.to(meta), leaf.scheme,
                            experts.to(meta), rows.to(meta))
    with pytest.raises(ValueError, match="on the CPU"):
        packed_matmul_grouped(x, leaf.packed.to(meta), leaf.scales,
                              leaf.scheme, experts, rows)
    dense = C.DenseLinear(torch.zeros((3, 64, 32), dtype=torch.bfloat16),
                          "moe.w_up")
    with pytest.raises(NotImplementedError, match="packed schemes"):
        ops.grouped_quantized_matmul(x, dense, experts, rows)
    with pytest.raises(NotImplementedError, match="packed schemes"):
        C.QuantMaker(0, device="cpu").dense("moe.w_up", 64, 32, "bf16",
                                            experts=3)


# ---------------------------------------------------------------------------
# Routing, dispatch, capacity, combine
# ---------------------------------------------------------------------------
def _planted_ties(rng, t, e):
    """[t, e] f32 probabilities whose rows repeat values: exact ties at
    and across the top-k boundary."""
    vals = rng.choice(np.linspace(0.01, 0.2, 6, dtype=np.float32), (t, e))
    vals[::3, : e // 2] = vals[::3, :1]         # a run of equal maxima
    return vals.astype(np.float32)


@pytest.mark.parametrize("k", [2, 8])
def test_top_k_ids_equal_jax_including_exact_ties(k):
    rng = np.random.default_rng(5)
    probs = _planted_ties(rng, 40, 16)
    _, want = jax.lax.top_k(jnp.asarray(probs), k)
    got = M.top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a tie straddles the boundary in some rows: the lower id goes in
    kth = np.sort(probs, -1)[:, ::-1][:, k - 1:k + 1]
    assert (kth[:, 0] == kth[:, 1]).any()


def test_route_equals_reference_on_the_same_probabilities(monkeypatch):
    """Given one f32 probability table (the softmax patched to return
    it on both sides), ``route`` and ``_route`` pick the same ids and the
    same gates, ties included."""
    rng = np.random.default_rng(6)
    probs = _planted_ties(rng, 24, 8)
    cfg = M.MoEConfig(n_experts=8, top_k=2)
    rcfg = RM.MoEConfig(d_model=4, d_ff=8, n_experts=8, top_k=2)
    monkeypatch.setattr(torch, "softmax", lambda *a, **k: torch.from_numpy(
        probs))
    monkeypatch.setattr(jax.nn, "softmax", lambda *a, **k: jnp.asarray(probs))
    router = C.DenseLinear(torch.zeros((4, 8), dtype=torch.bfloat16))
    gates, idx, _ = M.route(torch.zeros((24, 4), dtype=torch.bfloat16),
                            router, cfg)
    rgates, ridx, _ = RM._route(jnp.zeros((24, 4), jnp.bfloat16),
                                jnp.zeros((4, 8), jnp.bfloat16), rcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rgates), rtol=1e-6)


@pytest.mark.parametrize("cap", [1, 2, 5])
def test_dispatch_ranks_and_drops_equal_reference(cap):
    rng = np.random.default_rng(7 + cap)
    # skewed choice: experts 0-1 overflow any capacity here
    idx = np.stack([rng.choice(8, 2, replace=False,
                               p=[.3, .3, .1, .1, .05, .05, .05, .05])
                    for _ in range(16)]).astype(np.int32)
    flat_e, rank, keep = M.dispatch_ranks(torch.from_numpy(idx).long(), 8,
                                          cap)
    rflat, rrank, rkeep = RM._dispatch_ranks(jnp.asarray(idx), 8, cap)
    np.testing.assert_array_equal(flat_e.numpy(), np.asarray(rflat))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(rrank))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    assert not keep.all()                   # tokens are dropped
    # per routing group (a leading axis): each group ranks on its own
    two = torch.from_numpy(np.stack([idx, idx[::-1]])).long()
    _, rank2, keep2 = M.dispatch_ranks(two, 8, cap)
    np.testing.assert_array_equal(rank2[0].numpy(), rank.numpy())
    np.testing.assert_array_equal(
        keep2[1].numpy(), np.asarray(RM._dispatch_ranks(
            jnp.asarray(idx[::-1]), 8, cap)[2]))


@pytest.mark.parametrize("tokens", [1, 2, 7, 16, 64, 128, 513])
def test_capacity_equals_reference(tokens):
    for smoke in (True, False):
        pcfg = M.moe_cfg(port_config(ARCH, smoke=smoke))
        rcfg = get_config(ARCH, smoke=smoke).moe_cfg()
        assert M.capacity(tokens, pcfg) == RM.capacity(tokens, rcfg)
    assert M.capacity(64, M.moe_cfg(port_config(ARCH))) == 5


def test_capacity_comes_from_the_padded_chunk():
    """A 16-token chunk holds 8 prompt tokens and 8 pad tokens; five of the
    prompt tokens are one token, so their two experts each get 5 tokens.
    The padded length gives capacity 5 (no drop), as the reference's; the
    8 valid tokens alone would give 4 and drop the fifth."""
    declare_execution(kernel="pallas")
    cfg, params, pcfg, port = _smoke()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    x[0, [0, 2, 3, 5, 7]] = x[0, 0]
    mcfg = M.moe_cfg(pcfg)
    assert (M.capacity(16, mcfg), M.capacity(8, mcfg)) == (5, 4)
    lp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["moe"])
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    padded, _ = RM.moe_forward(lp, cfg.moe_cfg(), xj)
    valid, _ = RM.moe_forward(lp, cfg.moe_cfg(), xj[:, :8])
    got = _f32(M.moe_forward(port.layers[0].moe, mcfg, _bf16(x)))[:, :8]
    np.testing.assert_allclose(got, _f32(padded)[:, :8], rtol=TOL, atol=TOL)
    # capacity 4 drops a token that capacity 5 keeps: the valid-length
    # run is far outside the tolerance
    assert np.abs(got - _f32(valid)).max() > 10 * TOL


def test_combine_within_one_bf16_ulp_of_the_reference():
    rng = np.random.default_rng(9)
    t, k, d, cap = 12, 2, 32, 4
    idx = np.stack([rng.choice(8, k, replace=False) for _ in range(t)])
    probs = rng.random((t, 8)).astype(np.float32)
    gates = np.take_along_axis(probs, idx, -1)
    gates = (gates / gates.sum(-1, keepdims=True)).astype(np.float32)
    out_buf = rng.standard_normal((8, cap, d)).astype(np.float32)
    flat_e, rank, keep = RM._dispatch_ranks(jnp.asarray(idx), 8, cap)
    assert not np.asarray(keep).all()

    def ref(out_buf, gates, flat_e, rank, keep):     # _moe_group's combine
        y = out_buf[flat_e, jnp.minimum(rank, cap - 1)]
        y = y * (gates.reshape(-1, 1) * keep[:, None]).astype(y.dtype)
        return y.reshape(t, k, d).sum(axis=1)

    ob = jnp.asarray(out_buf).astype(jnp.bfloat16)
    want = _f32(jax.jit(ref)(ob, jnp.asarray(gates), flat_e, rank, keep))
    rows = _bf16(out_buf).reshape(8 * cap, d)[
        torch.from_numpy(np.asarray(flat_e) * cap
                         + np.minimum(np.asarray(rank), cap - 1)).long()]
    got = _f32(M.combine(rows[None], torch.from_numpy(gates)[None],
                         torch.from_numpy(np.array(keep))[None]))[0]
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()


# ---------------------------------------------------------------------------
# moe_forward against the reference
# ---------------------------------------------------------------------------
def _router_gap_at_flips(pcfg, router, x, idx_port, idx_ref):
    """The rows whose expert sets differ, and for each the gap between the
    k-th and (k+1)-th router logits over one bf16 ulp of the k-th."""
    k = pcfg.top_k
    logits = _f32(C.apply_linear(router, x, out_dtype=torch.float32))
    flips = np.sort(idx_port, -1) != np.sort(idx_ref, -1)
    rows = np.nonzero(flips.any(-1))
    top = np.sort(logits[rows], -1)[..., ::-1]
    return rows, (top[..., k - 1] - top[..., k]) / _bf16_ulp(top[..., k - 1])


@pytest.mark.parametrize("shape", [(1, 16), (1, 8), (6, 1)],
                         ids=["chunk16", "chunk8", "decode6"])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_forward_matches_reference(shape, seed):
    declare_execution(kernel="pallas")
    cfg, params, pcfg, port = _smoke()
    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    for layer in range(cfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[layer],
                                    params["layers"]["moe"])
        want, _ = jax.jit(lambda p, v: RM.moe_forward(p, cfg.moe_cfg(), v))(
            lp, xj)
        blk = port.layers[layer].moe
        routes = M.Routes()
        got = M.moe_forward(blk, M.moe_cfg(pcfg), _bf16(x), routes=routes)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)
        _, ridx, _ = jax.vmap(lambda v: RM._route(
            v, lp["router"], cfg.moe_cfg()))(xj)
        rows, gap = _router_gap_at_flips(pcfg, blk["router"], _bf16(x),
                                         routes.ids[0].numpy(),
                                         np.asarray(ridx))
        assert (gap <= 1).all(), (len(rows[0]), gap)


def test_replayed_routes_reproduce_the_recorded_run():
    """``Routes`` records a run's expert ids layer by layer; replayed on a
    second run, the run takes them as they are (the ids of the run on
    other inputs, here) with its own gates."""
    _, _, pcfg, port = _smoke()
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(1, pcfg.vocab, (1, 16))).long()
    cache = T.init_cache(pcfg, 1, 32, device="cpu")
    rec = M.Routes()
    want = T.forward(pcfg, port, toks, cache=cache, cache_index=0,
                     mode="prefill_chunk", routes=rec)
    assert len(rec.ids) == pcfg.n_layers
    again = T.forward(pcfg, port, toks, cache=T.init_cache(
        pcfg, 1, 32, device="cpu"), cache_index=0, mode="prefill_chunk",
        routes=M.Routes(rec.ids))
    np.testing.assert_array_equal(_f32(again), _f32(want))
    other = M.Routes(rec.ids)
    T.forward(pcfg, port, toks.flip(1), cache=T.init_cache(
        pcfg, 1, 32, device="cpu"), cache_index=0, mode="prefill_chunk",
        routes=other)
    assert other._next == pcfg.n_layers
    assert all(a is b for a, b in zip(other.ids, rec.ids))


# ---------------------------------------------------------------------------
# The slice: engine and scheduler against the reference engine
# ---------------------------------------------------------------------------
def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _engine(tier="bf16", **kw):
    _, _, pcfg, port = _smoke()
    kw.setdefault("max_len", 48)
    kw.setdefault("n_slots", 4)
    kw.setdefault("prefill_chunk", 8)
    return ServingEngine(pcfg, port, ServeConfig(
        policy=PrecisionPolicy(kv=tier), device="cpu", **kw))


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_teacher_forced_logits_match_reference_engine(tier):
    cfg, params, _, _ = _smoke()
    ref = RefEngine(cfg, params, RefServeConfig(
        max_len=32, n_slots=4, prefill_chunk=8,
        policy=RefPolicy(kv=tier, kernel="pallas")))
    port = _engine(tier, max_len=32)
    prompts = _prompts(cfg.vocab, (11, 8, 5), seed=5)
    rpool, ppool = ref.new_pool(), port.new_pool()
    slots = [rpool.alloc() for _ in prompts]
    assert slots == [ppool.alloc() for _ in prompts]
    want = [np.asarray(x, np.float32)
            for x in ref.prefill_into_slots(rpool, slots, prompts)]
    got = [x.numpy() for x in port.prefill_into_slots(ppool, slots, prompts)]
    steps = [(np.stack(want), np.stack(got))]
    toks = np.zeros((4,), np.int32)
    toks[slots] = np.stack(want).argmax(-1)
    for _ in range(4):
        w = np.asarray(ref.decode_slots_with_logits(rpool, toks),
                       np.float32)[slots]
        g = port.decode_slots_with_logits(ppool, toks).numpy()[slots]
        steps.append((w, g))
        for s in slots:
            rpool.lengths[s] += 1
            ppool.lengths[s] += 1
        toks[slots] = w.argmax(-1)              # teacher forcing
    n_decided = 0
    for w, g in steps:
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        top2 = np.sort(w, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > DECIDED_GAP
        n_decided += int(decided.sum())
        np.testing.assert_array_equal(g.argmax(-1)[decided],
                                      w.argmax(-1)[decided])
    assert n_decided >= len(steps)      # the check compared real tokens


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_scheduler_serves_requests_equal_to_their_solo_runs(tier):
    """Staggered admission and bursts: each request's greedy tokens equal
    the request served alone, bit for bit (a decode row routes as its own
    group, so its batch-mates cannot move it)."""
    eng = _engine(tier)
    prompts = _prompts(eng.cfg.vocab, (8, 6, 10, 13), seed=4)
    solo = [eng.generate({"tokens": p[None]},
                         max_new_tokens=6)["generated"][0] for p in prompts]
    sched = Scheduler(eng)
    first = [sched.submit(Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=6))) for p in prompts[:2]]
    while sched.n_decode_steps < 2:
        sched.step()
    late = [sched.submit(Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=6))) for p in prompts[2:]]
    sched.run(max_steps=200)
    for req, want in zip(first + late, solo):
        assert req.is_finished and req.finish_reason == "length"
        np.testing.assert_array_equal(np.asarray(req.output_tokens), want)
    batch = eng.generate({"tokens": np.stack([p[:5] for p in prompts])},
                         max_new_tokens=6)["generated"]
    for row, p in zip(batch, prompts):
        np.testing.assert_array_equal(
            row, eng.generate({"tokens": p[None, :5]},
                              max_new_tokens=6)["generated"][0])


# ---------------------------------------------------------------------------
# Parameters, policy, refusals, parameter counts
# ---------------------------------------------------------------------------
def test_expert_stack_quantizes_each_expert_as_its_own_leaf():
    """``QuantMaker`` quantizes an [E, K, N] draw in one call; each expert's
    words and scales are ``quantize_weights`` of its own [K, N] slice,
    bit for bit (the reference's per-expert loop)."""
    for scheme in ("awq_int4", "mxfp4", "fp8"):
        mk = C.QuantMaker(4, device="cpu")
        leaf = mk.dense("moe.w_gate", 256, 24, scheme, experts=5)
        draw = C.QuantMaker(4, device="cpu")._normal(5, 256, 24) / 16.0
        assert leaf.packed.is_contiguous() and leaf.scales.is_contiguous()
        for e in range(5):
            packed, scales = quantize_weights(get_scheme(scheme), draw[e])
            assert torch.equal(leaf.packed[e], packed), scheme
            assert torch.equal(leaf.scales[e], scales), scheme


def test_port_builds_and_bridges_the_reference_leaf_set():
    cfg, params, pcfg, port = _smoke()
    mine = T.build_params(pcfg, C.QuantMaker(0, device="cpu"))
    for blk in (mine.layers[0], port.layers[0]):
        assert not hasattr(blk, "ffn")
        assert set(blk.moe) == {"router", "w_gate", "w_up", "w_down"}
        assert isinstance(blk.moe["router"], C.DenseLinear)
        assert blk.moe["w_down"].packed.shape == (8, 96 // 8, 64)
    back = params_to_numpy(port)
    ref = params["layers"]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(back["layers"]["moe"][name].packed,
                                      np.asarray(ref[name].packed))
        np.testing.assert_array_equal(back["layers"]["moe"][name].scales,
                                      np.asarray(ref[name].scales))
    np.testing.assert_array_equal(
        back["layers"]["moe"]["router"],
        np.asarray(ref["router"]).view(np.int16))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_leaf_info_and_policy_cover_the_moe_leaves(smoke):
    pcfg = port_config(ARCH, smoke=smoke)
    assert leaf_info(pcfg) == ref_leaf_info(get_config(ARCH, smoke=smoke))
    pol = PrecisionPolicy(weights=(("moe.w_*", "mxfp4"),
                                   ("moe.router", "bf16"))).validate_for(pcfg)
    plan = pol.resolved_plan(pcfg)
    assert plan["moe.w_down"] == "mxfp4" and plan["moe.router"] == "bf16"
    assert plan["attn.wq"] == "awq_int4" and "ffn.w_gate" not in plan
    with pytest.raises(ValueError, match="matches no leaf"):
        PrecisionPolicy(weights=(("ffn.*", "fp8"),)).validate_for(pcfg)


def test_check_supported_admits_qwen3_and_refuses_mla_and_shared_experts():
    """MLA and shared experts are ported now: qwen3-moe, deepseek-v2 and
    qwen3-moe with either of deepseek's features are admitted; a MoE stack
    with no experts (or no top-k) and a non-RMS norm are still refused."""
    pcfg = port_config(ARCH)
    T.check_supported(pcfg)
    T.check_supported(port_config("deepseek-v2-236b"))
    for more in (dict(use_mla=True, q_lora=48, kv_lora=32),
                 dict(n_shared_experts=2)):
        T.check_supported(dataclasses.replace(pcfg, **more))
    for bad in (dict(n_experts=0), dict(top_k=0), dict(norm="layer")):
        for base in (pcfg, port_config("deepseek-v2-236b")):
            with pytest.raises(NotImplementedError, match="RMS norm"):
                T.check_supported(dataclasses.replace(base, **bad))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_model_params_count_total_and_active_as_the_reference(smoke):
    got = model_params(port_config(ARCH, smoke=smoke))
    assert got == ref_model_params(get_config(ARCH, smoke=smoke))
    if not smoke:       # the "30B" and "A3B" of the name
        assert 30e9 < got["total"] < 31e9 and 2.5e9 < got["active"] < 3.5e9
