"""The port's MLA attention and shared experts against the JAX reference
at deepseek-v2-smoke size (2 layers, d_model 64, 4 heads, q_lora 48,
kv_lora 32, d_head 16 + 8 rope, 8 experts top-2 and 2 shared, fp8),
through the kernels' plain versions on the CPU; the reference runs
meshless with its Pallas kernels in interpret mode:

* ``mla_forward``: an expanded prefill chunk, a second chunk over the
  first, then absorbed decode steps with a [B] ``cache_index`` of unequal
  lengths, on fp8 and on bf16 leaves, over a slab of 32 positions (one
  dense score block) and of 128 (``attend``'s chunked online softmax):
  outputs within the packed matmul's rtol 2e-3 / atol 1e-3, the latent
  and rope cache writes bit for bit;
* the absorbed decode's dequantized ``w_uk`` / ``w_uv`` bit for bit the
  reference's ``dequantize(..., bf16)``;
* ``moe_forward`` with shared experts (prefill-chunk and decode shapes) at
  5e-2, a routing difference only at a one-ulp router tie;
* the latent cache layout and bytes, and the refusals: a quantized KV tier
  (pool, cache, policy, an int8-KV draft) and a paged pool on MLA;
* the leaves: the MLA and shared-expert leaf set, ``leaf_info`` (an
  ``ffn.*`` rule reaches the shared experts), the bridge both ways and
  ``model_params``, each against the reference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ops import declare_execution
from repro.launch.roofline import model_params as ref_model_params
from repro.models import attention as RA
from repro.models import common as RC
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.quant import schemes as RS
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.quant.policy import leaf_info as ref_leaf_info
from repro.quant.policy import validate_kv_tier as ref_validate_kv_tier
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.launch.roofline import model_params
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.attention import mla_forward
from repro_torch.quant.policy import (PrecisionPolicy, leaf_info,
                                      validate_kv_tier)
from repro_torch.serve import (Scheduler, ServeConfig, ServingEngine,
                               SpecConfig)
from repro_torch.serve.kv_pool import (PagedKVPool, bytes_per_slot,
                                       slots_for_budget)

ARCH = "deepseek-v2-236b"
MM_TOL = dict(rtol=2e-3, atol=1e-3)     # the packed-matmul contract
TOL = 5e-2
MLA_LEAVES = ("attn.w_dq", "attn.w_uq", "attn.w_dkv", "attn.w_uk",
              "attn.w_uv", "attn.wo")


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))
    return np.exp2(e - 7)


@functools.lru_cache(maxsize=None)
def _smoke(leaves="fp8"):
    """(reference cfg, params; port cfg, params) at smoke size; ``leaves``
    'bf16' keeps every MLA projection dense in both."""
    cfg = get_config(ARCH, smoke=True)
    plan = {n: "bf16" for n in MLA_LEAVES} if leaves == "bf16" else None
    params = RT.build_params(cfg, RC.QuantMaker(jax.random.PRNGKey(0),
                                                plan=plan))
    pcfg = port_config(ARCH, smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")
    return cfg, params, pcfg, port


# ---------------------------------------------------------------------------
# mla_forward against the reference
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_mla(cfg):
    return jax.jit(lambda p, x, c, i: RA.mla_forward(
        p, cfg.mla_cfg(), x, cache=c, cache_index=i))


@pytest.mark.parametrize("smax,layer", [(32, 0), (128, 1)],
                         ids=["slab32", "slab128"])
@pytest.mark.parametrize("leaves", ["fp8", "bf16"])
def test_mla_forward_matches_reference(leaves, smax, layer):
    """Two 8-token prefill chunks of 2 rows (the second attends over the
    first), then two absorbed decode steps at unequal row lengths (16 and
    11, then 17 and 12): every output within the packed matmul's
    tolerance, the latent and rope caches bit for bit after every step."""
    declare_execution(kernel="pallas")
    cfg, params, pcfg, port = _smoke(leaves)
    lp = jax.tree_util.tree_map(lambda a: a[layer], params["layers"]["attn"])
    blk = port.layers[layer].attn
    for name in ("w_uk", "w_dkv"):
        assert isinstance(blk[name], C.QLinear) == (leaves == "fp8")
    rng = np.random.default_rng(20 + smax)
    b = 2
    rcache = (jnp.zeros((b, smax, cfg.kv_lora), jnp.bfloat16),
              jnp.zeros((b, smax, cfg.d_head_rope), jnp.bfloat16))
    pcache = (torch.zeros((b, smax, cfg.kv_lora), dtype=torch.bfloat16),
              torch.zeros((b, smax, cfg.d_head_rope), dtype=torch.bfloat16))
    steps = [(8, 0), (8, 8), (1, np.array([16, 11])), (1, np.array([17, 12]))]
    for s, index in steps:
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        ridx = jnp.asarray(index, jnp.int32) if s == 1 else index
        want, rcache = _ref_mla(cfg)(lp, jnp.asarray(x).astype(jnp.bfloat16),
                                     rcache, ridx)
        pidx = torch.from_numpy(index).long() if s == 1 else index
        got = mla_forward(blk, T.mla_cfg(pcfg), _bf16(x), cache=pcache,
                          cache_index=pidx)
        assert got.shape == (b, s, cfg.d_model) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(want), **MM_TOL)
        for mine, ref in zip(pcache, rcache):
            np.testing.assert_array_equal(_f32(mine), _f32(ref))


def test_absorbed_weights_are_the_reference_dequantize():
    """``QLinear.dense_bf16`` (made once and kept) is the reference's
    per-call ``dequantize(..., bf16)`` of ``w_uk`` / ``w_uv`` bit for bit."""
    _, params, _, port = _smoke()
    for name in ("w_uk", "w_uv"):
        ref = jax.tree_util.tree_map(lambda a: a[1],
                                     params["layers"]["attn"][name])
        want = RS.dequantize(RS.QuantizedLinearWeights(
            RS.get_scheme(ref.scheme_name), ref.packed, ref.scales,
            ref.shape), dtype=jnp.bfloat16)
        leaf = port.layers[1].attn[name]
        got = leaf.dense_bf16()
        assert leaf.dense_bf16() is got
        np.testing.assert_array_equal(_f32(got), _f32(want))


def test_prefill_chunk_of_one_token_takes_the_absorbed_decode():
    """As in the reference, any S == 1 call decodes absorbed, an int
    ``cache_index`` too: it equals the [B] index form at equal lengths."""
    _, _, pcfg, port = _smoke()
    blk, mcfg = port.layers[0].attn, T.mla_cfg(pcfg)
    rng = np.random.default_rng(3)
    x = _bf16(rng.standard_normal((2, 5, pcfg.d_model)))
    caches = [T.init_cache(pcfg, 2, 16, device="cpu") for _ in range(2)]
    for c in caches:
        mla_forward(blk, mcfg, x, cache=(c[0][0], c[1][0]), cache_index=0)
    step = _bf16(rng.standard_normal((2, 1, pcfg.d_model)))
    a = mla_forward(blk, mcfg, step, cache=(caches[0][0][0],
                                            caches[0][1][0]), cache_index=5)
    b = mla_forward(blk, mcfg, step, cache=(caches[1][0][0], caches[1][1][0]),
                    cache_index=torch.tensor([5, 5]))
    assert torch.equal(a, b)
    assert all(torch.equal(u, v) for u, v in zip(caches[0], caches[1]))


# ---------------------------------------------------------------------------
# Shared experts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 16), (6, 1)],
                         ids=["chunk16", "decode6"])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_forward_with_shared_experts_matches_reference(shape, seed):
    declare_execution(kernel="pallas")
    cfg, params, pcfg, port = _smoke()
    rng = np.random.default_rng(200 + seed)
    x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    mcfg = M.moe_cfg(pcfg)
    assert mcfg.n_shared_experts == 2
    for layer in range(cfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[layer],
                                    params["layers"]["moe"])
        want, _ = jax.jit(lambda p, v: RM.moe_forward(p, cfg.moe_cfg(), v))(
            lp, xj)
        blk = port.layers[layer].moe
        routes = M.Routes()
        got = M.moe_forward(blk, mcfg, _bf16(x), routes=routes)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)
        # the shared experts' part is there: the routed part alone differs
        routed = M.moe_forward(blk, M.MoEConfig(
            mcfg.n_experts, mcfg.top_k, mcfg.capacity_factor,
            mcfg.activation), _bf16(x), routes=M.Routes(routes.ids))
        assert (_f32(routed) != _f32(got)).mean() > 0.5
        _, ridx, _ = jax.vmap(lambda v: RM._route(
            v, lp["router"], cfg.moe_cfg()))(xj)
        flips = np.sort(routes.ids[0].numpy(), -1) != np.sort(
            np.asarray(ridx), -1)
        rows = np.nonzero(flips.any(-1))
        logits = _f32(C.apply_linear(blk["router"], _bf16(x),
                                     out_dtype=torch.float32))
        top = np.sort(logits[rows], -1)[..., ::-1]
        k = pcfg.top_k
        gap = (top[..., k - 1] - top[..., k]) / _bf16_ulp(top[..., k - 1])
        assert (gap <= 1).all(), gap


# ---------------------------------------------------------------------------
# The latent cache and the refusals
# ---------------------------------------------------------------------------
def test_latent_cache_layout_and_bytes():
    pcfg = port_config(ARCH, smoke=True)
    c_kv, k_rope = T.init_cache(pcfg, 3, 24, device="cpu")
    assert c_kv.shape == (2, 3, 24, 32) and k_rope.shape == (2, 3, 24, 8)
    assert c_kv.dtype == k_rope.dtype == torch.bfloat16
    full = port_config(ARCH)
    # (kv_lora 512 + rope 64) x 2 bytes = 1152 B a token a layer
    assert bytes_per_slot(full, 512) == 1152 * full.n_layers * 512
    assert bytes_per_slot(full, 500, align=64) == 1152 * full.n_layers * 512
    assert slots_for_budget(full, 512, 1152 * 60 * 512 * 7 + 1) == 7
    rcfg = get_config(ARCH)
    spec = RA.mla_cache_spec(rcfg.mla_cfg(), 1, 512)
    assert sum(int(np.prod(s.shape)) * 2 for s in spec) == 1152 * 512


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_quantized_kv_tiers_are_refused_on_mla(tier):
    pcfg = port_config(ARCH, smoke=True)
    with pytest.raises(ValueError, match="MLA latent cache"):
        validate_kv_tier(tier, pcfg)
    with pytest.raises(ValueError, match="MLA latent cache"):
        ref_validate_kv_tier(tier, get_config(ARCH, smoke=True))
    assert validate_kv_tier("bf16", pcfg) == "bf16"
    with pytest.raises(ValueError, match="MLA latent cache"):
        PrecisionPolicy(kv=tier).validate_for(pcfg)
    with pytest.raises(ValueError, match="stays bf16"):
        T.init_cache(pcfg, 1, 16, kv_dtype=tier, device="cpu")
    _, _, _, port = _smoke()
    eng = ServingEngine(pcfg, port, ServeConfig(device="cpu", max_len=32))
    with pytest.raises(ValueError, match="MLA latent cache"):
        eng.new_pool(kv_dtype=tier)
    with pytest.raises(ValueError, match="MLA latent cache"):
        ServingEngine(pcfg, port, ServeConfig(
            device="cpu", policy=PrecisionPolicy(kv=tier)))


def test_paged_pool_and_int8_draft_are_refused_on_mla():
    _, _, pcfg, port = _smoke()
    with pytest.raises(NotImplementedError, match="paged pools of the MLA"):
        PagedKVPool(pcfg, 2, 32, align=8, device="cpu")
    eng = ServingEngine(pcfg, port, ServeConfig(
        device="cpu", max_len=32, prefill_chunk=8, paged=True))
    with pytest.raises(NotImplementedError, match="paged pools of the MLA"):
        eng.new_pool()
    with pytest.raises(NotImplementedError, match="paged MLA"):
        T.forward(pcfg, port, torch.ones((1, 1), dtype=torch.long),
                  cache=T.init_cache(pcfg, 1, 8, device="cpu"),
                  cache_index=torch.zeros(1, dtype=torch.long), mode="decode",
                  page_table=torch.zeros((1, 1), dtype=torch.long))
    slab = ServingEngine(pcfg, port, ServeConfig(device="cpu", max_len=32))
    with pytest.raises(ValueError, match="MLA latent cache"):
        Scheduler(slab, spec=SpecConfig(draft_kv="int8"))


# ---------------------------------------------------------------------------
# Leaves, policy, bridge, parameter counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_leaf_info_covers_the_mla_and_shared_expert_leaves(smoke):
    pcfg = port_config(ARCH, smoke=smoke)
    info = leaf_info(pcfg)
    assert info == ref_leaf_info(get_config(ARCH, smoke=smoke))
    assert set(MLA_LEAVES) < set(info) and "attn.wq" not in info
    if not smoke:
        assert info["attn.w_dkv"] == (5120, 576, "fp8")
        assert info["attn.w_uq"] == (1536, 24576, "fp8")
        assert info["ffn.w_gate"] == (5120, 3072, "fp8")
    # an ffn.* rule reaches the shared experts, as in the reference
    weights = (("ffn.*", "mxfp4"),)
    plan = PrecisionPolicy(weights=weights).validate_for(pcfg) \
        .resolved_plan(pcfg)
    ref_plan = RefPolicy(weights=weights).validate_for(
        get_config(ARCH, smoke=smoke)).resolved_plan(get_config(ARCH,
                                                                smoke=smoke))
    assert plan == ref_plan
    assert plan["ffn.w_down"] == "mxfp4" and plan["moe.w_down"] == "fp8"


def test_ffn_rule_builds_shared_experts_the_engine_accepts():
    pcfg = port_config(ARCH, smoke=True)
    pol = PrecisionPolicy(weights=(("ffn.*", "mxfp4"),))
    params = T.build_params(pcfg, C.QuantMaker(
        0, device="cpu", plan=pol.resolved_plan(pcfg)))
    moe = params.layers[0].moe
    assert moe["shared_up"].scheme_name == "mxfp4"
    assert moe["shared_up"].name == "ffn.w_up"
    assert moe["w_up"].scheme_name == "fp8"
    ServingEngine(pcfg, params, ServeConfig(device="cpu", policy=pol))
    with pytest.raises(ValueError, match="policy's schemes"):
        ServingEngine(pcfg, params, ServeConfig(device="cpu"))


def test_port_builds_and_bridges_the_reference_leaf_set():
    """The port's own build has the reference's leaves (names, shapes,
    schemes); the bridge carries words, scales and gammas both ways bit
    for bit."""
    cfg, params, pcfg, port = _smoke()
    mine = T.build_params(pcfg, C.QuantMaker(0, device="cpu"))
    ref = params["layers"]
    for blk in (mine.layers[0], port.layers[0]):
        assert set(blk.attn) == set(ref["attn"])
        assert set(blk.moe) == set(ref["moe"])
        for group in ("attn", "moe"):
            for name, leaf in getattr(blk, group).items():
                want = ref[group][name]
                if isinstance(leaf, C.Norm):
                    assert leaf.weight.shape == want.shape[1:]
                    assert leaf.weight.dtype == torch.float32
                elif isinstance(leaf, C.QLinear):
                    assert leaf.scheme_name == want.scheme_name
                    assert tuple(leaf.packed.shape) == want.packed.shape[1:]
                    assert tuple(leaf.scales.shape) == want.scales.shape[1:]
                    assert leaf.name == want.name
                else:
                    assert tuple(leaf.weight.shape) == want.shape[1:]
    back = params_to_numpy(port)["layers"]
    for group in ("attn", "moe"):
        for name, want in ref[group].items():
            got = back[group][name]
            if hasattr(want, "packed"):
                np.testing.assert_array_equal(got.packed,
                                              np.asarray(want.packed))
                np.testing.assert_array_equal(got.scales,
                                              np.asarray(want.scales))
            elif name.endswith("_norm"):
                np.testing.assert_array_equal(got, np.asarray(want))
            else:
                np.testing.assert_array_equal(
                    got, np.asarray(want).view(np.int16))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_model_params_count_mla_and_shared_experts_as_the_reference(smoke):
    got = model_params(port_config(ARCH, smoke=smoke))
    assert got == ref_model_params(get_config(ARCH, smoke=smoke))
    if not smoke:       # about the "236B" of the name, 21 B active
        assert 235e9 < got["total"] < 240e9 and 21e9 < got["active"] < 22e9
