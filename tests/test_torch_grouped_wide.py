"""The grouped body past 8 rows a group (grouped K2's route: the capacity
buffers of prefill chunks of 104 tokens or more) on the CPU, at small
leaves (the kernel itself runs only on a card:
``tests/test_torch_moe_card.py``, ``chip_smoke.py``):

* ``grouped_work_list`` in items of R = 8 (as grouped K1's), 16 and 32
  rows: every live source once, sorted by expert, at most R an item,
  ceil(n / R) items an expert of n rows;
* the unit plan for each M (``grouped_unit``: R and the unit's columns)
  beside the order of sums (``grouped_gemv_plan``), which is the leaf's
  whatever M, G or R;
* ``packed_gemv_grouped_ordered`` (the body's order) at M = 10, 20 and 40
  against the reference's ``packed_gemv`` / ``packed_matmul`` under
  ``jax.vmap`` over the groups' experts (Pallas, interpret mode) at the
  packed matmul's rtol 2e-3 / atol 1e-3, for awq_int4, mxfp4 and fp8, with
  an empty group and a repeated expert; and each row of an M = 40 call bit
  for bit the same row alone;
* the route by M (grouped K1 to 8 rows, grouped K2 past them) and the
  refusal, with the leaf's shape, of a stack the body does not take, on
  qwen3-moe-30b-a3b's and deepseek-v2-236b's expert shapes (shape
  arithmetic only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.ops import declare_execution
from repro.models import common as RC
from repro_torch.kernels import ops
from repro_torch.kernels import packed_matmul as PM
from repro_torch.models import common as C
from repro_torch.quant.schemes import get_scheme

MM_TOL = dict(rtol=2e-3, atol=1e-3)     # the packed-matmul contract
# (scheme, K, N): awq_int4 in groups of 128 (stages of 32 word rows),
# mxfp4 in 32-groups, fp8 per channel
LEAVES = {"awq_int4": (256, 96), "mxfp4": (128, 64), "fp8": (128, 48)}
N_EXPERTS = 6


def _layout(name, rng):
    """(expert ids, rows, M) of a grouped call."""
    if name.startswith("buffers"):          # expert e's buffer in group e
        m = int(name[len("buffers"):])
        return np.arange(128), rng.integers(0, m + 1, 128), m
    if name == "repeats":                   # 8 experts over 40 groups
        rows = rng.integers(0, 4, 40)
        rows[:4] = 0
        return rng.integers(0, 8, 40), rows, 3
    if name == "one_expert_70_rows":
        return np.full(7, 4), np.full(7, 10), 10
    raise ValueError(name)


@pytest.mark.parametrize("r", [8, 16, 32])
@pytest.mark.parametrize("name", ["buffers10", "buffers20", "buffers40",
                                  "repeats", "one_expert_70_rows"])
def test_work_list_cuts_each_expert_into_items_of_r(name, r):
    rng = np.random.default_rng(3)
    experts, rows, m = _layout(name, rng)
    args = (torch.tensor(experts, dtype=torch.int32),
            torch.tensor(rows, dtype=torch.int32), m)
    item_e, item_rows = PM.grouped_work_list(*args, r=r)
    if r == 8:                              # grouped K1's list, unchanged
        base_e, base_rows = PM.grouped_work_list(*args)
        assert torch.equal(item_e, base_e)
        assert torch.equal(item_rows, base_rows)
    item_e, item_rows = item_e.numpy(), item_rows.numpy()
    assert item_rows.shape[1] == r
    want = sorted(g * m + j for g in range(len(rows))
                  for j in range(min(rows[g], m)))
    got = item_rows[item_rows >= 0]
    assert sorted(got.tolist()) == want             # each source once
    counts = (item_rows >= 0).sum(1)
    assert ((counts >= 1) & (counts <= r)).all()
    assert (np.diff(item_e) >= 0).all()             # sorted by expert
    for e in sorted(set(experts[rows > 0].tolist())):
        n = int(rows[experts == e].clip(0, m).sum())
        assert (item_e == e).sum() == -(-n // r)
        mine = item_rows[item_e == e]
        mine = mine[mine >= 0]
        assert (np.diff(mine) > 0).all()            # (group, row) order
        assert (experts[mine // m] == e).all()
    if name == "one_expert_70_rows":
        assert counts.tolist() == [r] * (70 // r) + ([70 % r] if 70 % r
                                                     else [])


# qwen3-moe-30b-a3b's and deepseek-v2-236b's expert leaves (K, N), scheme
def _expert_leaves():
    out = []
    for arch in ("qwen3-moe-30b-a3b", "deepseek-v2-236b"):
        cfg = ref_config(arch)
        d, f = cfg.d_model, cfg.moe_d_ff
        out += [(arch, cfg.n_experts, k, n, cfg.scheme_ffn)
                for k, n in ((d, f), (f, d))]
    return out


EXPERT_LEAVES = _expert_leaves()


@pytest.mark.parametrize("m", [1, 5, 8, 9, 10, 16, 17, 20, 40])
def test_unit_plan_widens_with_m_and_the_order_does_not_move(m):
    r, u = PM.grouped_unit(m, 768)
    assert r == (8 if m <= 8 else 16 if m <= 16 else 32)
    assert r == 8 * PM.grouped_fragments(m)
    for arch, e, k, n, scheme in EXPERT_LEAVES:
        sch = get_scheme(scheme)
        r, u = PM.grouped_unit(m, n)
        k_warps = 2 if n >= 1536 else 4
        # the consumer warps cover the unit's 32-column boxes by K warps:
        # 4 warps at M <= 8 (grouped K1's units), 8 past it
        assert u // 32 * k_warps == (4 if m <= 8 else 8)
        assert u >= 32 * (4 // k_warps) and (m <= 8 or u >= 2 * r)
        # the order of sums is the leaf's alone: the same (stage_k,
        # chunk_k, fold_k) at every M
        plan = PM.grouped_gemv_plan(k, n, sch)
        assert plan == PM.grouped_gemv_plan(k, n, sch)
        stage_k, chunk_k, fold_k = plan
        assert stage_k // chunk_k == k_warps
        assert k % chunk_k == 0 or stage_k % chunk_k == 0
    assert PM.grouped_gemv_plan(2048, 768, get_scheme("awq_int4")) == \
        (512, 128, 128)


def _leaf(scheme):
    k, n = LEAVES[scheme]
    leaf = RC.QuantMaker(jax.random.PRNGKey(5)).dense(
        "moe.w_up", (N_EXPERTS,), k, n, scheme=scheme)
    pleaf = C.QLinear(torch.from_numpy(np.array(leaf.packed)),
                      torch.from_numpy(np.array(leaf.scales)), scheme, (k, n),
                      leaf.name)
    return leaf, pleaf, k


def _ref_grouped(leaf, x, experts):
    """The reference's per-expert linear, vmapped over the groups' experts
    (``repro/models/moe.py:_expert_ffn``), f32 out."""
    def one(p, s, xe):
        return RC.apply_linear(RC.QLinear(p, s, leaf.scheme_name, leaf.shape,
                                          leaf.name), xe,
                               out_dtype=jnp.float32)
    return jax.vmap(one)(leaf.packed[experts], leaf.scales[experts], x)


@pytest.mark.parametrize("m", [10, 20, 40])
@pytest.mark.parametrize("scheme", list(LEAVES))
def test_ordered_twin_past_8_rows_matches_reference_vmap(scheme, m):
    declare_execution(kernel="pallas")
    leaf, pleaf, k = _leaf(scheme)
    rng = np.random.default_rng(m)
    # expert 2 three times (past one item of 32 rows at M = 20, 40), an
    # empty group, partly filled buffers
    experts = np.array([3, 2, 0, 2, 5, 2], np.int32)
    rows = np.array([m, m, m // 2, m - 1, 0, m], np.int32)
    x = rng.standard_normal((len(rows), m, k)).astype(np.float32)
    x *= (np.arange(m)[None, :] < rows[:, None])[..., None]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    args = (xb, pleaf.packed, pleaf.scales, pleaf.scheme,
            torch.from_numpy(experts), torch.from_numpy(rows))
    got = PM.packed_gemv_grouped_ordered(*args).numpy()
    want = np.asarray(_ref_grouped(leaf, jnp.asarray(x).astype(jnp.bfloat16),
                                   experts))
    np.testing.assert_allclose(got, want, **MM_TOL)
    np.testing.assert_allclose(got, PM.packed_grouped_plain(*args).numpy(),
                               **MM_TOL)
    live = np.arange(m)[None, :] < rows[:, None]
    assert not got[~live].any()             # rows past rows[g]: exact 0


@pytest.mark.parametrize("scheme", list(LEAVES))
def test_each_row_of_an_m40_call_is_bit_for_bit_the_row_alone(scheme):
    _, pleaf, k = _leaf(scheme)
    rng = np.random.default_rng(4)
    g, m = 3, 40
    experts = np.array([1, 4, 1], np.int32)
    rows = np.array([40, 13, 27], np.int32)
    x = torch.from_numpy(rng.standard_normal((g, m, k)).astype(
        np.float32)).to(torch.bfloat16)
    w = (pleaf.packed, pleaf.scales, pleaf.scheme)
    big = PM.packed_gemv_grouped_ordered(x, *w, torch.from_numpy(experts),
                                         torch.from_numpy(rows))
    one = torch.ones(1, dtype=torch.int32)
    for gi in range(g):
        for j in range(rows[gi]):
            alone = PM.packed_gemv_grouped_ordered(
                x[gi:gi + 1, j:j + 1], *w,
                torch.from_numpy(experts[gi:gi + 1]), one)
            assert torch.equal(alone[0, 0], big[gi, j])


@pytest.mark.parametrize("m", [1, 8, 9, 40])
def test_route_is_by_m_alone(monkeypatch, m):
    """On CUDA tensors ``grouped_quantized_matmul`` launches grouped K1 up
    to 8 rows a group and grouped K2 past them (never a plain version):
    the wrappers are replaced by recorders here."""
    called = []
    for name in ("packed_gemv_grouped", "packed_matmul_grouped"):
        monkeypatch.setattr(ops, name, lambda *a, _n=name: called.append(_n)
                            or torch.zeros(a[0].shape[:2] + (8,)))
    leaf = C.QuantMaker(0, device="cpu").dense("moe.w_up", 64, 8, "awq_int4",
                                               experts=3)
    x = torch.zeros((2, m, 64), dtype=torch.bfloat16)
    ids = torch.tensor([0, 2], dtype=torch.int32)
    ops.grouped_quantized_matmul(x, leaf, ids, torch.ones(2,
                                                          dtype=torch.int32))
    assert called == ["packed_gemv_grouped" if m <= 8
                      else "packed_matmul_grouped"]


@pytest.mark.parametrize("m", [1, 10, 40])
@pytest.mark.parametrize("leaf", EXPERT_LEAVES,
                         ids=lambda v: "x".join(map(str, v[2:4])))
def test_the_body_takes_the_reference_moe_expert_leaves(leaf, m):
    arch, e, k, n, scheme = leaf
    assert PM.grouped_refusal(m, e, k, n, 1024, 2048,
                              get_scheme(scheme)) is None


@pytest.mark.parametrize("case", ["n_not_4", "words_unaligned",
                                  "scales_unaligned", "experts", "group"])
def test_a_stack_the_body_refuses_raises_with_its_shape(case):
    sch = get_scheme("awq_int4")
    m, e, k, n, wp, sp = 20, 128, 2048, 768, 1024, 2048
    if case == "n_not_4":
        n = 1022
    elif case == "words_unaligned":
        wp += 4
    elif case == "scales_unaligned":
        sp += 8
    elif case == "experts":
        e = 513
    else:
        sch = dataclasses.replace(sch, group_size=3 * 32)
        k = 1536
    why = PM.grouped_refusal(m, e, k, n, wp, sp, sch)
    assert why is not None and f"{e} experts of {k} x {n}" in why
    assert "M = 20" in why
