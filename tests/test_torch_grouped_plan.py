"""Grouped K1's plan and its plain twins on the CPU (the kernel itself runs
only on a card: ``tests/test_torch_moe_card.py``, ``chip_smoke.py``):

* ``grouped_work_list``, the twin of the work list the kernel builds on
  the device: every (group, row) that holds data covered exactly once, at
  most 8 rows an item, the items of one expert in one run, in expert
  order, rows in (group, row) order, no item for an empty group; at G = 1,
  20 rows on one expert (3 items), all groups empty, the decode layout
  (8 rows x top-8 of 128 experts) and a prefill chunk's capacity buffers;
* ``grouped_gemv_plan``, the kernel's order of sums, a function of the
  leaf alone: stages, warp chunks and folds that tile K and the scale
  groups (narrow and wide leaves), qwen3-moe-30b-a3b's order, and the
  groups it refuses;
* ``packed_gemv_grouped_ordered`` (the kernel's order of sums) against ``packed_grouped_plain`` and against the reference's
  ``packed_gemv`` under ``jax.vmap`` over the groups' experts (Pallas,
  interpret mode) at the packed matmul's rtol 2e-3 / atol 1e-3, for
  awq_int4, mxfp4 and fp8; and bit for bit across batch-mates: a row alone
  equals the same row inside a larger G (other M, other experts).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import declare_execution
from repro.models import common as RC
from repro_torch.kernels import packed_matmul as PM
from repro_torch.models import common as C
from repro_torch.quant.schemes import get_scheme

MM_TOL = dict(rtol=2e-3, atol=1e-3)     # the packed-matmul contract
# (scheme, K, N): awq_int4 in groups of 128 (three ring stages of 32 word
# rows: a group spans two warps' chunks), mxfp4 in 32-groups (stages of 64
# rows, 1.25 of them: the last one's chunks 1-3 past K), fp8 per channel
LEAVES = {"awq_int4": ("awq_int4", 768, 96), "mxfp4": ("mxfp4", 640, 64),
          "fp8": ("fp8", 256, 48),
          # a wide leaf: units of 64 columns, two warps' chunks a column
          "awq_int4_wide": ("awq_int4", 512, 1600)}


def _layout(name, rng):
    """(expert ids, rows, M) of a grouped call."""
    if name == "one_group":
        return np.array([5]), np.array([3]), 4
    if name == "one_expert_20_rows":
        return np.full(20, 4), np.ones(20, int), 1
    if name == "all_empty":
        return rng.integers(0, 16, 12), np.zeros(12, int), 5
    if name == "decode":                    # 8 rows x their top-8 of 128
        return (np.concatenate([rng.permutation(128)[:8] for _ in range(8)]),
                np.ones(64, int), 1)
    if name == "prefill_buffers":           # expert e's buffer in group e
        return np.arange(128), rng.integers(0, 6, 128), 5
    raise ValueError(name)


LAYOUTS = ["one_group", "one_expert_20_rows", "all_empty", "decode",
           "prefill_buffers"]


@pytest.mark.parametrize("name", LAYOUTS)
def test_work_list_covers_each_row_once_in_expert_runs(name):
    rng = np.random.default_rng(1)
    experts, rows, m = _layout(name, rng)
    item_e, item_rows = PM.grouped_work_list(
        torch.tensor(experts, dtype=torch.int32),
        torch.tensor(rows, dtype=torch.int32), m)
    item_e, item_rows = item_e.numpy(), item_rows.numpy()
    want = sorted(g * m + r for g in range(len(rows))
                  for r in range(min(rows[g], m)))
    got = item_rows[item_rows >= 0]
    assert sorted(got.tolist()) == want             # each row exactly once
    counts = (item_rows >= 0).sum(1)
    assert ((counts >= 1) & (counts <= 8)).all()
    # one run of items per distinct expert, in expert order, and only
    # experts that hold rows
    live = sorted(set(experts[rows > 0].tolist()))
    runs = [e for i, e in enumerate(item_e) if i == 0 or item_e[i - 1] != e]
    assert runs == live
    for e in live:
        n = int(rows[experts == e].clip(0, m).sum())
        assert (item_e == e).sum() == -(-n // 8)
    # each item's rows name its expert, in (group, row) order, and only an
    # expert's last item is short
    for i, (e, rr) in enumerate(zip(item_e, item_rows)):
        rr = rr[rr >= 0]
        assert (experts[rr // m] == e).all()
        if i + 1 < len(item_e) and item_e[i + 1] == e:
            assert len(rr) == 8
    flat = item_rows[item_rows >= 0]
    for e in live:
        mine = flat[np.isin(flat // m, np.flatnonzero(experts == e))]
        assert (np.diff(mine) > 0).all()
    if name == "one_expert_20_rows":
        assert len(item_e) == 3 and counts.tolist() == [8, 8, 4]
    if name == "all_empty":
        assert len(item_e) == 0


@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
def test_plan_is_the_leafs_stages_chunks_and_folds(scheme):
    sch = get_scheme(scheme)
    per = 8 if sch.weight_bits == 4 else 4
    for k, n in itertools.product((2048, 768, 1024, 256, 128), (768, 2048)):
        stage_k, chunk_k, fold_k = PM.grouped_gemv_plan(k, n, sch)
        group = min(k, sch.group_size) if sch.group_size > 0 else k
        rows = 32 if (k // per) % 64 and (k // per) % 32 == 0 else 64
        k_warps = 2 if n >= 1536 else 4
        assert (stage_k, chunk_k) == (rows * per, rows // k_warps * per)
        assert fold_k == (k if group == k else min(group, chunk_k))
        # a fold never straddles a scale group or a warp's chunk
        assert group == k or (group % fold_k == 0 and chunk_k % fold_k == 0)
    if scheme == "awq_int4":
        # qwen3-moe-30b-a3b's gate / up and down leaves
        assert PM.grouped_gemv_plan(2048, 768, sch) == (512, 128, 128)
        assert PM.grouped_gemv_plan(768, 2048, sch) == (256, 128, 128)
    # groups that neither divide nor are multiples of a chunk are refused
    odd = dataclasses.replace(sch, group_size=3 * 4 * per)
    with pytest.raises(ValueError, match="scale group"):
        PM.grouped_gemv_plan(1536, 768, odd)
    wide = dataclasses.replace(sch, group_size=2 * 16 * per)
    assert PM.grouped_gemv_plan(1024, 768, wide)[2] == 16 * per


def _leaf(name, n_experts=6):
    scheme, k, n = LEAVES[name]
    leaf = RC.QuantMaker(jax.random.PRNGKey(3)).dense(
        "moe.w_up", (n_experts,), k, n, scheme=scheme)
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


@pytest.mark.parametrize("name", list(LEAVES))
def test_ordered_twin_matches_plain_and_reference_vmap(name):
    declare_execution(kernel="pallas")
    leaf, pleaf, k = _leaf(name)
    rng = np.random.default_rng(7)
    # expert 2 three times (9 rows: two items), an empty group, M = 3
    experts = np.array([3, 2, 0, 2, 5, 2, 1], np.int32)
    rows = np.array([3, 3, 1, 3, 0, 3, 2], np.int32)
    m = 3
    x = rng.standard_normal((len(rows), m, k)).astype(np.float32)
    x *= (np.arange(m)[None, :] < rows[:, None])[..., None]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    args = (xb, pleaf.packed, pleaf.scales, pleaf.scheme,
            torch.from_numpy(experts), torch.from_numpy(rows))
    got = PM.packed_gemv_grouped_ordered(*args)
    plain = PM.packed_grouped_plain(*args)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **MM_TOL)
    want = np.asarray(_ref_grouped(leaf, jnp.asarray(x).astype(jnp.bfloat16),
                                   experts))
    np.testing.assert_allclose(got.numpy(), want, **MM_TOL)
    live = np.arange(m)[None, :] < rows[:, None]
    assert not got.numpy()[~live].any()     # rows past rows[g]: exact 0


@pytest.mark.parametrize("name", list(LEAVES))
def test_ordered_twin_row_is_bit_for_bit_its_batch_mates_free(name):
    _, pleaf, k = _leaf(name)
    rng = np.random.default_rng(8)
    g, m = 12, 3
    experts = rng.integers(0, 6, g).astype(np.int32)
    rows = rng.integers(0, m + 1, g).astype(np.int32)
    rows[4] = 2
    x = torch.from_numpy(rng.standard_normal((g, m, k)).astype(
        np.float32)).to(torch.bfloat16)
    big = PM.packed_gemv_grouped_ordered(
        x, pleaf.packed, pleaf.scales, pleaf.scheme,
        torch.from_numpy(experts), torch.from_numpy(rows))
    # group 4's row 1 alone: G = 1, M = 1
    alone = PM.packed_gemv_grouped_ordered(
        x[4:5, 1:2], pleaf.packed, pleaf.scales, pleaf.scheme,
        torch.from_numpy(experts[4:5]), torch.ones(1, dtype=torch.int32))
    assert torch.equal(alone[0, 0], big[4, 1])
    # the same row among 8 decode-style pairs of other experts
    ids = np.array([experts[4], 0, 1, 2, 3, 4, 5, experts[4]], np.int32)
    xs = torch.cat([x[4:5, 1:2]] + [x[i:i + 1, 0:1] for i in range(7)])
    pairs = PM.packed_gemv_grouped_ordered(
        xs, pleaf.packed, pleaf.scales, pleaf.scheme, torch.from_numpy(ids),
        torch.ones(8, dtype=torch.int32))
    assert torch.equal(pairs[0, 0], big[4, 1])
