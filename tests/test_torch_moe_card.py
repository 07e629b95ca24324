"""The MoE path on the card (``gpu``; this file imports no JAX): the
expert-grouped K1 / K2 kernels (one persistent body) against their plain
version (empty groups, repeated experts, rows past a group's count
exactly zero, one launch a call), against their twin in the body's order,
a row's output bit for bit the same whatever shares its launch (decode
pairs at M = 1; buffers of M = 10, 17 and 40) and at M = 1 as inside an
M > 8 launch, and past one launch's 6144 rows of x; and qwen3-moe-smoke
with the port's own seeded weights served through the kernels, every
request equal to itself served alone."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.packed_matmul import (packed_gemv_grouped,
                                               packed_gemv_grouped_ordered,
                                               packed_grouped_plain,
                                               packed_matmul_grouped)
from repro_torch.models import transformer as T
from repro_torch.models.common import QuantMaker
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,k,n", [("awq_int4", 512, 256),
                                        ("mxfp4", 256, 96),
                                        ("fp8", 256, 128)])
@pytest.mark.parametrize("m", [1, 3, 8, 10, 17])
def test_grouped_kernels_match_plain(cuda_device, scheme, k, n, m):
    gen = torch.Generator(cuda_device).manual_seed(m)
    leaf = QuantMaker(1, device=cuda_device).dense("moe.w_up", k, n, scheme,
                                                   experts=6)
    g = 12
    experts = torch.randint(0, 6, (g,), generator=gen, device=cuda_device,
                            dtype=torch.int64).to(torch.int32)
    rows = torch.randint(0, m + 1, (g,), generator=gen, device=cuda_device,
                         dtype=torch.int64).to(torch.int32)
    rows[0] = 0
    x = torch.randn((g, m, k), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    args = (x, leaf.packed, leaf.scales, leaf.scheme, experts, rows)
    want = packed_grouped_plain(*args)
    live = torch.arange(m, device=cuda_device)[None, :] < rows[:, None]
    fns = [packed_matmul_grouped] + ([packed_gemv_grouped] if m <= 8 else [])
    for fn in fns:
        before = ops.launch_counts()[fn.__name__]
        got = fn(*args)
        torch.cuda.synchronize()
        assert ops.launch_counts()[fn.__name__] == before + 1
        torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-3)
        assert (got[~live] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,k,n", [("awq_int4", 1024, 256),
                                        ("mxfp4", 256, 96),
                                        ("fp8", 512, 128),
                                        ("awq_int4", 768, 2048)])
def test_grouped_gemv_row_is_free_of_its_batch_mates(cuda_device, scheme, k,
                                                      n):
    """Decode-style pairs (8 rows x 4 experts, M = 1): each row's 4 pairs
    launched alone give the G = 32 launch's rows bit for bit, and all of
    them match the ordered twin (f32 rounding apart)."""
    gen = torch.Generator(cuda_device).manual_seed(3)
    leaf = QuantMaker(2, device=cuda_device).dense("moe.w_up", k, n, scheme,
                                                   experts=16)
    experts = torch.stack([torch.randperm(16, generator=gen,
                                          device=cuda_device)[:4]
                           for _ in range(8)]).reshape(-1).to(torch.int32)
    rows = torch.ones(32, dtype=torch.int32, device=cuda_device)
    x = torch.randn((32, 1, k), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    args = (leaf.packed, leaf.scales, leaf.scheme)
    big = packed_gemv_grouped(x, *args, experts, rows)
    for i in range(0, 32, 4):
        alone = packed_gemv_grouped(x[i:i + 4], *args, experts[i:i + 4],
                                    rows[i:i + 4])
        assert torch.equal(alone, big[i:i + 4])
    torch.testing.assert_close(
        big, packed_gemv_grouped_ordered(x, *args, experts, rows),
        rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,k,n", [("awq_int4", 1024, 256),
                                        ("mxfp4", 256, 96),
                                        ("fp8", 512, 128),
                                        ("awq_int4", 768, 2048)])
@pytest.mark.parametrize("m", [10, 17, 40])
def test_grouped_matmul_row_is_free_of_batch_mates_and_m(cuda_device, scheme,
                                                          k, n, m):
    """Capacity-buffer groups of M rows (12 groups over 6 experts, some
    repeated, one empty): each half of the groups launched alone gives the
    G = 12 launch's rows bit for bit, each live row launched alone in a
    group of one row (grouped K1, items of 8) gives its row bit for bit,
    and all of them match the ordered twin (f32 rounding apart)."""
    gen = torch.Generator(cuda_device).manual_seed(m)
    leaf = QuantMaker(4, device=cuda_device).dense("moe.w_up", k, n, scheme,
                                                   experts=6)
    g = 12
    experts = torch.randint(0, 6, (g,), generator=gen, device=cuda_device,
                            dtype=torch.int64).to(torch.int32)
    rows = torch.randint(0, m + 1, (g,), generator=gen, device=cuda_device,
                         dtype=torch.int64).to(torch.int32)
    rows[3] = 0
    x = torch.randn((g, m, k), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    args = (leaf.packed, leaf.scales, leaf.scheme)
    big = packed_matmul_grouped(x, *args, experts, rows)
    for h in (slice(0, 6), slice(6, 12)):
        half = packed_matmul_grouped(x[h], *args, experts[h], rows[h])
        assert torch.equal(half, big[h])
    live = (torch.arange(m, device=cuda_device)[None, :]
            < rows[:, None]).nonzero()
    alone = packed_gemv_grouped(
        x[live[:, 0], live[:, 1]][:, None], *args, experts[live[:, 0]],
        torch.ones(len(live), dtype=torch.int32, device=cuda_device))
    assert torch.equal(alone[:, 0], big[live[:, 0], live[:, 1]])
    torch.testing.assert_close(
        big, packed_gemv_grouped_ordered(x, *args, experts, rows),
        rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_grouped_gemv_past_one_launch_of_rows(cuda_device):
    """800 groups of M = 8 (6400 rows of x) take two launches of whole
    groups, and match the plain version."""
    gen = torch.Generator(cuda_device).manual_seed(4)
    leaf = QuantMaker(3, device=cuda_device).dense("moe.w_up", 256, 64,
                                                   "awq_int4", experts=8)
    g, m = 800, 8
    experts = torch.randint(0, 8, (g,), generator=gen, device=cuda_device,
                            dtype=torch.int64).to(torch.int32)
    rows = torch.randint(0, m + 1, (g,), generator=gen, device=cuda_device,
                         dtype=torch.int64).to(torch.int32)
    x = torch.randn((g, m, 256), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    args = (x, leaf.packed, leaf.scales, leaf.scheme, experts, rows)
    before = ops.launch_counts()["packed_gemv_grouped"]
    got = packed_gemv_grouped(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["packed_gemv_grouped"] == before + 2
    torch.testing.assert_close(got, packed_grouped_plain(*args), rtol=2e-3,
                               atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_moe_smoke_serves_each_request_as_alone_on_card(cuda_device, tier):
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    with torch.no_grad():
        params = T.build_params(cfg, QuantMaker(0, device=cuda_device))
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=64, n_slots=4, prefill_chunk=16, max_burst=8,
        policy=PrecisionPolicy(kv=tier), device=str(cuda_device)))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (9, 20, 14, 31)]
    ops.reset_launch_counts()
    sched = Scheduler(engine)
    reqs = [sched.submit(Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=12))) for p in prompts]
    sched.run(max_steps=400)
    rows = ops.grouped_launch_counts()
    assert rows.get("packed_gemv_grouped:M=1", 0) > 0       # decode pairs
    assert rows.get("packed_gemv_grouped:M=5", 0) > 0       # chunk of 16
    for r, p in zip(reqs, prompts):
        solo = engine.generate({"tokens": p[None]},
                               max_new_tokens=12)["generated"][0]
        assert list(solo) == r.output_tokens
