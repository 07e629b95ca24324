"""Speculative decoding on the card (``gpu``; this file imports no JAX):
granite-smoke with the port's own seeded weights, served through the CUDA
kernels, emits the same tokens with speculation on as with it off, greedy
and temperature rows, slab and paged pools, with K1-K4 launched."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.common import QuantMaker
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine, SpecConfig)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _serve(engine, prompts, spec, temp):
    sched = Scheduler(engine, spec=spec)
    reqs = [sched.submit(Request(prompt=p, id=i, sampling=SamplingParams(
        temperature=temp, max_new_tokens=17, seed=13)))
        for i, p in enumerate(prompts)]
    sched.run(max_steps=600)
    assert all(r.is_finished for r in reqs)
    return [list(r.output_tokens) for r in reqs], sched


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_spec_equals_plain_decode_on_card(cuda_device, paged):
    cfg = get_config("granite-8b", smoke=True)
    with torch.no_grad():
        params = T.build_params(cfg, QuantMaker(0, device=cuda_device))
    # chunks of 16 rows take K2 (prefill, the draft's catch-up), decode
    # rows K1
    engine = ServingEngine(cfg, params, ServeConfig(
        max_len=48, n_slots=4, prefill_chunk=16, max_burst=8, paged=paged,
        device=str(cuda_device)))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (9, 6, 11, 14)]
    for temp in (0.0, 0.8):
        plain, _ = _serve(engine, prompts, None, temp)
        ops.reset_launch_counts()
        got, sched = _serve(engine, prompts, SpecConfig(), temp)
        launches = ops.launch_counts()
        assert got == plain, temp
        m = sched.metrics
        assert m.spec_rounds > 0 and m.spec_tokens_accepted > 0
        assert m.total_new_tokens == (len(m.ttft) + m.decode_tokens_emitted
                                      + m.spec_tokens_emitted)
        for name in ("packed_gemv", "packed_matmul", "decode_attention_bf16",
                     "decode_attention_quant"):
            assert launches[name] > 0, name
