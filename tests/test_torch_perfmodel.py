"""The port's cost model and retry bookkeeping against the JAX reference's
(host-side arithmetic, no tensors):

* ``launch/roofline.model_params`` counts the parameters of every config
  the port serves, FULL and SMOKE, exactly as the reference's walk of its
  abstract parameter tree (which allocates nothing);
* ``perfmodel.analytical.decode_latency`` equals the reference's to rel
  1e-12 over schemes, designs, the GEMV-engine route, batches, contexts
  and KV bytes per token (bf16 default and the int8 tier's);
* ``gemv_engine_for``, ``mac_distribution``, ``mac_unit_budget`` and the
  FPGA profiles equal the reference's;
* ``RetryBudget`` grants the reference's holds (1, 2, 4, ..., then None).
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.launch.roofline import model_params as ref_model_params
from repro.perfmodel import analytical as RA
from repro.perfmodel import hardware as RH
from repro.runtime.fault_tolerance import RetryBudget as RefRetryBudget
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.roofline import model_params
from repro_torch.perfmodel import analytical as PA
from repro_torch.perfmodel import hardware as PH
from repro_torch.runtime.fault_tolerance import RetryBudget

SCHEMES = ["awq_int4", "w8a8", "fp8", "mxfp4"]


def _int8_kv_bytes_per_token(cfg) -> int:
    """The int8 KV tier's bytes per cached position: per layer, K and V
    codes (one byte each of Hk x Dh) and one f32 scale per head."""
    return 2 * cfg.n_layers * cfg.n_kv_heads * (cfg.head_dim + 4)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_params_equal_reference(arch, smoke):
    assert model_params(get_config(arch, smoke=smoke)) == \
        ref_model_params(ref_config(arch, smoke=smoke))


@pytest.mark.parametrize("kv", ["default", "int8"])
@pytest.mark.parametrize("context", [1, 255, 4096])
@pytest.mark.parametrize("batch", [1, 8, 23])
@pytest.mark.parametrize("engine", ["table", "gemv_engine"])
@pytest.mark.parametrize("design", ["xtramac", "vendor"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_latency_equals_reference(scheme, design, engine, batch,
                                         context, kv):
    cfg, rcfg = get_config("granite-8b"), ref_config("granite-8b")
    kv_bytes = None if kv == "default" else _int8_kv_bytes_per_token(cfg)
    got = PA.decode_latency(
        cfg, scheme, batch=batch, context=context, design=design,
        kv_bytes_per_token=kv_bytes,
        engine_model=PA.gemv_engine_for(scheme) if engine != "table"
        else None)
    want = RA.decode_latency(
        rcfg, scheme, batch=batch, context=context, design=design,
        kv_bytes_per_token=kv_bytes,
        engine_model=RA.gemv_engine_for(scheme) if engine != "table"
        else None)
    assert set(got) == set(want)
    for key in ("t_mem_s", "t_compute_s", "t_total_s"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=0)
    for key in ("bound", "units_quant", "units_bf16"):
        assert got[key] == want[key], key


def test_granite_step_prices_the_serving_policy_reads():
    """The three prices the granite-8b-slo path's thresholds are chosen
    from (awq_int4, xtramac, GEMV engine, context 256): 8.33 ms at batch
    1, 66.6 ms at 8, 191.6 ms at 23 — seconds of the paper's V80 model."""
    cfg = get_config("granite-8b")
    got = [PA.decode_latency(cfg, "awq_int4", batch=b, context=256,
                             design="xtramac",
                             engine_model=PA.gemv_engine_for("awq_int4"))
           ["t_total_s"] for b in (1, 8, 23)]
    np.testing.assert_allclose(got, [8.3284e-3, 66.627e-3, 191.55e-3],
                               rtol=1e-4)


@pytest.mark.parametrize("fpga", ["V80", "U55C"])
@pytest.mark.parametrize("scheme", SCHEMES + ["bf16"])
def test_gemv_engine_for_equals_reference(scheme, fpga):
    got = PA.gemv_engine_for(scheme, getattr(PH, fpga))
    want = RA.gemv_engine_for(scheme, getattr(RH, fpga))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.macs_per_cycle, got.freq_hz, got.n_instances) == \
        (want.macs_per_cycle, want.freq_hz, want.n_instances)


@pytest.mark.parametrize("fpga", ["V80", "U55C"])
def test_fpga_profiles_equal_reference(fpga):
    assert dataclasses.asdict(getattr(PH, fpga)) == \
        dataclasses.asdict(getattr(RH, fpga))


@pytest.mark.parametrize("context", [1, 512, 4096])
@pytest.mark.parametrize("scheme", SCHEMES + ["bf16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mac_distribution_equals_reference(arch, scheme, context):
    got = PA.mac_distribution(get_config(arch), scheme, context)
    want = RA.mac_distribution(ref_config(arch), scheme, context)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)


@pytest.mark.parametrize("fpga", ["V80", "U55C"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_mac_unit_budget_equals_reference(scheme, fpga):
    vendor, _, xtra, _ = PA._DEPLOY[scheme]
    rvendor, _, rxtra, _ = RA._DEPLOY[scheme]
    for mine, theirs in ((vendor, rvendor), (xtra, rxtra)):
        assert PA.mac_unit_budget(mine, getattr(PH, fpga)) == \
            RA.mac_unit_budget(theirs, getattr(RH, fpga))


@pytest.mark.parametrize("max_retries", [0, 1, 2, 3, 5])
def test_retry_budget_holds_equal_reference(max_retries):
    mine, ref = RetryBudget(max_retries), RefRetryBudget(max_retries)
    for key in ("a", 7):
        holds = [mine.record_fault(key) for _ in range(max_retries + 2)]
        assert holds == [ref.record_fault(key)
                         for _ in range(max_retries + 2)]
        assert holds[:max_retries] == [1 << i for i in range(max_retries)]
        assert holds[max_retries:] == [None, None]
        assert mine.n_faults(key) == ref.n_faults(key) == max_retries + 2
        mine.clear(key)
        ref.clear(key)
        assert mine.n_faults(key) == ref.n_faults(key) == 0
    with pytest.raises(ValueError):
        RetryBudget(-1)
