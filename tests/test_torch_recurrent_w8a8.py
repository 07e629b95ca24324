"""xlstm-smoke (mLSTM / sLSTM, W8A8; 4 layers, an sLSTM block every 2)
served by the port against the JAX reference on the CPU, the helpers of
``test_torch_recurrent.py`` (split out so xdist's ``--dist loadfile``
runs the two halves on two workers):

* ``forward``: a prefill from an empty cache at S = 32 (the chunked SSD)
  and at S = 20 (the sequential one), then 6 decode steps, teacher-forced
  on the reference's greedy ids, against the reference run op by op
  (``jax.disable_jit()``: jitted, XLA keeps bf16 intermediates in f32 and
  moves int8 activation codes, ROADMAP R6): logits within rtol / atol
  5e-2, greedy ids equal wherever the reference's top-2 gap exceeds 0.1.
  The reference takes its jnp W8A8 route, whose exact int32 sums and
  epilogue are its Pallas kernel's bit for bit
  (``test_torch_ssm.py::test_reference_w8a8_routes_agree``): interpreted
  op by op, the kernel would take most of a minute more.  W8A8 quantizes
  a call's activations with one scale over every row (R10), so both
  sides run the same two-row batch;
* ``ServingEngine.generate`` against the reference's ``generate`` (its
  jitted loop), greedy and at temperature 0.8: ids equal up to each row's
  first parting, which must fall where the reference's top-2 gap (its
  perturbed scores at temperature) is at most 0.1.
"""
import pytest

from repro.kernels.ops import declare_execution
from test_torch_recurrent import generate_vs_reference, teacher_forced


@pytest.mark.parametrize("s", [32, 20], ids=["chunked", "sequential"])
def test_xlstm_forward_matches_reference_op_by_op(s):
    declare_execution(kernel="jnp")
    teacher_forced("xlstm-350m", "bf16", s, seed=50 + s, eager=True)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_xlstm_generate_matches_reference(temperature):
    declare_execution(kernel="pallas")
    got, want, _ = generate_vs_reference("xlstm-350m",
                                         temperature=temperature, seed=4)
    assert got["generated"].shape == (2, 8)
    assert got["finish_reasons"] == want["finish_reasons"]
