"""Speculative decoding on the paged KV pool (the checks of
``tests/test_torch_spec.py``): spec on equals spec off bit for bit, greedy
and seeded temperature, with the S-wide verify window pinned before each
dispatch and no page leaked; the port's scheduler against the reference's
under the serving contract, its per-round log equal up to the first
parting; a killed or poisoned verify recovers as the reference's does."""
import pytest

from test_torch_spec import (_spec_equals_plain,  # noqa: F401
                             _spec_matches_reference, _verify_fault_recovers,
                             sides, weights)


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "temperature"])
def test_spec_equals_plain_decode_paged(weights, sides, temp):
    _spec_equals_plain(weights, sides, True, temp)


def test_scheduler_matches_reference_paged(weights, sides):
    _spec_matches_reference(weights, sides, True)


@pytest.mark.parametrize("mode", ["injected", "nan"])
def test_verify_fault_recovers_like_reference_paged(weights, sides, mode):
    _verify_fault_recovers(weights, sides, True, mode)
