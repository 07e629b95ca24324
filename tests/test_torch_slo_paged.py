"""The scenarios of ``tests/test_torch_slo.py`` on the paged KV pool: the
port's scheduler and the reference's, with the same seeded prompts and the
same injected clock, make the same decisions and emit the same tokens under
the serving contract (the checks are that file's)."""
import pytest

from test_torch_slo import (SCENARIOS, _scenario_equals_reference,  # noqa: F401
                            sides, weights)


@pytest.mark.parametrize("paged", [True], ids=["paged"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_equals_reference(weights, sides, scenario, paged):
    _scenario_equals_reference(weights, sides, scenario, paged)
