"""Runtime support of the port (serving-side fault tolerance)."""
from .fault_tolerance import RetryBudget, StepFault  # noqa: F401
