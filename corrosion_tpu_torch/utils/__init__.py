"""Host-side utilities of the port (copies of ``corrosion_tpu/utils/``
with their imports pointed here): the retry policy, the hybrid logical
clock, tracked locks, lifecycle helpers, metrics, assertions and tracing.
``logger`` is the package's logger (``utils/tracing.py``)."""

from corrosion_tpu_torch.utils.tracing import logger  # noqa: F401
