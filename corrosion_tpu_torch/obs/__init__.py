"""The soak's observability plane and the state audit (port of
``corrosion_tpu/obs/``), threaded through
``resilience.segments.run_segmented``, ``Agent.soak`` and the ``soak``
subcommand:

- :mod:`~corrosion_tpu_torch.obs.flight`: the **FlightRecorder**
  (crash-safe line-atomic NDJSON segment records and
  :func:`replay_flight_record`) and the **SoakObserver** that bundles the
  recorder, the metrics bridge and an optional standalone Prometheus
  listener per run;
- :mod:`~corrosion_tpu_torch.obs.bridge`: the **metrics bridge** that
  drains each segment's infos into a ``utils.metrics.Registry`` plus the
  ``corro.soak.*`` series, so ``/metrics`` shows a soak advancing;
- :mod:`~corrosion_tpu_torch.obs.memory`: the per-table bytes audit behind
  the ``corro.mem.*`` gauges and ``/v1/obs/memory``, and its static
  projection (``static_report``, ``projected_bytes``, ``mem-report``);
- :mod:`~corrosion_tpu_torch.obs.spans`: pipeline spans (with optional
  ``torch.profiler`` labels) around segment dispatch, the carry's host
  copy and checkpoint serialize.

Config surface: ``[obs] flight_path / prometheus_port / jax_profile``
(``config.ObsConfig``; ``jax_profile`` keeps the JAX package's name and
labels ``torch.profiler`` traces here).
"""

from corrosion_tpu_torch.obs.bridge import MetricsBridge
from corrosion_tpu_torch.obs.flight import (
    FLIGHT_SCHEMA_VERSION,
    FlightRecorder,
    SoakObserver,
    make_observer,
    replay_flight_record,
)
from corrosion_tpu_torch.obs.memory import (
    memory_report,
    publish_memory_gauges,
    state_bytes,
)
from corrosion_tpu_torch.obs.spans import pipeline_span

__all__ = [
    "FLIGHT_SCHEMA_VERSION",
    "FlightRecorder",
    "MetricsBridge",
    "SoakObserver",
    "make_observer",
    "memory_report",
    "pipeline_span",
    "publish_memory_gauges",
    "replay_flight_record",
    "state_bytes",
]
