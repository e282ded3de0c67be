"""Observability of the port's state (port of ``corrosion_tpu/obs/``):
:mod:`~corrosion_tpu_torch.obs.memory`, the per-table bytes audit behind
the ``corro.mem.*`` gauges and ``/v1/obs/memory``. The soak flight
recorder, the metrics bridge and the pipeline spans are not ported yet."""
