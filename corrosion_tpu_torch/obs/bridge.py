"""Live metrics bridge: segment infos -> the Prometheus registry (port of
``corrosion_tpu/obs/bridge.py``).

The bridge drains each completed soak segment's infos into a
``utils.metrics.Registry`` while the run goes on, through the same
``record_round_info`` key -> ``corro.*`` mapping the agent's round loop
uses, plus the ``corro.soak.*`` progress series, so the standalone
Prometheus listener and the HTTP API's ``/metrics`` both show a soak
advancing.

Per info kind (``utils.metrics.info_series``): counter keys fold their
per-segment sum into the counter (the cumulative scrape value equals the
per-round accumulation); gauge keys (queue occupancy, activity levels)
take the segment's last round.
"""

from __future__ import annotations

from corrosion_tpu_torch.utils.metrics import info_series, record_round_info


class MetricsBridge:
    """Per-run bridge onto one registry (the agent's, or a standalone one
    for a CLI soak)."""

    def __init__(self, registry):
        self.registry = registry

    def on_segment(self, *, completed_rounds: int, rounds: int,
                   seconds: float, info_sum: dict, info_last: dict,
                   stats_delta: dict) -> None:
        reg = self.registry
        reg.counter("corro.soak.rounds_total", rounds)
        reg.counter("corro.soak.segments_total", 1)
        if seconds > 0:
            reg.gauge("corro.soak.rounds_per_s", rounds / seconds)
        reg.histogram("corro.soak.segment.seconds", seconds)
        # this segment's checkpoint pipeline deltas (the stats dict is
        # cumulative; the scrape wants rates and levels)
        stall = stats_delta.get("ckpt_stall_s", 0.0)
        if stall > 0:
            reg.histogram("corro.soak.ckpt.stall.seconds", stall)
        drained = stats_delta.get("ckpt_drain_bytes", 0)
        if drained > 0:
            reg.counter("corro.soak.ckpt.drain.bytes", drained)
        # one merged record_round_info call: counter keys carry the
        # segment's sum, gauge keys its last round
        merged = {}
        for key, (_name, kind) in info_series().items():
            if kind == "counter" and key in info_sum:
                merged[key] = info_sum[key]
            elif kind == "gauge" and key in info_last:
                merged[key] = info_last[key]
        record_round_info(merged, registry=reg)
        # the kernel wrappers' launch counts of this process, per form, as
        # the agent publishes them: /metrics shows the soak's kernels
        from corrosion_tpu_torch.ops.megakernel import FORM_LAUNCHES

        for (kernel, form), count in list(FORM_LAUNCHES.items()):
            reg.gauge("corro.kernel.launches", count,
                      labels={"kernel": kernel, "form": form})

    def on_end(self, *, completed_rounds: int, aborted: bool) -> None:
        reg = self.registry
        reg.gauge("corro.soak.completed.rounds", completed_rounds)
        reg.gauge("corro.soak.aborted", 1.0 if aborted else 0.0)
