"""corroguard admission control: per-route-class concurrency + queue
limits for the serving plane (docs/overload.md).

The reference survives swamped nodes by shedding at the edges — bounded
channels drop, HTTP returns 503, subscribers get disconnected — instead
of queueing without bound until latency diverges. This module is the
policy surface for our port's host plane: every HTTP route (except the
control plane — health, readiness, metrics must answer precisely when
the node is drowning) and every PG-wire connection passes through one
:class:`AdmissionController` shared by :class:`~corrosion_tpu_torch.api.http.
ApiServer` and :class:`~corrosion_tpu_torch.pg.PgServer`.

Policy (config ``[serve]``, :class:`~corrosion_tpu_torch.config.ServeConfig`):
each route class admits at most ``max_inflight`` concurrent requests;
up to ``max_queue`` more may wait ``queue_wait`` seconds for a slot;
everything past that is shed with 503 + ``Retry-After``. The hint is
not a constant: it is derived from the LIVE latency histograms
(``corro.http.request.seconds`` / ``corro.pg.query.seconds``) as
p95 × (requests ahead of you), clamped to ``[1, retry_after_cap]`` —
an overloaded node quotes a wait proportional to how overloaded it
actually is. ``max_inflight <= 0`` disables the guard entirely (the
unguarded plane the overload bench drives to the breaking point).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

from corrosion_tpu_torch.config import ServeConfig
from corrosion_tpu_torch.utils.metrics import (
    REGISTRY,
    Registry,
    aggregate_histograms,
    histogram_quantile,
)

#: the route classes admission partitions the plane into. "write" and
#: "read" are one-shot requests; "stream" tickets are held for the whole
#: NDJSON stream; "pg" tickets are held for the whole wire connection.
ROUTE_CLASSES = ("write", "read", "stream", "pg")

#: latency family each class derives its Retry-After from
_LATENCY_SOURCE = {
    "write": "corro.http.request.seconds",
    "read": "corro.http.request.seconds",
    "stream": "corro.http.request.seconds",
    "pg": "corro.pg.query.seconds",
}


def route_class(route: str, method: str) -> Optional[str]:
    """Map a templated route label (``route_label`` form) + method to
    its admission class — ``None`` is the control plane, never gated."""
    if route in ("/v1/health", "/v1/ready", "/metrics"):
        return None
    if route.startswith("/v1/subscriptions") or route.startswith(
            "/v1/updates"):
        return "stream"
    if method == "POST" and route in ("/v1/transactions", "/v1/migrations"):
        return "write"
    return "read"


class AdmissionController:
    """Shared per-route-class admission state.

    ``admit(cls)`` returns True (slot held — pair with ``release(cls)``
    in a finally) or False (shed). A full class queues the caller on a
    condition variable for at most ``queue_wait`` seconds when fewer
    than ``max_queue`` others are already waiting; timing out or finding
    the waiting room full both shed. Counters: ``corro.admission.
    admitted_total`` / ``rejected_total`` / ``queued_total`` plus the
    ``corro.admission.inflight`` and ``corro.admission.queue.depth``
    level gauges, all labelled ``{class}``.
    """

    def __init__(self, cfg: Optional[ServeConfig] = None,
                 registry: Registry = REGISTRY):
        self.cfg = cfg or ServeConfig()
        self.registry = registry
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._inflight = {c: 0 for c in ROUTE_CLASSES}
        self._waiting = {c: 0 for c in ROUTE_CLASSES}
        # retry_after memo: deriving the hint snapshots the registry,
        # and rejects are exactly the path that must stay cheap under
        # overload — recompute at most every 0.25 s per class
        self._ra_memo = {}  # cls -> (monotonic_ts, seconds)

    @property
    def enabled(self) -> bool:
        return self.cfg.max_inflight > 0

    def capacity(self, cls: str) -> int:
        """Concurrency cap for a class. ``stream`` and ``pg`` tickets
        are held for the whole stream / wire connection, so they get
        ``max_streams`` when set (> 0) rather than starving one-shot
        requests out of ``max_inflight``."""
        if cls in ("stream", "pg") and self.cfg.max_streams > 0:
            return self.cfg.max_streams
        return self.cfg.max_inflight

    def admit(self, cls: str) -> bool:
        """Take a slot in ``cls`` (True) or get shed (False)."""
        if not self.enabled:
            return True
        reg = self.registry
        cap = self.capacity(cls)
        deadline = None
        with self._cv:
            queued = False
            while self._inflight[cls] >= cap:
                if not queued:
                    if self._waiting[cls] >= self.cfg.max_queue:
                        self._reject_locked(cls)
                        return False
                    queued = True
                    self._waiting[cls] += 1
                    reg.counter("corro.admission.queued_total", 1.0,
                                {"class": cls})
                    reg.gauge("corro.admission.queue.depth",
                              float(self._waiting[cls]), {"class": cls})
                    deadline = time.monotonic() + self.cfg.queue_wait
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    # timed out waiting for a slot: leave the queue, shed
                    self._waiting[cls] -= 1
                    reg.gauge("corro.admission.queue.depth",
                              float(self._waiting[cls]), {"class": cls})
                    self._reject_locked(cls)
                    return False
            if queued:
                self._waiting[cls] -= 1
                reg.gauge("corro.admission.queue.depth",
                          float(self._waiting[cls]), {"class": cls})
            self._inflight[cls] += 1
            reg.counter("corro.admission.admitted_total", 1.0,
                        {"class": cls})
            reg.gauge("corro.admission.inflight",
                      float(self._inflight[cls]), {"class": cls})
        return True

    def release(self, cls: str) -> None:
        if not self.enabled:
            return
        with self._cv:
            self._inflight[cls] -= 1
            self.registry.gauge("corro.admission.inflight",
                                float(self._inflight[cls]), {"class": cls})
            self._cv.notify()

    def _reject_locked(self, cls: str) -> None:
        self.registry.counter("corro.admission.rejected_total", 1.0,
                              {"class": cls})

    # --- Retry-After derivation ------------------------------------------
    def retry_after(self, cls: str) -> int:
        """Whole seconds a shed client should wait before retrying:
        live p95 service time × (requests ahead of it — inflight plus
        waiters of its class), clamped to ``[1, retry_after_cap]``. An
        empty histogram (cold plane) quotes the 1 s floor."""
        now = time.monotonic()
        with self._mu:
            memo = self._ra_memo.get(cls)
            ahead = self._inflight.get(cls, 0) + self._waiting.get(cls, 0)
        if memo is not None and now - memo[0] < 0.25:
            p95 = memo[1]
        else:
            agg = aggregate_histograms(self.registry.snapshot(),
                                       _LATENCY_SOURCE[cls])
            p95 = histogram_quantile(agg, 0.95)
            with self._mu:
                self._ra_memo[cls] = (now, p95)
        hint = p95 * max(1, ahead)
        return int(min(self.cfg.retry_after_cap,
                       max(1.0, math.ceil(hint))))
