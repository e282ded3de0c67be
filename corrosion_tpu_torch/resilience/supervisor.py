"""Watchdog supervisor: deadline-and-retry around device dispatch (port
of ``corrosion_tpu/resilience/supervisor.py``).

A lost device, a preempted machine, or a wedged dispatch all present the
same way to the host: the dispatch call either raises a transient runtime error or never
returns. The supervisor wraps dispatch with

- a **deadline**: the call runs on a worker thread; if it has not
  completed within ``deadline_seconds`` the supervisor raises
  :class:`DispatchTimeout` (the abandoned thread is daemonic — a truly
  wedged dispatch cannot be cancelled, only orphaned);
- **jittered retries** via :func:`corrosion_tpu_torch.utils.backoff.retry_call`
  on the shared :class:`~corrosion_tpu_torch.utils.backoff.Backoff` policy —
  the same 1 s -> 15 s shape the reference's sync loop uses;
- **graceful abort**: when retries are exhausted,
  :class:`SupervisorAborted` propagates and the caller stops cleanly,
  leaving the last committed checkpoint as the recovery point.

The supervised call must finish its device work inside the deadline:
the soak runner and the agent synchronise the device inside it
(``torch.cuda.synchronize``), so a wedged card shows up as a missed
deadline and not at the next read. The agent binds its tripwire as the
abort predicate and the interruptible sleep (:meth:`Supervisor.bind_abort`),
and ``/v1/health`` reads ``state`` and :meth:`Supervisor.retry_after_seconds`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from corrosion_tpu_torch.utils import logger
from corrosion_tpu_torch.utils.backoff import Backoff, retry_call


#: exception types treated as transient: deadline misses and device or
#: runtime hiccups (torch surfaces CUDA errors as RuntimeError subclasses)
RETRY_ON = (TimeoutError, ConnectionError, OSError, RuntimeError)


class DispatchTimeout(TimeoutError):
    """A supervised call missed its deadline."""


class SupervisorAborted(RuntimeError):
    """Retries exhausted; the supervised workload must stop at the last
    good checkpoint."""


class _AbortPassthrough(BaseException):
    """Carrier that moves a SupervisorAborted raised INSIDE a supervised
    call past retry_call's ``except`` (which would otherwise retry it as
    a RuntimeError)."""

    def __init__(self, exc: SupervisorAborted):
        self.exc = exc


class Supervisor:
    """Deadline + retry wrapper for device dispatch.

    ``state``: ``idle`` -> ``running`` -> (``backoff`` -> ``running``)* ->
    ``idle`` on success, or ``aborted`` once retries are exhausted."""

    def __init__(
        self,
        deadline_seconds: Optional[float] = None,
        backoff: Optional[Backoff] = None,
        sleep: Callable[[float], object] = time.sleep,
    ):
        self.deadline_seconds = deadline_seconds
        self.backoff = backoff or Backoff(
            min_wait=1.0, max_wait=15.0, max_retries=4
        )
        self._sleep = sleep
        self._abort: Optional[Callable[[], bool]] = None
        # the round thread writes the state, /v1/health reads it on an
        # HTTP thread: both go through _mu
        self._mu = threading.Lock()
        self._state = "idle"
        self._retry_at = 0.0  # wall-clock time of the next attempt
        self.retries = 0  # total retries over the supervisor's lifetime
        self.aborts = 0

    # --- observable surface (feeds /v1/health) ---------------------------
    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def retry_after_seconds(self) -> float:
        """Seconds until the next attempt (0 when not backing off)."""
        with self._mu:
            if self._state != "backoff":
                return 0.0
            return max(0.0, self._retry_at - time.time())

    def _set(self, state: str, retry_in: float = 0.0) -> None:
        with self._mu:
            self._state = state
            self._retry_at = time.time() + retry_in

    def bind_abort(self, fn: Callable[[], bool],
                   sleep: Optional[Callable[[float], object]] = None,
                   ) -> "Supervisor":
        """Bind the abort predicate and, when given, an interruptible
        sleep: the agent ties both to its tripwire, so shutdown never sits
        out a backoff delay. Returns the supervisor."""
        with self._mu:
            self._abort = fn
            if sleep is not None:
                self._sleep = sleep
        return self

    # --- the wrapper -----------------------------------------------------
    def call(self, fn: Callable, *args, label: str = "dispatch", **kwargs):
        """Run ``fn`` under the deadline, retrying transient failures on
        the jittered policy; raises :class:`SupervisorAborted` once the
        policy is exhausted (or the bound abort predicate trips)."""

        def attempt():
            self._set("running")
            try:
                return self._with_deadline(fn, args, kwargs, label)
            except SupervisorAborted as e:
                # an inner supervised workload already aborted: never
                # re-run it, although it subclasses RuntimeError. BaseException carrier slips
                # past retry_call's except clause.
                raise _AbortPassthrough(e) from None

        def on_retry(exc, delay, attempt_no):
            self.retries += 1
            self._set("backoff", retry_in=delay)
            logger.warning(
                "supervisor: %s failed (%s: %s); retry %d in %.1fs",
                label, type(exc).__name__, exc, attempt_no, delay,
            )

        try:
            result = retry_call(
                attempt,
                backoff=self.backoff,
                retry_on=RETRY_ON,
                sleep=self._sleep,
                abort=self._abort,
                on_retry=on_retry,
            )
        except _AbortPassthrough as w:
            self._set("aborted")
            self.aborts += 1
            raise w.exc
        except RETRY_ON as e:
            self._set("aborted")
            self.aborts += 1
            raise SupervisorAborted(
                f"{label}: retries exhausted ({type(e).__name__}: {e}); "
                f"recover from the last committed checkpoint"
            ) from e
        except BaseException:
            # non-retryable (ValueError from a bad state, Keyboard-
            # Interrupt, ...): nothing is executing anymore — the state
            # must not stay stuck at "running"
            self._set("idle")
            raise
        self._set("idle")
        return result

    def _with_deadline(self, fn: Callable, args, kwargs, label: str):
        if self.deadline_seconds is None:
            return fn(*args, **kwargs)
        # one throwaway daemon thread per attempt: a timed-out dispatch
        # cannot be cancelled, only orphaned — and it must not block
        # interpreter exit or poison later attempts
        box: dict = {}
        done = threading.Event()

        def run():
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — relayed to the caller
                box["exc"] = e
            finally:
                done.set()

        # a daemon thread: a wedged dispatch never finishes and must not
        # hold up interpreter exit
        threading.Thread(
            target=run, daemon=True, name=f"corro-supervised-{label}"
        ).start()
        if not done.wait(self.deadline_seconds):
            raise DispatchTimeout(
                f"{label} missed its {self.deadline_seconds:.1f}s deadline"
            )
        if "exc" in box:
            raise box["exc"]
        return box["result"]
