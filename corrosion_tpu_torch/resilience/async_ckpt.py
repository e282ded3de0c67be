"""Asynchronous, double-buffered segment checkpointing (port of
``corrosion_tpu/resilience/async_ckpt.py``).

Split of work per segment boundary:

- **hot loop (synchronous)**: ``.cpu()`` of every state leaf, into host
  tensors the writer owns. This is the only stall; it is bounded by the
  device-to-host transfer of the carry.
- **writer thread (overlapped)**: serialization, SHA-256, manifest
  write, ``LATEST`` pointer and retention pruning
  (:func:`write_segment_checkpoint`, crash-consistent), while the next
  segment runs.

Commit order: the checkpoint directory first, then ``LATEST``, then
pruning, which never deletes the pointer's target. A crash can lose the
one checkpoint still in flight on the writer (the queue is depth-1), so
at most one extra segment of work.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, NamedTuple, Optional

from corrosion_tpu_torch.checkpoint import save_state_checkpoint
from corrosion_tpu_torch.resilience.retention import (
    prune_checkpoints,
    update_latest,
)
from corrosion_tpu_torch.utils import logger


def write_segment_checkpoint(cfg, state, key_json: dict, completed: int,
                             root: str, keep_last: int, db=None) -> str:
    """Commit one segment checkpoint (crash-consistent ordering).

    ``state`` is a state on any device (the soak runner's host copies).
    ``key_json`` is the serialized carried PRNG key
    (``segments._key_to_json``); ``db``, when given, is the host database
    the checkpoint carries (an agent's soak)."""
    from corrosion_tpu_torch.utils.tracing import span

    name = f"seg-{completed:08d}"
    # on the async writer this span runs overlapped with the next
    # segment's soak.segment.dispatch
    with span("soak.ckpt.serialize", warn_seconds=30.0, round=completed):
        path = save_state_checkpoint(
            cfg, state, completed, path=os.path.join(root, name),
            extra={"soak": {"completed_rounds": completed, "key": key_json}},
            db=db,
        )
    # pointer moves only AFTER the directory is fully committed; pruning
    # runs last so the recovery point is never the one being deleted
    update_latest(root, name)
    prune_checkpoints(root, keep_last)
    logger.info("soak checkpoint at round %d -> %s", completed, path)
    return path


class _Job(NamedTuple):
    state: object  # host state (owned CPU tensors)
    key_json: dict
    completed: int
    seg_index: int  # the submitting segment's ordinal in this run


class AsyncCheckpointWriter:
    """Single background writer with a depth-1 queue (double buffering).

    The writer holds at most two snapshots, one being written and one
    waiting; :meth:`submit` blocks while one is waiting (backpressure),
    which bounds host memory and keeps ``LATEST`` updates ordered. A
    write failure is re-raised on the next :meth:`submit` or on
    :meth:`close` — the soak must not keep running believing checkpoints
    are landing."""

    def __init__(self, cfg, root: str, keep_last: int = 3, db=None,
                 progress: Optional[Callable[[], int]] = None):
        self._cfg = cfg
        self._db = db
        self._root, self._keep_last = root, keep_last
        # reports the runner's current segment ordinal; a write that
        # finishes after the runner moved past its segment genuinely
        # overlapped compute
        self._progress = progress or (lambda: 0)
        self._q: "queue.Queue[Optional[_Job]]" = queue.Queue(maxsize=1)
        # the error handoff crosses threads (worker sets, submitter
        # clears): guard it
        self._mu = threading.Lock()
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None
        self.io_seconds = 0.0
        self.written = 0
        self.overlapped = 0
        self._thread = threading.Thread(target=self._run, name="corro-async-ckpt")
        self._thread.start()

    def _raise_pending(self) -> None:
        with self._mu:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "async checkpoint write failed; the previous segment has "
                "no committed recovery point"
            ) from err

    def submit(self, state, key_json: dict, completed: int,
               seg_index: int) -> None:
        """Queue one snapshot for writing. Blocks while an earlier
        snapshot is still waiting for the writer (backpressure)."""
        self._raise_pending()
        self._q.put(_Job(state, key_json, completed, seg_index))

    def drain(self) -> None:
        """Block until every submitted snapshot is committed (the
        synchronous mode: submit, then drain). Re-raises a write
        failure."""
        self._q.join()
        self._raise_pending()

    def close(self) -> Optional[str]:
        """Drain outstanding writes, stop the worker, and return the
        newest committed checkpoint path. Re-raises a pending write
        failure."""
        self._q.put(None)
        self._thread.join()
        self._raise_pending()
        return self.last_path

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                t0 = time.perf_counter()
                self.last_path = write_segment_checkpoint(
                    self._cfg, job.state, job.key_json,
                    job.completed, self._root, self._keep_last, self._db,
                )
                self.io_seconds += time.perf_counter() - t0
                self.written += 1
                if self._progress() > job.seg_index:
                    self.overlapped += 1
            except BaseException as exc:  # noqa: BLE001 — surfaced on submit/close
                logger.exception(
                    "async checkpoint write for round %d failed",
                    job.completed,
                )
                with self._mu:
                    self._error = exc
            finally:
                self._q.task_done()
