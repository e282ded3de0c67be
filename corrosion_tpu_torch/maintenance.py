"""DB maintenance loop: periodic durability + host-state housekeeping.

Mirrors the reference's maintenance machinery (SURVEY §2.4): WAL
checkpoint(TRUNCATE) when the WAL grows past a threshold
(``spawn_handle_db_maintenance``, ``agent/handlers.rs:455-540``),
incremental vacuum when the freelist grows (``handlers.rs:398-452``), and
the buffered-meta GC loop (``clear_buffered_meta_loop``,
``util.rs:430-490``).

TPU reframing — the durable artifact is the checkpoint directory, so:

- **auto-checkpoint**: every ``checkpoint_rounds`` rounds, if the cluster
  advanced, write a full checkpoint (the WAL-checkpoint analog: bounded
  recovery replay). Rotated: ``<path>/auto-{a,b}`` alternate so a crash
  mid-write never corrupts the only copy.
- **heap compaction** (round 5, the ``vacuum_db`` analog,
  ``handlers.rs:398-452``): every ``heap_compact_rounds`` rounds — or
  immediately past the soft limit — free heap ids referenced nowhere in
  device state (stable ids, free-list reuse). The warn fires only if the
  heap is STILL past the soft limit after compacting (genuinely that
  many live values).
- **matcher-log GC** runs inline in the pubsub layer (``max_log``); this
  loop reports its sizes as metrics.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from corrosion_tpu_torch.utils.tracing import logger


class MaintenanceLoop:
    def __init__(self, agent, db=None, subs=None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_rounds: int = 512,
                 heap_soft_limit: int = 1_000_000,
                 heap_compact_rounds: int = 256,
                 # above the longest expected streaming reader: an id a
                 # stale snapshot has not dereferenced yet is protected
                 # only by this window (values.py lookup contract)
                 heap_grace_seconds: float = 300.0,
                 interval_seconds: float = 2.0):
        self.agent = agent
        self.db = db
        self.subs = subs
        self.checkpoint_path = checkpoint_path
        self.checkpoint_rounds = checkpoint_rounds
        self.heap_soft_limit = heap_soft_limit
        self.heap_compact_rounds = heap_compact_rounds
        self.heap_grace_seconds = heap_grace_seconds
        # first tick is immediately "due": boot-time compaction settles
        # the post-restore heap before the cadence takes over
        self._last_compact_round = agent.round_no - heap_compact_rounds
        self.interval = interval_seconds
        self._last_ckpt_round = agent.round_no
        # seed rotation AWAY from the newest complete side, so the first
        # write after a restart never overwrites the copy just restored
        self._flip = False
        if checkpoint_path:
            latest = self.latest_auto_checkpoint(checkpoint_path)
            if latest and latest.endswith("auto-a"):
                self._flip = True  # next write goes to auto-b
        self._warned_heap = False
        self._last_members_round = -1
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MaintenanceLoop":
        from corrosion_tpu_torch.utils.lifecycle import spawn_counted

        self._thread = spawn_counted(self._loop, name="corro-db-maintenance")
        return self

    def _loop(self) -> None:
        while not self.agent.tripwire.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — maintenance must not die
                logger.exception("maintenance tick failed")

    def tick(self) -> Optional[str]:
        """One maintenance pass; returns the checkpoint path if one was
        written."""
        written = None
        rounds = self.agent.round_no
        if (self.checkpoint_path
                and rounds - self._last_ckpt_round >= self.checkpoint_rounds):
            from corrosion_tpu_torch.checkpoint import save_checkpoint

            side = "auto-b" if self._flip else "auto-a"
            target = os.path.join(self.checkpoint_path, side)
            # flip/cadence advance only on SUCCESS: a failed write retries
            # the same side (whose manifest save_checkpoint already
            # removed, marking it incomplete) and never touches the other
            written = save_checkpoint(self.agent, db=self.db, path=target)
            self._flip = not self._flip
            self._last_ckpt_round = rounds
            self.agent.metrics.counter("corro.db.checkpoint.count")
            logger.info("auto-checkpoint at round %d -> %s", rounds, target)
        members_path = getattr(self.agent.config.db, "members_path", "")
        if members_path and rounds != self._last_members_round:
            # the __corro_members upsert (foca-state diff persistence,
            # broadcast/mod.rs:814-949): keep the restart-bootstrap list
            # fresh; a booting agent replays it (util.rs:69-130)
            self.agent.persist_members(members_path)
            self._last_members_round = rounds
        if self.db is not None:
            heap = self.db.heap
            live = heap.live_count
            self.agent.metrics.gauge("corro.db.value_heap.len", len(heap))
            self.agent.metrics.gauge("corro.db.value_heap.live", live)
            due = rounds - self._last_compact_round >= self.heap_compact_rounds
            # over-limit triggers an early pass, but spaced — a workload
            # whose LIVE set legitimately exceeds the limit must not pay
            # a full device-state scan every 2 s tick for ~0 freed ids
            spacing = max(1, self.heap_compact_rounds // 8)
            over = (live > self.heap_soft_limit
                    and rounds - self._last_compact_round >= spacing)
            if due or over:
                freed = self.db.compact_heap(
                    grace_seconds=self.heap_grace_seconds)
                self._last_compact_round = rounds
                if freed:
                    self.agent.metrics.counter(
                        "corro.db.value_heap.compacted", freed)
                    logger.info("heap compaction freed %d value ids "
                                "(%d live)", freed, heap.live_count)
                if (heap.live_count > self.heap_soft_limit
                        and not self._warned_heap):
                    # still over AFTER compacting: genuinely that many
                    # live values — the operator must raise the limit
                    self._warned_heap = True
                    logger.warning(
                        "value heap holds %d LIVE values after compaction "
                        "(soft limit %d) — raise the limit or shrink the "
                        "working set", heap.live_count, self.heap_soft_limit,
                    )
        if self.subs is not None:
            for mid in self.subs.ids():
                m = self.subs.get(mid)
                if m is not None:
                    self.agent.metrics.gauge(
                        "corro.subs.change_log.len", len(m._log),
                        labels={"matcher": mid[:8]},
                    )
        return written

    @staticmethod
    def latest_auto_checkpoint(checkpoint_path: str) -> Optional[str]:
        """The newest complete rotated checkpoint, for boot-time resume."""
        sides = MaintenanceLoop._sides_newest_first(checkpoint_path)
        return sides[0] if sides else None

    @staticmethod
    def _sides_newest_first(checkpoint_path: str) -> list:
        found = []
        for side in ("auto-a", "auto-b"):
            p = os.path.join(checkpoint_path, side)
            manifest = os.path.join(p, "manifest.json")
            if os.path.exists(manifest):
                found.append((os.path.getmtime(manifest), p))
        return [p for _, p in sorted(found, reverse=True)]

    @staticmethod
    def resume_latest(agent, checkpoint_path: str, db=None) -> Optional[dict]:
        """Boot-time resume — a thin alias for ``Agent.recover_latest``,
        the ONE recovery path (integrity scan, sim-config gate,
        restore-failure fallback to the next-newest candidate): rotated
        auto-a/auto-b sides and soak segments alike, and a half-written,
        tampered, or config-drifted side can never brick startup or mask
        an older good one. Returns the restored manifest, or None when
        nothing restorable exists."""
        return agent.recover_latest(root=checkpoint_path, db=db)
