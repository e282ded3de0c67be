"""Happens-before race detection on shared attributes (port of
``corrosion_tpu/analysis/sanitizer/attrs.py``).

FastTrack-lite over the lock-disciplined classes corrolint already
indexes: every instance attribute of a tracked class carries shadow
state — the last write as an epoch ``(tid, clock)`` plus a read map
``tid -> clock`` — and every access checks the other side's epochs
against the accessing thread's vector clock. Two accesses with at
least one write and no happens-before path between them is a race
finding; accesses ordered through ANY instrumented synchronization
(locks, conditions, events, queues, thread start/join, executor
submit) are clean by construction, so the detector needs no lockset
heuristics and no knowledge of WHICH lock guards what.

Only objects *born inside* the sanitized window are tracked
(``__init__`` is patched to register them): a pre-existing object's
synchronization history is invisible, and shadowing it would turn
missing-history into fake races.

Sanctioned unsynchronized sites (GIL-atomic counters, single-reference
swaps) live in ``allowlist.ALLOWED_ATTR_RACES`` with reasons — the
runtime mirror of corrolint's ``unlocked-mutation`` suppressions.
"""

from __future__ import annotations

import _thread
import importlib
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.analysis.sanitizer.allowlist import ALLOWED_ATTR_RACES
from corrosion_tpu_torch.analysis.sanitizer.frames import call_site
from corrosion_tpu_torch.analysis.sanitizer.report import SanFinding

#: the lock-disciplined surface corrolint's lock checkers index — the
#: classes whose shared state the lock checkers argue about statically
TRACKED_CLASSES: Dict[str, Tuple[str, ...]] = {
    "corrosion_tpu_torch.pubsub": (
        "DeltaTracker", "Matcher", "SubsManager", "UpdatesManager",
    ),
    "corrosion_tpu_torch.db.database": ("Database",),
    "corrosion_tpu_torch.resilience.async_ckpt": ("AsyncCheckpointWriter",),
    "corrosion_tpu_torch.resilience.supervisor": ("Supervisor",),
    "corrosion_tpu_torch.agent.core": ("Agent",),
    "corrosion_tpu_torch.utils.hlc": ("HLClock",),
    "corrosion_tpu_torch.utils.metrics": ("Registry",),
}

#: attribute VALUES that are synchronization objects — reading the
#: attribute that holds a lock/queue is not a data access on shared
#: state (the primitive orders its own users)
_SYNC_TYPE_NAMES = frozenset({
    "SanLock", "SanRLock", "TrackedLock", "Condition", "Event",
    "Barrier", "Semaphore", "BoundedSemaphore", "Tripwire",
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "SubQueue",
    "lock", "RLock", "_RLock", "LockRegistry",
})


class _Cell:
    __slots__ = ("write", "reads")

    def __init__(self):
        self.write: Optional[Tuple[int, int, str]] = None  # tid, clock, thread name
        self.reads: Dict[int, Tuple[int, str]] = {}


class AttrRaces:
    def __init__(self, san):
        self._san = san
        self._ilock = _thread.allocate_lock()
        self._shadow: Dict[Tuple[int, str], _Cell] = {}
        #: oid -> its shadow keys, so purging a dead object is
        #: O(its attrs) instead of an O(shadow) scan under _ilock
        self._keys_by_oid: Dict[int, set] = {}
        self._born: set = set()  # id() of objects constructed in-window
        self._dead: deque = deque()  # ids whose finalizer ran (GC-safe)
        self._findings: Dict[Tuple[str, str, str], SanFinding] = {}
        self._patched: List[Tuple[type, dict]] = []

    # --- class patching ---------------------------------------------------
    def install(self) -> None:
        for mod_name, class_names in TRACKED_CLASSES.items():
            mod = importlib.import_module(mod_name)
            for cls_name in class_names:
                self.track(getattr(mod, cls_name))

    def uninstall(self) -> None:
        for cls, originals in reversed(self._patched):
            for name, fn in originals.items():
                setattr(cls, name, fn)
        self._patched.clear()

    def track(self, cls: type) -> None:
        """Instrument one class (also the fixture seam: seeded-race
        fixtures register their toy classes here)."""
        if any(c is cls for c, _ in self._patched):
            return
        originals = {
            "__init__": cls.__init__,
            "__setattr__": cls.__setattr__,
            "__getattribute__": cls.__getattribute__,
        }
        tracker = self
        orig_init = originals["__init__"]
        orig_set = originals["__setattr__"]
        orig_get = originals["__getattribute__"]

        def __init__(obj, *args, **kwargs):
            tracker._register(obj)
            orig_init(obj, *args, **kwargs)

        def __setattr__(obj, name, value):
            orig_set(obj, name, value)
            if name[:2] != "__":
                tracker._on_access(obj, name, value, True)

        def __getattribute__(obj, name):
            value = orig_get(obj, name)
            if name[:2] != "__":
                tracker._on_access(obj, name, value, False)
            return value

        cls.__init__ = __init__
        cls.__setattr__ = __setattr__
        cls.__getattribute__ = __getattribute__
        self._patched.append((cls, originals))

    # --- shadow state -----------------------------------------------------
    def _register(self, obj) -> None:
        oid = id(obj)
        with self._ilock:
            # purge FIRST: a dead object's address can be recycled for
            # this very allocation — without the purge its stale id
            # would make the early-return skip registration (and leave
            # the corpse's shadow epochs to alias the newborn's)
            self._purge_dead()
            if oid in self._born:
                return
            self._born.add(oid)
        try:
            # the finalizer may fire mid-GC on a thread holding _ilock:
            # it must only do a lock-free append; the gate purges later
            weakref.finalize(obj, self._dead.append, oid)
        except TypeError:
            pass

    def _purge_dead(self) -> None:
        """Callers hold ``_ilock``."""
        while self._dead:
            try:
                oid = self._dead.popleft()
            except IndexError:
                return
            self._born.discard(oid)
            for key in self._keys_by_oid.pop(oid, ()):
                self._shadow.pop(key, None)

    def _allowed(self, obj_type: type, name: str) -> bool:
        return any((klass.__name__, name) in ALLOWED_ATTR_RACES
                   for klass in obj_type.__mro__)

    def _on_access(self, obj, name: str, value, is_write: bool) -> None:
        san = self._san
        if not san.active:
            return
        st = san.thread_state()
        if st.busy:
            return
        myname = san.thread_display_name(st)
        if not is_write and (
                callable(value)
                or type(value).__name__ in _SYNC_TYPE_NAMES):
            return
        st.busy = True
        try:
            oid = id(obj)
            if oid not in self._born:
                return
            obj_type = type(obj)
            if self._allowed(obj_type, name):
                return
            my_clock = st.vc.get(st.tid, 1)
            key = (oid, name)
            with self._ilock:
                self._purge_dead()
                cell = self._shadow.get(key)
                if cell is None:
                    cell = _Cell()
                    self._shadow[key] = cell
                    self._keys_by_oid.setdefault(oid, set()).add(key)
                w = cell.write
                if (w is not None and w[0] != st.tid
                        and not w[1] <= st.vc.get(w[0], 0)):
                    self._race(obj_type.__name__, name,
                               "write" if is_write else "read",
                               w[2], myname)
                if is_write:
                    for rtid, (rclock, rname) in cell.reads.items():
                        if (rtid != st.tid
                                and not rclock <= st.vc.get(rtid, 0)):
                            self._race(obj_type.__name__, name,
                                       "write", rname, myname,
                                       prior_kind="read")
                    cell.write = (st.tid, my_clock, myname)
                    cell.reads = {}
                else:
                    cell.reads[st.tid] = (my_clock, myname)
        finally:
            st.busy = False

    def _race(self, cls_name: str, attr: str, kind: str,
              other_thread: str, this_thread: str,
              prior_kind: str = "write") -> None:
        key = (cls_name, attr, kind)
        if key in self._findings:
            return
        self._findings[key] = SanFinding(
            kind="attr-race", subject=f"{cls_name}.{attr}",
            message=(
                f"unsynchronized {prior_kind} by {other_thread} races "
                f"this {kind} — no happens-before path orders them"
            ),
            site=call_site(), thread=this_thread,
        )

    def findings(self) -> List[SanFinding]:
        with self._ilock:
            return list(self._findings.values())
