"""corrosan runtime: instrumentation of the threading surface (port of
``corrosion_tpu/analysis/sanitizer/runtime.py``).

One :class:`Sanitizer` session patches, for its lifetime:

- ``threading.Lock`` / ``threading.RLock`` -> shadowed wrappers that
  carry a vector clock (release publishes the holder's clock, acquire
  joins it — the classic lock-based happens-before edge) and feed the
  lock-order witness. Everything built ON these primitives inside the
  window — ``Condition``, ``Event``, ``Barrier``, ``queue.Queue`` —
  inherits the clocks for free, because the stdlib resolves
  ``threading.Lock`` at call time;
- ``threading.Thread`` -> a subclass that hands the parent's clock to
  the child at ``start()`` (covering ``utils.lifecycle.spawn_counted``
  and every server/worker spawn) and joins the child's final clock back
  on ``join()``;
- ``concurrent.futures.ThreadPoolExecutor`` -> ``submit`` threads the
  submitter's clock into the task (the work queue is a C
  ``SimpleQueue`` the lock patch cannot see);
- ``builtins.open`` / ``os.unlink`` / ``os.remove`` / ``os.replace`` /
  ``os.rename`` -> the filesystem witness, for paths under registered
  watch roots.

Locks/threads that exist BEFORE the window opens keep working
untouched; they simply carry no clocks. That is the safe direction:
the attribute detector only shadows objects born in-window, so missing
history can never masquerade as a race.
"""

from __future__ import annotations

import _thread
import builtins
import concurrent.futures
import concurrent.futures.thread as _cf_thread
import contextlib
import os
import threading
from typing import List, Optional

from corrosion_tpu_torch.analysis.sanitizer import vc as _vc
from corrosion_tpu_torch.analysis.sanitizer.attrs import AttrRaces
from corrosion_tpu_torch.analysis.sanitizer.frames import call_site
from corrosion_tpu_torch.analysis.sanitizer.fsops import FsWitness
from corrosion_tpu_torch.analysis.sanitizer.leaks import LeakRegistry
from corrosion_tpu_torch.analysis.sanitizer.report import (
    SanFinding,
    findings_payload,
)
from corrosion_tpu_torch.analysis.sanitizer.witness import LockWitness

#: originals captured at import — wrappers must reach the real
#: primitives even while the module attributes are patched
_REAL = {
    "allocate": _thread.allocate_lock,
    "Lock": threading.Lock,
    "RLock": threading.RLock,
    "Thread": threading.Thread,
    "Executor": concurrent.futures.ThreadPoolExecutor,
    "open": builtins.open,
    "unlink": os.unlink,
    "remove": os.remove,
    "replace": os.replace,
    "rename": os.rename,
}

_ACTIVE: Optional["Sanitizer"] = None

_tls = threading.local()
_tid_lock = _REAL["allocate"]()
_tid_counter = [0]


class _ThreadState:
    """Per-thread sanitizer state. ``tid`` is sanitizer-assigned and
    never reused (OS thread idents are), ``busy`` breaks reentrancy
    when sanitizer bookkeeping itself touches instrumented surfaces."""

    __slots__ = ("san", "tid", "vc", "held", "busy", "name")

    def __init__(self, san: "Sanitizer"):
        with _tid_lock:
            _tid_counter[0] += 1
            self.tid = _tid_counter[0]
        self.san = san
        self.vc = _vc.fresh(self.tid)
        self.held: list = []
        self.busy = False
        # resolved lazily (see Sanitizer.thread_display_name):
        # threading.current_thread() during thread BOOTSTRAP mints a
        # _DummyThread whose Event acquires an instrumented lock, which
        # would re-enter state creation before _tls.st is assigned —
        # unbounded recursion
        self.name: Optional[str] = None


class SanLock:
    """Drop-in ``threading.Lock`` with a clock and a witness feed."""

    __slots__ = ("_lock", "vc", "san_node", "san_site")

    def __init__(self):
        self._lock = _REAL["allocate"]()
        self.vc = {}
        self.san_node = None
        self.san_site = ""
        san = _ACTIVE
        if san is not None and san.active:
            san.witness.name_new_lock(self, "Lock")

    def acquire(self, blocking=True, timeout=-1):
        rc = self._lock.acquire(blocking, timeout)
        if rc:
            san = _ACTIVE
            if san is not None and san.active:
                san.on_acquire(self)
        return rc

    def release(self):
        san = _ACTIVE
        if san is not None and san.active:
            san.on_release(self)
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False


class SanRLock:
    """Drop-in ``threading.RLock`` (the pure-Python ``_RLock`` shape,
    including the ``_release_save`` / ``_acquire_restore`` /
    ``_is_owned`` surface ``threading.Condition`` duck-types against)."""

    __slots__ = ("_block", "_owner", "_count", "vc", "san_node",
                 "san_site")

    def __init__(self):
        self._block = _REAL["allocate"]()
        self._owner = None
        self._count = 0
        self.vc = {}
        self.san_node = None
        self.san_site = ""
        san = _ACTIVE
        if san is not None and san.active:
            san.witness.name_new_lock(self, "RLock")

    def acquire(self, blocking=True, timeout=-1):
        me = _thread.get_ident()
        if self._owner == me:
            self._count += 1
            return 1
        rc = self._block.acquire(blocking, timeout)
        if rc:
            self._owner = me
            self._count = 1
            san = _ACTIVE
            if san is not None and san.active:
                san.on_acquire(self)
        return rc

    def release(self):
        if self._owner != _thread.get_ident():
            raise RuntimeError("cannot release un-acquired lock")
        self._count -= 1
        if not self._count:
            san = _ACTIVE
            if san is not None and san.active:
                san.on_release(self)
            self._owner = None
            self._block.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition integration (threading.Condition duck-types these)
    def _release_save(self):
        if self._count == 0:
            raise RuntimeError("cannot release un-acquired lock")
        state = (self._count, self._owner)
        san = _ACTIVE
        if san is not None and san.active:
            san.on_release(self)
        self._count = 0
        self._owner = None
        self._block.release()
        return state

    def _acquire_restore(self, state):
        self._block.acquire()
        self._count, self._owner = state
        san = _ACTIVE
        if san is not None and san.active:
            san.on_acquire(self)

    def _is_owned(self):
        return self._owner == _thread.get_ident()


class SanThread(_REAL["Thread"]):
    """``threading.Thread`` with clock inheritance + leak tracking."""

    def start(self):
        san = _ACTIVE
        if san is not None and san.active:
            st = san.thread_state()
            parent_clock = dict(st.vc)
            st.vc[st.tid] = st.vc.get(st.tid, 1) + 1
            san.leaks.on_thread_start(self, call_site())
            orig_run = self.run
            me = self

            def _san_run():
                cst = san.thread_state()
                _vc.join(cst.vc, parent_clock)
                try:
                    orig_run()
                finally:
                    me._san_final = dict(cst.vc)

            self.run = _san_run
        super().start()

    def join(self, timeout=None):
        super().join(timeout)
        san = _ACTIVE
        if san is not None and san.active and not self.is_alive():
            final = getattr(self, "_san_final", None)
            if final:
                _vc.join(san.thread_state().vc, final)


class SanExecutor(_REAL["Executor"]):
    """Executor whose ``submit`` threads the submitter's clock through
    the (clock-invisible) C work queue into the task."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        san = _ACTIVE
        if san is not None and san.active:
            san.leaks.on_executor(self, call_site())

    def submit(self, fn, /, *args, **kwargs):
        san = _ACTIVE
        if san is None or not san.active:
            return super().submit(fn, *args, **kwargs)
        st = san.thread_state()
        snapshot = dict(st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 1) + 1

        def _san_task(*a, **kw):
            cst = san.thread_state()
            _vc.join(cst.vc, snapshot)
            return fn(*a, **kw)

        return super().submit(_san_task, *args, **kwargs)


def _san_open(file, mode="r", *args, **kwargs):
    fobj = _REAL["open"](file, mode, *args, **kwargs)
    san = _ACTIVE
    if san is not None and san.active and isinstance(mode, str):
        san.fs.on_open(file, mode, fobj)
    return fobj


def _san_unlink(path, *args, **kwargs):
    _REAL["unlink"](path, *args, **kwargs)
    san = _ACTIVE
    if san is not None and san.active:
        san.fs.on_delete(path)


def _san_replace(src, dst, *args, **kwargs):
    _REAL["replace"](src, dst, *args, **kwargs)
    san = _ACTIVE
    if san is not None and san.active:
        san.fs.on_replace(src, dst)


def _san_rename(src, dst, *args, **kwargs):
    _REAL["rename"](src, dst, *args, **kwargs)
    san = _ACTIVE
    if san is not None and san.active:
        san.fs.on_replace(src, dst)


def _preload_torch() -> None:
    """Load the parts of torch that torch itself loads lazily on the
    port's paths. A meta-device index store (the checkpoint reader's
    state template) imports ``torch._dynamo``, whose import starts a
    module-level ``ThreadPoolExecutor`` that lives as long as the
    process: born inside a window, it would read as a leak of the port.
    Loaded before the window, like everything torch makes at import, it
    stays out of the gate."""
    import torch
    import torch._dynamo  # noqa: F401


class Sanitizer:
    """One sanitized window: install() .. uninstall(), then gate().

    Components: :class:`AttrRaces` (happens-before attribute races),
    :class:`LockWitness` (runtime lock order vs the static graph),
    :class:`FsWitness` (watched-path write/delete ordering + fd leaks),
    :class:`LeakRegistry` (threads/executors)."""

    def __init__(self, watch_roots=()):
        self.active = False
        self.attrs = AttrRaces(self)
        self.witness = LockWitness(self)
        self.fs = FsWitness(self)
        self.leaks = LeakRegistry()
        for root in watch_roots:
            self.fs.watch(root)

    # --- thread state -----------------------------------------------------
    def thread_state(self) -> _ThreadState:
        st = getattr(_tls, "st", None)
        if st is None or st.san is not self:
            st = _ThreadState(self)
            _tls.st = st
        return st

    def thread_display_name(self, st: Optional[_ThreadState] = None) -> str:
        """The current thread's name for reports, resolved lazily (see
        ``_ThreadState.name``). Safe once a state exists: a dummy-thread
        detour through instrumented locks re-enters plumbing that finds
        the EXISTING state and terminates."""
        st = st or self.thread_state()
        if st.name is None:
            if st.busy:
                return f"tid-{st.tid}"  # mid-plumbing: don't recurse
            st.busy = True
            try:
                st.name = threading.current_thread().name
            finally:
                st.busy = False
        return st.name

    # --- clock plumbing (wrappers route here) -----------------------------
    def on_acquire(self, lock) -> None:
        st = self.thread_state()
        _vc.join(st.vc, lock.vc)
        if st.held and not st.busy:
            st.busy = True
            try:
                self.witness.on_edge(st.held, lock, st)
            finally:
                st.busy = False
        st.held.append(lock)

    def on_release(self, lock) -> None:
        st = self.thread_state()
        lock.vc = dict(st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 1) + 1
        for i in range(len(st.held) - 1, -1, -1):
            if st.held[i] is lock:
                del st.held[i]
                break

    # --- fixture/test seam ------------------------------------------------
    def track(self, cls: type) -> None:
        """Add a class to the race-tracked set (fixtures register toy
        classes; the curated production set installs automatically)."""
        self.attrs.track(cls)

    def watch_dir(self, root) -> None:
        self.fs.watch(root)

    # --- lifecycle --------------------------------------------------------
    def install(self) -> "Sanitizer":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a corrosan session is already active")
        _preload_torch()
        self.witness.prepare()
        self.attrs.install()
        threading.Lock = SanLock
        threading.RLock = SanRLock
        threading.Thread = SanThread
        concurrent.futures.ThreadPoolExecutor = SanExecutor
        _cf_thread.ThreadPoolExecutor = SanExecutor
        builtins.open = _san_open
        os.unlink = _san_unlink
        os.remove = _san_unlink
        os.replace = _san_replace
        os.rename = _san_rename
        _ACTIVE = self
        self.active = True
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is not self:
            return
        self.active = False
        _ACTIVE = None
        threading.Lock = _REAL["Lock"]
        threading.RLock = _REAL["RLock"]
        threading.Thread = _REAL["Thread"]
        concurrent.futures.ThreadPoolExecutor = _REAL["Executor"]
        _cf_thread.ThreadPoolExecutor = _REAL["Executor"]
        builtins.open = _REAL["open"]
        os.unlink = _REAL["unlink"]
        os.remove = _REAL["remove"]
        os.replace = _REAL["replace"]
        os.rename = _REAL["rename"]
        self.attrs.uninstall()

    # --- gate -------------------------------------------------------------
    def gate(self) -> List[SanFinding]:
        """All unsuppressed findings of this window, every detector."""
        findings = list(self.attrs.findings())
        findings.extend(self.witness.check())
        findings.extend(self.fs.check())
        findings.extend(self.leaks.check())
        return sorted(findings)

    def report_payload(self, findings: Optional[List[SanFinding]] = None
                       ) -> dict:
        """The pytest-section report body. Pass the findings from an
        earlier :meth:`gate` call to keep the printed and serialized
        findings one computation (the detectors re-inspect live state,
        e.g. ``os.path.exists``, so two gates can diverge)."""
        payload = findings_payload(
            self.gate() if findings is None else findings)
        payload["witnessed_edges"] = self.witness.edges_payload()
        payload["threads_spawned"] = self.leaks.spawned_count()
        payload["fs_ops"] = self.fs.ops_payload()
        return payload


@contextlib.contextmanager
def sanitized(watch_roots=()):
    """``with sanitized() as san: ...`` — scoped window; the caller
    gates explicitly (``san.gate()``) after the block.

    Composes with a session-wide window (the ``CORROSAN=1`` pytest
    plugin): an active outer session is suspended for the scope and
    re-installed after, so the sanitizer's own fixture tests can run
    inside a sanitized run. The outer window simply does not observe
    events that happen while it is suspended — its patched classes and
    clocks resume untouched."""
    outer = _ACTIVE
    if outer is not None:
        outer.uninstall()
    san = Sanitizer(watch_roots=watch_roots)
    san.install()
    try:
        yield san
    finally:
        san.uninstall()
        if outer is not None:
            outer.install()
