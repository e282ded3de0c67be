"""Seeded concurrency fixtures: the sanitizer's true-positive guard (port
of ``corrosion_tpu/analysis/sanitizer/fixtures.py``).

A detector nobody has watched CATCH a bug is a no-op with overhead, so
every detector ships with fixtures that provoke its bug class under
barrier-forced interleavings and assert the finding appears — plus
clean twins asserting the FIXED shape passes (false-positive guard).
``python -m corrosion_tpu_torch san`` replays them all into the JSON
report; ``tests/test_torch_corrosan.py`` holds each verdict to the JAX
package's.

The crown fixture pair re-provokes the unsubscribe-vs-persist race
against the REAL ``SubsManager``: ``pubsub-resurrect-reverted`` swaps
in the pre-fix ``_persist_worker`` (no post-write liveness re-check)
and must be flagged; ``pubsub-resurrect-fixed`` runs the shipped worker
through the same forced interleaving and must pass. Their un-started
``Agent`` lives on ``device`` (default ``cuda``, which raises without a
card); the other fixtures touch no device, but every entry point
resolves the device first, so a missing card is never a silent pass.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from typing import Callable, Dict, List, Optional, Tuple

from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.analysis.sanitizer.runtime import Sanitizer, sanitized


@dataclasses.dataclass
class FixtureResult:
    name: str
    expect: Tuple[str, ...]  # finding kinds that MUST appear (() = clean)
    found: Tuple[str, ...]
    ok: bool
    details: List[str]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _spawn(fn, name: str) -> threading.Thread:
    t = threading.Thread(target=fn, name=name, daemon=True)
    t.start()
    return t


# --- race detector ---------------------------------------------------------

def _fx_race_unlocked(san: Sanitizer, tmp: str, device) -> Optional[Callable]:
    """Two threads increment a shared counter with no lock: a textbook
    write/write + read/write race the happens-before detector must
    flag. The barrier orders both threads after setup but leaves the
    increments themselves concurrent."""

    class Shared:
        def __init__(self):
            self.val = 0

    san.track(Shared)
    obj = Shared()
    barrier = threading.Barrier(2)

    def worker():
        barrier.wait(timeout=10)
        for _ in range(50):
            obj.val += 1

    threads = [_spawn(worker, f"corrosan-racer-{i}") for i in range(2)]
    for t in threads:
        t.join(timeout=10)
    return None


def _fx_race_locked(san: Sanitizer, tmp: str, device) -> Optional[Callable]:
    """The fixed twin: same increments under one lock — every access
    pair is ordered through the lock's clock, so the detector must stay
    silent (false-positive guard)."""

    class Shared:
        def __init__(self):
            self.val = 0

    san.track(Shared)
    obj = Shared()
    mu = threading.Lock()
    barrier = threading.Barrier(2)

    def worker():
        barrier.wait(timeout=10)
        for _ in range(50):
            with mu:
                obj.val += 1

    threads = [_spawn(worker, f"corrosan-locked-{i}") for i in range(2)]
    for t in threads:
        t.join(timeout=10)
    return None


# --- lock-order witness ----------------------------------------------------

def _fx_lock_inversion(san: Sanitizer, tmp: str, device) -> Optional[Callable]:
    """ABBA without the deadlock: thread 1 nests a->b and FINISHES
    before thread 2 nests b->a, so the run completes — exactly the
    interleaving-dependent bug class only a witness catches. The gate
    must report the 2-cycle."""
    a = threading.Lock()
    b = threading.Lock()

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    first = _spawn(t1, "corrosan-ab")
    first.join(timeout=10)
    second = _spawn(t2, "corrosan-ba")
    second.join(timeout=10)
    return None


def _fx_lock_nested_clean(san: Sanitizer, tmp: str, device) -> Optional[Callable]:
    """Consistent a->b nesting from two threads: edges are witnessed
    but no cycle forms and no named pair leaves the static graph."""
    a = threading.Lock()
    b = threading.Lock()

    def worker():
        with a:
            with b:
                pass

    threads = [_spawn(worker, f"corrosan-nest-{i}") for i in range(2)]
    for t in threads:
        t.join(timeout=10)
    return None


# --- leak gate -------------------------------------------------------------

def _fx_thread_leak(san: Sanitizer, tmp: str, device) -> Optional[Callable]:
    stop = threading.Event()
    t = _spawn(lambda: stop.wait(timeout=60), "corrosan-leaky")

    def cleanup():
        stop.set()
        t.join(timeout=10)

    return cleanup


def _fx_fd_leak(san: Sanitizer, tmp: str, device) -> Optional[Callable]:
    root = os.path.join(tmp, "files")
    os.makedirs(root, exist_ok=True)
    san.watch_dir(root)
    leaked = open(os.path.join(root, "leak.txt"), "w")
    leaked.write("never closed\n")
    return leaked.close


def _fx_executor_leak(san: Sanitizer, tmp: str, device) -> Optional[Callable]:
    import concurrent.futures

    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    ex.submit(lambda: None).result(timeout=10)
    return lambda: ex.shutdown(wait=True)


# --- the pubsub unsubscribe-vs-persist regression pair ---------------------

def _small_config():
    from corrosion_tpu_torch.config import Config

    cfg = Config()
    cfg.sim.n_nodes = 8
    cfg.sim.m_slots = 8
    cfg.sim.n_origins = 2
    cfg.sim.n_rows = 4
    cfg.sim.n_cols = 2
    cfg.gossip.drop_prob = 0.0
    return cfg


def _pubsub_resurrect(san: Sanitizer, tmp: str, fixed: bool, device
                      ) -> Optional[Callable]:
    """Re-provoke the unsubscribe-vs-persist race with a forced
    interleaving: the persist worker is gated so its manifest write
    lands strictly after unsubscribe's unlink. The pre-fix worker
    (``fixed=False``) resurrects the manifest of a dead subscription —
    the fs witness must flag it; the shipped worker re-checks liveness
    after the write and unlinks, and must pass."""
    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.db import Database
    from corrosion_tpu_torch.pubsub import SubsManager

    if fixed:
        mgr_cls = SubsManager
    else:
        class RevertedSubsManager(SubsManager):
            """Pre-fix worker: persists with no post-write liveness
            re-check (the exact code the hardening replaced)."""

            def _persist_worker(self):
                while True:
                    mid = self._persist_q.get()
                    if mid is None:
                        return
                    m = self._matchers.get(mid)
                    if m is not None:
                        self._persist(m)

        mgr_cls = RevertedSubsManager

    # an un-started Agent: the fixture drives _on_round by hand, so no
    # round loop (and no device work beyond state creation) is needed
    agent = Agent(_small_config(), device=device)
    db = Database(agent)
    db.apply_schema_sql(
        "CREATE TABLE items (pk INTEGER PRIMARY KEY, v INTEGER);"
    )
    persist_dir = os.path.join(tmp, "subs")
    san.watch_dir(persist_dir)
    mgr = mgr_cls(db, persist_dir=persist_dir)
    matcher, _ = mgr.subscribe(0, "SELECT pk, v FROM items")

    persist_started = threading.Event()
    persist_gate = threading.Event()
    real_persist = mgr._persist

    def gated_persist(m):
        persist_started.set()
        persist_gate.wait(timeout=10)
        real_persist(m)

    mgr._persist = gated_persist
    with mgr._mu:
        mgr._dirty.add(matcher.id)
    # a persist-cadence round hands the dirty matcher to the worker
    mgr._on_round(mgr.PERSIST_EVERY)
    if not persist_started.wait(timeout=10):
        raise RuntimeError("persist worker never picked up the manifest")
    # worker is parked pre-write; unsubscribe unlinks the manifest...
    mgr.unsubscribe(matcher.id)
    # ...and only now may the worker's write land
    persist_gate.set()
    mgr._persist = real_persist
    # close() drains the queue and joins the worker BEFORE the gate
    # runs, so the resurrecting write (or the fixed worker's re-check
    # unlink) is on disk when the fs witness looks
    mgr.close()
    return None


#: name -> (callable(san, tmpdir, device) -> cleanup|None, expected kinds,
#: doc); only the pubsub pair uses the device
FIXTURES: Dict[str, Tuple[Callable, Tuple[str, ...], str]] = {
    "race-unlocked": (
        _fx_race_unlocked, ("attr-race",),
        "two unlocked incrementing threads -> attr-race",
    ),
    "race-locked": (
        _fx_race_locked, (),
        "same increments under a lock -> clean",
    ),
    "lock-inversion": (
        _fx_lock_inversion, ("lock-cycle",),
        "sequential ABBA nesting -> witnessed 2-cycle",
    ),
    "lock-nested-clean": (
        _fx_lock_nested_clean, (),
        "consistent a->b nesting -> clean",
    ),
    "thread-leak": (
        _fx_thread_leak, ("thread-leak",),
        "spawned thread outlives the window -> thread-leak",
    ),
    "fd-leak": (
        _fx_fd_leak, ("fd-leak",),
        "unclosed file under a watch root -> fd-leak",
    ),
    "executor-leak": (
        _fx_executor_leak, ("executor-leak",),
        "ThreadPoolExecutor never shut down -> executor-leak",
    ),
    "pubsub-resurrect-reverted": (
        lambda san, tmp, device: _pubsub_resurrect(san, tmp, False, device),
        ("fs-resurrect",),
        "pre-fix persist worker resurrects a dead manifest -> flagged",
    ),
    "pubsub-resurrect-fixed": (
        lambda san, tmp, device: _pubsub_resurrect(san, tmp, True, device),
        (),
        "shipped persist worker under the same interleaving -> clean",
    ),
}


def run_fixture(name: str, device="cuda") -> FixtureResult:
    fn, expect, _doc = FIXTURES[name]
    dev = resolve_device(device)
    cleanup = None
    with tempfile.TemporaryDirectory(prefix="corrosan-") as tmp:
        with sanitized() as san:
            cleanup = fn(san, tmp, dev)
        try:
            findings = san.gate()
        finally:
            if cleanup is not None:
                cleanup()
    found = tuple(sorted({f.kind for f in findings}))
    if expect:
        ok = set(expect).issubset(found)
    else:
        ok = not findings
    return FixtureResult(
        name=name, expect=tuple(expect), found=found, ok=ok,
        details=[f.render() for f in findings],
    )


def run_all_fixtures(names=None, device="cuda") -> List[FixtureResult]:
    picked = list(names) if names else list(FIXTURES)
    unknown = set(picked) - set(FIXTURES)
    if unknown:
        raise ValueError(
            f"unknown fixtures: {sorted(unknown)} "
            f"(available: {sorted(FIXTURES)})"
        )
    return [run_fixture(name, device=device) for name in picked]
