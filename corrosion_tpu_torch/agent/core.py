"""Agent core: the round loop + write/read surface over the simulator (port
of ``corrosion_tpu/agent/core.py``).

Maps the reference's node runtime (SURVEY §3.1 ``start_with_config`` ->
``run``) onto the card:

- the **round loop** thread advances the whole cluster one protocol round
  (SWIM + broadcast + sync) per tick: the scale round launches the swim
  kernel and both ingest kernels (``ops/megakernel.py``) every round;
- the **write path** mirrors ``POST /v1/transactions``
  (``api_v1_transactions``, ``crates/corro-agent/src/api/public/mod.rs:177``):
  statements execute against a node's pending-write slot and are
  disseminated by the next round's broadcast step;
- the **read path** mirrors ``/v1/queries``: reads observe one node's
  local replica only (eventually consistent by construction);
- **churn/partition controls** are the admin/fault-injection surface
  (the Antithesis fault-injection harness, SURVEY §4).

The round is functional: it returns fresh tensors and never writes into
the state it was given, so a reader that holds the previous state reads
valid tensors, and no reader lease is needed. ``snapshot()``,
``device_state()`` and ``read_cell()`` return host numpy copies, as the
JAX package's do.

Thread-safety: API threads only touch the pending-input buffers and the
latest host snapshot, both under tracked locks; the round thread owns the
device state exclusively.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.config import Config
from corrosion_tpu_torch.utils.assertions import assert_always, assert_sometimes
from corrosion_tpu_torch.utils.hlc import HLClock
from corrosion_tpu_torch.utils.lifecycle import Tripwire, spawn_counted
from corrosion_tpu_torch.utils.locks import LockRegistry
from corrosion_tpu_torch.utils.metrics import Registry, RoundTimer, record_round_info
from corrosion_tpu_torch.utils.tracing import logger


def _map_tree(fn, x):
    """``fn`` over the leaves of nested NamedTuples and tuples, keeping
    the containers."""
    if hasattr(x, "_fields"):
        return type(x)(*(_map_tree(fn, v) for v in x))
    if isinstance(x, tuple):
        return tuple(_map_tree(fn, v) for v in x)
    return fn(x)


def _host(t: torch.Tensor) -> np.ndarray:
    """An owned host copy of a tensor."""
    return t.detach().to("cpu", copy=True).numpy()


def _host_state(state):
    """The state as the same NamedTuples holding owned numpy copies, in
    the JAX package's dtypes (``Book.seen`` as uint32)."""
    out = _map_tree(_host, state)
    book = out.crdt.book
    return out._replace(crdt=out.crdt._replace(
        book=book._replace(seen=book.seen.view(np.uint32))))


def _upload(a, dev: torch.device) -> torch.Tensor:
    """An owned device copy of a numpy array or tensor leaf (uint32 as
    int32 bits, the port's form of ``Book.seen``)."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, copy=True)
    a = np.array(a, order="C")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


class Agent:
    """The node runtime. ``Agent(config).start()`` -> round loop running.

    Use :meth:`write` / :meth:`snapshot` (or a ``Database`` over the agent)
    from any thread; :meth:`shutdown` is the tripwire. ``device`` defaults
    to ``"cuda"`` and raises without a card; ``device="cpu"`` runs the
    kernels' plain versions."""

    def __init__(self, config: Optional[Config] = None, device="cuda"):
        self.config = config or Config()
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # a thread the agent spawns selects this card by its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        sim = self.config.sim
        self.mode = sim.mode
        self.cfg = self.config.sim_config()
        self.n_nodes = self.cfg.n_nodes
        self.n_origins = self.cfg.n_origins
        self.n_cells = self.cfg.n_cells

        if self.mode == "scale":
            from corrosion_tpu_torch.sim.scale_step import (
                ScaleRoundInput,
                ScaleSimState,
                check_slice,
                scale_sim_step,
            )

            check_slice(self.cfg)
            self._state = ScaleSimState.create(self.cfg, self.device)
            self._quiet = ScaleRoundInput.quiet(self.cfg, self.device)
            self._step = scale_sim_step
        else:
            from corrosion_tpu_torch.sim.config import check_full_slice
            from corrosion_tpu_torch.sim.step import RoundInput, SimState, sim_step

            check_full_slice(self.cfg)
            self._state = SimState.create(self.cfg, device=self.device)
            self._quiet = RoundInput.quiet(self.cfg, self.device)
            self._step = sim_step

        from corrosion_tpu_torch.sim.transport import NetModel

        self._net = NetModel.create(
            self.n_nodes,
            drop_prob=self.config.gossip.drop_prob,
            n_regions=self.config.gossip.n_regions,
            device=self.device,
        )
        self._key = prng.key(sim.seed)
        # host mirror of the state's round counter (``crdt.now``): the
        # round's sync gate reads it instead of the device; None = read
        # it from the state once (after a restore)
        self._now: Optional[int] = 0
        self._bootstrap_from_members_file()

        self.metrics = Registry()
        self.locks = LockRegistry(logger=logger)
        self.tripwire = Tripwire()
        self._input_lock = self.locks.lock("agent.pending_inputs")
        self._snap_lock = self.locks.lock("agent.snapshot")

        # pending per-node inputs for the next round (host-side staging).
        # Writes queue in per-node FIFOs — one *transaction* (up to
        # tx_max_cells cells, committed atomically under one db_version)
        # enters the round per node per tick, the array analog of the
        # reference's broadcast batching queue (``broadcast/mod.rs:395-408``)
        # + chunked-changeset commit (``public/mod.rs:177-256``).
        n = self.n_nodes
        self._tx_k = max(1, getattr(self.cfg, "tx_max_cells", 1))
        # node -> list of ([(cell, val, clp)...], event|None). Chunks of
        # one write_many transaction share the waiter; only the final
        # chunk carries it, so a failed round drops the whole transaction
        self._write_queues: dict = {}
        # API-boundary hybrid logical clocks, one per writer node: every
        # transaction is stamped on entry (crsql_set_ts analog,
        # public/mod.rs:88-100); the in-round clock lives on the device
        # as CrdtState.hlc and folds through ingest + sync handshakes
        self._hlc = {node: HLClock(node) for node in range(self.n_origins)}
        self._pend_kill = np.zeros(n, bool)
        self._pend_revive = np.zeros(n, bool)
        self._pend_partition: Optional[np.ndarray] = None
        self._pend_restore = None  # (state, applied-Event, box) | None

        self.round_no = 0
        self._round_cv = threading.Condition()
        self._snapshot_host = None  # cached per round
        self._thread = None
        self._listeners = []  # subscription manager hooks

        # --- recovery / supervision (resilience subsystem) --------------
        # generation fences stale state: every applied restore bumps it,
        # and a round result computed against an older generation is
        # discarded at commit instead of clobbering the restored state
        self.generation = 0
        self._supervisor = None  # optional watchdog around dispatch
        # the attached Database registers itself here so checkpoint
        # recovery restores the HOST state (schema, heap, rows) together
        # with the device state — a rewound cluster must not keep
        # serving rows it no longer holds
        self.recovery_db = None
        self._auto_recover = False
        self._recovering = False  # True while a checkpoint restore runs
        self._consec_failures = 0
        self._max_recoveries = 3  # consecutive failed rounds before giving up

    def _bootstrap_from_members_file(self) -> None:
        """Replay a persisted member list into the fresh SWIM state — the
        ``__corro_members`` bootstrap (``initialise_foca``'s ApplyMany
        from the DB, ``util.rs:69-130``): a restarted cluster starts from
        yesterday's membership instead of only the static seed set. The
        maintenance loop keeps the file fresh."""
        import json
        import os

        path = getattr(self.config.db, "members_path", "")
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                dump = json.load(f)
            members = [
                (int(m[0]), int(m[1]))
                for m in dump.get("members", [])
                if 0 <= int(m[0]) < self.n_nodes
            ]
        except (OSError, ValueError, KeyError, TypeError, IndexError):
            logger.exception("members bootstrap file unreadable; skipping")
            return
        if not members:
            return
        ids = [m[0] for m in members]
        incs = [m[1] for m in members]
        if self.mode == "scale":
            from corrosion_tpu_torch.sim.scale import bootstrap_members
        else:
            from corrosion_tpu_torch.sim.swim import bootstrap_members
        self._state = self._state._replace(
            swim=bootstrap_members(self._state.swim, ids, incs)
        )
        logger.info("bootstrapped %d members from %s", len(members), path)

    def _incarnation(self, swim) -> torch.Tensor:
        return swim.inc if self.mode == "scale" else swim.incarnation

    def persist_members(self, path: str) -> None:
        """Dump the alive member list (id, incarnation) for restart
        bootstrap — the ``__corro_members`` upsert. Reads only the two
        [N] liveness vectors, not the store planes."""
        import json
        import os

        swim = self._state.swim
        alive = _host(swim.alive)
        inc = _host(self._incarnation(swim))
        members = [[int(i), int(inc[i])] for i in np.nonzero(alive)[0]]
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"round": self.round_no, "members": members}, f)
        os.replace(tmp, path)

    # --- lifecycle ------------------------------------------------------
    def start(self, pace_seconds: float = 0.0, auto_recover: bool = False,
              supervisor=None):
        """Boot the round loop.

        ``auto_recover`` restores the newest valid checkpoint under
        ``config.db.path`` before the first round (missing/corrupt
        checkpoints are skipped — a fresh cluster boots clean), and
        re-arms after a mid-run round failure: the loop rolls back to
        the last good checkpoint instead of dying, up to
        ``_max_recoveries`` consecutive failures.

        ``supervisor`` (a ``resilience.Supervisor``) wraps every round
        with its deadline + jittered-retry policy; its abort predicate and
        sleep are bound to the agent's tripwire."""
        if self._thread is not None:
            raise RuntimeError("agent already started")
        if supervisor is not None:
            self._supervisor = supervisor.bind_abort(
                lambda: self.tripwire.tripped, sleep=self.tripwire.wait
            )
        self._auto_recover = auto_recover
        from corrosion_tpu_torch.obs.memory import (
            memory_report,
            publish_memory_gauges,
        )

        publish_memory_gauges(
            memory_report(self._state, self.n_nodes), self.metrics
        )
        if auto_recover:
            self.recover_latest()
        self._thread = spawn_counted(
            self._run_loop, pace_seconds, name="corro-agent-round-loop"
        )
        return self

    def recover_latest(self, root: Optional[str] = None,
                       db=None) -> Optional[dict]:
        """Restore from the newest checkpoint under ``root`` (default
        ``config.db.path``) that passes integrity verification AND is
        config-compatible AND actually restores — candidates failing any
        of those gates are logged and skipped for the next-newest.
        Returns the restored manifest, or None when nothing restorable
        exists. Boot-time resume (``MaintenanceLoop.resume_latest``) and
        mid-run crash rollback both land here."""
        import json
        import os

        from corrosion_tpu_torch.checkpoint import (
            config_identity,
            restore_checkpoint,
        )
        from corrosion_tpu_torch.resilience.retention import (
            iter_valid_checkpoints,
        )

        root = root or self.config.db.path
        db = db if db is not None else self.recovery_db
        self._recovering = True
        try:
            for path in iter_valid_checkpoints(root):
                # manifest-only read for the config gate; identity
                # excludes execution-only keys (``fused``)
                with open(os.path.join(path, "manifest.json")) as f:
                    manifest = json.load(f)
                if (config_identity(manifest["sim_config"])
                        != config_identity(self.cfg)):
                    logger.error(
                        "checkpoint %s has a different sim config than "
                        "this agent; trying the next-newest", path,
                    )
                    continue
                try:
                    # the iterator already ran the full hash pass
                    man = restore_checkpoint(self, path, db=db, verify=False)
                except Exception:  # noqa: BLE001 — try the next-newest
                    logger.exception(
                        "checkpoint %s is unrestorable; trying the "
                        "next-newest", path,
                    )
                    continue
                man["path"] = path
                if self._thread is None:
                    # boot-time recover: resume the round counter at the
                    # saved round (a live loop keeps its own monotonic
                    # counter for waiters)
                    self.round_no = int(man.get("round", self.round_no))
                logger.info(
                    "recovered from %s (round %d, generation %d)",
                    path, man["round"], self.generation,
                )
                return man
            return None
        finally:
            self._recovering = False

    def shutdown(self):
        self.tripwire.trip()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def soak(self, rounds: int, segment_rounds: int = 128,
             checkpoint_root: Optional[str] = None, keep_last: int = 3,
             write_frac: float = 0.0, resume: bool = False, mesh=None):
        """Throughput soak: run ``rounds`` rounds from the agent's current
        state through the segmented runner
        (:func:`corrosion_tpu_torch.resilience.segments.run_segmented`;
        checkpoints carry the attached database and are written on the
        overlapped background writer), then adopt the final carry as the
        agent's state (the round counter advances by the completed rounds;
        the generation fence moves so no stale in-flight result can commit
        over it).

        The round loop must be stopped. ``resume=True`` continues from the
        newest valid checkpoint under ``checkpoint_root`` instead of the
        live state. The inputs are ``make_soak_inputs`` from the config's
        seed; segments run under the agent's supervisor, if it has one.
        ``mesh`` (``parallel/mesh.Mesh``) shards the soak over the node
        axis: state, net and inputs are placed on it, checkpoints drain
        one slice file per shard, ``resume`` places the newest checkpoint
        on this mesh whatever mesh wrote it, and the agent adopts the
        final carry back on its own device.

        The observer comes from ``config.obs`` (flight path, Prometheus
        port, profiler labels) or, with that section idle, is a
        bridge-only observer onto the agent's own metrics registry, so a
        soak always advances ``corro.soak.rounds_total`` on this agent's
        ``/metrics``; it is closed before returning."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("stop the round loop before a soak dispatch")
        if resume and not checkpoint_root:
            raise ValueError("resume needs a checkpoint root")
        from corrosion_tpu_torch.obs.flight import SoakObserver, make_observer
        from corrosion_tpu_torch.resilience.segments import (
            make_soak_inputs,
            resume_segmented,
            run_segmented,
        )

        inputs = make_soak_inputs(
            self.cfg, prng.key(self.config.sim.seed + 1), rounds,
            write_frac=write_frac, device=self.device,
        )
        # serve_registry = the agent's own metrics: admission and
        # subscription shed counters publish there, so the soak's flight
        # record carries its shed story
        obs = (make_observer(self.config.obs, registry=self.metrics,
                             serve_registry=self.metrics)
               or SoakObserver(registry=self.metrics, serve_registry=self.metrics))
        common = dict(checkpoint_root=checkpoint_root, keep_last=keep_last,
                      db=self.recovery_db, supervisor=self._supervisor, obs=obs)
        net, st = self._net, self._state
        if mesh is not None:
            from corrosion_tpu_torch.parallel.mesh import shard_state

            # placement copies: the agent's own state stays as it is
            # whatever happens to the sharded run
            inputs = shard_state(mesh, self.cfg.n_nodes, inputs)
            net = shard_state(mesh, self.cfg.n_nodes, net)
            if not resume:
                st = shard_state(mesh, self.cfg.n_nodes, st)
        try:
            if resume:
                result = resume_segmented(self.cfg, net, inputs,
                                          segment_rounds, mesh=mesh, **common)
            else:
                result = run_segmented(self.cfg, st, net, self._key, inputs,
                                       segment_rounds, **common)
        finally:
            obs.close()
        adopted = result.state
        if mesh is not None:
            adopted = adopted.assemble(self.device)
        with self._input_lock:
            self._state = adopted
            self._key = result.key
            self._now = None  # read the adopted state's round counter once
            if resume:
                # completed_rounds is absolute within the input stack and
                # the adopted state replaces this agent's
                self.round_no = result.completed_rounds
            else:
                self.round_no += result.completed_rounds
            self.generation += 1
        with self._snap_lock:
            self._snapshot_host = None
        return result

    # --- the round loop -------------------------------------------------
    def _run_loop(self, pace_seconds: float):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while not self.tripwire.tripped:
                t0 = time.perf_counter()
                try:
                    self._one_round()
                    self._consec_failures = 0
                except Exception:  # noqa: BLE001 — recovery decides below
                    if not self._auto_recover:
                        raise
                    self._consec_failures += 1
                    if self._consec_failures > self._max_recoveries:
                        logger.error(
                            "round failed %d times in a row; giving up",
                            self._consec_failures,
                        )
                        raise
                    logger.exception(
                        "round failed; rolling back to the last good "
                        "checkpoint (recovery %d/%d)",
                        self._consec_failures, self._max_recoveries,
                    )
                    if self.recover_latest() is None:
                        logger.error(
                            "no restorable checkpoint under %r; shutting "
                            "down", self.config.db.path,
                        )
                        raise
                    continue
                if pace_seconds > 0:
                    left = pace_seconds - (time.perf_counter() - t0)
                    if left > 0 and self.tripwire.wait(left):
                        break
        except Exception:  # noqa: BLE001 — a dead loop must not look alive
            logger.exception("round loop crashed; tripping shutdown")
        finally:
            self.tripwire.trip()
            # wake everything parked on us: queued writers, round waiters,
            # and any restore staged after the last round started
            with self._input_lock:
                self._apply_pend_restore()
                for q in self._write_queues.values():
                    for _cells, ev in q:
                        if ev is not None:
                            # never entered a round — the wake must read
                            # as a drop, not a commit
                            ev.dropped = True
                            ev.set()
                self._write_queues.clear()
            with self._round_cv:
                self._round_cv.notify_all()

    def _apply_pend_restore(self):
        """Apply a staged restore. Callers must hold ``_input_lock``; only
        the round thread (or a caller when no round thread runs) may call
        this, so the swap never races an in-flight step."""
        if self._pend_restore is None:
            return
        state, ev, box = self._pend_restore
        self._pend_restore = None
        self._state = _map_tree(lambda a: _upload(a, self.device), state)
        self._now = None
        # fence: any round result computed against the pre-restore state
        # is now stale and must not commit over this one
        self.generation += 1
        box["applied"] = True
        ev.set()

    def _run_step(self, st, net, sub, inp, now):
        new_state, info = self._step(self.cfg, st, net, sub, inp, now=now)
        # completion inside the (possibly supervised) call: a wedged
        # card surfaces as a deadline miss, not a hang at next use
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return new_state, info

    def _dispatch(self, st, net, sub, inp, now):
        if self._supervisor is None:
            return self._run_step(st, net, sub, inp, now)
        return self._supervisor.call(
            self._run_step, st, net, sub, inp, now, label="round-dispatch"
        )

    def _device_array(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def _one_round(self):
        with self._input_lock:
            self._apply_pend_restore()
            gen = self.generation
            n, k = self.n_nodes, self._tx_k
            write_mask = np.zeros(n, bool)
            write_cell = np.zeros(n, np.int32)
            write_val = np.zeros(n, np.int32)
            write_clp = np.zeros(n, np.int32)
            tx_mask = np.zeros(n, bool)
            tx_len = np.ones(n, np.int32)
            tx_cell = np.zeros((n, k), np.int32)
            tx_val = np.zeros((n, k), np.int32)
            tx_clp = np.zeros((n, k), np.int32)
            waiters = []
            drained = []
            for node, q in self._write_queues.items():
                cells, ev = q.pop(0)
                if len(cells) == 1:
                    cell, val, clp = cells[0]
                    write_mask[node] = True
                    write_cell[node] = cell
                    write_val[node] = val
                    write_clp[node] = clp
                else:  # multi-cell: one db_version, atomic remote apply
                    tx_mask[node] = True
                    tx_len[node] = len(cells)
                    for i, (cell, val, clp) in enumerate(cells):
                        tx_cell[node, i] = cell
                        tx_val[node, i] = val
                        tx_clp[node, i] = clp
                if ev is not None:
                    waiters.append(ev)
                if not q:
                    drained.append(node)
            for node in drained:
                del self._write_queues[node]
            up = self._device_array  # copies: the staging buffers are reused
            inp = self._quiet._replace(
                write_mask=up(write_mask),
                write_cell=up(write_cell),
                write_val=up(write_val),
                write_clp=up(write_clp),
                kill=up(self._pend_kill),
                revive=up(self._pend_revive),
            )
            if k > 1:
                inp = inp._replace(
                    tx_mask=up(tx_mask),
                    tx_len=up(tx_len),
                    tx_cell=up(tx_cell),
                    tx_val=up(tx_val),
                    tx_clp=up(tx_clp),
                )
            net = self._net
            if self._pend_partition is not None:
                net = net._replace(partition=up(self._pend_partition))
                self._net = net
                self._pend_partition = None
            self._pend_kill[:] = False
            self._pend_revive[:] = False
            st = self._state
            if self._now is None:
                self._now = int(st.crdt.now)
            now = self._now

        with RoundTimer("round", warn_seconds=1.0, registry=self.metrics,
                        logger=logger):
            self._key, sub = prng.split(self._key)
            try:
                new_state, info = self._dispatch(st, net, sub, inp, now)
            except BaseException:
                # the drained writes die with the failed round (recovery
                # rolls back past them like any post-checkpoint write) —
                # wake their waiters now, flagged, so the caller gets a
                # clear error instead of a false success
                for ev in waiters:
                    ev.dropped = True
                    ev.set()
                raise

        with self._input_lock:
            listeners = list(self._listeners)
            if self.generation != gen:
                # a restore applied while this round was in flight: its
                # result was computed against pre-restore state — fence
                # it out; the writes that entered it roll back with it
                logger.warning(
                    "round result fenced: generation %d -> %d",
                    gen, self.generation,
                )
                for ev in waiters:
                    ev.dropped = True
                    ev.set()
                return
            self._state = new_state
            self._now = now + 1

        # one host read per info entry, as the JAX agent's float(v)
        vals = {key: float(v) for key, v in info.items()}
        record_round_info(vals, registry=self.metrics)
        # the kernel wrappers' launch counts of this process, per form:
        # /metrics shows which kernels the live loop runs
        from corrosion_tpu_torch.ops.megakernel import FORM_LAUNCHES

        for (kernel, form), count in list(FORM_LAUNCHES.items()):
            self.metrics.gauge("corro.kernel.launches", count,
                               labels={"kernel": kernel, "form": form})
        # inline always/sometimes probes (the Antithesis instrumentation
        # seam, SURVEY §4): invariants log+count, liveness is aggregated
        assert_always(
            all(v >= 0 for v in vals.values()),
            "round counters non-negative",
            str({key: v for key, v in vals.items() if v < 0}),
        )
        assert_sometimes(vals.get("syncs", 0) > 0,
                         "nodes sync with other nodes")
        assert_sometimes(vals.get("delivered", 0) > 0,
                         "broadcasts deliver changes")
        assert_sometimes(vals.get("acked", 0) > 0,
                         "SWIM probes are acked")
        # invalidate the cached snapshot BEFORE waking round waiters, so a
        # woken wait_rounds() caller never reads pre-round state
        with self._snap_lock:
            self._snapshot_host = None
        with self._round_cv:
            self.round_no += 1
            self._round_cv.notify_all()
        for ev in waiters:
            ev.set()
        for hook in listeners:
            try:
                hook(self.round_no)
            except Exception:  # noqa: BLE001 — a bad subscriber must not kill the loop
                logger.exception("round listener failed")

    def wait_rounds(self, k: int = 1, timeout: float = 30.0) -> bool:
        """Block until ``k`` more rounds completed (False on timeout or
        shutdown)."""
        with self._round_cv:
            target = self.round_no + k
            return self._round_cv.wait_for(
                lambda: self.round_no >= target or self.tripwire.tripped,
                timeout,
            ) and self.round_no >= target

    def add_round_listener(self, hook):
        # under _input_lock: registration publishes the hook (and what
        # its owner built) to the round thread
        with self._input_lock:
            self._listeners.append(hook)

    def remove_round_listener(self, hook) -> None:
        with self._input_lock:
            if hook in self._listeners:
                self._listeners.remove(hook)

    # --- write path (transactions) --------------------------------------
    def write(self, node: int, cell: int, value: int, wait: bool = True,
              timeout: float = 30.0) -> dict:
        """One-cell write transaction at ``node`` (must be an origin).

        Returns ``{rows_affected, round}`` after the write entered a round
        (the reference returns once committed locally; dissemination is
        async, ``public/mod.rs:177-256``)."""
        return self.write_many(node, [(cell, value)], wait=wait, timeout=timeout)

    def write_many(self, node: int, cells, wait: bool = True,
                   timeout: float = 30.0) -> dict:
        """Multi-cell transaction at ``node``: a list of ``(cell, value)``
        or ``(cell, value, clp)`` where ``clp`` is the causal-length row
        lifetime of the write (the DB layer stamps it; raw writes default
        to 0).

        Up to ``tx_max_cells`` cells commit atomically under one
        db_version and are disseminated as a chunked changeset
        (``public/mod.rs:177-256`` + ``util.rs:546-696``). Repeated cells
        collapse to the last write; transactions larger than
        ``tx_max_cells`` split into several versions, each atomic. With
        ``wait`` the call returns once the last chunk entered a round."""
        if not (0 <= node < self.n_origins):
            raise ValueError(
                f"node {node} is not a writer (origins are 0..{self.n_origins - 1})"
            )
        cells = [(c[0], c[1], c[2] if len(c) > 2 else 0) for c in cells]
        if not cells:
            return {"rows_affected": 0, "round": self.round_no}
        for cell, _, _ in cells:
            if not (0 <= cell < self.n_cells):
                raise ValueError(f"cell {cell} out of range (n_cells={self.n_cells})")
        if self.tripwire.tripped:
            raise RuntimeError("agent is shut down")
        # a version's cells must be distinct (one clock row per cell):
        # last-write-wins within the transaction
        dedup: dict = {}
        for cell, value, clp in cells:
            dedup[int(cell)] = (int(cell), int(value), int(clp))
        flat = list(dedup.values())
        chunks = [flat[i:i + self._tx_k] for i in range(0, len(flat), self._tx_k)]
        ts = self._hlc[node].new_timestamp()  # stamp on entry (crsql_set_ts)
        ev = threading.Event()
        with self._input_lock:
            q = self._write_queues.setdefault(node, [])
            for chunk in chunks[:-1]:
                q.append((chunk, None))
            q.append((chunks[-1], ev))
        if wait:
            if not ev.wait(timeout):
                raise TimeoutError("write did not enter a round in time")
            if getattr(ev, "dropped", False):
                raise RuntimeError(
                    "write was dropped before it committed (round "
                    "failure, recovery rollback, or shutdown) — retry"
                )
        return {"rows_affected": len(cells), "round": self.round_no,
                "ts": str(ts)}

    # --- fault injection (admin surface) --------------------------------
    def kill_node(self, node: int):
        with self._input_lock:
            self._pend_kill[node] = True

    def revive_node(self, node: int):
        with self._input_lock:
            self._pend_revive[node] = True

    def set_partition(self, groups: np.ndarray):
        """Assign partition group per node (same group = connected)."""
        groups = np.asarray(groups, np.int32)
        if groups.shape != (self.n_nodes,):
            raise ValueError(
                f"partition groups shape {groups.shape} != "
                f"({self.n_nodes},)"
            )
        with self._input_lock:
            self._pend_partition = groups

    def heal_partition(self):
        self.set_partition(np.zeros(self.n_nodes, np.int32))

    def set_cluster_id(self, cluster_id: int, nodes=None):
        """Stamp ``nodes`` (default: all) with a ClusterId. Mismatched
        payloads stop delivering — the uni-drop / sync-rejection gate
        (``uni.rs:75-77``, ``peer/mod.rs:1425-1436``)."""
        with self._input_lock:
            ids = _host(self._net.cluster_id)
            if nodes is None:
                ids = np.full(self.n_nodes, int(cluster_id), np.int32)
            else:
                for node in nodes:
                    node = int(node)
                    if not (0 <= node < self.n_nodes):
                        raise ValueError(
                            f"node {node} out of range (n_nodes={self.n_nodes})"
                        )
                    ids[node] = int(cluster_id)
            self._net = self._net._replace(cluster_id=self._device_array(ids))

    def set_regions(self, regions: np.ndarray):
        """Assign geographic region per node (drives the RTT rings).
        Applied between rounds, like partitions."""
        regions = np.asarray(regions, np.int32)
        if regions.shape != (self.n_nodes,):
            raise ValueError(
                f"regions shape {regions.shape} != ({self.n_nodes},)"
            )
        with self._input_lock:
            self._net = self._net._replace(region=self._device_array(regions))

    # --- checkpoint / restore -------------------------------------------
    def device_state(self):
        """An owned host copy of the current state: the state's
        NamedTuples holding numpy arrays in the JAX package's dtypes."""
        return _host_state(self._state)

    def restore_state(self, state, timeout: float = 60.0) -> bool:
        """Swap in a new state (tensors on any device, or numpy leaves as
        :meth:`device_state` returns them) under a live round loop — the
        ``sqlite3-restore`` analog. The swap is staged and applied at the
        next round boundary by the round thread itself (never racing an
        in-flight step); with no round thread it applies inline. Returns
        True once applied; False if it timed out or was superseded by a
        newer restore — in both failure cases the staged state is
        withdrawn."""
        ev = threading.Event()
        box = {"applied": False}
        with self._input_lock:
            if self._pend_restore is not None:
                # supersede: wake the earlier caller un-applied
                _, old_ev, _old_box = self._pend_restore
                self._pend_restore = None
                old_ev.set()
            self._pend_restore = (state, ev, box)
            loop_running = self._thread is not None and self._thread.is_alive()
            if not loop_running or threading.current_thread() is self._thread:
                # no round thread — or we ARE it (crash recovery between
                # rounds): apply inline
                self._apply_pend_restore()
        ok = ev.wait(timeout) and box["applied"]
        if ok:
            with self._snap_lock:
                self._snapshot_host = None
        else:
            with self._input_lock:
                if (self._pend_restore is not None
                        and self._pend_restore[1] is ev):
                    self._pend_restore = None
        return ok

    def memory_report(self) -> dict:
        """Per-table bytes audit of the live state (``obs/memory.py``),
        from tensor metadata only. Served at ``/v1/obs/memory``; the same
        audit feeds the boot-time ``corro.mem.*`` gauges."""
        from corrosion_tpu_torch.obs.memory import memory_report

        return memory_report(self._state, self.n_nodes)

    # --- health / readiness (feeds /v1/health + /v1/ready) ---------------
    def health(self) -> dict:
        """Liveness + readiness summary.

        ``status``: ``ok`` (serving), ``restoring`` (a checkpoint
        restore is staged or being applied), ``backoff`` (the watchdog
        supervisor is between dispatch retries), ``down`` (tripped).
        ``retry_after`` (seconds, present when not ok) feeds the HTTP
        ``Retry-After`` header."""
        with self._input_lock:
            restoring = self._pend_restore is not None or self._recovering
        sup = self._supervisor
        sup_state = sup.state if sup is not None else "idle"
        if self.tripwire.tripped:
            status = "down"
        elif restoring:
            status = "restoring"
        elif sup_state == "backoff":
            status = "backoff"
        else:
            status = "ok"
        out = {
            "status": status,
            "ready": status == "ok",
            "round": self.round_no,
            "generation": self.generation,
            "mode": self.mode,
            "n_nodes": self.n_nodes,
            "device": str(self.device),
        }
        if self.device.type == "cuda":
            # the caching allocator's counts for this process: no device sync
            out["device_bytes"] = torch.cuda.memory_allocated(self.device)
            out["device_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        if sup is not None:
            out["supervisor"] = {
                "state": sup_state,
                "retries": sup.retries,
                "aborts": sup.aborts,
            }
        if status == "backoff":
            out["retry_after"] = max(1, int(round(sup.retry_after_seconds())))
        elif status != "ok":
            out["retry_after"] = 1
        return out

    # --- read path ------------------------------------------------------
    def snapshot(self) -> dict:
        """Host copy of cluster state: store planes, heads, liveness.

        The device-to-host copy happens at most once per round (lazy); on
        the card it is ordered behind the round's queued kernels."""
        with self._snap_lock:
            if self._snapshot_host is not None:
                return self._snapshot_host
            round_no = self.round_no
        # the copy runs OUTSIDE the snapshot lock so the round thread's
        # invalidation never stalls behind a large copy
        st = self._state
        snap = {
            "round": round_no,
            "store": tuple(_host(p) for p in st.crdt.store),  # (ver, val, site, dbv, clp)
            "head": _host(st.crdt.book.head),
            "known_max": _host(st.crdt.book.known_max),
            "hlc": _host(st.crdt.hlc),
            "alive": _host(st.swim.alive),
            "incarnation": _host(self._incarnation(st.swim)),
        }
        with self._snap_lock:
            if self._snapshot_host is None and self.round_no == round_no:
                self._snapshot_host = snap
            return snap

    def read_cell(self, node: int, cell: int) -> dict:
        snap = self.snapshot()
        return {
            "value": int(snap["store"][1][node, cell]),
            "col_version": int(snap["store"][0][node, cell]),
            "site": int(snap["store"][2][node, cell]),
            "db_version": int(snap["store"][3][node, cell]),
            "cl_lifetime": int(snap["store"][4][node, cell]),
        }

    def node_rows(self, node: int) -> np.ndarray:
        """One node's replica as [n_rows, n_cols] values."""
        snap = self.snapshot()
        return snap["store"][1][node].reshape(self.cfg.n_rows, self.cfg.n_cols)

    # --- cluster introspection (admin sync state dump) -------------------
    def sync_state(self, node: int) -> dict:
        """``corrosion sync generate`` analog: heads + needs per origin.

        Need = known_max - head, an upper bound: versions already sitting
        in the node's out-of-order buffer still count as needed until
        applied."""
        from corrosion_tpu_torch.sim.broadcast import HLC_ROUND_BITS

        snap = self.snapshot()
        needs = np.maximum(snap["known_max"][node] - snap["head"][node], 0)
        hlc = int(snap["hlc"][node])
        return {
            "actor_id": node,
            "heads": {str(o): int(h) for o, h in enumerate(snap["head"][node])},
            "need": {
                str(o): int(v) for o, v in enumerate(needs) if v > 0
            },
            # the node's HLC as round.logical (the sync handshake's clock
            # message, peer/mod.rs:1439-1458)
            "ts": f"{hlc >> HLC_ROUND_BITS}.{hlc & ((1 << HLC_ROUND_BITS) - 1)}",
        }

    def members(self) -> list:
        """Member dump incl. region + RTT ring relative to node 0 (the
        reference's members dump shows per-peer ring membership)."""
        from corrosion_tpu_torch.sim.transport import RING_RTT_MS, ring_of

        snap = self.snapshot()
        net = self._net
        ids = torch.arange(self.n_nodes, dtype=torch.int32, device=self.device)
        rings = _host(ring_of(net, torch.zeros_like(ids), ids))
        regions = _host(net.region)
        return [
            {"id": i, "state": "Alive" if bool(a) else "Down",
             "incarnation": int(inc), "region": int(regions[i]),
             "ring": int(rings[i]),
             "rtt_ms": float(RING_RTT_MS[int(rings[i])])}
            for i, (a, inc) in enumerate(
                zip(snap["alive"], snap["incarnation"])
            )
        ]

    def converged(self) -> bool:
        """The check_bookkeeping predicate on the current snapshot."""
        snap = self.snapshot()
        alive = snap["alive"]
        if not alive.any():
            return True
        ref = int(np.argmax(alive))
        same = np.all(
            [np.all(p[alive] == p[ref], axis=1) for p in snap["store"]]
        )
        heads_eq = np.all(snap["head"][alive] == snap["head"][ref])
        no_needs = np.all(
            (snap["known_max"][alive] - snap["head"][alive]) <= 0
        )
        return bool(same and heads_eq and no_needs)
