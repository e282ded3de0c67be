"""State-parity harness: host oracle cluster vs the simulator (port of
``corrosion_tpu/sim/parity.py``).

Drive a real (CPU, pure-Python)
cluster and the scale sim with *identical workload scripts* and compare
final state — the analog of running corro-devcluster next to the
simulator and applying the Antithesis ``check_bookkeeping.py`` predicate
("no needs, equal heads") plus full LWW-store equality.

Determinism contract (SURVEY hard part (d) — RNG models differ, so
parity is defined on RNG-independent facts):

- **single-writer-per-cell** workloads: a cell's ``col_version`` only
  ever advances through its one writer's own writes, so the converged
  store is a pure function of the write script — the oracle and the sim
  must match **bitwise** on all four planes (ver, val, site, dbv).
- **multi-writer** workloads: ``col_version`` bumps from the writer's
  *merged* clock (cr-sqlite semantics, ``local_write``), which depends
  on delivery timing; parity is then **agreement + validity**: every
  node converged to the same store, the winning value for each cell was
  actually written to that cell, and the convergence predicate holds on
  both systems.

The oracle cluster mirrors the sim's protocol semantics exactly
(one-cell writes with ``ver = merged_ver + 1``, per-origin ``db_version``
counters, fanout + rebroadcast budgets, pull-based anti-entropy) in plain
Python over :class:`OracleNode` — deliberately obvious, nothing shared
with the array code.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.sim.oracle import OracleNode, converged
from corrosion_tpu_torch.sim.scale_step import (
    ScaleRoundInput,
    ScaleSimState,
    scale_crdt_metrics,
    scale_sim_config,
    scale_sim_step,
    scale_sim_step_quiet,
)
from corrosion_tpu_torch.sim.transport import NetModel

# (cell, ver, val, site, dbv, clp); origin==site
Change = Tuple[int, int, int, int, int, int]


def _write4(w):
    """Normalize a script write to (node, cell, value, clp). Scripts may
    omit clp (plain LWW workloads — one immortal lifetime, clp=0)."""
    return (*w, 0) if len(w) == 3 else tuple(w)


def _as_tx(w):
    """Normalize a script write to transaction form:
    ``(node, [(cell, value, clp), ...])``. Scripts may record plain
    single-cell writes ``(node, cell, value[, clp])`` or multi-statement
    transactions ``(node, [(cell, value[, clp]), ...])``."""
    if isinstance(w[1], (list, tuple)) and w[1] and isinstance(
        w[1][0], (list, tuple)
    ):
        return w[0], [(*c, 0) if len(c) == 2 else tuple(c) for c in w[1]]
    node, cell, val, clp = _write4(w)
    return node, [(cell, val, clp)]


@dataclass
class WorkloadScript:
    """Per-round write lists, shareable between oracle and sim.

    ``writes[r]`` = list of (node, cell, value[, clp]) committed in round
    r — ``clp`` is the causal-length lifetime (delete/resurrect
    workloads; defaults to 0). One write per node per round (the sim's
    RoundInput shape)."""

    n_nodes: int
    n_origins: int
    n_cells: int
    writes: List[List[Tuple]] = field(default_factory=list)
    # faults[r] = events applied before round r's writes: ("kill", node),
    # ("revive", node), ("partition", [group per node]), ("heal",) —
    # the Antithesis fault surface (kill/revive/partition/heal)
    faults: List[List[Tuple]] = field(default_factory=list)

    @staticmethod
    def random_single_writer(n_nodes: int, n_origins: int, n_cells: int,
                             rounds: int, seed: int = 0,
                             write_prob: float = 0.5) -> "WorkloadScript":
        """Each cell is owned by one writer (cell % n_origins) — the
        bitwise-parity regime."""
        rng = random.Random(seed)
        ws = WorkloadScript(n_nodes, n_origins, n_cells)
        for _ in range(rounds):
            batch = []
            for w in range(n_origins):
                if rng.random() < write_prob:
                    owned = [c for c in range(n_cells) if c % n_origins == w]
                    if owned:
                        batch.append((w, rng.choice(owned),
                                      rng.randrange(1, 1 << 20)))
            ws.writes.append(batch)
        return ws

    @staticmethod
    def random_conflicting(n_nodes: int, n_origins: int, n_cells: int,
                           rounds: int, seed: int = 0,
                           write_prob: float = 0.5,
                           hot_cells: int = 2) -> "WorkloadScript":
        """All writers hammer a few hot cells — the LWW-conflict regime."""
        rng = random.Random(seed)
        ws = WorkloadScript(n_nodes, n_origins, n_cells)
        for _ in range(rounds):
            batch = []
            for w in range(n_origins):
                if rng.random() < write_prob:
                    batch.append((w, rng.randrange(hot_cells),
                                  rng.randrange(1, 1 << 20)))
            ws.writes.append(batch)
        return ws

    @staticmethod
    def random_delete_resurrect(n_nodes: int, n_origins: int, n_rows: int,
                                n_cols: int, rounds: int, seed: int = 0,
                                op_prob: float = 0.6) -> "WorkloadScript":
        """Row-lifecycle workload: inserts, updates, deletes, resurrects —
        the causal-length regime (``doc/crdts.md`` ``cl``). Cell layout:
        ``row*n_cols`` is the CL register, value cells follow. Deletes
        race in-flight updates and resurrects race stale lifetimes
        through the network — agreement+validity parity regime."""
        rng = random.Random(seed)
        ws = WorkloadScript(n_nodes, n_origins, n_rows * n_cols)
        cl = [0] * n_rows
        for _ in range(rounds):
            batch = []
            for w in rng.sample(range(n_origins), n_origins):
                if rng.random() >= op_prob:
                    continue
                row = rng.randrange(n_rows)
                live = cl[row] % 2 == 1
                if not live or rng.random() < 0.3:
                    # insert/resurrect (dead row) or delete (live row):
                    # bump the causal length register
                    cl[row] += 1
                    batch.append((w, row * n_cols, cl[row], cl[row]))
                else:
                    # update a value column within the current lifetime
                    col = rng.randrange(1, n_cols)
                    batch.append((w, row * n_cols + col,
                                  rng.randrange(1, 1 << 20), cl[row]))
            ws.writes.append(batch)
        return ws

    @staticmethod
    def random_transactions(n_nodes: int, n_origins: int, n_cells: int,
                            rounds: int, tx_cells: int = 4, seed: int = 0,
                            write_prob: float = 0.5) -> "WorkloadScript":
        """Multi-statement transactions over single-writer-owned cells —
        the chunked-changeset regime (``change.rs:66-178``): each commit
        writes ``tx_cells`` distinct owned cells under one db_version;
        remote nodes must apply them atomically. Single-writer per cell
        keeps the bitwise-parity determinism contract."""
        rng = random.Random(seed)
        ws = WorkloadScript(n_nodes, n_origins, n_cells)
        for _ in range(rounds):
            batch = []
            for w in range(n_origins):
                if rng.random() < write_prob:
                    owned = [c for c in range(n_cells) if c % n_origins == w]
                    k = min(tx_cells, len(owned))
                    if k:
                        cells = rng.sample(owned, k)
                        batch.append((w, [(c, rng.randrange(1, 1 << 20))
                                          for c in cells]))
            ws.writes.append(batch)
        return ws

    @staticmethod
    def random_full_mix(n_nodes: int, n_origins: int, n_cells: int,
                        rounds: int, seed: int = 0, write_prob: float = 0.5,
                        hot_cells: int = 4, kill_prob: float = 0.08,
                        revive_prob: float = 0.3,
                        partition_window: Tuple[int, int] = None) -> "WorkloadScript":
        """BASELINE's full-mix correctness config: multi-writer hot cells
        + kill/revive churn + a partition window (split into two halves,
        healed later). Writes only fire at alive, reachable... any alive
        origin (partitioned writers keep writing — divergence repairs on
        heal). The agreement+validity parity regime."""
        rng = random.Random(seed)
        ws = WorkloadScript(n_nodes, n_origins, n_cells)
        alive = [True] * n_nodes
        if partition_window is None:
            partition_window = (rounds // 3, 2 * rounds // 3)
        p_start, p_end = partition_window
        for r in range(rounds):
            events: List[Tuple] = []
            # churn: kill a random alive non-seed node / revive a dead one
            dead = [i for i in range(n_nodes) if not alive[i]]
            if dead and rng.random() < revive_prob:
                node = rng.choice(dead)
                alive[node] = True
                events.append(("revive", node))
            candidates = [i for i in range(4, n_nodes) if alive[i]]
            if candidates and rng.random() < kill_prob:
                node = rng.choice(candidates)
                alive[node] = False
                events.append(("kill", node))
            if r == p_start:
                half = [1 if i >= n_nodes // 2 else 0 for i in range(n_nodes)]
                events.append(("partition", half))
            elif r == p_end:
                events.append(("heal",))
            ws.faults.append(events)
            batch = []
            for w in range(n_origins):
                if alive[w] and rng.random() < write_prob:
                    batch.append((w, rng.randrange(hot_cells),
                                  rng.randrange(1, 1 << 20)))
            ws.writes.append(batch)
        return ws

    @property
    def max_tx_cells(self) -> int:
        return max(
            (len(cells) for batch in self.writes
             for _, cells in (_as_tx(w) for w in batch)),
            default=1,
        )

    def written_values(self) -> Dict[int, set]:
        """cell -> set of all values ever written to it (validity check)."""
        out: Dict[int, set] = {}
        for batch in self.writes:
            for _node, cells in (_as_tx(w) for w in batch):
                for cell, val, _clp in cells:
                    out.setdefault(cell, set()).add(val)
        return out


class OracleCluster:
    """N pure-Python nodes speaking the sim's protocol semantics."""

    def __init__(self, n_nodes: int, n_origins: int, n_cells: int,
                 fanout: int = 3, rebroadcast_budget: int = 3,
                 sync_peers: int = 2, seed: int = 0):
        self.n_nodes = n_nodes
        self.n_origins = n_origins
        self.n_cells = n_cells
        self.fanout = fanout
        self.sync_peers = sync_peers
        self.budget = rebroadcast_budget
        self.rng = random.Random(seed)
        self.nodes = [OracleNode(n_origins) for _ in range(n_nodes)]
        self.next_dbv = [1] * n_nodes
        # per-node *complete* version payloads for serving sync:
        # (origin, dbv) -> tuple of (Change, seq, nseq) — a node can only
        # serve versions it holds whole (its store never contains torn
        # versions, so neither can what it serves)
        self.payloads: List[Dict[Tuple[int, int], tuple]] = [
            {} for _ in range(n_nodes)
        ]
        # chunks of not-yet-complete versions, promoted to payloads at
        # completion: (origin, dbv) -> {seq: (Change, seq, nseq)}
        self.payload_chunks: List[Dict[Tuple[int, int], dict]] = [
            {} for _ in range(n_nodes)
        ]
        # per-node broadcast queue: (change, seq, nseq, remaining tx)
        self.queues: List[List[tuple]] = [[] for _ in range(n_nodes)]

    # --- write path ------------------------------------------------------
    def write(self, node: int, cell: int, value: int, clp: int = 0) -> None:
        self.write_tx(node, [(cell, value, clp)])

    def write_tx(self, node: int, cells) -> None:
        """Commit a multi-statement transaction: all cells share one
        db_version, stamped seq 0..n-1 (``ChunkedChanges``,
        ``change.rs:66-178``); applied atomically to the writer's own
        store. ``cells`` = [(cell, value, clp), ...], distinct cells."""
        if node >= self.n_origins:
            raise ValueError(
                f"node {node} is not a writer (n_origins="
                f"{self.n_origins})"
            )
        me = self.nodes[node]
        dbv = self.next_dbv[node]
        self.next_dbv[node] += 1
        nseq = len(cells)
        chunks = []
        for seq, (cell, value, clp) in enumerate(cells):
            cur = me.store.get(cell)
            ver = (cur[0] if cur else 0) + 1  # bump the merged clock
            chunks.append(((cell, ver, value, node, dbv, clp), seq, nseq))
        me.record(node, dbv)
        for (cell, ver, value, site, dbv_, clp), seq, _n in chunks:
            me.merge_cell(cell, ver, value, site, dbv_, clp)
            self.queues[node].append(
                ((cell, ver, value, site, dbv_, clp), seq, nseq, self.budget)
            )
        self.payloads[node][(node, dbv)] = tuple(chunks)

    # --- dissemination round ---------------------------------------------
    def round(self) -> None:
        # broadcast flush: every queued change goes to a random fanout set
        deliveries: List[tuple] = []
        for src in range(self.n_nodes):
            newq = []
            for ch, seq, nseq, tx in self.queues[src]:
                targets = self.rng.sample(
                    [t for t in range(self.n_nodes) if t != src],
                    min(self.fanout, self.n_nodes - 1),
                )
                deliveries.extend((t, ch, seq, nseq) for t in targets)
                if tx - 1 > 0:
                    newq.append((ch, seq, nseq, tx - 1))
            self.queues[src] = newq
        for dst, ch, seq, nseq in deliveries:
            self._ingest(dst, ch, seq, nseq)
        # anti-entropy: each node pulls its missing versions from peers
        for node in range(self.n_nodes):
            peers = self.rng.sample(
                [p for p in range(self.n_nodes) if p != node],
                min(self.sync_peers, self.n_nodes - 1),
            )
            for peer in peers:
                self._sync_pull(node, peer)

    def _ingest(self, dst: int, ch: Change, seq: int = 0, nseq: int = 1) -> None:
        cell, ver, val, site, dbv, clp = ch
        fresh = self.nodes[dst].apply_chunk(
            (cell, ver, val, site, site, dbv, clp), seq, nseq
        )
        if fresh:
            chunks = self.payload_chunks[dst].setdefault((site, dbv), {})
            chunks[seq] = (ch, seq, nseq)
            if dbv in self.nodes[dst].seen.get(site, set()):
                # version now whole -> servable via sync
                self.payloads[dst][(site, dbv)] = tuple(chunks.values())
                del self.payload_chunks[dst][(site, dbv)]
            self.queues[dst].append((ch, seq, nseq, max(1, self.budget - 1)))

    def _sync_pull(self, node: int, peer: int) -> None:
        """compute_available_needs + serve: pull every version the peer
        can grant whole that we lack (``sync.rs:127``) — the bi channel
        transfers a version's full seq range atomically."""
        mine, theirs = self.nodes[node], self.nodes[peer]
        for origin in range(self.n_origins):
            their_seen = theirs.seen.get(origin, set())
            my_seen = mine.seen.get(origin, set())
            for dbv in sorted(their_seen - my_seen):
                chunks = self.payloads[peer].get((origin, dbv))
                if chunks is not None:
                    for ch, seq, nseq in chunks:
                        self._ingest(node, ch, seq, nseq)

    # --- harness ---------------------------------------------------------
    def run(self, script: WorkloadScript, settle_rounds: int = 64) -> int:
        """Apply the script, then settle until converged. Returns rounds
        taken (-1 if it never converged — a harness failure)."""
        for batch in script.writes:
            for node, cells in (_as_tx(w) for w in batch):
                self.write_tx(node, cells)
            self.round()
        for r in range(settle_rounds):
            if not any(self.queues) and converged(self.nodes):
                return len(script.writes) + r
            self.round()
        return len(script.writes) + settle_rounds if converged(self.nodes) else -1

    def store_planes(self) -> Tuple[np.ndarray, ...]:
        """Node-0's converged store as dense (ver, val, site, dbv, clp)
        planes (after ``run`` all nodes are identical)."""
        planes = [np.zeros(self.n_cells, np.int32) for _ in range(5)]
        for cell, (ver, val, site, dbv, clp) in self.nodes[0].store.items():
            planes[0][cell], planes[1][cell] = ver, val
            planes[2][cell], planes[3][cell] = site, dbv
            planes[4][cell] = clp
        return tuple(planes)


# --- sim-side runner ------------------------------------------------------

def run_sim_script(script: WorkloadScript, seed: int = 0,
                   settle_rounds: int = 512, drop_prob: float = 0.0,
                   quiet: str = "auto", device="cuda"):
    """Run the scale sim on ``device`` under the same script until
    converged: the JAX package's ``run_sim_script`` round for round, with
    the same config, keys, fault folding and final revive-all-and-heal.

    ``quiet="on"`` routes every round through ``scale_sim_step_quiet``;
    "auto" and "off" run the dense round.

    Returns (store planes [N, n_cells] x5 as numpy, alive mask,
    rounds-taken or -1).
    """
    dev = resolve_device(device)
    n = script.n_nodes
    n_rows = max(1, (script.n_cells + 3) // 4)
    tx_k = script.max_tx_cells
    cfg = scale_sim_config(
        n, n_origins=script.n_origins,
        n_rows=n_rows, n_cols=(script.n_cells + n_rows - 1) // n_rows,
        sync_interval=4, tx_max_cells=tx_k, quiet=quiet,
    )
    # the configured grid must cover the script's cell space
    if cfg.n_cells < script.n_cells:
        raise ValueError(
            f"config grid has {cfg.n_cells} cells < script's "
            f"{script.n_cells}"
        )
    st = ScaleSimState.create(cfg, dev)
    net = NetModel.create(n, drop_prob=drop_prob, device=dev)
    step_fn = scale_sim_step_quiet if cfg.quiet == "on" else scale_sim_step
    key = prng.key(seed)
    quiet_in = ScaleRoundInput.quiet(cfg, dev)
    now = 0  # host mirror of st.crdt.now (a fresh state starts at 0)

    def step(st, net, inp):
        nonlocal key, now
        key, sub = prng.split(key)
        st, _ = step_fn(cfg, st, net, sub, inp, now=now)
        now += 1
        return st

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    def round_input(batch):
        wm = np.zeros(n, bool)
        wc = np.zeros(n, np.int32)
        wv = np.zeros(n, np.int32)
        wl = np.zeros(n, np.int32)
        tm = np.zeros(n, bool)
        tl = np.ones(n, np.int32)
        tc = np.zeros((n, tx_k), np.int32)
        tv = np.zeros((n, tx_k), np.int32)
        tp = np.zeros((n, tx_k), np.int32)
        seen_nodes = set()
        for node, cells in (_as_tx(w) for w in batch):
            # the sim's RoundInput holds ONE write per node per round; a
            # second same-node write would silently overwrite the lanes
            # and diverge from the oracle's apply-all-in-order semantics
            if node in seen_nodes:
                raise ValueError(
                    f"script batch has two writes for node {node}; the "
                    f"sim round carries one write per node per round"
                )
            seen_nodes.add(node)
            if len(cells) == 1:
                cell, val, clp = cells[0]
                wm[node], wc[node], wv[node], wl[node] = True, cell, val, clp
            else:
                tm[node], tl[node] = True, len(cells)
                for i, (cell, val, clp) in enumerate(cells):
                    tc[node, i], tv[node, i], tp[node, i] = cell, val, clp
        return quiet_in._replace(
            write_mask=on_dev(wm), write_cell=on_dev(wc),
            write_val=on_dev(wv), write_clp=on_dev(wl),
            tx_mask=on_dev(tm), tx_len=on_dev(tl),
            tx_cell=on_dev(tc), tx_val=on_dev(tv), tx_clp=on_dev(tp),
        )

    def apply_faults(inp, net, events):
        """Fold one round's fault events into the RoundInput + NetModel."""
        kill = np.zeros(n, bool)
        revive = np.zeros(n, bool)
        for ev in events:
            if ev[0] == "kill":
                kill[ev[1]] = True
            elif ev[0] == "revive":
                revive[ev[1]] = True
            elif ev[0] == "partition":
                net = net._replace(partition=on_dev(np.asarray(ev[1], np.int32)))
            elif ev[0] == "heal":
                net = net._replace(partition=torch.zeros(n, dtype=torch.int32, device=dev))
            else:
                raise ValueError(f"unknown fault event {ev!r}")
        if kill.any() or revive.any():
            inp = inp._replace(kill=on_dev(kill), revive=on_dev(revive))
        return inp, net

    for r, batch in enumerate(script.writes):
        inp = round_input(batch)
        if r < len(script.faults):
            inp, net = apply_faults(inp, net, script.faults[r])
        st = step(st, net, inp)
    # settle with every node revived and partitions healed (the harness's
    # final repair phase — dead nodes rejoin and catch up via sync)
    if script.faults:
        net = net._replace(partition=torch.zeros(n, dtype=torch.int32, device=dev))
        st = step(st, net, quiet_in._replace(revive=~st.swim.alive))
    taken = -1
    for r in range(settle_rounds + 1):  # +1: check AFTER the last step too
        if bool(scale_crdt_metrics(cfg, st)["converged"]):
            taken = len(script.writes) + r
            break
        if r == settle_rounds:
            break
        st = step(st, net, quiet_in)
    planes = tuple(p.cpu().numpy()[:, :script.n_cells] for p in st.crdt.store)
    return planes, st.swim.alive.cpu().numpy(), taken


# --- comparison -----------------------------------------------------------

def check_bitwise_parity(oracle: OracleCluster, sim_planes, alive) -> List[str]:
    """Single-writer regime: every alive sim node's store must equal the
    oracle's converged store, plane by plane. Returns mismatch messages."""
    problems = []
    o_planes = oracle.store_planes()
    names = ("col_version", "value", "site", "db_version", "cl_lifetime")
    for name, op, sp in zip(names, o_planes, sim_planes):
        for node in np.nonzero(alive)[0]:
            if not np.array_equal(sp[node], op):
                bad = np.nonzero(sp[node] != op)[0]
                problems.append(
                    f"{name} plane: sim node {node} differs from oracle at "
                    f"cells {bad.tolist()[:8]} "
                    f"(sim={sp[node][bad[:8]].tolist()} "
                    f"oracle={op[bad[:8]].tolist()})"
                )
                break  # one node per plane is enough signal
    return problems


def check_agreement_validity(script: WorkloadScript, sim_planes,
                             alive) -> List[str]:
    """Multi-writer regime: all alive nodes identical + every winning
    value was actually written to its cell."""
    problems = []
    alive_idx = np.nonzero(alive)[0]
    ref = alive_idx[0]
    for name, plane in zip(("ver", "val", "site", "dbv", "clp"), sim_planes):
        same = np.all(plane[alive_idx] == plane[ref], axis=0)
        if not same.all():
            problems.append(
                f"agreement violated on {name} at cells "
                f"{np.nonzero(~same)[0].tolist()[:8]}"
            )
    written = script.written_values()
    val_plane = sim_planes[1][ref]
    ver_plane = sim_planes[0][ref]
    for cell in range(script.n_cells):
        if ver_plane[cell] <= 0:
            continue
        if cell not in written:
            problems.append(
                f"validity violated: cell {cell} has version "
                f"{int(ver_plane[cell])} but the script never wrote it"
            )
        elif int(val_plane[cell]) not in written[cell]:
            problems.append(
                f"validity violated: cell {cell} holds "
                f"{int(val_plane[cell])}, never written there"
            )
    return problems
