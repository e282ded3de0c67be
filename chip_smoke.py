#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's rounds on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build every kernel from ``corrosion_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together, while the parity phase's CPU half runs:
   ``parity_references``) and print ptxas' register and stack report;
   each of the swim kernel's 24 (18 register forms, 6 wide) and the ingest
   kernel's 150 instantiations is named, and any stack frame or spill in
   one of them fails the run.
2. Hold every kernel form against its plain PyTorch version on the card on
   random valid inputs (the ingest kernel's drawn from the port's PRNG,
   the swim kernel's from torch's generator), and again, untimed, on
   tie-heavy inputs at N three past the configuration's (``_ingest_inputs``
   and ``_swim_inputs`` with ``ties=True``; the swim inputs must give rows
   where two row-addressed steps meet in one hash class), every output
   bitwise equal, tolerance 0; time both with CUDA events: the flagship forms
   at N = 100,000; the 1M point's forms (packed-entry swim kernel with int8
   budgets, ingest with int8 q_tx) at N = 1,000,000; the full view's forms
   at N = 8192 (the recv_slots-wide receive batch, m = 96, on inputs where
   many rows record more messages than the queue's 64 slots, and the
   non-emitting local write, m = 1, both on int32 planes); the empty receive
   batch (m = 0) of ``pig_changes=0`` at N = 100,000; and the forms no
   path here runs (int32 planes at N = 100,000, the non-emitting local write
   at int16/int16 and int16/int8, the swim kernel's other budget tiers at
   N = 1,000,000). The ingest kernel's wide book (more than 32 origins):
   the many-writer flagship's receive, emitting and non-emitting write
   (256 origins, 64x4 cells) at N = 100,000, the full view's mailbox at
   64 origins (N = 8192) and a receive at 48 origins (int16/int8), each on
   inputs whose origins cover every book slot and meet on slots under
   ``% O``; each prints the rows that took, evicted and recorded on a slot
   past 32, and fails if any count is 0. The row kept in global memory
   (more than 256 cells): the large table's receive, emitting and
   non-emitting write (1024x4 = 4,096 cells, int16/int16) at N = 100,000,
   the full view's mailbox at 4,096 cells (N = 8192, int32/int32), the
   wide book (256 origins) at 4,096 cells and int16/int8 at 4,100 cells (a
   partial last group of 32); each prints the rows whose batch winners
   wrote a cell past 256, and fails if there are none. The deep form (more
   than 64 queue slots or 4 seen words): the deep queue's receive (m =
   128), emitting write (32 picks) and non-emitting write (256 origins,
   128 slots, 8 words) at N = 100,000, the full view's mailbox at 128 slots
   and 8 words (N = 8192, int32/int32) and a receive at 128 slots and 8
   words with the register book (int16/int8), on inputs with few empty
   queue slots and versions over the whole window; each prints the rows
   that placed a message into a slot past 64, recorded a seen bit past
   word 4 and (emitting) made more than 16 live picks, and fails if a
   count its widths and payload budget can reach is 0. The long form (more
   than 128 messages or 32 picks): the wide packet's receive (m = 256)
   and emitting write (64 picks) at N = 100,000, the widest the 128-slot
   queue allows (a receive of 512 messages, an emitting write of 128
   picks) at N = 100,000, the full view's mailbox at recv_slots = 256 (N =
   8192, int32/int32) and an int16/int8 receive of 256 messages with the
   register book; each prints the rows with a fresh message past message
   128, a duplicate whose first occurrence lies in an earlier 128-message
   chunk and a cell won past message 128 and (emitting) more than 32 live
   picks, and fails if a count the payload budget can reach is 0. The swim
   kernel's wide form (more than 128 member slots): the wide member table
   (m = 256) at N = 100,000 in every dtype pair, aligned (its int16/int16
   form on the members path) and packed (16 entries a packet), an aligned
   m = 200 (the general modulo), a packed m = 256 with 256 entries a packet
   (1,024 a row) and m = 1,024 aligned and packed (64 entries a packet),
   these three at N = 25,000.
3. Run 11 rounds of ``scale_sim_config(4096, sync_interval=2,
   sync_sweep_every=2)`` with writes, churn and 5 % message loss once on
   the card (kernels) and once on the CPU (plain versions); every state leaf
   and round-info value must be bitwise equal after every round. The same
   for the 1M point's configuration and the many-writer configuration
   (256 origins, 64x4 cells: the ingest kernel's wide book, once a round
   in each of its two forms) at 4096 nodes, the large table (1024x4 cells:
   the row in global memory, likewise) at 2048; and the deep queue (``QUEUES``:
   the deep form, likewise) at 1024 nodes for 14 rounds with a quarter of
   the nodes writing each round (the CPU route at 4096 nodes takes ~10 s a
   round at these widths), queue slots past 64 occupied on both sides at
   the end; and the wide packet (``PACKETS``: the long form) at 1024 nodes
   for 11 rounds likewise, with rows that made more than 32 live picks on
   both sides; and the wide member table (``MEMBERS``: the swim kernel's
   wide form, once a round under its ``/m256`` key) at 1024 nodes for 11
   rounds, aligned and packed under the 1M point's tiers, rows with an
   occupied member slot at or past 128 on both sides and a sync round
   inside. (The CPU route is held bitwise to the JAX package by
   ``tests/test_torch_*.py``.)
4. The flagship: ``scale_sim_config(100_000)`` with bench.py's workload
   (``sim.scale_step.flagship_workload``), 2 warm-up rounds, then three
   timed batches of 8 rounds. Each kernel's launch count over the timed
   rounds must equal the number of rounds; prints each batch's rounds/s,
   their median and peak device memory.
4b. writers: the many-writer flagship, ``scale_sim_config(100_000,
   n_origins=256, n_rows=64)`` (bench.py's heavier mix) with bench.py's
   workload, 2 warm-up rounds, then ten timed batches of 2 rounds; each
   kernel once a round, K2 and K3 under their ``/o256`` form keys; fresh,
   delivered and syncs above 0 and book slots past 32 owned at the end;
   prints the median and quartiles of rounds/s and peak device memory.
4c. tables: the large table, ``scale_sim_config(100_000, n_rows=1024,
   n_cols=4)`` (4,096 cells a row, the flagship's other knobs), the same
   way: K2 and K3 under their ``/c4096`` form keys, cells past 256 written
   at the end; prints rounds/s, peak device memory, and the state's bytes
   beside the static projection (``obs.memory.projected_bytes``), which
   must be equal.
4d. queues: the deep queue, ``scale_sim_config(100_000, **QUEUES)`` (128
   queue slots, a 256-version window, 32 changes a packet, the many-writer
   flagship's other knobs), under a write burst (``queues_workload``: every
   node writes with probability 0.25 a round, 1 % loss), the same way: K2
   and K3 under their ``/o256/q128/w8`` form keys (the receive's with
   ``/m128``), rows holding more than 64 occupied queue slots at the end,
   the state's bytes equal to the projection.
4e. packets: the wide packet, ``scale_sim_config(100_000, **PACKETS)`` (the
   deep queue with 64 changes a packet: a receive of 256 messages, 64
   picks), under the same write burst, the same way: K2 and K3 under
   their long-form keys (``/m256/o256/q128/w8`` and ``/o256/q128/w8/r64``),
   rows holding more than 32 live queue slots at the end, the state's
   bytes equal to the projection, its rounds/s printed beside the
   flagship's of phase 4.
4f. members: the wide member table, ``scale_sim_config(100_000,
   m_slots=256)`` (the flagship's other knobs), with bench.py's workload,
   the same way as 4b: K1 under its wide key (``aligned/16/16/m256``), rows
   with an occupied member slot at or past 128 at the end, the state's
   bytes equal to the projection, its rounds/s printed beside the
   flagship's of phase 4.
5. The 1M point: ``sim.scale_step.million_config()`` (bounded member
   piggyback, int8 budget and queue-counter planes) with the same workload,
   2 warm-up rounds, then three timed batches of 4 rounds. Each kernel must
   launch once a round, in that configuration's forms; prints rounds/s,
   peak device memory and the carried state's bytes; then one ``[dtype]``
   line: every ``NARROW_LEAVES`` name of ``analysis/dtypes.py`` is in the
   carry, on the card, at exactly its declared width.
6. cost: the static memory projection and the per-round cost model
   (``analysis/shapes.py``, ``analysis/cost.py``) on the card. ``mem-report
   --n-nodes 100000`` (the CLI, in this process, on the card by default)
   must equal ``static_report(scale_sim_config(100_000))`` leaf for leaf, and the
   1M phase's carried state, audited before it is freed, the projection of
   ``million_config()``. One flagship round at N=100,000 (a sync-and-sweep
   round) is counted on the card with K1-K3 launched inside it and must
   equal the fit of ``scale_sim_step`` made in this process from CPU points,
   exactly; ``sharded_scale_run`` counted directly at the 1M point
   (``ROOFLINE_POINT``, flagship template) must equal its fit's projection,
   exactly. Prints the model's bytes over the memory rate beside the same
   round's time, each kernel unit's bytes and operations beside the kernel
   table's count for that call, and the static roofline of the three scan
   entries.
6b. mesh: the node-axis sharding (``parallel/``), one
   process with a thread per shard. ``scale_sim_config(100_000)`` with the
   flagship workload, 8 rounds ending on a sync-and-sweep round, on a mesh
   of 4 shards (the one card repeated, or 4 cards where there are): the
   state, infos and key bitwise equal to the unsharded 8 rounds, K1-K3
   launched 4 times a round; the same 8 rounds as 4 + 4 chained on a
   ``(2, 2)`` multihost mesh; a checkpoint saved from the mesh of 4 (4
   slice files) restored onto 2 shards and onto one device, 2 more rounds
   each, bitwise equal to the uninterrupted run; ``million_config()`` (the
   1M phase's inputs) 3 rounds on the mesh of 4, bitwise equal to
   unsharded, in the packed/int8 forms. Prints the exchange bytes a round
   by site, the sharded and unsharded rounds/s and the 1M leg's peak bytes.
7. The quiet round: ``quiet="on"`` on the card against ``quiet="off"`` on
   the card and ``quiet="on"`` on the CPU, on a settled trace; every state
   leaf and info value must be bitwise equal, the fixpoint branch must run,
   and each kernel must launch once in every dense round of the card's
   ``quiet="on"`` run and in no fixpoint round.
8. The full view, card vs CPU: 11 rounds of ``scenario.full_mix`` (churn,
   conflict-heavy writes, 1 % loss) at ``full_view_config(1024)``; every
   state leaf and info value bitwise equal after every round.
9. The full view at ``full_view_config(8192)`` (O(N^2) membership view,
   recv_slots = 96) with the same workload: 2 warm-up rounds, then three
   timed batches of 4 rounds. The ingest kernel must launch once a round as
   the local write (m = 1) and once as the receive batch (m = 96), and the
   swim kernel never; prints rounds/s, peak device memory and the carried
   state's bytes.
10. tx-trajectory: phase 3's trajectory (11 rounds) for the configurations whose CRDT
   half takes the plain route or the empty batch: multi-cell transactions
   (``tx_max_cells=4``), the wire-budget lane (``bcast_wire_budget``), and
   ``pig_changes=0``. Card and CPU bitwise equal after every round; the
   swim kernel launches once a round in all three; the ingest kernel never
   in the first two, and at ``pig_changes=0`` once a round as the
   non-emitting local write and once as the empty receive batch (m = 0).
11. full-tx-trajectory: phase 8 at ``wan_config(1024, n_origins=16)``
    (``tx_max_cells=8``, the agent's full-view default) with one seeded
    transaction of 1..8 cells per writing origin and round; card and CPU
    bitwise equal after every round, transactions completed, no kernel
    launched (the configuration takes the plain route).
12. tx, wirebudget: ``scale_sim_config(100_000, n_origins=16,
    tx_max_cells=4)`` and ``scale_sim_config(100_000, n_origins=16,
    bcast_wire_budget=True)`` with the flagship's workload (routed through
    ``make_write_inputs``' transaction branch for the first): 2 warm-up
    rounds, then ten timed batches of 2 rounds; median and quartiles of
    rounds/s, peak device memory; the swim kernel launches once a round,
    the ingest kernel never.
13. full-tx: ``wan_config(8192, n_origins=16)`` under ``full_mix`` with
    phase 11's transactions: 2 warm-up rounds, then ten timed batches of 1
    round; median and quartiles of rounds/s, peak device memory; no kernel
    launches.
14. parity: BASELINE's state-parity check at N=256 (16 origins, 64
    cells, 24 rounds, up to 512 rounds to settle): single-writer scripts
    (without and with 5 % loss) and multi-cell transactions (tx 4, plain
    route) equal to the pure-Python oracle cluster bitwise; conflicting,
    delete/resurrect and full-mix scripts (kill, revive, partition, heal)
    agree and hold only written values. The three single-writer scripts
    also run on ``native.NativeCluster`` (the C++ host oracle,
    ``native/corro_host.cpp``, built with g++ by the port's bindings),
    whose stores equal the card's planes bitwise. Every script converges on
    both sides, the card equals the CPU route bitwise, and each kernel
    launches once a round (the swim kernel alone at tx 4); the single writer
    also runs ``quiet="on"`` to the same result. The oracles and the CPU
    route run while the kernels build (phase 1), the card here.
15. soak: the flagship for 16 rounds straight, as ``run_segmented`` in 2
    segments of 8 with the async writer (keep_last 2), and as its first
    8 rounds segmented then ``resume_segmented`` from disk: every leaf
    and info bitwise equal, the same launches per form, peak device bytes
    within 5 % of the straight run's; prints rounds/s, checkpoint stall
    and writer seconds, one checkpoint's bytes, and save, verify and load
    seconds.
16. full-soak: ``full_view_config(1024)`` for 16 rounds, one segment of 8
    checkpointed and resumed from disk, equal to the straight run bitwise,
    with the ingest kernel at m = 96 once a round.
17. agent-trajectory: two never-started agents at the agent's default
    config with 4096 nodes, one on the card and one on the CPU, driven by
    hand through the same SQL writes (a ``Database`` each), kills, a
    revive, a partition and its heal for 24 rounds: ``device_state()``
    bitwise equal after every round, the same query rows, and each kernel
    once a round on the card.
18. agent: ``python -m corrosion_tpu_torch agent`` as a process at
    N=100,000 (the ``Config`` defaults otherwise), a schema file, an
    ephemeral API port and ``pg.enabled`` on an ephemeral port: a row
    written at node 0 through the HTTP client is
    polled at node 99,999 until it is there (at most 400 rounds); 25
    pairs of queries are timed; the live loop's rounds/s is read from
    ``/v1/health``, quiet and under back-to-back queries; over PG wire
    (the load harness's ``_PgClient``) the row is read at node 99,999
    selected by database name, a PG-wire INSERT is read back over HTTP at
    node 50,000, one extended-protocol statement (Parse, Bind, Execute,
    Sync) runs and 20 simple queries are timed; ``template --once`` renders
    the table's rows and ``consul sync --once`` mirrors a stub Consul
    agent's services into ``consul_services`` (both as processes); the
    admin socket kills and revives a node and writes a
    checkpoint that ``verify-checkpoint`` passes; the ``/metrics`` launch
    gauges must show every kernel once a round; SIGTERM must end it with
    exit 0. Then, in this process at the same config, the hand-driven
    agent round, the snapshot copy and ``scale_run_rounds`` are timed.
19. soak-cli: ``python -m corrosion_tpu_torch soak`` as a process at
    N=100,000 (the ``Config`` defaults otherwise), 12 rounds in segments of
    4 with a flight record, an OTLP file and ``--prom-port 0``: ``/metrics``
    is scraped once after the first commit (the soak's rounds and the
    launch gauges), the process is SIGKILLed after its second commit, and
    ``--resume`` runs to the end. The flight record of both runs replays (a
    torn tail allowed), the final checkpoint is bitwise equal to a straight
    ``scale_run_rounds`` in this process on the same config, seed and
    inputs, the resumed run's metric sums equal that run's info sums over
    the rounds it ran, and each kernel launched once in each of them.
20. chaos: (a) every scenario of ``resilience.chaos.SCENARIOS`` at its
    N=24, seed 0, on the card, in a worker process beside (b)-(d), equal
    field for field to the JAX package's verdicts in
    ``tests/data/chaos_verdicts_jax.json`` (digests, rounds to convergence
    and quiescence, info sums, counters, ``ok``; the two remesh scenarios
    sharded over 8, then 4 shards of the one card), with exactly the
    ``fused="off"/"interpret"`` scenario skipped, with its reason;
    (b) ``preempt-storm`` with a settle budget of 512 at
    N=4,096, equal field for field to the JAX package's verdict in
    ``tests/data/chaos_storm_jax.json`` (converged, chaos leg bitwise,
    lineage validated; neither drains its queues within the budget, oracle
    3); (c) ``python -m corrosion_tpu_torch chaos --script`` on the
    committed corpus file, exit 0; (d) the host-plane ``serve-overload``
    (N=8, seed 0, its op plan and guard the defaults') with a 400 ms slow
    consumer (the defaults' 25 ms never overloads it at the port's round
    pace): ``ok`` as the JAX package's verdict is
    (``tests/data/serve_overload_jax.json``), equal to it on the seed-pure
    fields, the slow subscriber shed; its wall-time fields are printed. Each
    kernel launches once in every dense round of (a) and (b) (their sum is
    the chaos forms' launches in the kernel record) and every round of (d);
    the kernels phase holds the three forms at the chaos shapes (m_slots 8,
    4 origins, 4x2 cells) at N=100,000.
21. devcluster: ``python -m corrosion_tpu_torch devcluster
    tests/data/devcluster_topology.txt`` (30 nodes in three components):
    its printed JSON equals the JAX package's
    (``tests/data/devcluster_jax.json``), a write in one region is read in
    another, the launch gauges show each kernel once a round, SIGTERM ends
    it with exit 0.
22. overload: ``python -m corrosion_tpu_torch load --overload`` as a
    process, started before the soak-cli phase and run beside it, chaos
    and devcluster, at its default ramp and rig (N=16) with its time constants
    scaled to the port's pace (``LOAD_OVERLOAD_FLAGS``: a slower slow
    consumer, the lag bound to match, a longer closed-loop retry window):
    exit 0, so the guard holds the degradation contract and the unguarded
    arm breaks it; the plan digest the JAX package's, both arms' counts
    agree and nothing leaks.
23. load: ``obs.load.run_load(n_nodes=100_000)`` in this process, alone,
    with the harness's default clients and half its default ops (4 writers
    x 16 transactions over HTTP, 2 NDJSON subscribers, 2 PG-wire readers x
    16 queries, 12 keys, seed 0): ``ok``, the server's request counts equal
    the clients', the plan digest the JAX package's, each kernel once a
    round of the rig; p50/p95/p99 per op class, QPS, delivery lag, the
    rig's rounds/s and peak device bytes. The kernels phase holds the
    three forms at both serving rigs' shapes (16x4 cells at N=100,000;
    36x4 = 144 cells at N=16).
24. san: the runtime sanitizer (``analysis/sanitizer``) on the card. (a)
    In this process, while the overload bench finishes: corrolint over the
    port with every checker (the sharding contract, dtype-flow and densify
    among them; no finding; each checker's seconds printed), corrosan's nine
    seeded fixtures with ``device="cuda"``, each with its expected verdict;
    then one sanitized window over an agent on the card at a small config
    (N=16) with a ``Supervisor``, a ``SubsManager`` with a persist
    directory, an ``UpdatesManager`` and the HTTP API: four inserts,
    ``/v1/health``, an unsubscribe, shutdown. The gate must be empty, the
    ``SubsManager._mu -> Matcher._mu`` edge witnessed, every named
    witnessed edge in the static lock graph or the allowlist, more than 10
    threads spawned, and each kernel launched inside the window. (b)
    ``CORROSAN=1 python -m corrosion_tpu_torch load --device cuda
    --write-ops 8 --pg-ops 8`` as a process (the CLI's rig, N=16), started
    beside the chaos phase and read after the load phase: exit 0, the
    record ``ok`` with ``corrosan: true`` and no findings, each kernel
    launched.

Each kernel's bound is the larger of the bytes it must move on these inputs
over the memory rate and the integer operations its function needs on them
(counted from what it computes, not from the kernel's loops) over the int32
rate.

The last lines are the card's name and power limit, the per-kernel JSON
record (launches are counted on the path that runs each form, 0 for the
forms no path here runs), and ``{"ok": true, "device": {...}}``. The script
needs one CUDA device and exits non-zero without printing a result when
there is none.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # published HBM3 rate of one H100 SXM
# The kernels do int32 work on the CUDA cores. An SM has 64 INT32 lanes
# beside its 128 FP32 lanes, so the int32 rate is a quarter of the published
# 67 TFLOP/s float32 rate (which counts an FMA as two operations).
H100_INT32_OPS_PER_S = 67e12 / 4
FLAGSHIP_NODES = 100_000
MILLION_NODES = 1_000_000
TRAJECTORY_NODES = 4096  # small enough for the CPU route to keep pace
TRAJECTORY_ROUNDS = 11  # the workload's kill (round 4) and revive (round 10) inside
FULL_NODES = 8192  # the full view's measured point (sim.config.full_view_config)
FULL_TRAJECTORY_NODES = 1024  # the full view, card vs CPU: float ties are common
FULL_TRAJECTORY_ROUNDS = 11  # full_mix and the seeded transactions sync and complete by then
# the many-writer flagship: 256 tracked origins (the ingest kernel's wide
# book) and 64x4 cells, bench.py's heavier mix (BENCH_ORIGINS=256,
# BENCH_ROWS=64)
WRITERS = dict(n_origins=256, n_rows=64)
# the large table: a 1024x4 = 4,096-cell store row (a service-discovery
# table of a thousand rows), past the ingest kernel's staged 256 cells, at
# the flagship's other knobs (16 origins, int16 planes)
TABLES = dict(n_rows=1024, n_cols=4)
# the deep queue: the many-writer flagship with a 128-slot broadcast queue, a
# 256-version seen window (8 words) and 32 changes a packet (a receive batch
# of 4 x 32 = 128 messages), the ingest kernel's deep form (4 queue slots a
# lane), under a write burst (``queues_workload``)
QUEUES = dict(n_origins=256, n_rows=64, buf_slots=256, bcast_queue=128, pig_changes=32)
# the large table, card vs CPU: its CPU route's pace at 4,096 cells a row
TABLES_TRAJECTORY_NODES = 2048
QUEUES_TRAJECTORY_NODES = 1024  # the deep queue, card vs CPU (its CPU route's pace)
QUEUES_TRAJECTORY_ROUNDS = 14  # rows pass 64 queue slots from round ~10 at 1024 nodes
# the wide packet: the deep queue with 64 changes a packet (4 KiB of
# changes at 64 bytes each; a receive batch of 4 x 64 = 256 messages and 64
# picks), the ingest kernel's long form (the batch in global memory, up to
# 4 picks a lane), under the deep queue's write burst
PACKETS = dict(QUEUES, pig_changes=64)
# the wide packet, card vs CPU: the trajectory's kill (round 4) and revive
# (round 10) inside
PACKETS_TRAJECTORY_NODES, PACKETS_TRAJECTORY_ROUNDS = 1024, 11
# the wide member table: 256 member slots a node (the full member list of a
# 256-node cluster with no class collisions, four times the default 64),
# past the swim kernel's register form, at the flagship's other knobs;
# packed, under the 1M point's tiers (``million_config``)
MEMBERS = dict(m_slots=256)
REGISTER_SLOTS = 128  # the swim kernel's register form; past it the wide form
# the wide member table, card vs CPU, aligned and packed: the trajectory's
# kill (round 4) and revive (round 10) inside
MEMBERS_TRAJECTORY_NODES, MEMBERS_TRAJECTORY_ROUNDS = 1024, 11
# the swim kernel's widest forms (m = 1,024; 256 entries a packet) in the
# kernels phase
WIDEST_SWIM_NODES = 25_000
# BASELINE's correctness size: a 256-node cluster, 16 origins, 64 cells
PARITY_NODES, PARITY_ORIGINS, PARITY_CELLS, PARITY_ROUNDS = 256, 16, 64, 24
# empty rounds after the single writer's script for the quiet check: the
# cluster goes quiet about 100 rounds after the last write
PARITY_QUIET_TAIL = 128
SOAK_ROUNDS, SOAK_SEGMENT = 16, 8
# the agent: card vs CPU by hand at 4096 nodes; the process at 100,000
AGENT_TRAJECTORY_NODES, AGENT_TRAJECTORY_ROUNDS = 4096, 24
AGENT_NODES = 100_000
AGENT_BOOT_S = 300  # seconds for "agent up"
AGENT_VISIBLE_ROUNDS = 400  # rounds a write may take to reach the last node
AGENT_RATE_S = 5.0  # seconds of /v1/health rounds for the live loop's rate
AGENT_POLL_S = 0.05  # seconds between the reader's polls
AGENT_STOP_S = 60  # seconds for exit 0 after SIGTERM
AGENT_QUERIES = 25  # rounds with a pair of timed queries each
AGENT_QUERY_S = 120  # seconds the paced queries may take
AGENT_QUERY_POLL_S = 0.01  # seconds between /v1/health reads while pacing
AGENT_PG_QUERIES = 20  # timed PG-wire simple queries at the last node
# the soak subcommand as a process at the flagship's width (the Config
# defaults with n_nodes = SOAK_CLI_NODES), killed after its second commit
SOAK_CLI_NODES, SOAK_CLI_ROUNDS, SOAK_CLI_SEGMENT = 100_000, 12, 4
SOAK_CLI_WAIT_S = 300  # seconds for the two commits, and for the resume
# chaos: every registry scenario at its N=24 against the JAX package's
# verdicts; preempt-storm at the ladder's top rung against the JAX package's
# verdict there; the corpus through the CLI; serve-overload.
# preempt-storm's queues drain about 3.3 N rounds after its start, in both
# packages (13,624 rounds at N=4096: ``chaos --script
# tests/data/preempt_storm_4096.json``, under 12 minutes on the card), so
# the storm settles CHAOS_STORM_SETTLE rounds: it holds convergence, the
# chaos leg's bitwise match and the lineage, and records the quiescence
# outcome beside the reference's
CHAOS_STORM_NODES = 4096
CHAOS_STORM_SETTLE = 512  # the script's settle budget
CHAOS_STORM_VERDICT = "tests/data/chaos_storm_jax.json"
CHAOS_VERDICTS = "tests/data/chaos_verdicts_jax.json"
CHAOS_CORPUS = "tests/chaos_corpus/fuzz-000024-min.json"
#: the scenarios the port skips, with a word of each reason
CHAOS_SKIPS = {"fused-flip": "rules of the port"}
# serve-overload (the host-plane scenario), held to the JAX package's verdict
# at its defaults on its seed-pure fields and ``ok``; its slow consumer stalls
# 400 ms a frame (the defaults' 25 ms: the port's rounds at N=8 commit too few
# writes a second to overload it)
SERVE_OVERLOAD_VERDICT = "tests/data/serve_overload_jax.json"
SERVE_OVERLOAD_SLOW_MS = 400.0
# the load harness at the flagship's N with its default clients (4 writers,
# 2 subscribers, 2 PG readers, 12 keys, seed 0) and half its default ops (16
# transactions a writer and 16 queries a reader, not 32: the script's time);
# the plan's digest in the JAX package (tests/test_torch_serve.py derives it
# there)
LOAD_NODES = 100_000
LOAD_OPS = 16
LOAD_PLAN_DIGEST = "e8287e4965bb49b6"
# the overload bench (``load --overload``) at its default ramp and rig (N=16):
# its plan's digest in the JAX package, and its time constants at the port's
# pace (the defaults: a 25 ms slow consumer, a 2.5 s lag bound, 16 closed-loop
# retries). The port's round at N=16 commits too few writes a second for a
# 25 ms (or a 100 ms) consumer to fall behind, so the unguarded arm never
# breaks its bound; a 150 ms one just does. At 250 ms it falls well behind,
# while the guarded arm's lag stays ~50 frames of 250 ms, inside 25 s; and
# the ramp's heaviest stage can outlast 16 retries of 0.25 s
LOAD_OVERLOAD_PLAN_DIGEST = "3050689524567f7d"
LOAD_OVERLOAD_FLAGS = ("--slow-ms", "250", "--lag-bound", "25", "--closed-retries", "64")
#: the sanitized load process: the CLI's rig (N=16), 8 ops a client
SAN_LOAD_FLAGS = ("--write-ops", "8", "--pg-ops", "8")


def _swim_ops(args, pig_k: int = 0) -> int:
    """Integer operations the swim function needs on these operands: a
    channel merge (~10 per slot, packed: ~14 per entry) only on the rows
    where that channel is valid, ~30 per slot for timers, budget and
    stores, ~60 per row."""
    mem_id, ch_valid = args[0], args[18]
    n, m = mem_id.shape
    merge = 14 * pig_k if pig_k else 10 * m
    return sum(_count(v) for v in ch_valid) * merge + n * (30 * m + 60)


def _ingest_ops(p, x, out) -> int:
    """Integer operations the ingest function needs on these operands,
    counted from what it computes, not from the kernel's loops. Per live
    message: the HLC fold (3), the seen check (10), the known-max update
    (2), and a first-occurrence dedupe that sorts the row's live (origin,
    version) keys (2 per compare). Per fresh message: the slot claim (3)
    and the seen-bit record (8); per fresh message on a valid cell one step
    of a running per-cell LWW winner over five keys (12), and 2 per cell to
    seed and write back the winners. The enqueue: 2 per queue slot to build
    the evict keys, the E smallest of them (2 per compare, Q per pick, or a
    sort of Q·⌈log2 Q⌉ compares if that is fewer), 3 per enqueued message.
    Per origin the claim's take or evict (8 + W) and the head advance (8
    per seen word, + 4). The emitting form adds the payload choice: a sort
    of the queue by budget, the R largest draws, 4 per slot, 15 per entry."""
    import torch

    def sort_cmp(k):  # compares to sort k keys, per row
        return k * torch.ceil(torch.log2(torch.clamp(k.to(torch.float64), min=1)))

    n, c, q, r = x.live.shape[0], p.n_cells, p.q_slots, p.pig_r
    live = x.live.sum(dim=1)
    fresh = out.fresh
    applied = fresh & (x.cell >= 0) & (x.cell < c)
    enq = torch.clamp((fresh if p.enqueue_all else fresh & _owned(p, x, out)).sum(dim=1), max=q)
    log_q = int(sort_cmp(torch.tensor(q))) // q
    ops = (15 * int(live.sum()) + 2 * int(sort_cmp(live).sum()) + 11 * _count(fresh)
           + 12 * _count(applied) + n * 2 * c
           + n * 2 * q + 2 * q * int(torch.clamp(enq, max=log_q).sum()) + 3 * int(enq.sum())
           + n * p.n_origins * (12 + 9 * p.seen_words))
    if r:
        ops += n * (2 * q * log_q + 2 * q * min(r, log_q) + 4 * q + 15 * r)
    return ops


def _bound(nbytes: int, ops: int) -> tuple:
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and operations over the int32 rate."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = ops / H100_INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _cuda_ms(fn, iters: int, warm: bool = True) -> float:
    """Mean ms of ``iters`` back-to-back calls of ``fn`` by CUDA events,
    after one untimed call unless ``warm`` is False."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int, kernel: str) -> tuple:
    """Device time of ``kernel`` (a wrapper's name: its device kernels are
    ``{kernel}_kernel`` and ``{kernel}_wide_kernel``) per launch, over
    ``iters`` calls of ``fn`` (one launch each), from ``torch.profiler``:
    the kernel alone, without the wrapper's host time, which CUDA events
    over back-to-back calls include when the kernel is shorter than it.
    Returns (ms a launch, launches the profiler recorded): the mean is
    over the launches it recorded, which in a long run have been fewer
    than were made."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corrosion_tpu_torch.round_profile import _device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = (f"{kernel}_kernel", f"{kernel}_wide_kernel")
    events = [e for e in prof.key_averages() if any(name in e.key for name in names)]
    recorded = sum(e.count for e in events)
    return sum(_device_us(e) for e in events) / max(recorded, 1) / 1e3, recorded


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _count(t) -> int:
    return int(t.sum())


def _flat(x):
    """Tensor leaves of nested NamedTuples / tuples / dicts, in order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return []


def _max_abs_err(a_list, b_list) -> int:
    import torch

    worst = 0
    for a, b in zip(a_list, b_list, strict=True):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"dtype/shape mismatch {a.dtype}{tuple(a.shape)} "
                                 f"vs {b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float32:
            diff = (a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64))
        else:
            diff = a.to(torch.int64) - b.to(torch.int64)
        if diff.numel():
            worst = max(worst, int(diff.abs().max()))
    return worst


def _draws(seed: int, dev):
    """(ri, coin): int32 draws in [lo, hi) and bool coins of probability p,
    from torch's generator on ``dev`` seeded with ``seed``. The swim
    kernel's operands need only be random and reproducible; drawn with the
    port's bit-exact threefry they took a third of the kernels phase's
    time."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def ri(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32, device=dev)

    def coin(shape, p):
        return torch.rand(shape, generator=gen, device=dev) < p

    return ri, coin


def _swim_inputs(n: int, m: int, plane_dtype, seed: int, dev, tx_dtype=None,
                 pig_k: int = 0, ties: bool = False):
    """Random valid operands of the swim kernel (the order of
    ``swim_tables_update``'s arguments after ``consts``), with the timer
    plane at ``plane_dtype`` and the budget plane at ``tx_dtype`` (default
    the same). With ``pig_k > 0`` the channels are packed [n, pig_k] entry
    lists, whose entries often share a hash class within one packet. With
    ``ties``, the inputs where a lane-parallel merge can part from the
    sequential one (``_swim_tie_heavy``)."""
    import torch

    ri, coin = _draws(2 * seed, dev)
    iarr = torch.arange(n, dtype=torch.int32, device=dev)
    self_slot = iarr % m
    mem_id = torch.where(coin((n, m), 0.2), -1, ri((n, m), 0, n))
    own = coin((n,), 0.5)
    rows = iarr.long()
    mem_id[rows[own], self_slot.long()[own]] = iarr[own]
    mem_view = ri((n, m), -1, 64)
    old_id = torch.where(coin((n, m), 0.8), mem_id, ri((n, m), -1, n))
    old_view = torch.where(coin((n, m), 0.8), mem_view, ri((n, m), -1, 64))
    chans = [[], [], [], [], [], []]
    for _ in range(4):
        if pig_k:
            nk = (n, pig_k)
            chans[0].append(torch.where(coin(nk, 0.15), -1, ri(nk, 0, n)))
            chans[1].append(ri(nk, -1, 64))
            chans[2].append(torch.ones(nk, dtype=torch.bool, device=dev))
        else:
            chans[0].append(torch.where(coin((n, m), 0.5), mem_id, ri((n, m), -1, n)))
            chans[1].append(ri((n, m), -1, 64))
            chans[2].append(coin((n, m), 0.7))
        chans[3].append(coin((n,), 0.8))
        chans[4].append(ri((n,), 0, n))
        chans[5].append(ri((n,), 0, 8))
    args = (
        mem_id, mem_view, old_id, old_view,
        ri((n, m), 0, 12).to(plane_dtype), ri((n, m), 0, 14).to(tx_dtype or plane_dtype),
        coin((n,), 0.9), ri((n,), 0, 8), iarr, self_slot,
        ri((n,), -1, 40), ri((n,), 0, 4), ri((n,), 0, m), ri((n,), 0, 40),
        coin((n,), 0.3), *chans,
    )
    return _swim_tie_heavy(args, pig_k, seed) if ties else args


def _swim_tie_heavy(args, pig_k: int, seed: int):
    """``args`` with tie-heavy distributions: each row has a crowded hash
    class whose slot holds one of three ids of that class, and its packets
    (``pig_k > 0``) carry many live entries of those ids, the same id again
    with other views; views are small keys, often DOWN in the table and
    ALIVE in the packets (takes, then merges on the new id), sometimes -1,
    with equal keys common; senders sit on the self slot, on the crowded
    class, are the node itself or are negative; the failed probe's slot is
    often the self slot; timers and budgets are 0, 1 or 2 (timers expire,
    budgets run out), and the heard suspicion ties the incarnation's
    keys."""
    import torch

    (mem_id, mem_view, old_id, old_view, timer, tx, alive, inc, node_id,
     self_slot, sus_heard, sends, probe_slot, suspect_key, probe_failed,
     ch_id, ch_view, ch_send, ch_valid, ch_snd, ch_snd_inc) = args
    n, m = mem_id.shape
    dev = mem_id.device
    ri, coin = _draws(2 * seed + 1, dev)

    crowd = ri((n, 1), 0, m)

    def in_crowd(shape):
        return crowd + m * ri(shape, 0, 3)

    def key(shape, common):
        state = torch.where(coin(shape, 0.5), common, ri(shape, 0, 4))
        return torch.where(coin(shape, 0.1), -1, ri(shape, 0, 3) * 4 + state)

    nm = (n, m)
    cols = torch.arange(m, dtype=torch.int32, device=dev)
    mem_id = torch.where(cols[None, :] == crowd, in_crowd(nm), mem_id)
    mem_view = key(nm, 2)
    old_id = torch.where(coin(nm, 0.7), mem_id, old_id)
    old_view = torch.where(coin(nm, 0.7), mem_view, key(nm, 1))
    inc = ri((n,), 0, 3)
    ids, views = [], []
    for ch in range(4):
        if pig_k:
            nk = (n, pig_k)
            ids.append(torch.where(coin(nk, 0.6), in_crowd(nk),
                                   torch.where(coin(nk, 0.3), -1, ch_id[ch])))
            views.append(key(nk, 0))
        else:
            # the table's id, another id, or the id an earlier channel took
            other = torch.where(coin(nm, 0.5), mem_id + m, ch_id[ch])
            got = torch.where(coin(nm, 0.4), mem_id, other)
            ids.append(torch.where(coin(nm, 0.3), ids[-1], got) if ids else got)
            views.append(key(nm, 0))
    snd = [torch.where(coin((n,), 0.3), node_id,
                       torch.where(coin((n,), 0.5), self_slot + m * ri((n,), 0, 3),
                                   in_crowd((n, 1))[:, 0]))
           for _ in range(4)]
    # a negative sender takes its slot by floor modulo, as Python's %
    snd = [torch.where(coin((n,), 0.1), -1 - ri((n,), 0, 2 * m), x) for x in snd]
    return (
        mem_id, mem_view, old_id, old_view,
        ri(nm, 0, 3).to(timer.dtype), ri(nm, 0, 3).to(tx.dtype),
        alive, inc, node_id, self_slot,
        torch.where(coin((n,), 0.6), inc * 4 + ri((n,), 0, 3), -1), ri((n,), 0, 3),
        torch.where(coin((n,), 0.5), self_slot, crowd[:, 0]), ri((n,), 0, 3) * 4 + 1,
        coin((n,), 0.6), ids, views, ch_send, ch_valid, snd,
        [ri((n,), 0, 3) for _ in range(4)],
    )


def _swim_collisions(args, pig_k: int) -> int:
    """Rows with a same-class collision: two live entries of valid packets
    in one hash class (``pig_k > 0``), or, on aligned rows, two row-addressed
    steps (a valid sender's slot, the failed probe's slot, the self slot)
    on one column."""
    import torch

    (mem_id, _, _, _, _, _, _, _, _, self_slot, _, _, probe_slot, _, probe_failed,
     ch_id, _, _, ch_valid, ch_snd, _) = args
    m = mem_id.shape[1]
    if pig_k:
        slots = [torch.where(v[:, None] & (i >= 0), i % m, -1) for i, v in zip(ch_id, ch_valid)]
    else:
        slots = [torch.where(v, s % m, -1)[:, None] for s, v in zip(ch_snd, ch_valid)]
        slots += [torch.where(probe_failed, probe_slot, -1)[:, None], self_slot[:, None]]
    slots = torch.cat(slots, dim=1)
    # an inactive step gets a distinct negative slot of its own
    idx = torch.arange(slots.shape[1], dtype=slots.dtype, device=slots.device)
    slots = torch.where(slots >= 0, slots, -1 - idx)
    s = torch.sort(slots, dim=1).values
    return int((s[:, 1:] == s[:, :-1]).any(dim=1).sum())


def _swim_bytes(args, out, pig_k: int = 0) -> int:
    """Bytes the swim kernel must move on these operands: every plane once,
    except what it skips by the data. A failed probe's slot and key are
    read only where the probe failed. A channel is read only on the rows
    where it is valid (its sender and sender incarnation too); there its
    view only where the id is live and sendable, its send flag only where
    the id is live. A packed channel (``pig_k > 0``) has no send flags, and
    its view is read where its entry's id is live. Every output is written
    once."""
    (mem_id, mem_view, old_id, old_view, timer, tx, alive, inc, node_id,
     self_slot, sus_heard, sends, probe_slot, suspect_key, probe_failed,
     ch_id, ch_view, ch_send, ch_valid, ch_snd, ch_snd_inc) = args
    m = mem_id.shape[1]
    total = _nbytes((mem_id, mem_view, old_id, old_view, timer, tx, alive, inc,
                     node_id, self_slot, sus_heard, sends, probe_failed))
    total += (probe_slot.element_size() + suspect_key.element_size()) * _count(probe_failed)
    for ch in range(4):
        valid = ch_valid[ch]
        rows = _count(valid)
        live = valid[:, None] & (ch_id[ch] >= 0)
        total += _nbytes((valid,))
        total += rows * (ch_snd[ch].element_size() + ch_snd_inc[ch].element_size()
                         + (pig_k or m) * ch_id[ch].element_size())
        if pig_k:
            total += _count(live) * ch_view[ch].element_size()
            continue
        total += _count(live) * ch_send[ch].element_size()
        total += _count(live & ch_send[ch]) * ch_view[ch].element_size()
    return total + _nbytes(_flat(out))


# book slots of the ingest kernel's register book (a slot a lane); past them
# its wide-book instantiation keeps the book in shared memory
NARROW_BOOK = 32
# cells of the ingest kernel's staged store row (8 a lane in shared memory);
# past them its row stays in global memory
STAGED_CELLS = 256
# queue slots and seen words of the ingest kernel's shallow forms (one or
# two slots a lane); past either its deep form runs (4 slots a lane, up to 8
# words). A payload of more than SHALLOW_PICKS picks fills lanes past a half
# warp
SHALLOW_QUEUE, SHALLOW_WORDS, SHALLOW_PICKS = 64, 4, 16
# messages of the ingest kernel's register batch (KM 1 and 4) and picks of
# its one pick a lane; past either its long form runs (the batch in global
# memory, up to 4 picks a lane)
REGISTER_MSGS, ONE_PICK = 128, 32

# The ingest kernel's forms: (messages per row from cfg, emit, enqueue_all,
# no drift reject, the messages' origin and version ranges and live share).
# "receive" is the scale round's piggyback batch, "receive_full" the full
# view's mailbox of recv_slots messages (versions mostly past the seen
# window, origins below n_origins, so that many rows record more messages
# than the queue holds), "write" the local write of
# ``broadcast.local_write``, "write_emit" the scale round's local write.
INGEST_FORMS = {
    "receive": (lambda cfg: 4 * cfg.pig_changes, False, False, False, (64, 40, 0.7)),
    "receive_full": (lambda cfg: cfg.recv_slots, False, False, False, (16, 4000, 0.9)),
    "write": (lambda cfg: 1, False, True, True, (64, 40, 0.7)),
    "write_emit": (lambda cfg: 1, True, True, True, (64, 40, 0.7)),
}


def _ingest_inputs(cfg, n: int, form: str, seed: int, dev, ties: bool = False):
    """Random valid operands of the ingest kernel in ``form`` at ``cfg``'s
    widths and queue-plane dtypes. With ``ties``, the inputs where a
    lane-parallel rank can part from the sequential loops: queue counters
    and budgets from {1, 2}, uniforms on a grid of quarters (equal float32
    draws), each row's messages on two cells with equal (clp, ver, val,
    site) and store cells that tie them, repeated (origin, dbv) pairs and
    repeated versions across origins in a row, live and dead, and a payload
    budget of a few slots."""
    import torch

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.ops.megakernel import IngestInputs, IngestParams
    from corrosion_tpu_torch.sim.broadcast import (
        CHANGE_WIRE_BYTES,
        HLC_MAX_DRIFT_ROUNDS,
        HLC_ROUND_BITS,
        plane_dtypes,
    )

    msgs, emit, enqueue_all, no_drift, (o_hi, dbv_hi, p_live) = INGEST_FORMS[form]
    m = msgs(cfg)
    ks = iter(prng.split(prng.key(seed), 64))

    def ri(shape, lo, hi):
        return prng.randint(next(ks), shape, lo, hi, dev)

    def coin(shape, p):
        return prng.uniform(next(ks), shape, dev) < p

    def planes(shape, fields):
        """int32 planes in [0, hi) for each (bit shift, hi) of ``fields``,
        all sliced from one draw of 32 bits an element: past the staged
        row's cells a draw a plane would dominate the phase's time."""
        drawn = prng.bits(next(ks), shape, dev)
        return tuple(((drawn >> sh) % hi).to(torch.int32) for sh, hi in fields)

    o, c, q = cfg.n_origins, cfg.n_cells, cfg.bcast_queue
    w = max(1, -(-cfg.buf_slots // 32))
    org_hi = 64
    # the deep form: versions over the whole window of more than 4 words and
    # past it (the mailbox's already reach past it), and a fuller queue, so
    # that rows record bits past word 4 and place messages past slot 64
    if w > SHALLOW_WORDS and form != "receive_full":
        dbv_hi = 32 * w + 50
    q_empty = 0.02 if q > SHALLOW_QUEUE else 0.5
    if o > NARROW_BOOK:
        # the wide book: message origins and owners over every slot, with ids
        # a book apart (s and s + O) that meet on one slot; the full view's
        # mailbox keeps its origins below O (they meet the owners drawn past
        # O), so that most are owned and rows still record more messages
        # than the queue holds
        o_hi, org_hi = (o if form == "receive_full" else 2 * o), 2 * o
    cdt, qdt = plane_dtypes(cfg)
    now = 50
    head = ri((n, o), 0, 30)
    seen_bits = torch.where(coin((n, o * w), 0.3), ri((n, o * w), 0, 8),
                            ri((n, o * w), -(1 << 31), (1 << 31) - 1))
    p = IngestParams(
        n_origins=o, n_cells=c, q_slots=q, seen_words=w,
        hlc_round_bits=HLC_ROUND_BITS,
        hlc_max_drift=(1 << 20) if no_drift else HLC_MAX_DRIFT_ROUNDS,
        pig_r=cfg.pig_changes if emit else 0,
        budget_bytes=cfg.bcast_budget_bytes, wire_bytes=CHANGE_WIRE_BYTES,
        keep_rounds=cfg.org_keep_rounds, enqueue_all=enqueue_all,
    )
    x = IngestInputs(
        live=coin((n, m), p_live), origin=ri((n, m), -1, o_hi), dbv=ri((n, m), 0, dbv_hi),
        cell=ri((n, m), -1, c + 1), ver=ri((n, m), 0, 8), val=ri((n, m), 0, 4),
        site=ri((n, m), 0, 4), clp=ri((n, m), 0, 2),
        ts=ri((n, m), (now - 3) << HLC_ROUND_BITS, (now + 4) << HLC_ROUND_BITS),
        budget=torch.full((n, m), 2, dtype=torch.int32, device=dev),
        store=(planes((n, c), ((0, 8), (3, 4), (5, 4), (8, 40), (7, 2))) if c > STAGED_CELLS
               else (ri((n, c), 0, 8), ri((n, c), 0, 4), ri((n, c), 0, 4),
                     ri((n, c), 0, 40), ri((n, c), 0, 2))),
        head=head, km=head + ri((n, o), 0, 10), seen=seen_bits,
        org_id=torch.where(coin((n, o), 0.8),
                           torch.arange(o, dtype=torch.int32, device=dev).expand(n, o),
                           ri((n, o), -1, org_hi)),
        org_last=ri((n, o), 0, 60),
        q_origin=torch.where(coin((n, q), q_empty), -1, ri((n, q), 0, 64)),
        q_dbv=ri((n, q), 0, 40), q_cell=ri((n, q), 0, c).to(cdt),
        q_ver=ri((n, q), 0, 8), q_val=ri((n, q), 0, 4), q_site=ri((n, q), 0, 4),
        q_clp=ri((n, q), 0, 2), q_ts=ri((n, q), 0, now << HLC_ROUND_BITS),
        q_tx=ri((n, q), 0, 4).to(qdt),
        hlc=ri((n,), 0, now << HLC_ROUND_BITS),
        now=torch.tensor(now, dtype=torch.int32, device=dev),
        rand=prng.uniform(next(ks), (n, q), dev) if emit else None,
        carried=ri((n,), 0, 5) if emit else None,
    )
    if ties:
        # a budget that lets 1 to 3 live slots through the payload mask
        p = p._replace(budget_bytes=3 * CHANGE_WIRE_BYTES)
        x = _tie_heavy(x, c, ri, coin, planes)
    return p, x


def _tie_heavy(x, c: int, ri, coin, planes):
    """``x`` with the tie-heavy distributions of ``_ingest_inputs``
    (``planes`` as there: past the staged row's cells the store's coins
    come from one draw)."""
    import torch

    n, m = x.origin.shape
    q = x.q_origin.shape[1]
    dev = x.origin.device
    idx = torch.arange(m, device=dev).expand(n, m)
    # an earlier message of the row, up to 8 back
    back = torch.clamp(idx - ri((n, m), 1, 9).long(), min=0)
    rep = coin((n, m), 0.3) & (idx > 0)
    origin = torch.where(rep, x.origin.gather(1, back), x.origin)
    dbv = torch.where(rep, x.dbv.gather(1, back), x.dbv)
    # the same version from another origin: a full five-key LWW tie
    back2 = torch.clamp(idx - ri((n, m), 1, 9).long(), min=0)
    dbv = torch.where(coin((n, m), 0.2) & (idx > 0), dbv.gather(1, back2), dbv)
    cell_a = ri((n, 1), 0, c)
    cell_b = (cell_a + ri((n, 1), 1, c)) % c
    cell = torch.where(coin((n, m), 0.5), cell_a, cell_b)
    cell = torch.where(coin((n, m), 0.05), -1, cell)
    keys = (5, 1, 2, 1)  # ver, val, site, clp of every message

    def const(t, v):
        return torch.full_like(t, v)

    store = list(x.store)
    shape = store[0].shape
    coins = ([b == 1 for b in planes(shape, ((0, 2), (1, 2), (2, 2), (3, 2)))]
             if c > STAGED_CELLS else None)
    for k, (i, v) in enumerate(zip((0, 1, 2, 4), keys)):
        heads = coins[k] if coins else coin(shape, 0.5)
        store[i] = torch.where(heads, const(store[i], v), store[i])
    rand = None if x.rand is None else torch.floor(x.rand * 4) / 4
    return x._replace(
        origin=origin, dbv=dbv, cell=cell, ver=const(x.ver, keys[0]),
        val=const(x.val, keys[1]), site=const(x.site, keys[2]),
        clp=const(x.clp, keys[3]), budget=ri((n, m), 1, 3),
        store=tuple(store), q_tx=ri((n, q), 1, 3).to(x.q_tx.dtype), rand=rand)


def _ingest_bytes(x, out) -> int:
    """Bytes the ingest kernel must move on these operands: every plane
    once, except a message's cell, version, value, site, causal length and
    budget, which it reads only for fresh messages (only they are applied or
    enqueued). Every output is written once."""
    lazy = (x.cell, x.ver, x.val, x.site, x.clp, x.budget)
    lazy_ids = {id(t) for t in lazy}
    total = _nbytes(t for t in _flat(tuple(x)) if id(t) not in lazy_ids)
    total += _count(out.fresh) * sum(t.element_size() for t in lazy)
    return total + _nbytes(_flat(tuple(out)))


def _hold(name, got, want) -> int:
    err = _max_abs_err(_flat(tuple(got)), _flat(tuple(want)))
    if err != 0:
        raise AssertionError(f"{name}: kernel != plain version (max abs err {err})")
    return err


def _time_form(name, kernel, run, plain, nbytes, ops) -> dict:
    """Hold one form of ``kernel`` against its plain version, then time both
    (20 calls of the kernel; one of the plain version, after the hold's
    call: it has nothing to warm, and some take over a second)."""
    import torch

    got, want = run(), plain()
    torch.cuda.synchronize()
    err, ms = _hold(name, got, want), _cuda_ms(run, 20)
    device_ms, recorded = _device_ms(run, 20, kernel.removesuffix("_emit"))
    r = dict(kernel=kernel, max_abs_err=err, ms=ms, device_ms=device_ms,
             plain_ms=_cuda_ms(plain, 1, warm=False), bytes=nbytes(got), ops=ops(got))
    del got, want
    r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["ops"])
    print(f"[kernels] {name}: max_abs_err={r['max_abs_err']} "
          f"kernel {r['ms']!r} ms (device {r['device_ms']!r} ms, {recorded} of 20 launches "
          f"recorded), plain "
          f"{r['plain_ms']!r} ms, {r['bytes']} bytes, {r['ops']} int32 ops, bound "
          f"{r['bound_ms']!r} ms by {r['bound_by']}", flush=True)
    return r


def _swim_form(name, cfg, seed, dev, **kw) -> dict:
    """One swim kernel form at ``cfg``'s shapes, held and timed."""
    from corrosion_tpu_torch.ops import megakernel as mk

    n, m, k = cfg.n_nodes, cfg.m_slots, kw.get("pig_k", 0)
    consts = (m, cfg.suspicion_rounds, cfg.down_purge_rounds,
              cfg.max_transmissions, k)
    args = _swim_inputs(n, m, cfg.timer_dtype, seed, dev, **kw)

    def run():
        return mk.swim_tables_fused(consts, *args)

    def plain():
        return mk.swim_tables_plain(consts, *args)

    r = _time_form(name, "swim_tables", run, plain,
                   lambda got: _swim_bytes(args, got, k), lambda got: _swim_ops(args, k))
    r["replaces"] = "corrosion_tpu/ops/megakernel.py:1063"
    _hold_swim_ties(name, cfg, seed, dev, **kw)
    return r


def _hold_swim_ties(name, cfg, seed, dev, **kw) -> None:
    """The swim form on tie-heavy inputs (``_swim_inputs(ties=True)``), its
    own seed, N three past the configuration's so that the last block of
    rows is partial: held bitwise against the plain version, untimed; at
    least one row must have a same-class collision."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk

    n, m, k = cfg.n_nodes + 3, cfg.m_slots, kw.get("pig_k", 0)
    consts = (m, cfg.suspicion_rounds, cfg.down_purge_rounds, cfg.max_transmissions, k)
    args = _swim_inputs(n, m, cfg.timer_dtype, seed + 1000, dev, ties=True, **kw)
    got, want = mk.swim_tables_fused(consts, *args), mk.swim_tables_plain(consts, *args)
    torch.cuda.synchronize()
    _hold(f"{name} (tie-heavy)", got, want)
    rows = _swim_collisions(args, k)
    print(f"[kernels] {name}: tie-heavy inputs at N={n} bitwise equal "
          f"({rows} rows with a same-class collision)", flush=True)
    if rows <= 0:
        raise AssertionError(f"{name}: no row with a same-class collision")


def _owned(p, x, out):
    """Messages on a book slot that tracks their origin after the claim."""
    import torch

    slot = (torch.clamp(x.origin, min=0) % p.n_origins).long()
    return (x.origin >= 0) & (torch.gather(out.org_id, 1, slot) == x.origin)


def _wide_slot_rows(p, x, out) -> dict:
    """Rows that, on a book slot past the register book's 32, took the slot
    (its owner changed), evicted an owner (took it from an origin >= 0) and
    recorded a message (fresh and owned after the claim)."""
    import torch

    wide = slice(NARROW_BOOK, None)
    took = out.org_id[:, wide] != x.org_id[:, wide]
    slot = torch.clamp(x.origin, min=0) % p.n_origins
    rec = out.fresh & _owned(p, x, out) & (slot >= NARROW_BOOK)
    return {"took": int(took.any(dim=1).sum()),
            "evicted": int((took & (x.org_id[:, wide] >= 0)).any(dim=1).sum()),
            "recorded": int(rec.any(dim=1).sum())}


def _require_wide_slots(name, p, x, out) -> None:
    """With more than 32 origins, rows must take, evict and record on the
    wide book's slots past 32."""
    if p.n_origins <= NARROW_BOOK:
        return
    rows = _wide_slot_rows(p, x, out)
    print(f"[kernels] {name}: rows on slots >= {NARROW_BOOK} of {p.n_origins}: "
          f"{rows}", flush=True)
    if min(rows.values()) <= 0:
        raise AssertionError(f"{name}: the inputs miss the wide book's slots: {rows}")


def _past_staged_rows(x, out) -> int:
    """Rows where a batch winner wrote a cell past the staged row's 256
    (the store changed there: a winner beats its incumbent on (clp, ver,
    val, site), so it changes at least one of them)."""
    import torch

    past = slice(STAGED_CELLS, None)
    moved = [a[:, past] != b[:, past] for a, b in zip(x.store, out.store)]
    return int(torch.stack(moved).any(dim=0).any(dim=1).sum())


def _require_past_staged(name, p, x, out) -> None:
    """With more than 256 cells, rows must write cells past 256."""
    if p.n_cells <= STAGED_CELLS:
        return
    rows = _past_staged_rows(x, out)
    print(f"[kernels] {name}: {rows} of {x.origin.shape[0]} rows wrote cells >= "
          f"{STAGED_CELLS} of {p.n_cells}", flush=True)
    if rows <= 0:
        raise AssertionError(f"{name}: no row wrote a cell past {STAGED_CELLS}")


def _deep_rows(p, x, out) -> dict:
    """Rows that placed a message into a queue slot past SHALLOW_QUEUE (a
    queue plane changed there), made more than SHALLOW_PICKS live picks
    (emitting forms), and recorded a message whose seen bit lies past word
    SHALLOW_WORDS of the window (fresh and owned after the claim, at an
    offset from its slot's head, 0 where the slot was taken, of 32 *
    SHALLOW_WORDS or more and inside the window)."""
    import torch

    past = slice(SHALLOW_QUEUE, None)
    placed = torch.zeros(x.origin.shape[0], dtype=torch.bool, device=x.origin.device)
    for f in ("q_origin", "q_dbv", "q_cell", "q_ver", "q_val", "q_site", "q_clp",
              "q_ts", "q_tx"):
        placed |= (getattr(x, f)[:, past] != getattr(out, f)[:, past]).any(dim=1)
    slot = (torch.clamp(x.origin, min=0) % p.n_origins).long()
    taken = torch.gather(out.org_id != x.org_id, 1, slot)
    head = torch.where(taken, 0, torch.gather(x.head, 1, slot))
    off = x.dbv.to(torch.int64) - head - 1
    rec = out.fresh & _owned(p, x, out)
    far = rec & (off >= 32 * SHALLOW_WORDS) & (off < 32 * p.seen_words)
    rows = {"placed": int(placed.sum()), "far_bits": int(far.any(dim=1).sum())}
    if p.pig_r:
        rows["picks"] = int((out.sel_ok.sum(dim=1) > SHALLOW_PICKS).sum())
    return rows


def _require_deep(name, p, x, out) -> None:
    """In the deep form (more than 64 queue slots or 4 seen words), print
    ``_deep_rows`` and require each count that these widths and this
    payload budget can reach to be above 0."""
    from corrosion_tpu_torch.sim.broadcast import CHANGE_WIRE_BYTES

    if p.q_slots <= SHALLOW_QUEUE and p.seen_words <= SHALLOW_WORDS:
        return
    rows = _deep_rows(p, x, out)
    reach = {"placed": p.q_slots > SHALLOW_QUEUE, "far_bits": p.seen_words > SHALLOW_WORDS,
             "picks": p.pig_r > SHALLOW_PICKS
             and p.budget_bytes // (CHANGE_WIRE_BYTES * 4) > SHALLOW_PICKS}
    print(f"[kernels] {name}: rows past slot {SHALLOW_QUEUE} of {p.q_slots}, past word "
          f"{SHALLOW_WORDS} of {p.seen_words}, over {SHALLOW_PICKS} picks of {p.pig_r}: "
          f"{rows}", flush=True)
    missed = [k for k, v in rows.items() if reach[k] and v <= 0]
    if missed:
        raise AssertionError(f"{name}: the inputs miss the deep form's {missed}: {rows}")


def _long_rows(p, x, out) -> dict:
    """Rows that reach the long form's axes. With more than REGISTER_MSGS
    messages: a fresh message at an index of REGISTER_MSGS or more; a live
    duplicate (origin, dbv) whose first live occurrence lies in an earlier
    REGISTER_MSGS-message chunk; a cell whose batch winner (the least index
    among the fresh messages on it with the five keys the store took) lies
    at such an index. With more than ONE_PICK picks, more than ONE_PICK
    live picks. (Origins are at least -1 and versions at least 0 in every
    input here, so no live message has the dead messages' key, -1.)"""
    import torch

    from corrosion_tpu_torch.ops.lww import INT32_MAX

    n, m = x.origin.shape
    rows = {}
    if m > REGISTER_MSGS:
        chunk = REGISTER_MSGS
        rows["fresh_past"] = int(out.fresh[:, chunk:].any(dim=1).sum())
        live = x.live & ((x.ts >> p.hlc_round_bits) <= x.now + p.hlc_max_drift)
        key = torch.where(live, (x.origin.to(torch.int64) + 1) * (1 << 32) + x.dbv.to(torch.int64),
                          -1)
        cross = torch.zeros(n, dtype=torch.bool, device=key.device)
        for lo in range(chunk, m, chunk):
            earlier = torch.sort(key[:, :lo], dim=1).values
            later = key[:, lo:lo + chunk].contiguous()
            at = torch.clamp(torch.searchsorted(earlier, later), max=lo - 1)
            cross |= ((earlier.gather(1, at) == later) & (later >= 0)).any(dim=1)
        rows["cross_dups"] = int(cross.sum())
        c = p.n_cells
        cell = torch.where(out.fresh & (x.cell >= 0) & (x.cell < c), x.cell, c).long()
        took = torch.ones_like(out.fresh)
        for plane, f in zip(out.store, (x.ver, x.val, x.site, x.dbv, x.clp)):
            padded = torch.cat([plane, plane[:, :1]], dim=1)
            took &= padded.gather(1, cell) == f
        changed = torch.stack([a != b for a, b in zip(x.store, out.store)]).any(dim=0)
        took &= (cell < c) & torch.cat([changed, changed[:, :1]], dim=1).gather(1, cell)
        idx = torch.arange(m, dtype=torch.int32, device=key.device).expand(n, m)
        first = torch.full((n, c + 1), INT32_MAX, dtype=torch.int32, device=key.device)
        first.scatter_reduce_(1, cell, torch.where(took, idx, INT32_MAX), "amin")
        rows["late_winners"] = int(((first[:, :c] >= chunk) & (first[:, :c] < m))
                                   .any(dim=1).sum())
    if p.pig_r > ONE_PICK:
        rows["picks"] = int((out.sel_ok.sum(dim=1) > ONE_PICK).sum())
    return rows


def _require_long(name, p, x, out) -> None:
    """In the long form (more than REGISTER_MSGS messages, or more than
    ONE_PICK picks), print ``_long_rows`` and require each count that the
    payload budget can reach to be above 0."""
    from corrosion_tpu_torch.sim.broadcast import CHANGE_WIRE_BYTES

    if x.origin.shape[1] <= REGISTER_MSGS and p.pig_r <= ONE_PICK:
        return
    rows = _long_rows(p, x, out)
    # carried is at most 4 in these inputs
    reach = dict.fromkeys(rows, True)
    reach["picks"] = p.budget_bytes // (CHANGE_WIRE_BYTES * 4) > ONE_PICK
    print(f"[kernels] {name}: rows with fresh messages, first occurrences of duplicates and "
          f"winners past message {REGISTER_MSGS} of {x.origin.shape[1]}, over {ONE_PICK} "
          f"picks of {p.pig_r}: {rows}", flush=True)
    missed = [k for k, v in rows.items() if reach[k] and v <= 0]
    if missed:
        raise AssertionError(f"{name}: the inputs miss the long form's {missed}: {rows}")


def _recorded_past_queue(p, x, out) -> int:
    """Rows whose recorded messages (fresh and owned) outnumber the queue's
    slots."""
    return int(((out.fresh & _owned(p, x, out)).sum(dim=1) > p.q_slots).sum())


def _ingest_form(name, cfg, form, seed, dev) -> dict:
    """One ingest kernel form at ``cfg``'s shapes, held and timed."""
    from corrosion_tpu_torch.ops import megakernel as mk

    p, x = _ingest_inputs(cfg, cfg.n_nodes, form, seed, dev)
    r = _time_form(
        name, "ingest_emit" if p.pig_r else "ingest",
        lambda: mk.ingest(p, x), lambda: mk.ingest_plain(p, x),
        lambda got: _ingest_bytes(x, got), lambda got: _ingest_ops(p, x, got))
    r["replaces"] = "corrosion_tpu/ops/megakernel.py:" + ("960" if form.startswith("write") else "795")
    if (form == "receive_full" or p.n_origins > NARROW_BOOK or p.n_cells > STAGED_CELLS
            or p.q_slots > SHALLOW_QUEUE or p.seen_words > SHALLOW_WORDS
            or x.origin.shape[1] > REGISTER_MSGS or p.pig_r > ONE_PICK):
        want = mk.ingest_plain(p, x)
        if form == "receive_full":
            _require_past_queue(name, p, x, want)
        _require_wide_slots(name, p, x, want)
        _require_past_staged(name, p, x, want)
        _require_deep(name, p, x, want)
        _require_long(name, p, x, want)
        del want
    _hold_ties(name, cfg, form, seed, dev)
    return r


def _require_past_queue(name, p, x, out) -> None:
    """The full view's mailbox must give rows that record more messages than
    the queue holds, where it is wider than the queue."""
    if x.origin.shape[1] <= p.q_slots:
        return
    rows = _recorded_past_queue(p, x, out)
    print(f"[kernels] {name}: {rows} of {x.origin.shape[0]} rows recorded more "
          f"messages than the queue's {p.q_slots} slots", flush=True)
    if rows <= 0:
        raise AssertionError(f"{name}: no row recorded more than Q messages")


def _hold_ties(name, cfg, form, seed, dev) -> None:
    """The form on tie-heavy inputs (``_ingest_inputs(ties=True)``), its own
    seed, N three past the configuration's so that the last block of rows
    is partial: held bitwise against the plain version, untimed."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk

    n = cfg.n_nodes + 3
    p, x = _ingest_inputs(cfg, n, form, seed + 1000, dev, ties=True)
    got, want = mk.ingest(p, x), mk.ingest_plain(p, x)
    torch.cuda.synchronize()
    _hold(f"{name} (tie-heavy)", got, want)
    if form == "receive_full":
        _require_past_queue(f"{name} (tie-heavy)", p, x, want)
    _require_wide_slots(f"{name} (tie-heavy)", p, x, want)
    _require_past_staged(f"{name} (tie-heavy)", p, x, want)
    _require_deep(f"{name} (tie-heavy)", p, x, want)
    _require_long(f"{name} (tie-heavy)", p, x, want)
    print(f"[kernels] {name}: tie-heavy inputs at N={n} bitwise equal "
          f"({_count(want.fresh)} fresh messages)", flush=True)


def _bits(dtype) -> str:
    return str(dtype)[len("torch.int"):]


def _swim_key(cfg) -> tuple:
    """The swim kernel's launch-count key in ``cfg``'s round (the row's
    width after ``/m`` past the register form)."""
    form = "packed" if cfg.pig_members else "aligned"
    wide = f"/m{cfg.m_slots}" if cfg.m_slots > REGISTER_SLOTS else ""
    return ("swim_tables", f"{form}/{_bits(cfg.timer_dtype)}/{_bits(cfg.tx_dtype)}{wide}")


def phase_kernels(dev) -> dict:
    """Each kernel form against its plain version, held bitwise and timed, at
    the shapes of the path that runs it. Each result names that path and its
    launch-count key (``FORM_LAUNCHES``), or no path for the forms no path
    here runs (timed at the shapes of the configuration they belong to)."""
    import dataclasses

    import torch

    from corrosion_tpu_torch.resilience.chaos import SCENARIOS, scenario_config
    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config

    from corrosion_tpu_torch.testing import cluster_config

    storm = scenario_config(dataclasses.replace(SCENARIOS["preempt-storm"],
                                                n_nodes=FLAGSHIP_NODES))
    # the serving rigs' shapes: the load harness's (m_slots 8, 4 origins,
    # 16x4 cells) at LOAD_NODES, and the overload bench's (36x4 cells) at its
    # N=16
    serve = cluster_config(n_nodes=LOAD_NODES, n_rows=16).sim_config()
    overload = cluster_config(n_rows=36).sim_config()
    flag = scale_sim_config(FLAGSHIP_NODES)
    writers = scale_sim_config(FLAGSHIP_NODES, **WRITERS)
    tables = scale_sim_config(FLAGSHIP_NODES, **TABLES)
    queues = scale_sim_config(FLAGSHIP_NODES, **QUEUES)
    packets = scale_sim_config(FLAGSHIP_NODES, **PACKETS)
    widest = scale_sim_config(FLAGSHIP_NODES, **dict(QUEUES, pig_changes=128))
    members = scale_sim_config(FLAGSHIP_NODES, **MEMBERS)
    wide = scale_sim_config(FLAGSHIP_NODES, narrow_dtypes=False)
    big = million_config(MILLION_NODES)
    full = full_view_config(FULL_NODES)
    k = big.pig_members
    forms = [  # name, path, launch key, measurement
        ("swim_tables", "flagship", ("swim_tables", "aligned/16/16"),
         lambda n: _swim_form(n, flag, 11, dev)),
        ("ingest", "flagship", ("ingest", "16/16"),
         lambda n: _ingest_form(n, flag, "receive", 27, dev)),
        ("ingest_emit", "flagship", ("ingest_emit", "16/16"),
         lambda n: _ingest_form(n, flag, "write_emit", 32, dev)),
        ("swim_tables_packed_i8", "million", ("swim_tables", "packed/16/8"),
         lambda n: _swim_form(n, big, 13, dev, tx_dtype=torch.int8, pig_k=k)),
        ("ingest_q_i8", "million", ("ingest", "16/8"),
         lambda n: _ingest_form(n, big, "receive", 41, dev)),
        ("ingest_emit_q_i8", "million", ("ingest_emit", "16/8"),
         lambda n: _ingest_form(n, big, "write_emit", 42, dev)),
        ("ingest_full", "full", ("ingest", "32/32/m96"),
         lambda n: _ingest_form(n, full, "receive_full", 51, dev)),
        ("ingest_write_full", "full", ("ingest", "32/32"),
         lambda n: _ingest_form(n, full, "write", 52, dev)),
        ("ingest_empty", "pig0", ("ingest", "16/16/m0"),
         lambda n: _ingest_form(n, scale_sim_config(FLAGSHIP_NODES, pig_changes=0),
                                "receive", 53, dev)),
        # the chaos shapes (m_slots 8, 4 origins, 4x2 cells) at N=100,000
        ("swim_tables_chaos", "chaos", ("swim_tables", "aligned/16/16"),
         lambda n: _swim_form(n, storm, 18, dev)),
        ("ingest_chaos", "chaos", ("ingest", "16/16"),
         lambda n: _ingest_form(n, storm, "receive", 54, dev)),
        ("ingest_emit_chaos", "chaos", ("ingest_emit", "16/16"),
         lambda n: _ingest_form(n, storm, "write_emit", 55, dev)),
        ("swim_tables_serve", "load", ("swim_tables", "aligned/16/16"),
         lambda n: _swim_form(n, serve, 19, dev)),
        ("ingest_serve", "load", ("ingest", "16/16"),
         lambda n: _ingest_form(n, serve, "receive", 56, dev)),
        ("ingest_emit_serve", "load", ("ingest_emit", "16/16"),
         lambda n: _ingest_form(n, serve, "write_emit", 57, dev)),
        ("swim_tables_overload", "overload", ("swim_tables", "aligned/16/16"),
         lambda n: _swim_form(n, overload, 20, dev)),
        ("ingest_overload", "overload", ("ingest", "16/16"),
         lambda n: _ingest_form(n, overload, "receive", 58, dev)),
        ("ingest_emit_overload", "overload", ("ingest_emit", "16/16"),
         lambda n: _ingest_form(n, overload, "write_emit", 59, dev)),
        # the wide book (more than 32 origins): the many-writer flagship's
        # two forms, its non-emitting write, the full view's mailbox at 64
        # origins, and 48 origins (not a multiple of 32) at int16/int8
        ("ingest_writers", "writers", ("ingest", "16/16/o256"),
         lambda n: _ingest_form(n, writers, "receive", 60, dev)),
        ("ingest_emit_writers", "writers", ("ingest_emit", "16/16/o256"),
         lambda n: _ingest_form(n, writers, "write_emit", 61, dev)),
        ("ingest_write_16_16_o256_n100000", None, None,
         lambda n: _ingest_form(n, writers, "write", 62, dev)),
        ("ingest_full_o64", None, None,
         lambda n: _ingest_form(n, full_view_config(FULL_NODES, n_origins=64),
                                "receive_full", 63, dev)),
        ("ingest_16_8_o48_n100000", None, None,
         lambda n: _ingest_form(n, scale_sim_config(FLAGSHIP_NODES, n_origins=48,
                                                    narrow_q_int8=True),
                                "receive", 64, dev)),
        # the row in global memory (more than 256 cells): the large table's
        # two forms and its non-emitting write, the full view's mailbox at
        # 4,096 cells, the wide book at 4,096 cells and int16/int8 at 4,100
        ("ingest_tables", "tables", ("ingest", "16/16/c4096"),
         lambda n: _ingest_form(n, tables, "receive", 65, dev)),
        ("ingest_emit_tables", "tables", ("ingest_emit", "16/16/c4096"),
         lambda n: _ingest_form(n, tables, "write_emit", 66, dev)),
        ("ingest_write_16_16_c4096_n100000", None, None,
         lambda n: _ingest_form(n, tables, "write", 67, dev)),
        ("ingest_full_c4096", None, None,
         lambda n: _ingest_form(n, full_view_config(FULL_NODES, **TABLES),
                                "receive_full", 68, dev)),
        ("ingest_16_16_o256_c4096_n100000", None, None,
         lambda n: _ingest_form(n, scale_sim_config(FLAGSHIP_NODES, n_origins=256,
                                                    **TABLES),
                                "receive", 69, dev)),
        ("ingest_16_8_c4100_n100000", None, None,
         lambda n: _ingest_form(n, scale_sim_config(FLAGSHIP_NODES, n_rows=1025, n_cols=4,
                                                    narrow_q_int8=True),
                                "receive", 70, dev)),
        # the deep form (more than 64 queue slots or 4 seen words): the deep
        # queue's two forms (the receive at m = 128) and its non-emitting
        # write, the full view's mailbox at 128 slots and 8 words (int32),
        # and int16/int8 at 128 slots and 8 words with the register book
        ("ingest_queues", "queues", ("ingest", "16/16/m128/o256/q128/w8"),
         lambda n: _ingest_form(n, queues, "receive", 71, dev)),
        ("ingest_emit_queues", "queues", ("ingest_emit", "16/16/o256/q128/w8"),
         lambda n: _ingest_form(n, queues, "write_emit", 72, dev)),
        ("ingest_write_16_16_o256_q128_n100000", None, None,
         lambda n: _ingest_form(n, queues, "write", 73, dev)),
        ("ingest_full_q128", None, None,
         lambda n: _ingest_form(n, full_view_config(FULL_NODES, bcast_queue=128,
                                                    buf_slots=256),
                                "receive_full", 74, dev)),
        ("ingest_16_8_q128_n100000", None, None,
         lambda n: _ingest_form(n, scale_sim_config(FLAGSHIP_NODES, bcast_queue=128,
                                                    buf_slots=256, narrow_q_int8=True),
                                "receive", 75, dev)),
        # the long form (past 128 messages or 32 picks): the wide packet's
        # receive (m = 256) and emitting write (64 picks), the widest the
        # 128-slot queue allows (m = 512, 128 picks), the full view's
        # mailbox at recv_slots = 256 (int32) and int16/int8 at m = 256 with
        # the register book
        ("ingest_packets", "packets", ("ingest", "16/16/m256/o256/q128/w8"),
         lambda n: _ingest_form(n, packets, "receive", 76, dev)),
        ("ingest_emit_packets", "packets", ("ingest_emit", "16/16/o256/q128/w8/r64"),
         lambda n: _ingest_form(n, packets, "write_emit", 77, dev)),
        ("ingest_16_16_m512_o256_q128_n100000", None, None,
         lambda n: _ingest_form(n, widest, "receive", 78, dev)),
        ("ingest_emit_16_16_o256_q128_r128_n100000", None, None,
         lambda n: _ingest_form(n, widest, "write_emit", 79, dev)),
        ("ingest_full_m256", None, None,
         lambda n: _ingest_form(n, full_view_config(FULL_NODES, recv_slots=256),
                                "receive_full", 80, dev)),
        ("ingest_16_8_m256_n100000", None, None,
         lambda n: _ingest_form(n, scale_sim_config(FLAGSHIP_NODES, pig_changes=64,
                                                    bcast_queue=64, narrow_q_int8=True),
                                "receive", 81, dev)),
        # the swim kernel's wide form (more than 128 member slots): the wide
        # member table's round (m = 256, aligned int16/int16); the rest below
        ("swim_tables_members", "members", _swim_key(members),
         lambda n: _swim_form(n, members, 82, dev)),
    ]
    for c, form, seed in ((wide, "receive", 36), (wide, "write", 37),
                          (wide, "write_emit", 38), (flag, "write", 39),
                          (big, "write", 40)):
        name = (f"ingest_{form}_{_bits(c.timer_dtype)}_{_bits(c.q_dtype)}"
                f"_n{c.n_nodes}")
        forms.append((name, None, None,
                      lambda n, c=c, form=form, seed=seed: _ingest_form(n, c, form, seed, dev)))
    for c, kw, seed in ((wide, {}, 12),
                        (scale_sim_config(MILLION_NODES),
                         dict(tx_dtype=torch.int16, pig_k=k), 15),
                        (scale_sim_config(MILLION_NODES, narrow_dtypes=False),
                         dict(pig_k=k), 16),
                        (scale_sim_config(MILLION_NODES), dict(tx_dtype=torch.int8), 17)):
        name = (f"swim_tables_{'packed' if kw.get('pig_k') else 'aligned'}_"
                f"{_bits(c.timer_dtype)}_{_bits(kw.get('tx_dtype', c.timer_dtype))}"
                f"_n{c.n_nodes}")
        forms.append((name, None, None,
                      lambda n, c=c, kw=kw, seed=seed: _swim_form(n, c, seed, dev, **kw)))
    # the wide member table's other dtype pairs, aligned and packed (16
    # entries a packet, the 1M point's tiers), m = 200 (the general modulo)
    # at N = 100,000; a packet of m entries (1,024 a row), and m = 1,024
    # aligned and packed, at N = 25,000 (the wide member table's 25.6M
    # cells: these widths are no configuration's, and at N = 100,000 their
    # plain versions take over a second a call)
    i8, i16 = torch.int8, torch.int16
    for n, over, kw, seed in (
            (FLAGSHIP_NODES, dict(MEMBERS), dict(tx_dtype=i8), 83),
            (FLAGSHIP_NODES, dict(MEMBERS, narrow_dtypes=False), {}, 84),
            (FLAGSHIP_NODES, dict(MEMBERS), dict(tx_dtype=i8, pig_k=16), 85),
            (FLAGSHIP_NODES, dict(MEMBERS), dict(pig_k=16), 86),
            (FLAGSHIP_NODES, dict(MEMBERS, narrow_dtypes=False), dict(pig_k=16), 87),
            (FLAGSHIP_NODES, dict(m_slots=200), {}, 88),
            (WIDEST_SWIM_NODES, dict(MEMBERS), dict(pig_k=256), 89),
            (WIDEST_SWIM_NODES, dict(m_slots=1024, narrow_dtypes=False), {}, 90),
            (WIDEST_SWIM_NODES, dict(m_slots=1024), dict(tx_dtype=i16, pig_k=64), 91)):
        c = scale_sim_config(n, **over)
        entries = kw.get("pig_k", 0)  # (not `k`: the 1M form's lambda reads it)
        name = (f"swim_tables_{'packed' if entries else 'aligned'}_{_bits(c.timer_dtype)}_"
                f"{_bits(kw.get('tx_dtype', c.timer_dtype))}_m{c.m_slots}"
                f"{f'_k{entries}' if entries else ''}_n{c.n_nodes}")
        forms.append((name, None, None,
                      lambda n, c=c, kw=kw, seed=seed: _swim_form(n, c, seed, dev, **kw)))
    out = {}
    for name, path, key, measure in forms:
        t0 = time.perf_counter()
        out[name] = measure(name)
        out[name].update(path=path, launch_key=key)
        print(f"[time] kernels {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _trajectory_setup(cfg, rounds: int, dev, write_p: float = 0.02):
    import torch

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.sim.scale_step import ScaleSimState, make_write_inputs
    from corrosion_tpu_torch.sim.transport import NetModel

    n = cfg.n_nodes
    k_w, k_in = prng.split(prng.key(7))
    inputs = make_write_inputs(
        cfg, k_in, rounds, prng.uniform(k_w, (rounds, n), "cpu") < write_p, "cpu")
    kill = torch.zeros((rounds, n), dtype=torch.bool)
    revive = torch.zeros((rounds, n), dtype=torch.bool)
    kill[4, 100:132] = True
    revive[10, 100:116] = True
    inputs = inputs._replace(kill=kill, revive=revive)
    inputs = type(inputs)(*(a.to(dev) for a in inputs))
    st = ScaleSimState.create(cfg, dev)
    net = NetModel.create(n, drop_prob=0.05, device=dev)
    return st, net, prng.key(3), inputs


def phase_trajectory(dev, label, make_cfg, rounds: int = TRAJECTORY_ROUNDS,
                     tag: str = "trajectory", n_nodes: int = TRAJECTORY_NODES,
                     write_p: float = 0.02, final=None):
    """The card == the CPU, for ``make_cfg(n_nodes, ...)``: the kernel route
    on the card against the plain versions on the CPU (and the plain route
    on both where the config takes it), a share ``write_p`` of the nodes
    writing each round. Returns the card's launch counts per form, the info
    sums, and ``final(cpu state, card state)`` when given."""
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import ScaleRoundInput, scale_run_rounds_carry

    cfg = make_cfg(n_nodes, sync_interval=2, sync_sweep_every=2)
    runs = {d: _trajectory_setup(cfg, rounds, d, write_p) for d in ("cpu", dev)}
    carry = {d: (runs[d][0], runs[d][2]) for d in runs}
    t0 = time.perf_counter()
    mk.reset_launches()
    sums = {}
    for r in range(rounds):
        infos = {}
        for d, (_, net, _, inputs) in runs.items():
            one = ScaleRoundInput(*(a[r:r + 1] for a in inputs))
            st, key = carry[d]
            carry[d], infos[d] = scale_run_rounds_carry(cfg, st, net, key, one)
        a, b = _flat(carry["cpu"][0]), [t.cpu() for t in _flat(carry[dev][0])]
        err = _max_abs_err(a, b)
        ierr = _max_abs_err(_flat(infos["cpu"]), [t.cpu() for t in _flat(infos[dev])])
        if err or ierr:
            raise AssertionError(f"{label} round {r}: cuda != cpu (state {err}, info {ierr})")
        for k, v in infos["cpu"].items():
            sums[k] = sums.get(k, 0) + int(v.sum())
    forms = dict(mk.FORM_LAUNCHES)
    print(f"[{tag}] N={cfg.n_nodes} {label}: {rounds} rounds, "
          f"every leaf and info bitwise equal cuda vs cpu "
          f"({time.perf_counter() - t0:.1f} s); card launches {forms}", flush=True)
    if final is not None:
        return forms, sums, final(carry["cpu"][0], carry[dev][0])
    return forms, sums


#: the tx-trajectory configurations: (label, overrides)
TX_TRAJECTORIES = (("tx4", dict(tx_max_cells=4)),
                   ("wirebudget", dict(bcast_wire_budget=True)),
                   ("pig0", dict(pig_changes=0)))


def phase_tx_trajectory(dev) -> dict:
    """Phase 3's trajectory for multi-cell transactions, the wire-budget
    lane and ``pig_changes=0``, with the launches their routes imply."""
    from corrosion_tpu_torch.sim.broadcast import plane_dtypes
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    out = {}
    for label, over in TX_TRAJECTORIES:
        rounds = TRAJECTORY_ROUNDS
        forms, sums = phase_trajectory(
            dev, label, lambda n, **kw: scale_sim_config(n, **kw, **over),
            rounds, "tx-trajectory")
        cfg = scale_sim_config(TRAJECTORY_NODES, **over)
        swim = sum(v for (k, _), v in forms.items() if k == "swim_tables")
        ingest = {f: v for (k, f), v in forms.items() if k != "swim_tables"}
        cdt, qdt = plane_dtypes(cfg)
        q = f"{_bits(cdt)}/{_bits(qdt)}"
        want = ({q: rounds, f"{q}/m0": rounds} if label == "pig0" else {})
        if swim != rounds or ingest != want:
            raise AssertionError(f"{label}: swim launches {swim} != {rounds} or ingest "
                                 f"launches {ingest} != {want}")
        if label == "tx4" and sums["tx_completed"] <= 0:
            raise AssertionError(f"{label}: no transaction completed ({sums})")
        if label != "pig0" and sums["fresh"] <= 0:
            raise AssertionError(f"{label}: nothing fresh ({sums})")
        out[label] = {"forms": forms}
    return out


def phase_flagship(dev) -> dict:
    """bench.py's flagship workload through the port's entry points."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        scale_run_rounds_carry,
        scale_sim_config,
    )

    cfg = scale_sim_config(FLAGSHIP_NODES)
    # three timed batches of 8 rounds show the spread within one run
    n, warm, batch, reps = cfg.n_nodes, 2, 8, 3
    rounds = batch * reps
    total = warm + rounds
    st, net, key, inputs = flagship_workload(cfg, total, dev)

    def part(lo, hi):
        return ScaleRoundInput(*(a[lo:hi] for a in inputs))

    (st, key), _ = scale_run_rounds_carry(cfg, st, net, key, part(0, warm))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    rates, batch_infos = [], []
    for lo in range(warm, total, batch):
        t0 = time.perf_counter()
        (st, key), infos = scale_run_rounds_carry(cfg, st, net, key, part(lo, lo + batch))
        torch.cuda.synchronize()
        rates.append(batch / (time.perf_counter() - t0))
        batch_infos.append(infos)
    launches, forms = dict(mk.LAUNCHES), dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"swim_tables": rounds, "ingest": rounds, "ingest_emit": rounds}
    want_forms = {("swim_tables", "aligned/16/16"): rounds, ("ingest", "16/16"): rounds,
                  ("ingest_emit", "16/16"): rounds}
    if launches != want or forms != want_forms:
        raise AssertionError(f"launch counts {launches} {forms} != {want}")
    sums = {k: sum(int(i[k].sum()) for i in batch_infos) for k in batch_infos[0]}
    if sums["fresh"] <= 0 or sums["delivered"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"flagship run moved nothing: {sums}")
    if int(st.crdt.now) != total or st.swim.mem_id.shape != (n, cfg.m_slots):
        raise AssertionError("flagship state has the wrong round or shape")
    median = sorted(rates)[len(rates) // 2]
    print(f"[flagship] N={n}: {reps} batches of {batch} rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {median!r}; peak device "
          f"memory {peak} bytes; launches {launches}; info sums {sums}", flush=True)
    return {"rounds_per_s": median, "peak_bytes": peak, "forms": forms}


def phase_million(dev) -> dict:
    """The 1M point (bounded member piggyback, int8 budget and queue-counter
    planes) with the flagship's workload, through the port's entry points."""
    import torch

    from corrosion_tpu_torch.obs.memory import memory_report
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        million_config,
        scale_run_rounds_carry,
    )

    cfg = million_config(MILLION_NODES)
    n, warm, batch, reps = cfg.n_nodes, 2, 4, 3
    total = warm + batch * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    kept: dict = {}

    def make():
        st, net, key, inputs = flagship_workload(cfg, total, dev)
        kept.update(net=net, key=key, inputs=inputs)  # the mesh phase's too
        return st, net, key, inputs

    st, state_bytes, rates, batch_infos = _timed_batches(
        make, lambda s, net, k, i: scale_run_rounds_carry(cfg, s, net, k, i),
        lambda inputs, lo, hi: ScaleRoundInput(*(a[lo:hi] for a in inputs)),
        warm, batch, reps)
    launches, forms = dict(mk.LAUNCHES), dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"swim_tables": total, "ingest": total, "ingest_emit": total}
    want_forms = {("swim_tables", "packed/16/8"): total, ("ingest", "16/8"): total,
                  ("ingest_emit", "16/8"): total}
    if launches != want or forms != want_forms:
        raise AssertionError(f"1M launch counts {launches} {forms} != {want_forms}")
    sums = {k: sum(int(i[k].sum()) for i in batch_infos) for k in batch_infos[0]}
    sync_rounds = sum(int((i["syncs"] > 0).sum()) for i in batch_infos)
    if sums["fresh"] <= 0 or sums["delivered"] <= 0 or sync_rounds != 1:
        raise AssertionError(f"1M run: {sync_rounds} sync rounds, sums {sums}")
    if (int(st.crdt.now) != total or st.swim.mem_tx.dtype != torch.int8
            or st.crdt.q_tx.dtype != torch.int8 or _nbytes(_flat(st)) != state_bytes):
        raise AssertionError("1M state has the wrong round, dtypes or size")
    audit = memory_report(st, n)
    median = sorted(rates)[len(rates) // 2]
    print(f"[million] N={n} pig_members={cfg.pig_members} int8 mem_tx/q_tx: {reps} batches of {batch} rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {median!r}; peak device "
          f"memory {peak} bytes; carried state {state_bytes} bytes "
          f"({state_bytes / n!r} B/node); launches {forms}; info sums {sums}",
          flush=True)
    _check_narrow_widths(st, "1M point")
    return {"rounds_per_s": median, "peak_bytes": peak, "forms": forms, "audit": audit,
            "workload": kept}


def _check_narrow_widths(st, label: str) -> None:
    """The card's counterpart of dtype-flow's registry check: every
    ``NARROW_LEAVES`` name is in the carry ``st``, on the card, at exactly
    its declared width (the 1M point runs every narrow tier)."""
    import torch

    from corrosion_tpu_torch.analysis.dtypes import NARROW_LEAVES
    from corrosion_tpu_torch.obs.memory import _walk_leaves

    leaves: dict = {}
    _walk_leaves(st, "", leaves)
    found = {name: t for name, t in leaves.items() if name.rsplit(".", 1)[-1] in NARROW_LEAVES}
    seen = {name.rsplit(".", 1)[-1] for name in found}
    bad = {name: (str(t.dtype), str(t.device)) for name, t in found.items()
           if t.element_size() * 8 != NARROW_LEAVES[name.rsplit(".", 1)[-1]]
           or t.device.type != "cuda" or t.dtype.is_floating_point or t.dtype == torch.bool}
    if seen != set(NARROW_LEAVES) or bad:
        raise AssertionError(f"[dtype] {label}: missing {sorted(set(NARROW_LEAVES) - seen)}, "
                             f"off their declared width or off the card {bad}")
    print(f"[dtype] {label}'s carry on {next(iter(found.values())).device}: "
          + ", ".join(f"{name} {str(t.dtype).removeprefix('torch.')}"
                      for name, t in sorted(found.items()))
          + f": all {len(NARROW_LEAVES)} NARROW_LEAVES names at their declared widths",
          flush=True)


MESH_SHARDS = 4
MESH_ROUNDS = 8  # flagship rounds on the mesh; the last is a sync-and-sweep round
MESH_MILLION_ROUNDS = 3
MESH_RESUME_ROUNDS = 2  # rounds run after each restore of the sharded checkpoint
MESH_FULL_ROUNDS = 3  # full_view_config(FULL_NODES) rounds on the mesh
MESH_FULL_TX_NODES = 1024  # the full view's plain route (tx 8) on the mesh
MESH_FULL_TX_ROUNDS = 4


def _mesh_devices(dev, k: int) -> tuple:
    """The mesh's devices: k cards when the machine has them, else the one
    card repeated; -> (devices, a word for the log)."""
    import torch

    if dev.type == "cuda" and torch.cuda.device_count() >= k:
        return [torch.device("cuda", i) for i in range(k)], f"{k} cards"
    return [dev] * k, f"{dev} x{k} (one card, {k} shards)"


def _same_state(label, want, got) -> None:
    """Every leaf of ``got`` (a state or a mesh-placed one) equals
    ``want``'s, bitwise."""
    from corrosion_tpu_torch.parallel.mesh import ShardedTree

    if isinstance(got, ShardedTree):
        got = got.assemble(_flat(want)[0].device)
    a, b = _flat(want), _flat(got)
    if len(a) != len(b) or not all(x.dtype == y.dtype and x.shape == y.shape
                                   and bool((x == y).all()) for x, y in zip(a, b)):
        raise AssertionError(f"mesh {label}: state differs from the unsharded run")


def _same_infos(label, want: dict, got: dict) -> None:
    import torch

    if sorted(want) != sorted(got) or not all(
            torch.equal(want[k].cpu(), got[k].cpu()) for k in want):
        raise AssertionError(f"mesh {label}: round infos differ from the unsharded run")


def _mesh_launches(label, shards: int, rounds: int, want_forms) -> dict:
    """Each of the path's kernel forms launched once a round on every
    shard, and no other (no form: the plain route launches nothing)."""
    from corrosion_tpu_torch.ops import megakernel as mk

    want = {f: shards * rounds for f in want_forms}
    names: dict = {}
    for (name, _form), v in want.items():
        names[name] = names.get(name, 0) + v
    got = {k: v for k, v in mk.LAUNCHES.items() if v}
    forms = dict(mk.FORM_LAUNCHES)
    if got != names or forms != want:
        raise AssertionError(f"mesh {label}: launches {got} {forms}, want {names} "
                             f"{want}")
    return forms


def phase_mesh(dev, million_workload: dict) -> dict:
    """The node-axis sharding (``parallel/``) on the card: the flagship on
    a mesh of ``MESH_SHARDS`` (one card repeated, or that many cards), a
    ``(2, 2)`` carry chain, the 1M point on the mesh, a sharded checkpoint
    restored onto 2 shards and onto one device, the full view at
    ``FULL_NODES`` (tx 1: K2 at m = recv_slots and K3 at m = 1) and at
    ``wan_config(MESH_FULL_TX_NODES)`` (tx 8, the plain route); each
    bitwise equal to the unsharded run, with the path's kernels launched
    on every shard every round."""
    import os
    import shutil
    import tempfile

    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.parallel import (
        make_mesh,
        make_multihost_mesh,
        shard_state,
        sharded_scale_run_carry,
    )
    from corrosion_tpu_torch.resilience import resume_segmented, run_segmented
    from corrosion_tpu_torch.sim.config import full_view_config, wan_config
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        ScaleSimState,
        flagship_workload,
        million_config,
        scale_run_rounds_carry,
        scale_sim_config,
    )
    from corrosion_tpu_torch.sim.scenario import full_view_workload

    k = MESH_SHARDS
    devices, where = _mesh_devices(dev, k)
    print(f"[mesh] {k} shards on {where}; {torch.cuda.device_count()} visible "
          f"card(s)", flush=True)
    cut = lambda inputs, lo, hi: ScaleRoundInput(*(a[lo:hi] for a in inputs))  # noqa: E731

    # --- flagship: 8 rounds ending on a sync-and-sweep round -------------
    cfg = scale_sim_config(FLAGSHIP_NODES)
    st0, net, key, inputs = flagship_workload(cfg, MESH_ROUNDS, dev)
    sweep_at = max(1, cfg.sync_interval) * cfg.sync_sweep_every
    st0 = st0._replace(crdt=st0.crdt._replace(
        now=torch.full_like(st0.crdt.now, sweep_at - MESH_ROUNDS)))
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    (ref, ref_key), ref_infos = scale_run_rounds_carry(cfg, st0, net, key, inputs)
    torch.cuda.synchronize()
    plain_rate = MESH_ROUNDS / (time.perf_counter() - t0)
    _mesh_launches("flagship unsharded", 1, MESH_ROUNDS, {
        ("swim_tables", "aligned/16/16"), ("ingest", "16/16"), ("ingest_emit", "16/16")})
    if int(ref_infos["syncs"][-1]) <= 0:
        raise AssertionError("mesh flagship: the last round did not sync")
    mesh = make_mesh(devices)
    mk.reset_launches()
    exchanges: list = []
    t0 = time.perf_counter()
    # corrolint: disable=shard-spec-drift -- the unsharded run's start; the call places it
    (out, out_key), infos = sharded_scale_run_carry(cfg, mesh, st0, net, key, inputs,
                                                    exchanges=exchanges)
    for d in set(devices):
        torch.cuda.synchronize(d)
    mesh_rate = MESH_ROUNDS / (time.perf_counter() - t0)
    forms = _mesh_launches("flagship", k, MESH_ROUNDS, {
        ("swim_tables", "aligned/16/16"), ("ingest", "16/16"), ("ingest_emit", "16/16")})
    # corrolint: disable=shard-gather -- the check: the whole state equals the unsharded run's
    _same_state("flagship", ref, out)
    _same_infos("flagship", ref_infos, infos)
    if not torch.equal(ref_key, out_key):
        raise AssertionError("mesh flagship: the carried key differs")
    del out
    print(f"[mesh] flagship N={FLAGSHIP_NODES}, {MESH_ROUNDS} rounds (now "
          f"{sweep_at - MESH_ROUNDS + 1}..{sweep_at}, the last a sync-and-sweep "
          f"round) on {k} shards: bitwise equal to the unsharded run, state and "
          f"infos; launches {forms} ({k} a round each); {mesh_rate!r} rounds/s "
          f"sharded vs {plain_rate!r} unsharded", flush=True)
    print(f"[mesh] exchange bytes a round by site at N={FLAGSHIP_NODES} on {k} "
          f"shards: round 1 {exchanges[0]}; total {sum(exchanges[0].values())}; the "
          f"sync-and-sweep round {exchanges[-1]}; total {sum(exchanges[-1].values())}",
          flush=True)

    # --- the (2, 2) carry chain: 4 + 4 rounds ------------------------------
    mesh22 = make_multihost_mesh(2, devices)
    half = MESH_ROUNDS // 2
    # corrolint: disable=shard-spec-drift -- the unsharded run's start; the call places it
    (carry, ck), _ = sharded_scale_run_carry(cfg, mesh22, st0, net, key, cut(inputs, 0, half))
    # corrolint: disable=shard-spec-drift -- the unsharded run's start; the call places it
    (carry, ck), _ = sharded_scale_run_carry(cfg, mesh22, carry, net, ck,
                                             cut(inputs, half, MESH_ROUNDS))
    # corrolint: disable=shard-gather -- the check: the whole state equals the unsharded run's
    _same_state("(2, 2) carry chain", ref, carry)
    if not torch.equal(ref_key, ck):
        raise AssertionError("mesh carry chain: the carried key differs")
    del carry
    print(f"[mesh] (2, 2) multihost mesh, {half} + {half} rounds chained: bitwise "
          f"equal to the straight unsharded run", flush=True)

    # --- the sharded checkpoint: save on 4, restore onto 2 and onto 1 -----
    total = half + MESH_RESUME_ROUNDS
    (want, _), want_infos = scale_run_rounds_carry(cfg, st0, net, key, cut(inputs, 0, total))
    tmp = tempfile.mkdtemp(prefix="chip-mesh-")
    try:
        root = os.path.join(tmp, "saved")
        t0 = time.perf_counter()
        saved = run_segmented(cfg, shard_state(mesh, cfg.n_nodes, st0), net, key,
                              cut(inputs, 0, half), half, checkpoint_root=root)
        save_s = time.perf_counter() - t0
        if saved.stats["ckpt_shards"] != k or saved.aborted:
            raise AssertionError(f"mesh checkpoint: {saved.stats}")
        for label, target in (("2 shards", make_mesh(devices[:2])), ("one device", None)):
            copy = os.path.join(tmp, label.replace(" ", "-"))
            shutil.copytree(root, copy)
            t0 = time.perf_counter()
            res = resume_segmented(cfg, net, cut(inputs, 0, total), MESH_RESUME_ROUNDS,
                                   checkpoint_root=copy, mesh=target)
            resume_s = time.perf_counter() - t0
            if res.completed_rounds != total or res.aborted:
                raise AssertionError(f"mesh resume onto {label}: {res.completed_rounds}")
            _same_state(f"resume onto {label}", want, res.state)
            _same_infos(f"resume onto {label}",
                        {kk: v[half:] for kk, v in want_infos.items()}, res.infos)
            print(f"[mesh] checkpoint saved on {k} shards ({k} slice files, "
                  f"{save_s:.1f} s with the segment) restored onto {label}, "
                  f"{MESH_RESUME_ROUNDS} more rounds: bitwise equal to the "
                  f"uninterrupted run ({resume_s:.1f} s)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del want, ref, st0

    # --- the 1M point on the mesh: packed K1, int8 tiers per shard --------
    mcfg = million_config(MILLION_NODES)
    mnet, mkey = million_workload["net"], million_workload["key"]
    minputs = cut(million_workload["inputs"], 0, MESH_MILLION_ROUNDS)
    mst = ScaleSimState.create(mcfg, dev)
    (mref, _), mref_infos = scale_run_rounds_carry(mcfg, mst, mnet, mkey, minputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    t0 = time.perf_counter()
    # corrolint: disable=shard-spec-drift -- the unsharded run's start; the call places it
    (mout, _), minfos = sharded_scale_run_carry(mcfg, mesh, mst, mnet, mkey, minputs)
    for d in set(devices):
        torch.cuda.synchronize(d)
    m_rate = MESH_MILLION_ROUNDS / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    mforms = _mesh_launches("1M", k, MESH_MILLION_ROUNDS, {
        ("swim_tables", "packed/16/8"), ("ingest", "16/8"), ("ingest_emit", "16/8")})
    # corrolint: disable=shard-gather -- the check: the whole state equals the unsharded run's
    _same_state("1M", mref, mout)
    _same_infos("1M", mref_infos, minfos)
    print(f"[mesh] 1M point ({MILLION_NODES} nodes, pig_members={mcfg.pig_members}, "
          f"int8 mem_tx/q_tx) {MESH_MILLION_ROUNDS} rounds on {k} shards: bitwise "
          f"equal to the unsharded run; launches {mforms}; {m_rate!r} rounds/s; "
          f"peak device memory {peak} bytes", flush=True)
    del mref, mout, mst

    # --- the full view on the mesh: K2 (m = recv_slots) and K3 (m = 1) on
    # every shard, then the plain route (tx 8) --------------------------
    fcfg = full_view_config(FULL_NODES)
    full = _mesh_full_leg(
        f"full view N={FULL_NODES} (tx 1)", fcfg,
        full_view_workload(fcfg, MESH_FULL_ROUNDS, dev), MESH_FULL_ROUNDS, mesh, k,
        {("ingest", "32/32"), ("ingest", f"32/32/m{fcfg.recv_slots}")})
    tcfg = wan_config(MESH_FULL_TX_NODES)
    full_tx = _mesh_full_leg(
        f"full view wan_config({MESH_FULL_TX_NODES}), tx {tcfg.tx_max_cells}", tcfg,
        _tx_workload(tcfg, MESH_FULL_TX_ROUNDS, dev), MESH_FULL_TX_ROUNDS, mesh, k, ())
    return {"flagship_rounds_per_s": mesh_rate, "unsharded_rounds_per_s": plain_rate,
            "exchanges": exchanges, "million_rounds_per_s": m_rate, "peak_bytes": peak,
            "full": full, "full_tx": full_tx}


def _mesh_full_leg(label, cfg, workload, rounds: int, mesh, k: int, want_forms) -> dict:
    """One full-view leg: ``run_rounds`` unsharded (after a warm-up round),
    then ``sharded_run`` on ``mesh`` from the same state, key and inputs:
    bitwise equal, state and infos, with the path's kernel forms launched
    once a round on every shard (the unsharded run once a round)."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.parallel import sharded_run
    from corrosion_tpu_torch.sim.step import RoundInput, run_rounds

    st0, net, key, inputs = workload
    # a warm-up round: the unsharded rate is not a first call's
    run_rounds(cfg, st0, net, key, RoundInput(*(a[:1] for a in inputs)))
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    ref, ref_infos = run_rounds(cfg, st0, net, key, inputs)
    torch.cuda.synchronize()
    plain_rate = rounds / (time.perf_counter() - t0)
    _mesh_launches(f"{label} unsharded", 1, rounds, want_forms)
    sums = {kk: int(v.sum()) for kk, v in ref_infos.items()}
    if sums["fresh"] <= 0 or sums["sent"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"mesh {label}: the run moved nothing: {sums}")
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    exchanges: list = []
    t0 = time.perf_counter()
    # corrolint: disable=shard-spec-drift -- the unsharded run's start; the call places it
    out, infos = sharded_run(cfg, mesh, st0, net, key, inputs, exchanges=exchanges)
    for d in set(mesh.flat_devices()):
        torch.cuda.synchronize(d)
    rate = rounds / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    forms = _mesh_launches(label, k, rounds, want_forms)
    # corrolint: disable=shard-gather -- the check: the whole state equals the unsharded run's
    _same_state(label, ref, out)
    _same_infos(label, ref_infos, infos)
    if len(exchanges) != rounds or any(e != exchanges[0] for e in exchanges):
        raise AssertionError(f"mesh {label}: the rounds exchanged unequal bytes "
                             f"{exchanges}")
    launched = (f"launches {forms} ({k} a round each)" if forms
                else "no kernel launch (the plain route), as unsharded")
    print(f"[mesh] {label}: {rounds} rounds on {k} shards: bitwise equal to the "
          f"unsharded run, state and infos; {launched}; {rate!r} rounds/s sharded "
          f"vs {plain_rate!r} "
          f"unsharded; exchange bytes a round by site {exchanges[0]}, total "
          f"{sum(exchanges[0].values())} (every round the same); peak device memory "
          f"{peak} bytes over the sharded run (the unsharded start and result held "
          f"beside it)", flush=True)
    return {"rounds_per_s": rate, "unsharded_rounds_per_s": plain_rate,
            "exchanges": exchanges[0], "peak_bytes": peak, "forms": forms}



def phase_full_trajectory(dev) -> None:
    """The full-view round on the card == on the CPU, every leaf and info
    value after every round, at ``FULL_TRAJECTORY_NODES``, with the full
    view's workload (``scenario.full_view_workload``: churn, conflict-heavy
    writes, 1 % loss)."""
    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scenario import full_view_workload
    from corrosion_tpu_torch.sim.step import RoundInput, run_rounds_carry

    cfg = full_view_config(FULL_TRAJECTORY_NODES)
    rounds = FULL_TRAJECTORY_ROUNDS
    runs = {d: full_view_workload(cfg, rounds, d) for d in ("cpu", dev)}
    carry = {d: (runs[d][0], runs[d][2]) for d in runs}
    t0 = time.perf_counter()
    sums = {}
    for r in range(rounds):
        infos = {}
        for d, (_, net, _, inputs) in runs.items():
            one = RoundInput(*(a[r:r + 1] for a in inputs))
            st, key = carry[d]
            carry[d], infos[d] = run_rounds_carry(cfg, st, net, key, one)
        a, b = _flat(carry["cpu"][0]), [t.cpu() for t in _flat(carry[dev][0])]
        err = _max_abs_err(a, b)
        ierr = _max_abs_err(_flat(infos["cpu"]), [t.cpu() for t in _flat(infos[dev])])
        if err or ierr:
            raise AssertionError(f"full view round {r}: cuda != cpu (state {err}, info {ierr})")
        for k, v in infos["cpu"].items():
            sums[k] = sums.get(k, 0) + int(v.sum())
    if sums["fresh"] <= 0 or sums["syncs"] <= 0 or sums["failed_probes"] <= 0:
        raise AssertionError(f"full view trajectory moved nothing: {sums}")
    print(f"[full-trajectory] N={cfg.n_nodes}: {rounds} rounds of full_mix, every "
          f"leaf and info bitwise equal cuda vs cpu ({time.perf_counter() - t0:.1f} s); "
          f"info sums {sums}", flush=True)


def _with_transactions(cfg, inputs, dev):
    """``inputs`` with one transaction a round for each writing origin: each
    origin writes with probability 1/2, ``tx_len`` uniform in 1..K, cells
    (with replacement) and values uniform, all drawn from key 13."""
    import torch

    from corrosion_tpu_torch import random as prng

    rounds, n = inputs.kill.shape
    k = cfg.tx_max_cells
    k_w, k_len, k_cell, k_val = prng.split(prng.key(13), 4)
    writer = torch.arange(n, device=dev) < cfg.n_origins
    return inputs._replace(
        tx_mask=(prng.uniform(k_w, (rounds, n), dev) < 0.5) & writer,
        tx_len=prng.randint(k_len, (rounds, n), 1, k + 1, dev),
        tx_cell=prng.randint(k_cell, (rounds, n, k), 0, cfg.n_cells, dev),
        tx_val=prng.randint(k_val, (rounds, n, k), 0, 1 << 20, dev),
    )


def _tx_workload(cfg, rounds: int, dev):
    """The full view's workload with :func:`_with_transactions`."""
    from corrosion_tpu_torch.sim.scenario import full_view_workload

    st, net, key, inputs = full_view_workload(cfg, rounds, dev)
    return st, net, key, _with_transactions(cfg, inputs, dev)


def phase_full_tx_trajectory(dev) -> None:
    """The full view at ``tx_max_cells=8`` on the card == on the CPU, every
    leaf and info value after every round, with seeded transactions; the
    plain route launches no kernel."""
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.config import wan_config
    from corrosion_tpu_torch.sim.step import RoundInput, run_rounds_carry

    cfg = wan_config(FULL_TRAJECTORY_NODES, n_origins=16)
    rounds = FULL_TRAJECTORY_ROUNDS
    runs = {d: _tx_workload(cfg, rounds, d) for d in ("cpu", dev)}
    carry = {d: (runs[d][0], runs[d][2]) for d in runs}
    t0 = time.perf_counter()
    mk.reset_launches()
    sums = {}
    for r in range(rounds):
        infos = {}
        for d, (_, net, _, inputs) in runs.items():
            one = RoundInput(*(a[r:r + 1] for a in inputs))
            st, key = carry[d]
            carry[d], infos[d] = run_rounds_carry(cfg, st, net, key, one)
        err = _max_abs_err(_flat(carry["cpu"][0]), [t.cpu() for t in _flat(carry[dev][0])])
        ierr = _max_abs_err(_flat(infos["cpu"]), [t.cpu() for t in _flat(infos[dev])])
        if err or ierr:
            raise AssertionError(f"full view tx round {r}: cuda != cpu (state {err}, "
                                 f"info {ierr})")
        for k, v in infos["cpu"].items():
            sums[k] = sums.get(k, 0) + int(v.sum())
    forms = dict(mk.FORM_LAUNCHES)
    if sums["tx_completed"] <= 0 or sums["fresh"] <= 0 or sums["syncs"] <= 0 or forms:
        raise AssertionError(f"full view tx trajectory: sums {sums}, launches {forms}")
    print(f"[full-tx-trajectory] N={cfg.n_nodes} tx_max_cells={cfg.tx_max_cells} "
          f"partial_slots={cfg.partial_slots}: {rounds} rounds, every leaf and info "
          f"bitwise equal cuda vs cpu ({time.perf_counter() - t0:.1f} s); no kernel "
          f"launched; info sums {sums}", flush=True)


def _timed_batches(make, run, cut, warm: int, batch: int, reps: int):
    """Build the workload with ``make()`` (``(state, net, key, inputs)``),
    run ``warm`` rounds, then ``reps`` timed batches of ``batch`` rounds of
    ``run(state, net, key, cut(inputs, lo, hi))``. Only this frame holds
    the state, so the first round's input state is freed as in a plain
    loop and the peak memory is the run's own. Returns ``(final state,
    the initial state's bytes, rates, infos of the warm-up and of every
    batch)``."""
    import torch

    st, net, key, inputs = make()
    state_bytes = _nbytes(_flat(st))
    (st, key), warm_infos = run(st, net, key, cut(inputs, 0, warm))
    torch.cuda.synchronize()
    rates, infos = [], [warm_infos]
    for lo in range(warm, warm + batch * reps, batch):
        t0 = time.perf_counter()
        (st, key), got = run(st, net, key, cut(inputs, lo, lo + batch))
        torch.cuda.synchronize()
        rates.append(batch / (time.perf_counter() - t0))
        infos.append(got)
    return st, state_bytes, rates, infos


def _spread(rates) -> tuple:
    """(median, first quartile, third quartile) of the batch rates."""
    import statistics

    q1, med, q3 = statistics.quantiles(rates, n=4, method="inclusive")
    return med, q1, q3


def phase_scale_point(dev, name: str, **over) -> dict:
    """``scale_sim_config(FLAGSHIP_NODES, n_origins=16, **over)`` with the
    flagship's workload: ten timed batches of 2 rounds after 2 warm-up
    rounds; the swim kernel once a round, the ingest kernel never."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        scale_run_rounds_carry,
        scale_sim_config,
    )

    cfg = scale_sim_config(FLAGSHIP_NODES, n_origins=16, **over)
    n, warm, batch, reps = cfg.n_nodes, 2, 2, 10
    total = warm + batch * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    st, _, rates, infos = _timed_batches(
        lambda: flagship_workload(cfg, total, dev),
        lambda s, net, k, i: scale_run_rounds_carry(cfg, s, net, k, i),
        lambda inputs, lo, hi: ScaleRoundInput(*(a[lo:hi] for a in inputs)),
        warm, batch, reps)
    launches, forms = dict(mk.LAUNCHES), dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"swim_tables": total, "ingest": 0, "ingest_emit": 0}
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches} != {want}")
    sums = {k: sum(int(i[k].sum()) for i in infos) for k in infos[0]}
    if sums["fresh"] <= 0 or sums["delivered"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"{name} run moved nothing: {sums}")
    if cfg.tx_max_cells > 1 and sums["tx_completed"] <= 0:
        raise AssertionError(f"{name}: no transaction completed: {sums}")
    if int(st.crdt.now) != total or st.crdt.partials.cell.shape[2] != cfg.tx_max_cells:
        raise AssertionError(f"{name} state has the wrong round or partial buffer")
    med, q1, q3 = _spread(rates)
    print(f"[{name}] N={n} {over}: {reps} batches of {batch} rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {med!r} (quartiles {q1!r}-{q3!r}); "
          f"peak device memory {peak} bytes; launches {forms}; info sums {sums}",
          flush=True)
    return {"rounds_per_s": med, "peak_bytes": peak, "forms": forms}


def queues_workload(cfg, rounds: int, device="cuda"):
    """The deep queue's write burst: every node writes with probability 0.25
    a round (a fleet-wide deploy, most machines updating their service
    records within a few seconds), through ``make_write_inputs``, with the
    flagship's net (1 % datagram loss) and round key 0. Returns ``(state,
    net, key, inputs)`` for ``rounds`` stacked rounds."""
    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.sim.scale_step import ScaleSimState, make_write_inputs
    from corrosion_tpu_torch.sim.transport import NetModel

    n = cfg.n_nodes
    k_w, k_in, _ = prng.split(prng.key(1), 3)
    w = prng.uniform(k_w, (rounds, n), device) < 0.25
    return (ScaleSimState.create(cfg, device),
            NetModel.create(n, drop_prob=0.01, device=device),
            prng.key(0), make_write_inputs(cfg, k_in, rounds, w, device))


def _kernel_point(dev, cfg, suffix: str, workload=None) -> tuple:
    """``cfg`` at the flagship's size with ``workload`` (default bench.py's,
    ``flagship_workload``): ten timed batches of 2 rounds after 2 warm-up
    rounds; K1 once a round under its key (``_swim_key``) and K2 and K3
    once a round each under the form keys ending in ``suffix`` (the
    receive's after ``/m{m}`` when its batch is wider than 32, the emitting
    write's followed by ``/r{R}`` past 32 picks); fresh, delivered and
    syncs above 0.
    Returns (final state, its initial bytes, the batch rates, the info
    sums, the form launches, the peak device bytes)."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.broadcast import plane_dtypes
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        scale_run_rounds_carry,
    )

    workload = workload or flagship_workload
    warm, batch, reps = 2, 2, 10
    total = warm + batch * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    st, state_bytes, rates, infos = _timed_batches(
        lambda: workload(cfg, total, dev),
        lambda s, net, k, i: scale_run_rounds_carry(cfg, s, net, k, i),
        lambda inputs, lo, hi: ScaleRoundInput(*(a[lo:hi] for a in inputs)),
        warm, batch, reps)
    forms = dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cdt, qdt = plane_dtypes(cfg)
    key = f"{_bits(cdt)}/{_bits(qdt)}{suffix}"
    m = 4 * cfg.pig_changes
    recv = f"{_bits(cdt)}/{_bits(qdt)}/m{m}{suffix}" if m > 32 else key
    emit = f"{key}/r{cfg.pig_changes}" if cfg.pig_changes > ONE_PICK else key
    want = {_swim_key(cfg): total, ("ingest", recv): total, ("ingest_emit", emit): total}
    if forms != want:
        raise AssertionError(f"{suffix} launch counts {forms} != {want}")
    sums = {k: sum(int(i[k].sum()) for i in infos) for k in infos[0]}
    if sums["fresh"] <= 0 or sums["delivered"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"{suffix} run moved nothing: {sums}")
    if int(st.crdt.now) != total:
        raise AssertionError(f"{suffix} state at round {int(st.crdt.now)}, not {total}")
    return st, state_bytes, rates, sums, forms, peak


def phase_writers(dev) -> dict:
    """The many-writer flagship, ``scale_sim_config(FLAGSHIP_NODES,
    **WRITERS)``, with bench.py's workload (its 256 origin nodes write):
    ``_kernel_point`` with K2 and K3 in the wide book's forms; book slots
    past 32 owned at the end."""
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    cfg = scale_sim_config(FLAGSHIP_NODES, **WRITERS)
    n = cfg.n_nodes
    st, state_bytes, rates, sums, forms, peak = _kernel_point(
        dev, cfg, f"/o{cfg.n_origins}")
    org_id = st.crdt.book.org_id
    owned_wide = int((org_id[:, NARROW_BOOK:] >= 0).sum())
    if org_id.shape != (n, cfg.n_origins) or owned_wide <= 0:
        raise AssertionError(f"writers state: book {tuple(org_id.shape)}, {owned_wide} "
                             f"slots past {NARROW_BOOK} owned")
    med, q1, q3 = _spread(rates)
    print(f"[writers] N={n} {WRITERS}: {len(rates)} batches of 2 rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {med!r} (quartiles {q1!r}-{q3!r}); "
          f"peak device memory {peak} bytes, state {state_bytes} bytes; "
          f"{owned_wide} book slots past {NARROW_BOOK} owned "
          f"({int((org_id >= 0).sum())} of {org_id.numel()} in all); launches {forms}; "
          f"info sums {sums}", flush=True)
    return {"rounds_per_s": med, "peak_bytes": peak, "forms": forms}


def phase_tables(dev) -> dict:
    """The large table, ``scale_sim_config(FLAGSHIP_NODES, **TABLES)``
    (4,096 cells a row), with bench.py's workload: ``_kernel_point`` with K2
    and K3 in the form that keeps the row in global memory; cells past 256
    written at the end; the state's bytes equal to the static projection
    (``obs.memory.projected_bytes``)."""
    from corrosion_tpu_torch.obs.memory import projected_bytes
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    cfg = scale_sim_config(FLAGSHIP_NODES, **TABLES)
    n = cfg.n_nodes
    st, state_bytes, rates, sums, forms, peak = _kernel_point(
        dev, cfg, f"/c{cfg.n_cells}")
    written = int((st.crdt.store[0][:, STAGED_CELLS:] > 0).sum())
    projected = projected_bytes(cfg, n)
    if st.crdt.store[0].shape != (n, cfg.n_cells) or written <= 0:
        raise AssertionError(f"tables state: store {tuple(st.crdt.store[0].shape)}, "
                             f"{written} cells past {STAGED_CELLS} written")
    if projected != state_bytes:
        raise AssertionError(f"tables: state {state_bytes} bytes != projected {projected}")
    med, q1, q3 = _spread(rates)
    print(f"[tables] N={n} {TABLES} ({cfg.n_cells} cells a row): {len(rates)} batches of "
          f"2 rounds at {[repr(x) for x in rates]} rounds/s, median {med!r} (quartiles "
          f"{q1!r}-{q3!r}); peak device memory {peak} bytes, state {state_bytes} bytes, "
          f"projected {projected} bytes; {written} cells past {STAGED_CELLS} written; "
          f"launches {forms}; info sums {sums}", flush=True)
    return {"rounds_per_s": med, "peak_bytes": peak, "forms": forms}


def _deep_queue_rows(st) -> tuple:
    """(rows with a queue slot past SHALLOW_QUEUE occupied, rows holding more
    than SHALLOW_QUEUE occupied slots)."""
    live = st.crdt.q_origin != -1
    return (int(live[:, SHALLOW_QUEUE:].any(dim=1).sum()),
            int((live.sum(dim=1) > SHALLOW_QUEUE).sum()))


def phase_queues(dev) -> dict:
    """The deep queue, ``scale_sim_config(FLAGSHIP_NODES, **QUEUES)``, under
    its write burst (``queues_workload``): ``_kernel_point`` with K2 and K3
    in the deep form's keys; rows holding more than 64 occupied queue slots
    at the end (on the H100 they pass 64 from round ~18 of the 22); the
    state's bytes equal to the static projection."""
    from corrosion_tpu_torch.obs.memory import projected_bytes
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    cfg = scale_sim_config(FLAGSHIP_NODES, **QUEUES)
    n = cfg.n_nodes
    suffix = f"/o{cfg.n_origins}/q{cfg.bcast_queue}/w{cfg.buf_slots // 32}"
    st, state_bytes, rates, sums, forms, peak = _kernel_point(
        dev, cfg, suffix, workload=queues_workload)
    past, deep = _deep_queue_rows(st)
    projected = projected_bytes(cfg, n)
    if st.crdt.q_origin.shape != (n, cfg.bcast_queue) or deep <= 0:
        raise AssertionError(f"queues state: queue {tuple(st.crdt.q_origin.shape)}, {deep} "
                             f"rows with more than {SHALLOW_QUEUE} slots occupied")
    if projected != state_bytes:
        raise AssertionError(f"queues: state {state_bytes} bytes != projected {projected}")
    med, q1, q3 = _spread(rates)
    print(f"[queues] N={n} {QUEUES}: {len(rates)} batches of 2 rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {med!r} (quartiles {q1!r}-{q3!r}); "
          f"peak device memory {peak} bytes, state {state_bytes} bytes, projected "
          f"{projected} bytes; {past} rows with a slot past {SHALLOW_QUEUE} occupied, "
          f"{deep} holding more than {SHALLOW_QUEUE}; launches {forms}; info sums {sums}",
          flush=True)
    return {"rounds_per_s": med, "peak_bytes": peak, "forms": forms}


def _check_deep_launches(label, over, n_nodes: int, forms, rounds: int) -> None:
    """K1 once a round, and K2 and K3 once a round each under the deep
    form's keys of ``scale_sim_config(n_nodes, **over)`` (the receive's
    after ``/m{m}``, the emitting write's followed by ``/r{R}`` past
    ONE_PICK picks)."""
    from corrosion_tpu_torch.sim.broadcast import plane_dtypes
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    cfg = scale_sim_config(n_nodes, **over)
    cdt, qdt = plane_dtypes(cfg)
    deep = f"/o{cfg.n_origins}/q{cfg.bcast_queue}/w{cfg.buf_slots // 32}"
    bits = f"{_bits(cdt)}/{_bits(qdt)}"
    picks = f"/r{cfg.pig_changes}" if cfg.pig_changes > ONE_PICK else ""
    swim = sum(v for (k, _), v in forms.items() if k == "swim_tables")
    ingest = {kf: v for kf, v in forms.items() if kf[0] != "swim_tables"}
    want = {("ingest", f"{bits}/m{4 * cfg.pig_changes}{deep}"): rounds,
            ("ingest_emit", f"{bits}{deep}{picks}"): rounds}
    if swim != rounds or ingest != want:
        raise AssertionError(f"{label}: swim launches {swim} != {rounds} or ingest "
                             f"launches {ingest} != {want}")


def phase_queues_trajectory(dev) -> None:
    """Phase 3's trajectory for the deep queue at QUEUES_TRAJECTORY_NODES
    (the CPU route's pace at these widths), a quarter of the nodes writing
    each round: card and CPU bitwise equal every round, K2 and K3 in the
    deep form's keys once a round each and K1 once a round, queue slots
    past 64 occupied on both sides at the end."""
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    rounds = QUEUES_TRAJECTORY_ROUNDS
    forms, sums, rows = phase_trajectory(
        dev, "deep queue", lambda n, **kw: scale_sim_config(n, **QUEUES, **kw), rounds,
        n_nodes=QUEUES_TRAJECTORY_NODES, write_p=0.25,
        final=lambda a, b: (_deep_queue_rows(a), _deep_queue_rows(b)))
    _check_deep_launches("deep queue", QUEUES, QUEUES_TRAJECTORY_NODES, forms, rounds)
    print(f"[trajectory] deep queue: rows with a slot past {SHALLOW_QUEUE} occupied, and "
          f"holding more than {SHALLOW_QUEUE}: cpu {rows[0]}, card {rows[1]}", flush=True)
    if sums["fresh"] <= 0 or min(rows[0]) <= 0 or rows[0] != rows[1]:
        raise AssertionError(f"deep queue: fresh {sums['fresh']}, rows past "
                             f"{SHALLOW_QUEUE} cpu {rows[0]} card {rows[1]}")


def _live_slots_past_pick(st) -> int:
    """Rows whose queue holds more than ONE_PICK live slots (the next
    round's emitting write picks more than ONE_PICK of them)."""
    live = (st.crdt.q_origin != -1) & (st.crdt.q_tx > 0)
    return int((live.sum(dim=1) > ONE_PICK).sum())


def phase_packets(dev, flag: dict) -> dict:
    """The wide packet, ``scale_sim_config(FLAGSHIP_NODES, **PACKETS)``,
    under the deep queue's write burst (``queues_workload``):
    ``_kernel_point`` with K2 (m = 256) and K3 (64 picks) in the long
    form's keys; rows holding more than 32 live queue slots at the end; the
    state's bytes equal to the static projection. Prints its rounds/s
    beside the flagship's (``flag``, this call's phase 4)."""
    from corrosion_tpu_torch.obs.memory import projected_bytes
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    cfg = scale_sim_config(FLAGSHIP_NODES, **PACKETS)
    n = cfg.n_nodes
    suffix = f"/o{cfg.n_origins}/q{cfg.bcast_queue}/w{cfg.buf_slots // 32}"
    st, state_bytes, rates, sums, forms, peak = _kernel_point(
        dev, cfg, suffix, workload=queues_workload)
    rows = _live_slots_past_pick(st)
    projected = projected_bytes(cfg, n)
    if rows <= 0:
        raise AssertionError(f"packets: no row holds more than {ONE_PICK} live queue slots")
    if projected != state_bytes:
        raise AssertionError(f"packets: state {state_bytes} bytes != projected {projected}")
    med, q1, q3 = _spread(rates)
    print(f"[packets] N={n} {PACKETS}: {len(rates)} batches of 2 rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {med!r} (quartiles {q1!r}-{q3!r}; "
          f"the flagship's median {flag['rounds_per_s']!r} in this call); peak device memory "
          f"{peak} bytes, state {state_bytes} bytes, projected {projected} bytes; {rows} rows "
          f"holding more than {ONE_PICK} live queue slots; launches {forms}; info sums {sums}",
          flush=True)
    return {"rounds_per_s": med, "peak_bytes": peak, "forms": forms}


def _past_register(st) -> int:
    """Rows with an occupied member slot at or past REGISTER_SLOTS."""
    return int((st.swim.mem_id[:, REGISTER_SLOTS:] >= 0).any(dim=1).sum())


def phase_members(dev, flag: dict) -> dict:
    """The wide member table, ``scale_sim_config(FLAGSHIP_NODES,
    **MEMBERS)``, with bench.py's workload: ``_kernel_point`` with K1 in
    its wide form's key; rows with an occupied member slot at or past 128
    at the end; the state's bytes equal to the static projection. Prints
    its rounds/s beside the flagship's (``flag``, this call's phase 4)."""
    from corrosion_tpu_torch.obs.memory import projected_bytes
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    cfg = scale_sim_config(FLAGSHIP_NODES, **MEMBERS)
    n = cfg.n_nodes
    st, state_bytes, rates, sums, forms, peak = _kernel_point(dev, cfg, "")
    rows = _past_register(st)
    projected = projected_bytes(cfg, n)
    if st.swim.mem_id.shape != (n, cfg.m_slots) or rows <= 0:
        raise AssertionError(f"members state: table {tuple(st.swim.mem_id.shape)}, {rows} "
                             f"rows with a slot past {REGISTER_SLOTS} occupied")
    if projected != state_bytes:
        raise AssertionError(f"members: state {state_bytes} bytes != projected {projected}")
    med, q1, q3 = _spread(rates)
    print(f"[members] N={n} {MEMBERS}: {len(rates)} batches of 2 rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {med!r} (quartiles {q1!r}-{q3!r}; "
          f"the flagship's median {flag['rounds_per_s']!r} in this call); peak device memory "
          f"{peak} bytes, state {state_bytes} bytes, projected {projected} bytes; {rows} rows "
          f"with a member slot past {REGISTER_SLOTS} occupied; launches {forms}; info sums "
          f"{sums}", flush=True)
    return {"rounds_per_s": med, "peak_bytes": peak, "forms": forms}


def phase_members_trajectory(dev) -> None:
    """Phase 3's trajectory for the wide member table at
    MEMBERS_TRAJECTORY_NODES, aligned (``scale_sim_config``) and packed
    under the 1M point's tiers (``million_config``): card and CPU bitwise
    equal every round, K1 in its wide key once a round, rows with an
    occupied member slot at or past 128 on both sides at the end, and a
    sync round inside."""
    from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config

    rounds = MEMBERS_TRAJECTORY_ROUNDS
    for label, make in (("wide member table", scale_sim_config),
                        ("wide member table, packed", million_config)):
        forms, sums, rows = phase_trajectory(
            dev, label, lambda n, make=make, **kw: make(n, **MEMBERS, **kw), rounds,
            n_nodes=MEMBERS_TRAJECTORY_NODES,
            final=lambda a, b: (_past_register(a), _past_register(b)))
        swim = {kf: v for kf, v in forms.items() if kf[0] == "swim_tables"}
        want = {_swim_key(make(MEMBERS_TRAJECTORY_NODES, **MEMBERS)): rounds}
        print(f"[trajectory] {label}: rows with a member slot past {REGISTER_SLOTS} "
              f"occupied: cpu {rows[0]}, card {rows[1]}; syncs {sums['syncs']}", flush=True)
        if swim != want:
            raise AssertionError(f"{label}: swim launches {swim} != {want}")
        if rows[0] <= 0 or rows[0] != rows[1] or sums["syncs"] <= 0:
            raise AssertionError(f"{label}: rows past {REGISTER_SLOTS} cpu {rows[0]} card "
                                 f"{rows[1]}, syncs {sums['syncs']}")


@contextlib.contextmanager
def _counting_picks(rows: dict):
    """Add each emitting ingest call's rows with more than ONE_PICK live
    picks to ``rows[device type]`` while inside."""
    from corrosion_tpu_torch.ops import megakernel as mk

    inner = mk.ingest

    def counting(p, x):
        out = inner(p, x)
        if p.pig_r:
            d = x.origin.device.type
            rows[d] = rows.get(d, 0) + int((out.sel_ok.sum(dim=1) > ONE_PICK).sum())
        return out

    mk.ingest = counting
    try:
        yield rows
    finally:
        mk.ingest = inner


def phase_packets_trajectory(dev) -> None:
    """Phase 3's trajectory for the wide packet at PACKETS_TRAJECTORY_NODES,
    a quarter of the nodes writing each round: card and CPU bitwise equal
    every round, K2 (m = 256) and K3 (64 picks) in the long form's keys
    once a round each and K1 once a round, rows with more than 32 live
    picks on both sides."""
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    rounds = PACKETS_TRAJECTORY_ROUNDS
    with _counting_picks({}) as picks:
        forms, sums = phase_trajectory(
            dev, "wide packet", lambda n, **kw: scale_sim_config(n, **PACKETS, **kw), rounds,
            n_nodes=PACKETS_TRAJECTORY_NODES, write_p=0.25)
    _check_deep_launches("wide packet", PACKETS, PACKETS_TRAJECTORY_NODES, forms, rounds)
    print(f"[trajectory] wide packet: rows with more than {ONE_PICK} live picks over the "
          f"{rounds} rounds: {picks}", flush=True)
    if sums["fresh"] <= 0 or min(picks.get(d, 0) for d in ("cpu", "cuda")) <= 0:
        raise AssertionError(f"wide packet: fresh {sums['fresh']}, rows past {ONE_PICK} "
                             f"picks {picks}")


def phase_writers_trajectory(dev) -> None:
    """Phase 3's trajectory for the many-writer configuration: card and
    CPU bitwise equal every round, K2 and K3 in the wide book's forms once
    a round each and K1 once a round."""
    from corrosion_tpu_torch.sim.broadcast import plane_dtypes
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    rounds = TRAJECTORY_ROUNDS
    forms, sums = phase_trajectory(
        dev, "many writers", lambda n, **kw: scale_sim_config(n, **WRITERS, **kw), rounds)
    cdt, qdt = plane_dtypes(scale_sim_config(TRAJECTORY_NODES, **WRITERS))
    book = f"{_bits(cdt)}/{_bits(qdt)}/o{WRITERS['n_origins']}"
    swim = sum(v for (k, _), v in forms.items() if k == "swim_tables")
    ingest = {kf: v for kf, v in forms.items() if kf[0] != "swim_tables"}
    want = {("ingest", book): rounds, ("ingest_emit", book): rounds}
    if swim != rounds or ingest != want:
        raise AssertionError(f"many writers: swim launches {swim} != {rounds} or ingest "
                             f"launches {ingest} != {want}")
    if sums["fresh"] <= 0:
        raise AssertionError(f"many writers: nothing fresh ({sums})")


def phase_tables_trajectory(dev) -> None:
    """Phase 3's trajectory for the large table (4,096 cells a row): card
    and CPU bitwise equal every round, K2 and K3 in the row-in-global-memory
    forms once a round each and K1 once a round, cells past 256 written."""
    from corrosion_tpu_torch.sim.broadcast import plane_dtypes
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    rounds = TRAJECTORY_ROUNDS
    forms, sums = phase_trajectory(
        dev, "large table", lambda n, **kw: scale_sim_config(n, **TABLES, **kw), rounds,
        n_nodes=TABLES_TRAJECTORY_NODES)
    cfg = scale_sim_config(TABLES_TRAJECTORY_NODES, **TABLES)
    cdt, qdt = plane_dtypes(cfg)
    row = f"{_bits(cdt)}/{_bits(qdt)}/c{cfg.n_cells}"
    swim = sum(v for (k, _), v in forms.items() if k == "swim_tables")
    ingest = {kf: v for kf, v in forms.items() if kf[0] != "swim_tables"}
    want = {("ingest", row): rounds, ("ingest_emit", row): rounds}
    if swim != rounds or ingest != want:
        raise AssertionError(f"large table: swim launches {swim} != {rounds} or ingest "
                             f"launches {ingest} != {want}")
    if sums["fresh"] <= 0:
        raise AssertionError(f"large table: nothing fresh ({sums})")


def phase_full_tx(dev) -> dict:
    """The full view at ``wan_config(FULL_NODES, n_origins=16)``
    (``tx_max_cells=8``) with seeded transactions: ten timed batches of one
    round after 2 warm-up rounds; no kernel launches."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.config import wan_config
    from corrosion_tpu_torch.sim.step import RoundInput, crdt_metrics, run_rounds_carry

    cfg = wan_config(FULL_NODES, n_origins=16)
    n, warm, batch, reps = cfg.n_nodes, 2, 1, 10
    total = warm + batch * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    st, state_bytes, rates, infos = _timed_batches(
        lambda: _tx_workload(cfg, total, dev),
        lambda s, net, k, i: run_rounds_carry(cfg, s, net, k, i),
        lambda inputs, lo, hi: RoundInput(*(a[lo:hi] for a in inputs)),
        warm, batch, reps)
    forms = dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sums = {k: sum(int(i[k].sum()) for i in infos) for k in infos[0]}
    if forms or sums["tx_completed"] <= 0 or sums["fresh"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"full view tx run: launches {forms}, sums {sums}")
    if int(st.crdt.now) != total or _nbytes(_flat(st)) != state_bytes:
        raise AssertionError("full view tx state has the wrong round or size")
    metrics = {k: v.item() for k, v in crdt_metrics(cfg, st).items()}
    med, q1, q3 = _spread(rates)
    print(f"[full-tx] N={n} tx_max_cells={cfg.tx_max_cells} partial_slots="
          f"{cfg.partial_slots} recv_slots={cfg.recv_slots}: {reps} batches of {batch} "
          f"round at {[repr(x) for x in rates]} rounds/s, median {med!r} (quartiles "
          f"{q1!r}-{q3!r}); peak device memory {peak} bytes; carried state "
          f"{state_bytes} bytes; launches {forms}; info sums {sums}; metrics {metrics}",
          flush=True)
    return {"rounds_per_s": med, "peak_bytes": peak, "forms": forms}


def phase_full(dev) -> dict:
    """The full view at ``FULL_NODES`` through the port's entry points: the
    ingest kernel launches once a round as the local write (m=1) and once as
    the recv_slots-wide receive batch, and the swim kernel never."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scenario import full_view_workload
    from corrosion_tpu_torch.sim.step import RoundInput, crdt_metrics, run_rounds_carry

    cfg = full_view_config(FULL_NODES)
    n, warm, batch, reps = cfg.n_nodes, 2, 4, 3
    total = warm + batch * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    st, state_bytes, rates, batch_infos = _timed_batches(
        lambda: full_view_workload(cfg, total, dev),
        lambda s, net, k, i: run_rounds_carry(cfg, s, net, k, i),
        lambda inputs, lo, hi: RoundInput(*(a[lo:hi] for a in inputs)),
        warm, batch, reps)
    forms = dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want_forms = {("ingest", "32/32"): total,
                  ("ingest", f"32/32/m{cfg.recv_slots}"): total}
    if forms != want_forms:
        raise AssertionError(f"full view launch counts {forms} != {want_forms}")
    sums = {k: sum(int(i[k].sum()) for i in batch_infos) for k in batch_infos[0]}
    if sums["fresh"] <= 0 or sums["sent"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"full view run moved nothing: {sums}")
    if (int(st.crdt.now) != total or st.swim.view.shape != (n, n)
            or _nbytes(_flat(st)) != state_bytes):
        raise AssertionError("full view state has the wrong round, shape or size")
    metrics = {k: v.item() for k, v in crdt_metrics(cfg, st).items()}
    median = sorted(rates)[len(rates) // 2]
    print(f"[full] N={n} recv_slots={cfg.recv_slots} Q={cfg.bcast_queue} "
          f"fanout={cfg.bcast_fanout}: {reps} batches of {batch} rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {median!r} (spread "
          f"{min(rates)!r}-{max(rates)!r}); peak device memory {peak} bytes; "
          f"carried state {state_bytes} bytes ({state_bytes / n!r} B/node); "
          f"launches {forms}; info sums {sums}; metrics {metrics}", flush=True)
    return {"rounds_per_s": median, "peak_bytes": peak, "forms": forms}


def _same_tables(label, live: dict, static: dict) -> None:
    """A live audit must equal the static projection at its point, leaf for
    leaf (shape, dtype, bytes, class, bytes a node) and in its totals."""
    keys = ("shape", "dtype", "nbytes", "class", "per_node_bytes")
    if static["unresolved"] or list(live["tables"]) != list(static["tables"]):
        raise AssertionError(f"{label}: leaves {list(live['tables'])} != "
                             f"{list(static['tables'])} (unresolved {static['unresolved']})")
    for name, entry in live["tables"].items():
        want = {k: static["tables"][name].get(k) for k in keys}
        if {k: entry.get(k) for k in keys} != want:
            raise AssertionError(f"{label}: {name} live {entry} != static {want}")
    for k in ("total_bytes", "n_nodes", "by_class"):
        if live[k] != static[k]:
            raise AssertionError(f"{label}: {k} live {live[k]} != static {static[k]}")


def phase_cost(dev, million_audit: dict) -> dict:
    """The static memory projection and the cost model, on the card: live
    audits against their projections, one counted flagship round and one
    direct 1M count against the fits, exactly."""
    import contextlib
    import io

    import torch

    from corrosion_tpu_torch import cli
    from corrosion_tpu_torch.analysis import cost
    from corrosion_tpu_torch.obs.memory import static_report
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config

    # mem-report live on the card (the CLI's default device) vs --project
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["mem-report", "--n-nodes", str(FLAGSHIP_NODES)])
    live = json.loads(out.getvalue())
    flagship = scale_sim_config(FLAGSHIP_NODES)
    static = static_report(flagship)
    if rc != 0 or live["mode"] != "scale":
        raise AssertionError(f"mem-report exit {rc}, mode {live.get('mode')}")
    _same_tables("mem-report 100k", live, static)
    _same_tables("1M state", million_audit, static_report(million_config(MILLION_NODES)))
    print(f"[cost] mem-report live on the card at N={FLAGSHIP_NODES}: "
          f"{live['total_bytes']} bytes in {len(live['tables'])} tables, equal to "
          f"static_report leaf for leaf; the 1M phase's state {million_audit['total_bytes']} "
          f"bytes equal to the projection of million_config()", flush=True)

    # one flagship round, counted on the card with K1-K3 inside it
    t0 = time.perf_counter()
    fits = cost.fit_entry("scale_sim_step", device="cpu")
    fit_s = time.perf_counter() - t0
    env = {"N": FLAGSHIP_NODES, "M": flagship.m_slots}
    run = cost.PRICED_ENTRY_POINTS["scale_sim_step"].build(flagship, 1, dev)
    torch.cuda.synchronize()
    mk.reset_launches()
    with cost.Counter(keep=cost.KERNEL_UNITS) as counter:
        run()
    torch.cuda.synchronize()
    launches, forms = dict(mk.LAUNCHES), dict(mk.FORM_LAUNCHES)
    count = counter.count()
    want = (fits["flops"].at(env), fits["hbm_bytes"].at(env))
    if launches != {"swim_tables": 1, "ingest": 1, "ingest_emit": 1}:
        raise AssertionError(f"counted round launched {launches}, not K1-K3 once each")
    if counter.arms["sync"] != 1 or counter.arms["sweep"] != 1:
        raise AssertionError(f"counted round took the arms {dict(counter.arms)}")
    if (count.flops, count.hbm_bytes) != want:
        raise AssertionError(f"flagship round on the card counts {count}, the fit {want}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    round_s = sorted(times)[1]
    model_s = count.hbm_bytes / H100_BYTES_PER_S
    print(f"[cost] flagship round at N={FLAGSHIP_NODES} on the card: {count.flops} operations, "
          f"{count.hbm_bytes} model bytes, {count.eqns} priced calls (units {dict(counter.units)}), "
          f"equal to the fit of scale_sim_step made from CPU points in {fit_s:.1f} s "
          f"({fits['flops'].render()} | {fits['hbm_bytes'].render()}); launches {forms}; "
          f"model bytes / 3.35 TB/s = {model_s * 1e3!r} ms beside the round's "
          f"{round_s * 1e3!r} ms (median of 3, uncounted)", flush=True)
    for name, args, _kw, got, flops, nbytes in counter.calls:
        if name == "swim_tables":
            consts, tensors = args[0], args[1:]
            pig_k = int(consts[4]) if len(consts) > 4 else 0
            table = (_swim_bytes(tensors, got, pig_k), _swim_ops(tensors, pig_k))
        else:
            p, x = args
            name = "ingest_emit" if p.pig_r else "ingest"
            table = (_ingest_bytes(x, got), _ingest_ops(p, x, got))
        print(f"[cost] unit {name}: {nbytes} bytes, {flops} operations (worst case); the "
              f"kernel table's count for this call: {table[0]} bytes, {table[1]} operations",
              flush=True)

    # the direct 1M count against the fit's projection
    t0 = time.perf_counter()
    fits = cost.fit_entry("sharded_scale_run", device="cpu")
    torch.cuda.synchronize()
    mk.reset_launches()
    t1 = time.perf_counter()
    direct = cost.price_per_round("sharded_scale_run", dict(cost.ROOFLINE_POINT), device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    proj = (fits["flops"].at(cost.ROOFLINE_POINT), fits["hbm_bytes"].at(cost.ROOFLINE_POINT))
    if (direct.flops, direct.hbm_bytes) != proj or not all(f.exact for f in fits.values()):
        raise AssertionError(f"direct 1M count {direct} != projection {proj}")
    if dict(mk.LAUNCHES) != {"swim_tables": 3, "ingest": 3, "ingest_emit": 3}:
        raise AssertionError(f"1M count launched {dict(mk.LAUNCHES)}")
    roof = cost.roofline(device="cpu")
    print(f"[cost] sharded_scale_run counted directly at {cost.ROOFLINE_POINT} on the card "
          f"({t2 - t1:.1f} s, 2 rounds minus 1): {direct.flops} operations, {direct.hbm_bytes} "
          f"model bytes a round, equal to the projection of its fit (made in {t1 - t0:.1f} s); "
          f"roofline {json.dumps(roof['entries'])}", flush=True)
    return {"flagship": count, "direct_1m": direct}


def phase_quiet(dev) -> None:
    """The quiet round on the card == the dense round on the card and the
    quiet round on the CPU, on a settled trace (the JAX package's quiet-test
    shape, with the 1M point's tiers and bounded packets of 4 entries). Its
    fixpoint branch runs, and launches no kernel: each kernel launches once
    in every dense round of the card's quiet run."""
    import torch

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleSimState,
        make_write_inputs,
        million_config,
        scale_run_rounds,
    )
    from corrosion_tpu_torch.sim.transport import NetModel

    n, rounds = 48, 48
    shape = dict(m_slots=8, n_origins=4, n_rows=4, n_cols=2, sync_interval=4,
                 pig_members=4)

    def run(quiet, d):
        cfg = million_config(n, quiet=quiet, **shape)
        inputs = make_write_inputs(cfg, prng.key(8), rounds,
                                   torch.zeros((rounds, n), dtype=torch.bool), d)
        return scale_run_rounds(cfg, ScaleSimState.create(cfg, d),
                                NetModel.create(n, device=d), prng.key(0), inputs)

    st_d, i_d = run("off", dev)
    mk.reset_launches()
    st_q, i_q = run("on", dev)
    torch.cuda.synchronize()
    forms = dict(mk.FORM_LAUNCHES)
    st_c, i_c = run("on", "cpu")
    cheap = int(i_q["quiet_round"].sum())
    dense = rounds - cheap
    want_forms = {("swim_tables", "packed/16/8"): dense, ("ingest", "16/8"): dense,
                  ("ingest_emit", "16/8"): dense}
    err = _max_abs_err(_flat(st_d), _flat(st_q))
    ierr = _max_abs_err(_flat(i_d), _flat({k: i_q[k] for k in i_d}))
    cerr = _max_abs_err(_flat(st_c), [t.cpu() for t in _flat(st_q)])
    cierr = _max_abs_err(_flat(i_c), [t.cpu() for t in _flat(i_q)])
    if err or ierr or cerr or cierr or cheap <= 0 or forms != want_forms:
        raise AssertionError(
            f"quiet round: vs dense state err {err}, info err {ierr}; vs cpu state "
            f"err {cerr}, info err {cierr}; {cheap} fixpoint rounds; launches "
            f"{forms} != {want_forms}")
    print(f"[quiet] N={n}: {rounds} rounds, quiet == dense on the card and == quiet "
          f"on the cpu, bitwise; {cheap} fixpoint rounds, "
          f"{int(i_q['quiet_backstop'].sum())} backstop rounds; launches {forms}",
          flush=True)


#: the parity phase's scripts: (label, generator, its arguments after
#: (n_nodes, n_origins), run_sim_script keywords, the check that applies)
PARITY_SCRIPTS = (
    ("single_writer", "random_single_writer", (PARITY_CELLS, PARITY_ROUNDS),
     dict(seed=3), dict(seed=3, quiet="off"), "bitwise"),
    ("single_writer_loss", "random_single_writer", (PARITY_CELLS, PARITY_ROUNDS),
     dict(seed=3), dict(seed=11, drop_prob=0.05), "bitwise"),
    ("transactions_tx4", "random_transactions", (PARITY_CELLS, PARITY_ROUNDS),
     dict(tx_cells=4, seed=3), dict(seed=3), "bitwise"),
    ("conflicting", "random_conflicting", (PARITY_CELLS, PARITY_ROUNDS),
     dict(seed=5, hot_cells=2), dict(seed=5), "agreement"),
    ("delete_resurrect", "random_delete_resurrect", (16, 4, PARITY_ROUNDS),
     dict(seed=9), dict(seed=9), "agreement"),
    ("full_mix", "random_full_mix", (PARITY_CELLS, PARITY_ROUNDS),
     dict(seed=9), dict(seed=9), "agreement"),
)


def _same_run(a, b) -> bool:
    """Two ``run_sim_script`` results (planes, alive, rounds-taken) equal."""
    import numpy as np

    return (a[2] == b[2] and np.array_equal(a[1], b[1])
            and all(np.array_equal(p, q) for p, q in zip(a[0], b[0], strict=True)))


def parity_references() -> dict:
    """The CPU half of the parity phase, which needs no kernel (``main`` runs
    it while nvcc builds them): for each of PARITY_SCRIPTS the script, the
    pure-Python oracle cluster run on it, the C++ host oracle
    (``native.NativeCluster``, built by the port's bindings) for the
    bitwise scripts, and ``run_sim_script`` on the CPU route, each timed."""
    from corrosion_tpu_torch.native import NativeCluster
    from corrosion_tpu_torch.sim import parity

    n, o = PARITY_NODES, PARITY_ORIGINS
    refs = {}
    for label, gen, args, gen_kw, kw, check in PARITY_SCRIPTS:
        script = getattr(parity.WorkloadScript, gen)(n, o, *args, **gen_kw)
        ref = {"script": script}
        ref["oracle"] = parity.OracleCluster(n, o, script.n_cells, seed=1)
        t0 = time.perf_counter()
        ref["oracle_rounds"] = ref["oracle"].run(script, settle_rounds=512)
        ref["oracle_s"] = time.perf_counter() - t0
        if check == "bitwise":
            ref["native"] = NativeCluster(n, o, script.n_cells, fanout=4, sync_peers=2, seed=4)
            t0 = time.perf_counter()
            ref["native_rounds"] = ref["native"].run(script, settle_rounds=512)
            ref["native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref["cpu"] = parity.run_sim_script(script, settle_rounds=512, device="cpu", **kw)
        ref["cpu_s"] = time.perf_counter() - t0
        refs[label] = ref
    return refs


def phase_parity(dev, refs: dict) -> dict:
    """BASELINE's state-parity check at N = ``PARITY_NODES``: each script
    through the port's ``run_sim_script`` on the card, which must converge,
    equal the oracle of ``parity_references`` (bitwise for single writers,
    agreement and validity otherwise; the single-writer scripts also
    against ``native.NativeCluster``, the C++ host oracle, whose stores
    must equal the card's planes bitwise), equal the same script on the
    CPU route bitwise, and launch each kernel once a round on the kernel
    route (the swim kernel alone on the plain route of multi-cell
    transactions). The single writer's script with ``PARITY_QUIET_TAIL``
    empty rounds appended gives the same result under ``quiet="on"`` as
    under ``"off"`` with some rounds quiet (no swim launch) and some
    dense."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim import parity

    n, o = PARITY_NODES, PARITY_ORIGINS
    out = {}
    for label, gen, args, gen_kw, kw, check in PARITY_SCRIPTS:
        ref = refs[label]
        script, o_taken, o_s = ref["script"], ref["oracle_rounds"], ref["oracle_s"]
        mk.reset_launches()
        t0 = time.perf_counter()
        card = parity.run_sim_script(script, settle_rounds=512, device=dev, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = dict(mk.LAUNCHES)
        cpu, cpu_s = ref["cpu"], ref["cpu_s"]
        planes, alive, taken = card
        if check == "bitwise":
            problems = parity.check_bitwise_parity(ref["oracle"], planes, alive)
            n_taken, n_s = ref["native_rounds"], ref["native_s"]
            if n_taken <= 0:
                problems.append(f"NativeCluster did not converge ({n_taken})")
            problems += [f"native: {p}" for p in
                         parity.check_bitwise_parity(ref["native"], planes, alive)]
        else:
            problems = parity.check_agreement_validity(script, planes, alive)
        # the round steps run: the script, the final revive-all, the settle
        steps = taken + (1 if script.faults else 0)
        kernel = script.max_tx_cells == 1
        want = {"swim_tables": steps, "ingest": steps if kernel else 0,
                "ingest_emit": steps if kernel else 0}
        if (o_taken <= 0 or taken <= 0 or problems or not _same_run(card, cpu)
                or launches != want):
            raise AssertionError(
                f"parity {label}: oracle rounds {o_taken}, card rounds {taken}, "
                f"card == cpu {_same_run(card, cpu)}, problems {problems[:4]}, "
                f"launches {launches} != {want}")
        if gen == "random_full_mix" and not {"kill", "partition"} <= {
                e[0] for evs in script.faults for e in evs}:
            raise AssertionError(f"parity {label}: the script has no kill or partition")
        line = (f"[parity] N={n} {label} ({check}): oracle {o_taken} rounds in "
                f"{o_s:.2f} s; card {taken} rounds in {card_s:.2f} s, cpu "
                f"{cpu[2]} rounds in {cpu_s:.2f} s, card == cpu bitwise; "
                f"launches {launches}")
        if check == "bitwise":
            line += (f"; NativeCluster {n_taken} rounds in {n_s:.2f} s, its stores "
                     f"bitwise equal to the card's planes")
        if label == "single_writer":
            # the same writes, then empty rounds: the cluster settles inside
            # the script, so some rounds take the quiet branch
            tail = getattr(parity.WorkloadScript, gen)(n, o, *args, **gen_kw)
            tail.writes += [[] for _ in range(PARITY_QUIET_TAIL)]
            off = parity.run_sim_script(tail, settle_rounds=512, device=dev, **kw)
            mk.reset_launches()
            t0 = time.perf_counter()
            on = parity.run_sim_script(tail, settle_rounds=512, device=dev,
                                       **{**kw, "quiet": "on"})
            torch.cuda.synchronize()
            on_s = time.perf_counter() - t0
            dense = mk.LAUNCHES["swim_tables"]
            if off[2] <= 0 or not _same_run(on, off) or not 0 < dense < off[2]:
                raise AssertionError(
                    f"parity {label}: with {PARITY_QUIET_TAIL} empty rounds, "
                    f"quiet='on' != 'off' ({on[2]} vs {off[2]} rounds) or "
                    f"{dense} dense rounds of {off[2]}")
            line += (f"; with {PARITY_QUIET_TAIL} empty rounds appended, quiet='on' "
                     f"== 'off' in {on_s:.2f} s, {dense} of {off[2]} rounds dense")
        print(line, flush=True)
        out[label] = {"oracle_rounds": o_taken, "rounds": taken, "card_s": card_s,
                      "cpu_s": cpu_s, "oracle_s": o_s, "launches": launches}
    return out


def _soak_arm(run):
    """``run()`` with the peak-memory and launch counters reset before it;
    returns (its result, seconds, peak device bytes, launches per form)."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0, torch.cuda.max_memory_allocated(), dict(
        mk.FORM_LAUNCHES)


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _check_soak(label, arms: dict) -> None:
    """Every arm's final state and infos equal the straight arm's bitwise,
    its launches per form equal, and its peak device bytes within 5 %."""
    want_st, want_infos, want_forms, want_peak = arms["straight"]
    for name, (st, infos, forms, peak) in arms.items():
        err = _max_abs_err(_flat(want_st), _flat(st))
        ierr = _max_abs_err(_flat(want_infos), _flat({k: infos[k] for k in want_infos}))
        if err or ierr or forms != want_forms or abs(peak - want_peak) > 0.05 * want_peak:
            raise AssertionError(
                f"{label} {name}: state err {err}, info err {ierr}, launches "
                f"{forms} vs {want_forms}, peak {peak} vs {want_peak} bytes")


def phase_soak(dev) -> dict:
    """The flagship (``scale_sim_config(FLAGSHIP_NODES)``, bench.py's
    workload) for ``SOAK_ROUNDS`` rounds three ways: straight; segmented in
    segments of ``SOAK_SEGMENT`` with the async writer (keep_last 2); and
    the first half segmented, then resumed from disk. All three equal
    bitwise (every leaf and info), launch the same kernels, and peak
    within 5 % of the straight run. Prints rounds/s, checkpoint stall and
    writer seconds, one checkpoint's bytes, and save, verify and load
    seconds."""
    import os
    import tempfile

    import torch

    from corrosion_tpu_torch.checkpoint import load_checkpoint, save_state_checkpoint, verify_checkpoint
    from corrosion_tpu_torch.resilience import resume_segmented, run_segmented
    from corrosion_tpu_torch.resilience.segments import host_copy
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        scale_run_rounds_carry,
        scale_sim_config,
    )

    cfg = scale_sim_config(FLAGSHIP_NODES)
    rounds, seg, half = SOAK_ROUNDS, SOAK_SEGMENT, SOAK_ROUNDS // 2
    with tempfile.TemporaryDirectory(prefix="soak-") as tmp:
        roots = {k: os.path.join(tmp, k) for k in ("segmented", "resumed", "single")}

        # each arm builds its own workload and hands the state into the run
        # (``w.pop(0)``), so no frame here holds the initial carry
        def straight():
            w = list(flagship_workload(cfg, rounds, dev))
            net, key, inputs = w[1:]
            (st, _), infos = scale_run_rounds_carry(cfg, w.pop(0), net, key, inputs)
            return host_copy(st), {k: v.cpu() for k, v in infos.items()}

        def segmented():
            w = list(flagship_workload(cfg, rounds, dev))
            net, key, inputs = w[1:]
            res = run_segmented(cfg, w.pop(0), net, key, inputs, seg,
                                checkpoint_root=roots["segmented"], keep_last=2)
            return (host_copy(res.state), {k: v.cpu() for k, v in res.infos.items()},
                    res.stats, res.checkpoint)

        def resumed():
            w = list(flagship_workload(cfg, rounds, dev))
            net, key, inputs = w[1:]
            first = run_segmented(cfg, w.pop(0), net, key,
                                  ScaleRoundInput(*(a[:half] for a in inputs)), seg,
                                  checkpoint_root=roots["resumed"], keep_last=2)
            infos, stats = first.infos, first.stats
            del first  # a resuming process holds no carry of its own
            rest = resume_segmented(cfg, net, inputs, seg,
                                    checkpoint_root=roots["resumed"], keep_last=2)
            return (host_copy(rest.state),
                    {k: torch.cat([infos[k], rest.infos[k]]).cpu() for k in infos},
                    (stats, rest.stats), rest.completed_rounds)

        (st, infos), s_straight, p_straight, f_straight = _soak_arm(straight)
        (sst, sinfos, sstats, last), s_seg, p_seg, f_seg = _soak_arm(segmented)
        (rst, rinfos, rstats, done), s_res, p_res, f_res = _soak_arm(resumed)
        if done != rounds or sstats["segments"] != rounds // seg or sstats["ckpt_written"] != rounds // seg:
            raise AssertionError(f"soak: resumed to {done}, segmented stats {sstats}")
        _check_soak("soak", {"straight": (st, infos, f_straight, p_straight),
                             "segmented": (sst, sinfos, f_seg, p_seg),
                             "resumed": (rst, rinfos, f_res, p_res)})
        want_forms = {("swim_tables", "aligned/16/16"): rounds, ("ingest", "16/16"): rounds,
                      ("ingest_emit", "16/16"): rounds}
        if f_straight != want_forms:
            raise AssertionError(f"soak launches {f_straight} != {want_forms}")
        ckpt_bytes = _dir_bytes(last)
        kept = sorted(os.listdir(roots["segmented"]))
        if kept != ["LATEST", f"seg-{rounds - seg:08d}", f"seg-{rounds:08d}"]:
            raise AssertionError(f"soak retention kept {kept}")
        # one checkpoint of the straight run's final state, timed alone
        path = os.path.join(roots["single"], "one")
        t0 = time.perf_counter()
        save_state_checkpoint(cfg, st, rounds, path=path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        verify_checkpoint(path)
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, loaded = load_checkpoint(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if _max_abs_err(_flat(st), [t.cpu() for t in _flat(loaded)]):
            raise AssertionError("soak: the loaded checkpoint differs from the state saved")
        del loaded
    state_bytes = _nbytes(_flat(st))
    rates = {k: rounds / s for k, s in (("straight", s_straight), ("segmented", s_seg),
                                         ("resumed", s_res))}
    print(f"[soak] N={cfg.n_nodes} {rounds} rounds, segments of {seg}: straight, "
          f"segmented and resumed bitwise equal in every leaf and info; launches "
          f"{f_straight} in each; rounds/s {rates}; peak device bytes straight "
          f"{p_straight}, segmented {p_seg}, resumed {p_res}; segmented "
          f"ckpt_stall_s {sstats['ckpt_stall_s']!r} vs ckpt_io_s {sstats['ckpt_io_s']!r} "
          f"({sstats['ckpt_written']} written, {sstats['ckpt_overlapped_segments']} "
          f"overlapped); resumed arm stall/io {rstats[0]['ckpt_stall_s']!r}/"
          f"{rstats[0]['ckpt_io_s']!r} then {rstats[1]['ckpt_stall_s']!r}/"
          f"{rstats[1]['ckpt_io_s']!r}; state {state_bytes} bytes, one checkpoint "
          f"{ckpt_bytes} bytes on disk; save {save_s!r} s, verify {verify_s!r} s, "
          f"load {load_s!r} s", flush=True)
    return {"rates": rates, "peaks": (p_straight, p_seg, p_res), "stats": sstats,
            "ckpt_bytes": ckpt_bytes, "save_s": save_s, "verify_s": verify_s,
            "load_s": load_s}


def phase_full_soak(dev) -> None:
    """The full view at ``full_view_config(FULL_TRAJECTORY_NODES)`` for 16
    rounds: the first segment of 8 checkpointed, then resumed from disk,
    equal to the straight ``run_rounds_carry`` bitwise, with the ingest
    kernel launched at m = 96 once a round in both."""
    import os
    import tempfile

    import torch

    from corrosion_tpu_torch.resilience import resume_segmented, run_segmented
    from corrosion_tpu_torch.resilience.segments import host_copy
    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scenario import full_view_workload
    from corrosion_tpu_torch.sim.step import RoundInput, run_rounds_carry

    cfg = full_view_config(FULL_TRAJECTORY_NODES)
    rounds, seg = 16, 8

    def straight():
        w = list(full_view_workload(cfg, rounds, dev))
        net, key, inputs = w[1:]
        (st, _), infos = run_rounds_carry(cfg, w.pop(0), net, key, inputs)
        return host_copy(st), {k: v.cpu() for k, v in infos.items()}

    with tempfile.TemporaryDirectory(prefix="full-soak-") as tmp:
        root = os.path.join(tmp, "soak")

        def resumed():
            w = list(full_view_workload(cfg, rounds, dev))
            net, key, inputs = w[1:]
            first = run_segmented(cfg, w.pop(0), net, key,
                                  RoundInput(*(a[:seg] for a in inputs)), seg,
                                  checkpoint_root=root)
            infos = first.infos
            del first
            rest = resume_segmented(cfg, net, inputs, seg, checkpoint_root=root)
            return (host_copy(rest.state),
                    {k: torch.cat([infos[k], rest.infos[k]]).cpu() for k in infos})

        (st, infos), s_straight, p_straight, f_straight = _soak_arm(straight)
        (rst, rinfos), s_res, p_res, f_res = _soak_arm(resumed)
    _check_soak("full-soak", {"straight": (st, infos, f_straight, p_straight),
                              "resumed": (rst, rinfos, f_res, p_res)})
    want = {("ingest", "32/32"): rounds, ("ingest", f"32/32/m{cfg.recv_slots}"): rounds}
    if f_straight != want:
        raise AssertionError(f"full-soak launches {f_straight} != {want}")
    print(f"[full-soak] N={cfg.n_nodes} {rounds} rounds: segment of {seg} resumed from "
          f"disk == straight, bitwise in every leaf and info; launches {f_res}; "
          f"{s_straight:.2f} s straight, {s_res:.2f} s segmented and resumed; peak "
          f"{p_straight} / {p_res} bytes", flush=True)


# --- the agent ----------------------------------------------------------------

AGENT_SCHEMA = "CREATE TABLE kv (k TEXT PRIMARY KEY, v INTEGER);"


def _agent_config(n: int):
    """The agent's ``Config`` at its defaults with ``n`` nodes."""
    from corrosion_tpu_torch.config import Config

    cfg = Config()
    cfg.sim.n_nodes = n
    return cfg


def _agent_read_nodes(n: int) -> tuple:
    """Nodes agent-trajectory reads: two writers, the node killed and
    revived, an even and an odd node of the partition's halves, the node
    killed for good and the last node."""
    return (0, 1, 100, n // 2, n // 2 + 1, n - 7, n - 1)


def _np_leaves(x) -> list:
    """numpy leaves of nested NamedTuples / tuples, in order."""
    if isinstance(x, tuple):
        return [a for v in x for a in _np_leaves(v)]
    return [x]


def phase_agent_trajectory(dev) -> dict:
    """Two never-started agents at the agent's default config with
    ``AGENT_TRAJECTORY_NODES`` nodes, one on the card and one on the CPU,
    driven by hand through the same SQL writes (a ``Database`` each), kills,
    a revive, a partition and its heal for ``AGENT_TRAJECTORY_ROUNDS``
    rounds: ``device_state()`` bitwise equal after every round, the query
    rows equal at ``_agent_read_nodes`` (writers, a killed and revived node,
    both sides of the partition, the last node), both databases' state
    equal, and each kernel launched once a round on the card."""
    import numpy as np

    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.db import Database
    from corrosion_tpu_torch.ops import megakernel as mk

    n, rounds = AGENT_TRAJECTORY_NODES, AGENT_TRAJECTORY_ROUNDS
    agents = {d: Agent(_agent_config(n), device=d) for d in ("cpu", dev)}
    dbs = {d: Database(a) for d, a in agents.items()}
    for db in dbs.values():
        db.apply_schema_sql(AGENT_SCHEMA)
    t0 = time.perf_counter()
    mk.reset_launches()
    for r in range(rounds):
        for d, agent in agents.items():
            if r % 3 == 0:
                dbs[d].execute(r % agent.n_origins,
                               [("INSERT INTO kv (k, v) VALUES (?, ?)", [f"k{r}", r])],
                               wait=False)
            if r == 4:
                agent.kill_node(100)
                agent.kill_node(n - 7)
            elif r == 8:
                agent.set_partition(np.arange(n) % 2)
            elif r == 12:
                agent.revive_node(100)
            elif r == 16:
                agent.heal_partition()
            agent._one_round()
        a, b = (_np_leaves(agents[d].device_state()) for d in ("cpu", dev))
        bad = [i for i, (x, y) in enumerate(zip(a, b, strict=True))
               if x.dtype != y.dtype or not np.array_equal(x, y)]
        if bad:
            raise AssertionError(f"agent-trajectory round {r}: leaves {bad} differ "
                                 f"cuda vs cpu")
    launches, forms = dict(mk.LAUNCHES), dict(mk.FORM_LAUNCHES)
    want = {"swim_tables": rounds, "ingest": rounds, "ingest_emit": rounds}
    if launches != want:
        raise AssertionError(f"agent-trajectory launches {launches} != {want}")
    sql = "SELECT k, v FROM kv ORDER BY k"
    nodes = _agent_read_nodes(n)
    rows = {d: [[list(x) for x in db.query(v, sql)[1]] for v in nodes]
            for d, db in dbs.items()}
    if rows["cpu"] != rows[dev] or not agents[dev].snapshot()["alive"][100]:
        raise AssertionError(f"agent-trajectory rows {rows} or revive differ")
    if dbs["cpu"].state_dict() != dbs[dev].state_dict():
        raise AssertionError("agent-trajectory: the two databases' state differs")
    held = {v: len(r) for v, r in zip(nodes, rows["cpu"])}
    print(f"[agent-trajectory] N={n} agent defaults: {rounds} rounds of SQL writes, "
          f"kills, revive, partition and heal; device_state() bitwise equal cuda vs "
          f"cpu after every round; query rows equal at nodes {held} (node: rows, of "
          f"{len(range(0, rounds, 3))} written) and the databases' state equal; "
          f"card launches {forms} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"forms": forms}


def _metric_values(text: str, name: str) -> dict:
    """``{labels: value}`` of one metric in Prometheus text."""
    import re

    out = {}
    for line in text.splitlines():
        got = re.match(rf"{name}(\{{[^}}]*\}})? (\S+)$", line)
        if got:
            out[got.group(1) or ""] = float(got.group(2))
    return out


def _compute_apps() -> list:
    """``nvidia-smi --query-compute-apps=pid,used_memory`` rows (empty when
    nvidia-smi does not run)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return []


def _process_memory(pid: int) -> str:
    """The agent process's device memory from the ``nvidia-smi
    --query-compute-apps`` row that carries its pid. In a container the
    rows may carry other pids; then no reading is the agent's."""
    rows = _compute_apps()
    mine = [r.split(",", 1)[1].strip() for r in rows
            if r.split(",")[0].strip() == str(pid)]
    return "; ".join(mine) if mine else (
        f"not attributed (no row carries pid {pid}; rows {rows})")


def _paced_queries(client, round_no, node: int) -> dict:
    """Query latency with the loop running: just after each of
    ``AGENT_QUERIES`` rounds (read from ``/v1/health``) two queries in a
    row. The first pays the copy of the round's snapshot, the second reads
    it from the cache; a pair across a round boundary is dropped and
    counted. Median and max of each, and the loop's rounds/s meanwhile."""
    fresh, cached, dropped = [], [], 0
    r_q, t_q = round_no(), time.perf_counter()
    last = r_q
    while len(fresh) < AGENT_QUERIES:
        if time.perf_counter() - t_q > AGENT_QUERY_S:
            raise AssertionError(f"{len(fresh)} of {AGENT_QUERIES} paced queries "
                                 f"in {AGENT_QUERY_S} s")
        r = round_no()
        if r == last:
            time.sleep(AGENT_QUERY_POLL_S)
            continue
        last = r
        lat = []
        for _ in range(2):
            t0 = time.perf_counter()
            client.query("SELECT v FROM kv WHERE k = ?", ["probe"], node=node)
            lat.append(time.perf_counter() - t0)
        if round_no() != r:
            dropped += 1
            continue
        fresh.append(lat[0])
        cached.append(lat[1])
    rounds, wall = round_no() - r_q, time.perf_counter() - t_q
    fresh.sort()
    cached.sort()
    return {"query_fresh_s": (fresh[len(fresh) // 2], fresh[-1]),
            "query_cached_s": (cached[len(cached) // 2], cached[-1]),
            "query_dropped": dropped, "query_rounds": rounds,
            "query_rounds_per_s": rounds / wall}


def _pg_extended(pg, sql: str, params) -> list:
    """One extended-protocol statement over ``pg``'s connection (the load
    harness's ``_PgClient`` speaks only simple query): Parse, Bind (text
    parameters), Execute, Sync; -> the backend's messages up to
    ReadyForQuery (with no Describe, Execute sends the RowDescription)."""
    import struct

    def msg(kind: bytes, payload: bytes) -> bytes:
        return kind + struct.pack("!I", len(payload) + 4) + payload

    bind = b"\x00\x00" + struct.pack("!HH", 0, len(params))
    for p in params:
        raw = str(p).encode()
        bind += struct.pack("!I", len(raw)) + raw
    bind += struct.pack("!H", 0)
    pg.sock.sendall(msg(b"P", b"\x00" + sql.encode() + b"\x00" + struct.pack("!H", 0))
                    + msg(b"B", bind) + msg(b"E", b"\x00" + struct.pack("!I", 0))
                    + msg(b"S", b""))
    return pg._drain()


def _agent_pg(client, pg_addr, round_no, n: int) -> dict:
    """The agent's PG-wire listener: the row written over HTTP at node 0 read
    over PG wire at the last node (selected by database name), a PG-wire
    INSERT read back over HTTP at node n // 2, one extended-protocol
    statement, and ``AGENT_PG_QUERIES`` timed simple queries."""
    from corrosion_tpu_torch.obs.load import _PgClient

    far = _PgClient(*pg_addr, database=f"node{n - 1}")
    near = _PgClient(*pg_addr)
    try:
        got = far.query("SELECT k, v FROM kv WHERE k = 'probe'")
        if got != [["probe", "4242"]]:
            raise AssertionError(f"PG wire at node {n - 1} read {got}")
        near.query("INSERT INTO kv (k, v) VALUES ('pgw', 77)")
        r_w = round_no()
        while client.query("SELECT k, v FROM kv WHERE k = ?", ["pgw"],
                           node=n // 2)[1] != [["pgw", 77]]:
            if round_no() - r_w > AGENT_VISIBLE_ROUNDS:
                raise AssertionError(f"the PG-wire write was not visible at node "
                                     f"{n // 2} {AGENT_VISIBLE_ROUNDS} rounds after it")
            time.sleep(AGENT_POLL_S)
        pg_visible = round_no() - r_w
        ext = _pg_extended(near, "SELECT v FROM kv WHERE k = $1", ["pgw"])
        kinds = [k for k, _ in ext]
        if (kinds != [b"1", b"2", b"T", b"D", b"C", b"Z"] or ext[3][1][-2:] != b"77"
                or ext[4][1] != b"SELECT 1\x00"):
            raise AssertionError(f"extended protocol answered {ext}")
        lat = []
        for _ in range(AGENT_PG_QUERIES):
            t0 = time.perf_counter()
            far.query("SELECT k, v FROM kv WHERE k = 'probe'")
            lat.append(time.perf_counter() - t0)
    finally:
        far.close()
        near.close()
    lat.sort()
    return {"pg_query_s": (lat[len(lat) // 2], lat[-1]), "pg_visible_rounds": pg_visible,
            "pg_extended": [k.decode() for k in kinds]}


class _StubConsul:
    """A Consul agent's ``/v1/agent/services`` and ``/v1/agent/checks`` on
    loopback (the shape ``tests/test_tpl_consul.py`` stubs)."""

    SERVICES = {"web-1": {"Service": "web", "Port": 80},
                "api-1": {"Service": "api", "Port": 81, "Tags": ["v2"]}}
    CHECKS = {"web-1-check": {"Status": "passing"}}

    def __enter__(self):
        import http.server
        import threading

        bodies = {"/v1/agent/services": self.SERVICES, "/v1/agent/checks": self.CHECKS}

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = json.dumps(bodies.get(self.path, {})).encode()
                self.send_response(200 if self.path in bodies else 404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                       name="corro-smoke-consul")
        self.thread.start()
        return f"127.0.0.1:{self.httpd.server_address[1]}"

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _agent_template_consul(client, api_port: int, tmp: str, root: str) -> dict:
    """``template --once`` over the agent's ``kv`` table (the rendered file
    equals the rows) and ``consul sync --once`` against ``_StubConsul`` (its
    services appear in ``consul_services`` over HTTP), both as processes."""
    import os

    src, dst = os.path.join(tmp, "kv.tpl.py"), os.path.join(tmp, "kv.conf")
    with open(src, "w") as f:
        f.write('for r in sql("SELECT k, v FROM kv ORDER BY k"):\n'
                '    write(f"{r[\'k\']}={r[\'v\']}\\n")\n')
    cli = [sys.executable, "-m", "corrosion_tpu_torch", "--api-port", str(api_port)]
    t0 = time.perf_counter()
    res = subprocess.run(cli + ["template", f"{src}:{dst}", "--once"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    tpl_s = time.perf_counter() - t0
    rows = client.query("SELECT k, v FROM kv ORDER BY k", node=0)[1]
    want = "".join(f"{k}={v}\n" for k, v in rows)
    with open(dst) as f:
        got = f.read()
    if res.returncode != 0 or got != want or not rows:
        raise AssertionError(f"template --once rc {res.returncode}: {got!r} != "
                             f"{want!r} {res.stderr[-1000:]}")
    with _StubConsul() as consul_addr:
        t0 = time.perf_counter()
        res = subprocess.run(cli + ["consul", "sync", "--consul-addr", consul_addr,
                                    "--once"], cwd=root, capture_output=True,
                             text=True, timeout=120)
        consul_s = time.perf_counter() - t0
    ids = client.query("SELECT id FROM consul_services ORDER BY id", node=0)[1]
    checks = client.query("SELECT id FROM consul_checks ORDER BY id", node=0)[1]
    if (res.returncode != 0 or json.loads(res.stdout) != {"services": 2, "checks": 1}
            or ids != [[k] for k in sorted(_StubConsul.SERVICES)]
            or checks != [[k] for k in sorted(_StubConsul.CHECKS)]):
        raise AssertionError(f"consul sync --once rc {res.returncode} {res.stdout!r}: "
                             f"services {ids}, checks {checks} {res.stderr[-1000:]}")
    return {"template_rows": len(rows), "template_s": tpl_s, "consul_s": consul_s,
            "consul_services": [i[0] for i in ids]}


def _agent_process(dev, tmp: str) -> dict:
    """``python -m corrosion_tpu_torch agent`` at ``AGENT_NODES`` nodes
    through its HTTP API, its admin socket and SIGTERM."""
    import os
    import queue
    import re
    import signal
    import threading

    import torch

    from corrosion_tpu_torch.admin import AdminClient
    from corrosion_tpu_torch.client import CorrosionApiClient

    n = AGENT_NODES
    schema, uds = os.path.join(tmp, "schema.sql"), os.path.join(tmp, "admin.sock")
    cfg_path = os.path.join(tmp, "agent.toml")
    with open(schema, "w") as f:
        f.write(AGENT_SCHEMA)
    with open(cfg_path, "w") as f:
        f.write(f'[db]\npath = "{os.path.join(tmp, "state")}"\n'
                f'schema_paths = ["{schema}"]\n[api]\nport = 0\n'
                f'[admin]\nuds_path = "{uds}"\n[pg]\nenabled = true\nport = 0\n'
                f'[sim]\nn_nodes = {n}\n')
    err_path = os.path.join(tmp, "agent.err")
    err = open(err_path, "w")
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "corrosion_tpu_torch", "agent", "-c", cfg_path,
         "--device", str(dev), "--pace", "0"],
        cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put(None)],
        daemon=True)
    reader.start()
    out = {}
    try:
        t_boot = time.perf_counter()
        up = None
        while up is None:
            left = AGENT_BOOT_S - (time.perf_counter() - t_boot)
            line = lines.get(timeout=max(0.1, left))
            if line is None or left <= 0:
                raise AssertionError(f"agent exited or did not come up in {AGENT_BOOT_S} s")
            up = re.match(r"agent up: api http://([\d.]+):(\d+) .*nodes=(\d+) "
                          r"device=(\S+)", line)
        addr, port, nodes, device = up.groups()
        pg_at = re.search(r" pg ([\d.]+):(\d+) ", line)
        if int(nodes) != n or torch.device(device).type != dev.type or not pg_at:
            raise AssertionError(f"agent up line {line.strip()!r}")
        out["boot_s"] = time.perf_counter() - t_boot
        client = CorrosionApiClient(addr, int(port), timeout=120)

        def round_no() -> int:
            return int(client._request_json("GET", "/v1/health")["round"])

        # the first rounds load the kernels: write once the loop runs warm
        while round_no() < 3:
            if time.perf_counter() - t_boot > AGENT_BOOT_S:
                raise AssertionError(f"the agent ran no 3 rounds in {AGENT_BOOT_S} s")
            time.sleep(AGENT_POLL_S)
        # write at node 0, read at the last node until the whole row is there
        t_w = time.perf_counter()
        client.execute([("INSERT INTO kv (k, v) VALUES (?, ?)", ["probe", 4242])], node=0)
        r_w = round_no()
        while client.query("SELECT k, v FROM kv WHERE k = ?", ["probe"],
                           node=n - 1)[1] != [["probe", 4242]]:
            if round_no() - r_w > AGENT_VISIBLE_ROUNDS:
                raise AssertionError(f"the row was not visible at node {n - 1} "
                                     f"{AGENT_VISIBLE_ROUNDS} rounds after its write")
            time.sleep(AGENT_POLL_S)
        out["visible_s"] = time.perf_counter() - t_w
        out["visible_rounds"] = round_no() - r_w
        out.update(_paced_queries(client, round_no, n - 1))
        # the live loop's rate: /v1/health's round over wall time, first
        # with no client traffic, then while queries run back to back
        r0, t0 = round_no(), time.perf_counter()
        time.sleep(AGENT_RATE_S)
        r1, t1 = round_no(), time.perf_counter()
        out["live_rounds_per_s"] = (r1 - r0) / (t1 - t0)
        queries = 0
        while time.perf_counter() - t1 < AGENT_RATE_S:
            client.query("SELECT v FROM kv WHERE k = ?", ["probe"], node=n - 1)
            queries += 1
        r2, t2 = round_no(), time.perf_counter()
        out["loaded_rounds_per_s"] = (r2 - r1) / (t2 - t1)
        out["loaded_queries"] = queries
        health = client._request_json("GET", "/v1/health")
        out["device_bytes"] = (health.get("device_bytes"), health.get("device_peak_bytes"))
        out.update(_agent_pg(client, (pg_at.group(1), int(pg_at.group(2))), round_no, n))
        out.update(_agent_template_consul(client, int(port), tmp, root))

        def wait_rounds(k: int) -> None:
            start = round_no()
            while round_no() < start + k:
                time.sleep(0.05)

        with AdminClient(uds, timeout=300) as admin:
            admin.call("kill", node=5)
            wait_rounds(2)
            if admin.call("cluster_members")[5]["state"] != "Down":
                raise AssertionError("node 5 is not down after the admin kill")
            admin.call("revive", node=5)
            wait_rounds(2)
            if admin.call("cluster_members")[5]["state"] != "Alive":
                raise AssertionError("node 5 is not alive after the admin revive")
            t0 = time.perf_counter()
            ck = admin.call("checkpoint", path=os.path.join(tmp, "ck"))
            out["checkpoint_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ver = subprocess.run(
            [sys.executable, "-m", "corrosion_tpu_torch", "verify-checkpoint", ck],
            cwd=root, capture_output=True, text=True, timeout=300)
        out["verify_s"] = time.perf_counter() - t0
        summary = json.loads(ver.stdout) if ver.returncode == 0 else {}
        if not summary.get("ok") or summary.get("mode") != "scale":
            raise AssertionError(f"verify-checkpoint rc {ver.returncode}: "
                                 f"{ver.stdout[-500:]} {ver.stderr[-500:]}")
        with open(os.path.join(ck, "manifest.json")) as f:
            if not json.load(f)["db"]:
                raise AssertionError("the agent's checkpoint carries no database")
        r_a = round_no()
        text = client.metrics()
        r_b = round_no()
        launches = _metric_values(text, "corro_kernel_launches")
        counts = {re.search(r'kernel="(\w+)"', k).group(1): v for k, v in launches.items()}
        if (set(counts) != {"swim_tables", "ingest", "ingest_emit"}
                or len(set(counts.values())) != 1
                or not r_a <= next(iter(counts.values())) <= r_b + 1):
            raise AssertionError(f"agent launches {launches} at rounds {r_a}..{r_b}")
        out["launches"] = launches
        out["rounds"] = r_b
        out["mem"] = _metric_values(text, "corro_mem_state_bytes")[""]
        out["mem_by_class"] = _metric_values(text, "corro_mem_class_bytes")
        out["process_memory"] = _process_memory(proc.pid)
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=AGENT_STOP_S)
        out["stop_s"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"agent exited {rc} on SIGTERM")
    except BaseException:
        err.flush()
        with open(err_path) as f:
            print(f"[agent] agent stderr tail:\n{f.read()[-3000:]}", flush=True)
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
        err.close()
    return out


def _agent_in_process(dev) -> dict:
    """At the agent's default config with ``AGENT_NODES`` nodes: rounds/s of
    a never-started agent's rounds driven by hand and of
    ``scale_run_rounds`` with quiet inputs, three batches of 8 each in
    turns (sorted), and the median ``snapshot()`` time."""
    import torch

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        ScaleSimState,
        scale_run_rounds_carry,
    )
    from corrosion_tpu_torch.sim.transport import NetModel

    config = _agent_config(AGENT_NODES)
    warm, batch, reps = 2, 8, 3
    agent = Agent(config, device=dev)
    cfg = agent.cfg
    st = ScaleSimState.create(cfg, dev)
    net = NetModel.create(cfg.n_nodes, drop_prob=config.gossip.drop_prob,
                          n_regions=config.gossip.n_regions, device=dev)
    quiet = ScaleRoundInput.quiet(cfg, dev)

    def stack(k):
        return ScaleRoundInput(*(a.expand((k,) + tuple(a.shape)) for a in quiet))

    def agent_rounds(k):
        for _ in range(k):
            agent._one_round()

    def plain_rounds(k):
        nonlocal st, key
        (st, key), _ = scale_run_rounds_carry(cfg, st, net, key, stack(k))
        torch.cuda.synchronize(dev)

    key = prng.key(config.sim.seed)
    agent_rounds(warm)
    plain_rounds(warm)
    # the two loops take turns, batch by batch, on one card
    rates = {"hand": [], "plain": []}
    for _ in range(reps):
        for name, run in (("hand", agent_rounds), ("plain", plain_rounds)):
            t0 = time.perf_counter()
            run(batch)
            rates[name].append(batch / (time.perf_counter() - t0))
    snaps = []
    for _ in range(5):
        agent._snapshot_host = None
        t0 = time.perf_counter()
        agent.snapshot()
        snaps.append(time.perf_counter() - t0)
    hand, plain = (sorted(rates[k]) for k in ("hand", "plain"))
    return {"hand_rounds_per_s": hand, "run_rounds_per_s": plain,
            "snapshot_s": sorted(snaps)[len(snaps) // 2]}


def phase_agent(dev) -> dict:
    """The agent as its users run it: ``python -m corrosion_tpu_torch agent``
    with ``AGENT_NODES`` nodes and the other keys at the ``Config``
    defaults, a schema file and an ephemeral API port. A row written at node
    0 through the HTTP client is polled at the last node until it is there
    (at most ``AGENT_VISIBLE_ROUNDS`` rounds); queries are timed just after
    a round, paying its snapshot copy, and again from the cache; the
    live loop's rounds/s is read from ``/v1/health`` with no client
    traffic and while queries run back to back; the admin socket kills and
    revives a node and writes a checkpoint, which
    ``verify-checkpoint`` must pass; the process's kernel launch gauges
    must show every kernel once a round; SIGTERM must stop it with exit 0.
    Then, in this process at the same config, the hand-driven agent round,
    the snapshot copy and ``scale_run_rounds`` are timed."""
    import tempfile

    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="agent-") as tmp:
        out = _agent_process(dev, tmp)
    out.update(_agent_in_process(dev))
    print(f"[agent] N={AGENT_NODES} agent defaults on {dev}: up in {out['boot_s']:.1f} s; "
          f"live loop {out['live_rounds_per_s']!r} rounds/s (/v1/health round over "
          f"{AGENT_RATE_S} s, --pace 0), {out['loaded_rounds_per_s']!r} while "
          f"{out['loaded_queries']} queries ran back to back; in this process, "
          f"batches of 8 in turns: hand-driven _one_round "
          f"{[repr(x) for x in out['hand_rounds_per_s']]} rounds/s, scale_run_rounds "
          f"{[repr(x) for x in out['run_rounds_per_s']]} at the same config; "
          f"write at node 0 "
          f"visible at node {AGENT_NODES - 1} after {out['visible_rounds']} rounds, "
          f"{out['visible_s']!r} s; query latency with the loop running, the first "
          f"query after each of {AGENT_QUERIES} rounds (a fresh snapshot) median, max "
          f"{out['query_fresh_s']!r} s, the next one in the same round (cached) "
          f"{out['query_cached_s']!r} s ({out['query_dropped']} pairs across a round "
          f"dropped; {out['query_rounds']} rounds meanwhile, "
          f"{out['query_rounds_per_s']!r} rounds/s); snapshot {out['snapshot_s']!r} s; "
          f"admin checkpoint {out['checkpoint_s']!r} s, verify-checkpoint "
          f"{out['verify_s']!r} s; the agent's allocated and peak device bytes "
          f"{out['device_bytes']} (/v1/health); nvidia-smi's row of its pid "
          f"{out['process_memory']}; "
          f"corro.mem.state.bytes {int(out['mem'])} by class {out['mem_by_class']}; "
          f"launch gauges {out['launches']} after {out['rounds']} rounds; SIGTERM "
          f"exit 0 in {out['stop_s']:.1f} s", flush=True)
    print(f"[agent] PG wire (pg.enabled, ephemeral port): the probe row read at node "
          f"{AGENT_NODES - 1} by database name; a PG-wire INSERT at node 0 read over "
          f"HTTP at node {AGENT_NODES // 2} after {out['pg_visible_rounds']} rounds; "
          f"extended protocol (Parse, Bind, Execute, Sync) answered "
          f"{out['pg_extended']}; {AGENT_PG_QUERIES} simple queries at node "
          f"{AGENT_NODES - 1} median, max {out['pg_query_s']!r} s; template --once "
          f"rendered the {out['template_rows']} rows of kv in {out['template_s']:.1f} s "
          f"(process); consul sync --once put {out['consul_services']} into "
          f"consul_services in {out['consul_s']:.1f} s (process)", flush=True)
    return out


def _soak_cli_committed(ck: str) -> list:
    """The soak's committed checkpoints (a manifest is the commit)."""
    import os

    if not os.path.isdir(ck):
        return []
    return sorted(d for d in os.listdir(ck)
                  if os.path.exists(os.path.join(ck, d, "manifest.json")))


def phase_soak_cli(dev) -> dict:
    """``python -m corrosion_tpu_torch soak`` as its users run it: the
    ``Config`` defaults with ``SOAK_CLI_NODES`` nodes, ``SOAK_CLI_ROUNDS``
    rounds in segments of ``SOAK_CLI_SEGMENT``, a flight record, an OTLP
    file and ``--prom-port 0``. ``/metrics`` is scraped once after the first
    commit; the process is SIGKILLed after its second commit; ``--resume``
    runs to the end. Both runs' flight record replays (a torn tail
    allowed), the final checkpoint equals an in-process straight
    ``scale_run_rounds`` of the same config, seed and inputs bitwise, the
    resumed run's metric sums equal that run's info sums over the rounds
    it ran, and each kernel launched once a round in it."""
    import os
    import signal
    import tempfile
    import urllib.request

    import torch

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.checkpoint import load_checkpoint
    from corrosion_tpu_torch.config import load_config
    from corrosion_tpu_torch.obs.flight import info_sums, replay_flight_record
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.resilience.segments import make_soak_inputs
    from corrosion_tpu_torch.sim.scale_step import ScaleSimState, scale_run_rounds
    from corrosion_tpu_torch.sim.transport import NetModel

    rounds, seg = SOAK_CLI_ROUNDS, SOAK_CLI_SEGMENT
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory(prefix="soak-cli-") as tmp:
        cfg_path, otlp = os.path.join(tmp, "soak.toml"), os.path.join(tmp, "otlp.json")
        with open(cfg_path, "w") as f:
            f.write(f'[sim]\nn_nodes = {SOAK_CLI_NODES}\n'
                    f'[telemetry]\notlp_path = "{otlp}"\n')
        ck, flight = os.path.join(tmp, "ck"), os.path.join(tmp, "flight.ndjson")
        argv = [sys.executable, "-m", "corrosion_tpu_torch", "soak", "-c", cfg_path,
                "--device", str(dev), "--rounds", str(rounds), "--segment", str(seg),
                "--checkpoint-dir", ck, "--keep-last", str(rounds // seg),
                "--flight", flight]
        err_path = os.path.join(tmp, "soak.err")
        err = open(err_path, "w")
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv + ["--prom-port", "0"], cwd=root,
                                stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError("the soak exited before its listener came up")
            port = json.loads(line)["prometheus_port"]
            scrape = None
            while True:
                done = _soak_cli_committed(ck)
                if done and scrape is None:
                    text = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=60).read().decode()
                    scrape = (_metric_values(text, "corro_soak_rounds_total"),
                              _metric_values(text, "corro_kernel_launches"))
                if len(done) >= 2:
                    break
                if proc.poll() is not None or time.perf_counter() - t0 > SOAK_CLI_WAIT_S:
                    raise AssertionError(f"the soak committed {done} in "
                                         f"{time.perf_counter() - t0:.1f} s, rc {proc.poll()}")
                time.sleep(0.05)
            out["kill_s"] = time.perf_counter() - t0
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(60)
            killed = replay_flight_record(flight)
            soak_rounds = scrape[0].get("", 0.0)
            launches = {k: v for k, v in scrape[1].items()}
            if (killed["ended"] or killed["segments"] < 2 or soak_rounds < seg
                    or len(launches) != 3 or min(launches.values()) < soak_rounds):
                raise AssertionError(f"soak-cli killed run: replay {killed}, scrape {scrape}")
            t1 = time.perf_counter()
            res = subprocess.run(argv + ["--resume"], cwd=root, capture_output=True,
                                 text=True, timeout=SOAK_CLI_WAIT_S)
            out["resume_s"] = time.perf_counter() - t1
            if res.returncode != 0:
                raise AssertionError(f"soak --resume rc {res.returncode}: {res.stderr[-3000:]}")
            summary = json.loads(res.stdout)
        except BaseException:
            err.flush()
            with open(err_path) as f:
                print(f"[soak-cli] soak stderr tail:\n{f.read()[-3000:]}", flush=True)
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()
        both = replay_flight_record(flight)
        start = both["header"]["start_round"]
        if (both["runs"] != 2 or not both["ended"] or both["crashed"]
                or summary["completed_rounds"] != rounds or start < 2 * seg
                or both["completed_rounds"] != rounds):
            raise AssertionError(f"soak-cli: replay {both}, summary {summary}")
        want_launches = {f"{k}:{form}": rounds - start for k, form in (
            ("swim_tables", "aligned/16/16"), ("ingest", "16/16"), ("ingest_emit", "16/16"))}
        if summary["kernel_launches"] != want_launches:
            raise AssertionError(f"soak-cli resumed launches {summary['kernel_launches']} "
                                 f"!= {want_launches}")
        spans = open(otlp).read()
        if "soak.segment.dispatch" not in spans or "soak.ckpt.serialize" not in spans:
            raise AssertionError("soak-cli: the OTLP file lacks the pipeline spans")
        # in this process: the straight run of the same config, seed, inputs
        config = load_config(cfg_path)
        cfg = config.sim_config()
        net = NetModel.create(cfg.n_nodes, drop_prob=config.gossip.drop_prob,
                              n_regions=config.gossip.n_regions, device=dev)
        inputs = make_soak_inputs(cfg, prng.key(config.sim.seed + 1), rounds,
                                  write_frac=0.25, device=dev)
        mk.reset_launches()
        t2 = time.perf_counter()
        want, infos = scale_run_rounds(cfg, ScaleSimState.create(cfg, dev), net,
                                       prng.key(config.sim.seed), inputs)
        torch.cuda.synchronize()
        out["straight_rounds_per_s"] = rounds / (time.perf_counter() - t2)
        straight_launches = dict(mk.FORM_LAUNCHES)
        _, got = load_checkpoint(summary["checkpoint"], device=dev)
        err_state = _max_abs_err(_flat(want), _flat(got))
        tail = info_sums({k: v[start:] for k, v in infos.items()})
        if err_state or summary["metrics"] != tail:
            raise AssertionError(f"soak-cli: final checkpoint err {err_state}; metrics "
                                 f"{summary['metrics']} vs straight {tail}")
        out.update(killed_segments=killed["segments"], killed_skipped=killed["skipped_lines"],
                   resumed_from=start, scrape_rounds=soak_rounds, scrape_launches=launches,
                   stats=summary["stats"], flight_rounds_per_s=both["rounds_per_s"],
                   straight_launches=straight_launches)
    print(f"[soak-cli] N={SOAK_CLI_NODES} Config defaults, {rounds} rounds in segments "
          f"of {seg} on {dev}: SIGKILL after 2 commits at {out['kill_s']:.1f} s (flight "
          f"record {out['killed_segments']} segments, {out['killed_skipped']} torn lines; "
          f"/metrics mid-run corro_soak_rounds_total {out['scrape_rounds']!r}, launch "
          f"gauges {out['scrape_launches']}); --resume from round {out['resumed_from']} "
          f"ran to {rounds} in {out['resume_s']:.1f} s (stats {out['stats']}); final "
          f"checkpoint bitwise equal to scale_run_rounds in this process "
          f"({out['straight_rounds_per_s']!r} rounds/s, launches "
          f"{out['straight_launches']}); resumed metric sums equal its info sums",
          flush=True)
    return out


def _counting_rounds(tally: dict):
    """Wrap ``scale_step.scale_run_rounds_carry`` to count the rounds it runs
    and the dense ones among them (a quiet round's fixpoint branch launches
    no kernel); -> the function to put back."""
    from corrosion_tpu_torch.sim import scale_step

    real = scale_step.scale_run_rounds_carry

    def counting(cfg, st, net, key, inputs, axis=None):
        # on a mesh every shard runs the loop: its rounds count once per
        # shard, as its launches do
        out = real(cfg, st, net, key, inputs, axis=axis)
        n = int(inputs.kill.shape[0])
        cheap = int(out[1]["quiet_round"].sum()) if "quiet_round" in out[1] else 0
        tally["rounds"] += n
        tally["dense"] += n - cheap
        return out

    scale_step.scale_run_rounds_carry = counting
    return real


def _chaos_run(dev, run) -> tuple:
    """``run()`` with the launch counters reset and the rounds counted;
    -> (its result, seconds, dense rounds, launches per form). Each kernel
    must launch once in every dense round."""
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim import scale_step

    tally = {"rounds": 0, "dense": 0}
    real = _counting_rounds(tally)
    mk.reset_launches()
    t0 = time.perf_counter()
    try:
        got = run()
    finally:
        scale_step.scale_run_rounds_carry = real
    seconds = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    if set(launches.values()) != {tally["dense"]} or not tally["dense"]:
        raise AssertionError(f"chaos launches {launches} over {tally} rounds")
    return got, seconds, tally, dict(mk.FORM_LAUNCHES)


def _chaos_sweep(names) -> tuple:
    """chaos (a), run in a worker process: ``names`` at their N=24, seed 0,
    on the card; -> ``_chaos_run``'s (records, seconds, rounds, launches per
    form)."""
    import torch

    from corrosion_tpu_torch.resilience import chaos

    dev = torch.device("cuda")
    return _chaos_run(dev, lambda: {
        name: chaos.run_scenario(chaos.SCENARIOS[name], seed=0, device=dev)
        for name in names})


def phase_chaos(dev) -> dict:
    """The chaos engine on the card. (a) Every scenario of the registry at
    its N=24, seed 0, in a worker process (``_chaos_sweep``) while (b)-(d)
    run here, against the JAX package's verdicts (``CHAOS_VERDICTS``, read,
    no JAX imported): the digests, rounds to convergence and quiescence,
    info sums, counters and ``ok`` equal field for field (the mesh scenarios
    sharded over the card repeated, 8 shards then 4); the scenario on
    ``fused="off"/"interpret"`` skips with its reason.
    (b) ``preempt-storm`` at ``CHAOS_STORM_NODES`` equals the JAX
    package's verdict there (``CHAOS_STORM_VERDICT``) field for field: it
    converges, its chaos leg matches the straight run bitwise, every
    checkpoint replays, and its queues do not drain within the settle budget
    (oracle 3) in either package. (c) The corpus reproducer replays through
    ``python -m corrosion_tpu_torch chaos --script``, as a process started
    with (a). (d) The host-plane ``serve-overload`` (``_serve_overload``).
    Each kernel launches once in every dense round of (a) and (b) and in
    every round of (d); every form's launches are printed."""
    import concurrent.futures
    import multiprocessing
    import os
    import tempfile

    from corrosion_tpu_torch.resilience import chaos

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, CHAOS_VERDICTS)) as f:
        verdicts = json.load(f)["scenarios"]
    if set(verdicts) != set(chaos.SCENARIOS):
        raise AssertionError(f"verdicts for {sorted(verdicts)}")

    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool, \
            tempfile.TemporaryFile("w+") as out_f, tempfile.TemporaryFile("w+") as err_f:
        sweep_job = pool.submit(_chaos_sweep, sorted(chaos.SCENARIOS))
        t_corpus = time.perf_counter()
        corpus = subprocess.Popen(
            [sys.executable, "-m", "corrosion_tpu_torch", "chaos", "--script",
             CHAOS_CORPUS, "--device", str(dev)], cwd=root, stdout=out_f, stderr=err_f)
        try:
            storm = _chaos_storm(dev, root)
            sovl, sovl_forms = _serve_overload(dev, root)
            corpus.wait(timeout=600)
            corpus_s = time.perf_counter() - t_corpus
            recs, sweep_s, sweep_rounds, sweep_forms = sweep_job.result(timeout=900)
        finally:
            if corpus.poll() is None:
                corpus.kill()
                corpus.wait()
        out_f.seek(0)
        err_f.seek(0)
        out, err = out_f.read(), err_f.read()
    if corpus.returncode != 0:
        raise AssertionError(f"chaos --script {CHAOS_CORPUS} rc {corpus.returncode}: "
                             f"{out[-2000:]} {err[-2000:]}")
    (replay,) = json.loads(out)["scenarios"]
    print(f"[chaos] (c) chaos --script {CHAOS_CORPUS} exit 0 in {corpus_s:.1f} s "
          f"(beside (a), (b), (d)): ok {replay['ok']}, "
          f"{replay['checkpoints_refused']} checkpoint refused, converged at "
          f"{replay['rounds_to_convergence']}", flush=True)

    skipped = {n for n, r in recs.items() if r.get("skipped")}
    if skipped != set(CHAOS_SKIPS):
        raise AssertionError(f"chaos skipped {sorted(skipped)}")
    for name, rec in recs.items():
        want = verdicts[name]
        if name in CHAOS_SKIPS:
            same = all(rec[f] == want[f] for f in (
                "name", "seed", "n_nodes", "trace_digest", "rounds_scripted", "phases"))
            if not (rec["ok"] and CHAOS_SKIPS[name] in rec["skipped"] and same):
                raise AssertionError(f"chaos {name}: skip record {rec}")
        elif rec != want:
            diff = {k: (rec.get(k), want.get(k)) for k in set(rec) | set(want)
                    if rec.get(k) != want.get(k)}
            raise AssertionError(f"chaos {name} differs from JAX's verdict: {diff}")
    ran = sorted(set(recs) - skipped)
    meshes = {n: (s.mesh_devices, [i.mesh_devices for i in s.injections if i.kind == "remesh"])
              for n, s in chaos.SCENARIOS.items() if s.mesh_devices}
    print(f"[chaos] (a) the mesh scenarios' shards all on {dev} (the run's device "
          f"repeated; initial shards, remesh targets): {meshes}", flush=True)
    print(f"[chaos] (a) {len(ran)} scenarios at N=24 on {dev} (a worker process) equal "
          f"JAX's verdicts field for field ({ran}); skipped "
          f"{ {n: recs[n]['skipped'] for n in sorted(skipped)} }; rounds to convergence "
          f"{ {n: recs[n]['rounds_to_convergence'] for n in ran} }, to quiescence "
          f"{ {n: recs[n]['rounds_to_quiescence'] for n in ran} }; {sweep_s:.1f} s, "
          f"{sweep_rounds} rounds, launches {sweep_forms}", flush=True)
    storm_s, storm_forms = storm
    forms = dict(sweep_forms)
    for k, v in storm_forms.items():
        forms[k] = forms.get(k, 0) + v
    return {"forms": forms, "sweep_forms": sweep_forms, "storm_s": storm_s,
            "sweep_s": sweep_s, "corpus_s": corpus_s, "serve_overload": sovl,
            "serve_overload_forms": sovl_forms}


def _chaos_storm(dev, root: str) -> tuple:
    """chaos (b): ``preempt-storm`` at ``CHAOS_STORM_NODES`` against the JAX
    package's verdict; -> (seconds, launches per form)."""
    import dataclasses

    import os

    from corrosion_tpu_torch.resilience import chaos

    with open(os.path.join(root, CHAOS_STORM_VERDICT)) as f:
        ref = json.load(f)
    n = CHAOS_STORM_NODES
    if (ref["n_nodes"], ref["settle_budget"], ref["seed"]) != (n, CHAOS_STORM_SETTLE, 0):
        raise AssertionError(f"{CHAOS_STORM_VERDICT} is for another storm: {ref}")
    ref = ref["verdict"]
    storm = dataclasses.replace(chaos.SCENARIOS["preempt-storm"], n_nodes=n,
                                settle_budget=CHAOS_STORM_SETTLE)
    rec, storm_s, storm_rounds, storm_forms = _chaos_run(
        dev, lambda: chaos.run_scenario(storm, seed=0, device=dev))
    # oracles 1 and 2 and the chaos leg's bitwise match must hold; oracle 3
    # (queues drained within the budget) fails in both packages at this N
    others = [p for p in rec.get("problems", []) if "(oracle 3)" not in p]
    if (others or not (rec["converged"] and rec["bitwise_match"])
            or rec["checkpoints_validated"] == 0 or rec["checkpoints_refused"]):
        raise AssertionError(f"chaos preempt-storm at N={n}: {rec}")
    if rec != ref:
        diff = {k: (rec.get(k), ref.get(k)) for k in set(rec) | set(ref)
                if rec.get(k) != ref.get(k)}
        raise AssertionError(f"chaos preempt-storm at N={n} differs from JAX's "
                             f"verdict: {diff}")
    quiet = (f"quiescent at {rec['rounds_to_quiescence']}" if rec["quiesced"] else
             f"not quiescent within {CHAOS_STORM_SETTLE} settle rounds")
    print(f"[chaos] (b) preempt-storm at N={n} on {dev}, equal to JAX's verdict field "
          f"for field: converged at {rec['rounds_to_convergence']}, {quiet} (JAX: "
          f"quiesced {ref['quiesced']}), chaos leg bitwise {rec['bitwise_match']}; "
          f"{rec['faults_injected']} faults, {rec['resumes']} resumes, "
          f"{rec['checkpoints_validated']} checkpoints validated, "
          f"{rec['checkpoints_refused']} refused; ok {rec['ok']}; info sums "
          f"{rec['info_sums']}; {storm_s:.1f} s, {storm_rounds} rounds, launches "
          f"{storm_forms}", flush=True)
    return storm_s, storm_forms


def _agent_rounds_run(run) -> tuple:
    """``run()`` with the launch counters reset and every agent round it
    drives counted (``Agent._one_round``, with the time each ended); ->
    (its result, seconds, rounds, the rounds/s of the rig's loop from its
    first round to its last, launches per form). Each kernel must launch
    once in every round."""
    from corrosion_tpu_torch.agent import core
    from corrosion_tpu_torch.ops import megakernel as mk

    real = core.Agent._one_round
    ends = []

    def counting(self):
        try:
            return real(self)
        finally:
            ends.append(time.perf_counter())

    core.Agent._one_round = counting
    mk.reset_launches()
    t0 = time.perf_counter()
    try:
        got = run()
    finally:
        core.Agent._one_round = real
    seconds = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    want = {"swim_tables": len(ends), "ingest": len(ends), "ingest_emit": len(ends)}
    if launches != want or len(ends) < 2:
        raise AssertionError(f"agent rig launches {launches} over {len(ends)} rounds")
    rate = (len(ends) - 1) / (ends[-1] - ends[0])
    return got, seconds, len(ends), rate, dict(mk.FORM_LAUNCHES)


def _serve_overload(dev, root: str) -> tuple:
    """chaos (d): the host-plane scenario ``serve-overload`` (N=8, seed 0,
    the defaults' op plan, guard and ready flap) with its slow consumer
    stalling ``SERVE_OVERLOAD_SLOW_MS`` a frame: ``ok`` as the JAX package's
    verdict at its defaults is (``SERVE_OVERLOAD_VERDICT``), so both oracles
    hold (no lost committed write; delivered or shed, never silently
    gapped), equal to that verdict on its seed-pure fields, the ready flap
    applied and the slow subscriber shed. The wall-time fields are printed
    beside JAX's. Each kernel launches once in every round of the rig."""
    import os

    from corrosion_tpu_torch.resilience import serve_overload

    with open(os.path.join(root, SERVE_OVERLOAD_VERDICT)) as f:
        ref = json.load(f)["verdict"]
    rec, seconds, rounds, rate, forms = _agent_rounds_run(
        lambda: serve_overload.run_serve_overload(
            seed=0, slow_ms=SERVE_OVERLOAD_SLOW_MS, device=dev))
    pure = {k: (rec[k], ref[k]) for k in serve_overload.SEED_PURE_FIELDS
            if rec[k] != ref[k]}
    if (pure or not rec["ok"] or rec["ok"] != ref["ok"] or rec["subs_shed_total"] <= 0
            or not rec["ready_flap_applied"]):
        raise AssertionError(f"serve-overload on {dev}: seed-pure fields differing "
                             f"from JAX's {pure}; verdict {rec}")
    wall = {k: rec[k] for k in ("acked_writes", "rejected_writes",
                                "admission_rejected_total", "subs_shed_total",
                                "resyncs", "frames_dropped", "ready_503_observed")}
    print(f"[chaos] (d) serve-overload (N=8, seed 0, a {SERVE_OVERLOAD_SLOW_MS:g} ms slow "
          f"consumer) on {dev}: ok as JAX's, both oracles hold, the slow subscriber "
          f"shed; seed-pure fields equal JAX's "
          f"({ {k: rec[k] for k in serve_overload.SEED_PURE_FIELDS} }); wall-time "
          f"fields {wall} (JAX at its defaults on the CPU: "
          f"{ {k: ref[k] for k in wall} }); {seconds:.1f} s, {rounds} rounds at "
          f"{rate!r} rounds/s, launches {forms}", flush=True)
    return {"ok": rec["ok"], "seconds": seconds, "rounds": rounds,
            "rounds_per_s": rate, "wall": wall}, forms


def phase_load(dev) -> dict:
    """The serving plane under concurrent clients: the load harness in
    this process, ``obs.load.run_load(n_nodes=LOAD_NODES)`` with its default
    clients and ``LOAD_OPS`` ops a client: its record ``ok``, the server's
    request counts equal the
    clients' (the agreement gate), the plan's digest ``LOAD_PLAN_DIGEST``
    (the JAX package's), each kernel once in every round of the rig; prints
    p50/p95/p99 per op class, QPS, delivery lag, the rig's rounds/s and its
    peak device bytes. It runs alone (after the overload bench's process
    has ended): its numbers are the serving plane's measurement."""
    import torch

    from corrosion_tpu_torch.obs.load import run_load

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rec, seconds, rounds, rate, forms = _agent_rounds_run(
        lambda: run_load(n_nodes=LOAD_NODES, write_ops=LOAD_OPS, pg_ops=LOAD_OPS,
                         device=dev))
    peak = torch.cuda.max_memory_allocated(dev)
    agree = rec["agreement"]
    same = all(agree[k]["client"] == agree[k]["server"]
               for k in ("transactions", "pg_select"))
    if not (rec["ok"] and agree["ok"] and same and rec["plan_digest"] == LOAD_PLAN_DIGEST):
        raise AssertionError(f"load at N={LOAD_NODES}: {rec}")
    ops = {k: {q: v[q] for q in ("p50", "p95", "p99", "count")}
           for k, v in rec["ops"].items()}
    print(f"[load] run_load(n_nodes={LOAD_NODES}) on {dev}, 4 writers x {LOAD_OPS}, 2 "
          f"subscribers, 2 PG readers x {LOAD_OPS}, 12 keys, seed 0: ok, plan digest "
          f"{rec['plan_digest']} (JAX's), agreement {agree}; per op class (s) {ops}; "
          f"{rec['qps']!r} ops/s over {rec['duration_s']!r} s; server delivery "
          f"quantiles {rec['server']['delivery_quantiles_s']}; the rig's loop "
          f"{rounds} rounds at {rate!r} rounds/s, each kernel once a round "
          f"({forms}); peak device bytes {peak}; {seconds:.1f} s in all", flush=True)
    return {"forms": forms, "record": rec, "rounds": rounds, "rounds_per_s": rate,
            "peak": peak, "seconds": seconds}


def _start_load(dev, flags, env=None) -> dict:
    """Start ``python -m corrosion_tpu_torch load`` with ``flags`` as a
    process (its phase reads it, and ``_stop_load`` ends it)."""
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="load-")
    job = {"tmp": tmp, "path": os.path.join(tmp, "load.json"),
           "out": open(os.path.join(tmp, "stdout"), "w+"),
           "err": open(os.path.join(tmp, "stderr"), "w+"), "t0": time.perf_counter()}
    job["proc"] = subprocess.Popen(
        [sys.executable, "-m", "corrosion_tpu_torch", "load", *flags,
         "--device", str(dev), "--output-json", job["path"]],
        cwd=root, stdout=job["out"], stderr=job["err"],
        env=None if env is None else {**os.environ, **env})
    return job


def _start_overload(dev) -> dict:
    """The overload bench's process: ``load --overload`` with
    ``LOAD_OVERLOAD_FLAGS`` (``phase_overload`` reads it)."""
    return _start_load(dev, ("--overload", *LOAD_OVERLOAD_FLAGS))


def _start_san_load(dev) -> dict:
    """The sanitized load process: ``CORROSAN=1 load`` with
    ``SAN_LOAD_FLAGS`` (``phase_san_load`` reads it)."""
    return _start_load(dev, SAN_LOAD_FLAGS, env={"CORROSAN": "1"})


def _job_tails(job) -> list:
    tails = []
    for f in (job["out"], job["err"]):
        f.seek(0)
        tails.append(f.read()[-3000:])
    return tails


def _stop_load(job) -> None:
    import shutil

    if job["proc"].poll() is None:
        job["proc"].kill()
        job["proc"].wait()
    job["out"].close()
    job["err"].close()
    shutil.rmtree(job["tmp"], ignore_errors=True)


def phase_overload(dev, job) -> dict:
    """The overload bench, started by ``_start_overload`` before the chaos
    phase and run beside it and devcluster (its arms' outcomes hold with
    wide margins at the flags' time constants): exit 0 (the guarded arm
    holds the degradation contract: p99 delivery lag within its bound, shed
    counters rising, the closed-loop client absorbed; the unguarded arm
    breaks the lag bound), the plan's digest the JAX package's, both arms'
    server and client counts agreeing with nothing leaked, only the guarded
    arm shedding, each kernel launched."""
    import os

    rc = job["proc"].wait(timeout=900)
    ovl_s = time.perf_counter() - job["t0"]
    bench = {}
    if os.path.exists(job["path"]):
        with open(job["path"]) as f:
            bench = json.load(f)
    launched = bench.get("kernel_launches", {})
    guarded, unguarded = bench.get("guarded", {}), bench.get("unguarded", {})
    held = (rc == 0 and bench.get("ok")
            and bench.get("plan_digest") == LOAD_OVERLOAD_PLAN_DIGEST
            and guarded["contract"]["pressure_final"] > 0
            and not unguarded.get("problems") and unguarded["agreement"]["ok"]
            and unguarded["contract"]["pressure_final"] == 0
            and {k.split(":")[0] for k, v in launched.items() if v}
            == {"swim_tables", "ingest", "ingest_emit"})
    if not held:
        tails = _job_tails(job)
        raise AssertionError(f"load --overload rc {rc}: {tails[0]} {tails[1]}")
    arms = {arm: {k: bench[arm]["contract"][k] for k in
                  ("delivery_p99_s", "lag_bounded", "shed_monotone", "pressure_final",
                   "absorbed")} | {"duration_s": bench[arm]["duration_s"],
                                   "http_503": bench[arm]["http_503"],
                                   "closed_loop_attempts_503":
                                       bench[arm]["closed_loop"]["attempts_503"],
                                   "agreement": bench[arm]["agreement"]["ok"]}
            for arm in ("guarded", "unguarded")}
    print(f"[overload] load --overload {' '.join(LOAD_OVERLOAD_FLAGS)} --device {dev} "
          f"(its default ramp, N=16; beside chaos and devcluster): exit 0 in "
          f"{ovl_s:.1f} s, plan digest {bench['plan_digest']} (JAX's); the guard holds "
          f"the degradation contract: {arms['guarded']}; the unguarded arm breaks the "
          f"lag bound: {arms['unguarded']}; launches {launched}", flush=True)
    return {"forms": {tuple(k.split(":", 1)): v for k, v in launched.items()},
            "arms": arms, "seconds": ovl_s}


def _san_config():
    """The sanitized battery's agent: the config of the JAX package's
    ``tests/test_corrosan.py``."""
    from corrosion_tpu_torch.config import Config

    cfg = Config()
    cfg.sim.n_nodes = 16
    cfg.sim.m_slots = 8
    cfg.sim.n_origins = 4
    cfg.sim.n_rows = 8
    cfg.sim.n_cols = 2
    cfg.gossip.drop_prob = 0.0
    return cfg


def _lint_port() -> tuple:
    """corrolint over the port's package with every checker, the sharding
    contract, dtype-flow and densify among them: -> (seconds, checker
    names); prints each checker's seconds; any finding fails the phase."""
    import os

    import corrosion_tpu_torch
    from corrosion_tpu_torch.analysis import ALL_CHECKERS, PROJECT_CHECKERS, lint_report

    checkers = sorted(ALL_CHECKERS) + sorted(PROJECT_CHECKERS)
    missing = {"sharding-contract", "dtype-flow", "densify"} - set(checkers)
    if missing:
        raise AssertionError(f"san: lint runs without {sorted(missing)}: {checkers}")
    seconds: dict = {}
    t0 = time.perf_counter()
    findings, files = lint_report(
        [os.path.dirname(os.path.abspath(corrosion_tpu_torch.__file__))], seconds=seconds)
    if findings:
        raise AssertionError("san: corrolint findings in the port:\n"
                             + "\n".join(f.render() for f in findings))
    total = time.perf_counter() - t0
    print(f"[san] corrolint seconds by checker over {files} files: "
          + ", ".join(f"{k} {seconds[k]!r}" for k in checkers) + f"; whole walk {total!r}",
          flush=True)
    return total, checkers


def phase_san(dev) -> dict:
    """corrolint over the port (every checker, the sharding contract among
    them: no finding), then corrosan on the card, in this process: the
    nine seeded fixtures with ``device`` (each ``ok``: every seeded bug found, every clean twin
    clean), then the sanitized battery of the JAX package's
    ``tests/test_corrosan.py`` on an agent on ``device``: an empty gate,
    the ``SubsManager._mu -> Matcher._mu`` edge witnessed, witnessed edges
    within the static graph and the allowlist, more than 10 threads, and
    each kernel launched inside the window. CUDA and the kernels are built
    and loaded before any window opens (the kernels phase did both)."""
    import json as _json
    import shutil
    import tempfile
    import urllib.request

    from corrosion_tpu_torch.analysis.sanitizer import (
        run_all_fixtures,
        sanitized,
        static_lock_graph,
    )
    from corrosion_tpu_torch.analysis.sanitizer.allowlist import ALLOWED_LOCK_EDGES
    from corrosion_tpu_torch.ops import megakernel as mk

    lint_s, checkers = _lint_port()
    t0 = time.perf_counter()
    fixtures = run_all_fixtures(device=dev)
    bad = [(r.name, r.expect, r.found, r.details) for r in fixtures if not r.ok]
    if bad:
        raise AssertionError(f"san: fixture verdicts wrong on {dev}: {bad}")
    fixtures_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="san-")
    before = dict(mk.LAUNCHES)
    t1 = time.perf_counter()
    try:
        with sanitized() as san:
            from corrosion_tpu_torch.agent import Agent
            from corrosion_tpu_torch.api import ApiServer
            from corrosion_tpu_torch.db import Database
            from corrosion_tpu_torch.pubsub import SubsManager, UpdatesManager
            from corrosion_tpu_torch.resilience import Supervisor

            agent = Agent(_san_config(), device=dev).start(
                supervisor=Supervisor(deadline_seconds=300.0))
            try:
                db = Database(agent)
                db.apply_schema_sql("CREATE TABLE t (pk INTEGER PRIMARY KEY, v INTEGER);")
                mgr = SubsManager(db, persist_dir=f"{tmp}/subs")
                matcher, _ = mgr.subscribe(0, "SELECT pk, v FROM t")
                matcher.attach()
                upd = UpdatesManager(db)
                feed_q = upd.attach("t")
                api = ApiServer(db, subs=mgr, updates=upd).start()
                for i in range(4):
                    db.execute(0, [(f"INSERT INTO t (pk, v) VALUES ({i}, {i * 7})",)])
                if not agent.wait_rounds(3, timeout=300):
                    raise AssertionError("san: the agent ran no 3 rounds in 300 s")
                with urllib.request.urlopen(
                        f"http://{api.addr}:{api.port}/v1/health", timeout=30) as resp:
                    health = _json.load(resp)
                mgr.unsubscribe(matcher.id)
                if not agent.wait_rounds(2, timeout=300):
                    raise AssertionError("san: the agent ran no 2 rounds in 300 s")
                upd.detach("t", feed_q)
                api.stop()
                mgr.close()
            finally:
                agent.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    battery_s = time.perf_counter() - t1
    launched = {k: v - before[k] for k, v in mk.LAUNCHES.items()}
    findings = san.gate()
    named = san.witness.named_edges()
    edge = ("corrosion_tpu_torch.pubsub.SubsManager._mu",
            "corrosion_tpu_torch.pubsub.Matcher._mu")
    extra = named - static_lock_graph().edge_names() - set(ALLOWED_LOCK_EDGES)
    threads = san.leaks.spawned_count()
    if (findings or edge not in named or extra or threads <= 10
            or not all(launched.values()) or health["supervisor"]["state"] == "aborted"):
        raise AssertionError(
            f"san: battery on {dev}: findings {[f.render() for f in findings]}, "
            f"edge witnessed {edge in named}, outside static + allowlist {extra}, "
            f"{threads} threads, launches in the window {launched}, health {health}")
    verdicts = ", ".join(f"{r.name}: {list(r.found) or 'clean'}" for r in fixtures)
    print(f"[san] corrolint over corrosion_tpu_torch/ with {checkers}: no finding, "
          f"{lint_s:.1f} s", flush=True)
    print(f"[san] corrosan on {dev}: {len(fixtures)} fixtures, each its verdict "
          f"({verdicts}) "
          f"in {fixtures_s:.1f} s; the battery (agent N=16 with Supervisor, "
          f"SubsManager, UpdatesManager, HTTP API; 4 inserts, /v1/health, "
          f"unsubscribe, shutdown) in one window: gate empty, {len(named)} named "
          f"lock edges witnessed ({len(san.witness.edges_payload())} in all), "
          f"{' -> '.join(edge)} among them, all within the static graph "
          f"({len(static_lock_graph().edge_names())} edges) and the allowlist; "
          f"{threads} threads spawned; launches inside the window {launched}; "
          f"{battery_s:.1f} s", flush=True)
    return {"fixtures": len(fixtures), "named_edges": len(named), "threads": threads,
            "launches": launched, "seconds": time.perf_counter() - t0}


def phase_san_load(dev, job) -> dict:
    """The sanitized load process started by ``_start_san_load`` beside the
    chaos phase: exit 0, ``corrosan: true``, ``ok``, no findings, and each
    kernel launched in the process."""
    import os

    rc = job["proc"].wait(timeout=600)
    seconds = time.perf_counter() - job["t0"]
    rec = {}
    if os.path.exists(job["path"]):
        with open(job["path"]) as f:
            rec = json.load(f)
    launched = rec.get("kernel_launches", {})
    kernels = {k.split(":")[0] for k, v in launched.items() if v}
    if not (rc == 0 and rec.get("corrosan") is True and rec.get("ok")
            and not rec.get("problems")
            and kernels == {"swim_tables", "ingest", "ingest_emit"}):
        tails = _job_tails(job)
        raise AssertionError(f"CORROSAN=1 load rc {rc}: {rec.get('problems')} "
                             f"{tails[0]} {tails[1]}")
    agree = rec["agreement"]
    print(f"[san] CORROSAN=1 load {' '.join(SAN_LOAD_FLAGS)} --device {dev} (the CLI's "
          f"rig, N=16; beside chaos): exit 0, corrosan true, ok, no findings, "
          f"agreement {agree['transactions']} {agree['pg_select']}; the harness ran "
          f"{rec['duration_s']!r} s at {rec['qps']!r} ops/s, write p50 "
          f"{rec['ops']['write']['p50']!r} s; launches {launched}; read "
          f"{seconds:.1f} s after its start", flush=True)
    return {"forms": {tuple(k.split(":", 1)): v for k, v in launched.items()},
            "seconds": seconds}


DEVCLUSTER_TOPOLOGY = "tests/data/devcluster_topology.txt"
DEVCLUSTER_PLAN = "tests/data/devcluster_jax.json"  # what JAX's devcluster prints


def phase_devcluster(dev) -> dict:
    """``python -m corrosion_tpu_torch devcluster`` on
    ``DEVCLUSTER_TOPOLOGY`` (three components, 30 named nodes, the ``Config``
    defaults otherwise): its printed JSON equals the JAX package's for that
    file (``DEVCLUSTER_PLAN``), a write at a node of one component is read
    at a node of another, its launch gauges show each kernel once a round,
    and SIGTERM stops it with exit 0."""
    import os
    import queue
    import re
    import signal
    import tempfile
    import threading

    from corrosion_tpu_torch.client import CorrosionApiClient

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, DEVCLUSTER_PLAN)) as f:
        want = json.load(f)
    with tempfile.TemporaryDirectory(prefix="devcluster-") as tmp:
        schema = os.path.join(tmp, "schema.sql")
        with open(schema, "w") as f:
            f.write(AGENT_SCHEMA)
        cfg = os.path.join(tmp, "dev.toml")
        with open(cfg, "w") as f:
            f.write(f'[db]\npath = "{os.path.join(tmp, "state")}"\n'
                    f'schema_paths = ["{schema}"]\n[api]\nport = 0\n'
                    f'[admin]\nuds_path = "{os.path.join(tmp, "admin.sock")}"\n')
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "corrosion_tpu_torch", "devcluster",
             DEVCLUSTER_TOPOLOGY, "-c", cfg, "--device", str(dev), "--pace", "0"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        lines: queue.Queue = queue.Queue()
        reader = threading.Thread(
            target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put(None)],
            daemon=True)
        reader.start()
        try:
            printed = []
            while not (printed and printed[-1].startswith("agent up:")):
                line = lines.get(timeout=AGENT_BOOT_S)
                if line is None:
                    raise AssertionError("devcluster exited before it came up")
                printed.append(line)
            boot_s = time.perf_counter() - t0
            plan = json.loads("".join(printed[:-1]))
            up = re.match(r"agent up: api http://([\d.]+):(\d+) .*nodes=(\d+) ",
                          printed[-1])
            if plan != want or not up or int(up.group(3)) != len(want["nodes"]):
                raise AssertionError(f"devcluster printed {printed}")
            client = CorrosionApiClient(up.group(1), int(up.group(2)), timeout=120)
            writer, reader_node = want["nodes"]["solo-first"], want["nodes"]["chain7"]
            client.execute([("INSERT INTO kv (k, v) VALUES (?, ?)", ["dev", 30])],
                           node=writer)
            t_w = time.perf_counter()
            while client.query("SELECT k, v FROM kv", node=reader_node)[1] != [["dev", 30]]:
                if time.perf_counter() - t_w > AGENT_BOOT_S:
                    raise AssertionError("the write never reached the other region")
                time.sleep(AGENT_POLL_S)
            visible_s = time.perf_counter() - t_w
            r_a = int(client._request_json("GET", "/v1/health")["round"])
            launches = _metric_values(client.metrics(), "corro_kernel_launches")
            r_b = int(client._request_json("GET", "/v1/health")["round"])
            counts = {re.search(r'kernel="(\w+)"', k).group(1): v
                      for k, v in launches.items()}
            if (set(counts) != {"swim_tables", "ingest", "ingest_emit"}
                    or len(set(counts.values())) != 1
                    or not r_a <= next(iter(counts.values())) <= r_b + 1):
                raise AssertionError(f"devcluster launches {launches} at rounds {r_a}..{r_b}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=AGENT_STOP_S)
            if rc != 0:
                raise AssertionError(f"devcluster exited {rc} on SIGTERM")
        except BaseException:
            print(f"[devcluster] stderr tail:\n{proc.stderr.read()[-3000:]}"
                  if proc.poll() is not None else "[devcluster] failed", flush=True)
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            reader.join(timeout=10)
    print(f"[devcluster] devcluster {DEVCLUSTER_TOPOLOGY} --device {dev}: "
          f"{len(want['nodes'])} nodes in {len(set(want['regions'].values()))} "
          f"regions, printed JSON equal to JAX's ({DEVCLUSTER_PLAN}); up in "
          f"{boot_s:.1f} s; a write at solo-first (region "
          f"{want['regions']['solo-first']}) read at chain7 (region "
          f"{want['regions']['chain7']}) after {visible_s:.2f} s; launch gauges "
          f"{counts} at rounds {r_a}..{r_b}; SIGTERM exit 0", flush=True)
    return {"boot_s": boot_s, "visible_s": visible_s}


_PTX_TYPES = {"a": "int8", "s": "int16", "i": "int32"}


def _ptxas_functions(log: str) -> dict:
    """ptxas' report (``-Xptxas -v``) per kernel: {mangled name: (stack
    frame, spill stores, spill loads, its register line)}."""
    import re

    out, name, frame = {}, None, None
    for line in log.splitlines():
        got = re.search(r"Function properties for (\S+)", line)
        if got:
            name, frame = got.group(1), None
            continue
        got = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", line)
        if got and name:
            frame = tuple(int(x) for x in got.groups())
            continue
        if "Used" in line and "registers" in line and name and frame:
            out[name] = (*frame, line.split(":", 1)[-1].strip())
            name = None
    return out


def _check_swim_ptxas(log: str) -> None:
    """Print ptxas' report for every swim kernel instantiation (the six
    timer/budget x form pairs, each at 1, 2 and 4 columns a lane, and each
    in the wide form) by name; each must have no stack frame and no
    spills."""
    import re

    seen, bad = set(), []
    for mangled, (frame, st, ld, regs) in sorted(_ptxas_functions(log).items()):
        got = re.search(r"swim_tables_(wide_)?kernelI([asi])([asi])Lb([01])E(?:Li(\d+)E)?",
                        mangled)
        if not got:
            continue
        wide, tt, xt, packed, spl = got.groups()
        form = (_PTX_TYPES[tt], _PTX_TYPES[xt], "packed" if packed == "1" else "aligned")
        name = (f"swim_tables_wide_kernel<{', '.join(form)}>" if wide
                else f"swim_tables_kernel<{', '.join(form)}, SPL={spl}>")
        print(f"[ptxas] {name}: {frame} bytes stack frame, {st} bytes spill stores, "
              f"{ld} bytes spill loads; {regs}", flush=True)
        if frame or st or ld:
            bad.append(name)
        seen.add((form, "wide" if wide else spl))
    want = {((t, x, f), spl) for t, x in (("int16", "int8"), ("int16", "int16"),
                                           ("int32", "int32"))
            for f in ("aligned", "packed") for spl in ("1", "2", "4", "wide")}
    if bad:
        raise AssertionError(f"stack frame or spills in ptxas' report: {bad}")
    if seen != want:
        raise AssertionError(f"swim ptxas report lacks {sorted(want - seen)}")


def _check_ingest_ptxas(log: str) -> None:
    """Print ptxas' report for every ingest kernel instantiation by name
    (three plane-dtype pairs x the emitting, the narrow and the wide batch x
    one, two or four queue slots a lane (four: the deep form, up to 8 seen
    words) x the register book at 2 or 8 cells a lane and the wide book at
    8, and both books with the row in global memory, CH = 0; and the long
    form, KM = 0, with EMIT and in the deep form alone); each must have no
    stack frame and no spills."""
    import re

    seen, bad = set(), []
    for mangled, (frame, st, ld, regs) in sorted(_ptxas_functions(log).items()):
        got = re.search(r"ingest_kernelI([asi])([asi])Lb([01])ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E",
                        mangled)
        if not got:
            continue
        ct, xt, emit, km, qh, ch, wo = got.groups()
        form = (_PTX_TYPES[ct], _PTX_TYPES[xt], "EMIT" if emit == "1" else "no EMIT",
                f"KM={km}", f"QH={qh}", f"CH={ch}", "wide book" if wo == "1" else "book a lane")
        name = f"ingest_kernel<{', '.join(form)}>"
        print(f"[ptxas] {name}: {frame} bytes stack frame, {st} bytes spill stores, "
              f"{ld} bytes spill loads; {regs}", flush=True)
        if frame or st or ld:
            bad.append(name)
        seen.add(form)
    want = {(_PTX_TYPES[ct], _PTX_TYPES[xt], e, f"KM={km}", f"QH={qh}", f"CH={ch}", b)
            for ct, xt in (("s", "a"), ("s", "s"), ("i", "i"))
            for e, km, qhs in (("EMIT", "1", "124"), ("no EMIT", "1", "124"),
                               ("no EMIT", "4", "124"), ("EMIT", "0", "4"))
            for qh in qhs
            for ch, b in (("2", "book a lane"), ("8", "book a lane"), ("8", "wide book"),
                          ("0", "book a lane"), ("0", "wide book"))}
    if bad:
        raise AssertionError(f"stack frame or spills in ptxas' report: {bad}")
    if seen != want:
        raise AssertionError(f"ingest ptxas report lacks {sorted(want - seen)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from corrosion_tpu_torch.ops import cuda_lib
    from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    # the parity phase's CPU half (no kernel) runs while nvcc builds
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        built = pool.submit(cuda_lib.build_all)
        refs = parity_references()
        t_refs = time.perf_counter() - t0
        built.result()
    print(f"[build] {len(cuda_lib.SOURCES)} kernels built in "
          f"{time.perf_counter() - t0:.1f} s (the parity references beside it, "
          f"{t_refs:.1f} s)", flush=True)
    _check_ingest_ptxas(cuda_lib.build_log("ingest"))
    _check_swim_ptxas(cuda_lib.build_log("swim_tables"))

    t_phase = time.perf_counter()

    def done(name):
        nonlocal t_phase
        print(f"[time] {name}: {time.perf_counter() - t_phase:.1f} s", flush=True)
        t_phase = time.perf_counter()

    kern = phase_kernels(dev)
    done("kernels")
    phase_trajectory(dev, "flagship", scale_sim_config)
    phase_trajectory(dev, "1M point's tiers", million_config)
    phase_writers_trajectory(dev)
    phase_tables_trajectory(dev)
    phase_queues_trajectory(dev)
    phase_packets_trajectory(dev)
    phase_members_trajectory(dev)
    done("trajectory")
    flag = phase_flagship(dev)
    done("flagship")
    writers = phase_writers(dev)
    done("writers")
    tables = phase_tables(dev)
    done("tables")
    queues = phase_queues(dev)
    done("queues")
    packets = phase_packets(dev, flag)
    done("packets")
    members = phase_members(dev, flag)
    done("members")
    million = phase_million(dev)
    done("million")
    phase_cost(dev, million.pop("audit"))
    done("cost")
    phase_mesh(dev, million.pop("workload"))
    done("mesh")
    phase_quiet(dev)
    done("quiet")
    phase_full_trajectory(dev)
    done("full-trajectory")
    full = phase_full(dev)
    done("full")
    tx_paths = phase_tx_trajectory(dev)
    done("tx-trajectory")
    phase_full_tx_trajectory(dev)
    done("full-tx-trajectory")
    phase_scale_point(dev, "tx", tx_max_cells=4)
    done("tx")
    phase_scale_point(dev, "wirebudget", bcast_wire_budget=True)
    done("wirebudget")
    phase_full_tx(dev)
    done("full-tx")
    phase_parity(dev, refs)
    done("parity")
    phase_soak(dev)
    done("soak")
    phase_full_soak(dev)
    done("full-soak")
    phase_agent_trajectory(dev)
    done("agent-trajectory")
    phase_agent(dev)
    done("agent")
    bench = _start_overload(dev)
    san_load = None
    try:
        phase_soak_cli(dev)
        done("soak-cli")
        san_load = _start_san_load(dev)
        chaos = phase_chaos(dev)
        done("chaos")
        phase_devcluster(dev)
        done("devcluster")
        phase_san(dev)
        done("san (in process)")
        overload = phase_overload(dev, bench)
        done("overload (the rest of its wait)")
        load = phase_load(dev)
        done("load")
        phase_san_load(dev, san_load)
        done("san (the load process's rest)")
    finally:
        _stop_load(bench)
        if san_load is not None:
            _stop_load(san_load)

    # each form's launches are read from the path that runs it (0: no path
    # here runs the form); the load forms count the load rig's rounds and
    # serve-overload's (N=8, the same widths)
    serve_forms = dict(load["forms"])
    for k, v in chaos["serve_overload_forms"].items():
        serve_forms[k] = serve_forms.get(k, 0) + v
    paths = {"flagship": flag, "writers": writers, "tables": tables, "queues": queues,
             "packets": packets, "members": members,
             "million": million, "full": full, "pig0": tx_paths["pig0"],
             "chaos": chaos, "load": {"forms": serve_forms},
             "overload": overload}
    source = {
        "swim_tables": "corrosion_tpu_torch/csrc/swim_tables.cu",
        "ingest": "corrosion_tpu_torch/csrc/ingest.cu",
        "ingest_emit": "corrosion_tpu_torch/csrc/ingest.cu",
    }
    record = {"kernels": [
        {
            "name": name, "route": "cuda", "source": source[r["kernel"]],
            "replaces": r["replaces"],
            "launches": (paths[r["path"]]["forms"].get(r["launch_key"], 0)
                         if r["path"] else 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        }
        for name, r in kern.items()
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
