"""The ``corrosion-tpu-torch`` command line (port of
``corrosion_tpu/cli.py``).

Mirrors the reference binary's command surface (``Command`` enum,
``crates/corrosion/src/main.rs:649-737``):

- ``agent`` — boot the node runtime (round loop on the card + HTTP API +
  admin UDS + maintenance loop + optional Prometheus), apply schema files,
  run until SIGTERM/SIGINT (``command/agent.rs:19``); ``--device cpu``
  runs the cluster on the CPU;
- ``exec`` / ``query`` — one-shot statements over the HTTP API
  (``main.rs`` Exec/Query);
- ``sync generate`` — sync-state dump via admin (the Antithesis
  convergence probe);
- ``cluster members`` / ``rejoin`` / ``set-id`` — membership ops via admin;
- ``backup`` / ``restore`` / ``checkpoint`` / ``verify-checkpoint`` —
  portable node backup and full checkpoints (``main.rs:160-330``);
- ``locks``, ``compact``, ``reload``, ``assertions``, ``default-config``;
- ``soak`` — a preemption-safe segmented run with a checkpoint after every
  segment, ``--resume``, a flight record (``--flight``) and a live
  ``/metrics`` listener (``--prom-port``);
- ``chaos`` — seeded fault scenarios through the segmented runner, judged
  by three oracles (``--list``, ``--tier1``, names, ``--seed-range``,
  ``--script FILE``), and the host-plane ``serve-overload`` by name;
  ``fuzz`` — generated scenarios, with a shrinker;
- ``template`` — render Python templates over the HTTP API (``--once``, or
  re-render on change); ``consul sync`` — mirror a Consul agent's services
  and checks into tables;
- ``devcluster`` — boot an agent from an ``A -> B`` topology file, one
  region per connected component;
- ``load`` — the seeded concurrent-client load harness over HTTP,
  subscriptions and PG wire (``--overload``: the two-arm overload bench);
- ``lint`` — corrolint over the port (lock discipline, strippable
  asserts, lock order); ``san`` — replay corrosan's seeded race/leak
  fixtures;
- ``mem-report`` — the per-table bytes audit of the configured state
  (``--project N[,M]``: the static projection, built on ``meta``).

``agent``, ``devcluster``, ``soak``, ``chaos``, ``fuzz``, ``load``,
``san`` and ``mem-report`` take ``--device`` (default ``cuda``). Under
``CORROSAN=1``, ``chaos``, ``fuzz`` and ``load`` run inside one corrosan
window and fail on its findings. A sharded soak (``--shard``, ROADMAP
Queue 1 item 14) is not ported yet.

Run as ``python -m corrosion_tpu_torch <command>``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from corrosion_tpu_torch.config import Config, default_toml, load_config


def _client(args):
    from corrosion_tpu_torch.client import CorrosionApiClient

    return CorrosionApiClient(args.api_addr, args.api_port)


def _admin(args):
    from corrosion_tpu_torch.admin import AdminClient

    return AdminClient(args.admin_path)


def _params(raw):
    """CLI params: JSON literals when they parse, raw strings otherwise
    (so ``--param 10.0.0.2`` stays a string but ``--param 80`` is an int)."""
    out = []
    for p in raw:
        try:
            out.append(json.loads(p))
        except json.JSONDecodeError:
            out.append(p)
    return out


def cmd_agent(args, cfg=None, regions=None) -> int:
    from corrosion_tpu_torch.admin import AdminServer
    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.api import ApiServer
    from corrosion_tpu_torch.db import Database

    if cfg is None:
        cfg = load_config(args.config) if args.config else Config()
    # validate listener addresses BEFORE anything starts, so a config typo
    # cannot strand half-booted servers
    prom_hostport = None
    if cfg.telemetry.prometheus_addr:
        host, sep, port = cfg.telemetry.prometheus_addr.rpartition(":")
        if not sep or not port.isdigit():
            raise SystemExit(
                f"telemetry.prometheus_addr must be host:port "
                f"(got {cfg.telemetry.prometheus_addr!r})"
            )
        prom_hostport = (host or "127.0.0.1", int(port))
    agent = Agent(cfg, device=args.device).start(pace_seconds=args.pace)
    if regions is not None:
        agent.set_regions(regions)
    agent.tripwire.hook_signals()
    api = admin = pg = prom = None
    try:
        db = Database(agent)
        from corrosion_tpu_torch.maintenance import MaintenanceLoop

        if cfg.db.checkpoint_rounds > 0:
            # boot-time resume from the newest restorable rotated side;
            # runs BEFORE schema files so edited schemas apply on top of
            # the restored state instead of being reverted by it
            man = MaintenanceLoop.resume_latest(agent, cfg.db.path, db=db)
            if man:
                print(f"resumed from {man['path']} (round {man['round']})",
                      flush=True)
        for path in cfg.db.schema_paths:
            with open(path) as f:
                db.apply_schema_sql(f.read())
        # the maintenance loop always runs (heap compaction, member
        # persistence, gauges); checkpointing itself stays gated on the
        # configured cadence
        MaintenanceLoop(
            agent, db=db,
            checkpoint_path=(cfg.db.path
                             if cfg.db.checkpoint_rounds > 0 else None),
            checkpoint_rounds=max(1, cfg.db.checkpoint_rounds),
        ).start()
        api = ApiServer(db, addr=cfg.api.addr, port=cfg.api.port).start()
        admin = AdminServer(agent, cfg.admin.uds_path, db=db).start()
        if cfg.pg.enabled:
            from corrosion_tpu_torch.pg import PgServer

            pg = PgServer(db, addr=cfg.pg.addr, port=cfg.pg.port).start()
        if prom_hostport:
            from corrosion_tpu_torch.utils.metrics import start_prometheus_listener

            prom = start_prometheus_listener(agent.metrics, *prom_hostport)
        if cfg.telemetry.otlp_path:
            from corrosion_tpu_torch.utils.tracing import configure_otlp_file

            configure_otlp_file(cfg.telemetry.otlp_path)
        extras = (f" pg {pg.addr}:{pg.port}" if pg else "") + (
            f" prometheus {cfg.telemetry.prometheus_addr}" if prom else "")
        print(f"agent up: api http://{api.addr}:{api.port} "
              f"admin {cfg.admin.uds_path}{extras} nodes={agent.n_nodes} "
              f"device={agent.device}", flush=True)
        while not agent.tripwire.tripped:
            agent.tripwire.wait(0.5)
    finally:
        if admin:
            admin.stop()
        if api:
            api.stop()
        if pg:
            pg.stop()
        if prom:
            prom.shutdown()
        agent.shutdown()
        from corrosion_tpu_torch.utils.tracing import flush_otlp

        flush_otlp()
    return 0


def cmd_exec(args) -> int:
    with_params = [(args.sql, _params(args.param))] if args.param else [args.sql]
    results = _client(args).execute(with_params, node=args.node)
    for r in results:
        print(json.dumps(r))
    return 0


def cmd_query(args) -> int:
    client = _client(args)
    stmt = (args.sql, _params(args.param)) if args.param else (args.sql, None)
    if args.follow:
        stream = client.subscribe(stmt[0], stmt[1], node=args.node)
        try:
            for event in stream:
                print(json.dumps(event), flush=True)
        except KeyboardInterrupt:
            stream.close()
        return 0
    cols, rows = client.query(stmt[0], stmt[1], node=args.node)
    if args.columns:
        print("\t".join(cols))
    for row in rows:
        print("\t".join(_fmt_cell(v) for v in row))
    return 0


def _fmt_cell(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, bytes):
        return "x'" + v.hex() + "'"
    return json.dumps(v)


def cmd_sync(args) -> int:
    from corrosion_tpu_torch.utils.tracing import configure_otlp_file, flush_otlp, span

    # export the client-side span too when a config with an OTLP path is
    # at hand — otherwise the agent's serving span would reference a
    # parent no export contains (a rootless trace)
    cfg_path = getattr(args, "config", None)
    if cfg_path:
        cfg = load_config(cfg_path)
        if cfg.telemetry.otlp_path:
            configure_otlp_file(cfg.telemetry.otlp_path, service_name="corrosion-cli")
    try:
        # a client-side span whose context rides the admin call into the
        # agent's serving span (cross-process trace propagation)
        with span("cli.sync_generate"), _admin(args) as admin:
            out = admin.call("sync", **({"node": args.node}
                                        if args.node is not None else {}))
    finally:
        flush_otlp()
    print(json.dumps(out, indent=2))
    return 0


def cmd_cluster(args) -> int:
    with _admin(args) as admin:
        if args.cluster_cmd == "members":
            print(json.dumps(admin.call("cluster_members"), indent=2))
        elif args.cluster_cmd == "rejoin":
            admin.call("cluster_rejoin", node=args.node)
            print("ok")
        elif args.cluster_cmd == "set-id":
            print(json.dumps(admin.call("cluster_set_id",
                                        cluster_id=args.cluster_id)))
    return 0


def cmd_locks(args) -> int:
    with _admin(args) as admin:
        print(json.dumps(admin.call("locks", top=args.top), indent=2))
    return 0


def cmd_compact(args) -> int:
    with _admin(args) as admin:
        print(json.dumps(
            admin.call("compact", grace_seconds=args.grace), indent=2))
    return 0


def cmd_backup(args) -> int:
    with _admin(args) as admin:
        path = admin.call("backup", path=args.path, node=args.node)
    print(path)
    return 0


def cmd_restore(args) -> int:
    with _admin(args) as admin:
        if args.full:
            out = admin.call("restore", path=args.path)
        else:
            out = admin.call(
                "restore_backup", path=args.path,
                **({"node": args.node} if args.node is not None else {}),
            )
    print(json.dumps(out))
    return 0


def cmd_checkpoint(args) -> int:
    with _admin(args) as admin:
        print(admin.call("checkpoint", path=args.path))
    return 0


def cmd_verify_checkpoint(args) -> int:
    """Offline integrity check of a checkpoint directory: manifest,
    format, SHA-256 state-file hashes (every per-shard slice file of a
    sharded v3 checkpoint is hashed independently — one damaged slice
    fails the whole verify), slice-coverage validation, and state
    deserialization against the saved config. Exits non-zero on any
    defect."""
    from corrosion_tpu_torch.checkpoint import verify_checkpoint

    try:
        out = verify_checkpoint(args.path)
    except Exception as e:  # noqa: BLE001 — any defect is a failed verify
        print(json.dumps({"ok": False, "path": args.path,
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    print(json.dumps({"ok": True, **out}, indent=2))
    return 0


def cmd_soak(args) -> int:
    """Preemption-safe soak run: R rounds in K-round segments with a
    crash-consistent checkpoint after each. ``--resume`` continues from
    the newest valid checkpoint under ``--checkpoint-dir`` (losing at most
    one segment); the segmented run is bitwise identical to a straight run
    of the same seed.

    ``--resume`` must be given the same config, ``--rounds`` and
    ``--write-frac`` as the original run: the input stack is rebuilt from
    the seed (sim-config drift is refused; the workload flags are the
    caller's contract)."""
    import dataclasses

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch._device import resolve_device
    from corrosion_tpu_torch.obs.flight import info_sums, make_observer
    from corrosion_tpu_torch.ops.megakernel import FORM_LAUNCHES
    from corrosion_tpu_torch.resilience import (
        Supervisor,
        resume_segmented,
        run_segmented,
    )
    from corrosion_tpu_torch.resilience.segments import make_soak_inputs
    from corrosion_tpu_torch.sim.transport import NetModel
    from corrosion_tpu_torch.utils.tracing import configure_otlp_file, flush_otlp

    if args.shard or args.mesh_hosts:
        raise SystemExit(
            "--shard/--mesh-hosts: a sharded soak is not ported yet "
            "(ROADMAP Queue 1 item 14)")
    if args.fused in ("off", "interpret"):
        raise SystemExit(
            f"--fused {args.fused}: the port has no XLA or interpret path; "
            f"the route follows the config and the tensors' device "
            f"(ROADMAP, rules of the port)")
    dev = resolve_device(args.device)
    cfg_file = load_config(args.config) if args.config else Config()
    # the pipeline spans (segment dispatch, host copy, serialize) land in
    # the OTLP file only with the exporter installed
    if cfg_file.telemetry.otlp_path:
        configure_otlp_file(cfg_file.telemetry.otlp_path)
    cfg = cfg_file.sim_config()
    if args.fused:
        cfg = dataclasses.replace(cfg, fused=args.fused).validate()
    if args.quiet_mode:
        # execution-only: quiet == dense bitwise, and checkpoint identity
        # ignores the key, so --resume composes freely
        cfg = dataclasses.replace(cfg, quiet=args.quiet_mode).validate()
    net = NetModel.create(cfg.n_nodes, drop_prob=cfg_file.gossip.drop_prob,
                          n_regions=cfg_file.gossip.n_regions, device=dev)
    inputs = make_soak_inputs(cfg, prng.key(cfg_file.sim.seed + 1), args.rounds,
                              write_frac=args.write_frac, device=dev)
    supervisor = Supervisor(deadline_seconds=args.deadline or None)
    # the observability flags override the [obs] section; one observer
    # covers the run: flight record, live /metrics, spans
    if args.flight:
        cfg_file.obs.flight_path = args.flight
    if args.prom_port is not None:
        cfg_file.obs.prometheus_port = args.prom_port
    if args.jax_profile:
        cfg_file.obs.jax_profile = True
    obs = make_observer(cfg_file.obs)
    if obs is not None and obs.listener is not None:
        print(json.dumps({"prometheus_port": obs.listener.bound_port}),
              flush=True)
    common = dict(
        checkpoint_root=args.checkpoint_dir, keep_last=args.keep_last,
        supervisor=supervisor, async_checkpoint=not args.sync_checkpoint,
        obs=obs,
    )
    try:
        if args.resume:
            result = resume_segmented(cfg, net, inputs, args.segment, **common)
        else:
            if cfg_file.sim.mode == "scale":
                from corrosion_tpu_torch.sim.scale_step import ScaleSimState

                st = ScaleSimState.create(cfg, dev)
            else:
                from corrosion_tpu_torch.sim.step import SimState

                st = SimState.create(cfg, device=dev)
            result = run_segmented(cfg, st, net, prng.key(cfg_file.sim.seed),
                                   inputs, args.segment, **common)
    finally:
        if obs is not None:
            obs.close()
        flush_otlp()
    summary = {
        "completed_rounds": result.completed_rounds,
        "aborted": result.aborted,
        "checkpoint": result.checkpoint,
        "stats": result.stats,
        "metrics": info_sums(result.infos),
        # this process's kernel launches per form (``kernel:form``)
        "kernel_launches": {f"{k}:{form}": n
                            for (k, form), n in sorted(FORM_LAUNCHES.items())},
    }
    if cfg_file.obs.flight_path:
        summary["flight"] = cfg_file.obs.flight_path
    print(json.dumps(summary, indent=2))
    return 1 if result.aborted else 0


def _corrosan_run(run, device) -> dict:
    """The record ``run()`` returns, with ``corrosan`` saying whether it ran
    inside a sanitized window: under ``CORROSAN=1`` it does, and any
    finding of the window makes ``ok`` false and is listed under
    ``problems``.

    The device is resolved, CUDA initialised and the kernels built and
    loaded before the window opens: the window instruments every lock
    born inside it, and torch's or the build's own are not the port's."""
    if os.environ.get("CORROSAN") != "1":
        out = run()
        out["corrosan"] = False
        return out
    from corrosion_tpu_torch._device import resolve_device
    from corrosion_tpu_torch.analysis.sanitizer import sanitized

    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        from corrosion_tpu_torch.ops import cuda_lib

        torch.cuda.init()
        for name in cuda_lib.SOURCES:
            cuda_lib.library(name)
    with sanitized() as san:
        out = run()
    findings = san.gate()
    out["corrosan"] = True
    if findings:
        out["ok"] = False
        out.setdefault("problems", []).extend(
            f"corrosan: {f.kind} {f.subject}" for f in findings
        )
    return out


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def cmd_chaos(args) -> int:
    """corrochaos: run seeded fault scenarios through the segmented soak
    runner and judge them by the three oracles. A scenario is reproducible
    from ``(name, seed)`` alone: the verdict carries the trace digest that
    pins it. Under ``CORROSAN=1`` the whole run rides inside a sanitized
    window."""
    from corrosion_tpu_torch.resilience.chaos import (
        SCENARIOS,
        TIER1_SCENARIOS,
        _host_scenarios,
        run_sweep,
    )

    if args.list:
        for name, script in sorted(SCENARIOS.items()):
            tier = " [tier1]" if name in TIER1_SCENARIOS else ""
            print(f"{name}{tier}: {len(script.phases)} phases, "
                  f"{script.total_rounds} rounds, "
                  f"{len(script.injections)} injection(s)")
        for name in sorted(_host_scenarios()):
            print(f"{name} [host-plane]: serving-plane scenario, "
                  f"run by name (not part of the default sweep)")
        return 0
    if args.script:
        return _chaos_replay_scripts(args)
    if args.scenario:
        names = list(args.scenario)
    elif args.tier1:
        names = list(TIER1_SCENARIOS)
    else:
        names = sorted(SCENARIOS)
    seed_range = None
    if args.seed_range:
        try:
            lo, _, hi = args.seed_range.partition(":")
            seed_range = (int(lo), int(hi))
        except ValueError:
            print(f"error: --seed-range wants A:B, got {args.seed_range!r}",
                  file=sys.stderr)
            return 2
    out = _corrosan_run(
        lambda: run_sweep(names, seed=args.seed, seed_range=seed_range,
                          device=args.device),
        args.device)
    if args.output_json:
        _write_json(args.output_json, out)
    if args.convergence_json:
        # rounds to convergence, one entry per scenario that ran
        conv = [
            {
                "scenario": r["name"],
                "seed": r["seed"],
                "n": r["n_nodes"],
                "faults": True,
                "rounds_to_convergence": r.get("rounds_to_convergence", -1),
                "converged": bool(r.get("converged")),
                "platform": out["platform"],
            }
            for r in out["scenarios"]
            if not r.get("skipped") and not r.get("host_plane")
        ]
        _write_json(args.convergence_json, conv)
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


def _chaos_replay_scripts(args) -> int:
    """``chaos --script FILE [...]``: replay serialized scenario scripts,
    corpus reproducers (the envelope ``fuzz.save_reproducer`` writes,
    which pins its own seed) or bare ``script_to_json`` documents (run at
    ``--seed``); a replay derives the trace digest the original run
    recorded."""
    from corrosion_tpu_torch.resilience.chaos import (
        platform_name,
        run_scenario,
        script_from_json,
    )
    from corrosion_tpu_torch.resilience.fuzz import load_reproducer

    def replay() -> dict:
        records = []
        for path in args.script:
            with open(path) as f:
                payload = json.load(f)
            if isinstance(payload, dict) and "script" in payload:
                script, seed, _meta = load_reproducer(path)
            else:
                script, seed = script_from_json(payload), args.seed
            records.append(run_scenario(script, seed=seed, device=args.device))
        return {
            "metric": "chaos_sweep",
            "seed": int(args.seed),
            "platform": platform_name(args.device),
            "scripts": list(args.script),
            "scenarios": records,
            "ok": all(r["ok"] for r in records),
        }

    out = _corrosan_run(replay, args.device)
    if args.output_json:
        _write_json(args.output_json, out)
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


def cmd_fuzz(args) -> int:
    """corrofuzz: sweep a fixed-seed budget of generated chaos scenarios
    and print the per-seed verdicts with rounds to convergence and
    quiescence. Deterministic end to end. ``--shrink-failures DIR``
    delta-debugs every failing seed to a 1-minimal reproducer in DIR for
    ``chaos --script`` replay. Under ``CORROSAN=1`` the sweep rides a
    sanitized window like the chaos run (the shrinker runs after it)."""
    from corrosion_tpu_torch.resilience import fuzz

    try:
        lo, _, hi = args.seeds.partition(":")
        seeds = list(range(int(lo), int(hi) + 1))
    except ValueError:
        print(f"error: --seeds wants A:B, got {args.seeds!r}", file=sys.stderr)
        return 2
    if args.list:
        for seed in seeds:
            script = fuzz.gen_script(seed, profile=args.profile)
            print(f"{script.name}: N={script.n_nodes}, "
                  f"{len(script.phases)} phases, "
                  f"{script.total_rounds} rounds, injections="
                  f"{[i.kind for i in script.injections] or '[]'}")
        return 0
    out = _corrosan_run(
        lambda: fuzz.run_fuzz(seeds, profile=args.profile, device=args.device),
        args.device)
    if args.shrink_failures is not None:
        shrunk = []
        for case in out["cases"]:
            if case["ok"] or case.get("skipped"):
                continue
            script = fuzz.gen_script(case["seed"], profile=args.profile)
            minimal, runs = fuzz.shrink(script, case["seed"], device=args.device)
            shrunk.append(fuzz.save_reproducer(
                minimal, case["seed"],
                note=f"shrunk from {script.name} in {runs} oracle runs; "
                     f"problems: {case.get('problems')}",
                path=os.path.join(args.shrink_failures, f"{minimal.name}.json"),
            ))
        out["reproducers"] = shrunk
    if args.output_json:
        _write_json(args.output_json, out)
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


def cmd_load(args) -> int:
    """corroload: the seeded concurrent-client load harness. Drives an
    in-process rig's HTTP API, NDJSON subscriptions and PG-wire server with
    N writers + M subscribers + K readers whose op streams are a pure
    function of ``--seed``, and prints the ``BENCH_SERVE`` record:
    client-side p50/p95/p99 per op class, delivery lag, and the
    server-vs-client request-count agreement gate. ``--overload`` runs the
    two-arm overload bench instead (exit 0 when the guard holds the
    degradation contract and the unguarded arm violates it). Under
    ``CORROSAN=1`` the whole run rides inside a sanitized window."""
    from corrosion_tpu_torch.obs.load import run_load, run_overload_bench
    from corrosion_tpu_torch.ops.megakernel import FORM_LAUNCHES

    if args.overload:
        # the harness's own defaults govern everything but these flags
        def run():
            return run_overload_bench(
                stages=tuple(int(x) for x in args.stages.split(",")),
                slow_subs=args.slow_subs, slow_ms=args.slow_ms,
                lag_bound_s=args.lag_bound,
                closed_loop_retries=args.closed_retries,
                seed=args.seed, device=args.device,
            )
    else:
        def run():
            return run_load(
                writers=args.writers, subscribers=args.subscribers,
                pg_readers=args.pg_readers, write_ops=args.write_ops,
                pg_ops=args.pg_ops, keys=args.keys, seed=args.seed,
                device=args.device,
            )
    out = _corrosan_run(run, args.device)
    # this process's kernel launches per form (``kernel:form``)
    out["kernel_launches"] = {f"{k}:{form}": n
                              for (k, form), n in sorted(FORM_LAUNCHES.items())}
    if args.output_json:
        _write_json(args.output_json, out)
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


def cmd_lint(args) -> int:
    """corrolint over the given paths (same engine as
    ``python -m corrosion_tpu_torch.analysis`` and the tier-1 gate)."""
    from corrosion_tpu_torch.analysis.__main__ import main as lint_main

    argv = list(args.paths or [])
    if args.format != "text":
        argv = ["--format", args.format] + argv
    if args.changed is not None:
        argv = ["--changed", args.changed] + argv
    if args.output_json is not None:
        argv = ["--output-json", args.output_json] + argv
    return lint_main(argv)


def cmd_san(args) -> int:
    """corrosan fixture replay (same engine as
    ``python -m corrosion_tpu_torch.analysis.sanitizer``): seeded
    race/leak/inversion scenarios the runtime sanitizer must detect."""
    from corrosion_tpu_torch.analysis.sanitizer.__main__ import main as san_main

    argv = list(args.fixtures or []) + ["--device", args.device]
    if args.list_fixtures:
        argv = ["--list-fixtures"] + argv
    if args.format != "text":
        argv = ["--format", args.format] + argv
    if args.output_json is not None:
        argv = ["--output-json", args.output_json] + argv
    return san_main(argv)


def cmd_template(args) -> int:
    from corrosion_tpu_torch.tpl import render_template_cli

    return render_template_cli(args)


def cmd_consul(args) -> int:
    from corrosion_tpu_torch.consul import consul_sync_cli

    return consul_sync_cli(args)


def parse_topology(text: str):
    """``A -> B`` edge-list topology (corro-devcluster's format,
    ``corro-devcluster/src/topology/mod.rs``): returns (names in
    first-appearance order, edges as index pairs, group id per node from
    connected components)."""
    names: list = []
    index: dict = {}
    edges = []

    def nid(name: str) -> int:
        if name not in index:
            index[name] = len(names)
            names.append(name)
        return index[name]

    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if "->" in line:
            a, b = (s.strip() for s in line.split("->", 1))
            edges.append((nid(a), nid(b)))
        else:
            nid(line)
    # connected components -> region groups
    parent = list(range(len(names)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        parent[find(a)] = find(b)
    roots = {}
    groups = []
    for i in range(len(names)):
        r = find(i)
        groups.append(roots.setdefault(r, len(roots)))
    return names, edges, groups


def cmd_devcluster(args) -> int:
    """Boot an N-node cluster from a topology file (corro-devcluster
    analog): node names map to simulator indices, topology components map
    to regions, and the agent serves the whole cluster."""
    with open(args.topology) as f:
        names, edges, groups = parse_topology(f.read())
    if not names:
        raise SystemExit(f"no nodes in topology file {args.topology}")
    cfg = load_config(args.config) if args.config else Config()
    cfg.sim.n_nodes = len(names)
    cfg.sim.n_origins = min(cfg.sim.n_origins, len(names))
    cfg.gossip.n_regions = max(groups) + 1 if groups else 1
    print(json.dumps({
        "nodes": {name: i for i, name in enumerate(names)},
        "edges": [[names[a], names[b]] for a, b in edges],
        "regions": {name: g for name, g in zip(names, groups)},
    }, indent=2), flush=True)
    # the per-node component assignment goes into the RTT-ring model (the
    # region count alone would deal nodes out round-robin)
    return cmd_agent(args, cfg=cfg, regions=groups)


def cmd_reload(args) -> int:
    with _admin(args) as admin:
        out = admin.call("reload", config=args.config)
    print(json.dumps(out))
    return 0


def cmd_assertions(args) -> int:
    with _admin(args) as admin:
        print(json.dumps(admin.call("assertions"), indent=2))
    return 0


def _project_point(text: str) -> str:
    """argparse type for ``--project N[,M]``: a typo is a usage error, not
    a traceback; the string passes through to ``mem_report_cli``."""
    try:
        parts = [int(p) for p in text.split(",")]
    except ValueError:
        parts = []
    if len(parts) not in (1, 2) or any(p <= 0 for p in parts):
        raise argparse.ArgumentTypeError(
            f"expected N or N,M (positive integers), got {text!r}")
    return text


def cmd_mem_report(args) -> int:
    """Per-table bytes audit of the configured state (which table is O(N·M)
    and which O(N)); with ``--project N[,M]`` the static projection."""
    from corrosion_tpu_torch.obs.memory import mem_report_cli

    return mem_report_cli(args)


def cmd_default_config(args) -> int:
    print(default_toml())
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="corrosion-tpu-torch",
        description="gossip/CRDT cluster simulator on one CUDA card",
    )
    p.add_argument("--api-addr", default="127.0.0.1")
    p.add_argument("--api-port", type=int, default=8787)
    p.add_argument("--admin-path", default="./admin.sock")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("agent", help="run the agent")
    a.add_argument("-c", "--config", default=None)
    a.add_argument("--pace", type=float, default=0.05,
                   help="seconds per round (0 = flat out)")
    a.add_argument("--device", default="cuda",
                   help="torch device of the cluster state (default cuda; "
                        "'cpu' runs the kernels' plain versions)")
    a.set_defaults(fn=cmd_agent)

    e = sub.add_parser("exec", help="execute write statements")
    e.add_argument("sql")
    e.add_argument("--param", action="append", default=[])
    e.add_argument("--node", type=int, default=0)
    e.set_defaults(fn=cmd_exec)

    q = sub.add_parser("query", help="run a read-only query")
    q.add_argument("sql")
    q.add_argument("--param", action="append", default=[])
    q.add_argument("--node", type=int, default=0)
    q.add_argument("--columns", action="store_true")
    q.add_argument("--follow", action="store_true",
                   help="subscribe and stream changes")
    q.set_defaults(fn=cmd_query)

    s = sub.add_parser("sync", help="sync state introspection")
    ssub = s.add_subparsers(dest="sync_cmd", required=True)
    sg = ssub.add_parser("generate")
    sg.add_argument("--node", type=int, default=None)
    sg.set_defaults(fn=cmd_sync)

    c = sub.add_parser("cluster", help="cluster membership ops")
    csub = c.add_subparsers(dest="cluster_cmd", required=True)
    csub.add_parser("members").set_defaults(fn=cmd_cluster)
    cr = csub.add_parser("rejoin")
    cr.add_argument("--node", type=int, required=True)
    cr.set_defaults(fn=cmd_cluster)
    ci = csub.add_parser("set-id")
    ci.add_argument("cluster_id", type=int)
    ci.set_defaults(fn=cmd_cluster)

    lk = sub.add_parser("locks", help="lock registry dump")
    lk.add_argument("--top", type=int, default=10)
    lk.set_defaults(fn=cmd_locks)

    cp = sub.add_parser("compact",
                        help="compact the value heap (vacuum analog)")
    cp.add_argument("--grace", type=float, default=300.0,
                    help="seconds of touch-recency that pin an id")
    cp.set_defaults(fn=cmd_compact)

    b = sub.add_parser("backup", help="portable single-node backup")
    b.add_argument("path")
    b.add_argument("--node", type=int, default=0)
    b.set_defaults(fn=cmd_backup)

    r = sub.add_parser("restore", help="restore a backup or checkpoint")
    r.add_argument("path")
    r.add_argument("--node", type=int, default=None)
    r.add_argument("--full", action="store_true",
                   help="path is a full checkpoint directory")
    r.set_defaults(fn=cmd_restore)

    ck = sub.add_parser("checkpoint", help="write a full cluster checkpoint")
    ck.add_argument("path")
    ck.set_defaults(fn=cmd_checkpoint)

    vc = sub.add_parser("verify-checkpoint",
                        help="verify a checkpoint directory's integrity")
    vc.add_argument("path")
    vc.set_defaults(fn=cmd_verify_checkpoint)

    sk = sub.add_parser("soak",
                        help="segmented soak run with per-segment "
                             "checkpoints (preemption-safe)")
    sk.add_argument("-c", "--config", default=None)
    sk.add_argument("--rounds", type=int, default=1024)
    sk.add_argument("--segment", type=int, default=128,
                    help="rounds per segment (checkpoint cadence)")
    sk.add_argument("--checkpoint-dir", default="./soak_checkpoints")
    sk.add_argument("--keep-last", type=int, default=3)
    sk.add_argument("--write-frac", type=float, default=0.25,
                    help="fraction of nodes writing per round")
    sk.add_argument("--deadline", type=float, default=0.0,
                    help="per-segment dispatch deadline in seconds "
                         "(0 = none)")
    sk.add_argument("--resume", action="store_true",
                    help="continue from the newest valid checkpoint")
    sk.add_argument("--no-donate", action="store_true",
                    help="accepted for the JAX package's command line; the "
                         "port's round is functional and never donates its "
                         "carry (stats donated_segments stays 0)")
    sk.add_argument("--sync-checkpoint", action="store_true",
                    help="write checkpoints synchronously on the hot "
                         "loop instead of the overlapped background "
                         "writer")
    sk.add_argument("--shard", type=int, default=0,
                    help="a sharded soak: not ported yet (ROADMAP Queue 1 "
                         "item 14); any value but 0 exits")
    sk.add_argument("--mesh-hosts", type=int, default=0,
                    help="with --shard: not ported yet (item 14)")
    from corrosion_tpu_torch.sim.config import FUSED_MODES, QUIET_MODES

    sk.add_argument("--fused", choices=list(FUSED_MODES), default=None,
                    help="execution-mode override of the [perf] fused key; "
                         "the port runs 'auto' and 'on' (its kernels) and "
                         "refuses 'off' and 'interpret'")
    sk.add_argument("--quiet-mode", choices=list(QUIET_MODES),
                    dest="quiet_mode", default=None,
                    help="quiet active-set round override (default: the "
                         "[perf] quiet key); 'on' runs the quiet round, "
                         "'auto' lets the runner pick it for all-quiet "
                         "segments; results are bitwise identical")
    sk.add_argument("--flight", default=None, metavar="PATH",
                    help="flight-recorder NDJSON path (overrides [obs] "
                         "flight_path): crash-safe per-segment records a "
                         "dead soak leaves behind")
    sk.add_argument("--prom-port", type=int, default=None,
                    help="serve live /metrics for this soak on this port "
                         "(0 = ephemeral; overrides [obs] prometheus_port)")
    sk.add_argument("--jax-profile", action="store_true",
                    help="label the pipeline spans in torch.profiler traces "
                         "(overrides [obs] jax_profile; the name is the "
                         "JAX package's)")
    sk.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    sk.set_defaults(fn=cmd_soak)

    ch = sub.add_parser(
        "chaos",
        help="corrochaos: run deterministic seeded fault scenarios "
             "through the segmented soak runner, judged by three oracles")
    ch.add_argument("scenario", nargs="*", default=None,
                    help="scenario name(s) to run (default: the whole "
                         "registry; see --list)")
    ch.add_argument("--seed", type=int, default=0,
                    help="scenario seed: (name, seed) determines the trace "
                         "and the verdict")
    ch.add_argument("--seed-range", metavar="A:B", default=None,
                    help="run every scenario at seeds A..B (inclusive); the "
                         "record gains a per_seed map of rounds to "
                         "convergence")
    ch.add_argument("--tier1", action="store_true",
                    help="run only the tier-1 subset")
    ch.add_argument("--list", action="store_true",
                    help="list the scenarios and exit")
    ch.add_argument("--output-json", metavar="PATH", default=None,
                    help="write the sweep record")
    ch.add_argument("--convergence-json", metavar="PATH", default=None,
                    help="also write rounds to convergence per scenario")
    ch.add_argument("--script", metavar="FILE", action="append",
                    default=None,
                    help="replay serialized scenario script(s): corpus "
                         "reproducers (tests/chaos_corpus/*.json, which pin "
                         "their own seed) or bare script JSON (run at "
                         "--seed); repeatable")
    ch.add_argument("--device", default="cuda",
                    help="torch device of the scenarios (default cuda)")
    ch.set_defaults(fn=cmd_chaos)

    fz = sub.add_parser(
        "fuzz",
        help="corrofuzz: sweep a fixed-seed budget of generated chaos "
             "scenarios and optionally shrink failures to reproducers")
    fz.add_argument("--seeds", metavar="A:B", default="0:24",
                    help="inclusive fuzz-seed range; each seed generates "
                         "and judges one scenario (default 0:24)")
    fz.add_argument("--profile", choices=("fast", "scale"), default="fast",
                    help="N ladder: fast = the small rungs only; scale = "
                         "up to 4096 nodes")
    fz.add_argument("--list", action="store_true",
                    help="print the generated scripts without running them")
    fz.add_argument("--shrink-failures", metavar="DIR", default=None,
                    help="delta-debug every failing seed to a 1-minimal "
                         "reproducer JSON in DIR (replay with "
                         "'chaos --script')")
    fz.add_argument("--output-json", metavar="PATH", default=None,
                    help="write the fuzz record")
    fz.add_argument("--device", default="cuda",
                    help="torch device of the scenarios (default cuda)")
    fz.set_defaults(fn=cmd_fuzz)

    t = sub.add_parser("template", help="render templates (re-render on change)")
    t.add_argument("spec", nargs="+", help="template.py:output pairs")
    t.add_argument("--once", action="store_true")
    t.add_argument("--node", type=int, default=0)
    t.set_defaults(fn=cmd_template)

    co = sub.add_parser("consul", help="consul bridge")
    cosub = co.add_subparsers(dest="consul_cmd", required=True)
    cs = cosub.add_parser("sync")
    cs.add_argument("--consul-addr", default="127.0.0.1:8500")
    cs.add_argument("--once", action="store_true")
    cs.add_argument("--node", type=int, default=0)
    cs.set_defaults(fn=cmd_consul)

    dc = sub.add_parser("devcluster",
                        help="boot a cluster from an `A -> B` topology file")
    dc.add_argument("topology")
    dc.add_argument("-c", "--config", default=None)
    dc.add_argument("--pace", type=float, default=0.05)
    dc.add_argument("--device", default="cuda",
                    help="torch device of the cluster state (default cuda)")
    dc.set_defaults(fn=cmd_devcluster)

    ld = sub.add_parser(
        "load",
        help="corroload: seeded concurrent-client load harness over the "
             "serving plane (HTTP + subscriptions + PG wire): prints the "
             "BENCH_SERVE record with client p50/p95/p99 and the "
             "server-vs-client agreement gate")
    ld.add_argument("--writers", type=int, default=4,
                    help="open-loop HTTP transaction writers")
    ld.add_argument("--subscribers", type=int, default=2,
                    help="NDJSON subscription streams measuring "
                         "write-commit -> delivery lag")
    ld.add_argument("--pg-readers", type=int, default=2,
                    help="PG-wire simple-query readers")
    ld.add_argument("--write-ops", type=int, default=32,
                    help="transactions per writer")
    ld.add_argument("--pg-ops", type=int, default=32,
                    help="queries per reader")
    ld.add_argument("--keys", type=int, default=12,
                    help="keyspace size (rows in load_kv)")
    ld.add_argument("--seed", type=int, default=0,
                    help="op-plan seed; the record carries the plan digest "
                         "it determines")
    ld.add_argument("--overload", action="store_true",
                    help="run the overload bench instead: a guarded arm "
                         "(admission control + bounded queues) and an "
                         "unguarded arm, gated on the degradation contract")
    ld.add_argument("--stages", default="2,4,8",
                    help="[overload] comma-separated open-loop writer "
                         "counts per ramp stage")
    ld.add_argument("--slow-subs", type=int, default=2,
                    help="[overload] deliberately slow subscribers")
    ld.add_argument("--slow-ms", type=float, default=25.0,
                    help="[overload] per-event stall of a slow subscriber, "
                         "milliseconds")
    ld.add_argument("--lag-bound", type=float, default=2.5,
                    help="[overload] p99 delivery-lag bound (seconds) the "
                         "guarded arm must hold")
    ld.add_argument("--closed-retries", type=int, default=16,
                    help="[overload] 503 retries of the closed-loop client "
                         "(0.25 s apart at most) before an op fails")
    ld.add_argument("--output-json", metavar="PATH", default=None,
                    help="write the BENCH_SERVE record")
    ld.add_argument("--device", default="cuda",
                    help="torch device of the rig's agent (default cuda)")
    ld.set_defaults(fn=cmd_load)

    lint = sub.add_parser(
        "lint", help="corrolint static analysis: lock discipline, "
                     "strippable asserts and the interprocedural lock "
                     "order")
    lint.add_argument("paths", nargs="*", default=None,
                      help="files/dirs (default: corrosion_tpu_torch)")
    lint.add_argument("--format", choices=("text", "json"), default="text")
    lint.add_argument("--changed", metavar="GIT_REF", default=None,
                      help="lint only .py files changed vs the git ref "
                           "(fast pre-commit mode)")
    lint.add_argument("--output-json", metavar="PATH", default=None,
                      help="write a machine-readable findings report")
    lint.set_defaults(fn=cmd_lint)

    san = sub.add_parser(
        "san", help="corrosan runtime sanitizer: replay seeded "
                    "race/leak fixtures (detector true-positive guard); "
                    "a sanitized run is CORROSAN=1 on chaos/fuzz/load or "
                    "on the test command")
    san.add_argument("fixtures", nargs="*", default=None,
                     help="fixture names (default: all)")
    san.add_argument("--list-fixtures", action="store_true")
    san.add_argument("--format", choices=("text", "json"), default="text")
    san.add_argument("--output-json", metavar="PATH", default=None,
                     help="write the fixtures section of the corrosan "
                          "report")
    san.add_argument("--device", default="cuda",
                     help="device of the agent-backed fixtures (default "
                          "cuda)")
    san.set_defaults(fn=cmd_san)

    rl = sub.add_parser("reload", help="re-apply config (schema, log level)")
    rl.add_argument("config")
    rl.set_defaults(fn=cmd_reload)

    asr = sub.add_parser("assertions",
                         help="always/sometimes assertion report")
    asr.set_defaults(fn=cmd_assertions)

    mr = sub.add_parser(
        "mem-report",
        help="per-table bytes audit of the configured sim state (O(N·M) "
             "vs O(N) classification)")
    mr.add_argument("-c", "--config", default=None)
    mr.add_argument("--n-nodes", type=int, default=0,
                    help="override [sim] n_nodes for the audit")
    mr.add_argument("--project", metavar="N[,M]", default=None,
                    type=_project_point,
                    help="print the static projection at (N[, M]) instead "
                         "of building a state (the meta device, any N)")
    mr.add_argument("--device", default="cuda",
                    help="device the audited state is built on (default "
                         "cuda; --project builds nothing)")
    mr.set_defaults(fn=cmd_mem_report)

    d = sub.add_parser("default-config", help="print an example config file")
    d.set_defaults(fn=cmd_default_config)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # downstream pager/head closed the pipe — normal unix behavior
        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
