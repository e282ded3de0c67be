"""The ``corrosion-tpu-torch`` command line (port of
``corrosion_tpu_torch/cli.py``).

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
- ``locks``, ``compact``, ``reload``, ``assertions``, ``default-config``.

The JAX package's ``soak``, ``template``, ``consul``, ``mem-report``,
``devcluster``, ``lint``, ``san``, ``chaos``, ``fuzz`` and ``load`` are not
ported yet (ROADMAP Queue 1).

Run as ``python -m corrosion_tpu_torch <command>``.
"""

from __future__ import annotations

import argparse
import json
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


def cmd_agent(args, cfg=None) -> int:
    from corrosion_tpu_torch.admin import AdminServer
    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.api import ApiServer
    from corrosion_tpu_torch.db import Database

    if cfg is None:
        cfg = load_config(args.config) if args.config else Config()
    if cfg.pg.enabled:
        raise SystemExit(
            "pg.enabled = true: the PostgreSQL wire listener is not ported "
            "yet (ROADMAP Queue 1 item 15-rest)")
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
    agent.tripwire.hook_signals()
    api = admin = prom = None
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
        if prom_hostport:
            from corrosion_tpu_torch.utils.metrics import start_prometheus_listener

            prom = start_prometheus_listener(agent.metrics, *prom_hostport)
        if cfg.telemetry.otlp_path:
            from corrosion_tpu_torch.utils.tracing import configure_otlp_file

            configure_otlp_file(cfg.telemetry.otlp_path)
        extras = f" prometheus {cfg.telemetry.prometheus_addr}" if prom else ""
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


def cmd_reload(args) -> int:
    with _admin(args) as admin:
        out = admin.call("reload", config=args.config)
    print(json.dumps(out))
    return 0


def cmd_assertions(args) -> int:
    with _admin(args) as admin:
        print(json.dumps(admin.call("assertions"), indent=2))
    return 0


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

    rl = sub.add_parser("reload", help="re-apply config (schema, log level)")
    rl.add_argument("config")
    rl.set_defaults(fn=cmd_reload)

    asr = sub.add_parser("assertions",
                         help="always/sometimes assertion report")
    asr.set_defaults(fn=cmd_assertions)

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
