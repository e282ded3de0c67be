"""Configuration: TOML file + environment overlay (port of
``corrosion_tpu/config.py``: the same file loads in both packages).

Mirrors the reference's config system (``crates/corro-types/src/config.rs``):
a TOML file with sections ``db / api / gossip / perf / admin / telemetry /
log / consul`` (``config.rs:63-81``), an environment-variable overlay using
the ``__`` separator (``config.rs:326-332``), a ``PerfConfig`` section that
centralizes every queue length / pool size (``config.rs:200-257``), and a
test-config constructor (``config.rs:335-456``).

TPU reframing: the ``[sim]`` section (no reference analog) selects the
simulator model and cluster scale; ``[perf]`` holds the bounded-pool
shapes that the reference expresses as channel capacities; ``[gossip]``
carries the protocol knobs plus the network-condition model that the
reference gets implicitly from real sockets.
"""

from __future__ import annotations

import dataclasses
import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: stdlib tomllib is absent
    import tomli as tomllib
from typing import Any, Optional

ENV_PREFIX = "CORRO_TPU"


@dataclasses.dataclass
class DbConfig:
    """Where state lives on the host (``config.rs`` ``db.path`` etc.).

    The SQLite file's role — the durable checkpoint — is played by
    checkpoint directories (see ``checkpoint.py``)."""

    path: str = "./corro_tpu_state"
    schema_paths: tuple = ()
    # auto-checkpoint cadence in rounds (WAL-checkpoint analog); 0 = off
    checkpoint_rounds: int = 0
    # membership persistence (the __corro_members table analog,
    # broadcast/mod.rs:814-949): the maintenance loop dumps the member
    # list here; a booting agent bootstraps its SWIM views from it
    # (initialise_foca's ApplyMany-from-DB, util.rs:69-130). "" = off
    members_path: str = ""


@dataclasses.dataclass
class ApiConfig:
    """HTTP API listener (``config.rs`` ``api.bind_addr``)."""

    addr: str = "127.0.0.1"
    port: int = 8787


@dataclasses.dataclass
class GossipConfig:
    """Protocol + network-model knobs (``config.rs`` ``gossip``)."""

    bootstrap: tuple = ()  # seed node ids (DNS list analog)
    cluster_id: int = 0
    drop_prob: float = 0.01
    n_regions: int = 1  # geographic regions feeding the RTT rings
    idle_rounds: int = 16  # announce interval analog
    plaintext: bool = True  # no TLS in the simulator


@dataclasses.dataclass
class PerfConfig:
    """Bounded-pool shapes (``PerfConfig``, ``config.rs:200-257``)."""

    buf_slots: int = 32  # out-of-order version buffer (processing queue cap)
    bcast_queue: int = 32  # pending-broadcast slots
    recv_slots: int = 96  # per-round apply mailbox (full sim)
    pig_changes: int = 4  # changesets per packet (scale sim)
    sync_chunk: int = 32  # versions per (peer, origin) sync pull
    sync_interval: int = 8
    sync_peers: int = 2
    bcast_fanout: int = 5
    bcast_max_transmissions: int = 4
    # kept so that a config file written for the JAX package loads: no
    # code in the port reads it. The port's round is functional (every
    # round writes fresh tensors and never consumes its input state), so
    # there is no carry to donate and readers need no lease.
    donate_rounds: bool = True
    # kernel route (ops/megakernel.py): "auto" and "on" run the
    # hand-written CUDA kernels on CUDA tensors and their plain PyTorch
    # versions on CPU tensors; "off" and "interpret" name paths the port
    # does not have and are refused when the agent is built. Threaded
    # onto the sim config as ``cfg.fused``
    fused: str = "auto"
    # quiescence-aware active-set rounds: threaded as ``cfg.quiet`` for
    # the simulator entry points; the agent's live loop runs the dense
    # round whatever it says, as the JAX package's does
    quiet: str = "auto"
    # dense-round backstop cadence while quiet; 0 = sync_interval
    quiet_backstop_interval: int = 0


@dataclasses.dataclass
class SimConfigSection:
    """Simulator model + scale (TPU-specific section)."""

    mode: str = "scale"  # "full" (O(N^2) faithful) | "scale" (bounded tables)
    n_nodes: int = 256
    m_slots: int = 64
    n_origins: int = 16
    n_rows: int = 16
    n_cols: int = 4
    seed: int = 0


@dataclasses.dataclass
class PgConfig:
    """PostgreSQL wire listener (``config.rs`` ``api.pg``)."""

    enabled: bool = False
    addr: str = "127.0.0.1"
    port: int = 5432


@dataclasses.dataclass
class ServeConfig:
    """corroguard overload policy for the serving plane
    (``api/admission.py``, docs/overload.md).

    ``max_inflight`` <= 0 disables admission control entirely (the
    unguarded plane); with it on, each route class (write / read /
    stream / pg) admits at most ``max_inflight`` concurrent requests,
    queues up to ``max_queue`` more for ``queue_wait`` seconds, and
    sheds the rest with 503 + Retry-After derived from the live
    latency histograms.

    The non-zero defaults are DERIVED from the committed two-arm
    overload measurement (``BENCH_SERVE_r17.json``): the guarded arm
    held delivery p99 = 1.75 s <= the 2.5 s contract bound while the
    unguarded arm blew it 3.6x (9.0 s) under the same load. The
    arithmetic lives in docs/overload.md ("Default caps"); change a
    default only together with that derivation. ``0`` stays the
    explicit unlimited opt-out per knob — :meth:`unlimited` returns
    the all-off policy (the pre-r18 behavior)."""

    # 2x the concurrency the r17 guarded arm absorbed with zero sheds
    # at cap 3 (stage 0), sized to absorb its breaking stage (8
    # writers) without shedding; <=0 = admission off
    max_inflight: int = 8
    # floor(max_inflight * queue_wait / 0.117 s measured p50 write
    # service): the deepest queue that still drains inside queue_wait
    max_queue: int = 16
    # stream/pg tickets are held for the WHOLE stream / wire connection,
    # so long-lived classes get their own capacity instead of starving
    # one-shot requests out of max_inflight; <=0 inherits max_inflight.
    # 8x the write cap — the r17 rig's stream:inflight ratio (32:3),
    # rounded down to a power of two
    max_streams: int = 64
    queue_wait: float = 0.25  # seconds a queued request waits for a slot
    retry_after_cap: float = 30.0  # ceiling on derived Retry-After hints
    # bounded per-subscription NDJSON delivery queues (pubsub.py):
    shed_policy: str = "shed-oldest"  # or "drop-newest" (legacy)
    # ~ lag_bound / per-frame fanout write time (2.5 s / ~2.4 ms),
    # rounded to a power of two; 0 = unbounded (explicit opt-out)
    sub_queue: int = 1024
    sub_shed_threshold: int = 256  # cumulative sheds before disconnect
    # SO_SNDBUF clamp for NDJSON stream sockets (> 0 to enable): the
    # per-sub queue only bounds delivery lag if the kernel's socket
    # pipeline can't silently absorb the backlog behind it
    stream_sndbuf: int = 0

    @classmethod
    def unlimited(cls) -> "ServeConfig":
        """The explicit all-off opt-out: no admission control, no
        stream caps, unbounded subscription queues (each knob's
        documented ``0 = unlimited`` contract in one place). This is
        what ``serve = None`` meant before the measured defaults
        landed — benches and tests that NEED the unguarded plane say
        so out loud with this."""
        return cls(max_inflight=0, max_queue=0, max_streams=0,
                   sub_queue=0)


@dataclasses.dataclass
class AdminConfig:
    """UDS admin socket (``config.rs`` ``admin.uds_path``)."""

    uds_path: str = "./admin.sock"


@dataclasses.dataclass
class TelemetryConfig:
    """Prometheus exposition + OTLP pipeline (``config.rs`` ``telemetry``)."""

    prometheus_addr: Optional[str] = None  # "host:port" or None = disabled
    # OTLP span export (the reference's open-telemetry pipeline,
    # main.rs:57-150) — a file path here enables the OTLP-JSON file
    # exporter (zero-egress environments have no collector socket)
    otlp_path: str = ""


@dataclasses.dataclass
class ObsConfig:
    """Flight-recorder observability plane for the soak pipeline
    (``corrosion_tpu_torch/obs/``, docs/observability.md).

    Distinct from ``[telemetry]`` (the host agent's always-on
    Prometheus/OTLP endpoints): ``[obs]`` arms the PER-RUN soak plane —
    NDJSON flight records, a dedicated soak metrics listener, and
    device-profiler span annotation."""

    # NDJSON flight-record path ("" = off): crash-safe per-segment
    # records a dead soak leaves behind (obs.replay_flight_record)
    flight_path: str = ""
    # standalone Prometheus listener for the soak registry: -1 = off,
    # 0 = ephemeral (bound port on the server's ``bound_port``), >0 fixed
    prometheus_port: int = -1
    # label the pipeline spans in torch.profiler traces (the key keeps the
    # JAX package's name, where it annotates jax.profiler traces)
    jax_profile: bool = False


@dataclasses.dataclass
class LogConfig:
    colors: bool = False
    format: str = "plaintext"  # or "json"
    level: str = "info"


@dataclasses.dataclass
class ConsulConfig:
    enabled: bool = False
    addr: str = "127.0.0.1:8500"
    poll_seconds: float = 1.0


@dataclasses.dataclass
class Config:
    db: DbConfig = dataclasses.field(default_factory=DbConfig)
    api: ApiConfig = dataclasses.field(default_factory=ApiConfig)
    gossip: GossipConfig = dataclasses.field(default_factory=GossipConfig)
    perf: PerfConfig = dataclasses.field(default_factory=PerfConfig)
    sim: SimConfigSection = dataclasses.field(default_factory=SimConfigSection)
    pg: PgConfig = dataclasses.field(default_factory=PgConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    admin: AdminConfig = dataclasses.field(default_factory=AdminConfig)
    telemetry: TelemetryConfig = dataclasses.field(default_factory=TelemetryConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    log: LogConfig = dataclasses.field(default_factory=LogConfig)
    consul: ConsulConfig = dataclasses.field(default_factory=ConsulConfig)

    # --- simulator-config bridges ---------------------------------------
    def to_scale_config(self):
        from corrosion_tpu_torch.sim.scale_step import scale_sim_config

        return scale_sim_config(
            self.sim.n_nodes,
            m_slots=self.sim.m_slots,
            n_origins=self.sim.n_origins,
            n_rows=self.sim.n_rows,
            n_cols=self.sim.n_cols,
            buf_slots=self.perf.buf_slots,
            bcast_queue=self.perf.bcast_queue,
            pig_changes=self.perf.pig_changes,
            sync_chunk=self.perf.sync_chunk,
            sync_interval=self.perf.sync_interval,
            sync_peers=self.perf.sync_peers,
            bcast_max_transmissions=self.perf.bcast_max_transmissions,
            announce_interval=self.gossip.idle_rounds,
            fused=self.perf.fused,
            quiet=self.perf.quiet,
            quiet_backstop_interval=self.perf.quiet_backstop_interval,
        )

    def to_full_config(self):
        from corrosion_tpu_torch.sim.config import wan_config

        return wan_config(
            self.sim.n_nodes,
            n_origins=self.sim.n_origins,
            n_rows=self.sim.n_rows,
            n_cols=self.sim.n_cols,
            buf_slots=self.perf.buf_slots,
            bcast_queue=self.perf.bcast_queue,
            recv_slots=self.perf.recv_slots,
            sync_chunk=self.perf.sync_chunk,
            sync_interval=self.perf.sync_interval,
            sync_peers=self.perf.sync_peers,
            bcast_fanout=self.perf.bcast_fanout,
            bcast_max_transmissions=self.perf.bcast_max_transmissions,
            announce_interval=self.gossip.idle_rounds,
            fused=self.perf.fused,
        )

    def sim_config(self):
        if self.sim.mode == "scale":
            return self.to_scale_config()
        if self.sim.mode == "full":
            return self.to_full_config()
        raise ValueError(f"unknown sim.mode {self.sim.mode!r}")


_SECTIONS = {f.name: f.type for f in dataclasses.fields(Config)}


def _coerce(cur: Any, raw: str) -> Any:
    """Coerce an env-var string to the type of the current value."""
    if isinstance(cur, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(cur, int):
        return int(raw)
    if isinstance(cur, float):
        return float(raw)
    if isinstance(cur, tuple):
        return tuple(x.strip() for x in raw.split(",") if x.strip())
    return raw


def _apply_dict(cfg: Config, data: dict) -> Config:
    for section, values in data.items():
        if section not in _SECTIONS:
            raise ValueError(f"unknown config section [{section}]")
        sec = getattr(cfg, section)
        if not isinstance(values, dict):
            raise ValueError(f"section [{section}] must be a table")
        for k, v in values.items():
            if not hasattr(sec, k):
                raise ValueError(f"unknown key {k!r} in section [{section}]")
            if isinstance(v, list):
                v = tuple(v)
            setattr(sec, k, v)
    return cfg


def _apply_env(cfg: Config, environ=None) -> Config:
    """Overlay ``CORRO_TPU__SECTION__KEY=value`` env vars (the reference's
    ``__``-separator overlay, ``config.rs:326-332``)."""
    environ = os.environ if environ is None else environ
    prefix = ENV_PREFIX + "__"
    for name, raw in environ.items():
        if not name.startswith(prefix):
            continue
        parts = name[len(prefix):].lower().split("__")
        if len(parts) != 2:
            raise ValueError(f"bad config env var {name} (want SECTION__KEY)")
        section, key = parts
        if section not in _SECTIONS:
            raise ValueError(f"unknown config section {section!r} from {name}")
        sec = getattr(cfg, section)
        if not hasattr(sec, key):
            raise ValueError(f"unknown key {key!r} from {name}")
        setattr(sec, key, _coerce(getattr(sec, key), raw))
    return cfg


def load_config(path: Optional[str] = None, environ=None) -> Config:
    """TOML file (optional) + env overlay -> validated Config."""
    cfg = Config()
    if path is not None:
        with open(path, "rb") as f:
            _apply_dict(cfg, tomllib.load(f))
    return _apply_env(cfg, environ)


def default_toml() -> str:
    """An example config file (``config.example.toml`` analog)."""
    lines = []
    for f in dataclasses.fields(Config):
        lines.append(f"[{f.name}]")
        sec = getattr(Config(), f.name)
        for sf in dataclasses.fields(sec):
            v = getattr(sec, sf.name)
            if v is None:
                lines.append(f"# {sf.name} = <unset>")
            elif isinstance(v, bool):
                lines.append(f"{sf.name} = {str(v).lower()}")
            elif isinstance(v, (int, float)):
                lines.append(f"{sf.name} = {v}")
            elif isinstance(v, tuple):
                lines.append(f"{sf.name} = {list(v)!r}")
            else:
                lines.append(f'{sf.name} = "{v}"')
        lines.append("")
    return "\n".join(lines)
