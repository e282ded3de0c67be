"""Static simulator configuration (port of ``corrosion_tpu/sim/config.py``).

``SimConfig`` and ``wan_config`` are copied field for field, so the same
arguments give the same shapes and protocol constants as the JAX package
(a CPU test pins the two equal). ``check_full_slice`` refuses the
execution knobs the port does not have.
"""

from __future__ import annotations

import dataclasses
import math

#: the execution-knob vocabularies the configs validate against
FUSED_MODES = ("auto", "on", "off", "interpret")
QUIET_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Shapes and protocol constants for the full-view simulated cluster."""

    n_nodes: int
    # --- SWIM membership -------------------------------------------------
    n_indirect: int = 3
    suspicion_rounds: int = 6
    piggyback: int = 8
    max_transmissions: int = 10
    announce_interval: int = 16
    # --- CRDT store ------------------------------------------------------
    n_origins: int = 4
    any_writer: bool = False
    org_keep_rounds: int = 16
    n_rows: int = 16
    n_cols: int = 4
    buf_slots: int = 64
    # --- multi-cell transactions -----------------------------------------
    tx_max_cells: int = 8
    partial_slots: int = 16
    # --- broadcast dissemination -----------------------------------------
    bcast_fanout: int = 5
    bcast_queue: int = 64
    bcast_max_transmissions: int = 3
    recv_slots: int = 96
    bcast_budget_bytes: int = 10 * 1024 * 1024
    # --- anti-entropy sync -----------------------------------------------
    sync_interval: int = 8
    sync_peers: int = 2
    sync_chunk: int = 32
    serve_cap: int = 3
    sync_min_chunk: int = 4
    sync_defer_cap: int = 8
    sync_sweep_every: int = 0
    # --- execution knob: in the port "auto" and "on" both mean the kernel
    # route on CUDA tensors; "off" and "interpret" are refused
    fused: str = "auto"

    @property
    def n_cells(self) -> int:
        return self.n_rows * self.n_cols

    @property
    def sync_tracks(self) -> int:
        """Columns of the last-sync table: one per peer node id."""
        return self.n_nodes

    def validate(self) -> "SimConfig":
        if self.n_origins > self.n_nodes:
            raise ValueError(
                f"n_origins {self.n_origins} > n_nodes {self.n_nodes}"
            )
        if self.piggyback < 1 or self.n_indirect < 0:
            raise ValueError(
                f"need piggyback >= 1 and n_indirect >= 0, got "
                f"{self.piggyback}/{self.n_indirect}"
            )
        if not 1 <= self.tx_max_cells <= 30:
            raise ValueError(
                f"tx_max_cells {self.tx_max_cells} not in 1..30 "
                f"(seq bitmask lives in an int32)"
            )
        if self.fused not in FUSED_MODES:
            raise ValueError(f"fused {self.fused!r} not one of {FUSED_MODES}")
        return self


def wan_config(n_nodes: int, **overrides) -> SimConfig:
    """Cluster-size-adaptive defaults: 3 indirect probes, dissemination
    budget growing with log N, broadcast and sync fanout
    ``clamp(N / 100, 3, 10)``."""
    log_n = max(1, math.ceil(math.log2(max(2, n_nodes))))
    defaults = dict(
        n_indirect=3,
        max_transmissions=log_n + 4,
        suspicion_rounds=max(4, log_n),
        piggyback=8,
        bcast_fanout=max(3, min(10, n_nodes // 100 + 3)),
        sync_peers=max(3, min(10, n_nodes // 100)),
    )
    defaults.update(overrides)
    return SimConfig(n_nodes=n_nodes, **defaults).validate()


def full_view_config(n_nodes: int = 8192, **overrides) -> SimConfig:
    """The full view's measured point: ``wan_config`` with the agent's 16
    origins and single-cell transactions, the configuration whose round
    runs the ingest kernel (recv_slots = 96, 16 x 4 cells, Q = 64)."""
    return wan_config(n_nodes, **{"n_origins": 16, "tx_max_cells": 1, **overrides})


def check_full_slice(cfg: SimConfig) -> None:
    """Raise for the execution knobs the port does not have: ``fused="off"``
    and ``"interpret"``."""
    if cfg.fused in ("off", "interpret"):
        raise ValueError(
            f"fused={cfg.fused!r}: the port has no XLA or interpret path; the "
            f"route follows the config and the tensors' device (ROADMAP, "
            f"rules of the port)")
