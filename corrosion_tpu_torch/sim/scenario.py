"""Workload scenarios (port of ``corrosion_tpu/sim/scenario.py``): the
full-view generators and the scale round's fault compiler.

Each full-view generator builds a stacked ``RoundInput`` (leading axis =
rounds) from a key, with the JAX package's draws: the same key gives the
same arrays. The mixes are the repo's baseline configurations: membership
only, churn, single-writer inserts, conflict-heavy multi-writer LWW, and
the full mix (churn + conflict-heavy writes) with partition windows.

The **fault compiler** at the bottom is the scale round's half of the chaos
engine (``resilience/chaos.py``): a :class:`FaultPhase` is a declarative
window of a scenario (a constant network shape plus seeded workload, churn
and clock-skew knobs), and :func:`compile_scale_phase` lowers it into the
inputs the segmented soak runner consumes. Compilation is a pure function
of ``(cfg, phase, key, dead)`` and draws what the JAX package draws, so the
same key gives the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.sim.config import SimConfig
from corrosion_tpu_torch.sim.step import RoundInput, SimState
from corrosion_tpu_torch.sim.transport import NetModel


def _below(u, p: float):
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


def quiet(cfg: SimConfig, rounds: int, device="cuda") -> RoundInput:
    """Membership only: no faults, no writes."""
    z = RoundInput.quiet(cfg, device)
    return RoundInput(*(a.expand((rounds,) + tuple(a.shape)).clone() for a in z))


def churn(cfg: SimConfig, rounds: int, key, rate: float = 0.01,
          device="cuda") -> RoundInput:
    """Each round a node dies or rejoins with probability ``rate``."""
    dev = resolve_device(device)
    n = cfg.n_nodes
    k1, k2 = prng.split(key)
    kill = _below(prng.uniform(k1, (rounds, n), dev), rate)
    revive = _below(prng.uniform(k2, (rounds, n), dev), rate)
    return quiet(cfg, rounds, dev)._replace(kill=kill, revive=revive & ~kill)


def single_writer(cfg: SimConfig, rounds: int, key, device="cuda") -> RoundInput:
    """Node 0 writes one random cell every round."""
    dev = resolve_device(device)
    n = cfg.n_nodes
    k1, k2 = prng.split(key)
    base = quiet(cfg, rounds, dev)
    w = torch.zeros((rounds, n), dtype=torch.bool, device=dev)
    w[:, 0] = True
    cell = torch.zeros((rounds, n), dtype=torch.int32, device=dev)
    cell[:, 0] = prng.randint(k1, (rounds,), 0, cfg.n_cells, dev)
    val = torch.zeros((rounds, n), dtype=torch.int32, device=dev)
    val[:, 0] = prng.randint(k2, (rounds,), 0, 1 << 20, dev)
    return base._replace(write_mask=w, write_cell=cell, write_val=val)


def conflict_heavy(cfg: SimConfig, rounds: int, key, write_prob: float = 0.5,
                   hot_cells: int = 2, device="cuda") -> RoundInput:
    """Every origin writes with ``write_prob`` into a few hot cells."""
    dev = resolve_device(device)
    n = cfg.n_nodes
    k1, k2, k3 = prng.split(key, 3)
    w = _below(prng.uniform(k1, (rounds, n), dev), write_prob) & (
        torch.arange(n, device=dev)[None, :] < cfg.n_origins)
    cell = prng.randint(k2, (rounds, n), 0, max(1, hot_cells), dev)
    val = prng.randint(k3, (rounds, n), 0, 1 << 20, dev)
    return quiet(cfg, rounds, dev)._replace(write_mask=w, write_cell=cell,
                                            write_val=val)


def full_mix(cfg: SimConfig, rounds: int, key, churn_rate: float = 0.005,
             write_prob: float = 0.3, device="cuda") -> RoundInput:
    """Churn + conflict-heavy writes over all cells (the baseline's mixed
    configuration); partition windows are a ``partitioned_net`` for the
    rounds of the window."""
    k1, k2 = prng.split(key)
    inp = conflict_heavy(cfg, rounds, k1, write_prob=write_prob,
                         hot_cells=cfg.n_cells, device=device)
    ch = churn(cfg, rounds, k2, rate=churn_rate, device=device)
    return inp._replace(kill=ch.kill, revive=ch.revive)


def partitioned_net(cfg: SimConfig, groups: int = 2, drop_prob: float = 0.0,
                    device="cuda") -> NetModel:
    """The network split into ``id % groups`` islands."""
    net = NetModel.create(cfg.n_nodes, drop_prob=drop_prob, device=device)
    return net._replace(partition=(
        torch.arange(cfg.n_nodes, device=net.partition.device) % groups
    ).to(torch.int32))


def full_view_workload(cfg: SimConfig, rounds: int, device="cuda"):
    """The full view's measured workload: ``full_mix`` (key 5) under 1 %
    gossip loss, the agent's default, from a fresh state, round key 3.
    Returns ``(state, net, key, inputs)``."""
    return (SimState.create(cfg, device=device),
            NetModel.create(cfg.n_nodes, drop_prob=0.01, device=device),
            prng.key(3), full_mix(cfg, rounds, prng.key(5), device=device))


# --- the scale round's fault compiler -------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPhase:
    """One declarative window of a chaos scenario (scenario-as-data).

    Kills, revives and writes land in the compiled ``ScaleRoundInput``
    stack; partition and loss shape the phase's constant ``NetModel``;
    ``clock_skew_*`` compiles to an HLC bump the engine adds at phase entry
    (the knob the HLC max-drift gate is swept against). Kills and revives
    both fire on the phase's first round and are disjoint: revives cover
    only nodes dead at entry, kills draw from alive non-seed nodes."""

    rounds: int
    write_frac: float = 0.0  # conflict-heavy writer fraction per round
    kill_frac: float = 0.0  # one-shot kill draw at phase entry
    revive_killed: bool = False  # revive every dead node at phase entry
    partition_groups: int = 1  # >1: net split into id%groups islands
    drop_prob: float = 0.0  # datagram loss for the phase
    clock_skew_rounds: int = 0  # HLC skew injected at phase entry...
    clock_skew_frac: float = 0.0  # ...on this fraction of nodes

    def validate(self) -> "FaultPhase":
        if self.rounds <= 0:
            raise ValueError(f"phase rounds must be positive, got {self.rounds}")
        for name in ("write_frac", "kill_frac", "clock_skew_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} {v} not in [0, 1]")
        if self.partition_groups < 1:
            raise ValueError(
                f"partition_groups must be >= 1, got {self.partition_groups}"
            )
        if self.clock_skew_rounds < 0 or not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError(
                f"bad clock_skew_rounds/drop_prob "
                f"{self.clock_skew_rounds}/{self.drop_prob}"
            )
        return self


def _host_uniform(key, shape) -> np.ndarray:
    """float32 uniforms as numpy (the draws are small: [N] or [rounds, N])."""
    return prng.uniform(key, shape, "cpu").numpy()


def compile_scale_phase(cfg, phase: FaultPhase, key, dead=None, device="cuda"):
    """Lower one :class:`FaultPhase` into the round's fault inputs.

    -> ``(inputs, net, skew, dead_out)``: ``inputs`` a stacked
    ``ScaleRoundInput`` (leading axis ``phase.rounds``) and ``net`` the
    phase's constant ``NetModel``, both on ``device``; ``skew`` an int32
    numpy [N] of pre-shifted HLC units (``rounds << HLC_ROUND_BITS``;
    all zero when the phase skews no clock) the engine adds to
    ``crdt.hlc`` at phase entry; ``dead_out`` the bool numpy [N] dead set
    after this phase's entry events (thread it into the next phase so
    revives stay exact inverses of earlier kills).

    Pure in ``(cfg, phase, key, dead)``. Writes are masked to nodes alive
    after the entry events, so a scripted workload never writes from a
    corpse."""
    from corrosion_tpu_torch.sim.broadcast import HLC_ROUND_BITS
    from corrosion_tpu_torch.sim.scale_step import ScaleRoundInput, make_write_inputs

    dev = resolve_device(device)
    phase.validate()
    n, rounds = cfg.n_nodes, phase.rounds
    k_kill, k_write, k_mask, k_skew = prng.split(key, 4)
    dead = (np.zeros(n, bool) if dead is None
            else np.array(dead, dtype=bool, copy=True))
    if dead.shape != (n,):
        raise ValueError(f"dead mask shape {dead.shape} != ({n},)")

    revive_mask = dead if phase.revive_killed else np.zeros(n, bool)
    killable = ~dead & (np.arange(n) >= cfg.n_seeds)
    kill_mask = (
        (_host_uniform(k_kill, (n,)) < phase.kill_frac) & killable
        if phase.kill_frac > 0.0 else np.zeros(n, bool)
    )
    dead_out = (dead & ~revive_mask) | kill_mask

    if phase.write_frac > 0.0:
        wm = _host_uniform(k_mask, (rounds, n)) < phase.write_frac
        wm &= ~dead_out[None, :]
        inputs = make_write_inputs(cfg, k_write, rounds, torch.from_numpy(wm), dev)
    else:
        quiet = ScaleRoundInput.quiet(cfg, dev)
        inputs = ScaleRoundInput(*(a.expand((rounds,) + tuple(a.shape)).clone()
                                   for a in quiet))
    first = np.arange(rounds)[:, None] == 0
    inputs = inputs._replace(
        kill=torch.from_numpy(first & kill_mask[None, :]).to(dev),
        revive=torch.from_numpy(first & revive_mask[None, :]).to(dev),
    )

    net = NetModel.create(n, drop_prob=phase.drop_prob, device=dev)
    if phase.partition_groups > 1:
        net = net._replace(partition=(
            torch.arange(n, dtype=torch.int32, device=dev) % phase.partition_groups))

    skew = np.zeros(n, np.int32)
    if phase.clock_skew_rounds > 0 and phase.clock_skew_frac > 0.0:
        sel = _host_uniform(k_skew, (n,)) < phase.clock_skew_frac
        skew = np.where(
            sel, np.int32(phase.clock_skew_rounds << HLC_ROUND_BITS), 0
        ).astype(np.int32)
    return inputs, net, skew, dead_out
