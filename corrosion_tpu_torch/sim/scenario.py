"""Workload scenarios of the full-view round (port of the full-view
generators of ``corrosion_tpu/sim/scenario.py``).

Each builds a stacked ``RoundInput`` (leading axis = rounds) from a key,
with the JAX package's draws: the same key gives the same arrays. The
mixes are the repo's baseline configurations: membership only, churn,
single-writer inserts, conflict-heavy multi-writer LWW, and the full mix
(churn + conflict-heavy writes) with partition windows.
"""

from __future__ import annotations

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
