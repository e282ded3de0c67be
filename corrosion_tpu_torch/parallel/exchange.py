"""The node axis as one shard sees it, and the exchanges between shards.

A mesh run is single-controller: one process, one worker thread per
shard, each running the same round code on its own rows ``[lo, hi)`` of
the node axis on its own device. The threads meet only at the exchanges
this module defines, all of them collective (every shard calls each one
in the same order):

- :meth:`NodeAxis.all_gather`: the whole ``[N, ...]`` plane on this
  shard's device (the cross-node gathers of the round then index it with
  global node ids);
- :meth:`NodeAxis.owner_add` / :meth:`NodeAxis.owner_max`: every shard
  builds its partial ``[N, ...]`` scatter over global ids, and each owner
  keeps its own rows of the sum (max) over the shards. Integer sums and
  maxima are exact in any order, so the result is bitwise the
  single-device scatter's;
- :meth:`NodeAxis.sum` / :meth:`any` / :meth:`all` / :meth:`max` and
  :meth:`sum_info`: reductions of scalars over the whole axis.

:meth:`NodeAxis.whole` is the single-device axis: every method is the
identity or the op the round ran before there was a mesh (no copy, no
wait, no thread), so ``axis=None`` runs exactly the unsharded round.

The exchange layer is :class:`ShardGroup`. The shards take turns in
rank order, each running until its next exchange: it writes its slot,
hands the turn on and waits for its next turn, by when every shard has
written that exchange's slot. One turn at a time keeps the shard threads
from contending for the interpreter lock over the round's many small
tensor ops (at eight shards, contention cost more than the work); the
devices still overlap, since a turn only enqueues work on its shard's
device. Two banks of slots alternate, so a value stays readable until its
readers have moved on. A byte counter records, per shard, per round and
per exchange site, the bytes that shard received from the other shards;
it is the port's audit of what a round exchanges. A shard that raises
ends every shard's wait, so no shard waits forever; every wait also has a
timeout.

The group adds no lock: turns pass through one ``threading.Event`` per
shard, each shard writes only its own slot and its own counters, and the
caller reads them after ``join``. All shards of one device stay on that
device's default stream, so a copy a reader enqueues is ordered after the
writer's kernels.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import torch

#: seconds a shard waits for its turn before the run is declared hung
TURN_TIMEOUT_S = 600.0


class ShardAborted(RuntimeError):
    """A shard's wait ended because another shard failed."""


def shard_bounds(n: int, k: int) -> List[tuple]:
    """Contiguous ``[lo, hi)`` row blocks of an ``n``-row axis over ``k``
    shards. The split must be even, as a JAX ``NamedSharding`` demands."""
    if k <= 0 or n % k:
        raise ValueError(
            f"the node axis of global size {n} should be divisible by {k} "
            f"shards")
    b = n // k
    return [(i * b, (i + 1) * b) for i in range(k)]


class ShardGroup:
    """The shards of one mesh run: where they meet, and what moves."""

    def __init__(self, devices: Sequence, n_nodes: int):
        self.devices = [torch.device(d) for d in devices]
        self.k = len(self.devices)
        self.n = int(n_nodes)
        self.bounds = shard_bounds(self.n, self.k)
        self._turn = [threading.Event() for _ in range(self.k)]
        self._failed = False
        self._banks = ([None] * self.k, [None] * self.k)
        self._bank = [0] * self.k  # per shard: the bank its next exchange uses
        #: per shard: one ``{site: bytes received}`` dict per round
        self.moved: List[List[dict]] = [[] for _ in range(self.k)]

    def axes(self) -> List["NodeAxis"]:
        return [NodeAxis(self.n, lo, hi, self.devices[i], self, i)
                for i, (lo, hi) in enumerate(self.bounds)]

    def exchange(self, rank: int, value, site: str, nbytes: Callable = None):
        """Publish ``value`` from shard ``rank`` and return every shard's,
        in shard order. ``nbytes(v)`` gives the bytes a peer's value costs
        this shard (recorded under ``site``)."""
        bank = self._banks[self._bank[rank]]
        self._bank[rank] ^= 1
        bank[rank] = value
        self._pass_turn(rank)
        self._wait_turn(rank)
        got = list(bank)
        if nbytes is not None:
            self._count(rank, site,
                        sum(nbytes(v) for j, v in enumerate(got) if j != rank))
        return got

    def _wait_turn(self, rank: int) -> None:
        if not self._turn[rank].wait(TURN_TIMEOUT_S):
            self._fail()
            raise TimeoutError(
                f"shard {rank} waited {TURN_TIMEOUT_S} s for its turn at an "
                f"exchange")
        self._turn[rank].clear()
        if self._failed:
            raise ShardAborted(f"shard {rank}: another shard failed")

    def _pass_turn(self, rank: int) -> None:
        self._turn[(rank + 1) % self.k].set()

    def _fail(self) -> None:
        self._failed = True
        for t in self._turn:
            t.set()

    def _count(self, rank: int, site: str, nbytes: int) -> None:
        rounds = self.moved[rank]
        if not rounds:
            rounds.append({})
        rounds[-1][site] = rounds[-1].get(site, 0) + int(nbytes)

    def next_round(self, rank: int) -> None:
        self.moved[rank].append({})

    def bytes_by_round(self) -> List[dict]:
        """``[{site: bytes}, ...]`` per round, summed over the shards."""
        out: List[dict] = []
        for rounds in self.moved:
            for r, sites in enumerate(rounds):
                while len(out) <= r:
                    out.append({})
                for site, b in sites.items():
                    out[r][site] = out[r].get(site, 0) + b
        return out

    def run(self, work: Callable[["NodeAxis"], object]):
        """Run ``work(axis)`` on one thread per shard; -> the results in
        shard order. Each shard's kernel launches are counted apart and
        added to the process's counters after the join. The first error a
        shard raises ends the run: every other shard's wait ends, every
        thread is joined, and that error is raised."""
        from corrosion_tpu_torch.ops import megakernel

        axes = self.axes()
        results: list = [None] * self.k
        errors: list = [None] * self.k
        launches: list = [None] * self.k

        def body(i: int) -> None:
            counts = megakernel.shard_launch_counts()
            try:
                self._wait_turn(i)
                results[i] = work(axes[i])
                self._pass_turn(i)
            except BaseException as e:  # noqa: BLE001 — re-raised after join
                errors[i] = e
                self._fail()
            finally:
                launches[i] = counts.close()

        self._turn[0].set()

        threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                    name=f"corro-shard-{i}")
                   for i in range(self.k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for c in launches:
            if c is not None:
                megakernel.add_launch_counts(c)
        first = next((e for e in errors
                      if e is not None and not isinstance(e, ShardAborted)), None)
        if first is None:
            first = next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        return results


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class NodeAxis:
    """Shard ``rank``'s view of the node axis: global size ``n``, its rows
    ``[lo, hi)`` on ``device``, and the ``group`` it exchanges in (None:
    the whole axis on one device)."""

    def __init__(self, n: int, lo: int, hi: int, device, group: Optional[ShardGroup],
                 rank: int = 0):
        self.n, self.lo, self.hi = int(n), int(lo), int(hi)
        self.device = torch.device(device)
        self.group = group
        self.rank = rank

    @staticmethod
    def whole(n: int, device) -> "NodeAxis":
        return NodeAxis(n, 0, n, device, None)

    @property
    def is_whole(self) -> bool:
        return self.group is None

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    def ids(self, dtype=torch.int32) -> torch.Tensor:
        """The global node ids of this shard's rows."""
        if self.is_whole:
            return torch.arange(self.n, dtype=dtype, device=self.device)
        return torch.arange(self.lo, self.hi, dtype=dtype, device=self.device)

    def next_round(self) -> None:
        if not self.is_whole:
            self.group.next_round(self.rank)

    # --- planes ------------------------------------------------------------

    def all_gather(self, x: torch.Tensor, site: str = "gather") -> torch.Tensor:
        """This shard's rows ``x`` ([hi - lo, ...]) -> the whole ``[N, ...]``
        plane on this shard's device."""
        if self.is_whole:
            return x
        parts = self.group.exchange(self.rank, x, site, _nbytes)
        return torch.cat([p.to(self.device) for p in parts])

    def spread(self, x: torch.Tensor, fill) -> torch.Tensor:
        """This shard's rows placed in a whole-axis ``[N, ...]`` tensor
        filled with ``fill`` elsewhere (the base of a partial scatter);
        the whole axis returns ``x``."""
        if self.is_whole:
            return x
        out = torch.full((self.n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        out[self.lo:self.hi] = x
        return out

    def _owner(self, partial: torch.Tensor, site: str, op) -> torch.Tensor:
        if self.is_whole:
            return partial
        parts = self.group.exchange(
            self.rank, partial[:self.n], site,
            lambda v: _nbytes(v[self.lo:self.hi]))
        out = parts[0][self.lo:self.hi].to(self.device)
        for p in parts[1:]:
            out = op(out, p[self.lo:self.hi].to(self.device))
        return out

    def owner_add(self, partial: torch.Tensor, site: str = "owner_add") -> torch.Tensor:
        """Each shard's partial ``[N (+1), ...]`` scatter-add over global
        ids -> this shard's rows of their sum (a padding row past ``N`` is
        dropped; the whole axis returns ``partial`` as it is)."""
        return self._owner(partial, site, torch.add)

    def owner_max(self, partial: torch.Tensor, site: str = "owner_max") -> torch.Tensor:
        """:meth:`owner_add` with the maximum."""
        return self._owner(partial, site, torch.maximum)

    # --- scalars -----------------------------------------------------------

    def _reduce(self, x: torch.Tensor, site: str, op) -> torch.Tensor:
        if self.is_whole:
            return x
        parts = self.group.exchange(self.rank, x, site, _nbytes)
        out = parts[0].to(self.device)
        for p in parts[1:]:
            out = op(out, p.to(self.device))
        return out

    def sum(self, x: torch.Tensor, site: str = "sum") -> torch.Tensor:
        return self._reduce(x, site, torch.add)

    def max(self, x: torch.Tensor, site: str = "max") -> torch.Tensor:
        return self._reduce(x, site, torch.maximum)

    def any(self, x: torch.Tensor, site: str = "any") -> torch.Tensor:
        return self._reduce(x, site, torch.logical_or)

    def all(self, x: torch.Tensor, site: str = "all") -> torch.Tensor:
        return self._reduce(x, site, torch.logical_and)

    def sum_info(self, info: dict, site: str = "info") -> dict:
        """A round's info dict of per-shard counts -> the whole axis's, in
        one exchange (each value keeps its dtype)."""
        if self.is_whole or not info:
            return info
        keys = list(info)
        stacked = torch.stack([info[k].to(torch.int64) for k in keys])
        total = self.sum(stacked, site)
        return {k: total[i].to(info[k].dtype) for i, k in enumerate(keys)}
