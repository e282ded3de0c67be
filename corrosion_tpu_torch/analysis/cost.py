"""corrocost for the port: every hot entry point's per-round operations
and memory-model bytes, exact polynomial fits in the config extents, and
the static roofline at the 1M point (port of
``corrosion_tpu/analysis/cost.py``).

The JAX package prices a traced jaxpr. The port has no trace, so it runs
the entry point eagerly on real tensors under a ``TorchDispatchMode``
(:class:`Counter`) and prices every aten op as the JAX model prices the
matching primitive:

- an op's operations are ``weight × output elements``, with constant
  weights (:data:`_FLOP_WEIGHTS`); data movement (views, slices, copies,
  gathers, concatenation, tensor creation) is free (:data:`_ZERO_FLOP`);
  reductions are priced at their input size (:data:`_INPUT_SIZED`);
  scatters at their updates. No weight has a ``log`` term, so a fit that
  reproduces held-out points proves the count is that polynomial;
- an op's bytes are its tensor inputs read and its outputs written once
  (the unfused upper bound).

Two kinds of call are priced as units from their shapes, and what runs
inside them is skipped (``_units.py``): the PRNG draws of ``random.py``
and its ``top_k``, priced exactly as the JAX model prices the jaxpr of the
same ``jax.random`` or ``lax.top_k`` call (:data:`UNIT_PRICES`; its sort
otherwise costs by the row's width and layout), and the kernel wrappers
``swim_tables_fused`` and ``ingest``, priced at their operands plus
results in bytes and at the worst case (every slot and message live) in
operations. So a round counts the same on CPU tensors (plain versions)
as on CUDA tensors (kernels), and the count does not move when a draw or
a kernel gets faster: it is the yardstick, not the measurement.

Control flow: the JAX model takes a ``cond``'s costliest arm; the port's
round takes its host-gated arms on the host, so every priced round is
started at a ``now`` that makes it a sync-and-sweep round, the quiet
entry is fed writes so that its dense arm runs, and the counter checks
the arms that ran (``_units.arm``). Scan entries price 2 rounds minus 1.

Meta tensors cannot run a round (the host mirror of ``now``, the route),
so fits are made on CPU tensors at the JAX package's small points; a
direct count at the 1M point runs on the card (``chip_smoke.py`` cost).
There is no XLA here, so JAX's ``xla_agreement`` has no counterpart; the
tests hold the port's count against the JAX package's instead.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from fractions import Fraction
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from corrosion_tpu_torch import _units

#: state root -> the extent degrees the fitted polynomials have, and so the
#: degrees the state inventory must have (copied from the JAX package;
#: :func:`check_degrees` holds the two together)
COST_DEGREES: Dict[str, Dict[str, int]] = {
    "ScaleSimState": {"N": 1, "M": 1},
    "SimState": {"N": 2, "M": 1},
}

#: the declared flagship projection point (``shapes.HBM_BUDGET["point"]``)
ROOFLINE_POINT: Dict[str, int] = {"N": 1_000_000, "M": 64}


# --------------------------------------------------------------------------
# the per-op cost counter
# --------------------------------------------------------------------------

#: data movement: 0 operations (bytes still counted)
_ZERO_FLOP = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "slice",
    "select", "squeeze", "unsqueeze", "permute", "transpose", "t", "unbind",
    "split", "split_with_sizes", "chunk", "narrow", "alias", "detach",
    "clone", "copy", "cat", "stack", "flip", "roll", "repeat", "as_strided",
    "gather", "index_select", "index", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "zeros", "ones", "full", "empty", "empty_like",
    "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_full", "new_empty", "new_empty_strided", "empty_strided", "arange",
    "scalar_tensor", "fill",
})

#: operations per output element for ops that are not 1 per element
_FLOP_WEIGHTS = {
    "sort": 8,  # stand-in for the comparator network depth
    "topk": 4,
}

#: reductions price at the INPUT size (one combine per input element)
_INPUT_SIZED = frozenset({
    "sum", "prod", "amax", "amin", "any", "all", "argmax", "argmin",
    "cumsum", "cumprod", "cummax", "cummin", "mean", "count_nonzero",
    "nansum", "logsumexp", "max", "min",
})

#: scatters price at their updates: op -> position of the argument shaped as
#: the updates (a scatter's index, an index_add's source, the put values)
_SCATTER_UPDATES = {
    "scatter": 2, "scatter_add": 2, "scatter_reduce": 2, "index_add": 3,
    "index_copy": 3, "index_put": 2, "_index_put_impl": 2,
}


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    return []


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _numel(obj) -> int:
    return sum(t.numel() for t in _tensors(obj))


def price_op(func, args, kwargs, out) -> Tuple[int, int]:
    """(operations, bytes) of one aten op call, as the JAX model prices the
    matching primitive."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]  # in-place form
    io = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
    if name in _ZERO_FLOP:
        return 0, io
    if name in _INPUT_SIZED and not (name in ("max", "min")
                                     and func._overloadname == "other"):
        return _numel(args[:1]), io
    if name in _SCATTER_UPDATES:
        i = _SCATTER_UPDATES[name]
        upd = _numel(args[i]) if len(args) > i else 0
        if name in ("index_put", "_index_put_impl"):  # values broadcast over the indices
            upd = max([upd] + [t.numel() for t in _tensors(args[1])])
        return upd, io
    return _FLOP_WEIGHTS.get(name, 1) * _numel(out), io


# --- priced units ---------------------------------------------------------

#: a key as the JAX model prices it: two uint32 words
_KEY_BYTES = 8
#: a drawn word: JAX's draws emit uint32
_WORD_BYTES = 4


def _bits_price(n: int) -> Tuple[int, int]:
    """``random_bits``: 16 operations a word (threefry rounds); the key read,
    the words written."""
    return 16 * n, _KEY_BYTES + _WORD_BYTES * n


def _split_price(num: int) -> Tuple[int, int]:
    """``random_split``: 16 operations a key made; the key read, the keys
    written."""
    return 16 * num, _KEY_BYTES * (1 + num)


def _price_uniform(args, kwargs, out) -> Tuple[int, int]:
    """``jax.random.uniform``: ``random_bits`` and its tail of six
    elementwise ops on the n words (shift, or, sub, mul, add, max; the
    bitcast is free), each reading 8 bytes of words and a 4-byte scalar
    (the bitcast none), plus the scalar prologue: two converts and two
    broadcasts of the bounds (16 + 16 bytes) and their difference (12)."""
    n = out.numel()
    f, b = _bits_price(n)
    return f + 6 * n + 3, b + 56 * n + 68


def _price_randint(args, kwargs, out) -> Tuple[int, int]:
    """``jax.random.randint``: a 2-way split, two ``random_bits`` and the
    multiply-mod tail of seven elementwise ops on the n words (three rem,
    mul, add, convert, add: 60 bytes a word), plus 20 scalar ops on the
    bounds (the clips, converts, compares and selects: 336 bytes with the
    split keys' slices)."""
    n = out.numel()
    sf, sb = _split_price(2)
    f, b = _bits_price(n)
    return sf + 2 * f + 7 * n + 20, sb + 2 * b + 60 * n + 336


def _price_top_k(args, kwargs, out) -> Tuple[int, int]:
    """``lax.top_k``: 4 operations an output element (values and indices);
    the input read, the values and JAX's int32 indices written."""
    vals, idx = out
    return 4 * (vals.numel() + idx.numel()), _nbytes(args[0]) + _nbytes(vals) + 4 * idx.numel()


def _sort_compares(k: int) -> int:
    return k * math.ceil(math.log2(max(k, 1)))


def _price_swim(args, kwargs, out) -> Tuple[int, int]:
    """The swim kernel at the worst case: every channel valid on every row
    (a merge of ~10 operations a slot, packed ~14 an entry), ~30 a slot for
    timers, budget and stores, ~60 a row; every operand read and every
    result written once."""
    consts, tensors = args[0], args[1:]
    mem_id, ch_valid = tensors[0], tensors[18]
    n, m = mem_id.shape
    pig_k = int(consts[4]) if len(consts) > 4 else 0
    merge = 14 * pig_k if pig_k else 10 * m
    return len(ch_valid) * n * merge + n * (30 * m + 60), _nbytes(tensors) + _nbytes(out)


def _price_ingest(args, kwargs, out) -> Tuple[int, int]:
    """The ingest kernel at the worst case: every message live and fresh on
    a valid cell, the queue taking min(m, Q) of them (the operation count
    of ``chip_smoke.py``'s kernel table at that data); every operand read
    and every result written once."""
    p, x = args
    n, m = x.origin.shape
    c, q, r = p.n_cells, p.q_slots, p.pig_r
    log_q = math.ceil(math.log2(max(q, 1)))
    enq = min(m, q)
    ops = (15 * n * m + 2 * n * _sort_compares(m) + 11 * n * m + 12 * n * m
           + 2 * n * c + 2 * n * q + 2 * q * n * min(enq, log_q) + 3 * n * enq
           + n * p.n_origins * (12 + 9 * p.seen_words))
    if r:
        ops += n * (2 * q * log_q + 2 * q * min(r, log_q) + 4 * q + 15 * r)
    return ops, _nbytes(tuple(x)) + _nbytes(tuple(out))


#: unit name -> price(args, kwargs, out) -> (operations, bytes)
UNIT_PRICES: Dict[str, Callable] = {
    "bits": lambda a, k, out: _bits_price(out.numel()),
    "uniform": _price_uniform,
    "randint": _price_randint,
    "split": lambda a, k, out: _split_price(int(out.shape[0])),
    "fold_in": lambda a, k, out: (16, 2 * _KEY_BYTES + _WORD_BYTES),
    "top_k": _price_top_k,
    "swim_tables": _price_swim,
    "ingest": _price_ingest,
}

#: the kernel units (their calls can be kept for a per-call report)
KERNEL_UNITS = ("swim_tables", "ingest")


@dataclasses.dataclass(frozen=True)
class CostCount:
    """One run's priced totals (the unit every fit interpolates)."""

    flops: int
    hbm_bytes: int
    eqns: int

    def minus(self, other: "CostCount") -> "CostCount":
        return CostCount(self.flops - other.flops, self.hbm_bytes - other.hbm_bytes,
                         self.eqns - other.eqns)


class Counter(TorchDispatchMode):
    """Prices what runs inside ``with Counter() as c:`` on this thread:
    every aten op, and the priced units as one call each. ``keep`` names
    units whose calls are kept in :attr:`calls` as ``(name, args, kwargs,
    out, operations, bytes)``."""

    def __init__(self, keep: Sequence[str] = ()):
        super().__init__()
        self.keep = frozenset(keep)
        self.flops = 0
        self.hbm_bytes = 0
        self.eqns = 0
        self.in_unit = False
        self.units: collections.Counter = collections.Counter()
        self.arms: collections.Counter = collections.Counter()
        self.calls: list = []

    def __enter__(self):
        out = super().__enter__()
        _units.push(self)
        return out

    def __exit__(self, *exc):
        _units.pop(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.in_unit:
            flops, nbytes = price_op(func, args, kwargs, out)
            self.flops += flops
            self.hbm_bytes += nbytes
            self.eqns += 1
        return out

    def add_unit(self, name: str, args, kwargs, out) -> None:
        flops, nbytes = UNIT_PRICES[name](args, kwargs, out)
        self.flops += flops
        self.hbm_bytes += nbytes
        self.eqns += 1
        self.units[name] += 1
        if name in self.keep:
            self.calls.append((name, args, kwargs, out, flops, nbytes))

    def add_arm(self, name: str) -> None:
        self.arms[name] += 1

    def count(self) -> CostCount:
        return CostCount(self.flops, self.hbm_bytes, self.eqns)


# --------------------------------------------------------------------------
# the priced entry-point registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PricedEntry:
    """One hot entry point's pricing recipe. ``build(cfg, rounds, device)``
    makes the state and inputs (not counted) and returns the call to count;
    ``scanned`` entries run ``rounds`` rounds (per round = 2 minus 1),
    step entries one. ``template`` builds the config family the fit sweeps:
    only the extents are rebound. Every port entry is exactly polynomial
    (``exact_fit``): the kernel units carry no grid ceil-division, where the
    JAX package's Pallas trace of ``fused_scale_run`` does."""

    name: str
    root: str
    extents: Tuple[str, ...]
    scanned: bool
    template: Callable[[], object]
    build: Callable[[object, int, object], Callable[[], object]]
    exact_fit: bool = True


def _flagship_cfg():
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    return scale_sim_config(100_000)


def _full_cfg():
    from corrosion_tpu_torch.sim.config import SimConfig

    return SimConfig(n_nodes=12, n_origins=4, n_rows=4, n_cols=2, tx_max_cells=2)


def _with(factory, **knobs):
    def template():
        return dataclasses.replace(factory(), **knobs).validate()

    return template


def config_at(template, env: Dict[str, int]):
    """The template config with its extents rebound (validated)."""
    kw = {}
    if "N" in env:
        kw["n_nodes"] = int(env["N"])
    if "M" in env and hasattr(template, "m_slots"):
        kw["m_slots"] = int(env["M"])
    return dataclasses.replace(template, **kw).validate()


def _start_now(cfg, rounds_before: int) -> int:
    """The smallest ``now`` >= 0 from which the round after
    ``rounds_before`` others gates as a sync (and sweep) round."""
    period = max(1, cfg.sync_interval) * max(1, getattr(cfg, "sync_sweep_every", 0))
    gate = rounds_before + 1
    return period * -(-gate // period) - gate


def _at_now(st, now: int):
    crdt = st.crdt._replace(now=torch.full((), now, dtype=torch.int32,
                                           device=st.crdt.now.device))
    return st._replace(crdt=crdt)


def _scale_state(cfg, rounds_before: int, dev):
    from corrosion_tpu_torch.sim.scale_step import ScaleSimState
    from corrosion_tpu_torch.sim.transport import NetModel

    st = _at_now(ScaleSimState.create(cfg, dev), _start_now(cfg, rounds_before))
    return st, NetModel.create(cfg.n_nodes, drop_prob=0.05, device=dev)


def _build_scale_step(cfg, rounds: int, device):
    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch._device import resolve_device
    from corrosion_tpu_torch.sim.scale_step import ScaleRoundInput, scale_sim_step

    dev = resolve_device(device)
    st, net = _scale_state(cfg, 0, dev)
    inp = ScaleRoundInput.quiet(cfg, dev)
    key = prng.key(0)
    return lambda: scale_sim_step(cfg, st, net, key, inp)


def _scale_run_build(carry: bool):
    def build(cfg, rounds: int, device):
        from corrosion_tpu_torch import random as prng
        from corrosion_tpu_torch._device import resolve_device
        from corrosion_tpu_torch.sim.scale_step import (
            make_write_inputs,
            scale_run_rounds,
            scale_run_rounds_carry,
        )

        dev = resolve_device(device)
        # the priced (marginal) round is the second of two
        st, net = _scale_state(cfg, 1, dev)
        writers = torch.arange(cfg.n_nodes, device=dev) < cfg.n_origins
        inputs = make_write_inputs(cfg, prng.key(8), rounds,
                                   writers[None, :].expand(rounds, -1), dev)
        run = scale_run_rounds_carry if carry else scale_run_rounds
        key = prng.key(0)
        return lambda: run(cfg, st, net, key, inputs)

    return build


def _build_full_step(cfg, rounds: int, device):
    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch._device import resolve_device
    from corrosion_tpu_torch.sim.step import RoundInput, SimState, sim_step
    from corrosion_tpu_torch.sim.transport import NetModel

    dev = resolve_device(device)
    st = _at_now(SimState.create(cfg, device=dev), _start_now(cfg, 0))
    net = NetModel.create(cfg.n_nodes, device=dev)
    inp = RoundInput.quiet(cfg, dev)
    key = prng.key(0)
    return lambda: sim_step(cfg, st, net, key, inp)


_build_scale_run = _scale_run_build(carry=False)
_build_scale_run_carry = _scale_run_build(carry=True)

#: every hot entry point, priced, under the JAX package's names.
#: ``sharded_scale_run`` prices the single-device ``scale_run_rounds``: the
#: program is placement-independent. ``fused_scale_run`` is the same program
#: through the kernel units (the port's route follows the config).
PRICED_ENTRY_POINTS: Dict[str, PricedEntry] = {
    "full_sim_step": PricedEntry(
        "full_sim_step", "SimState", ("N",), False, _full_cfg, _build_full_step),
    "scale_sim_step": PricedEntry(
        "scale_sim_step", "ScaleSimState", ("N", "M"), False,
        _flagship_cfg, _build_scale_step),
    "segment_dispatch": PricedEntry(
        "segment_dispatch", "ScaleSimState", ("N", "M"), True,
        _flagship_cfg, _build_scale_run_carry),
    "segmented_soak": PricedEntry(
        "segmented_soak", "ScaleSimState", ("N", "M"), True,
        _flagship_cfg, _build_scale_run_carry),
    "sharded_scale_run": PricedEntry(
        "sharded_scale_run", "ScaleSimState", ("N", "M"), True,
        _flagship_cfg, _build_scale_run),
    "fused_scale_run": PricedEntry(
        "fused_scale_run", "ScaleSimState", ("N", "M"), True,
        _with(_flagship_cfg, fused="on"), _build_scale_run),
    "quiet_scale_run": PricedEntry(
        "quiet_scale_run", "ScaleSimState", ("N", "M"), True,
        _with(_flagship_cfg, quiet="on"), _build_scale_run_carry),
}


def _expected_arms(cfg) -> Tuple[str, ...]:
    arms = ["sync"]
    if getattr(cfg, "sync_sweep_every", 0) > 0:
        arms.append("sweep")
    if getattr(cfg, "quiet", "off") == "on":
        arms.append("dense")
    return tuple(arms)


def _count_entry(name: str, cfg, rounds: int, device="cuda") -> Counter:
    """Run one entry on ``cfg`` under a :class:`Counter` and return it."""
    run = PRICED_ENTRY_POINTS[name].build(cfg, rounds, device)
    with Counter() as counter:
        run()
    return counter


def _check_arms(name: str, arms, cfg) -> None:
    missing = [a for a in _expected_arms(cfg) if arms[a] < 1]
    if missing:
        raise RuntimeError(
            f"{name}: the priced round did not take the {missing} arm(s) "
            f"(took {dict(arms)}); the count would price a cheaper round")


def price_entry(name: str, env: Dict[str, int], rounds: int = 2, template=None,
                device="cuda") -> CostCount:
    """Price one entry at concrete extents: ``rounds`` rounds of a scan
    entry, or one step, run eagerly on ``device``."""
    entry = PRICED_ENTRY_POINTS[name]
    cfg = config_at(template if template is not None else entry.template(), env)
    return _count_entry(name, cfg, rounds if entry.scanned else 1, device).count()


def price_per_round(name: str, env: Dict[str, int], template=None,
                    device="cuda") -> CostCount:
    """The cost of ONE round at concrete extents, from eager runs on
    ``device``: scan entries run 2 rounds and 1 round from the same state
    and difference, step entries price the step; either way the priced
    round is a sync-and-sweep round (checked)."""
    entry = PRICED_ENTRY_POINTS[name]
    cfg = config_at(template if template is not None else entry.template(), env)
    if not entry.scanned:
        counter = _count_entry(name, cfg, 1, device)
        _check_arms(name, counter.arms, cfg)
        return counter.count()
    two = _count_entry(name, cfg, 2, device)
    one = _count_entry(name, cfg, 1, device)
    _check_arms(name, two.arms - one.arms, cfg)
    return two.count().minus(one.count())


# --------------------------------------------------------------------------
# exact polynomial fits over the extents
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostFit:
    """An exact interpolating polynomial for one entry × metric.

    ``basis`` holds monomial exponent tuples aligned with ``extents``
    (``((0, 0), (1, 0), (0, 1), (1, 1))`` = 1, N, M, NM). ``exact`` is True
    when every held-out point reproduced exactly: the proof that the count
    IS this polynomial on the swept family."""

    entry: str
    metric: str
    extents: Tuple[str, ...]
    basis: Tuple[Tuple[int, ...], ...]
    coeffs: Tuple[Fraction, ...]
    points: Tuple[Tuple[int, ...], ...]
    holdouts: Tuple[Tuple[int, ...], ...]
    exact: bool

    def at(self, env: Dict[str, int]) -> int:
        total = Fraction(0)
        for expts, c in zip(self.basis, self.coeffs):
            term = c
            for sym, e in zip(self.extents, expts):
                term *= Fraction(env[sym]) ** e
            total += term
        if total.denominator != 1:
            raise ValueError(f"non-integer cost at {env}: {total}")
        return int(total)

    def degree(self, sym: str) -> int:
        if sym not in self.extents:
            return 0
        i = self.extents.index(sym)
        return max((e[i] for e, c in zip(self.basis, self.coeffs) if c != 0), default=0)

    def render(self) -> str:
        parts = []
        for expts, c in zip(self.basis, self.coeffs):
            if c == 0:
                continue
            mono = "*".join(sym if e == 1 else f"{sym}^{e}"
                            for sym, e in zip(self.extents, expts) if e)
            parts.append(f"{c}{'*' + mono if mono else ''}")
        return " + ".join(parts) or "0"


def _solve(rows: List[List[Fraction]], ys: List[Fraction]) -> List[Fraction]:
    """Exact Gaussian elimination (the systems are 3x3 / 4x4)."""
    n = len(rows)
    aug = [list(r) + [y] for r, y in zip(rows, ys)]
    for i in range(n):
        piv = next((r for r in range(i, n) if aug[r][i] != 0), None)
        if piv is None:
            raise ValueError("singular fit system: degenerate points")
        aug[i], aug[piv] = aug[piv], aug[i]
        inv = aug[i][i]
        aug[i] = [x / inv for x in aug[i]]
        for r in range(n):
            if r != i and aug[r][i] != 0:
                f = aug[r][i]
                aug[r] = [a - f * b for a, b in zip(aug[r], aug[i])]
    return [aug[r][n] for r in range(n)]


def _fit_points(entry: PricedEntry, template):
    """(basis, fit points, holdout points) for the entry's extents, the JAX
    package's, scaled so every point validates against the template."""
    if entry.extents == ("N",):
        # full view: quadratic in N; points respect n_origins <= N
        n0 = max(8, getattr(template, "n_origins", 4) * 2)
        return ((0,), (1,), (2,)), ((n0,), (2 * n0,), (4 * n0,)), ((3 * n0,),)
    n0 = 64
    while n0 < max(getattr(template, "n_origins", 16), 2 * getattr(template, "sync_peers", 0)):
        n0 *= 2
    m0 = getattr(template, "m_slots", 64)
    basis = ((0, 0), (1, 0), (0, 1), (1, 1))
    pts = ((n0, m0), (2 * n0, m0), (n0, 2 * m0), (2 * n0, 2 * m0))
    return basis, pts, ((3 * n0, m0), (n0, 3 * m0))


def fit_entry(name: str, template=None, device="cuda") -> Dict[str, CostFit]:
    """Exact per-round fits for one entry, ``{"flops": CostFit, "hbm_bytes":
    CostFit}``, from counts at small points on ``device`` (CPU tensors give
    the same counts as CUDA tensors). ``exact`` records whether the
    holdouts reproduced."""
    entry = PRICED_ENTRY_POINTS[name]
    template = template if template is not None else entry.template()
    basis, pts, hold = _fit_points(entry, template)
    counts = {p: price_per_round(name, dict(zip(entry.extents, p)),
                                 template=template, device=device)
              for p in pts + hold}
    fits: Dict[str, CostFit] = {}
    for metric in ("flops", "hbm_bytes"):
        rows = [[Fraction(math.prod(int(x) ** e for x, e in zip(p, expts)))
                 for expts in basis] for p in pts]
        ys = [Fraction(getattr(counts[p], metric)) for p in pts]
        fit = CostFit(name, metric, entry.extents, basis, tuple(_solve(rows, ys)),
                      pts, hold, exact=True)
        exact = all(fit.at(dict(zip(entry.extents, h))) == getattr(counts[h], metric)
                    for h in hold)
        fits[metric] = dataclasses.replace(fit, exact=exact)
    return fits


_FIT_CACHE: Dict[object, Dict[str, CostFit]] = {}


def fit_for_config(cfg, entry: str = "sharded_scale_run",
                   device="cuda") -> Dict[str, CostFit]:
    """Fits for a live config family (a bench's provenance hook): the swept
    points keep every knob of ``cfg`` and rebind only the extents."""
    key = (entry, cfg, str(device))
    if key not in _FIT_CACHE:
        _FIT_CACHE[key] = fit_entry(entry, template=cfg, device=device)
    return _FIT_CACHE[key]


def projected_flops(cfg, n_nodes: int, entry: str = "sharded_scale_run",
                    device="cuda") -> int:
    """Per-round operations of ``cfg``'s family at N=``n_nodes``."""
    fit = fit_for_config(cfg, entry, device)["flops"]
    return fit.at({"N": n_nodes, "M": cfg.m_slots})


def roofline(entries: Sequence[str] = ("sharded_scale_run", "fused_scale_run",
                                       "quiet_scale_run"),
             device="cuda") -> dict:
    """The static 1M roofline: per-round operations and memory-model bytes
    projected to :data:`ROOFLINE_POINT` from fits on ``device``. (The JAX
    package also traces the 1M point directly; a 1M-node round runs only
    on the card, where ``chip_smoke.py``'s cost phase counts it against
    the projection.)"""
    out = {"point": dict(ROOFLINE_POINT), "entries": {}}
    for name in entries:
        fits = fit_for_config(PRICED_ENTRY_POINTS[name].template(), name, device)
        rec = {"exact_fit_expected": PRICED_ENTRY_POINTS[name].exact_fit}
        for metric, fit in fits.items():
            rec[metric + "_per_round"] = fit.at(ROOFLINE_POINT)
            rec[metric + "_poly"] = fit.render()
            rec[metric + "_fit_exact"] = fit.exact
        out["entries"][name] = rec
    return out


# --------------------------------------------------------------------------
# the degree gate (a test, where the JAX package has the cost-drift rule)
# --------------------------------------------------------------------------


def inventory_degrees(inv) -> Dict[str, int]:
    """Max per-symbol degree over an inventory's resolved leaves (a leaf's
    degree is the sum over its dims: an [N, N] plane is degree 2)."""
    degs: Dict[str, int] = {"N": 0, "M": 0}
    for leaf in inv.leaves.values():
        if leaf.dims is None:
            continue
        for sym in degs:
            degs[sym] = max(degs[sym], sum(d.degree(sym) for d in leaf.dims))
    return degs


#: state root -> (inventory mode, the config family the fits sweep)
_DEGREE_ROOTS = {
    "ScaleSimState": ("scale", _flagship_cfg),
    "SimState": ("full", _full_cfg),
}


def check_degrees() -> List[str]:
    """The state inventories must grow at exactly :data:`COST_DEGREES` in
    the extents each root's config binds: a new [N, N] plane (or a vanished
    [N, M] one) fails until the fits are re-run and the registry updated.
    The full view's config has no M (its ``last_sync`` tracks peers, N), so
    only N is held there. Returns the problems (empty: the gate passes)."""
    from corrosion_tpu_torch.analysis import shapes

    problems = []
    for root, declared in COST_DEGREES.items():
        mode, template = _DEGREE_ROOTS[root]
        inv = shapes.static_inventory(template(), mode=mode)
        got = inventory_degrees(inv)
        for sym, want in declared.items():
            if sym not in inv.bindings:
                continue
            if got.get(sym, 0) != want:
                problems.append(
                    f"{root}'s inventory is degree {got.get(sym, 0)} in {sym} but the "
                    f"committed fits price degree {want}: the roofline and the 1M "
                    "projection are stale")
    return problems
