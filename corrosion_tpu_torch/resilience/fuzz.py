"""corrofuzz: property-based chaos over the scenario grammar (port of
``corrosion_tpu/resilience/fuzz.py``).

The registry (``resilience/chaos.py``) covers each fault axis once; this
module searches the interleaving space: a seeded generator draws a
random-but-valid :class:`~corrosion_tpu_torch.resilience.chaos.ScenarioScript`
composing device-plane phases (kill/revive, partition, loss, HLC skew) with
host-plane injections (both crash seams, checkpoint corruption, remesh,
fused and quiet flips), and the three chaos oracles judge it.

Determinism: ``gen_script(seed, profile)`` is a pure function of its
arguments (``random.Random(seed)`` drives every draw; the generator is the
JAX package's, so a seed gives the same script in both packages), and the
generated script runs under ``run_scenario(script, seed=seed)``, itself
pure in ``(script, seed)``. A drawn remesh runs its chaos leg on a mesh
of that many shards (on the run's device, repeated); a flip to
``fused="off"``/``"interpret"`` is a skip in the port (``chaos._port_skip``).

**Validity by construction.** Phase ``rounds`` are multiples of
``segment_rounds``; crash seams and corruption only target phases with at
least two cumulative committed segments, so recovery always has a prior
segment to land on; kills draw only from non-seed nodes and every
kill-bearing script ends with a revive and heal phase; at most one crash
seam a phase.

**The N ladder** prices each rung by the bytes of one state replica at the
chaos shapes (a state built on the ``meta`` device: shapes and dtypes, no
storage); rungs past ``FAST_LADDER_BYTES`` are slow. The fast profile draws
from the fast rungs; the ``scale`` profile climbs to 4096 nodes.

**The shrinker** delta-debugs a failing script to a 1-minimal reproducer
(drop phases, drop injections, halve rounds, shrink N, zero fault knobs),
restarting from every smaller script that still fails. Reproducers go
through ``script_to_json`` into ``tests/chaos_corpus/`` and replay with
``python -m corrosion_tpu_torch chaos --script FILE``.

``broken_corruption_oracle`` is the mutation fixture that proves the
find, shrink and replay pipeline is live: it blinds the corruption
injector, so any script with a ``corrupt_checkpoint`` injection fails its
verdict, and the shrinker must carve everything else away.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import random
from typing import Callable, Optional, Tuple

from corrosion_tpu_torch.resilience import chaos
from corrosion_tpu_torch.resilience.chaos import (
    Injection,
    ScenarioScript,
    scenario_config,
    script_from_json,
    script_to_json,
)
from corrosion_tpu_torch.sim.scenario import FaultPhase
from corrosion_tpu_torch.utils.tracing import logger

#: corpus file schema (the envelope around the script JSON; the script
#: itself carries chaos.SCRIPT_SCHEMA_VERSION)
CORPUS_SCHEMA_VERSION = 1

#: the N rungs the generator may draw (24 = the registry's N; capped where
#: a CPU sweep stays tractable)
LADDER_RUNGS = (24, 64, 256, 1024, 4096)

#: rungs whose state exceeds this are slow: they never enter the fast
#: profile's draw
FAST_LADDER_BYTES = 1 << 17  # 128 KiB of state: N<=64 at the chaos shapes


def fuzz_ladder():
    """Price every rung: -> tuple of ``{"n_nodes", "bytes", "slow"}``.

    ``bytes`` is the static projection of one state replica at the chaos
    shapes (:func:`scenario_config`, ``obs.memory.projected_bytes``: no
    storage is allocated); ``slow`` marks rungs past
    :data:`FAST_LADDER_BYTES`. The figures equal the JAX package's."""
    out = []
    for n in LADDER_RUNGS:
        b = _rung_bytes(int(n))
        out.append({
            "n_nodes": int(n),
            "bytes": b,
            "slow": bool(b > FAST_LADDER_BYTES),
        })
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _rung_bytes(n_nodes: int) -> int:
    """Projected bytes of one state replica at ``n_nodes`` at the chaos
    shapes (a pure function of N; cached because every ``gen_script`` call
    prices the ladder). An unpriceable rung raises, never mis-bins."""
    from corrosion_tpu_torch.obs.memory import projected_bytes

    cfg = scenario_config(probe_script(n_nodes=n_nodes))
    return projected_bytes(cfg, n_nodes, mode="scale")


def probe_script(n_nodes: int = 24) -> ScenarioScript:
    """A minimal valid script at ``n_nodes``: the config probe the ladder
    pricer runs through :func:`scenario_config`."""
    return ScenarioScript(
        name=f"probe-{n_nodes}",
        phases=(FaultPhase(rounds=4),),
        n_nodes=n_nodes,
    ).validate()


# --- the generator --------------------------------------------------------

#: fused_flip transition: start mode -> flip target (the JAX package's
#: draws; both are skips in the port)
_FUSED_FLIPS = (("interpret", "off"), ("off", "interpret"))

#: quiet_flip transition: start round variant -> flip target, both
#: directions of the quiet == dense bitwise contract
_QUIET_FLIPS = (("on", "off"), ("off", "on"))

#: remesh chains: (initial mesh, boundary target), descending (the JAX
#: package's draws)
_REMESH_CHAINS = ((8, 4), (8, 2), (4, 2))


def gen_script(seed: int, profile: str = "fast") -> ScenarioScript:
    """Draw one valid random scenario, pure in ``(seed, profile)``.

    ``profile="fast"``: N from the fast ladder rungs. ``profile="scale"``:
    N may climb the whole ladder. The returned script always
    ``validate()``s and obeys the validity rules of the module docstring."""
    if profile not in ("fast", "scale"):
        raise ValueError(f"unknown fuzz profile {profile!r}")
    rng = random.Random(int(seed))
    ladder = fuzz_ladder()
    rungs = [r for r in ladder if not r["slow"]] if profile == "fast" else list(ladder)
    # weight the small rungs heavily: the interleaving space is the
    # search target, N is just the stage it plays on
    weights = [1.0 / (i + 1) ** 2 for i in range(len(rungs))]
    n_nodes = rng.choices([r["n_nodes"] for r in rungs], weights)[0]

    segment_rounds = 4
    n_phases = rng.randint(2, 3)
    phases = []
    any_kill = False
    for _ in range(n_phases):
        rounds = segment_rounds * rng.randint(1, 2)
        kill_frac = rng.choice((0.0, 0.0, 0.15, 0.25))
        if kill_frac:
            any_kill = True
        skew = rng.choice((0, 0, 1, 12))
        phases.append(FaultPhase(
            rounds=rounds,
            write_frac=rng.choice((0.1, 0.2, 0.3)),
            kill_frac=kill_frac,
            revive_killed=any_kill and rng.random() < 0.3,
            partition_groups=rng.choice((1, 1, 2, 3)),
            drop_prob=rng.choice((0.0, 0.0, 0.02, 0.1)),
            clock_skew_rounds=skew,
            clock_skew_frac=0.3 if skew else 0.0,
        ))
    # the healed tail: revive every corpse, clean network, no writes —
    # the settle budget settles data, it does not wait out churn
    phases.append(FaultPhase(rounds=8, revive_killed=any_kill))
    phases = tuple(phases)

    mesh_devices = 0
    fused = "auto"
    injections = []
    # cumulative committed segments at the END of each phase — the
    # recoverability precondition for the crash/corruption draws
    segs_through = []
    acc = 0
    for ph in phases:
        acc += ph.rounds // segment_rounds
        segs_through.append(acc)
    recoverable = [i for i in range(len(phases)) if segs_through[i] >= 2]

    crash_phases = set()
    # quiet_flip joins via its own tail draw below: sampling it here
    # would reshuffle every pre-quiet seed's rng stream and invalidate
    # the corpus
    legacy_kinds = tuple(
        k for k in chaos.INJECTION_KINDS if k != "quiet_flip")
    for kind in rng.sample(legacy_kinds,
                           k=rng.choice((0, 1, 1, 2))):
        if kind in ("crash_slice", "crash_manifest"):
            open_phases = [p for p in recoverable if p not in crash_phases]
            if not open_phases:
                continue
            phase = rng.choice(open_phases)
            crash_phases.add(phase)
            injections.append(Injection(kind=kind, phase=phase))
        elif kind == "corrupt_checkpoint":
            if not recoverable:
                continue
            injections.append(Injection(
                kind=kind, phase=rng.choice(recoverable)))
        elif kind == "preempt":
            injections.append(Injection(
                kind=kind, phase=rng.choice(recoverable or [0])))
        elif kind == "remesh":
            mesh_devices, target = rng.choice(_REMESH_CHAINS)
            injections.append(Injection(
                kind=kind, phase=rng.randrange(len(phases) - 1),
                mesh_devices=target))
        elif kind == "fused_flip":
            fused, target = rng.choice(_FUSED_FLIPS)
            injections.append(Injection(
                kind=kind, phase=rng.randrange(len(phases) - 1),
                fused=target))
    # the quiet axis, drawn at the end of the rng stream so every seed
    # drawn before it existed still generates its historical script:
    # either a quiet_flip lineage (both directions) or a static
    # non-default round variant for the whole scenario
    quiet = "auto"
    if rng.random() < 0.25:
        quiet, target = rng.choice(_QUIET_FLIPS)
        injections.append(Injection(
            kind="quiet_flip", phase=rng.randrange(len(phases) - 1),
            quiet=target))
    elif rng.random() < 0.25:
        quiet = rng.choice(("on", "off"))
    injections.sort(key=lambda i: (i.phase, i.kind))

    return ScenarioScript(
        name=f"fuzz-{int(seed):06d}",
        phases=phases,
        injections=tuple(injections),
        n_nodes=n_nodes,
        segment_rounds=segment_rounds,
        mesh_devices=mesh_devices,
        fused=fused,
        quiet=quiet,
    ).validate()


def run_fuzz(seeds, profile: str = "fast", device="cuda"):
    """Sweep a fuzz-seed budget on ``device``; -> one verdict case per seed
    plus the ``per_seed`` map (verdict, rounds to convergence and
    quiescence), the chaos sweep record's shape. A failing case carries
    its script's JSON (``script_to_json``), so a failure carries its
    reproducer before anyone runs the shrinker."""
    seeds = [int(s) for s in seeds]
    cases = []
    for seed in seeds:
        script = gen_script(seed, profile=profile)
        rec = chaos.run_scenario(script, seed=seed, device=device)
        case = {
            "name": script.name,
            "seed": seed,
            "n_nodes": script.n_nodes,
            "phases": len(script.phases),
            "injections": [i.kind for i in script.injections],
            "trace_digest": rec.get("trace_digest"),
            "ok": bool(rec["ok"]),
            "skipped": rec.get("skipped"),
            "rounds_to_convergence": rec.get("rounds_to_convergence", -1),
            "rounds_to_quiescence": rec.get("rounds_to_quiescence", -1),
        }
        if rec.get("problems"):
            case["problems"] = rec["problems"]
            case["script"] = script_to_json(script)
        cases.append(case)
        logger.info("corrofuzz seed %d (%s): %s", seed, script.name,
                    "ok" if case["ok"] else "FAIL")
    return {
        "metric": "chaos_fuzz",
        "profile": profile,
        "platform": chaos.platform_name(device),
        "seeds": seeds,
        "ladder": list(fuzz_ladder()),
        "cases": cases,
        "per_seed": {
            str(c["seed"]): {
                "ok": c["ok"],
                "rounds_to_convergence": c["rounds_to_convergence"],
                "rounds_to_quiescence": c["rounds_to_quiescence"],
            }
            for c in cases
        },
        "ok": all(c["ok"] for c in cases),
    }


# --- the shrinker ---------------------------------------------------------

#: oracle runs one shrink may spend
SHRINK_MAX_RUNS = 200


def _drop_phase(script: ScenarioScript, i: int) -> ScenarioScript:
    """Drop phase ``i``; injections targeting it go with it, later
    injections re-index down one."""
    phases = script.phases[:i] + script.phases[i + 1:]
    injections = tuple(
        dataclasses.replace(inj, phase=inj.phase - (1 if inj.phase > i else 0))
        for inj in script.injections if inj.phase != i
    )
    return dataclasses.replace(script, phases=phases, injections=injections)


def grammar_valid(script: ScenarioScript) -> bool:
    """The validity-by-construction rules the generator obeys, as a
    predicate — the shrinker must stay inside the same grammar.
    Structural validity is ``validate()``'s job; this checks the
    SEMANTIC rules: crash/corruption only where at least two cumulative
    committed segments exist to recover to, one crash seam per phase.
    (Without this gate a shrink judged under the mutation fixture —
    whose failure needs no recovery at all — happily reduces a
    corruption script to a single committed segment, and the resulting
    "reproducer" fails the HEALTHY engine too: corrupting the only
    checkpoint leaves nothing to fall back to.)"""
    segs = 0
    segs_through = []
    for ph in script.phases:
        segs += ph.rounds // script.segment_rounds
        segs_through.append(segs)
    crash_phases = []
    for inj in script.injections:
        if inj.kind in ("crash_slice", "crash_manifest",
                        "corrupt_checkpoint"):
            if segs_through[inj.phase] < 2:
                return False
        if inj.kind in ("crash_slice", "crash_manifest"):
            crash_phases.append(inj.phase)
    return len(crash_phases) == len(set(crash_phases))


def _shrink_candidates(script: ScenarioScript):
    """Every single-step reduction of ``script``, simplest-first.
    The shrink loop keeps only candidates that ``validate()`` AND stay
    :func:`grammar_valid` — a reproducer outside the generator's
    grammar is not a finding, it is a malformed script."""
    # 1. drop a whole phase
    if len(script.phases) > 1:
        for i in range(len(script.phases)):
            yield _drop_phase(script, i)
    # 2. drop an injection
    for i in range(len(script.injections)):
        yield dataclasses.replace(
            script,
            injections=script.injections[:i] + script.injections[i + 1:],
        )
    # 3. halve a phase's rounds (floor: one segment)
    for i, ph in enumerate(script.phases):
        if ph.rounds > script.segment_rounds:
            smaller = max(
                script.segment_rounds,
                (ph.rounds // 2) // script.segment_rounds
                * script.segment_rounds,
            )
            yield dataclasses.replace(script, phases=(
                script.phases[:i]
                + (dataclasses.replace(ph, rounds=smaller),)
                + script.phases[i + 1:]
            ))
    # 4. shrink N down the ladder
    lower = [r for r in LADDER_RUNGS if r < script.n_nodes]
    if lower:
        yield dataclasses.replace(script, n_nodes=max(lower))
    # 5. zero one fault knob of one phase
    zeroed = dict(write_frac=0.0, kill_frac=0.0, revive_killed=False,
                  partition_groups=1, drop_prob=0.0, clock_skew_rounds=0,
                  clock_skew_frac=0.0)
    for i, ph in enumerate(script.phases):
        for field, z in zeroed.items():
            if getattr(ph, field) != z:
                yield dataclasses.replace(script, phases=(
                    script.phases[:i]
                    + (dataclasses.replace(ph, **{field: z}),)
                    + script.phases[i + 1:]
                ))
    # 6. drop the mesh / pin the execution mode when no injection
    #    still needs them
    kinds = {i.kind for i in script.injections}
    if script.mesh_devices and "remesh" not in kinds:
        yield dataclasses.replace(script, mesh_devices=0)
    if script.fused != "auto" and "fused_flip" not in kinds:
        yield dataclasses.replace(script, fused="auto")
    if script.quiet != "auto" and "quiet_flip" not in kinds:
        yield dataclasses.replace(script, quiet="auto")


def shrink(script: ScenarioScript, seed: int,
           failing: Optional[Callable[[ScenarioScript], bool]] = None,
           device="cuda") -> Tuple[ScenarioScript, int]:
    """Delta-debug ``script`` to a 1-minimal failing reproducer.

    ``failing(candidate) -> bool`` re-runs the oracles (default: the
    full three-oracle :func:`chaos.run_scenario` verdict at ``seed`` on
    ``device``)
    — every accepted reduction is *re-verified*, the shrinker never
    assumes monotonicity. Greedy fixpoint: restart the candidate walk
    from every smaller script that still fails; stop when no
    single-step reduction reproduces (1-minimality) or the
    :data:`SHRINK_MAX_RUNS` oracle budget is spent.

    -> ``(minimal_script, oracle_runs_spent)``. Raises ``ValueError``
    if the input script does not fail its oracle (nothing to shrink —
    a passing script must never enter the corpus)."""
    if failing is None:
        def failing(s: ScenarioScript) -> bool:
            rec = chaos.run_scenario(s, seed=seed, device=device)
            return not rec["ok"] and not rec.get("skipped")

    runs = 1
    if not failing(script):
        raise ValueError(
            f"script {script.name!r} passes its oracles at seed {seed}; "
            "refusing to shrink a non-failure"
        )
    current = script
    progress = True
    while progress and runs < SHRINK_MAX_RUNS:
        progress = False
        for cand in _shrink_candidates(current):
            try:
                cand.validate()
            except ValueError:
                continue
            if not grammar_valid(cand):
                continue
            runs += 1
            if failing(cand):
                logger.info(
                    "corrofuzz shrink: %d phases/%d injections/%d rounds "
                    "still fails",
                    len(cand.phases), len(cand.injections),
                    cand.total_rounds,
                )
                current = cand
                progress = True
                break
            if runs >= SHRINK_MAX_RUNS:
                break
    return dataclasses.replace(
        current, name=f"{script.name}-min"), runs


# --- the corpus -----------------------------------------------------------


def corpus_dir() -> str:
    """The committed reproducer corpus: ``tests/chaos_corpus/`` at the
    repo root (resolved relative to this file so replay works from any
    CWD)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)),
                        "tests", "chaos_corpus")


def save_reproducer(script: ScenarioScript, seed: int, note: str = "",
                    path: Optional[str] = None) -> str:
    """Serialize a shrunk reproducer into the corpus. -> the file path.

    The envelope carries the replay seed and provenance note; the
    ``script`` key is exactly :func:`script_to_json`, so
    ``python -m corrosion_tpu_torch chaos --script FILE`` replays it and the
    round-trip preserves ``trace_digest``."""
    if path is None:
        path = os.path.join(corpus_dir(), f"{script.name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "schema": CORPUS_SCHEMA_VERSION,
        "seed": int(seed),
        "note": note,
        "tier1": False,  # the tier-1 tests replay files marked true
        "script": script_to_json(script),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_reproducer(path: str) -> Tuple[ScenarioScript, int, dict]:
    """Load one corpus file. -> ``(script, seed, meta)`` where ``meta``
    is the envelope minus the script. Refuses unknown envelope schemas
    and malformed scripts loudly (``script_from_json``)."""
    with open(path) as f:
        payload = json.load(f)
    schema = int(payload.get("schema", CORPUS_SCHEMA_VERSION))
    if schema != CORPUS_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: corpus schema {schema} != {CORPUS_SCHEMA_VERSION}"
        )
    script = script_from_json(payload["script"])
    meta = {k: v for k, v in payload.items() if k != "script"}
    return script, int(payload.get("seed", 0)), meta


def iter_corpus():
    """Sorted corpus file paths (deterministic replay order)."""
    dirpath = corpus_dir()
    if not os.path.isdir(dirpath):
        return []
    return [os.path.join(dirpath, name)
            for name in sorted(os.listdir(dirpath))
            if name.endswith(".json")]


# --- the mutation fixture -------------------------------------------------


@contextlib.contextmanager
def broken_corruption_oracle():
    """Blind the corruption injector (the mutation fixture).

    Inside the context, ``chaos.corrupt_checkpoint`` is a no-op: the
    engine *believes* it corrupted the newest checkpoint, so its
    post-corruption probe finds the load succeeding and the recovery
    resuming from the "corrupted" file: any script with a
    ``corrupt_checkpoint`` injection now fails its verdict. The tests use
    it to prove that the fuzzer catches a real oracle violation and the
    shrinker carves it to a minimal reproducer: a chaos pipeline that
    cannot fail measures nothing."""
    real = chaos.corrupt_checkpoint

    def dark(path: str, *a, **k) -> None:
        logger.info("corrofuzz mutation fixture: corruption of %s "
                    "suppressed", path)

    chaos.corrupt_checkpoint = dark
    try:
        yield
    finally:
        chaos.corrupt_checkpoint = real
