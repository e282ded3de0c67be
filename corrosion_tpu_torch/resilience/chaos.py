"""corrochaos: deterministic seeded fault scenarios over the segmented soak
runner (port of ``corrosion_tpu/resilience/chaos.py``).

Scenarios are data: a :class:`ScenarioScript` composes device-plane fault
phases (kills, revives, partitions, loss, HLC skew), compiled into round
inputs by ``sim/scenario.compile_scale_phase``, with host-plane injections
(a save killed mid-write or before its manifest, preemption, a corrupted
checkpoint), driven through the real segmented runner, supervisor and
async checkpoint writer, and judged by three oracles:

1. **convergence**: after the scripted phases the cluster reaches the
   converged fixpoint (``scale_crdt_metrics``) within the script's settle
   budget, and the chaos leg's post-script state is bitwise equal to an
   uninterrupted straight run of the same trace;
2. **checkpoint lineage**: every checkpoint left behind either refuses to
   load (a fault the scenario injected) or restores to a state that,
   replaying the remaining scripted rounds, lands bitwise on the
   uninterrupted run's state;
3. **quiescence**: after the settle, the per-node ``activity_masks`` of
   the alive nodes drain to zero within the same budget.

Every scenario is a pure function of ``(script, seed)``, and the port draws
what the JAX package draws: the verdict's ``trace_digest`` (the script's
JSON, then every phase's ``ScaleRoundInput`` and ``NetModel`` leaves and
skew vector, in the JAX package's leaf order and dtypes) and
``state_digest`` (the uninterrupted run's state leaves) are the JAX
package's strings for the same ``(script, seed)``, and so is the rest of
the verdict.

What the port cannot run yet is skipped (reported with ``ok: true`` and a
reason, never failed): a scenario on a device mesh or with a ``remesh``
injection (the node-axis sharding is ROADMAP Queue 1 item 14), and one
that runs or flips to ``fused="off"``/``"interpret"`` (the port has no XLA
or interpret path, ROADMAP, rules of the port). The host-plane
``serve-overload`` scenario (:mod:`.serve_overload`) runs when named.

Host-plane injections (``Injection.kind``):

- ``crash_slice`` / ``crash_manifest``: kill a save mid-write / between
  the state file and the manifest publish (the ``checkpoint._write_bytes``
  / ``checkpoint._publish_manifest`` seams); the soak resumes from the
  previous committed segment;
- ``preempt``: drop the live carry at a phase boundary and resume from the
  newest valid checkpoint;
- ``corrupt_checkpoint``: flip a byte of the newest checkpoint's state
  file; the hash gate must refuse it and recovery falls back a segment;
- ``quiet_flip``: resume under another ``quiet`` round variant;
- ``remesh``, ``fused_flip``: see the skips above.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.checkpoint import (
    CheckpointIntegrityError,
    host_arrays,
    load_checkpoint,
)
from corrosion_tpu_torch.resilience.retention import latest_valid_checkpoint
from corrosion_tpu_torch.resilience.segments import (
    _key_from_json,
    _slice_inputs,
    restore_soak_carry,
    run_segmented,
)
from corrosion_tpu_torch.resilience.supervisor import Supervisor
from corrosion_tpu_torch.sim.scenario import FaultPhase, compile_scale_phase
from corrosion_tpu_torch.utils.tracing import logger

INJECTION_KINDS = (
    "preempt",
    "crash_slice",
    "crash_manifest",
    "corrupt_checkpoint",
    "remesh",
    "fused_flip",
    "quiet_flip",
)

#: the ``fused`` modes the port refuses (``scale_step.check_slice``)
_UNPORTED_FUSED = ("off", "interpret")


@dataclasses.dataclass(frozen=True)
class Injection:
    """One host-plane fault. ``crash_*`` kinds arm a seam during phase
    ``phase`` (the checkpoint at that phase's final segment dies
    mid-commit); the other kinds apply at the boundary after phase
    ``phase`` completes."""

    kind: str
    phase: int
    mesh_devices: int = 0  # remesh target (0 = single device)
    fused: str = ""  # fused_flip target execution mode
    quiet: str = ""  # quiet_flip target round variant

    def validate(self) -> "Injection":
        if self.kind not in INJECTION_KINDS:
            raise ValueError(
                f"injection kind {self.kind!r} not in {INJECTION_KINDS}"
            )
        if self.phase < 0:
            raise ValueError(f"injection phase {self.phase} < 0")
        if self.kind == "fused_flip" and not self.fused:
            raise ValueError("fused_flip needs a target fused mode")
        if self.kind == "quiet_flip" and not self.quiet:
            raise ValueError("quiet_flip needs a target quiet mode")
        return self


@dataclasses.dataclass(frozen=True)
class ScenarioScript:
    """A whole scenario: device-plane fault phases, host-plane injections
    and the oracle budgets. Everything here is data: the verdict is a pure
    function of ``(script, seed)``."""

    name: str
    phases: Tuple[FaultPhase, ...]
    injections: Tuple[Injection, ...] = ()
    n_nodes: int = 24
    segment_rounds: int = 4
    settle_budget: int = 256  # quiet rounds allowed to reach the fixpoint
    keep_last: int = 64  # retention wide enough for the lineage oracle
    mesh_devices: int = 0  # initial mesh (0 = single device)
    fused: str = "auto"  # initial execution mode
    quiet: str = "auto"  # initial round variant
    # minimum per-info-key sums the chaos leg must report (e.g. the
    # clock-skew script must actually trip the drift gate)
    expect_info: Tuple[Tuple[str, int], ...] = ()

    def validate(self) -> "ScenarioScript":
        if not self.phases:
            raise ValueError(f"scenario {self.name!r} has no phases")
        for ph in self.phases:
            ph.validate()
        for inj in self.injections:
            inj.validate()
            if inj.phase >= len(self.phases):
                raise ValueError(
                    f"injection {inj.kind!r} targets phase {inj.phase} "
                    f"but the script has {len(self.phases)}"
                )
        if self.segment_rounds <= 0 or self.settle_budget <= 0:
            raise ValueError("segment_rounds/settle_budget must be positive")
        return self

    @property
    def total_rounds(self) -> int:
        return sum(ph.rounds for ph in self.phases)


#: script JSON schema version (``script_from_json`` refuses others)
SCRIPT_SCHEMA_VERSION = 1


def script_to_json(script: ScenarioScript) -> dict:
    """The script as plain JSON data: exactly the ``dataclasses.asdict``
    view :func:`compile_scenario` digests, plus a schema tag. A script that
    round-trips equal compiles to the same ``trace_digest``."""
    script.validate()
    return {"schema": SCRIPT_SCHEMA_VERSION, **dataclasses.asdict(script)}


def script_from_json(obj: dict) -> ScenarioScript:
    """Inverse of :func:`script_to_json` (tuples restored, unknown keys
    refused, the result validated): the loader behind corpus replay and
    ``chaos --script FILE``."""
    data = dict(obj)
    schema = int(data.pop("schema", SCRIPT_SCHEMA_VERSION))
    if schema != SCRIPT_SCHEMA_VERSION:
        raise ValueError(
            f"script schema {schema} != {SCRIPT_SCHEMA_VERSION}"
        )
    known = {f.name for f in dataclasses.fields(ScenarioScript)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(f"unknown script fields {unknown}")
    phases = tuple(FaultPhase(**p) for p in data.pop("phases", ()))
    injections = tuple(Injection(**i) for i in data.pop("injections", ()))
    expect_info = tuple(
        (str(k), int(v)) for k, v in data.pop("expect_info", ())
    )
    return ScenarioScript(
        phases=phases, injections=injections, expect_info=expect_info,
        **data,
    ).validate()


def scenario_config(script: ScenarioScript):
    """The scenario's sim config: 8 slots, 4 origins, a 4x2 grid, sync
    every 4 rounds at the script's N, plus its execution mode (the JAX
    package's chaos shapes)."""
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    return scale_sim_config(
        script.n_nodes, m_slots=8, n_origins=4, n_rows=4, n_cols=2,
        sync_interval=4, fused=script.fused, quiet=script.quiet,
    )


class PhaseTrace(NamedTuple):
    """One compiled phase: absolute round window and its inputs."""

    start: int  # absolute first round of the phase
    rounds: int
    inputs: object  # stacked ScaleRoundInput
    net: object  # the phase's constant NetModel
    skew: np.ndarray  # int32 [N] HLC units added at phase entry


def _leaf_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().numpy().tobytes()


def compile_scenario(script: ScenarioScript, seed: int, device="cuda"):
    """-> (cfg, [PhaseTrace], trace_digest), the inputs on ``device``.
    Deterministic in ``(script, seed)``: the digest hashes the script
    declaration plus every compiled input, net and skew array byte for
    byte, as the JAX package hashes them."""
    script.validate()
    dev = resolve_device(device)
    cfg = scenario_config(script)
    root_key = prng.key(seed)
    h = hashlib.sha256(f"{script.name}:{seed}".encode())
    h.update(json.dumps(dataclasses.asdict(script), sort_keys=True).encode())
    traces, dead, start = [], None, 0
    for i, ph in enumerate(script.phases):
        inputs, net, skew, dead = compile_scale_phase(
            cfg, ph, prng.fold_in(root_key, i), dead, device=dev
        )
        for leaf in tuple(inputs) + tuple(net):
            h.update(_leaf_bytes(leaf))
        h.update(skew.tobytes())
        traces.append(PhaseTrace(start, ph.rounds, inputs, net, skew))
        start += ph.rounds
    return cfg, traces, h.hexdigest()


def _run_straight(cfg, st, key, net, inputs):
    """The straight round loop over a window: -> (state, key, infos)."""
    from corrosion_tpu_torch.sim.scale_step import scale_run_rounds_carry

    (st, key), infos = scale_run_rounds_carry(cfg, st, net, key, inputs)
    return st, key, infos


def _apply_skew(st, skew: np.ndarray):
    """Host-inject clock skew: bump the skewed nodes' HLCs by the
    pre-shifted amount (a wall clock running ahead; ``hlc_fold``'s
    max-drift gate is what it sweeps against)."""
    if not skew.any():
        return st
    hlc = st.crdt.hlc
    bump = torch.from_numpy(skew).to(hlc.device)
    return st._replace(crdt=st.crdt._replace(hlc=hlc + bump))


def _phase_at(traces, pos: int) -> int:
    """Index of the phase whose round window contains ``pos``."""
    for i, tr in enumerate(traces):
        if tr.start <= pos < tr.start + tr.rounds:
            return i
    raise ValueError(f"round {pos} outside the scripted trace")


class _CrashSeam:
    """Arm one of the checkpoint crash seams against one segment
    directory; ``restore()`` always puts the real function back (the async
    writer is joined before run_segmented returns, so no write races the
    restore)."""

    def __init__(self, kind: str, target_round: int):
        import corrosion_tpu_torch.checkpoint as ckpt_mod

        self._mod = ckpt_mod
        target = f"seg-{target_round:08d}"
        if kind == "crash_manifest":
            self._attr, real = "_publish_manifest", ckpt_mod._publish_manifest

            def patched(tmp, final, _real=real):
                if target in final:
                    raise OSError(
                        f"corrochaos: killed between state write and "
                        f"manifest publish of {target}"
                    )
                return _real(tmp, final)
        else:  # crash_slice
            self._attr, real = "_write_bytes", ckpt_mod._write_bytes

            def patched(path, data, _real=real):
                if target in path and "shard-00000" in path:
                    raise OSError(
                        f"corrochaos: killed writing a state slice of "
                        f"{target}"
                    )
                return _real(path, data)

        self._real = real
        setattr(ckpt_mod, self._attr, patched)

    def restore(self) -> None:
        setattr(self._mod, self._attr, self._real)


def corrupt_checkpoint(path: str) -> str:
    """Flip a byte mid-way through the first state file the manifest
    records: the SHA-256 gate must refuse the directory on load."""
    with open(os.path.join(path, "manifest.json")) as f:
        files = sorted(json.load(f)["files"])
    if not files:
        raise ValueError(f"checkpoint {path} records no state files")
    fp = os.path.join(path, files[0])
    with open(fp, "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF
    with open(fp, "wb") as f:
        f.write(bytes(data))
    return fp


def _port_skip(script: ScenarioScript) -> Optional[str]:
    """The reason the port cannot run ``script`` yet, or None."""
    if script.mesh_devices > 0 or any(
            inj.kind == "remesh" for inj in script.injections):
        return ("needs a device mesh: the port's node-axis sharding is "
                "ROADMAP Queue 1 item 14")
    if script.fused in _UNPORTED_FUSED or any(
            inj.kind == "fused_flip" and inj.fused in _UNPORTED_FUSED
            for inj in script.injections):
        return ("runs fused='off'/'interpret': the port has no XLA or "
                "interpret path (ROADMAP, rules of the port)")
    return None


def _injected_crash(exc) -> bool:
    """True iff the exception chain carries a seam-injected kill (the
    ``corrochaos:`` marker). A genuine pipeline failure during an armed
    phase must not be taken for the scripted fault and recovered from."""
    seen: set = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if "corrochaos:" in str(exc):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def _host_leaves(st) -> list:
    """Owned host copies of the state's leaves, in the JAX package's
    leaf order and dtypes (``Book.seen`` as uint32)."""
    return [np.array(a, copy=True) for a in host_arrays(st)]


def _run_chaos_leg(cfg, script, traces, key0, root, rec, problems, dev):
    """Drive the scripted trace through the segmented runner, applying
    the host-plane injections. -> (state, key) after the final scripted
    round."""
    from corrosion_tpu_torch.sim.scale_step import ScaleSimState

    crash_by_phase = {
        inj.phase: inj for inj in script.injections
        if inj.kind in ("crash_slice", "crash_manifest")
    }
    boundary: dict = {}
    for inj in script.injections:
        if inj.kind not in ("crash_slice", "crash_manifest"):
            boundary.setdefault(inj.phase, []).append(inj)
    applied: set = set()

    run_cfg = cfg
    st = ScaleSimState.create(cfg, dev)
    key = key0
    total = script.total_rounds
    pos = 0
    info_sums: dict = {}
    while pos < total:
        phase_idx = _phase_at(traces, pos)
        tr = traces[phase_idx]
        if pos == tr.start:
            st = _apply_skew(st, tr.skew)
        inputs = _slice_inputs(tr.inputs, pos - tr.start, tr.rounds)
        crash = crash_by_phase.get(phase_idx)
        seam = None
        if crash is not None and id(crash) not in applied:
            seam = _CrashSeam(crash.kind, tr.start + tr.rounds)
        try:
            res = run_segmented(
                run_cfg, st, tr.net, key, inputs, script.segment_rounds,
                checkpoint_root=root, keep_last=script.keep_last,
                supervisor=Supervisor(), start_round=pos,
            )
        except RuntimeError as e:
            if seam is None or not _injected_crash(e):
                raise
            # the injected mid-commit kill: the run died with the target
            # segment's checkpoint uncommitted; recover as a preempted
            # soak does
            applied.add(id(crash))
            rec["faults_injected"] += 1
            seam.restore()
            seam = None
            st, key, pos, path = restore_soak_carry(run_cfg, root, device=dev)
            rec["resumes"] += 1
            logger.info("chaos %s: crashed save recovered from %s",
                        script.name, path)
            continue
        finally:
            if seam is not None:
                seam.restore()
        if seam is not None and id(crash) not in applied:
            problems.append(
                f"{crash.kind} armed for phase {phase_idx} never fired"
            )
        st, key = res.state, res.key
        pos = res.completed_rounds
        if res.aborted:
            problems.append(f"soak aborted at round {pos}")
            break
        for k, v in res.infos.items():
            info_sums[k] = info_sums.get(k, 0) + int(v.cpu().numpy().sum())
        if pos != tr.start + tr.rounds:
            continue
        for inj in boundary.get(phase_idx, []):
            if id(inj) in applied:
                continue
            applied.add(id(inj))
            rec["faults_injected"] += 1
            if inj.kind == "corrupt_checkpoint":
                newest = latest_valid_checkpoint(root)
                corrupt_checkpoint(newest)
                rec["corrupted"].append(os.path.basename(newest))
                try:
                    load_checkpoint(newest, verify=True, device="cpu")
                    problems.append(
                        f"corruption of {newest} was NOT detected"
                    )
                except CheckpointIntegrityError:
                    rec["corruptions_detected"] += 1
                st, key, pos, path = restore_soak_carry(run_cfg, root, device=dev)
                rec["resumes"] += 1
                if path == newest:
                    problems.append(
                        "recovery resumed from the corrupted checkpoint"
                    )
            elif inj.kind == "preempt":
                st, key, pos, _ = restore_soak_carry(run_cfg, root, device=dev)
                rec["resumes"] += 1
            elif inj.kind == "quiet_flip":
                # quiet <-> dense across a resume; replace from run_cfg so
                # flips compose
                run_cfg = dataclasses.replace(
                    run_cfg, quiet=inj.quiet).validate()
                st, key, pos, _ = restore_soak_carry(run_cfg, root, device=dev)
                rec["resumes"] += 1
                rec["quiet_flips"].append(inj.quiet)
            elif inj.kind == "fused_flip":  # to a mode the port runs
                run_cfg = dataclasses.replace(
                    run_cfg, fused=inj.fused).validate()
                st, key, pos, _ = restore_soak_carry(run_cfg, root, device=dev)
                rec["resumes"] += 1
                rec["fused_flips"].append(inj.fused)
    rec["info_sums"] = {k: info_sums[k] for k in sorted(info_sums)}
    for inj in script.injections:
        if id(inj) not in applied:
            problems.append(
                f"injection {inj.kind!r} at phase {inj.phase} never applied"
            )
    return st, key


def _settle(cfg, st, key, budget: int, dev, chunk: int = 8):
    """Quiet, healed rounds until the convergence predicate holds and the
    activity masks drain over the alive nodes (oracles 1 and 3 share the
    one settle budget).
    -> (rounds_to_converge or -1, converged,
        rounds_to_quiesce or -1, quiesced)."""
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        activity_masks,
        scale_crdt_metrics,
    )
    from corrosion_tpu_torch.sim.transport import NetModel

    net = NetModel.create(cfg.n_nodes, device=dev)
    quiet = ScaleRoundInput(*(a.expand((chunk,) + tuple(a.shape)).clone()
                              for a in ScaleRoundInput.quiet(cfg, dev)))

    def probe(s):
        # quiescence over ALIVE nodes: a corpse's frozen tables owe the
        # cluster nothing; alive nodes' timers about the corpse still
        # count, and drain once the purge completes
        active = torch.stack([(m & s.swim.alive).any()
                              for m in activity_masks(cfg, s).values()]).any()
        return bool(scale_crdt_metrics(cfg, s)["converged"]), bool(active)

    taken = 0
    conv_at = quiet_at = -1
    conv, active = probe(st)
    if conv:
        conv_at = 0
    if not active:
        quiet_at = 0
    while (conv_at < 0 or quiet_at < 0) and taken < budget:
        st, key, _ = _run_straight(cfg, st, key, net, quiet)
        taken += chunk
        conv, active = probe(st)
        if conv_at < 0 and conv:
            conv_at = taken
        if quiet_at < 0 and not active:
            quiet_at = taken
    return conv_at, conv_at >= 0, quiet_at, quiet_at >= 0


def _validate_lineage(cfg, script, traces, root, ref_leaves, rec, problems,
                      dev):
    """Oracle 2: every checkpoint left behind restores and replays to the
    uninterrupted run's state, or refuses loudly."""
    total = script.total_rounds
    for name in sorted(os.listdir(root)):
        if not name.startswith("seg-"):
            continue
        path = os.path.join(root, name)
        try:
            manifest, state = load_checkpoint(path, verify=True, device=dev)
        except (CheckpointIntegrityError, ValueError) as e:
            rec["checkpoints_refused"] += 1
            if name not in rec["corrupted"]:
                problems.append(
                    f"lineage: {name} refused outside an injected "
                    f"corruption: {e}"
                )
            continue
        soak = (manifest.get("extra") or {}).get("soak") or {}
        if "completed_rounds" not in soak:
            problems.append(f"lineage: {name} has no soak carry")
            continue
        pos = int(soak["completed_rounds"])
        key = _key_from_json(soak["key"])
        st = state
        while pos < total:
            tr = traces[_phase_at(traces, pos)]
            if pos == tr.start:
                st = _apply_skew(st, tr.skew)
            inputs = _slice_inputs(tr.inputs, pos - tr.start, tr.rounds)
            st, key, _ = _run_straight(cfg, st, key, tr.net, inputs)
            pos = tr.start + tr.rounds
        for i, (got, want) in enumerate(zip(host_arrays(st), ref_leaves)):
            if not np.array_equal(got, want):
                problems.append(
                    f"lineage: {name} replays to a DIVERGED state "
                    f"(leaf {i})"
                )
                break
        else:
            rec["checkpoints_validated"] += 1
    if rec["checkpoints_validated"] == 0:
        problems.append("lineage: no checkpoint survived to validate")


def run_scenario(script: ScenarioScript, seed: int = 0, device="cuda") -> dict:
    """Run one scenario end to end on ``device``; -> the verdict record
    (deterministic in ``(script, seed)``; the oracles are in the module
    docstring)."""
    dev = resolve_device(device)
    cfg, traces, digest = compile_scenario(script, seed, device=dev)
    rec = {
        "name": script.name,
        "seed": int(seed),
        "n_nodes": cfg.n_nodes,
        "trace_digest": digest,
        "rounds_scripted": script.total_rounds,
        "phases": len(script.phases),
        "faults_injected": 0,
        "resumes": 0,
        "remeshes": 0,
        "fused_flips": [],
        "quiet_flips": [],
        "corrupted": [],
        "corruptions_detected": 0,
        "checkpoints_validated": 0,
        "checkpoints_refused": 0,
    }
    skip = _port_skip(script)
    if skip:
        rec["skipped"] = skip
        rec["ok"] = True
        return rec
    root_dir = tempfile.mkdtemp(prefix=f"chaos-{script.name}-")
    root = os.path.join(root_dir, "ckpt")
    problems: list = []
    try:
        key0 = prng.key(seed + 1)
        from corrosion_tpu_torch.sim.scale_step import ScaleSimState

        # the uninterrupted reference: the same compiled trace, straight
        # through; the fixpoint both oracles are judged against
        ref_st, ref_key = ScaleSimState.create(cfg, dev), key0
        for tr in traces:
            ref_st = _apply_skew(ref_st, tr.skew)
            ref_st, ref_key, _ = _run_straight(cfg, ref_st, ref_key, tr.net,
                                               tr.inputs)
        ref_leaves = _host_leaves(ref_st)
        del ref_st
        # content digest of the fixpoint: equal across execution-only
        # knobs (quiet, fused) and equal to the JAX package's
        h = hashlib.sha256()
        for a in ref_leaves:
            h.update(a.tobytes())
        rec["state_digest"] = h.hexdigest()

        # the chaos leg: the same trace through the segmented runner with
        # the faults
        st, key = _run_chaos_leg(cfg, script, traces, key0, root, rec,
                                 problems, dev)
        mismatch = [
            i for i, (a, b) in enumerate(zip(host_arrays(st), ref_leaves))
            if not np.array_equal(a, b)
        ]
        rec["bitwise_match"] = not mismatch
        if mismatch:
            problems.append(
                f"chaos leg diverged from the uninterrupted reference "
                f"at leaves {mismatch[:4]}"
            )

        for k, want in script.expect_info:
            got = rec.get("info_sums", {}).get(k, 0)
            rec[f"observed_{k}"] = got
            if got < want:
                problems.append(
                    f"expected info {k} >= {want}, observed {got}"
                )

        # oracle 1: settle the chaos state to the converged fixpoint;
        # oracle 3: the activity masks must then drain (same quiet rounds,
        # same budget)
        settle_rounds, converged, quiesce_rounds, quiesced = _settle(
            cfg, st, key, script.settle_budget, dev)
        del st
        rec["converged"] = converged
        rec["rounds_to_convergence"] = (
            script.total_rounds + settle_rounds if converged else -1
        )
        rec["quiesced"] = quiesced
        rec["rounds_to_quiescence"] = (
            script.total_rounds + quiesce_rounds if quiesced else -1
        )
        if not converged:
            problems.append(
                f"did not converge within {script.settle_budget} settle "
                f"rounds"
            )
        if not quiesced:
            problems.append(
                f"activity masks did not drain within "
                f"{script.settle_budget} settle rounds (oracle 3)"
            )

        # oracle 2: the checkpoint lineage
        _validate_lineage(cfg, script, traces, root, ref_leaves, rec,
                          problems, dev)
    except Exception as e:
        # a broken scenario (e.g. a script whose injected crash kills the
        # first ever save, leaving nothing to resume from) fails its own
        # verdict, never the rest of a sweep
        logger.exception("chaos %s: engine error", script.name)
        problems.append(f"engine error: {e!r}")
    finally:
        shutil.rmtree(root_dir, ignore_errors=True)
    rec["ok"] = not problems
    if problems:
        rec["problems"] = problems
    return rec


# --- the scenario registry -------------------------------------------------
# The JAX package's registry: the same names and fields, so a (name, seed)
# compiles to the same trace in both packages.

SCENARIOS = {
    s.name: s.validate()
    for s in (
        # asymmetric partition that heals mid-sync: both islands keep
        # writing under loss, then the heal phase lets anti-entropy repair
        ScenarioScript(
            name="partition-heal",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3, partition_groups=2,
                           drop_prob=0.02),
                FaultPhase(rounds=8, write_frac=0.2),
                FaultPhase(rounds=8),
            ),
            expect_info=(("syncs", 1),),
        ),
        # clock skew swept against the HLC max-drift gate: under it, then
        # far past it (receivers reject the stamps; anti-entropy still
        # converges the data)
        ScenarioScript(
            name="clock-skew",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3, clock_skew_rounds=1,
                           clock_skew_frac=0.3),
                FaultPhase(rounds=8, write_frac=0.3, clock_skew_rounds=12,
                           clock_skew_frac=0.3),
                FaultPhase(rounds=8),
            ),
            expect_info=(("clock_drift_rejects", 1),),
        ),
        # a quarter of the non-seed nodes die, then rejoin under heavy
        # loss: refutation must overturn the stale Down beliefs
        ScenarioScript(
            name="rejoin-refutation",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3, kill_frac=0.25,
                           drop_prob=0.15),
                FaultPhase(rounds=8, write_frac=0.2, revive_killed=True,
                           drop_prob=0.15),
                FaultPhase(rounds=8),
            ),
            expect_info=(("refutes", 1), ("failed_probes", 1)),
        ),
        # both crash windows: a state file write dies mid-file, and a
        # later save dies between the state write and the manifest
        # publish; each time the soak resumes from the previous segment
        ScenarioScript(
            name="preempt-mid-segment",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3),
                FaultPhase(rounds=8, write_frac=0.2),
                FaultPhase(rounds=4),
            ),
            injections=(
                Injection(kind="crash_slice", phase=0),
                Injection(kind="crash_manifest", phase=1),
            ),
        ),
        # flip bytes in the newest committed checkpoint and preempt:
        # recovery must refuse it and fall back to the previous segment
        ScenarioScript(
            name="ckpt-corrupt",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3),
                FaultPhase(rounds=8, write_frac=0.1),
            ),
            injections=(
                Injection(kind="corrupt_checkpoint", phase=0),
            ),
        ),
        # elastic restore onto another mesh mid-scenario (skipped in the
        # port until item 14)
        ScenarioScript(
            name="elastic-remesh",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3),
                FaultPhase(rounds=8, write_frac=0.1),
            ),
            injections=(
                Injection(kind="remesh", phase=0, mesh_devices=4),
            ),
            mesh_devices=8,
        ),
        # fused <-> unfused flip across a resume (skipped in the port: it
        # has neither mode)
        ScenarioScript(
            name="fused-flip",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3),
                FaultPhase(rounds=8, write_frac=0.1),
            ),
            injections=(
                Injection(kind="fused_flip", phase=0, fused="off"),
            ),
            fused="interpret",
        ),
        # quiet <-> dense round flips across resumes, both directions in
        # one lineage; the write-free tail runs the quiet fixpoint path
        ScenarioScript(
            name="quiet-flip",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3),
                FaultPhase(rounds=8, write_frac=0.1),
                FaultPhase(rounds=8),
            ),
            injections=(
                Injection(kind="quiet_flip", phase=0, quiet="off"),
                Injection(kind="quiet_flip", phase=1, quiet="on"),
            ),
            quiet="on",
        ),
        # checkpoint corruption and an 8 -> 4 remesh in one lineage
        # (skipped in the port until item 14)
        ScenarioScript(
            name="corrupt-remesh",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3),
                FaultPhase(rounds=8, write_frac=0.2),
                FaultPhase(rounds=8),
            ),
            injections=(
                Injection(kind="corrupt_checkpoint", phase=0),
                Injection(kind="remesh", phase=1, mesh_devices=4),
            ),
            mesh_devices=8,
        ),
        # HLC drift past the gate while a 2-island partition is live, then
        # the heal phase must still converge
        ScenarioScript(
            name="skew-partition",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3, partition_groups=2,
                           drop_prob=0.05, clock_skew_rounds=12,
                           clock_skew_frac=0.3),
                FaultPhase(rounds=8, write_frac=0.2),
                FaultPhase(rounds=8),
            ),
            expect_info=(("clock_drift_rejects", 1), ("syncs", 1)),
        ),
        # repeated preemption across both crash windows while a quarter of
        # the non-seed nodes die and later rejoin
        ScenarioScript(
            name="preempt-storm",
            phases=(
                FaultPhase(rounds=8, write_frac=0.3, kill_frac=0.25,
                           drop_prob=0.1),
                FaultPhase(rounds=8, write_frac=0.2),
                FaultPhase(rounds=8, write_frac=0.1, revive_killed=True),
                FaultPhase(rounds=8),
            ),
            injections=(
                Injection(kind="crash_slice", phase=0),
                Injection(kind="preempt", phase=1),
                Injection(kind="crash_manifest", phase=2),
            ),
            expect_info=(("refutes", 1),),
        ),
    )
}

#: the small-N subset the tier-1 tests replay: the two host-plane families
#: (crash windows; corruption fallback)
TIER1_SCENARIOS = ("preempt-mid-segment", "ckpt-corrupt")

def _host_scenarios() -> dict:
    """Host-plane scenarios: serving-plane rigs judged by serving-plane
    oracles (no fault traces, no device-state bitwise oracle). They are not
    in the default sweep (``SCENARIOS`` stays the device-plane registry) and
    run only when named."""
    from corrosion_tpu_torch.resilience.serve_overload import run_serve_overload

    return {"serve-overload": run_serve_overload}


def run_sweep(names=None, seed: int = 0, seed_range=None,
              device="cuda") -> dict:
    """Run a set of scenarios (default: every device-plane scenario of
    ``SCENARIOS``; host-plane ones join only when named) and fold the
    verdicts into one record. ``seed_range=(a, b)`` runs every scenario
    once per seed ``a..b`` inclusive and adds a ``per_seed`` map of
    rounds-to-convergence."""
    dev = resolve_device(device)
    hosts = _host_scenarios()
    names = list(names) if names else sorted(SCENARIOS)
    for name in names:
        if name not in SCENARIOS and name not in hosts:
            raise ValueError(
                f"unknown scenario {name!r}; have "
                f"{sorted(SCENARIOS) + sorted(hosts)}"
            )
    if seed_range is not None:
        a, b = int(seed_range[0]), int(seed_range[1])
        if b < a:
            raise ValueError(f"bad seed range {a}:{b}")
        seeds = list(range(a, b + 1))
    else:
        seeds = [int(seed)]
    records = [run_scenario(SCENARIOS[name], seed=s, device=dev)
               if name in SCENARIOS else hosts[name](seed=s, device=dev)
               for s in seeds for name in names]
    out = {
        "metric": "chaos_sweep",
        "seed": int(seeds[0]),
        "platform": platform_name(dev),
        "scenarios": records,
        "ok": all(r["ok"] for r in records),
    }
    if seed_range is not None:
        out["seed_range"] = [seeds[0], seeds[-1]]
        per_seed: dict = {}
        for r in records:
            per_seed.setdefault(str(r["seed"]), {})[r["name"]] = (
                r.get("rounds_to_convergence", -1)
                if not r.get("skipped") and not r.get("host_plane") else None
            )
        out["per_seed"] = per_seed
    return out


def platform_name(dev) -> str:
    """The record's ``platform``: ``gpu`` for a CUDA card, else the device
    type (the JAX package's platform names)."""
    return "gpu" if torch.device(dev).type == "cuda" else torch.device(dev).type
