"""Segmented soak runner: preemption-safe long simulations (port of
``corrosion_tpu/resilience/segments.py``).

A long run is cut into K-round segments. The full carry (state + PRNG
key) is threaded across them, so the segmented run is **bitwise
identical** to the straight one: the per-round key is split off the
carried key inside the round loop, and each loop rebuilds its host mirror
of the round counter from the state it is given. After every segment a
crash-consistent checkpoint is written (manifest last, SHA-256 hashes,
``checkpoint.py``), the atomic ``LATEST`` pointer moves, and old
checkpoints are pruned to the retention budget; a preempted run resumes
from the newest committed segment, losing at most K rounds of work (plus
the one checkpoint in flight on the writer).

A segment boundary never holds two carries on the device: the runner
hands the boundary carry to the next segment's round loop and keeps no
reference to it, so the peak is the straight loop's. A retry therefore
restarts from the host copy of the last boundary, or from the caller's
carry for the first segment (held only when a supervisor may retry;
without checkpoints a supervised run also holds each boundary carry). It
never restarts from a carry that a failed attempt may have written into.

Segments dispatch through an optional
:class:`~corrosion_tpu_torch.resilience.supervisor.Supervisor`; on retry
exhaustion the run aborts gracefully with the last committed checkpoint as
the recovery point.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.checkpoint import config_identity, config_mode, load_checkpoint
from corrosion_tpu_torch.resilience.async_ckpt import AsyncCheckpointWriter
from corrosion_tpu_torch.resilience.retention import latest_valid_checkpoint
from corrosion_tpu_torch.resilience.supervisor import SupervisorAborted
from corrosion_tpu_torch.utils import logger

#: the one key implementation the port draws with
KEY_IMPL = "threefry2x32"


class SoakResult(NamedTuple):
    state: object  # final state
    key: object  # final carried PRNG key (feed back in to continue)
    infos: dict  # per-round metrics, concatenated over the rounds RUN
    completed_rounds: int  # absolute index into the run's input stack
    aborted: bool  # True when the supervisor exhausted its retries
    checkpoint: Optional[str]  # newest committed checkpoint path
    stats: dict = {}  # pipeline facts: segments, checkpoint stall/IO


def _run_carry_fn(mode: str):
    if mode == "scale":
        from corrosion_tpu_torch.sim.scale_step import scale_run_rounds_carry

        return scale_run_rounds_carry
    from corrosion_tpu_torch.sim.step import run_rounds_carry

    return run_rounds_carry


def _key_to_json(key) -> dict:
    """Serialize a port key into the manifest, as the JAX package writes
    a typed threefry key."""
    return {"typed": True, "impl": KEY_IMPL,
            "data": [int(w) for w in key.tolist()]}


def _key_from_json(d: dict):
    # any other impl would resume a DIFFERENT key sequence (an rbg key's
    # words read as threefry) and silently break the bitwise identity; a
    # raw (untyped) key is JAX's default threefry key data
    if d.get("typed") and d.get("impl") != KEY_IMPL:
        raise ValueError(
            f"checkpoint key impl {d.get('impl')!r}: the port draws with "
            f"{KEY_IMPL} only")
    return prng.key_from_data(d["data"])


def _n_rounds(inputs) -> int:
    return int(inputs.kill.shape[0])


def _pipeline_stats(quiet_mode: str = "off") -> dict:
    """A zeroed stats record (the keys every SoakResult.stats carries)."""
    return {
        "quiet_mode": quiet_mode,
        # segments the quiet="auto" resolver ran on the quiet round
        "quiet_segments": 0,
        "segments": 0,
        # retries that restarted from the host copy of the last boundary
        "carry_reuploads": 0,
        # hot-loop seconds: the host copy and writer backpressure
        "ckpt_stall_s": 0.0,
        # the writer thread's seconds (overlapped with the segments)
        "ckpt_io_s": 0.0,
        "ckpt_written": 0,
        "ckpt_overlapped_segments": 0,
    }


def _slice_inputs(inputs, lo: int, hi: int):
    return type(inputs)(*(a[lo:hi] for a in inputs))


def _map_state(fn, st):
    return type(st)(*(
        _map_state(fn, v) if hasattr(v, "_fields")
        else tuple(fn(t) for t in v) if isinstance(v, tuple)
        else fn(v)
        for v in st
    ))


def host_copy(st):
    """The carry's host snapshot: owned CPU tensors (a copy on the CPU
    route too, so nothing aliases a live carry)."""
    return _map_state(lambda t: t.to("cpu", copy=True), st)


def _upload(host_st, dev):
    return _map_state(lambda t: t.to(dev, copy=True), host_st)


def _concat_infos(parts: list) -> dict:
    if not parts:
        return {}
    # segments on the quiet round carry ``quiet_*`` keys a dense segment
    # lacks: union the keys and zero-fill the segments without one
    keys: dict = {}
    for p in parts:
        for k, v in p.items():
            keys.setdefault(k, v.dtype)

    def col(p: dict, k: str, dt):
        if k in p:
            return p[k]
        ref = next(iter(p.values()))
        return torch.zeros(len(ref), dtype=dt, device=ref.device)

    return {k: torch.cat([col(p, k, dt) for p in parts]) for k, dt in keys.items()}


def _inputs_quiet(seg) -> bool:
    """True when the segment's inputs inject no kill, revive, write or
    transaction (the input half of the quiet predicate, one device read)."""
    return not bool(torch.stack([seg.kill.any(), seg.revive.any(),
                                 seg.write_mask.any(), seg.tx_mask.any()]).any())


def _carry_quiet(cfg, st) -> bool:
    """No alive node owes work (``scale_step._quiet_busy``)."""
    from corrosion_tpu_torch.sim.scale_step import _quiet_busy

    return not bool(_quiet_busy(cfg, st).any())


def run_segmented(
    cfg,
    st,
    net,
    key,
    inputs,
    segment_rounds: int,
    *,
    checkpoint_root: Optional[str] = None,
    keep_last: int = 3,
    supervisor=None,
    start_round: int = 0,
) -> SoakResult:
    """Run ``inputs`` (stacked per-round, leading axis = rounds) in
    K-round segments, checkpointing after each.

    Bitwise identical to the straight round loop (``scale_run_rounds`` or
    the full view's ``run_rounds``) on the same carry-in: final state
    leaves AND per-round infos. ``start_round`` offsets checkpoint round
    numbers when resuming a longer run (``resume_segmented``).

    With a ``supervisor``, each segment's dispatch rides its deadline and
    retry policy (the device is synchronised inside the supervised call);
    on exhaustion the run stops gracefully (``aborted=True``) with the
    last committed checkpoint intact and the last boundary's carry as its
    state.

    With a ``checkpoint_root`` the hot loop only copies the carry to the
    host; serialization, hashing, manifest commit, ``LATEST`` and pruning
    run on a background writer overlapped with the next segment.

    Under ``quiet="auto"`` (scale mode, cohort sync) a segment whose
    inputs inject nothing and whose carry is quiet at the boundary runs
    the quiet round (``quiet="on"``, bitwise equal to the dense round);
    ``stats["quiet_segments"]`` counts them.
    """
    if segment_rounds <= 0:
        raise ValueError("segment_rounds must be positive")
    mode = config_mode(cfg)
    run_carry = _run_carry_fn(mode)
    rounds = _n_rounds(inputs)
    dev = st.swim.alive.device
    quiet_auto = (mode == "scale" and cfg.quiet == "auto"
                  and getattr(cfg, "sync_cohort", False))
    quiet_cfg = (dataclasses.replace(cfg, quiet="on").validate()
                 if quiet_auto else cfg)
    stats = _pipeline_stats(str(getattr(cfg, "quiet", "off")))
    seg_box = {"index": 0}  # read by the async writer's overlap probe
    writer = None
    if checkpoint_root:
        writer = AsyncCheckpointWriter(
            cfg, checkpoint_root, keep_last,
            progress=lambda: seg_box["index"],
        )
    # the boundary carry lives only in ``box``; a segment takes it out, so
    # no frame here holds it while the next segment runs. ``held`` is what
    # a retry restarts from when there is no host copy: the caller's carry
    # (which the caller holds anyway), or, supervised without checkpoints,
    # each boundary carry.
    box = {"st": st, "key": key}
    held = (st, key) if supervisor is not None else None
    del st, key
    host_carry = None  # (host state, key json) at the last boundary
    info_parts: list = []
    completed = 0
    aborted = False
    last_ckpt = None
    try:
        while completed < rounds:
            hi = min(completed + segment_rounds, rounds)
            seg = _slice_inputs(inputs, completed, hi)
            quiet_now = (quiet_auto and _inputs_quiet(seg)
                         and _carry_quiet(cfg, box["st"]))
            if quiet_now:
                stats["quiet_segments"] += 1
            seg_cfg = quiet_cfg if quiet_now else cfg

            def restart():
                """A retry's carry: never the one a failed attempt held."""
                if host_carry is None:
                    return {"st": held[0], "key": held[1]}
                stats["carry_reuploads"] += 1
                logger.warning(
                    "restarting soak segment at round %d from the host "
                    "copy of its boundary", start_round + completed)
                return {"st": _upload(host_carry[0], dev),
                        "key": _key_from_json(host_carry[1])}

            def seg_dispatch():
                if not box:
                    box.update(restart())
                # popped into the call: the loop owns the carry
                out = run_carry(seg_cfg, box.pop("st"), net, box.pop("key"), seg)
                if dev.type == "cuda":
                    # completion inside the supervised call: a wedged card
                    # shows up as a deadline miss here, not at the next read
                    torch.cuda.synchronize(dev)
                return out

            try:
                if supervisor is not None:
                    (st2, key2), infos = supervisor.call(
                        seg_dispatch,
                        label=f"segment[{start_round + completed}:"
                              f"{start_round + hi}]",
                    )
                else:
                    (st2, key2), infos = seg_dispatch()
            except SupervisorAborted:
                if not box:
                    # hand back the last boundary's values, a usable state
                    box.update(restart())
                logger.exception(
                    "soak aborted at round %d; last good checkpoint: %s",
                    start_round + completed,
                    writer.last_path if writer is not None else None,
                )
                aborted = True
                break
            completed = hi
            seg_box["index"] += 1
            stats["segments"] += 1
            info_parts.append(infos)
            if writer is not None:
                # the only synchronous cost on the hot loop: the host copy
                # (plus writer backpressure while the previous segment's
                # checkpoint is still being written)
                t0 = time.perf_counter()
                host_carry = (host_copy(st2), _key_to_json(key2))
                writer.submit(host_carry[0], host_carry[1],
                              start_round + completed, seg_box["index"])
                stats["ckpt_stall_s"] += time.perf_counter() - t0
                held = None
            elif supervisor is not None:
                held = (st2, key2)
            box.update(st=st2, key=key2)
            del st2, key2
    finally:
        if writer is not None:
            # drain overlapped writes; a write failure surfaces here (or
            # earlier, on submit) rather than being silently lost
            try:
                last_ckpt = writer.close() or last_ckpt
            except Exception:
                if not aborted:
                    raise
                logger.exception("async checkpoint drain failed")
            stats["ckpt_io_s"] = writer.io_seconds
            stats["ckpt_written"] = writer.written
            stats["ckpt_overlapped_segments"] = writer.overlapped
    return SoakResult(
        state=box["st"],
        key=box["key"],
        infos=_concat_infos(info_parts),
        completed_rounds=start_round + completed,
        aborted=aborted,
        checkpoint=(last_ckpt if last_ckpt
                    else (latest_valid_checkpoint(checkpoint_root)
                          if checkpoint_root else None)),
        stats=stats,
    )


def restore_soak_carry(cfg, checkpoint_root: str, *, device="cuda"):
    """Restore the newest valid soak checkpoint under
    ``checkpoint_root`` onto ``device`` without running anything: the
    restore gate of :func:`resume_segmented`.

    -> ``(state, key, completed_rounds, path)``. Raises
    ``FileNotFoundError`` when no restorable checkpoint exists and
    ``ValueError`` on mode/config drift, a missing soak carry, or a key
    of another implementation."""
    mode = config_mode(cfg)
    path = latest_valid_checkpoint(checkpoint_root)
    if path is None:
        raise FileNotFoundError(
            f"no restorable checkpoint under {checkpoint_root!r}"
        )
    # latest_valid_checkpoint just ran the full hash pass on this path
    manifest, state = load_checkpoint(path, verify=False, device=device)
    if manifest["mode"] != mode:
        raise ValueError(
            f"checkpoint mode {manifest['mode']!r} != run mode {mode!r}"
        )
    # identity minus execution-only keys: a quiet soak's checkpoint
    # resumes dense, while any SEMANTIC drift refuses loudly
    if config_identity(manifest["sim_config"]) != config_identity(cfg):
        raise ValueError(
            "checkpoint sim config differs from the resuming run's — "
            "resuming would not reproduce the original run"
        )
    soak = (manifest.get("extra") or {}).get("soak")
    if not soak:
        raise ValueError(
            f"checkpoint {path} was not written by the segmented runner "
            f"(no soak carry in its manifest)"
        )
    return (state, _key_from_json(soak["key"]),
            int(soak["completed_rounds"]), path)


def resume_segmented(
    cfg,
    net,
    inputs,
    segment_rounds: int,
    *,
    checkpoint_root: str,
    keep_last: int = 3,
    supervisor=None,
) -> SoakResult:
    """Resume a segmented run from the newest valid checkpoint under
    ``checkpoint_root``, on ``net``'s device.

    ``inputs`` is the FULL run's input stack (the one the interrupted run
    was started with); the restored ``completed_rounds`` selects the
    remaining slice. The restored carry (state + PRNG key) continues the
    original run bit for bit. Returned ``infos`` cover only the rounds run
    by THIS call.

    Raises ``FileNotFoundError`` when no restorable checkpoint exists
    and ``ValueError`` on config drift."""
    carry = list(restore_soak_carry(cfg, checkpoint_root,
                                    device=net.partition.device))
    completed, path = carry[2], carry[3]
    rounds = _n_rounds(inputs)
    logger.info("resuming soak from %s at round %d/%d", path, completed,
                rounds)
    if completed >= rounds:
        return SoakResult(carry[0], carry[1], {}, completed, False, path,
                          stats=_pipeline_stats())
    # the restored carry is popped into the call, so this frame does not
    # hold it while the run goes on
    return run_segmented(
        cfg, carry.pop(0), net, carry.pop(0),
        _slice_inputs(inputs, completed, rounds),
        segment_rounds, checkpoint_root=checkpoint_root,
        keep_last=keep_last, supervisor=supervisor, start_round=completed,
    )


def make_soak_inputs(cfg, key, rounds: int, write_frac: float = 0.0,
                     device="cuda"):
    """Stacked per-round inputs for a soak run: quiet rounds with an
    optional ``write_frac`` of nodes issuing random single-cell writes
    each round; the same draws as the JAX package's ``make_soak_inputs``."""
    dev = resolve_device(device)
    mode = config_mode(cfg)
    if mode == "scale":
        from corrosion_tpu_torch.sim.scale_step import ScaleRoundInput as RI
    else:
        from corrosion_tpu_torch.sim.step import RoundInput as RI
    quiet = RI.quiet(cfg, dev)
    inputs = RI(*(a.expand((rounds,) + tuple(a.shape)).clone() for a in quiet))
    if write_frac <= 0.0:
        return inputs
    k_mask, k_w = prng.split(key)
    n = cfg.n_nodes
    mask = prng.uniform(k_mask, (rounds, n), dev) < write_frac
    if not getattr(cfg, "any_writer", False):
        # only the origin pool may write on the fixed-pool path
        mask = mask & (torch.arange(n, device=dev) < cfg.n_origins)[None, :]
    if mode == "scale":
        from corrosion_tpu_torch.sim.scale_step import make_write_inputs

        return make_write_inputs(cfg, k_w, rounds, mask, dev)
    k_cell, k_val = prng.split(k_w)
    return inputs._replace(
        write_mask=mask,
        write_cell=prng.randint(k_cell, (rounds, n), 0, cfg.n_cells, dev),
        write_val=prng.randint(k_val, (rounds, n), 0, 1 << 20, dev),
    )
