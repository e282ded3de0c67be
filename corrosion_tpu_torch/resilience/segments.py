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

Under a mesh (a state placed with ``parallel/mesh.shard_state``) every
segment runs sharded, the checkpoint drain goes per shard (one slice file
per shard, no whole-state gather), and a resume places the restored carry
on whatever mesh it is given, bitwise the same run (``resume_segmented(...,
mesh=)``).

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
from corrosion_tpu_torch.obs.memory import state_bytes
from corrosion_tpu_torch.obs.spans import pipeline_span
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


def _mesh_run_carry(mode: str, mesh):
    """The segment dispatch on a mesh: the sharded scale round loop."""
    if mode != "scale":
        raise ValueError("a mesh runs the scale round only (the full view's "
                         "sharded_run is not ported, ROADMAP)")
    from corrosion_tpu_torch.parallel.mesh import sharded_scale_run_carry

    return lambda cfg, st, net, key, inputs: sharded_scale_run_carry(
        cfg, mesh, st, net, key, inputs)


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


def _parts(tree) -> list:
    """A tree's per-shard trees (a tree not on a mesh is its own one)."""
    from corrosion_tpu_torch.parallel.mesh import ShardedTree

    return tree.parts if isinstance(tree, ShardedTree) else [tree]


def _n_rounds(inputs) -> int:
    return int(_parts(inputs)[0].kill.shape[0])


def _pipeline_stats(quiet_mode: str = "off", async_checkpoint: bool = True,
                    kernel_route: str = "cuda", fused_mode: str = "auto") -> dict:
    """A zeroed stats record (the keys every SoakResult.stats carries)."""
    return {
        # the port's round is functional: a segment never donates its
        # carry, so ``donate`` is False and ``donated_segments`` stays 0
        "donate": False,
        "async_checkpoint": async_checkpoint,
        "fused_mode": fused_mode,
        # "cuda": the kernels launch (CUDA tensors); "plain": their plain
        # versions (CPU tensors)
        "kernel_route": kernel_route,
        "quiet_mode": quiet_mode,
        # segments the quiet="auto" resolver ran on the quiet round
        "quiet_segments": 0,
        "segments": 0,
        "donated_segments": 0,
        # retries that restarted from the host copy of the last boundary
        "carry_reuploads": 0,
        # hot-loop seconds: the host copy and writer backpressure
        "ckpt_stall_s": 0.0,
        # the writer's seconds (overlapped with the segments when async)
        "ckpt_io_s": 0.0,
        "ckpt_written": 0,
        "ckpt_overlapped_segments": 0,
        # bytes of the carry's host copies; the slices it drained into
        # (one per shard under a mesh) and the largest shard's bytes
        "ckpt_drain_bytes": 0,
        "ckpt_shards": 0,
        "ckpt_shard_bytes_max": 0,
    }


def _obs_hook(obs, name: str, **kwargs) -> None:
    """Drive one observer hook, guarded: the observability plane must
    never kill (or change the result of) the soak it observes; a raising
    hook is logged and the run goes on."""
    if obs is None:
        return
    try:
        getattr(obs, name)(**kwargs)
    except Exception:  # noqa: BLE001 — observers are caller-supplied
        logger.exception("soak observer hook %s failed; continuing", name)


def _slice_inputs(inputs, lo: int, hi: int):
    from corrosion_tpu_torch.parallel.mesh import ShardedTree

    if isinstance(inputs, ShardedTree):
        return inputs.map(lambda p, _i: _slice_inputs(p, lo, hi))
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
    transaction (the input half of the quiet predicate, one device read a
    shard)."""
    return not any(bool(torch.stack([p.kill.any(), p.revive.any(),
                                     p.write_mask.any(), p.tx_mask.any()]).any())
                   for p in _parts(seg))


def _carry_quiet(cfg, st) -> bool:
    """No alive node owes work (``scale_step._quiet_busy``)."""
    from corrosion_tpu_torch.sim.scale_step import _quiet_busy

    return not any(bool(_quiet_busy(cfg, p).any()) for p in _parts(st))


def _drain(st):
    """The carry's host copy at a boundary: owned CPU tensors, or, on a
    mesh, the per-shard drain (``parallel/mesh.host_shard_copy``).
    -> (host carry, shards, total bytes, largest shard's bytes)."""
    from corrosion_tpu_torch.parallel.mesh import ShardedTree, host_shard_copy, tree_leaves

    if not isinstance(st, ShardedTree):
        host = host_copy(st)
        total = state_bytes(host)
        return host, 1, total, total
    host = host_shard_copy(st)
    per_shard: dict = {}
    for hs in tree_leaves(host):
        for k, (_start, a) in enumerate(hs.parts):
            per_shard[k] = per_shard.get(k, 0) + int(a.nbytes)
    return host, len(per_shard), sum(per_shard.values()), max(per_shard.values())


def _observed(st):
    """What the observer's memory report reads: the state, or a mesh
    state's whole shapes on the ``meta`` device."""
    from corrosion_tpu_torch.parallel.mesh import ShardedTree

    return st.meta_tree() if isinstance(st, ShardedTree) else st


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
    db=None,
    supervisor=None,
    start_round: int = 0,
    async_checkpoint: bool = True,
    obs=None,
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
    host; with ``async_checkpoint`` (the default) serialization, hashing,
    manifest commit, ``LATEST`` and pruning run on a background writer
    overlapped with the next segment; without it the hot loop waits for
    each write (the same writer, drained after every submit). ``db`` is the
    host database each checkpoint carries (an agent's soak).

    Under ``quiet="auto"`` (scale mode, cohort sync) a segment whose
    inputs inject nothing and whose carry is quiet at the boundary runs
    the quiet round (``quiet="on"``, bitwise equal to the dense round);
    ``stats["quiet_segments"]`` counts them.

    ``obs`` (an :class:`corrosion_tpu_torch.obs.flight.SoakObserver` or
    None): each completed segment appends a flight-record line and drains
    its infos into the observer's metrics registry, and the run's end
    record lands whatever ends the run. The observer belongs to the
    caller; this function only drives its hooks. The segment dispatch,
    the carry's host copy and (in the writer) the serialize run in
    pipeline spans, labelled for ``torch.profiler`` when the observer asks.
    """
    if segment_rounds <= 0:
        raise ValueError("segment_rounds must be positive")
    from corrosion_tpu_torch.parallel.mesh import ShardedTree, device_put_shards

    mode = config_mode(cfg)
    mesh = st.mesh if isinstance(st, ShardedTree) else None
    run_carry = _run_carry_fn(mode) if mesh is None else _mesh_run_carry(mode, mesh)
    rounds = _n_rounds(inputs)
    devs = sorted({p.swim.alive.device for p in _parts(st)}, key=str)
    dev = devs[0]
    quiet_auto = (mode == "scale" and cfg.quiet == "auto"
                  and getattr(cfg, "sync_cohort", False))
    quiet_cfg = (dataclasses.replace(cfg, quiet="on").validate()
                 if quiet_auto else cfg)
    stats = _pipeline_stats(
        str(getattr(cfg, "quiet", "off")), bool(checkpoint_root and async_checkpoint),
        "cuda" if dev.type == "cuda" else "plain", str(cfg.fused))
    prof = bool(obs is not None and getattr(obs, "jax_profile", False))
    # the observer's hooks run guarded and before the writer thread
    # exists: a broken observer must neither kill the soak nor strand a
    # writer thread
    _obs_hook(obs, "open_run", cfg=cfg, mode=mode, total_rounds=rounds,
              start_round=start_round, segment_rounds=segment_rounds,
              stats=stats, state=_observed(st))
    seg_box = {"index": 0}  # read by the async writer's overlap probe
    writer = None
    if checkpoint_root:
        writer = AsyncCheckpointWriter(
            cfg, checkpoint_root, keep_last, db,
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
    crashed = False  # an exception unwound this run
    last_ckpt = None
    try:
        while completed < rounds:
            lo = completed
            seg_no = seg_box["index"] + 1  # 1-based, shared by span and record
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
                host = host_carry[0]
                return {"st": (device_put_shards(host) if mesh is not None
                               else _upload(host, dev)),
                        "key": _key_from_json(host_carry[1])}

            def seg_dispatch():
                if not box:
                    box.update(restart())
                # popped into the call: the loop owns the carry
                out = run_carry(seg_cfg, box.pop("st"), net, box.pop("key"), seg)
                for d in devs:
                    if d.type == "cuda":
                        # completion inside the supervised call: a wedged
                        # card shows up as a deadline miss here, not at the
                        # next read
                        torch.cuda.synchronize(d)
                return out

            try:
                # segments legitimately run for minutes: the slow-span
                # warning is for the host copy and the serialize
                with pipeline_span("soak.segment.dispatch", jax_profile=prof,
                                   warn_seconds=float("inf"), seg=seg_no,
                                   lo=start_round + lo, hi=start_round + hi):
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
            if checkpoint_root:
                # the only synchronous cost on the hot loop with the writer:
                # the host copy (plus backpressure while the previous
                # segment's checkpoint is still being written)
                t0 = time.perf_counter()
                with pipeline_span("soak.ckpt.drain", jax_profile=prof,
                                   warn_seconds=30.0):
                    host, n_sh, total_b, max_b = _drain(st2)
                    host_carry = (host, _key_to_json(key2))
                stats["ckpt_drain_bytes"] += total_b
                stats["ckpt_shards"] = max(stats["ckpt_shards"], n_sh)
                stats["ckpt_shard_bytes_max"] = max(stats["ckpt_shard_bytes_max"], max_b)
                writer.submit(host_carry[0], host_carry[1],
                              start_round + completed, seg_box["index"])
                if not async_checkpoint:
                    writer.drain()
                stats["ckpt_stall_s"] += time.perf_counter() - t0
                held = None
            elif supervisor is not None:
                held = (st2, key2)
            box.update(st=st2, key=key2)
            del st2, key2
            # after the checkpoint: the segment record carries this
            # segment's checkpoint facts
            _obs_hook(obs, "on_segment", seg_index=seg_no,
                      lo=start_round + lo, hi=start_round + completed,
                      infos=infos, stats=stats, state=_observed(box["st"]))
    except BaseException:
        # the run's own crash (a caller's enclosing except handler must
        # not mark a clean run crashed)
        crashed = True
        raise
    finally:
        try:
            if writer is not None:
                # drain overlapped writes; a write failure surfaces here (or
                # earlier, on submit) rather than being silently lost
                try:
                    last_ckpt = writer.close()
                except BaseException:
                    if aborted:
                        logger.exception("async checkpoint drain failed")
                    else:
                        crashed = True
                        raise
                stats["ckpt_io_s"] = writer.io_seconds
                stats["ckpt_written"] = writer.written
                stats["ckpt_overlapped_segments"] = writer.overlapped
        finally:
            # the end record lands whatever ended the run
            _obs_hook(obs, "end_run", stats=stats,
                      completed_rounds=start_round + completed,
                      aborted=aborted, crashed=crashed and not aborted,
                      checkpoint=last_ckpt)
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


def restore_soak_carry(cfg, checkpoint_root: str, *, device="cuda", mesh=None):
    """Restore the newest valid soak checkpoint under
    ``checkpoint_root`` onto ``device`` (or placed on ``mesh``, whatever
    mesh saved it) without running anything: the restore gate of
    :func:`resume_segmented`.

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
    manifest, state = load_checkpoint(path, verify=False, device=device, mesh=mesh)
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
    db=None,
    supervisor=None,
    async_checkpoint: bool = True,
    obs=None,
    mesh=None,
) -> SoakResult:
    """Resume a segmented run from the newest valid checkpoint under
    ``checkpoint_root``, on ``net``'s device, or, with ``mesh``, placed on
    that mesh whatever mesh saved it (8 shards to 4, 1-D to ``(dcn,
    node)``, mesh to one device and back): the resumed run is bitwise the
    uninterrupted one.

    ``inputs`` is the FULL run's input stack (the one the interrupted run
    was started with); the restored ``completed_rounds`` selects the
    remaining slice. The restored carry (state + PRNG key) continues the
    original run bit for bit. Returned ``infos`` cover only the rounds run
    by THIS call.

    Raises ``FileNotFoundError`` when no restorable checkpoint exists
    and ``ValueError`` on config drift."""
    carry = list(restore_soak_carry(cfg, checkpoint_root,
                                    device=_parts(net)[0].partition.device,
                                    mesh=mesh))
    completed, path = carry[2], carry[3]
    rounds = _n_rounds(inputs)
    logger.info("resuming soak from %s at round %d/%d", path, completed,
                rounds)
    if completed >= rounds:
        return SoakResult(carry[0], carry[1], {}, completed, False, path,
                          stats=_pipeline_stats(async_checkpoint=async_checkpoint))
    # the restored carry is popped into the call, so this frame does not
    # hold it while the run goes on
    return run_segmented(
        cfg, carry.pop(0), net, carry.pop(0),
        _slice_inputs(inputs, completed, rounds),
        segment_rounds, checkpoint_root=checkpoint_root,
        keep_last=keep_last, db=db, supervisor=supervisor,
        start_round=completed, async_checkpoint=async_checkpoint, obs=obs,
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
