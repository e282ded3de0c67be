"""The segmented soak runner and checkpoint format 3 of the port, on the CPU
at ``tests/test_resilience.py``'s sizes (scale N=24, full view N=12).

A segmented run equals the straight round loop bit for bit, leaves and
per-round infos; checkpoints cross between the packages in both
directions (JAX writes and the port resumes, the port writes and JAX
verifies and resumes), every dtype included, and the resumed runs equal
the other package's straight runs; damaged, drifted, half-written,
mis-sliced and foreign-key checkpoints are refused; retries restart from the
host copy of the boundary. Tolerance 0."""

import dataclasses
import json
import os

import jax
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu import checkpoint as jckpt
from corrosion_tpu.resilience import segments as jseg
from corrosion_tpu.sim import config as jconfig
from corrosion_tpu.sim import scale_step as jscale
from corrosion_tpu.sim import step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import checkpoint as ckpt
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.resilience import (
    Supervisor,
    SupervisorAborted,
    latest_valid_checkpoint,
    prune_checkpoints,
    read_latest,
    resume_segmented,
    run_segmented,
    update_latest,
)
from corrosion_tpu_torch.resilience import segments
from corrosion_tpu_torch.sim import config, scale_step, step
from corrosion_tpu_torch.sim.transport import NetModel
from corrosion_tpu_torch.utils.backoff import Backoff
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROUNDS = 16
SCALE = dict(m_slots=8, n_origins=4, n_rows=4, n_cols=2, sync_interval=4)
#: name -> (mode, config overrides): the flagship's int16 tiers, the 1M
#: point's int8 tiers with bounded member piggyback, the full view at tx 2
CONFIGS = {
    "scale": ("scale", {}),
    "scale_int8": ("scale", dict(pig_members=4, narrow_int8=True, narrow_q_int8=True)),
    "full": ("full", {}),
}


def port_cfg(name):
    mode, over = CONFIGS[name]
    if mode == "scale":
        return scale_step.scale_sim_config(24, **SCALE, **over)
    return config.SimConfig(n_nodes=12, n_origins=4, n_rows=4, n_cols=2,
                            tx_max_cells=2).validate()


def jax_cfg(name):
    mode, over = CONFIGS[name]
    if mode == "scale":
        return jscale.scale_sim_config(24, **SCALE, **over)
    return jconfig.SimConfig(n_nodes=12, n_origins=4, n_rows=4, n_cols=2,
                             tx_max_cells=2)


def port_state(cfg, mode):
    if mode == "scale":
        return scale_step.ScaleSimState.create(cfg, "cpu")
    return step.SimState.create(cfg, device="cpu")


def port_straight(cfg, mode, st, net, key, inputs):
    run = scale_step.scale_run_rounds if mode == "scale" else step.run_rounds
    return run(cfg, st, net, key, inputs)


def leaves(st):
    """Numpy leaves of a port or a JAX state, in file order (the port's
    field order against ``jax.tree.leaves``)."""
    if isinstance(st, (scale_step.ScaleSimState, step.SimState)):
        return ckpt.host_arrays(st)
    return [np.asarray(x) for x in jax.tree.leaves(st)]


def assert_states_equal(a, b, what):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i, x.dtype, y.dtype)
        assert np.array_equal(x, y), f"{what}: leaf {i} differs"


def assert_infos_equal(want, got, what, lo=0):
    """Every key of ``want`` (rows ``lo:``) equals ``got``'s, by value."""
    for k in want:
        assert np.array_equal(np.asarray(want[k])[lo:], np.asarray(got[k])), (what, k)


def port_inputs(cfg, rounds=ROUNDS, write_frac=0.25):
    return segments.make_soak_inputs(cfg, prng.key(5), rounds, write_frac=write_frac,
                                     device="cpu")


def head(inputs, hi):
    return type(inputs)(*(a[:hi] for a in inputs))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def rig(request):
    """Both packages' straight runs of one configuration from fresh state,
    key 3 and ``make_soak_inputs`` at write fraction 0.25, 2 % loss."""
    name = request.param
    mode = CONFIGS[name][0]
    cfg, jcfg = port_cfg(name), jax_cfg(name)
    inputs = port_inputs(cfg)
    jinputs = jseg.make_soak_inputs(jcfg, jr.key(5), ROUNDS, write_frac=0.25, mode=mode)
    net = NetModel.create(cfg.n_nodes, drop_prob=0.02, device="cpu")
    jnet = JNet.create(cfg.n_nodes, drop_prob=0.02)
    st, infos = port_straight(cfg, mode, port_state(cfg, mode), net, prng.key(3), inputs)
    jrun = jscale.scale_run_rounds if mode == "scale" else jstep.run_rounds
    jst0 = (jscale.ScaleSimState if mode == "scale" else jstep.SimState).create(jcfg)
    jst, jinfos = jax.jit(lambda s, k, i: jrun(jcfg, s, jnet, k, i))(jst0, jr.key(3), jinputs)
    return dict(name=name, mode=mode, cfg=cfg, jcfg=jcfg, inputs=inputs,
                jinputs=jinputs, net=net, jnet=jnet, jst0=jst0, st=st,
                infos=infos, jst=jst, jinfos=jinfos)


def test_inputs_and_straight_runs_match_jax(rig):
    for a, b in zip(rig["inputs"], rig["jinputs"]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert_states_equal(rig["jst"], rig["st"], "straight")
    assert_infos_equal(rig["jinfos"], rig["infos"], "straight infos")
    assert sum(int(v.sum()) for k, v in rig["infos"].items() if k == "fresh") > 0


def test_segmented_equals_straight_and_resumes(rig, tmp_path):
    """Four segments of 4 with the async writer equal the straight run;
    a second process resumes the first half's checkpoint from disk and
    equals it too."""
    cfg, mode, net = rig["cfg"], rig["mode"], rig["net"]
    root = str(tmp_path / "soak")
    res = run_segmented(cfg, port_state(cfg, mode), net, prng.key(3), rig["inputs"],
                        4, checkpoint_root=root, keep_last=2)
    assert res.completed_rounds == ROUNDS and not res.aborted
    assert res.stats["segments"] == 4 and res.stats["ckpt_written"] == 4
    assert res.checkpoint.endswith("seg-00000016") and read_latest(root) == "seg-00000016"
    assert sorted(os.listdir(root)) == ["LATEST", "seg-00000012", "seg-00000016"]
    assert_states_equal(rig["st"], res.state, "segmented")
    assert_infos_equal(rig["infos"], res.infos, "segmented infos")

    root2 = str(tmp_path / "half")
    first = run_segmented(cfg, port_state(cfg, mode), net, prng.key(3),
                          head(rig["inputs"], 8), 8, checkpoint_root=root2)
    assert first.stats["ckpt_written"] == 1 and first.stats["ckpt_io_s"] > 0.0
    rest = resume_segmented(cfg, net, rig["inputs"], 4, checkpoint_root=root2)
    assert rest.completed_rounds == ROUNDS and rest.stats["segments"] == 2
    assert_states_equal(rig["st"], rest.state, "resumed")
    assert_infos_equal(rig["infos"], rest.infos, "resumed infos", lo=8)
    done = resume_segmented(cfg, net, rig["inputs"], 4, checkpoint_root=root2)
    assert done.completed_rounds == ROUNDS and done.infos == {}
    assert_states_equal(rig["st"], done.state, "resume of a finished run")


def test_jax_checkpoint_resumes_in_the_port(rig, tmp_path):
    """JAX's ``run_segmented`` writes ``seg-00000008``; the port resumes
    it and ends equal to JAX's straight run."""
    root = str(tmp_path / "jax")
    mode = rig["mode"]
    r1 = jseg.run_segmented(rig["jcfg"], rig["jst0"], rig["jnet"], jr.key(3),
                            jax.tree.map(lambda a: a[:8], rig["jinputs"]),
                            segment_rounds=8, mode=mode, checkpoint_root=root)
    assert r1.checkpoint.endswith("seg-00000008")
    manifest, state = ckpt.load_checkpoint(r1.checkpoint, device="cpu")
    assert manifest["format"] == 3 and manifest["mesh"] is None
    assert state.crdt.book.seen.dtype == torch.int32
    assert_states_equal(r1.state, state, "JAX's checkpoint as loaded")
    res = resume_segmented(rig["cfg"], rig["net"], rig["inputs"], 8,
                           checkpoint_root=root)
    assert res.completed_rounds == ROUNDS
    assert_states_equal(rig["jst"], res.state, "port resume of JAX's checkpoint")
    want = jax.tree.leaves(convert.as_numpy_tree(rig["jst"]))
    got = jax.tree.leaves(convert.state_to_numpy(res.state))
    assert len(want) == len(got)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(want, got))
    assert_infos_equal(rig["jinfos"], res.infos, "port resume infos", lo=8)


def test_port_checkpoint_resumes_in_jax(rig, tmp_path):
    """The port writes; JAX's ``verify_checkpoint`` accepts the directory
    and JAX's ``resume_segmented`` ends equal to the port's straight run."""
    root = str(tmp_path / "port")
    cfg, mode = rig["cfg"], rig["mode"]
    r1 = run_segmented(cfg, port_state(cfg, mode), rig["net"], prng.key(3),
                       head(rig["inputs"], 8), 8, checkpoint_root=root)
    summary = jckpt.verify_checkpoint(r1.checkpoint)
    assert summary["format"] == 3 and summary["mode"] == mode and summary["round"] == 8
    assert summary["extra"]["soak"]["key"]["impl"] == "threefry2x32"
    assert ckpt.verify_checkpoint(r1.checkpoint)["hashed_files"] == summary["hashed_files"]
    _, jstate = jckpt.load_checkpoint(r1.checkpoint)
    assert_states_equal(jstate, r1.state, "the port's checkpoint as JAX loads it")
    jres = jseg.resume_segmented(rig["jcfg"], rig["jnet"], rig["jinputs"],
                                 segment_rounds=8, checkpoint_root=root, mode=mode)
    assert jres.completed_rounds == ROUNDS
    assert_states_equal(rig["st"], jres.state, "JAX resume of the port's checkpoint")
    assert_infos_equal(jres.infos, {k: v[8:] for k, v in rig["infos"].items()},
                       "JAX resume infos")


# --- refusals ---------------------------------------------------------------


@pytest.fixture()
def two_segments(tmp_path):
    """A scale soak of 8 rounds in two committed segments of 4."""
    cfg = port_cfg("scale")
    root = str(tmp_path / "soak")
    net = NetModel.create(cfg.n_nodes, device="cpu")
    inputs = port_inputs(cfg, rounds=12)
    run_segmented(cfg, port_state(cfg, "scale"), net, prng.key(3), head(inputs, 8), 4,
                  checkpoint_root=root)
    return cfg, root, net, inputs


def _edit_manifest(path, fn):
    mp = os.path.join(path, "manifest.json")
    with open(mp) as f:
        m = json.load(f)
    fn(m)
    with open(mp, "w") as f:
        json.dump(m, f)


def test_config_drift_refused(two_segments):
    cfg, root, net, inputs = two_segments
    drift = dataclasses.replace(cfg, sync_interval=8)
    with pytest.raises(ValueError, match="config differs"):
        resume_segmented(drift, net, inputs, 4, checkpoint_root=root)
    with pytest.raises(ValueError, match="checkpoint mode 'scale' != run mode 'full'"):
        resume_segmented(port_cfg("full"), net, inputs, 4, checkpoint_root=root)
    # an execution-only key is no drift
    res = resume_segmented(dataclasses.replace(cfg, quiet="on"), net, inputs, 4,
                           checkpoint_root=root)
    assert res.completed_rounds == 12


def test_tampered_leaf_file_refused(two_segments):
    cfg, root, _, _ = two_segments
    path = os.path.join(root, "seg-00000008")
    npz = os.path.join(path, "shard-00000.npz")
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(npz, "wb") as f:
        f.write(blob)
    with pytest.raises(ckpt.CheckpointIntegrityError, match="hash mismatch"):
        ckpt.load_checkpoint(path, device="cpu")
    with pytest.raises(ckpt.CheckpointIntegrityError, match="hash mismatch"):
        ckpt.verify_checkpoint(path)
    with pytest.raises(jckpt.CheckpointIntegrityError, match="hash mismatch"):
        jckpt.verify_checkpoint(path)
    # the recovery scan falls back to the older committed segment
    assert latest_valid_checkpoint(root) == os.path.join(root, "seg-00000004")


def test_crash_mid_save_leaves_no_manifest(two_segments, monkeypatch):
    cfg, root, _, _ = two_segments
    st = port_state(cfg, "scale")

    def crash(tmp, final):
        raise OSError("simulated crash before the manifest is published")

    monkeypatch.setattr(ckpt, "_publish_manifest", crash)
    half = os.path.join(root, "seg-00000012")
    with pytest.raises(OSError):
        ckpt.save_state_checkpoint(cfg, st, 12, path=half)
    monkeypatch.undo()
    assert os.path.exists(os.path.join(half, "shard-00000.npz"))
    for check in (ckpt.verify_checkpoint, jckpt.verify_checkpoint):
        with pytest.raises(ValueError, match="no manifest"):
            check(half)
    # an overwrite removes the old manifest first: a crash there too
    # leaves the side invalid, never a stale manifest over new files
    side = os.path.join(root, "seg-00000008")
    monkeypatch.setattr(ckpt, "_publish_manifest", crash)
    with pytest.raises(OSError):
        ckpt.save_state_checkpoint(cfg, st, 12, path=side)
    monkeypatch.undo()
    with pytest.raises(ckpt.CheckpointIntegrityError):
        ckpt.load_checkpoint(side, device="cpu")
    assert latest_valid_checkpoint(root) == os.path.join(root, "seg-00000004")


@pytest.mark.parametrize("edit, exc, match", [
    (lambda m: m["extra"]["soak"]["key"].update(impl="rbg"), ValueError, "impl 'rbg'"),
    (lambda m: m.pop("extra"), ValueError, "not written by the segmented runner"),
    # a save claiming a slice of leaf 0 over four shards that its file
    # does not hold fails verification, so no candidate is left
    (lambda m: (m.update(mesh={"axis_names": ["node"], "shape": [4]}),
                m["leaves"][0].update(dim=0, axes=["node"]),
                m["slices"]["shard-00000.npz"][0].update(
                    stop=m["leaves"][0]["shape"][0] // 4)),
     FileNotFoundError, "no restorable checkpoint"),
], ids=["rbg_key", "not_a_soak", "sharded"])
def test_foreign_checkpoints_refused(two_segments, edit, exc, match):
    """An rbg key, a checkpoint that is no soak's, or a save sharded over
    four devices whose slices do not match its manifest: each refused whole
    (the manifest itself is unhashed)."""
    cfg, root, net, inputs = two_segments
    for seg in ("seg-00000004", "seg-00000008"):
        _edit_manifest(os.path.join(root, seg), edit)
    with pytest.raises(exc, match=match):
        resume_segmented(cfg, net, inputs, 4, checkpoint_root=root)
    if exc is FileNotFoundError:
        path = os.path.join(root, "seg-00000008")
        for load in (ckpt.verify_checkpoint,
                     lambda p: ckpt.load_checkpoint(p, device="cpu")):
            with pytest.raises(ckpt.CheckpointIntegrityError, match="manifest window"):
                load(path)


def test_format_2_checkpoint_loads(tmp_path):
    """A whole-state ``state.npz`` of format 2 loads as format 3 does."""
    cfg = port_cfg("scale")
    st = port_state(cfg, "scale")
    path = ckpt.save_state_checkpoint(cfg, st, 7, path=str(tmp_path / "v3"))
    v2 = str(tmp_path / "v2")
    os.makedirs(v2)
    arrays = ckpt.host_arrays(st)
    np.savez_compressed(os.path.join(v2, "state.npz"),
                        **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    for k in ("mesh", "leaves", "slices"):
        m.pop(k)
    m.update(format=2, files={"state.npz": ckpt._file_sha256(os.path.join(v2, "state.npz"))})
    with open(os.path.join(v2, "manifest.json"), "w") as f:
        json.dump(m, f)
    _, got = ckpt.load_checkpoint(v2, device="cpu")
    assert_states_equal(st, got, "format 2")
    assert ckpt.verify_checkpoint(v2)["format"] == 2


def test_retention_and_latest_pointer(tmp_path):
    cfg = port_cfg("scale")
    root = str(tmp_path)
    for r in (8, 16, 24, 32):
        ckpt.save_state_checkpoint(cfg, port_state(cfg, "scale"), r,
                                   path=os.path.join(root, f"seg-{r:08d}"))
        update_latest(root, f"seg-{r:08d}")
    assert read_latest(root) == "seg-00000032"
    pruned = prune_checkpoints(root, keep_last=2)
    left = sorted(d for d in os.listdir(root) if d.startswith("seg-"))
    assert left == ["seg-00000024", "seg-00000032"]
    assert sorted(pruned) == ["seg-00000008", "seg-00000016"]
    # LATEST's target is pinned even under keep_last=1 with a stale set
    update_latest(root, "seg-00000024")
    prune_checkpoints(root, keep_last=1)
    assert os.path.isdir(os.path.join(root, "seg-00000024"))


# --- supervised retries and aborts ---------------------------------------------


def _quick_supervisor(retries=2, **kw):
    return Supervisor(backoff=Backoff(0.01, max_retries=retries), sleep=lambda _d: None,
                      **kw)


@pytest.mark.parametrize("fail_call, checkpoints", [(1, True), (2, True), (2, False)])
def test_supervised_retry_restarts_from_the_boundary(tmp_path, monkeypatch, fail_call,
                                                     checkpoints):
    """An injected device fault mid-segment (after two rounds, with the
    segment's carry-in scribbled over when a host copy exists) is retried
    from the caller's carry (first segment), the host copy of the last
    boundary, or, supervised without checkpoints, the held boundary carry;
    the run still equals the straight run."""
    cfg = port_cfg("scale")
    net = NetModel.create(cfg.n_nodes, drop_prob=0.02, device="cpu")
    inputs = port_inputs(cfg, rounds=12)
    want, want_infos = port_straight(cfg, "scale", port_state(cfg, "scale"), net,
                                     prng.key(3), inputs)
    real = scale_step.scale_run_rounds_carry
    calls = []

    def flaky(cfg, st, net, key, seg):
        calls.append(1)
        if len(calls) == fail_call:
            real(cfg, st, net, key, head(seg, 2))
            if fail_call > 1 and checkpoints:
                st.crdt.store[1].fill_(12345)
            raise RuntimeError("injected device fault")
        return real(cfg, st, net, key, seg)

    monkeypatch.setattr(segments, "_run_carry_fn", lambda mode: flaky)
    sup = _quick_supervisor()
    res = run_segmented(cfg, port_state(cfg, "scale"), net, prng.key(3), inputs, 4,
                        checkpoint_root=str(tmp_path) if checkpoints else None,
                        supervisor=sup)
    assert res.completed_rounds == 12 and not res.aborted and sup.retries == 1
    assert len(calls) == 4
    assert res.stats["carry_reuploads"] == (1 if fail_call > 1 and checkpoints else 0)
    assert_states_equal(want, res.state, "retried")
    assert_infos_equal(want_infos, res.infos, "retried infos")


def test_aborted_run_resumes(tmp_path):
    """Supervisor exhaustion in the second segment: the run stops with
    the last committed segment as its recovery point and the boundary's
    carry as its state; a resume from disk finishes the run bitwise."""
    cfg = port_cfg("scale")
    net = NetModel.create(cfg.n_nodes, device="cpu")
    inputs = port_inputs(cfg, rounds=12)
    want, _ = port_straight(cfg, "scale", port_state(cfg, "scale"), net, prng.key(3),
                            inputs)
    root = str(tmp_path / "soak")

    class ConsumeThenAbort(Supervisor):
        def __init__(self):
            super().__init__(backoff=Backoff(0.01, max_retries=1), sleep=lambda _d: None)
            self.calls = 0

        def call(self, fn, *args, **kwargs):
            self.calls += 1
            if self.calls == 1:
                return fn(*args)
            fn(*args)  # the segment runs and takes the carry; its result is lost
            raise SupervisorAborted("injected exhaustion")

    res = run_segmented(cfg, port_state(cfg, "scale"), net, prng.key(3), inputs, 4,
                        checkpoint_root=root, supervisor=ConsumeThenAbort())
    assert res.aborted and res.completed_rounds == 4
    assert res.checkpoint.endswith("seg-00000004")
    _, boundary = ckpt.load_checkpoint(res.checkpoint, device="cpu")
    assert_states_equal(boundary, res.state, "aborted carry")
    assert int(res.state.crdt.now) == 4
    res2 = resume_segmented(cfg, net, inputs, 4, checkpoint_root=root)
    assert res2.completed_rounds == 12 and not res2.aborted
    assert_states_equal(want, res2.state, "resumed after abort")


def test_supervisor_deadline_and_exhaustion():
    import threading

    release = threading.Event()
    sup = _quick_supervisor(retries=1, deadline_seconds=0.05)
    with pytest.raises(SupervisorAborted, match="deadline"):
        sup.call(lambda: release.wait(5), label="wedged")
    release.set()
    assert sup.state == "aborted" and sup.retries == 1 and sup.aborts == 1
    ok = _quick_supervisor()
    flaky = iter([RuntimeError("transient"), None])

    def once():
        err = next(flaky)
        if err:
            raise err
        return 7

    assert ok.call(once) == 7 and ok.retries == 1 and ok.state == "idle"


def test_quiet_auto_segments_take_the_quiet_round(tmp_path):
    """Writes stop at round 10; later all-quiet segments on a settled
    carry run the quiet round under ``quiet="auto"``, and the run equals
    the dense straight run in every leaf and shared info key."""
    cfg = port_cfg("scale")
    rounds = 48
    n = cfg.n_nodes
    w = ((prng.uniform(prng.key(7), (rounds, n), "cpu") < 0.3)
         & (torch.arange(n) < cfg.n_origins)[None, :]
         & (torch.arange(rounds) < 10)[:, None])
    inputs = scale_step.make_write_inputs(cfg, prng.key(8), rounds, w, "cpu")
    net = NetModel.create(n, device="cpu")
    dense = dataclasses.replace(cfg, quiet="off")
    want, want_infos = port_straight(dense, "scale", port_state(cfg, "scale"), net,
                                     prng.key(0), inputs)
    res = run_segmented(cfg, port_state(cfg, "scale"), net, prng.key(0), inputs, 8,
                        checkpoint_root=str(tmp_path))
    assert res.stats["quiet_mode"] == "auto" and res.stats["quiet_segments"] >= 1
    assert int(res.infos["quiet_round"].sum()) > 0
    assert_states_equal(want, res.state, "quiet auto")
    assert_infos_equal(want_infos, res.infos, "quiet auto infos")


def test_async_write_failure_surfaces(tmp_path, monkeypatch):
    """A failed background write stops the run at the next submit or at
    close, never silently."""
    from corrosion_tpu_torch.resilience import async_ckpt

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(async_ckpt, "write_segment_checkpoint", broken)
    cfg = port_cfg("scale")
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        run_segmented(cfg, port_state(cfg, "scale"),
                      NetModel.create(cfg.n_nodes, device="cpu"), prng.key(3),
                      port_inputs(cfg, rounds=8), 4,
                      checkpoint_root=str(tmp_path))
