"""Sharded checkpoints and the elastic restore in the port (after the JAX
package's ``tests/test_sharded_checkpoint.py``), on the CPU at N=24.

A soak run on a mesh of eight ``cpu`` shards drains its carry per shard and
writes the JAX package's format-3 layout: one slice file per shard and the
same manifest JAX writes for the same run on eight host devices, slice for
slice. The checkpoint resumes onto four shards, a ``(2, 4)`` mesh or one
device bitwise equal to the uninterrupted run (with a crashed slice write
on the way); a single-device save resumes onto a mesh; one damaged or
missing slice refuses the whole checkpoint; sharded checkpoints cross the
two packages both ways; ``Agent.soak(mesh=)`` equals the unsharded soak,
and a live agent restores a sharded checkpoint."""

import json
import os
import shutil

import jax
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu import checkpoint as jckpt
from corrosion_tpu.parallel import mesh as jmesh
from corrosion_tpu.resilience import segments as jseg
from corrosion_tpu.sim import scale_step as jscale
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import checkpoint as ckpt
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.parallel import (
    device_put_shards,
    host_shard_copy,
    make_mesh,
    make_multihost_mesh,
    shard_state,
)
from corrosion_tpu_torch.parallel import exchange
from corrosion_tpu_torch.parallel.mesh import ShardedTree, tree_leaves
from corrosion_tpu_torch.resilience import (
    Supervisor,
    SupervisorAborted,
    latest_valid_checkpoint,
    resume_segmented,
    run_segmented,
)
from corrosion_tpu_torch.resilience.segments import make_soak_inputs
from corrosion_tpu_torch.sim import scale_step
from corrosion_tpu_torch.sim.transport import NetModel
from corrosion_tpu_torch.utils.backoff import Backoff

N, ROUNDS = 24, 16
SCALE = dict(m_slots=8, n_origins=4, n_rows=4, n_cols=2, sync_interval=4)


@pytest.fixture(autouse=True, scope="module")
def _short_turn_timeout():
    """A deadlocked shard fails its wait within a minute."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exchange, "TURN_TIMEOUT_S", 60.0)
        yield


def mesh8():
    return make_mesh(["cpu"] * 8)


def fresh(cfg):
    return scale_step.ScaleSimState.create(cfg, "cpu")


def head(inputs, hi):
    return type(inputs)(*(a[:hi] for a in inputs))


def assert_same(a, b, what):
    """Two states (port, placed, or JAX) hold the same leaves."""
    def host(st):
        if isinstance(st, ShardedTree):
            st = st.assemble("cpu")
        if isinstance(st, scale_step.ScaleSimState):
            return ckpt.host_arrays(st)
        return [np.asarray(x) for x in jax.tree.leaves(st)]

    la, lb = host(a), host(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and np.array_equal(x, y), f"{what}: leaf {i}"


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """16 rounds of writes, the straight reference, a root holding
    ``seg-00000008`` written on eight shards (with a crashed slice write of
    the next segment on the way: the failure surfaces and seg 8 stays the
    recovery point), and JAX's sharded save of the same 8 rounds."""
    cfg = scale_step.scale_sim_config(N, **SCALE)
    net = NetModel.create(N, drop_prob=0.02, device="cpu")
    inputs = make_soak_inputs(cfg, prng.key(5), ROUNDS, write_frac=0.25, device="cpu")
    ref, _ = scale_step.scale_run_rounds(cfg, fresh(cfg), net, prng.key(3), inputs)

    root = str(tmp_path_factory.mktemp("soak") / "root")
    m8 = mesh8()
    r1 = run_segmented(cfg, shard_state(m8, N, fresh(cfg)), net, prng.key(3),
                       head(inputs, 8), 8, checkpoint_root=root)
    assert r1.completed_rounds == 8 and not r1.aborted
    real = ckpt._write_bytes

    def exploding(path, data):
        if "shard-00003" in path:
            raise OSError("simulated crash while writing slice 3")
        return real(path, data)

    ckpt._write_bytes = exploding
    try:
        with pytest.raises(RuntimeError, match="async checkpoint write failed"):
            resume_segmented(cfg, net, inputs, 8, checkpoint_root=root, mesh=m8)
    finally:
        ckpt._write_bytes = real
    assert latest_valid_checkpoint(root).endswith("seg-00000008")

    jcfg = jscale.scale_sim_config(N, **SCALE)
    jnet = JNet.create(N, drop_prob=0.02)
    jinputs = jseg.make_soak_inputs(jcfg, jr.key(5), ROUNDS, write_frac=0.25,
                                    mode="scale")
    jm8 = jmesh.make_mesh(jax.devices()[:8])
    jroot = str(tmp_path_factory.mktemp("jax") / "root")
    jr1 = jseg.run_segmented(
        jcfg, jmesh.shard_state(jm8, N, jscale.ScaleSimState.create(jcfg)),
        jmesh.shard_state(jm8, N, jnet), jr.key(3),
        jmesh.shard_state(jm8, N, jax.tree.map(lambda a: a[:8], jinputs)),
        segment_rounds=8, mode="scale", checkpoint_root=jroot)
    assert jr1.completed_rounds == 8 and jr1.stats["ckpt_shards"] == 8
    return dict(cfg=cfg, net=net, inputs=inputs, ref=ref, root=root, r1=r1,
                jcfg=jcfg, jnet=jnet, jinputs=jinputs, jroot=jroot)


def _manifest(root):
    with open(os.path.join(root, "seg-00000008", "manifest.json")) as f:
        return json.load(f)


def test_sharded_save_writes_jax_slices_and_manifest(rig):
    mine, theirs = _manifest(rig["root"]), _manifest(rig["jroot"])
    assert mine["format"] == 3 and mine["mesh"] == {"axis_names": ["node"], "shape": [8]}
    assert len(mine["slices"]) == 8 and sorted(mine["files"]) == sorted(mine["slices"])
    sharded = [m for m in mine["leaves"] if m["dim"] is not None]
    assert sharded and all(m["axes"] == ["node"] for m in sharded)
    assert all(m["axes"] is None for m in mine["leaves"] if m["dim"] is None)
    assert sorted(mine["files"]) == sorted(theirs["files"])
    assert ({k: v for k, v in mine.items() if k != "files"}
            == {k: v for k, v in theirs.items() if k != "files"})
    for name in mine["files"]:
        with np.load(os.path.join(rig["root"], "seg-00000008", name)) as a, \
                np.load(os.path.join(rig["jroot"], "seg-00000008", name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)

    stats = rig["r1"].stats
    assert stats["ckpt_shards"] == 8 and stats["ckpt_written"] == 1
    assert 0 < stats["ckpt_shard_bytes_max"] < stats["ckpt_drain_bytes"]


def test_verify_checkpoint_reports_shards(rig):
    from corrosion_tpu_torch.cli import main

    path = os.path.join(rig["root"], "seg-00000008")
    out = ckpt.verify_checkpoint(path)
    assert out["format"] == 3 and out["shards"] == 8 and out["mesh"]["shape"] == [8]
    assert out == {**jckpt.verify_checkpoint(path), "path": path}
    assert main(["verify-checkpoint", path]) == 0


@pytest.mark.parametrize("target", ["mesh4", "mesh2x4", "single"])
def test_resharded_resume_bitwise_equals_uninterrupted(rig, tmp_path, target):
    my_root = str(tmp_path / "root")
    shutil.copytree(rig["root"], my_root)
    mesh = {"mesh4": make_mesh(["cpu"] * 4),
            "mesh2x4": make_multihost_mesh(2, ["cpu"] * 8), "single": None}[target]
    res = resume_segmented(rig["cfg"], rig["net"], rig["inputs"], 8,
                           checkpoint_root=my_root, mesh=mesh)
    assert res.completed_rounds == ROUNDS and not res.aborted
    assert_same(rig["ref"], res.state, f"resume onto {target}")
    if mesh is not None:
        assert isinstance(res.state, ShardedTree) and res.state.mesh is mesh
        # the resumed run checkpointed per shard on the new mesh
        assert res.stats["ckpt_shards"] == mesh.size
        assert ckpt.verify_checkpoint(res.checkpoint)["shards"] == mesh.size


def test_single_device_save_restores_onto_mesh(rig, tmp_path):
    cfg, net, inputs = rig["cfg"], rig["net"], rig["inputs"]
    root = str(tmp_path / "root")
    r1 = run_segmented(cfg, fresh(cfg), net, prng.key(3), head(inputs, 8), 8,
                       checkpoint_root=root)
    assert r1.stats["ckpt_shards"] == 1 and not r1.aborted
    res = resume_segmented(cfg, net, inputs, 8, checkpoint_root=root, mesh=mesh8())
    assert res.completed_rounds == ROUNDS
    assert_same(rig["ref"], res.state, "single -> mesh resume")
    assert len(res.state.parts) == 8


def test_single_slice_corruption_refused(rig, tmp_path):
    from corrosion_tpu_torch.cli import main

    my_root = str(tmp_path / "root")
    shutil.copytree(rig["root"], my_root)
    res = resume_segmented(rig["cfg"], rig["net"], rig["inputs"], 8,
                           checkpoint_root=my_root, mesh=mesh8())
    newest = res.checkpoint
    assert newest.endswith("seg-00000016")
    slice_path = os.path.join(newest, "shard-00005.npz")
    blob = bytearray(open(slice_path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(slice_path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ckpt.CheckpointIntegrityError):
        ckpt.verify_checkpoint(newest)
    assert main(["verify-checkpoint", newest]) != 0
    assert latest_valid_checkpoint(my_root).endswith("seg-00000008")
    os.unlink(os.path.join(newest, "shard-00002.npz"))
    with pytest.raises(ckpt.CheckpointIntegrityError, match="missing"):
        ckpt.verify_checkpoint(newest)


def test_jax_sharded_checkpoint_restores_in_the_port(rig, tmp_path):
    root = str(tmp_path / "root")
    shutil.copytree(rig["jroot"], root)
    res = resume_segmented(rig["cfg"], rig["net"], rig["inputs"], 8,
                           checkpoint_root=root, mesh=make_mesh(["cpu"] * 4))
    assert res.completed_rounds == ROUNDS
    assert_same(rig["ref"], res.state, "JAX's sharded checkpoint resumed on 4 shards")


def test_port_sharded_checkpoint_restores_in_jax(rig, tmp_path):
    root = str(tmp_path / "root")
    shutil.copytree(rig["root"], root)
    jm4 = jmesh.make_mesh(jax.devices()[:4])
    jres = jseg.resume_segmented(
        rig["jcfg"], jmesh.shard_state(jm4, N, rig["jnet"]),
        jmesh.shard_state(jm4, N, rig["jinputs"]), segment_rounds=8,
        checkpoint_root=root, mode="scale", mesh=jm4)
    assert jres.completed_rounds == ROUNDS
    assert_same(rig["ref"], jres.state, "the port's sharded checkpoint resumed in JAX")


def test_sharded_abort_hands_back_a_usable_carry(rig, tmp_path):
    """Supervisor exhaustion mid-run on a mesh: the carry handed back is
    the last committed boundary, rebuilt from its host slices on the same
    mesh."""
    cfg, net = rig["cfg"], rig["net"]
    m8 = mesh8()

    class AbortSecond(Supervisor):
        def __init__(self):
            super().__init__(backoff=Backoff(0.01, max_retries=1), sleep=lambda _d: None)
            self.calls = 0

        def call(self, fn, *args, **kwargs):
            self.calls += 1
            if self.calls == 1:
                return fn(*args)
            fn(*args)
            raise SupervisorAborted("injected: result lost after dispatch")

    res = run_segmented(cfg, shard_state(m8, N, fresh(cfg)), net, prng.key(29),
                        head(rig["inputs"], 12), 4, checkpoint_root=str(tmp_path / "s"),
                        supervisor=AbortSecond())
    assert res.aborted and res.completed_rounds == 4
    assert isinstance(res.state, ShardedTree) and res.state.mesh is m8
    _manifest_, state = ckpt.load_checkpoint(res.checkpoint, device="cpu")
    assert_same(state, res.state, "aborted sharded carry")


def test_host_shard_copy_roundtrip_is_owned_and_bitwise(rig):
    m8 = mesh8()
    placed = shard_state(m8, N, fresh(rig["cfg"]))
    drained = host_shard_copy(placed)
    assert {len(hs.parts) for hs in tree_leaves(drained) if hs.dim is not None} == {8}
    for hs in tree_leaves(drained):
        for _start, arr in hs.parts:
            assert isinstance(arr, np.ndarray) and arr.flags.owndata
    back = device_put_shards(drained)
    assert isinstance(back, ShardedTree) and back.mesh is m8
    assert_same(placed, back, "drain/re-upload roundtrip")


def test_agent_soak_on_a_mesh_equals_the_unsharded_soak(tmp_path):
    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.config import Config

    def agent(tag):
        acfg = Config()
        acfg.sim.mode = "scale"
        acfg.sim.n_nodes = 16
        acfg.sim.m_slots = 8
        acfg.sim.n_origins = 4
        acfg.sim.n_rows = 4
        acfg.sim.n_cols = 2
        acfg.gossip.drop_prob = 0.0
        acfg.db.path = str(tmp_path / tag)
        return Agent(acfg, device="cpu")

    plain, sharded = agent("plain"), agent("sharded")
    want = plain.soak(8, segment_rounds=4, write_frac=0.25,
                      checkpoint_root=str(tmp_path / "plain-soak"))
    res = sharded.soak(8, segment_rounds=4, write_frac=0.25,
                       checkpoint_root=str(tmp_path / "sharded-soak"), mesh=mesh8())
    assert not res.aborted and res.completed_rounds == want.completed_rounds == 8
    assert res.stats["ckpt_shards"] == 8 and sharded.round_no == plain.round_no
    for a, b in zip(tree_leaves(plain.device_state()), tree_leaves(sharded.device_state())):
        assert np.array_equal(a, b)
    assert torch.equal(plain._key, sharded._key)
    assert ckpt.verify_checkpoint(res.checkpoint)["shards"] == 8
    # a live agent takes a sharded manifest whole (restore_checkpoint)
    manifest = ckpt.restore_checkpoint(plain, res.checkpoint)
    assert manifest["mesh"] == {"axis_names": ["node"], "shape": [8]}
    _m, saved = ckpt.load_checkpoint(res.checkpoint, device="cpu")
    for a, b in zip(ckpt.host_arrays(saved), tree_leaves(plain.device_state())):
        assert np.array_equal(a, b)
