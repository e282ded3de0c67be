"""The port's ``devcluster`` and native host oracle held to the JAX package's.

``parse_topology`` and the JSON ``devcluster`` prints equal JAX's on one
topology file of three components, and so do the configuration it boots
and the agent's region plane. ``python -m corrosion_tpu_torch devcluster
--device cpu`` serves that cluster: a write at a node of one component is
read at a node of another, and SIGTERM stops it with exit 0. The port's
ctypes bindings build ``native/corro_host.cpp`` themselves; their stores
equal the JAX package's bindings of the same source, and at N=64 the
port's scale round (``run_sim_script`` on the CPU) bitwise.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from corrosion_tpu import cli as jcli
from corrosion_tpu.agent import Agent as JAgent
from corrosion_tpu.native import NativeCluster as JNativeCluster
from corrosion_tpu.native import NativeNode as JNativeNode
from corrosion_tpu_torch import cli, native
from corrosion_tpu_torch.agent import Agent
from corrosion_tpu_torch.client import CorrosionApiClient
from corrosion_tpu_torch.native import NativeCluster, NativeNode
from corrosion_tpu_torch.sim.parity import (
    OracleCluster,
    WorkloadScript,
    check_bitwise_parity,
    run_sim_script,
)

ROOT = Path(__file__).resolve().parent.parent
#: three components: a ring of 12, a star of 10, a chain of 8, with
#: comments, a blank line and a node named before its edges
TOPOLOGY = ROOT / "tests" / "data" / "devcluster_topology.txt"
#: the JSON the JAX package's ``devcluster`` prints for it (``chip_smoke.py``
#: holds the card's run to this file)
PLAN = ROOT / "tests" / "data" / "devcluster_jax.json"


def _devcluster_plan(mod, path, capsys, monkeypatch):
    """``devcluster``'s printed JSON and the (config, regions) it hands to
    ``cmd_agent``, without booting the agent."""
    seen = {}

    def fake_agent(args, cfg=None, regions=None):
        seen.update(cfg=cfg, regions=regions)
        return 0

    monkeypatch.setattr(mod, "cmd_agent", fake_agent)
    argv = ["devcluster", str(path)]
    if mod is cli:
        argv += ["--device", "cpu"]
    assert mod.main(argv) == 0
    return json.loads(capsys.readouterr().out), seen


def test_devcluster_plan_and_regions_equal_jax(capsys, monkeypatch):
    text = TOPOLOGY.read_text()
    assert cli.parse_topology(text) == jcli.parse_topology(text)
    names, _, groups = cli.parse_topology(text)
    assert len(names) == 30 and sorted(set(groups)) == [0, 1, 2]
    want, jseen = _devcluster_plan(jcli, TOPOLOGY, capsys, monkeypatch)
    got, seen = _devcluster_plan(cli, TOPOLOGY, capsys, monkeypatch)
    assert got == want == json.loads(PLAN.read_text())
    assert seen["regions"] == jseen["regions"] == groups
    for section in ("sim", "gossip"):
        assert (vars(getattr(seen["cfg"], section))
                == vars(getattr(jseen["cfg"], section))), section
    jagent, agent = JAgent(jseen["cfg"]), Agent(seen["cfg"], device="cpu")
    jagent.set_regions(jseen["regions"])
    agent.set_regions(seen["regions"])
    want_region = np.asarray(jagent._net.region)
    assert agent._net.region.dtype == torch.int32
    assert np.array_equal(agent._net.region.numpy(), want_region)
    assert want_region.tolist() == groups


def test_devcluster_process_serves_across_regions(tmp_path):
    schema = tmp_path / "schema.sql"
    schema.write_text("CREATE TABLE kv (k TEXT PRIMARY KEY, v INTEGER);")
    cfg = tmp_path / "dev.toml"
    cfg.write_text(f'[db]\npath = "{tmp_path / "state"}"\n'
                   f'schema_paths = ["{schema}"]\n[api]\nport = 0\n'
                   f'[admin]\nuds_path = "{tmp_path / "admin.sock"}"\n'
                   f'[sim]\nm_slots = 8\nn_rows = 8\nn_cols = 4\n')
    proc = subprocess.Popen(
        [sys.executable, "-m", "corrosion_tpu_torch", "devcluster", str(TOPOLOGY),
         "-c", str(cfg), "--device", "cpu", "--pace", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        lines = []
        while not (lines and lines[-1].startswith("agent up:")):
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-3000:]
            lines.append(line)
        plan = json.loads("".join(lines[:-1]))
        assert plan == json.loads(PLAN.read_text())
        up = re.match(r"agent up: api http://([\d.]+):(\d+) .*nodes=(\d+) "
                      r"device=cpu", lines[-1])
        assert up and int(up.group(3)) == len(plan["nodes"]) == 30
        client = CorrosionApiClient(up.group(1), int(up.group(2)), timeout=60)
        writer, reader = plan["nodes"]["solo-first"], plan["nodes"]["chain7"]
        assert plan["regions"]["solo-first"] != plan["regions"]["chain7"]
        client.execute([("INSERT INTO kv (k, v) VALUES (?, ?)", ["x", 7])],
                       node=writer)
        deadline = time.monotonic() + 60
        while client.query("SELECT k, v FROM kv", node=reader)[1] != [["x", 7]]:
            assert time.monotonic() < deadline, "the write never crossed regions"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_native_node_equals_jax():
    rng = np.random.default_rng(3)
    # (cell, ver, val, site, origin, dbv, clp) rows, versions out of order
    rows = np.stack([rng.integers(0, 16, 64), rng.integers(1, 4, 64),
                     rng.integers(0, 100, 64), rng.integers(0, 4, 64),
                     rng.integers(0, 4, 64), rng.integers(1, 12, 64),
                     rng.integers(0, 3, 64)], axis=1).astype(np.int32)
    got, want = NativeNode(16, 4), JNativeNode(16, 4)
    for chunk in np.array_split(rows, 4):
        assert np.array_equal(got.apply(chunk), want.apply(chunk))
    for origin in range(4):
        for fn in ("head", "known_max", "needs", "n_gaps"):
            assert getattr(got, fn)(origin) == getattr(want, fn)(origin), fn
    assert got.record(2, 40) == want.record(2, 40)
    for a, b in zip(got.store(), want.store(), strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["single_writer", "full_mix"])
def test_native_cluster_stores_equal_jax(kind):
    if kind == "single_writer":
        script = WorkloadScript.random_single_writer(64, 8, 16, 10, seed=21,
                                                     write_prob=0.6)
    else:
        script = WorkloadScript.random_full_mix(64, 8, 32, rounds=12, seed=9,
                                                kill_prob=0.2, hot_cells=6)
    cells = script.n_cells
    got = NativeCluster(64, 8, cells, fanout=4, sync_peers=2, seed=4)
    want = JNativeCluster(64, 8, cells, fanout=4, sync_peers=2, seed=4)
    taken = got.run(script, settle_rounds=512)
    assert taken > 0 and taken == want.run(script, settle_rounds=512)
    assert got.converged() and got.total_needs() == want.total_needs() == 0
    for node in (0, 17, 63):
        for a, b in zip(got.store_planes(node), want.store_planes(node),
                        strict=True):
            assert np.array_equal(a, b)


def test_native_cluster_equals_the_port_round_at_64():
    script = WorkloadScript.random_single_writer(64, 8, 16, 10, seed=21,
                                                 write_prob=0.6)
    nat = NativeCluster(64, 8, 16, fanout=4, sync_peers=2, seed=4)
    assert nat.run(script, settle_rounds=512) > 0
    planes, alive, taken = run_sim_script(script, seed=21, device="cpu")
    assert taken > 0 and alive.all()
    assert not check_bitwise_parity(nat, planes, alive)
    oracle = OracleCluster(64, 8, 16, seed=1)
    assert oracle.run(script) > 0
    for a, b in zip(nat.store_planes(), oracle.store_planes(), strict=True):
        assert np.array_equal(a, b)


def test_native_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.load()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="did not run"):
        NativeCluster(8, 2, 4)
    assert list(tmp_path.iterdir()) == []
