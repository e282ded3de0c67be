"""The port's soak observability (``obs/flight.py``, ``obs/bridge.py``,
``obs/spans.py``, ``run_segmented(obs=)``), ``Agent.soak`` and the ``soak``
subcommand, on the CPU (``tests/test_obs.py``'s cases on the port, plus
the JAX package's ``Agent.soak`` as the reference):

the flight recorder appends and replays, skips a torn tail, degrades on an
I/O failure and joins its thread; a crash-injected soak leaves a record
whose replay matches its resume; a mid-soak ``/metrics`` scrape advances;
``Agent.soak`` equals JAX's bitwise (state and infos) and bridges the
agent's own metrics; and ``soak --device cpu`` killed with SIGKILL and
resumed equals a straight run. Tolerance 0."""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from corrosion_tpu_torch import checkpoint as ckpt
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.obs import (
    FlightRecorder,
    SoakObserver,
    make_observer,
    pipeline_span,
    replay_flight_record,
    state_bytes,
)
from corrosion_tpu_torch.obs.flight import config_digest, info_sums, serve_snapshot
from corrosion_tpu_torch.resilience import segments
from corrosion_tpu_torch.resilience.segments import (
    make_soak_inputs,
    resume_segmented,
    run_segmented,
)
from corrosion_tpu_torch.sim.scale_step import (
    ScaleSimState,
    scale_run_rounds,
    scale_sim_config,
)
from corrosion_tpu_torch.sim.transport import NetModel
from corrosion_tpu_torch.utils import tracing
from corrosion_tpu_torch.utils.metrics import Registry, start_prometheus_listener
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
N = 48


@pytest.fixture(scope="module")
def cfg():
    return scale_sim_config(N, m_slots=8, n_origins=4, n_rows=8, n_cols=4,
                            sync_interval=2)


@pytest.fixture(scope="module")
def net():
    return NetModel.create(N, drop_prob=0.0, device="cpu")


def fresh(cfg):
    return ScaleSimState.create(cfg, "cpu")


# --- flight recorder -----------------------------------------------------


def test_flight_recorder_appends_and_replays(tmp_path):
    path = str(tmp_path / "flight.ndjson")
    rec = FlightRecorder(path)
    rec.record("header", schema=1, mode="scale", n_nodes=N, start_round=0,
               total_rounds=4, segment_rounds=2, hbm_bytes=123)
    rec.record("segment", seg=1, lo=0, hi=2, rounds=2, seconds=0.5,
               rounds_per_s=4.0, donated=False, info_sum={"acked": 3.0},
               info_last={"queued": 1.0},
               stats={"segments": 1, "ckpt_written": 0}, hbm_bytes=123)
    rec.record("end", completed_rounds=2, aborted=False, crashed=False,
               checkpoint=None, stats={"segments": 1, "ckpt_written": 0})
    rec.close()
    lines = open(path).read().splitlines()
    assert len(lines) == 3 and all(json.loads(ln)["kind"] for ln in lines)
    summary = replay_flight_record(path)
    assert summary["runs"] == 1 and summary["segments"] == 1
    assert summary["completed_rounds"] == 2 and summary["rounds"] == 2
    assert summary["info_sum"] == {"acked": 3.0}
    assert summary["ended"] and summary["aborted"] is False
    assert summary["skipped_lines"] == 0
    # records after close are dropped, not errors
    rec.record("segment", seg=2)
    assert replay_flight_record(path)["segments"] == 1


def test_flight_replay_skips_torn_tail(tmp_path):
    path = str(tmp_path / "flight.ndjson")
    rec = FlightRecorder(path)
    rec.record("header", schema=1, start_round=0)
    rec.record("segment", seg=1, lo=0, hi=3, rounds=3, seconds=1.0,
               stats={"segments": 1})
    rec.close()
    with open(path, "a") as f:
        f.write('{"kind":"segment","seg":2,"lo":3,"hi"')  # torn mid-write
    summary = replay_flight_record(path)
    assert summary["skipped_lines"] == 1 and summary["segments"] == 1
    assert summary["completed_rounds"] == 3


def test_flight_recorder_io_failure_degrades(tmp_path):
    rec = FlightRecorder(str(tmp_path / "flight.ndjson"))
    rec.path = str(tmp_path)  # a directory: os.open(O_WRONLY) fails
    rec.record("header", schema=1)
    rec.close()  # drains without raising


def test_flight_recorder_thread_counted_and_joined(tmp_path):
    from corrosion_tpu_torch.utils.lifecycle import pending_count

    before = pending_count()
    rec = FlightRecorder(str(tmp_path / "f.ndjson"))
    assert pending_count() == before + 1
    assert any(t.name == "corro-obs-flight" and t.is_alive()
               for t in threading.enumerate())
    rec.close()
    assert pending_count() == before
    assert not any(t.name == "corro-obs-flight" and t.is_alive()
                   for t in threading.enumerate())


def test_flight_records_carry_serve_snapshot(tmp_path):
    reg = Registry()
    reg.counter("corro.admission.admitted_total", 5, labels={"class": "write"})
    reg.gauge("corro.admission.inflight", 3, labels={"class": "write"})
    reg.counter("corro.subs.shed_total", 7)
    reg.counter("corro.http.requests_total", 9)  # not a serve series
    snap = serve_snapshot(reg)
    assert snap == {"corro.admission.admitted_total{class=write}": 5,
                    "corro.admission.inflight{class=write}": 3,
                    "corro.subs.shed_total": 7}
    assert serve_snapshot(None) == {}
    path = str(tmp_path / "flight.ndjson")
    obs = SoakObserver(flight=FlightRecorder(path), serve_registry=reg)
    obs.on_segment(seg_index=1, lo=0, hi=2, infos={}, stats={"segments": 1},
                   state=None)
    reg.counter("corro.subs.shed_total", 4)
    obs.end_run(stats={"segments": 1}, completed_rounds=2, aborted=False)
    obs.close()
    assert replay_flight_record(path)["serve"]["corro.subs.shed_total"] == 11


def test_config_digest_equals_jax():
    from corrosion_tpu.obs.flight import config_digest as jdigest
    from corrosion_tpu.sim.scale_step import scale_sim_config as jconfig

    kw = dict(m_slots=8, n_origins=4, n_rows=8, n_cols=4, sync_interval=2)
    assert config_digest(scale_sim_config(N, **kw)) == jdigest(jconfig(N, **kw))


# --- the headline: a crash-injected soak, replay against resume -----------


def test_crash_injected_soak_flight_matches_resume(tmp_path, cfg, net,
                                                   monkeypatch):
    rounds, seg = 6, 2
    inputs = make_soak_inputs(cfg, prng.key(1), rounds, write_frac=0.25,
                              device="cpu")
    ck = str(tmp_path / "ck")
    flight_a = str(tmp_path / "crashed.ndjson")
    flight_b = str(tmp_path / "resumed.ndjson")

    # crash the third segment dispatch (after two committed segments)
    real = segments._run_carry_fn
    calls = {"n": 0}

    def crashing(mode):
        run = real(mode)

        def wrapped(*a, **k):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("injected mid-soak crash")
            return run(*a, **k)

        return wrapped

    monkeypatch.setattr(segments, "_run_carry_fn", crashing)
    obs_a = SoakObserver(flight=FlightRecorder(flight_a), registry=Registry())
    with pytest.raises(RuntimeError, match="injected"):
        run_segmented(cfg, fresh(cfg), net, prng.key(0), inputs, seg,
                      checkpoint_root=ck, obs=obs_a)
    obs_a.close()
    monkeypatch.setattr(segments, "_run_carry_fn", real)

    replay_a = replay_flight_record(flight_a)
    assert replay_a["skipped_lines"] == 0 and replay_a["segments"] == 2
    assert replay_a["completed_rounds"] == 4
    assert replay_a["ended"] and replay_a["crashed"] is True
    assert replay_a["aborted"] is False

    obs_b = SoakObserver(flight=FlightRecorder(flight_b), registry=Registry())
    res = resume_segmented(cfg, net, inputs, seg, checkpoint_root=ck, obs=obs_b)
    obs_b.close()
    assert res.completed_rounds == rounds and not res.aborted
    replay_b = replay_flight_record(flight_b)
    assert (replay_a["completed_rounds"]
            == res.completed_rounds - replay_b["rounds"]
            == replay_b["header"]["start_round"])
    for key in ("segments", "donated_segments", "ckpt_written",
                "ckpt_drain_bytes", "carry_reuploads"):
        assert replay_b["stats"][key] == res.stats[key], key
    for key in ("ckpt_stall_s", "ckpt_io_s"):
        assert replay_b["stats"][key] == pytest.approx(res.stats[key]), key
    assert replay_b["ended"] and replay_b["crashed"] is False
    assert res.stats["donated_segments"] == 0
    assert replay_b["header"]["kernel_route"] == "plain"
    assert replay_b["header"]["hbm_bytes"] == state_bytes(res.state)
    assert (replay_a["header"]["config_digest"]
            == replay_b["header"]["config_digest"] == config_digest(cfg))
    # the resumed run's infos are the straight run's tail, and the record's
    # sums are theirs
    _, straight = scale_run_rounds(cfg, fresh(cfg), net, prng.key(0), inputs)
    tail = {k: v[4:] for k, v in straight.items()}
    assert replay_b["info_sum"] == info_sums(tail) == info_sums(res.infos)


def test_end_record_clean_inside_outer_except_handler(tmp_path, cfg, net):
    flight = str(tmp_path / "clean.ndjson")
    obs = SoakObserver(flight=FlightRecorder(flight))
    inputs = make_soak_inputs(cfg, prng.key(1), 2, device="cpu")
    try:
        raise ValueError("outer failure being handled")
    except ValueError:
        res = run_segmented(cfg, fresh(cfg), net, prng.key(0), inputs, 2,
                            obs=obs)
    obs.close()
    summary = replay_flight_record(flight)
    assert res.completed_rounds == 2
    assert summary["crashed"] is False and summary["aborted"] is False


def test_raising_observer_never_kills_the_soak(tmp_path, cfg, net):
    class Broken:
        jax_profile = False

        def __getattr__(self, name):
            raise RuntimeError(f"observer hook {name} broke")

    inputs = make_soak_inputs(cfg, prng.key(1), 4, write_frac=0.25, device="cpu")
    res = run_segmented(cfg, fresh(cfg), net, prng.key(0), inputs, 2,
                        checkpoint_root=str(tmp_path / "ck"), obs=Broken())
    want, _ = scale_run_rounds(cfg, fresh(cfg), net, prng.key(0), inputs)
    for (name, a), (_, b) in zip(ckpt.named_leaves(res.state),
                                 ckpt.named_leaves(want)):
        assert torch.equal(a, b), name


# --- the metrics bridge and the spans --------------------------------------


def test_mid_soak_metrics_scrape_advances(tmp_path, cfg, net):
    registry = Registry()
    listener = start_prometheus_listener(registry, port=0)
    url = f"http://127.0.0.1:{listener.bound_port}/metrics"
    samples = []

    def scrape() -> dict:
        text = urllib.request.urlopen(url, timeout=5).read().decode()
        return {line.split()[0]: float(line.split()[1])
                for line in text.splitlines()
                if line and not line.startswith("#")}

    class ScrapingObserver(SoakObserver):
        def on_segment(self, **kw):
            super().on_segment(**kw)
            samples.append(scrape())

    rounds = 6
    inputs = make_soak_inputs(cfg, prng.key(1), rounds, write_frac=0.25,
                              device="cpu")
    obs = ScrapingObserver(registry=registry, listener=listener)
    try:
        res = run_segmented(cfg, fresh(cfg), net, prng.key(0), inputs, 2,
                            checkpoint_root=str(tmp_path / "ck"), obs=obs)
    finally:
        obs.close()
    assert [s["corro_soak_rounds_total"] for s in samples] == [2.0, 4.0, 6.0]
    assert res.completed_rounds == rounds
    last = samples[-1]
    assert last["corro_soak_segments_total"] == 3.0
    assert last["corro_soak_rounds_per_s"] > 0
    assert last["corro_soak_segment_seconds_count"] == 3.0
    assert last["corro_gossip_probe_acked"] == info_sums(res.infos)["acked"] > 0
    assert last["corro_activity_bcast_nodes"] > 0
    assert last["corro_mem_state_bytes"] == state_bytes(res.state)
    assert not any(t.name == "corro-prometheus" and t.is_alive()
                   for t in threading.enumerate())


def test_pipeline_spans_reach_the_otlp_file(tmp_path, cfg, net):
    """Dispatch, host copy and serialize spans land in the OTLP export;
    with ``jax_profile`` the dispatch is labelled in a torch.profiler
    trace."""
    path = str(tmp_path / "otlp.json")
    tracing.configure_otlp_file(path)
    try:
        inputs = make_soak_inputs(cfg, prng.key(1), 4, device="cpu")
        obs = SoakObserver(jax_profile=True)
        with torch.profiler.profile() as prof:
            run_segmented(cfg, fresh(cfg), net, prng.key(0), inputs, 2,
                          checkpoint_root=str(tmp_path / "ck"), obs=obs)
        tracing.flush_otlp()
    finally:
        tracing.configure_otlp_file(None)
    names = [s["name"] for line in open(path)
             for rs in json.loads(line)["resourceSpans"]
             for ss in rs["scopeSpans"] for s in ss["spans"]]
    for want in ("soak.segment.dispatch", "soak.ckpt.drain",
                 "soak.ckpt.serialize"):
        assert names.count(want) == 2, (want, names)
    labels = {e.key for e in prof.key_averages()}
    assert "soak.segment.dispatch" in labels and "soak.ckpt.drain" in labels
    with pipeline_span("probe", jax_profile=False) as ctx:
        assert ctx.span_id


def test_make_observer_follows_the_obs_section(tmp_path):
    from corrosion_tpu_torch.config import ObsConfig

    assert make_observer(ObsConfig()) is None
    obs = make_observer(ObsConfig(flight_path=str(tmp_path / "f.ndjson"),
                                  prometheus_port=0))
    try:
        assert obs.flight is not None and obs.listener.bound_port > 0
        assert obs.bridge is not None and not obs.jax_profile
    finally:
        obs.close()


# --- Agent.soak against the JAX package's ---------------------------------


def _agent_configs():
    from test_torch_agent import small_config

    from corrosion_tpu.config import Config as JConfig
    from corrosion_tpu_torch.config import Config

    return small_config(Config), small_config(JConfig)


def test_agent_soak_equals_jax_and_bridges_its_metrics(tmp_path):
    from corrosion_tpu.agent import Agent as JAgent
    from corrosion_tpu_torch.agent import Agent

    cfg, jcfg = _agent_configs()
    agent, jagent = Agent(cfg, device="cpu"), JAgent(jcfg)
    res = agent.soak(8, segment_rounds=4, write_frac=0.25,
                     checkpoint_root=str(tmp_path / "port"))
    jres = jagent.soak(8, segment_rounds=4, write_frac=0.25,
                       checkpoint_root=str(tmp_path / "jax"))
    assert res.completed_rounds == jres.completed_rounds == 8
    assert agent.round_no == jagent.round_no == 8 and agent.generation == 1
    want = convert.as_numpy_tree(jagent.device_state())
    got = convert.as_numpy_tree(agent.device_state())
    for (name, a), (_, b) in zip(_flat(want), _flat(got)):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert set(res.infos) == set(jres.infos)
    for k, v in jres.infos.items():
        assert np.array_equal(np.asarray(v), res.infos[k].numpy()), k
    assert agent.metrics.get_counter("corro.soak.rounds_total") == 8.0
    assert agent.metrics.get_gauge("corro.soak.completed.rounds") == 8.0
    assert agent.metrics.get_gauge("corro.soak.aborted") == 0.0
    assert agent.metrics.get_gauge("corro.mem.state.bytes") == state_bytes(
        agent.device_state())
    # the port's checkpoints are JAX's files: the same state hashes
    pm = json.load(open(tmp_path / "port" / "seg-00000008" / "manifest.json"))
    jm = json.load(open(tmp_path / "jax" / "seg-00000008" / "manifest.json"))
    assert pm["files"] == jm["files"] and pm["extra"] == jm["extra"]
    # a round after the soak continues from the adopted carry
    agent._one_round()
    jagent._one_round()
    got = convert.as_numpy_tree(agent.device_state())
    want = convert.as_numpy_tree(jagent.device_state())
    for (name, a), (_, b) in zip(_flat(want), _flat(got)):
        assert np.array_equal(a, b), name


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], f"{path}.{k}")
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += _flat(v, f"{path}[{i}]")
        return out
    return [(path, np.asarray(tree))]


def test_agent_soak_resumes_onto_the_agent(tmp_path):
    from corrosion_tpu_torch.agent import Agent

    cfg, _ = _agent_configs()
    root = str(tmp_path / "ck")
    straight = Agent(cfg, device="cpu")
    straight.soak(8, segment_rounds=4, write_frac=0.25, checkpoint_root=root,
                  keep_last=8)
    shutil.rmtree(os.path.join(root, "seg-00000008"))  # preempted there
    resumed = Agent(cfg, device="cpu")
    res = resumed.soak(8, segment_rounds=4, write_frac=0.25, resume=True,
                       checkpoint_root=root, keep_last=8)
    assert res.completed_rounds == 8 and resumed.round_no == 8
    assert len(res.infos["acked"]) == 4
    for (name, a), (_, b) in zip(
            _flat(convert.as_numpy_tree(straight.device_state())),
            _flat(convert.as_numpy_tree(resumed.device_state()))):
        assert np.array_equal(a, b), name
    with pytest.raises(ValueError, match="resume needs"):
        resumed.soak(8, resume=True)


# --- the soak subcommand: SIGKILL, --resume, equal to a straight run ------

SOAK_TOML = """
[sim]
n_nodes = {n}
m_slots = 8
n_origins = 4
n_rows = 4
n_cols = 2
seed = 3

[perf]
sync_interval = 4

[gossip]
drop_prob = 0.01

[telemetry]
otlp_path = "{otlp}"
"""


def _soak_cli(cfg_path, ck, flight, *extra):
    return [sys.executable, "-m", "corrosion_tpu_torch", "soak", "-c", cfg_path,
            "--device", "cpu", "--checkpoint-dir", ck, "--flight", flight,
            "--keep-last", "64", *extra]


def _soak_cli_kill_resume(tmp_path, *mode):
    """``soak`` (with ``mode``'s flags) SIGKILLed after its second commit,
    then ``--resume``d to the end; -> the resumed run's summary, checked
    against a straight ``scale_run_rounds`` of the same config."""
    from corrosion_tpu_torch.config import load_config

    rounds, segment = 240, 4
    cfg_path = str(tmp_path / "soak.toml")
    with open(cfg_path, "w") as f:
        f.write(SOAK_TOML.format(n=32, otlp=tmp_path / "otlp.json"))
    ck, flight = str(tmp_path / "ck"), str(tmp_path / "flight.ndjson")
    args = ["--rounds", str(rounds), "--segment", str(segment), *mode]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(_soak_cli(cfg_path, ck, flight, *args, "--prom-port", "0"),
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True, cwd=ROOT, env=env)
    try:
        port = json.loads(proc.stdout.readline())["prometheus_port"]
        # two commits and the second segment's flight line: a segment's
        # manifest can land before its flight line (the writer commits it,
        # then the loop appends the line), so a kill between the two would
        # leave one segment on record with two committed
        deadline = time.time() + 120
        while time.time() < deadline:
            done = [d for d in (os.listdir(ck) if os.path.isdir(ck) else [])
                    if os.path.exists(os.path.join(ck, d, "manifest.json"))]
            if (len(done) >= 2 and os.path.exists(flight)
                    and replay_flight_record(flight)["segments"] >= 2):
                break
            time.sleep(0.01)
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
        assert "corro_soak_rounds_total" in text
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait(30)
    killed = replay_flight_record(flight)
    assert not killed["ended"] and killed["segments"] >= 2
    assert killed["completed_rounds"] < rounds

    out = subprocess.run(_soak_cli(cfg_path, ck, flight, *args, "--resume"),
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout)
    both = replay_flight_record(flight)
    assert both["runs"] == 2 and both["ended"] and not both["crashed"]
    start = both["header"]["start_round"]
    assert summary["completed_rounds"] == rounds and start >= 2 * segment
    assert summary["stats"]["donated_segments"] == 0

    config = load_config(cfg_path)
    cfg = config.sim_config()
    net = NetModel.create(cfg.n_nodes, drop_prob=config.gossip.drop_prob,
                          device="cpu")
    inputs = make_soak_inputs(cfg, prng.key(config.sim.seed + 1), rounds,
                              write_frac=0.25, device="cpu")
    want, infos = scale_run_rounds(cfg, ScaleSimState.create(cfg, "cpu"), net,
                                   prng.key(config.sim.seed), inputs)
    _, got = ckpt.load_checkpoint(summary["checkpoint"], device="cpu")
    for (name, a), (_, b) in zip(ckpt.named_leaves(want), ckpt.named_leaves(got)):
        assert torch.equal(a, b), name
    tail = info_sums({k: v[start:] for k, v in infos.items()})
    assert summary["metrics"] == tail
    spans = open(tmp_path / "otlp.json").read()
    assert "soak.segment.dispatch" in spans and "soak.ckpt.serialize" in spans
    return summary


def test_soak_cli_killed_and_resumed_equals_a_straight_run(tmp_path):
    summary = _soak_cli_kill_resume(tmp_path)
    assert summary["stats"]["async_checkpoint"] is True


def test_soak_cli_sync_checkpoint_killed_and_resumed_equals_a_straight_run(tmp_path):
    """``--sync-checkpoint``: the same writer, drained after every submit."""
    summary = _soak_cli_kill_resume(tmp_path, "--sync-checkpoint")
    stats = summary["stats"]
    assert stats["async_checkpoint"] is False
    assert stats["ckpt_written"] == stats["segments"]
    assert stats["ckpt_overlapped_segments"] == 0


def test_soak_cli_refuses_what_the_port_lacks(tmp_path):
    from corrosion_tpu_torch import cli

    for argv, item in ((["--shard", "4"], "exceeds the 0 available devices"),
                       (["--shard", "4", "--mesh-hosts", "2"],
                        "exceeds the 0 available devices"),
                       (["--fused", "interpret"], "rules of the port")):
        with pytest.raises(SystemExit, match=item):
            cli.main(["soak", "--device", "cpu", *argv])
