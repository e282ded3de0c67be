"""The port's chaos engine (``resilience/chaos.py``) against the JAX
package's, on the CPU at the registry's N=24.

The tier-1 scenarios' verdicts equal JAX's field for field (digests,
rounds to convergence and quiescence, info sums, counters, ``ok``) and
equal ``tests/data/chaos_verdicts_jax.json``, the JAX package's verdicts of
every registry scenario at seed 0 (made on the CPU, regenerated by the slow
test below with ``CHAOS_VERDICTS_WRITE=1``, as is
``tests/data/chaos_storm_jax.json``, preempt-storm at N=4096); the two
remesh scenarios run sharded over eight ``cpu`` shards, then four, and
equal JAX's committed verdicts (made on eight host devices) field for field,
``state_digest`` included; what the port cannot run
(``fused="off"/"interpret"``) is a skip with its reason; a
crash before the first commit fails its verdict and not the sweep; a
corrupt checkpoint is refused; scripts round-trip through JSON with their
digest; and the ``chaos`` subcommand lists and replays on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from corrosion_tpu.resilience import chaos as jchaos
from corrosion_tpu_torch import cli
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.checkpoint import CheckpointIntegrityError, load_checkpoint
from corrosion_tpu_torch.resilience import chaos
from corrosion_tpu_torch.resilience.async_ckpt import write_segment_checkpoint
from corrosion_tpu_torch.resilience.segments import _key_to_json
from corrosion_tpu_torch.sim.scale_step import ScaleSimState
from corrosion_tpu_torch.sim.scenario import FaultPhase
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
VERDICTS = ROOT / "tests" / "data" / "chaos_verdicts_jax.json"
#: JAX's verdict of preempt-storm at the ladder's top rung, seed 0: the
#: reference the card's storm leg is held to (regenerated by the slow test
#: below with ``CHAOS_VERDICTS_WRITE=1``)
STORM = ROOT / "tests" / "data" / "chaos_storm_jax.json"
STORM_N, STORM_SETTLE = 4096, 512
#: preempt-storm at the top rung with a settle budget its queues drain
#: within (``chaos --script`` runs it in either package)
DRAIN = ROOT / "tests" / "data" / "preempt_storm_4096.json"
DRAIN_SETTLE = 14336
QUIESCENCE_PROBLEM = "did not drain within 512 settle rounds (oracle 3)"
#: the scenarios the port skips, with a word of each reason
SKIPS = {"fused-flip": "rules of the port"}
#: the scenarios that run on a mesh of cpu shards (8, then 4)
REMESH = ("corrupt-remesh", "elastic-remesh")
#: the verdict fields a skip shares with the JAX package's run
SKIP_FIELDS = ("name", "seed", "n_nodes", "trace_digest", "rounds_scripted",
               "phases")


def committed_verdicts() -> dict:
    with open(VERDICTS) as f:
        return json.load(f)


def assert_verdict_matches(rec: dict, jrec: dict) -> None:
    """A run scenario equals JAX's verdict field for field; a skip shares
    the compiled trace and carries its reason."""
    if rec["name"] in SKIPS:
        assert rec["ok"] and SKIPS[rec["name"]] in rec["skipped"], rec
        for f in SKIP_FIELDS:
            assert rec[f] == jrec[f], f
        return
    assert "skipped" not in rec, rec
    assert rec == jrec


@pytest.mark.parametrize("name", jchaos.TIER1_SCENARIOS)
def test_tier1_verdict_equals_jax_and_the_committed_file(name):
    rec = chaos.run_scenario(chaos.SCENARIOS[name], seed=0, device="cpu")
    assert rec["ok"], rec.get("problems")
    assert rec["converged"] and rec["quiesced"] and rec["bitwise_match"]
    assert rec["faults_injected"] == len(chaos.SCENARIOS[name].injections)
    assert rec == jchaos.run_scenario(jchaos.SCENARIOS[name], seed=0)
    assert rec == committed_verdicts()["scenarios"][name]


@pytest.mark.parametrize("name", sorted(jchaos.SCENARIOS))
def test_committed_file_pins_every_registry_trace(name):
    """The file holds JAX's verdict of every registry scenario, each
    passing, and the port compiles the same trace for it."""
    jrec = committed_verdicts()["scenarios"][name]
    assert jrec["ok"] and jrec["name"] == name and jrec["seed"] == 0
    _, _, digest = chaos.compile_scenario(chaos.SCENARIOS[name], 0, device="cpu")
    assert digest == jrec["trace_digest"]


def storm_script(module, n: int, budget: int):
    import dataclasses

    return dataclasses.replace(module.SCENARIOS["preempt-storm"], n_nodes=n,
                               settle_budget=budget)


def test_storm_file_pins_the_top_rung_trace():
    """The JAX package's own verdict at N=4096 converges, replays every
    checkpoint and matches its chaos leg bitwise, and fails only oracle 3
    (its queues do not drain within the budget); the port compiles the
    same trace at that size."""
    with open(STORM) as f:
        doc = json.load(f)
    assert (doc["n_nodes"], doc["settle_budget"], doc["seed"]) == (
        STORM_N, STORM_SETTLE, 0)
    jrec = doc["verdict"]
    assert jrec["converged"] and jrec["bitwise_match"]
    assert jrec["checkpoints_validated"] == 8 and jrec["checkpoints_refused"] == 0
    assert not jrec["quiesced"] and jrec["rounds_to_quiescence"] == -1
    assert [p[-len(QUIESCENCE_PROBLEM):] for p in jrec["problems"]] == [
        QUIESCENCE_PROBLEM]
    _, _, digest = chaos.compile_scenario(
        storm_script(chaos, STORM_N, STORM_SETTLE), 0, device="cpu")
    assert digest == jrec["trace_digest"]


def test_drain_script_is_the_registry_storm_at_the_top_rung():
    """The committed drain script is preempt-storm at N=4096 with a wide
    settle budget, and both packages compile it to the same trace."""
    with open(DRAIN) as f:
        doc = json.load(f)
    script = chaos.script_from_json(doc)
    assert script == storm_script(chaos, STORM_N, DRAIN_SETTLE)
    assert json.loads(json.dumps(chaos.script_to_json(script))) == doc
    _, _, digest = chaos.compile_scenario(script, 0, device="cpu")
    _, _, jdigest = jchaos.compile_scenario(jchaos.script_from_json(doc), 0)
    assert digest == jdigest


@pytest.mark.parametrize("name", sorted(SKIPS))
def test_unported_scenarios_skip_with_their_reason(name):
    rec = chaos.run_scenario(chaos.SCENARIOS[name], seed=0, device="cpu")
    assert_verdict_matches(rec, committed_verdicts()["scenarios"][name])
    assert "state_digest" not in rec and "problems" not in rec


@pytest.mark.parametrize("name", REMESH)
def test_remesh_verdict_equals_the_committed_jax_verdict(name):
    """Sharded over eight shards, resumed onto four mid-lineage: JAX's
    verdict field for field, the state digest included."""
    rec = chaos.run_scenario(chaos.SCENARIOS[name], seed=0, device="cpu")
    assert rec["ok"], rec.get("problems")
    assert rec["remeshes"] == 1 and rec["bitwise_match"]
    assert "skipped" not in rec and rec["state_digest"]
    assert rec == committed_verdicts()["scenarios"][name]


def test_only_mesh_and_fused_scenarios_skip():
    """Mesh scenarios run now: the fused flip alone skips."""
    skipped = {n for n, s in chaos.SCENARIOS.items() if chaos._port_skip(s)}
    assert skipped == set(SKIPS)
    assert set(REMESH) <= {n for n, s in chaos.SCENARIOS.items() if s.mesh_devices}


def test_crash_before_first_commit_fails_the_verdict_not_the_sweep():
    """A crash that kills the first ever save leaves nothing to resume
    from: the verdict fails with an engine error instead of raising."""
    script = chaos.ScenarioScript(
        name="first-save-crash",
        phases=(FaultPhase(rounds=4, write_frac=0.2),),
        injections=(chaos.Injection(kind="crash_slice", phase=0),),
        settle_budget=64,
    )
    rec = chaos.run_scenario(script, seed=0, device="cpu")
    assert not rec["ok"]
    assert any("engine error" in p for p in rec["problems"])


def test_injected_crash_marker_gates_seam_attribution():
    assert chaos._injected_crash(OSError("corrochaos: killed writing"))
    wrapped = RuntimeError("async checkpoint write failed")
    wrapped.__cause__ = OSError("corrochaos: killed between state write")
    assert chaos._injected_crash(wrapped)
    genuine = RuntimeError("async checkpoint write failed")
    genuine.__cause__ = OSError(28, "No space left on device")
    assert not chaos._injected_crash(genuine)


def test_corrupt_checkpoint_is_refused_on_load(tmp_path):
    cfg = chaos.scenario_config(chaos.SCENARIOS["ckpt-corrupt"])
    path = write_segment_checkpoint(
        cfg, ScaleSimState.create(cfg, "cpu"), _key_to_json(prng.key(0)), 4,
        str(tmp_path), keep_last=8)
    load_checkpoint(path, verify=True, device="cpu")  # clean before the flip
    chaos.corrupt_checkpoint(path)
    with pytest.raises(CheckpointIntegrityError):
        load_checkpoint(path, verify=True, device="cpu")


@pytest.mark.parametrize("name", sorted(jchaos.SCENARIOS))
def test_script_json_round_trip_keeps_the_digest(name):
    script = chaos.SCENARIOS[name]
    doc = json.loads(json.dumps(chaos.script_to_json(script)))
    assert doc == json.loads(json.dumps(jchaos.script_to_json(jchaos.SCENARIOS[name])))
    again = chaos.script_from_json(doc)
    assert again == script
    assert (chaos.compile_scenario(again, 3, device="cpu")[2]
            == chaos.compile_scenario(script, 3, device="cpu")[2])


def test_script_from_json_refuses_unknown_fields_and_schemas():
    doc = chaos.script_to_json(chaos.SCENARIOS["ckpt-corrupt"])
    with pytest.raises(ValueError, match="unknown script fields"):
        chaos.script_from_json(dict(doc, bogus=1))
    with pytest.raises(ValueError, match="script schema"):
        chaos.script_from_json(dict(doc, schema=99))


def test_seed_range_sweep_structure(monkeypatch):
    calls = []

    def fake(script, seed=0, device="cuda"):
        calls.append((script.name, seed))
        return {"name": script.name, "seed": seed, "ok": True,
                "rounds_to_convergence": 10 + seed}

    monkeypatch.setattr(chaos, "run_scenario", fake)
    out = chaos.run_sweep(["ckpt-corrupt", "clock-skew"], seed_range=(2, 3),
                          device="cpu")
    assert calls == [("ckpt-corrupt", 2), ("clock-skew", 2),
                     ("ckpt-corrupt", 3), ("clock-skew", 3)]
    assert out["seed_range"] == [2, 3] and out["platform"] == "cpu"
    assert out["per_seed"] == {"2": {"ckpt-corrupt": 12, "clock-skew": 12},
                               "3": {"ckpt-corrupt": 13, "clock-skew": 13}}
    with pytest.raises(ValueError, match="bad seed range"):
        chaos.run_sweep(["clock-skew"], seed_range=(3, 2), device="cpu")
    with pytest.raises(ValueError, match="unknown scenario"):
        chaos.run_sweep(["nope"], device="cpu")


def test_serve_overload_and_corrosan_name_their_items(monkeypatch, capsys):
    """``serve-overload`` is a host-plane runner the sweep calls by name with
    the seed and the device (``tests/test_torch_serve.py`` runs it); under
    ``CORROSAN=1`` a tier-1 scenario and one fuzz seed run inside a
    sanitized window (``analysis/sanitizer``), say so, and are clean."""
    from corrosion_tpu_torch.resilience import serve_overload

    calls = []

    def fake(seed, device):
        calls.append((seed, str(device)))
        return {"name": "serve-overload", "seed": seed, "n_nodes": 8,
                "host_plane": True, "ok": True}

    monkeypatch.setattr(serve_overload, "run_serve_overload", fake)
    out = chaos.run_sweep(["serve-overload"], seed_range=(1, 1), device="cpu")
    assert calls == [(1, "cpu")] and out["ok"]
    assert out["per_seed"]["1"]["serve-overload"] is None
    assert out["scenarios"][0]["host_plane"]
    assert cli.main(["chaos", "serve-overload", "--device", "cpu"]) == 0
    assert calls[-1] == (0, "cpu")
    assert json.loads(capsys.readouterr().out)["scenarios"][0]["name"] == "serve-overload"
    monkeypatch.setenv("CORROSAN", "1")
    for argv in (["chaos", chaos.TIER1_SCENARIOS[-1]], ["fuzz", "--seeds", "0:0"]):
        assert cli.main(argv + ["--device", "cpu"]) == 0, argv
        out = json.loads(capsys.readouterr().out)
        assert out["corrosan"] is True and out["ok"] and not out.get("problems"), argv


def test_chaos_raises_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        chaos.run_scenario(chaos.SCENARIOS["ckpt-corrupt"])


def _cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "corrosion_tpu_torch", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))


def test_chaos_cli_lists_the_registry():
    out = _cli("chaos", "--list")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(chaos.SCENARIOS) + 1
    assert any(ln.startswith("ckpt-corrupt [tier1]") for ln in lines)
    assert lines[-1] == ("serve-overload [host-plane]: serving-plane scenario, "
                         "run by name (not part of the default sweep)")


def test_chaos_cli_replays_the_corpus_on_the_cpu(tmp_path):
    corpus = ROOT / "tests" / "chaos_corpus" / "fuzz-000024-min.json"
    record = tmp_path / "replay.json"
    out = _cli("chaos", "--script", str(corpus), "--device", "cpu",
               "--output-json", str(record))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with open(record) as f:
        rec = json.load(f)
    assert rec["ok"] and rec["platform"] == "cpu"
    (verdict,) = rec["scenarios"]
    assert verdict["seed"] == 24 and verdict["corruptions_detected"] == 1
    assert verdict["converged"] and verdict["quiesced"]


# --- the JAX verdicts file (slow: every registry scenario in JAX) ----------


@pytest.mark.slow
def test_jax_verdicts_file_is_current_and_the_port_equals_it(tmp_path):
    """Regenerate JAX's verdicts of every registry scenario at seed 0
    (``CHAOS_VERDICTS_WRITE=1`` writes them to the file), then hold the
    port's verdicts to them scenario by scenario."""
    want = {name: jchaos.run_scenario(script, seed=0)
            for name, script in sorted(jchaos.SCENARIOS.items())}
    doc = {"seed": 0,
           "made_by": "corrosion_tpu.resilience.chaos.run_scenario, JAX on "
                      "the CPU with 8 host devices",
           "scenarios": want}
    if os.environ.get("CHAOS_VERDICTS_WRITE") == "1":
        VERDICTS.parent.mkdir(exist_ok=True)
        with open(VERDICTS, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    assert committed_verdicts() == json.loads(json.dumps(doc))
    for name, script in sorted(chaos.SCENARIOS.items()):
        assert_verdict_matches(
            chaos.run_scenario(script, seed=0, device="cpu"), want[name])


@pytest.mark.slow
def test_port_verdicts_are_deterministic_and_equal_jax_at_another_seed():
    # seed 2: at seeds 1 and 3 the JAX package's own verdict fails the
    # script's expected refutation (no node is refuted), and the port's
    # equals it there too
    script = chaos.SCENARIOS["preempt-storm"]
    a = chaos.run_scenario(script, seed=2, device="cpu")
    assert a == chaos.run_scenario(script, seed=2, device="cpu")
    assert a["ok"], a.get("problems")
    assert a == jchaos.run_scenario(jchaos.SCENARIOS["preempt-storm"], seed=2)


@pytest.mark.slow
def test_preempt_storm_quiesces_ever_later_as_n_grows():
    """preempt-storm's broadcast queues drain more slowly as N grows: all
    three oracles hold at N=64, 256, 512 and 1024 with a settle budget
    that grows with N, the rounds to quiescence grow, and every verdict
    equals the JAX package's field for field."""
    took = []
    for n, budget in ((64, 256), (256, 1024), (512, 2048), (1024, 4096)):
        rec = chaos.run_scenario(storm_script(chaos, n, budget), seed=0,
                                 device="cpu")
        assert rec["ok"], (n, rec.get("problems"))
        assert rec == jchaos.run_scenario(storm_script(jchaos, n, budget), seed=0)
        took.append(rec["rounds_to_quiescence"])
    assert took == sorted(took) and took[-1] > 4 * took[0], took


@pytest.mark.slow
def test_jax_storm_file_is_current_and_the_port_equals_it():
    """Regenerate JAX's preempt-storm verdict at N=4096 (settle budget 512;
    ``CHAOS_VERDICTS_WRITE=1`` writes it to the file), then hold the
    port's to it field for field."""
    want = jchaos.run_scenario(storm_script(jchaos, STORM_N, STORM_SETTLE), seed=0)
    doc = {"seed": 0, "n_nodes": STORM_N, "settle_budget": STORM_SETTLE,
           "made_by": "corrosion_tpu.resilience.chaos.run_scenario, JAX on "
                      "the CPU", "verdict": want}
    if os.environ.get("CHAOS_VERDICTS_WRITE") == "1":
        with open(STORM, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    with open(STORM) as f:
        assert json.load(f) == json.loads(json.dumps(doc))
    rec = chaos.run_scenario(storm_script(chaos, STORM_N, STORM_SETTLE), seed=0,
                             device="cpu")
    assert rec == want
