"""The port's scenario fuzzer (``resilience/fuzz.py``) against the JAX
package's, on the CPU: ``gen_script`` draws the same script for seeds 0-63
in both profiles, ``fuzz_ladder`` prices the same bytes rung for rung
(from a state on the ``meta`` device), the shrinker takes the same steps to
the same 1-minimal reproducer, the committed corpus reproducer fails under
the blinded corruption injector and passes with the healthy engine, and a
generated remesh is a skip in the port."""

import dataclasses
import json
import os

import pytest

from corrosion_tpu.resilience import chaos as jchaos
from corrosion_tpu.resilience import fuzz as jfuzz
from corrosion_tpu_torch.resilience import chaos, fuzz

SEEDS = range(64)
#: one state replica at the chaos shapes, bytes (the JAX package's
#: projection of the same rungs)
LADDER_BYTES = {24: 37_372, 64: 99_652, 256: 398_596, 1024: 1_594_372,
                4096: 6_377_476}


@pytest.mark.parametrize("profile", ["fast", "scale"])
def test_gen_script_equals_jax(profile, monkeypatch):
    # the JAX generator prices its ladder on every call; its ladder is
    # held to the port's below, so price it once here
    ladder = jfuzz.fuzz_ladder()
    monkeypatch.setattr(jfuzz, "fuzz_ladder", lambda: ladder)
    for seed in SEEDS:
        script = fuzz.gen_script(seed, profile=profile)
        assert chaos.script_to_json(script) == jchaos.script_to_json(
            jfuzz.gen_script(seed, profile=profile)), seed
        assert fuzz.grammar_valid(script)
        assert fuzz.grammar_valid(script) == jfuzz.grammar_valid(
            jfuzz.gen_script(seed, profile=profile))


def test_fuzz_ladder_equals_jax():
    ladder = fuzz.fuzz_ladder()
    assert ladder == jfuzz.fuzz_ladder()
    assert {r["n_nodes"]: r["bytes"] for r in ladder} == LADDER_BYTES
    assert [r["slow"] for r in ladder] == [False, False, True, True, True]


def test_gen_script_refuses_an_unknown_profile():
    with pytest.raises(ValueError, match="unknown fuzz profile"):
        fuzz.gen_script(0, profile="huge")


def _corrupt_only(script) -> bool:
    return any(i.kind == "corrupt_checkpoint" for i in script.injections)


def test_shrinker_takes_jax_steps_to_the_failing_injection():
    """With a synthetic oracle that fails exactly when a corruption
    injection is present, the shrinker strips every other phase, injection
    and knob, in the JAX package's steps, to its minimal script."""
    script = fuzz.gen_script(24)
    assert _corrupt_only(script)
    minimal, runs = fuzz.shrink(script, seed=24, failing=_corrupt_only)
    jminimal, jruns = jfuzz.shrink(jfuzz.gen_script(24), seed=24,
                                   failing=_corrupt_only)
    assert runs == jruns <= 200
    assert chaos.script_to_json(minimal) == jchaos.script_to_json(jminimal)
    assert [i.kind for i in minimal.injections] == ["corrupt_checkpoint"]
    assert minimal.n_nodes == min(fuzz.LADDER_RUNGS) and fuzz.grammar_valid(minimal)
    # 1-minimal: no in-grammar single-step reduction still fails
    for cand in fuzz._shrink_candidates(dataclasses.replace(minimal,
                                                            name=script.name)):
        try:
            cand.validate()
        except ValueError:
            continue
        assert not fuzz.grammar_valid(cand) or not _corrupt_only(cand), cand


def test_shrink_refuses_a_passing_script():
    with pytest.raises(ValueError, match="refusing to shrink"):
        fuzz.shrink(fuzz.gen_script(0), seed=0, failing=lambda s: False)


def test_drop_phase_reindexes_injections():
    script = fuzz.gen_script(8)
    kept = fuzz._drop_phase(script, 0)
    jkept = jfuzz._drop_phase(jfuzz.gen_script(8), 0)
    assert chaos.script_to_json(kept) == jchaos.script_to_json(jkept)
    assert all(0 <= i.phase < len(kept.phases) for i in kept.injections)


def test_broken_oracle_swaps_and_restores_the_injector():
    real = chaos.corrupt_checkpoint
    with fuzz.broken_corruption_oracle():
        assert chaos.corrupt_checkpoint is not real
    assert chaos.corrupt_checkpoint is real


def test_corpus_files_parse_and_compile_to_jax_traces():
    paths = fuzz.iter_corpus()
    assert paths == jfuzz.iter_corpus()
    for path in paths:
        script, seed, meta = fuzz.load_reproducer(path)
        jscript, jseed, jmeta = jfuzz.load_reproducer(path)
        assert (seed, meta) == (jseed, jmeta) and meta["note"]
        assert os.path.basename(path) == f"{script.name}.json"
        assert (chaos.compile_scenario(script, seed, device="cpu")[2]
                == jchaos.compile_scenario(jscript, jseed)[2])


def test_reproducer_round_trips_through_the_envelope(tmp_path):
    script = fuzz.gen_script(5)
    path = fuzz.save_reproducer(script, seed=5, note="probe",
                                path=str(tmp_path / "probe.json"))
    again, seed, meta = fuzz.load_reproducer(path)
    assert again == script and seed == 5 and meta["tier1"] is False
    with open(path) as f:
        payload = json.load(f)
    payload["schema"] = 999
    with open(path, "w") as f:
        json.dump(payload, f)
    with pytest.raises(ValueError, match="corpus schema"):
        fuzz.load_reproducer(path)


def test_corpus_reproducer_fails_blinded_and_passes_healthy():
    """The find, shrink and replay pipeline is live in the port: the
    committed reproducer fails under the blinded injector and passes with
    the healthy engine."""
    script, seed, meta = fuzz.load_reproducer(
        os.path.join(fuzz.corpus_dir(), "fuzz-000024-min.json"))
    assert meta["tier1"] and _corrupt_only(script)
    with fuzz.broken_corruption_oracle():
        dark = chaos.run_scenario(script, seed=seed, device="cpu")
    assert not dark["ok"]
    assert any("NOT detected" in p for p in dark["problems"])
    healthy = chaos.run_scenario(script, seed=seed, device="cpu")
    assert healthy["ok"], healthy.get("problems")
    assert healthy["converged"] and healthy["quiesced"] and healthy["bitwise_match"]


def test_run_fuzz_record_and_the_remesh_skip(monkeypatch):
    """Seed 2 draws a remesh: a skip in the port, with its reason, and no
    round run; a failing case carries its script."""
    out = fuzz.run_fuzz([2], device="cpu")
    (case,) = out["cases"]
    assert out["ok"] and out["platform"] == "cpu" and case["ok"]
    assert "remesh" in case["injections"] and "item 14" in case["skipped"]
    assert case["trace_digest"] == jchaos.compile_scenario(
        jfuzz.gen_script(2), 2)[2]
    assert out["ladder"] == list(jfuzz.fuzz_ladder())

    def fake(script, seed=0, device="cuda"):
        return {"ok": False, "problems": ["synthetic failure"],
                "trace_digest": "x"}

    monkeypatch.setattr(chaos, "run_scenario", fake)
    out = fuzz.run_fuzz([3], device="cpu")
    (case,) = out["cases"]
    assert not out["ok"] and case["problems"] == ["synthetic failure"]
    assert chaos.script_from_json(case["script"]) == fuzz.gen_script(3)
    assert out["per_seed"]["3"]["ok"] is False


def test_live_shrink_under_the_mutation_fixture():
    """The whole pipeline on the port's engine: the blinded injector fails
    gen_script(24), the shrinker carves it to a corruption-only script, and
    the healthy engine passes that reproducer."""
    script = fuzz.gen_script(24)
    with fuzz.broken_corruption_oracle():
        minimal, _runs = fuzz.shrink(script, seed=24, device="cpu")
    assert [i.kind for i in minimal.injections] == ["corrupt_checkpoint"]
    assert len(minimal.phases) <= 3
    rec = chaos.run_scenario(minimal, seed=24, device="cpu")
    assert rec["ok"], rec.get("problems")


def test_fuzz_cli_lists_the_jax_scripts(capsys):
    from corrosion_tpu import cli as jcli
    from corrosion_tpu_torch import cli

    assert cli.main(["fuzz", "--list", "--seeds", "0:7"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["fuzz", "--list", "--seeds", "0:7"]) == 0
    assert got == capsys.readouterr().out and len(got.splitlines()) == 8


def test_chaos_fuzz_and_obs_modules_pull_in_no_jax():
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import corrosion_tpu_torch.resilience.chaos, corrosion_tpu_torch.resilience.fuzz\n"
        "import corrosion_tpu_torch.obs, corrosion_tpu_torch.sim.scenario\n"
        "import corrosion_tpu_torch.cli, corrosion_tpu_torch.agent\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'corrosion_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
