"""The port's load harness (``obs/load.py``) and host-plane chaos scenario
(``resilience/serve_overload.py``) against the JAX package's.

The seeded plans (``plan_ops``, ``plan_overload``, ``plan_serve_overload``)
and their digests equal JAX's for seeds 0-4, and ``percentiles`` equals
JAX's. The rigs then run on the CPU: ``load --device cpu`` at a small
traffic, a small guarded overload arm, and ``serve-overload`` with the op
plan of its defaults. A serve-overload verdict is held to JAX's recorded
one (``tests/data/serve_overload_jax.json``) on the fields that are pure in
the seed; the others count what the wall clock let through. The port's
rounds at N=8-16 are slower than JAX's, so the rigs' time constants are
scaled to its pace, and each run must then pass every oracle and gate that
JAX's test holds: the slow consumer stalls ``SLOW_MS`` (the defaults' 25 ms
never overload it at the port's pace), and the small guarded overload arm
gives its closed-loop client ``CLOSED_RETRIES`` 503 retries and its p99
delivery lag (which counts a retried write's wait from its first attempt)
``LAG_BOUND_S``."""

import json
import os
from pathlib import Path

import pytest

import chip_smoke
from corrosion_tpu.obs import load as jload
from corrosion_tpu.resilience import serve_overload as jsovl
from corrosion_tpu_torch import cli
from corrosion_tpu_torch.config import ServeConfig
from corrosion_tpu_torch.obs import load
from corrosion_tpu_torch.resilience import serve_overload as sovl

ROOT = Path(__file__).resolve().parent.parent
SERVE_VERDICT = ROOT / chip_smoke.SERVE_OVERLOAD_VERDICT
#: the slow consumer's stall, as on the card (the defaults' is 25 ms)
SLOW_MS = chip_smoke.SERVE_OVERLOAD_SLOW_MS
#: the closed-loop client's 503 retries in the small guarded run (JAX's 16)
CLOSED_RETRIES = 64
#: its lag bound (JAX's 2.5 s): the closed loop's retry window, 0.25 s a retry
LAG_BOUND_S = CLOSED_RETRIES * 0.25

PLANS = {
    "plan_ops": lambda m, s: m.plan_ops(s, writers=4, write_ops=32,
                                        pg_readers=2, pg_ops=32, keys=12),
    "plan_ops_small": lambda m, s: m.plan_ops(s, writers=3, write_ops=5,
                                              pg_readers=1, pg_ops=7, keys=4),
    "plan_overload": lambda m, s: m.plan_overload(s, (2, 4, 8), 30, 32, 24),
    "plan_serve_overload": lambda m, s: m.plan_serve_overload(s, 4, 40, 12),
}


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plans_equal_jax(plan, seed):
    port = sovl if plan == "plan_serve_overload" else load
    jax = jsovl if plan == "plan_serve_overload" else jload
    got, want = PLANS[plan](port, seed), PLANS[plan](jax, seed)
    assert got == want and len(want["digest"]) == 16


@pytest.mark.parametrize("samples", [
    [], [0.25], [3.0, 1.0, 2.0], [i / 100.0 for i in range(1, 101)],
    [0.001 * (i * 7919 % 997) for i in range(333)],
], ids=["empty", "one", "three", "hundred", "scrambled"])
def test_percentiles_equal_jax(samples):
    for qs in ((0.5, 0.95, 0.99), (0.0, 0.25, 1.0)):
        assert load.percentiles(samples, qs) == jload.percentiles(samples, qs)


def test_chip_smokes_constants_are_jaxs():
    """The load rig's plan digest and the serve-overload record that
    ``chip_smoke.py`` holds the card to come from the JAX package."""
    ops = chip_smoke.LOAD_OPS
    assert chip_smoke.LOAD_PLAN_DIGEST == jload.plan_ops(
        0, 4, ops, 2, ops, 12)["digest"] == load.plan_ops(0, 4, ops, 2, ops, 12)["digest"]
    assert chip_smoke.LOAD_OVERLOAD_PLAN_DIGEST == jload.plan_overload(
        0, (2, 4, 8), 30, 32, 24)["digest"]
    with open(SERVE_VERDICT) as f:
        want = json.load(f)["verdict"]
    assert want["ok"] and want["plan_digest"] == jsovl.plan_serve_overload(
        0, 4, 40, 12)["digest"]
    assert set(sovl.SEED_PURE_FIELDS) <= set(want)


def test_load_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "serve.json"
    argv = ["load", "--device", "cpu", "--writers", "2", "--subscribers", "1",
            "--pg-readers", "1", "--write-ops", "3", "--pg-ops", "3",
            "--keys", "4", "--seed", "3", "--output-json", str(out)]
    assert cli.main(argv) == 0
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == rec
    assert rec["ok"], rec["problems"]
    assert rec["plan_digest"] == jload.plan_ops(3, 2, 3, 1, 3, 4)["digest"]
    assert rec["agreement"]["transactions"] == {"client": 8, "server": 8, "ok": True}
    assert rec["agreement"]["pg_select"] == {"client": 3, "server": 3, "ok": True}
    assert rec["ops"]["write"]["count"] == 6 and rec["ops"]["pg_query"]["count"] == 3
    assert rec["ops"]["subscribe_delivery"]["count"] > 0
    assert rec["corrosan"] is False and "kernel_launches" in rec


def test_overload_guarded_arm_on_the_cpu():
    """JAX's small guarded run (a deliberately tiny guard) on the port, held
    to the JAX test's assertions: the plan is JAX's, the ramp sheds, the
    shed counters rise monotonically, the closed-loop client is absorbed
    whole, every client attempt (503s included) is server-accounted, nothing
    leaks and the record is ``ok``. The port's rounds are slower than JAX's,
    so the ramp's heavier stage lasts longer: the closed loop's retry window
    is made to outlast it (``CLOSED_RETRIES``), and the lag bound to hold a
    write retried through that window (``LAG_BOUND_S``)."""
    serve = ServeConfig(max_inflight=1, max_queue=0, queue_wait=0.02,
                        max_streams=8, retry_after_cap=5.0, sub_queue=2,
                        sub_shed_threshold=1 << 30, stream_sndbuf=4608)
    rec = load.run_overload(stages=(2, 4), write_ops=12, subscribers=2,
                            slow_subs=1, slow_ms=25.0, keys=16,
                            closed_loop_ops=6, pg_probes=3, seed=11,
                            warm_rounds=6, serve=serve,
                            closed_loop_retries=CLOSED_RETRIES,
                            lag_bound_s=LAG_BOUND_S, device="cpu")
    assert rec["kind"] == "serve_overload" and rec["guard"]
    assert rec["plan_digest"] == jload.plan_overload(
        11, stages=(2, 4), write_ops=12, keys=16, closed_loop_ops=6)["digest"]
    assert [st["posts"] for st in rec["stage_stats"]] == [2 * 12, 4 * 12]
    assert rec["contract"]["pressure_final"] > 0
    assert rec["contract"]["shed_monotone"]
    assert rec["closed_loop"]["done"] == 6
    assert rec["closed_loop"]["failed"] == 0
    assert rec["agreement"]["ok"], rec["agreement"]
    assert rec["leaked_threads"] == []
    assert rec["pg_probe"]["ok"] + rec["pg_probe"]["shed"] == 3
    assert rec["ok"], rec["problems"]


def test_overload_cli_passes_its_flags(monkeypatch, capsys):
    seen = {}

    def fake_bench(**kw):
        seen.update(kw)
        return {"ok": True}

    monkeypatch.setattr(load, "run_overload_bench", fake_bench)
    assert cli.main(["load", "--overload", "--device", "cpu", "--stages",
                     "1,3", "--slow-ms", "150", "--lag-bound", "15",
                     "--seed", "2"]) == 0
    assert seen == dict(stages=(1, 3), slow_subs=2, slow_ms=150.0,
                        lag_bound_s=15.0, closed_loop_retries=16, seed=2,
                        device="cpu")
    assert json.loads(capsys.readouterr().out)["ok"] is True
    # the flags chip_smoke.py runs the bench with on the card
    seen.clear()
    assert cli.main(["load", "--overload", "--device", "cpu",
                     *chip_smoke.LOAD_OVERLOAD_FLAGS]) == 0
    assert seen == dict(stages=(2, 4, 8), slow_subs=2, slow_ms=250.0,
                        lag_bound_s=25.0, closed_loop_retries=64, seed=0,
                        device="cpu")


def test_serve_overload_on_the_cpu():
    rec = sovl.run_serve_overload(seed=0, slow_ms=SLOW_MS, device="cpu")
    with open(SERVE_VERDICT) as f:
        want = json.load(f)["verdict"]
    for field in sovl.SEED_PURE_FIELDS:
        assert rec[field] == want[field], field
    assert rec["ok"], rec.get("problems")
    assert rec["subs_shed_total"] > 0 and rec["resyncs"] > 0
    assert rec["acked_writes"] + rec["rejected_writes"] == 4 * 40
    assert rec["ready_flap_applied"]


@pytest.mark.parametrize("rig", ["load", "overload", "serve_overload"])
def test_serving_rigs_raise_without_a_card(monkeypatch, rig):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"load": lambda: load.run_load(),
           "overload": lambda: load.run_overload_bench(),
           "serve_overload": lambda: sovl.run_serve_overload()}[rig]
    with pytest.raises(RuntimeError, match="CUDA requested"):
        run()


@pytest.mark.slow
def test_jax_serve_overload_record_is_current():
    """Rerun JAX's serve-overload at its defaults (``CHAOS_VERDICTS_WRITE=1``
    writes the record) and hold the file to it on the seed-pure fields."""
    rec = jsovl.run_serve_overload(seed=0)
    assert rec["ok"], rec.get("problems")
    if os.environ.get("CHAOS_VERDICTS_WRITE") == "1":
        doc = {"made_by": "corrosion_tpu.resilience.serve_overload."
                          "run_serve_overload, JAX on the CPU, at its defaults",
               "seed": 0, "verdict": rec}
        with open(SERVE_VERDICT, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    with open(SERVE_VERDICT) as f:
        want = json.load(f)["verdict"]
    for field in sovl.SEED_PURE_FIELDS:
        assert rec[field] == want[field], field
