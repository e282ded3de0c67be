"""The port's scale-round fault compiler (``sim/scenario.py``:
``FaultPhase``, ``compile_scale_phase``) and the chaos engine's trace
compiler (``resilience/chaos.compile_scenario``) against the JAX package's,
on the CPU at the chaos shapes (N=24): the same key gives the same inputs,
nets, skew vectors and dead sets, byte for byte, and every registry
scenario the same ``trace_digest``. Tolerance 0."""

import dataclasses

import jax.random as jr
import numpy as np
import pytest

from corrosion_tpu.resilience import chaos as jchaos
from corrosion_tpu.sim import scale_step as jscale
from corrosion_tpu.sim import scenario as jscen
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.resilience import chaos
from corrosion_tpu_torch.sim import scale_step, scenario
from corrosion_tpu_torch.sim.broadcast import HLC_ROUND_BITS

N = 24
SHAPES = dict(m_slots=8, n_origins=4, n_rows=4, n_cols=2, sync_interval=4)

#: name -> four phases compiled in a row (the dead set threads through):
#: each knob alone, then all of them together
PHASE_SETS = {
    "writes": [dict(rounds=4, write_frac=0.3)] * 4,
    "kills": [dict(rounds=4, kill_frac=0.25), dict(rounds=4, kill_frac=0.5),
              dict(rounds=4), dict(rounds=4, kill_frac=1.0)],
    "revives": [dict(rounds=4, kill_frac=0.5),
                dict(rounds=4, revive_killed=True),
                dict(rounds=4, kill_frac=0.3),
                dict(rounds=4, kill_frac=0.3, revive_killed=True)],
    "partitions": [dict(rounds=4, partition_groups=g) for g in (2, 3, 1, 5)],
    "loss": [dict(rounds=4, drop_prob=p) for p in (0.02, 0.1, 0.0, 1.0)],
    "skew": [dict(rounds=4, clock_skew_rounds=1, clock_skew_frac=0.3),
             dict(rounds=4, clock_skew_rounds=12, clock_skew_frac=0.3),
             dict(rounds=4, clock_skew_rounds=12),
             dict(rounds=4, clock_skew_rounds=3, clock_skew_frac=1.0)],
    "together": [
        dict(rounds=8, write_frac=0.3, kill_frac=0.25, drop_prob=0.1,
             partition_groups=2, clock_skew_rounds=12, clock_skew_frac=0.3),
        dict(rounds=4, write_frac=0.2, revive_killed=True, drop_prob=0.15),
        dict(rounds=8, write_frac=1.0, kill_frac=1.0, partition_groups=3),
        dict(rounds=4, revive_killed=True, clock_skew_rounds=1,
             clock_skew_frac=0.5),
    ],
}


@pytest.fixture(scope="module")
def cfgs():
    return (scale_step.scale_sim_config(N, **SHAPES),
            jscale.scale_sim_config(N, **SHAPES))


def _same(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if hasattr(b, "numpy") else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), (what, np.argwhere(a != b)[:5])


@pytest.mark.parametrize("name", sorted(PHASE_SETS))
def test_compile_scale_phase_equals_jax(cfgs, name):
    cfg, jcfg = cfgs
    dead = jdead = None
    for i, kw in enumerate(PHASE_SETS[name]):
        inputs, net, skew, dead = scenario.compile_scale_phase(
            cfg, scenario.FaultPhase(**kw), prng.fold_in(prng.key(7), i), dead,
            device="cpu")
        jinputs, jnet, jskew, jdead = jscen.compile_scale_phase(
            jcfg, jscen.FaultPhase(**kw), jr.fold_in(jr.key(7), i), jdead)
        assert inputs._fields == jinputs._fields and net._fields == jnet._fields
        for f, a in zip(jinputs._fields, jinputs):
            _same(a, getattr(inputs, f), (name, i, f))
        for f, a in zip(jnet._fields, jnet):
            _same(a, getattr(net, f), (name, i, f))
        _same(jskew, skew, (name, i, "skew"))
        _same(jdead, dead, (name, i, "dead"))
        assert isinstance(skew, np.ndarray) and isinstance(dead, np.ndarray)


def test_compile_scale_phase_contract(cfgs):
    """Kills on round 0 only and never at a seed; revives exactly the dead
    set; no write from a corpse; skew is pre-shifted HLC units."""
    cfg, _ = cfgs
    inputs, _, _, dead = scenario.compile_scale_phase(
        cfg, scenario.FaultPhase(rounds=4, kill_frac=1.0, write_frac=1.0),
        prng.key(13), device="cpu")
    kill, wm = inputs.kill.numpy(), inputs.write_mask.numpy()
    assert kill[0, cfg.n_seeds:].all() and not kill[0, :cfg.n_seeds].any()
    assert not kill[1:].any() and np.array_equal(dead, kill[0])
    assert not wm[:, dead].any() and wm[:, ~dead].all()
    inputs2, _, skew, dead2 = scenario.compile_scale_phase(
        cfg, scenario.FaultPhase(rounds=4, revive_killed=True,
                                 clock_skew_rounds=3, clock_skew_frac=0.5),
        prng.key(14), dead, device="cpu")
    assert np.array_equal(inputs2.revive.numpy()[0], dead) and not dead2.any()
    assert set(np.unique(skew)) == {0, 3 << HLC_ROUND_BITS}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(jchaos.SCENARIOS))
def test_trace_digest_equals_jax(name, seed):
    """No round runs: the digest covers the script's JSON and every
    compiled input, net and skew byte, in the JAX package's order."""
    assert chaos.SCENARIOS[name] == _as_port(jchaos.SCENARIOS[name])
    _, traces, digest = chaos.compile_scenario(chaos.SCENARIOS[name], seed,
                                               device="cpu")
    _, jtraces, jdigest = jchaos.compile_scenario(jchaos.SCENARIOS[name], seed)
    assert digest == jdigest
    assert [(t.start, t.rounds) for t in traces] == [
        (t.start, t.rounds) for t in jtraces]


def _as_port(jscript):
    return chaos.script_from_json(jchaos.script_to_json(jscript))


#: malformed phases: every one refused by both packages
BAD_PHASES = [
    dict(rounds=0),
    dict(rounds=-4),
    dict(rounds=4, write_frac=1.5),
    dict(rounds=4, kill_frac=-0.1),
    dict(rounds=4, clock_skew_frac=2.0),
    dict(rounds=4, partition_groups=0),
    dict(rounds=4, clock_skew_rounds=-1),
    dict(rounds=4, drop_prob=1.5),
]


@pytest.mark.parametrize("kw", BAD_PHASES, ids=[str(i) for i in range(len(BAD_PHASES))])
def test_fault_phase_refuses_what_jax_refuses(cfgs, kw):
    cfg, jcfg = cfgs
    with pytest.raises(ValueError) as jerr:
        jscen.compile_scale_phase(jcfg, jscen.FaultPhase(**kw), jr.key(0))
    with pytest.raises(ValueError) as err:
        scenario.compile_scale_phase(cfg, scenario.FaultPhase(**kw),
                                     prng.key(0), device="cpu")
    assert str(err.value) == str(jerr.value)


def test_compile_refuses_a_dead_set_of_another_size(cfgs):
    cfg, jcfg = cfgs
    with pytest.raises(ValueError, match="dead mask shape"):
        jscen.compile_scale_phase(jcfg, jscen.FaultPhase(rounds=4), jr.key(0),
                                  dead=np.zeros(3, bool))
    with pytest.raises(ValueError, match="dead mask shape"):
        scenario.compile_scale_phase(cfg, scenario.FaultPhase(rounds=4),
                                     prng.key(0), dead=np.zeros(3, bool),
                                     device="cpu")


def test_compile_raises_without_cuda(cfgs, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        scenario.compile_scale_phase(cfgs[0], scenario.FaultPhase(rounds=4),
                                     prng.key(0))


def test_script_validation_refuses_what_jax_refuses():
    ph = scenario.FaultPhase(rounds=4)
    bad = [
        dict(name="empty", phases=()),
        dict(name="far", phases=(ph,),
             injections=(chaos.Injection(kind="preempt", phase=1),)),
        dict(name="kind", phases=(ph,),
             injections=(chaos.Injection(kind="nope", phase=0),)),
        dict(name="flip", phases=(ph,),
             injections=(chaos.Injection(kind="quiet_flip", phase=0),)),
        dict(name="seg", phases=(ph,), segment_rounds=0),
    ]
    for kw in bad:
        jkw = dict(kw, phases=tuple(jscen.FaultPhase(**dataclasses.asdict(p))
                                    for p in kw["phases"]),
                   injections=tuple(jchaos.Injection(**dataclasses.asdict(i))
                                    for i in kw.get("injections", ())))
        with pytest.raises(ValueError) as jerr:
            jchaos.ScenarioScript(**jkw).validate()
        with pytest.raises(ValueError) as err:
            chaos.ScenarioScript(**kw).validate()
        assert str(err.value) == str(jerr.value), kw["name"]
