"""The state-parity harness: the port's oracle cluster and its
``run_sim_script`` (on the CPU, plain kernel versions) against the JAX
package's, at the JAX parity tests' sizes (24 nodes, 4 origins, 8 cells, 12
rounds). Tolerance 0: the same script and seed give the same store planes,
alive mask and rounds-taken on both sides, and the checks pass where the
JAX package's own tests expect them to."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from corrosion_tpu.sim import parity as jparity
from corrosion_tpu_torch.sim import oracle, parity
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N_NODES, N_ORIGINS, N_CELLS, ROUNDS = 24, 4, 8, 12

#: name -> (generator, its arguments after the sizes)
SCRIPTS = {
    "single_writer": ("random_single_writer", (N_CELLS, ROUNDS), dict(seed=3)),
    "conflicting": ("random_conflicting", (N_CELLS, ROUNDS), dict(seed=5, hot_cells=2)),
    "delete_resurrect": ("random_delete_resurrect", (4, 2, 16), dict(seed=9)),
    "transactions": ("random_transactions", (N_CELLS, ROUNDS), dict(tx_cells=2, seed=3)),
    "full_mix": ("random_full_mix", (N_CELLS, 16), dict(seed=5)),
}


def _script(mod, name):
    gen, args, kw = SCRIPTS[name]
    return getattr(mod.WorkloadScript, gen)(N_NODES, N_ORIGINS, *args, **kw)


def test_oracle_module_is_a_copy():
    """The port's oracle is the JAX package's, line for line, past the
    module docstring."""
    import inspect

    from corrosion_tpu.sim import oracle as joracle

    def body(mod):
        return inspect.getsource(mod).split('"""', 2)[2]

    assert body(oracle) == body(joracle)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripts_and_oracle_cluster_match_jax(name):
    """The same generator gives the same script, and the port's oracle
    cluster the same converged store and rounds-taken as JAX's."""
    ours, theirs = _script(parity, name), _script(jparity, name)
    assert ours.writes == theirs.writes and ours.faults == theirs.faults
    assert ours.written_values() == theirs.written_values()
    assert ours.max_tx_cells == theirs.max_tx_cells
    a = parity.OracleCluster(N_NODES, N_ORIGINS, ours.n_cells, seed=1)
    b = jparity.OracleCluster(N_NODES, N_ORIGINS, theirs.n_cells, seed=1)
    taken = a.run(ours)
    assert taken > 0 and taken == b.run(theirs)
    for p, q in zip(a.store_planes(), b.store_planes()):
        assert p.dtype == q.dtype and np.array_equal(p, q)


#: (script, run_sim_script keyword arguments, the check JAX's tests apply)
RUNS = {
    "single_writer": ("single_writer", dict(seed=3), "bitwise"),
    "single_writer_loss": ("single_writer", dict(seed=11, drop_prob=0.05), "bitwise"),
    "transactions_tx2": ("transactions", dict(seed=3), "bitwise"),
    "full_mix_faults": ("full_mix", dict(seed=2, settle_rounds=256), "agreement"),
    "full_mix_quiet_on": ("full_mix", dict(seed=2, settle_rounds=256, quiet="on"),
                          "agreement"),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_sim_script_bitwise_equal_to_jax(run):
    name, kw, check = RUNS[run]
    script = _script(parity, name)
    planes, alive, taken = parity.run_sim_script(script, device="cpu", **kw)
    j_planes, j_alive, j_taken = jparity.run_sim_script(_script(jparity, name), **kw)
    assert taken > 0 and taken == j_taken
    assert np.array_equal(alive, j_alive)
    assert len(planes) == len(j_planes) == 5
    for p, q in zip(planes, j_planes):
        assert p.dtype == q.dtype and p.shape == q.shape and np.array_equal(p, q)
    if check == "bitwise":
        oc = parity.OracleCluster(N_NODES, N_ORIGINS, script.n_cells, seed=1)
        assert oc.run(script) > 0
        assert parity.check_bitwise_parity(oc, planes, alive) == []
    else:
        assert parity.check_agreement_validity(script, planes, alive) == []
    if name == "full_mix":
        assert any(e[0] == "kill" for evs in script.faults for e in evs)
        assert any(e[0] == "partition" for evs in script.faults for e in evs)


def test_checks_report_a_divergence():
    """The comparison functions name the plane and cells that differ."""
    script = _script(parity, "single_writer")
    oc = parity.OracleCluster(N_NODES, N_ORIGINS, script.n_cells, seed=1)
    assert oc.run(script) > 0
    planes = tuple(np.tile(p, (N_NODES, 1)) for p in oc.store_planes())
    alive = np.ones(N_NODES, bool)
    assert parity.check_bitwise_parity(oc, planes, alive) == []
    assert parity.check_agreement_validity(script, planes, alive) == []
    bad = tuple(p.copy() for p in planes)
    bad[1][5, 2] += 1
    assert "value plane: sim node 5" in parity.check_bitwise_parity(oc, bad, alive)[0]
    assert "agreement violated on val" in parity.check_agreement_validity(
        script, bad, alive)[0]
    alive[5] = False  # a dead node is not held to the store
    assert parity.check_bitwise_parity(oc, bad, alive) == []


def test_parity_and_soak_modules_pull_in_no_jax():
    code = (
        "import sys\n"
        "import corrosion_tpu_torch.sim.parity, corrosion_tpu_torch.checkpoint\n"
        "import corrosion_tpu_torch.resilience\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'corrosion_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=pathlib.Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
