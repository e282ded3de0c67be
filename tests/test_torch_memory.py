"""The port's static memory projection (``analysis/shapes.py``,
``obs/memory.py``'s ``static_report`` / ``projected_bytes`` and the
``mem-report`` command) against the JAX package's corrobudget, on the CPU:
field for field, symbolic shapes included, at the flagship, the 1M point,
the full view, a transaction config and rebound extents; the CLI's JSON
text for text; the budget gate of record; and the loud refusal of a leaf
that cannot be attributed."""

import dataclasses

import pytest
import torch

from corrosion_tpu import cli as jcli
from corrosion_tpu.analysis import shapes as jshapes
from corrosion_tpu.obs import memory as jmemory
from corrosion_tpu.sim.config import wan_config as jwan_config
from corrosion_tpu.sim.scale_step import scale_sim_config as jscale_sim_config
from corrosion_tpu_torch import cli
from corrosion_tpu_torch.analysis import shapes
from corrosion_tpu_torch.obs import memory
from corrosion_tpu_torch.sim.config import full_view_config, wan_config
from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

#: (port config, JAX config, mode, rebound N, rebound M, projected bytes)
POINTS = {
    "flagship-100k": (lambda: scale_sim_config(100_000), lambda: jscale_sim_config(100_000),
                      "scale", None, None, 370_100_004),
    "flagship-at-1m": (lambda: scale_sim_config(100_000), lambda: jscale_sim_config(100_000),
                       "scale", 1_000_000, None, 3_701_000_004),
    "flagship-at-64x8": (lambda: scale_sim_config(100_000), lambda: jscale_sim_config(100_000),
                         "scale", 64, 8, 186_692),
    "million-point": (million_config, lambda: jscale_sim_config(
        1_000_000, pig_members=16, narrow_int8=True, narrow_q_int8=True),
        "scale", None, None, 3_541_000_004),
    "full-view": (full_view_config, lambda: jwan_config(8192, n_origins=16, tx_max_cells=1),
                  "full", None, None, 1_110_876_164),
    "wan-tx8": (lambda: wan_config(8192, n_origins=16), lambda: jwan_config(8192, n_origins=16),
                "full", None, None, 1_133_649_924),
    "tx4": (lambda: scale_sim_config(100_000, n_origins=16, tx_max_cells=4),
            lambda: jscale_sim_config(100_000, n_origins=16, tx_max_cells=4),
            "scale", None, None, 443_300_004),
}


@pytest.mark.parametrize("point", sorted(POINTS))
def test_static_report_equals_jax(point):
    make, jmake, mode, n, m, total = POINTS[point]
    got = memory.static_report(make(), mode=mode, n_nodes=n, m_slots=m)
    want = jmemory.static_report(jmake(), mode=mode, n_nodes=n, m_slots=m)
    assert got == want
    assert list(got["tables"]) == list(want["tables"])  # leaf order too
    assert got["unresolved"] == [] and got["total_bytes"] == total
    if m is None:
        assert memory.projected_bytes(make(), n or make().n_nodes, mode=mode) == total


def test_symbols_and_budget_registries_equal_jax():
    assert shapes.SYMBOLS == jshapes.SYMBOLS
    assert shapes.PROPERTY_SYMBOLS == jshapes.PROPERTY_SYMBOLS
    assert shapes.HBM_BUDGET == jshapes.HBM_BUDGET


def _run(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("point", ["1000000", "64,8"])
def test_mem_report_project_prints_jax_json(point, capsys):
    got = _run(cli.main, ["mem-report", "--project", point], capsys)
    assert got == _run(jcli.main, ["mem-report", "--project", point], capsys)


@pytest.mark.parametrize("mode", ["scale", "full"])
def test_mem_report_live_cpu_prints_jax_json(mode, tmp_path, capsys):
    conf = tmp_path / "cfg.toml"
    conf.write_text(f'[sim]\nmode = "{mode}"\n')
    argv = ["mem-report", "-c", str(conf), "--n-nodes", "64"]
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert got == _run(jcli.main, argv, capsys)


def test_mem_report_live_builds_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default build would succeed")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["mem-report", "--n-nodes", "64"])


def test_mem_report_project_rejects_bad_points(capsys):
    for bad in ("0", "a", "1,2,3", "-5"):
        with pytest.raises(SystemExit):
            cli.main(["mem-report", "--project", bad])
    capsys.readouterr()


def test_budget_gate_of_record_and_int8_shrink():
    assert shapes.check_budget() == []
    point = dict(shapes.HBM_BUDGET["point"])
    base = shapes.static_inventory(mode="scale").report(point)
    i8 = dataclasses.replace(scale_sim_config(100_000), narrow_int8=True).validate()
    i8_total = shapes.static_inventory(i8, mode="scale").report(point)["total_bytes"]
    # mem_tx halves: 2 B/node/slot -> 1 B/node/slot at M=64
    assert base["total_bytes"] - i8_total == 64 * 1_000_000


def test_budget_gate_fires_on_a_new_full_width_plane():
    inv = shapes.static_inventory(mode="scale")
    n_dim, m_dim = (d for d in shapes.DIM_EXPRESSIONS if d.text in ("N", "M"))
    inv.leaves["swim.extra"] = shapes.LeafShape("swim.extra", (n_dim, m_dim), "int32")
    problems = shapes.check_budget(inv)
    assert len(problems) == 1 and "O(N*M)" in problems[0] and "swim.extra" in problems[0]


def _with_odd_leaves(monkeypatch):
    """The scale root's constructor with two leaves no expression explains: one
    sized by ``sync_peers`` (not an extent), one whose dtype moves with N."""
    _root, build = shapes.ROOTS["scale"]

    def odd(cfg):
        dt = torch.int16 if cfg.n_nodes % 2 else torch.int32
        return {"state": build(cfg),
                "z_peers": torch.zeros((cfg.n_nodes, cfg.sync_peers), device="meta"),
                "z_width": torch.zeros((cfg.n_nodes,), dtype=dt, device="meta")}

    monkeypatch.setitem(shapes.ROOTS, "scale", ("ScaleSimState", odd))


def test_projected_bytes_raises_on_an_unresolved_leaf(monkeypatch):
    _with_odd_leaves(monkeypatch)
    cfg = scale_sim_config(100_000)
    report = memory.static_report(cfg)
    assert report["unresolved"] == ["z_peers", "z_width"]
    assert "z_peers" not in report["tables"]
    assert report["tables"]["state.swim.mem_id"]["symbolic"] == "[N, M]"
    with pytest.raises(ValueError, match="unpriceable"):
        memory.projected_bytes(cfg, 1_000_000)
    assert any("z_peers" in p for p in shapes.check_budget(shapes.static_inventory(cfg)))


def test_live_audit_names_the_stored_dtypes_as_jax_does():
    from corrosion_tpu.sim.scale_step import ScaleSimState as JState
    from corrosion_tpu_torch.sim.scale_step import ScaleSimState

    got = memory.memory_report(ScaleSimState.create(scale_sim_config(64), "cpu"), 64)
    want = jmemory.memory_report(JState.create(jscale_sim_config(64)), 64)
    assert got == want
    assert got["tables"]["crdt.book.seen"]["dtype"] == "uint32"
