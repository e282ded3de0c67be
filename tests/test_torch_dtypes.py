"""The port's ``dtype-flow`` rule (``corrosion_tpu_torch/analysis/dtypes.py``)
against the JAX package's, on the CPU. Exact equality throughout.

- Every ``dtype-widen`` fixture of ``tests/test_analysis_v2.py`` (read out
  of that file's syntax tree) has a torch-spelled twin with the same line
  layout that fires the same ``(line, rule)`` list through the port as the
  original through JAX, except where torch promotes otherwise: those are
  tabled, and real torch shows the dtype.
- Every row of ``dtypes.py``'s promotion table: the rule's dtype equals
  what real torch computes, and the jnp column what real jnp computes.
- Torch-only boundaries: ``arange`` (int64), a 0-dim int32 tensor,
  ``where`` with a scalar or a tensor, device moves and cast methods.
- The registries equal JAX's, and one CPU round at N=64 under each of the
  three knob sets of ``tests/test_cost.py`` leaves every ``NARROW_LEAVES``
  name in the carry at the width JAX's traced carry has.
- The package is clean under ``dtype-flow``, and ``lint`` lists both new
  rules and runs them from the command line."""

import ast
import functools
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from corrosion_tpu.analysis import cost as jcost
from corrosion_tpu.analysis import dtypes as jdtypes
from corrosion_tpu.analysis.runner import check_source as j_check_source
from corrosion_tpu.sim.scale_step import scale_run_rounds as j_scale_run_rounds
from corrosion_tpu.sim.scale_step import scale_sim_config as jscale_sim_config
from corrosion_tpu_torch import cli
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.analysis import dtypes
from corrosion_tpu_torch.analysis.callgraph import ModuleInfo, Project
from corrosion_tpu_torch.analysis.runner import check_source, run_paths
from corrosion_tpu_torch.obs.memory import _walk_leaves
from corrosion_tpu_torch.sim import scale_step as S
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "corrosion_tpu_torch"


def _jax_fixtures():
    """``"<test name>-<i>"`` -> the source of the i-th ``lint(src,
    ["dtype-flow"])`` call of ``tests/test_analysis_v2.py``."""
    tree = ast.parse((ROOT / "tests" / "test_analysis_v2.py").read_text())
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                 and isinstance(c.func, ast.Name) and c.func.id == "lint"
                 and len(c.args) == 2 and isinstance(c.args[1], ast.List)
                 and [e.value for e in c.args[1].elts] == ["dtype-flow"]]
        for i, call in enumerate(sorted(calls, key=lambda c: c.lineno)):
            out[f"{fn.name}-{i}"] = textwrap.dedent(call.args[0].value)
    return out


JAX_FIXTURES = _jax_fixtures()

#: JAX fixture -> its torch twin (same line layout)
TWINS = {
    "test_dtype_widen_fires_at_replace_boundary-0": """
        import torch

        def carry_out(st, n):
            bumped = st.swim.mem_timer + torch.arange(4, dtype=torch.int32)
            return st.swim._replace(mem_timer=bumped)
    """,
    "test_dtype_widen_clean_with_explicit_cast-0": """
        import torch

        def carry_out(st, n):
            bumped = st.swim.mem_timer + torch.arange(4, dtype=torch.int32)
            return st.swim._replace(mem_timer=bumped.to(torch.int16))
    """,
    "test_dtype_widen_weak_scalars_do_not_widen-0": """
        def carry_out(st):
            return st.swim._replace(mem_timer=st.swim.mem_timer + 1)
    """,
    "test_dtype_widen_kernel_ref_store-0": """
        import torch

        def kernel(consts, m_timer, o_timer):
            timer = m_timer + torch.arange(4, dtype=torch.int32)
            o_timer[:] = timer
    """,
    "test_dtype_widen_fused_ingest_queue_refs_registered-0": """
        import torch

        def ingest_kernel(cfg_tuple, q_tx, o_q_cell, o_q_tx):
            decremented = q_tx - torch.arange(4, dtype=torch.int32)
            o_q_tx[:] = decremented
    """,
    "test_dtype_widen_fused_ingest_queue_refs_registered-1": """
        import torch

        def ingest_kernel(cfg_tuple, q_tx, o_q_tx):
            decremented = q_tx - torch.arange(4, dtype=torch.int32)
            o_q_tx[:] = decremented.to(o_q_tx.dtype)
    """,
    "test_dtype_widen_sum_and_clip_promote-0": """
        import torch

        def carry_out(st, bound):
            total = torch.sum(st.swim.mem_timer)  # int16 -> 0-dim int64
            return st.swim._replace(mem_timer=st.swim.mem_timer * 0 + total)
    """,
    "test_dtype_widen_sum_and_clip_promote-1": """
        import torch

        def carry_out(st, n):
            hi = torch.arange(4, dtype=torch.int32)
            t = torch.clamp(st.swim.mem_timer, max=hi)  # promotes to int32
            return st.swim._replace(mem_timer=t)
    """,
    "test_dtype_widen_sum_and_clip_promote-2": """
        import torch

        def carry_out(st):
            t = torch.cumsum(st.swim.mem_timer, 0)
            return st.swim._replace(mem_timer=t)
    """,
    "test_dtype_widen_dynamic_astype_is_clean-0": """
        import torch

        def kernel(consts, m_timer, o_timer):
            timer = m_timer + torch.arange(4, dtype=torch.int32)
            o_timer[:] = timer.to(o_timer.dtype)
    """,
}

#: where torch promotes otherwise: fixture -> (the expression in real torch
#: on an int16 tensor ``a16``, the dtype torch gives, JAX's findings, the
#: port's findings)
TORCH_DIFFERS = {
    # a 0-dim tensor does not widen a tensor with dims
    "test_dtype_widen_sum_and_clip_promote-0": (
        "a16 * 0 + torch.sum(a16)", torch.int16,
        [(6, "dtype-widen")], []),
    # cumsum of an integer tensor accumulates in int64
    "test_dtype_widen_sum_and_clip_promote-2": (
        "torch.cumsum(a16, 0)", torch.int64,
        [], [(6, "dtype-widen")]),
}


def _flow(src, jax_engine=False):
    if jax_engine:
        found = j_check_source(src, "fixture.py", {"dtype-flow": jdtypes.check_project})
    else:
        found = check_source(src, "fixture.py", {"dtype-flow": dtypes.check_project})
    return [(f.line, f.rule) for f in found]


def test_every_jax_dtype_fixture_has_a_twin():
    assert set(JAX_FIXTURES) == set(TWINS) and len(TWINS) == 10


@pytest.mark.parametrize("name", sorted(TWINS))
def test_dtype_twin_fires_as_jax(name):
    jax_src, twin = JAX_FIXTURES[name], textwrap.dedent(TWINS[name])
    assert len(twin.splitlines()) == len(jax_src.splitlines())
    want, got = _flow(jax_src, jax_engine=True), _flow(twin)
    if name in TORCH_DIFFERS:
        expr, torch_dtype, jax_found, port_found = TORCH_DIFFERS[name]
        a16 = torch.ones((2, 4), dtype=torch.int16)
        assert eval(expr, {"torch": torch, "a16": a16}).dtype == torch_dtype
        assert (want, got) == (jax_found, port_found)
    else:
        assert got == want


def test_widen_message_names_the_plane_and_width():
    found = check_source(textwrap.dedent(TWINS["test_dtype_widen_fires_at_replace_boundary-0"]),
                         "fixture.py", {"dtype-flow": dtypes.check_project})
    assert len(found) == 1 and "`mem_timer` (int16)" in found[0].message
    assert "int32" in found[0].message and ".to(torch.int16)" in found[0].hint


# --- the promotion table ----------------------------------------------------

#: dtypes.py's table: (torch expression, jnp expression, torch dtype, jnp dtype)
PROMOTION_TABLE = [
    ("a16 + 1", "a16 + 1", "int16", "int16"),
    ("a16 + torch.tensor(1, dtype=torch.int32)", "a16 + jnp.asarray(1, jnp.int32)",
     "int16", "int32"),
    ("a16 + i32", "a16 + i32", "int32", "int32"),
    ("torch.where(m, a16, 0)", "jnp.where(m, a16, 0)", "int16", "int16"),
    ("torch.where(m, a16, i32)", "jnp.where(m, a16, i32)", "int32", "int32"),
    ("torch.clamp(a16, lo16, i32)", "jnp.clip(a16, lo16, i32)", "int32", "int32"),
    ("torch.arange(n)", "jnp.arange(n)", "int64", "int32"),
    ("torch.sum(a16)", "jnp.sum(a16)", "int64", "int32"),
    ("a16 * 0 + torch.sum(a16)", "a16 * 0 + jnp.sum(a16)", "int16", "int32"),
    ("torch.sum(a16, dim=1, keepdim=True)", "jnp.sum(a16, axis=1, keepdims=True)",
     "int64", "int32"),
    ("torch.cumsum(a16, 0)", "jnp.cumsum(a16, 0)", "int64", "int16"),
    ("a16.amax(dim=1)", "a16.max(axis=1)", "int16", "int16"),
    ("torch.max(a16)", "jnp.max(a16)", "int16", "int16"),
]

_PRELUDE = """
import torch

def f(st, n):
    a16 = st.swim.mem_timer
    lo16 = st.swim.q_cell
    i32 = torch.arange(4, dtype=torch.int32)
    m = st.swim.mem_timer > 0
    x = {expr}
"""


def _rule_dtype(expr):
    src = _PRELUDE.format(expr=expr)
    mod = ModuleInfo(path="fixture.py", name="fixture", tree=ast.parse(src), source=src,
                     suppressions={}, bad_suppressions=[])
    fn = Project([mod]).functions["fixture.f"]
    x = dtypes._Analysis(fn, []).run(list(fn.node.body))["x"]
    return x.name if x is not None else None


@pytest.mark.parametrize("row", PROMOTION_TABLE, ids=[r[0] for r in PROMOTION_TABLE])
def test_promotion_table_row(row):
    texpr, jexpr, tdt, jdt = row
    a16 = torch.ones((2, 4), dtype=torch.int16)
    got = eval(texpr, {"torch": torch, "a16": a16, "lo16": a16, "n": 4,
                       "i32": torch.arange(4, dtype=torch.int32), "m": a16 > 0})
    j16 = jnp.ones((2, 4), jnp.int16)
    jgot = eval(jexpr, {"jnp": jnp, "a16": j16, "lo16": j16, "n": 4,
                        "i32": jnp.arange(4, dtype=jnp.int32), "m": j16 > 0})
    assert (str(got.dtype), str(jgot.dtype)) == (f"torch.{tdt}", jdt)
    assert _rule_dtype(texpr) == tdt


# --- torch-only boundaries -------------------------------------------------

TORCH_CASES = {
    "arange-int64": ("torch.arange(n)", True),
    "arange-int16": ("torch.arange(n, dtype=torch.int16)", False),
    "zerodim-int32": ("plane + torch.tensor(1, dtype=torch.int32)", False),
    "where-scalar": ("torch.where(mask, plane, 0)", False),
    "where-tensor": ("torch.where(mask, plane, i32)", True),
    "where-zerodim": ("torch.where(mask, plane, torch.tensor(1, dtype=torch.int32))", False),
    "device-move-keeps": ("(plane + i32).to(dev)", True),
    "string-device-keeps": ('(plane + i32).to("cuda")', True),
    "literal-cast": ("(plane + i32).to(torch.int16)", False),
    "dtype-keyword-cast": ("(plane + i32).to(device=dev, dtype=torch.int16)", False),
    "dynamic-cast": ("(plane + i32).to(plane.dtype)", False),
    "short": ("(plane + i32).short()", False),
    "long": ("plane.long()", True),
    "sum-keepdim": ("plane.sum(dim=1, keepdim=True)", True),
    "sum-dtype": ("plane.sum(dim=1, keepdim=True, dtype=torch.int16)", False),
    "amax": ("plane.amax(dim=1, keepdim=True)", False),
    "maximum-tensor": ("torch.maximum(plane, i32)", True),
    "clamp-scalar": ("torch.clamp(plane, min=0)", False),
    "in-place": ("plane.add_(i32)", False),
    "int16-wider-than-int8": ("plane.to(torch.int16)", False),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_only_boundaries(case):
    expr, flags = TORCH_CASES[case]
    src = textwrap.dedent(f"""
        import torch

        def carry_out(st, n, mask, dev):
            plane = st.swim.mem_timer
            i32 = torch.arange(4, dtype=torch.int32)
            return st.swim._replace(mem_timer={expr})
    """)
    assert _flow(src) == ([(7, "dtype-widen")] if flags else [])


def test_int16_into_an_int8_plane_flags():
    src = textwrap.dedent("""
        def carry_out(st):
            return st.crdt._replace(q_tx=st.crdt.q_cell + 1)
    """)
    assert _flow(src) == [(3, "dtype-widen")]


# --- registries and the real carry -----------------------------------------

def test_registries_equal_jax():
    assert dtypes.RULE == jdtypes.RULE
    assert dtypes.NARROW_LEAVES == jdtypes.NARROW_LEAVES
    assert dtypes.NARROW_REFS == jdtypes.NARROW_REFS
    for leaf in ("q_cell", "q_tx"):
        assert dtypes.NARROW_REFS[f"o_{leaf}"] == dtypes.NARROW_LEAVES[leaf]


KNOBS = [
    {"narrow_int8": True, "narrow_q_int8": True},
    {"narrow_int8": True, "narrow_q_int8": False},
    {"narrow_int8": False, "narrow_q_int8": True},
]
SMALL = dict(m_slots=8, n_origins=4, n_rows=4, n_cols=2, sync_interval=4)


def _port_widths(cfg, rounds=2):
    st = S.ScaleSimState.create(cfg, "cpu")
    net = S.NetModel.create(cfg.n_nodes, drop_prob=0.05, device="cpu")
    mask = prng.uniform(prng.key(3), (rounds, cfg.n_nodes), "cpu") < 0.25
    inputs = S.make_write_inputs(cfg, prng.key(8), rounds, mask, "cpu")
    st, _infos = S.scale_run_rounds(cfg, st, net, prng.key(0), inputs)
    leaves: dict = {}
    _walk_leaves(st, "", leaves)
    widths: dict = {}
    for name, t in leaves.items():
        widths.setdefault(name.rsplit(".", 1)[-1], set()).add(t.element_size() * 8)
    return widths


def _jax_widths(cfg, rounds=2):
    st = jax.eval_shape(functools.partial(j_scale_run_rounds, cfg),
                        *jcost._scale_specs(cfg, rounds))[0]
    widths: dict = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(st)[0]:
        name = next((p.name for p in reversed(path) if hasattr(p, "name")), None)
        if name is not None:
            widths.setdefault(name, set()).add(leaf.dtype.itemsize * 8)
    return widths


@pytest.mark.parametrize("knobs", KNOBS, ids=["i8-q8", "i8", "q8"])
def test_narrow_leaves_keep_their_width_through_a_round(knobs):
    got = _port_widths(S.scale_sim_config(64, **SMALL, **knobs))
    want = _jax_widths(jscale_sim_config(64, **SMALL, **knobs))
    for name, declared in dtypes.NARROW_LEAVES.items():
        assert got[name] == want[name], name
        (bits,) = got[name]
        off = (name == "mem_tx" and not knobs["narrow_int8"]) or (
            name in ("q_seq", "q_nseq", "q_tx") and not knobs["narrow_q_int8"])
        assert bits >= declared if off else bits == declared, (name, bits)


def test_package_is_clean_under_dtype_flow():
    assert run_paths([str(PKG)], ["dtype-flow"]) == []


def test_lint_lists_and_runs_both_rules(capsys):
    assert cli.main(["lint", "--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert "densify: " in listed and "dtype-widen: " in listed
    assert cli.main(["lint", "--checkers", "densify,dtype-flow", str(PKG)]) == 0
    capsys.readouterr()
