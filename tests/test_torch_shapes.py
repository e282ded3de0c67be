"""The port's symbolic shape interpreter and its ``densify`` rule
(``corrosion_tpu_torch/analysis/shapes.py``) against the JAX package's
corrobudget, on the CPU. Exact equality throughout.

- Every densify fixture of ``tests/test_membudget.py`` (read out of that
  file's syntax tree) has a torch-spelled twin with the same line layout,
  and the twin fires the same ``(line, rule)`` list through the port as
  the original does through JAX; so do its create-less name collision and
  the mem-budget fixtures, priced by the port's gate on the interpreted
  inventory.
- Every symbolic regression there has a twin whose leaf shapes equal
  JAX's strings.
- The torch idioms: ``unsqueeze`` pairs, ``zeros(n, n)``, ``expand`` and
  ``repeat`` to ``[N, N]`` flag; ``table[idx]``, ``gather``,
  ``index_select`` and ``take_along_dim`` stay linear; a nested ``def``
  factory flags like the direct form.
- The interpreted inventory of the port's constructors equals the
  ``meta``-device inventory and JAX's interpreter, leaf for leaf, at the
  flagship, the 1M point, a transaction config and the full view.
- ``sim/`` and ``ops/`` are clean under densify, and the one suppression
  (``same_region``, as JAX's) covers a real finding."""

import ast
import dataclasses
import textwrap
from pathlib import Path

import pytest

from corrosion_tpu.analysis import shapes as jshapes
from corrosion_tpu.analysis.callgraph import ModuleInfo as JModuleInfo
from corrosion_tpu.analysis.callgraph import Project as JProject
from corrosion_tpu.analysis.runner import check_source as j_check_source
from corrosion_tpu.sim.config import wan_config as jwan_config
from corrosion_tpu.sim.scale_step import scale_sim_config as jscale_sim_config
from corrosion_tpu_torch.analysis import shapes
from corrosion_tpu_torch.analysis.callgraph import ModuleInfo, Project
from corrosion_tpu_torch.analysis.runner import check_source, run_paths
from corrosion_tpu_torch.sim.config import full_view_config, wan_config
from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "corrosion_tpu_torch"


def _jax_sources():
    """test name -> the fixture source of ``tests/test_membudget.py``: the
    function's ``src = '''...'''``, else the module constant it reads."""
    tree = ast.parse((ROOT / "tests" / "test_membudget.py").read_text())
    consts = {t.id: n.value.value for n in tree.body if isinstance(n, ast.Assign)
              and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)
              for t in n.targets if isinstance(t, ast.Name)}
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        srcs = [n.value.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id in ("src", "decoy")
                        for t in n.targets)
                and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)]
        names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)} & set(consts)
        if srcs:
            out[fn.name] = srcs[-1]
        elif names:
            out[fn.name] = consts[names.pop()]
    return out


JAX_SOURCES = _jax_sources()

NXN = '''
import torch


def pairwise(cfg, key):
    iarr = torch.arange(cfg.n_nodes, dtype=torch.int32)
    adj = iarr[:, None] == iarr[None, :]
    return torch.sum(adj)
'''

#: JAX test name -> the torch twin of its densify fixture (same lines)
DENSIFY_TWINS = {
    "test_densify_fires_on_nxn_broadcast": NXN,
    "test_densify_unknown_operand_never_flags": '''
import torch


def f(cfg, mystery):
    iarr = torch.arange(cfg.n_nodes, dtype=torch.int32)
    return iarr[:, None] * mystery
''',
    "test_densify_creation_and_eye_flag": '''
import torch


def f(cfg):
    n = cfg.n_nodes
    a = torch.zeros((n, n), dtype=torch.int32)
    b = torch.eye(n, dtype=torch.int32)
    return a, b
''',
    "test_densify_follows_local_lambda_factory": '''
import torch


def f(cfg):
    n = cfg.n_nodes
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    adj = z(n, n)
    return adj * 2
''',
    "test_densify_gather_of_table_is_linear": '''
import torch


def f(cfg, key):
    n, m = cfg.n_nodes, cfg.m_slots
    table = torch.zeros((n, m), dtype=torch.int32)
    src_ids = torch.arange(n, dtype=torch.int32)
    got = table[src_ids]
    return got * 2
''',
}

OVER_BUDGET = '''
from typing import NamedTuple
import torch
from torch import Tensor


class ScaleSimState(NamedTuple):
    big: Tensor
    ok: Tensor

    @staticmethod
    def create(cfg):
        n, m = cfg.n_nodes, cfg.m_slots
        big = torch.zeros((n, 64 * m), dtype=torch.int32)  # 16 KB/node
        return ScaleSimState(big=big, ok=torch.zeros(n, dtype=torch.int32))
'''


def _rules(findings):
    return [(f.line, f.rule) for f in findings]


def _densify(src):
    return _rules(check_source(src, "fixture_densify.py",
                               {"densify": shapes.check_densify}))


def _j_densify(src):
    return _rules(j_check_source(src, "fixture_densify.py",
                                 {"densify": jshapes.check_densify}))


def test_every_jax_densify_fixture_has_a_twin():
    densify = {n for n in JAX_SOURCES if n.startswith("test_densify")}
    assert densify - {"test_densify_reasoned_suppression"} == set(DENSIFY_TWINS)


@pytest.mark.parametrize("name", sorted(DENSIFY_TWINS))
def test_densify_twin_fires_as_jax(name):
    jax_src, twin = JAX_SOURCES[name], DENSIFY_TWINS[name]
    assert len(twin.splitlines()) == len(jax_src.splitlines())
    want = _j_densify(jax_src)
    assert _densify(twin) == want
    assert want == {"test_densify_fires_on_nxn_broadcast": [(7, "densify")],
                    "test_densify_creation_and_eye_flag": [(7, "densify"), (8, "densify")],
                    "test_densify_follows_local_lambda_factory": [(7, "densify")],
                    }.get(name, [])


@pytest.mark.parametrize("reason,rules", [
    ("  # corrolint: disable=densify -- deliberate dense fixture", []),
    # a reasonless suppression suppresses nothing and is itself a finding
    ("  # corrolint: disable=densify", ["densify", "suppression-missing-reason"]),
])
def test_densify_reasoned_suppression_as_jax(reason, rules):
    line = "iarr[:, None] == iarr[None, :]"
    mine = _densify(NXN.replace(line, line + reason))
    want = _j_densify(JAX_SOURCES["test_densify_reasoned_suppression"].replace(
        line, line + reason))
    assert mine == want
    assert sorted(r for _l, r in mine) == rules


def _project(*named_sources, jax=False):
    info, proj = (JModuleInfo, JProject) if jax else (ModuleInfo, Project)
    return proj([info(path=f"{name}.py", name=name, tree=ast.parse(src), source=src,
                      suppressions={}, bad_suppressions=[])
                 for name, src in named_sources])


def test_budget_ignores_create_less_name_collision():
    decoy = JAX_SOURCES["test_budget_ignores_create_less_name_collision"]
    project = _project(("decoy", decoy), ("real", OVER_BUDGET))
    assert shapes.index_classes(project)["ScaleSimState"].module.name == "real"
    problems = shapes.check_budget(shapes.build_inventory(project, "ScaleSimState"))
    assert len(problems) == 1 and "O(N*M)" in problems[0] and "big=" in problems[0]


def test_mem_budget_fixtures_priced_on_the_interpreted_inventory():
    """JAX's three mem-budget fixtures: over budget, an unpriceable leaf, and
    a walked set with no state root."""
    inv = shapes.build_inventory(_project(("f", OVER_BUDGET)), "ScaleSimState")
    problems = shapes.check_budget(inv)
    assert len(problems) == 1 and "1,000,000" in problems[0] and "big=" in problems[0]
    assert inv.leaves["big"].line == 14  # JAX's finding line: the leaf's creation
    src = OVER_BUDGET.replace("torch.zeros((n, 64 * m), dtype=torch.int32)",
                              "mystery_table(cfg)")
    problems = shapes.check_budget(shapes.build_inventory(_project(("f", src)),
                                                          "ScaleSimState"))
    assert any("`big`" in p and "no resolvable shape" in p for p in problems)
    assert shapes.build_inventory(_project(("f", "def f():\n    return 1\n")),
                                  "ScaleSimState") is None


# --- symbolic regressions --------------------------------------------------

SYMBOLIC_TWINS = {
    "test_symbolic_tuple_packing_and_shape_unpack": '''
from typing import NamedTuple
import torch
from torch import Tensor


class Inner(NamedTuple):
    a: Tensor

    @staticmethod
    def create(cfg):
        return Inner(a=torch.zeros((cfg.n_nodes, cfg.m_slots), dtype=torch.int32))


class ScaleSimState(NamedTuple):
    pair: tuple
    b: Tensor

    @staticmethod
    def create(cfg):
        inner = Inner.create(cfg)
        n, m = inner.a.shape          # .shape tuple unpack
        x, y = torch.zeros(n, dtype=torch.int16), torch.zeros(n, m, dtype=torch.int8)
        pair = (x, y)                 # tuple packing into a field
        return ScaleSimState(pair=pair, b=inner.a)
''',
    "test_symbolic_branch_joins": '''
from typing import NamedTuple
import torch
from torch import Tensor


class ScaleSimState(NamedTuple):
    a: Tensor
    b: Tensor

    @staticmethod
    def create(cfg):
        n = cfg.n_nodes
        if cfg.tx_max_cells > 1:      # concrete config guard: one arm
            a = torch.zeros((n, cfg.partial_slots), dtype=torch.int32)
        else:
            a = torch.zeros((n, 1), dtype=torch.int32)
        if unknowable():              # join: same shape both arms
            b = torch.zeros(n, dtype=torch.int32)
        else:
            b = torch.zeros(n, dtype=torch.int32)
        return ScaleSimState(a=a, b=b)
''',
    "test_symbolic_replace_threading": '''
from typing import NamedTuple
import torch
from torch import Tensor


class ScaleSimState(NamedTuple):
    a: Tensor
    b: Tensor

    @staticmethod
    def create(cfg):
        n = cfg.n_nodes
        st = ScaleSimState(a=torch.zeros(n, dtype=torch.int32),
                           b=torch.zeros(n, dtype=torch.int32))
        st = st._replace(b=torch.zeros((n, cfg.m_slots), dtype=torch.int16))
        st = st._replace(a=st.a.to(torch.int8))
        return st
''',
    "test_symbolic_lambda_factory": '''
from typing import NamedTuple
import torch
from torch import Tensor


class ScaleSimState(NamedTuple):
    a: Tensor
    b: Tensor

    @staticmethod
    def create(cfg):
        n, q = cfg.n_nodes, cfg.bcast_queue
        z = lambda *s: torch.zeros(s, dtype=torch.int32)
        z2 = lambda: torch.ones((n, q), dtype=torch.uint32)
        return ScaleSimState(a=z(n, q), b=z2())
''',
}


def _leaves(src, jax=False):
    mod = (jshapes if jax else shapes).build_inventory(_project(("fixture", src), jax=jax),
                                                       "ScaleSimState")
    return {n: (leaf.shape_str(), leaf.dtype) for n, leaf in mod.leaves.items()}


def test_every_jax_symbolic_regression_has_a_twin():
    assert {n for n in JAX_SOURCES if n.startswith("test_symbolic")} == set(SYMBOLIC_TWINS)


@pytest.mark.parametrize("name", sorted(SYMBOLIC_TWINS))
def test_symbolic_twin_gives_jax_leaf_shapes(name):
    jax_src, twin = JAX_SOURCES[name], SYMBOLIC_TWINS[name]
    assert len(twin.splitlines()) == len(jax_src.splitlines())
    want = _leaves(jax_src, jax=True)
    got = _leaves(twin)
    assert got == want


def test_nested_def_factory_and_generator_tuple():
    """The port's own constructor idioms: ``def z(*s, dtype=...)`` with a
    keyword default and ``tuple(z(n, c) for _ in range(5))``."""
    src = '''
from typing import NamedTuple
import torch


class ScaleSimState(NamedTuple):
    store: tuple
    q: Tensor
    org: Tensor

    @staticmethod
    def create(cfg, device="cuda"):
        n, q, c = cfg.n_nodes, cfg.bcast_queue, cfg.n_cells
        ndt = torch.int16 if getattr(cfg, "narrow_dtypes", False) else torch.int32

        def z(*s, dtype=torch.int32):
            return torch.zeros(s, dtype=dtype, device=device)

        return ScaleSimState(
            store=tuple(z(n, c) for _ in range(2)),
            q=z(n, q, dtype=ndt),
            org=torch.arange(cfg.n_origins, dtype=torch.int32,
                             device=device).expand(n, cfg.n_origins).clone(),
        )
'''
    assert _leaves(src) == {"store[0]": ("[N, C]", "int32"), "store[1]": ("[N, C]", "int32"),
                            "q": ("[N, Q]", "int16"), "org": ("[N, O]", "int32")}


# --- torch idioms under densify --------------------------------------------

TORCH_DENSIFY = {
    "unsqueeze-pair": ("x.unsqueeze(1) == x.unsqueeze(0)", True),
    "zeros-varargs": ("torch.zeros(n, n, dtype=torch.bool)", True),
    "expand": ("x.expand(n, n)", True),
    "expand-minus-one": ("x[:, None].expand(-1, n)", True),
    "repeat": ("x.repeat(n, 1)", True),
    "new-zeros": ("x.new_zeros((n, n))", True),
    "eye-like-full": ("torch.full((n, n), 0, dtype=torch.int32)", True),
    "table-gather": ("table[x.long()]", False),
    "torch-gather": ("torch.gather(table, 1, table.long())", False),
    "index-select": ("table.index_select(0, x.long())", False),
    "take-along-dim": ("torch.take_along_dim(table, table.long(), dim=1)", False),
    "scatter-in-place": ("table.scatter_(1, table.long(), 1)", False),
    "where-rowwise": ("torch.where(x[:, None] > 0, table, 0)", False),
    "reduce-dim": ("table.sum(dim=1, keepdim=True) * x[:, None]", False),
}


@pytest.mark.parametrize("case", sorted(TORCH_DENSIFY))
def test_torch_idioms_under_densify(case):
    expr, dense = TORCH_DENSIFY[case]
    src = textwrap.dedent(f'''
        import torch


        def f(cfg):
            n, m = cfg.n_nodes, cfg.m_slots
            x = torch.arange(n, dtype=torch.int32)
            table = torch.zeros((n, m), dtype=torch.int32)
            out = {expr}
            return out
    ''')
    assert _densify(src) == ([(9, "densify")] if dense else [])


def test_nested_def_factory_flags_like_the_direct_form():
    src = textwrap.dedent('''
        import torch


        def f(cfg, device="cuda"):
            n = cfg.n_nodes

            def z(*s):
                return torch.zeros(s, dtype=torch.int32, device=device)

            return z(n, n) + 1
    ''')
    assert _densify(src) == [(9, "densify")]


def test_unknown_and_none_defaults():
    """An unproven operand grows nothing; a ``None`` default is read on its
    default path (``same_region``'s form), a caller's value is not."""
    src = textwrap.dedent('''
        import torch


        def f(cfg, rows=None, other=None):
            iarr = torch.arange(cfg.n_nodes, dtype=torch.int32)
            rows = iarr if rows is None else rows
            a = rows[:, None] == iarr[None, :]
            b = other[:, None] == iarr[None, :]
            return a, b
    ''')
    assert _densify(src) == [(8, "densify")]


# --- the inventory, three ways ---------------------------------------------

#: (port config, JAX config, mode)
INVENTORY_POINTS = {
    "flagship": (lambda: scale_sim_config(100_000), lambda: jscale_sim_config(100_000),
                 "scale"),
    "million-point": (million_config, lambda: jscale_sim_config(
        1_000_000, pig_members=16, narrow_int8=True, narrow_q_int8=True), "scale"),
    "tx4": (lambda: scale_sim_config(100_000, n_origins=16, tx_max_cells=4),
            lambda: jscale_sim_config(100_000, n_origins=16, tx_max_cells=4), "scale"),
    "full-view": (full_view_config, lambda: jwan_config(8192, n_origins=16, tx_max_cells=1),
                  "full"),
    "wan-tx8": (lambda: wan_config(8192, n_origins=16),
                lambda: jwan_config(8192, n_origins=16), "full"),
}


def _shapes(inv):
    return [(n, leaf.shape_str(), leaf.dtype) for n, leaf in inv.leaves.items()]


@pytest.mark.parametrize("point", sorted(INVENTORY_POINTS))
def test_interpreted_inventory_equals_meta_and_jax(point):
    make, jmake, mode = INVENTORY_POINTS[point]
    got = shapes.interpreted_inventory(make(), mode=mode)
    meta = shapes.static_inventory(make(), mode=mode)
    want = jshapes.static_inventory(jmake(), mode=mode)
    assert _shapes(got) == _shapes(meta) == _shapes(want)  # leaf order too
    assert got.report() == meta.report()
    assert got.report()["unresolved"] == []
    if mode == "full":
        assert dict((n, s) for n, s, _dt in _shapes(got))["swim.view"] == "[N, N]"


def test_defaults_match_the_flagship_config():
    """The densify gate's extents and flags are the port's real
    ``scale_sim_config(100_000)`` (and JAX's), and the abstract config's
    dtype properties pick what the real ones pick."""
    cfg = scale_sim_config(100_000)
    assert shapes.DEFAULT_EXTENTS == jshapes.DEFAULT_EXTENTS
    assert shapes.DEFAULT_FLAGS == jshapes.DEFAULT_FLAGS
    for attr, symbol in shapes.SYMBOLS.items():
        assert shapes.DEFAULT_EXTENTS[symbol] == getattr(cfg, attr), attr
    assert shapes.DEFAULT_EXTENTS["C"] == cfg.n_cells
    for flag, val in shapes.DEFAULT_FLAGS.items():
        assert getattr(cfg, flag) == val, flag
    for knobs in ({}, {"narrow_int8": True}, {"narrow_q_int8": True},
                  {"narrow_dtypes": False}):
        real = dataclasses.replace(cfg, **knobs).validate()
        cv = shapes.ConfigVal.from_config(real)
        for prop in ("timer_dtype", "tx_dtype", "q_dtype"):
            assert cv.attr(prop).name == str(getattr(real, prop)).removeprefix("torch.")


# --- the port under the rule ------------------------------------------------

def test_sim_and_ops_are_clean_under_densify():
    assert run_paths([str(PKG / "sim"), str(PKG / "ops")], ["densify"]) == []


def test_same_region_suppression_covers_a_real_finding():
    """The one densify suppression, JAX's own on the same function: without
    it the rule finds the [N, N] adjacency on the default path."""
    path = PKG / "sim" / "transport.py"
    src = path.read_text()
    marker = "# corrolint: disable=densify -- full-view broadcast fanout only"
    assert src.count(marker) == 1
    bare = "\n".join(ln for ln in src.splitlines() if marker not in ln)
    found = check_source(bare, str(path.parent / "_unsuppressed.py"),
                         {"densify": shapes.check_densify})
    line = next(i for i, ln in enumerate(bare.splitlines(), 1)
                if "return rows[:, None] == net.region[None, :]" in ln)
    assert _rules(found) == [(line, "densify")]
    assert "[N, N]" in found[0].message
