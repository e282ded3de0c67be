"""The port's corrolint (``corrosion_tpu_torch/analysis``) against the JAX
package's, on the CPU.

- Every lock-discipline, strippable-assert, suppression and lock-order
  fixture source of ``tests/test_analysis.py`` and
  ``tests/test_analysis_v2.py`` (read out of those files' syntax trees, so
  a new case there is a new case here) gives the same ``(path, line, rule,
  message)`` list through both engines, messages compared after renaming
  the ``corrosion_tpu_torch.`` prefix to ``corrosion_tpu.``; so does the
  two-module lock-order case and the dataflow engine on a taint pass.
- The port's static lock graph equals JAX's after the same rename: the
  same nodes (``Supervisor._mu`` included) and the same edges.
- ``module_name_for`` names port paths by their last
  ``corrosion_tpu_torch`` component, and every out-of-package file
  (``chip_smoke.py``) by a name of its own.
- JAX's nine sharding-contract fixtures fire the same rules on the same
  lines through the port's rule, which also flags the torch idioms
  (``.cpu()``, ``.to("cpu")``, ``.numpy()``, ``ShardedTree.assemble``)
  and passes a registered drain.
- The port tree and ``chip_smoke.py`` lint clean, and the ``lint``
  subcommand exits 0, 1 and 2 as JAX's does."""

import ast
import json
import subprocess
import textwrap
from pathlib import Path

import pytest

from corrosion_tpu.analysis import ALL_CHECKERS as J_ALL
from corrosion_tpu.analysis import PROJECT_CHECKERS as J_PROJECT
from corrosion_tpu.analysis import RULES as J_RULES
from corrosion_tpu.analysis import check_source as j_check_source
from corrosion_tpu.analysis import dataflow as j_dataflow
from corrosion_tpu.analysis.callgraph import (
    ModuleInfo as JModuleInfo,
    Project as JProject,
    module_name_for as j_module_name_for,
)
from corrosion_tpu.analysis.runner import _lint_sources as j_lint_sources
from corrosion_tpu.analysis.sanitizer import static_lock_graph as j_static_lock_graph
from corrosion_tpu_torch import cli
from corrosion_tpu_torch.analysis import (
    ALL_CHECKERS,
    PROJECT_CHECKERS,
    RULES,
    check_source,
    run_paths,
)
from corrosion_tpu_torch.analysis import dataflow
from corrosion_tpu_torch.analysis.callgraph import ModuleInfo, Project, module_name_for
from corrosion_tpu_torch.analysis.runner import _lint_sources
from corrosion_tpu_torch.analysis.sanitizer import static_lock_graph
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
PORTABLE = ("lock-discipline", "strippable-assert", "lock-order")


def _fixture_cases(tiers=PORTABLE):
    """``(id, source, checkers)`` for every ``lint(src, [checkers])`` call of
    the JAX lint tests whose checkers are all among ``tiers``."""
    def strings(body):
        return {t.id: node.value.value for node in body
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                for t in node.targets if isinstance(t, ast.Name)}

    cases = []
    for name in ("test_analysis.py", "test_analysis_v2.py"):
        tree = ast.parse((ROOT / "tests" / name).read_text())
        for fn in tree.body:
            if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
                continue
            consts = {**strings(tree.body), **strings(fn.body)}
            calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                     and isinstance(c.func, ast.Name) and c.func.id == "lint"
                     and len(c.args) == 2 and isinstance(c.args[1], ast.List)]
            for i, call in enumerate(calls):
                src = call.args[0]
                src = (src.value if isinstance(src, ast.Constant)
                       else consts.get(getattr(src, "id", None)))
                checkers = [e.value for e in call.args[1].elts]
                if src is None or not set(checkers) <= set(tiers):
                    continue
                cases.append(pytest.param(src, checkers,
                                          id=f"{name[5:-3]}-{fn.name[5:]}-{i}"))
    return cases


FIXTURES = _fixture_cases()
#: JAX's sharding-contract fixtures (``tests/test_analysis_v2.py``)
SHARDING_FIXTURES = _fixture_cases(("sharding-contract",))


def _ported(findings):
    return [(f.path, f.line, f.rule,
             f.message.replace("corrosion_tpu_torch.", "corrosion_tpu."))
            for f in findings]


def _jax(findings):
    return [(f.path, f.line, f.rule, f.message) for f in findings]


def test_fixture_cases_cover_every_portable_tier():
    """The extraction found the JAX tests' cases of all three tiers and of
    the suppression rules (not an empty parametrisation)."""
    seen = {c for case in FIXTURES for c in case.values[1]}
    assert seen == set(PORTABLE) and len(FIXTURES) >= 20
    assert any("corrolint:" in case.values[0] for case in FIXTURES)


@pytest.mark.parametrize("src,checkers", FIXTURES)
def test_fixture_findings_equal_jax(src, checkers):
    """One JAX fixture source through both engines, with its own checkers
    and with all three portable tiers at once."""
    src = textwrap.dedent(src)
    for names in (checkers, PORTABLE):
        mine = check_source(src, "fixture.py", {
            k: PROJECT_CHECKERS.get(k) or ALL_CHECKERS[k] for k in names})
        want = j_check_source(src, "fixture.py", {
            k: J_PROJECT.get(k) or J_ALL[k] for k in names})
        assert _ported(mine) == _jax(want), names


def test_two_module_lock_order_equals_jax():
    """A stdlib-shaped call in one module must not resolve to a same-named
    method of another (no phantom edge), and a real cross-module
    inversion through bare-name calls is found by both engines alike."""
    writer = textwrap.dedent("""
        import threading

        class Writer:
            def __init__(self):
                self._mu = threading.Lock()

            def submit(self, job):
                with self._mu:
                    pass

        def drain_writer(w):
            with _wmu:
                host_kick()

        def writer_touch():
            with _wmu:
                pass

        _wmu = threading.Lock()
    """)
    host = textwrap.dedent("""
        import threading

        class Host:
            def __init__(self):
                self._lock = threading.Lock()

            def kick(self, pool, job):
                with self._lock:
                    pool.submit(job)  # stdlib executor, NOT Writer

        def host_kick():
            with _hmu:
                pass

        def host_drain():
            with _hmu:
                writer_touch()

        _hmu = threading.Lock()
    """)
    sources = [("a.py", writer), ("b.py", host)]
    mine = _lint_sources(sources, {}, {"lock-order": PROJECT_CHECKERS["lock-order"]})
    want = j_lint_sources(sources, {}, {"lock-order": J_PROJECT["lock-order"]})
    assert _ported(mine) == _jax(want)
    assert [f.rule for f in mine] == ["lock-inversion"]


def _taint_pass(module):
    """A taint analysis on ``module``'s ForwardAnalysis: ``source()`` taints,
    the taint flows through binds, tuples, branches and loops."""

    class Taint(module.ForwardAnalysis):
        def eval_call(self, node, env, args, keywords):
            if getattr(node.func, "id", None) == "source":
                return "T"
            return "T" if "T" in args else None

        def eval_binop(self, node, left, right, env):
            return "T" if "T" in (left, right) else None

    return Taint


TAINT_SRC = textwrap.dedent("""
    def straight(a):
        x = source()
        y, z = (x, a)
        return y

    def branch(a):
        if a:
            x = source()
        else:
            x = 1
        return x

    def loop(a):
        acc = None
        for i in a:
            acc = f(acc, source())
        return acc

    def both(a):
        if a:
            x = source()
        else:
            x = source() + 1
        return x, a
""")


def test_dataflow_engine_equals_jax():
    tree = ast.parse(TAINT_SRC)
    mine_project = Project([ModuleInfo("t.py", "t", tree, TAINT_SRC, {}, [])])
    jax_project = JProject([JModuleInfo("t.py", "t", tree, TAINT_SRC, {}, [])])
    got = {}
    for project, module, tag in ((mine_project, dataflow, "port"),
                                 (jax_project, j_dataflow, "jax")):
        cls = _taint_pass(module)
        got[tag] = {fn.name: repr(cls(fn, fn.path).analyze())
                    for fn in project.iter_functions()}
    assert got["port"] == got["jax"]
    assert got["port"]["straight"] == "'T'" and got["port"]["branch"] == "None"
    assert got["port"]["both"] == "TupleVal('T', None)"


def test_static_lock_graph_equals_jax():
    """The port's locks and acquisition edges are JAX's, named after the
    port's modules: the supervisor keeps its lock (``Supervisor._mu``)."""
    def names(graph, prefix):
        nodes = {(n.name.replace(prefix, "corrosion_tpu.", 1), n.kind)
                 for n in graph.creation_sites}
        edges = {(a.replace(prefix, "corrosion_tpu.", 1),
                  b.replace(prefix, "corrosion_tpu.", 1))
                 for a, b in graph.edge_names()}
        return nodes, edges

    mine = names(static_lock_graph(), "corrosion_tpu_torch.")
    want = names(j_static_lock_graph(), "corrosion_tpu.")
    assert mine == want
    assert len(mine[0]) == 21
    assert ("corrosion_tpu.resilience.supervisor.Supervisor._mu", "Lock") in mine[0]
    assert ("corrosion_tpu.pubsub.SubsManager._mu",
            "corrosion_tpu.pubsub.Matcher._mu") in mine[1]


def test_module_name_for_port_paths():
    assert module_name_for("corrosion_tpu_torch/pubsub.py") == "corrosion_tpu_torch.pubsub"
    assert module_name_for(str(ROOT / "corrosion_tpu_torch" / "analysis" / "__init__.py")) \
        == "corrosion_tpu_torch.analysis"
    assert module_name_for("x/corrosion_tpu_torch/build/corrosion_tpu_torch/a/b.py") \
        == "corrosion_tpu_torch.a.b"
    # out-of-package files keep their whole path: no two share a name
    assert module_name_for("chip_smoke.py") == "chip_smoke"
    smoke = module_name_for(str(ROOT / "chip_smoke.py"))
    assert smoke.endswith(".chip_smoke") and smoke != "chip_smoke"
    assert module_name_for("../chip_smoke.py") == "__up__.chip_smoke"
    assert module_name_for("corrosion_tpu/pubsub.py") == "corrosion_tpu.pubsub"
    # JAX's own naming keys on its package and so leaves a port file
    # under its whole path, where no runtime lock would find it
    port_file = str(ROOT / "corrosion_tpu_torch" / "pubsub.py")
    assert j_module_name_for(port_file) != "corrosion_tpu_torch.pubsub"
    assert module_name_for(port_file) == "corrosion_tpu_torch.pubsub"


def test_rules_are_jax_rules_and_documented():
    """The port emits a subset of JAX's rules, each listed in
    ``docs/corrolint.md`` and described as JAX's is, but for the sharding
    contract's two, which name the port's materializers, and dtype-widen
    and densify, which speak of torch (no trace, no retrace)."""
    sharding = {"shard-gather", "shard-spec-drift"}
    torch_worded = {"dtype-widen", "densify"}
    assert set(RULES) == {"unlocked-mutation", "blocking-under-lock", "bare-assert",
                          "suppression-missing-reason", "lock-cycle",
                          "lock-inversion"} | sharding | torch_worded
    for rule, text in RULES.items():
        if rule not in sharding | torch_worded:
            assert J_RULES[rule] == text
    assert all(w in RULES["shard-gather"]
               for w in (".cpu()", ".numpy()", "ShardedTree.assemble"))
    assert "`shard_state`" in RULES["shard-spec-drift"]
    assert "torch's promotion" in RULES["dtype-widen"]
    assert "N x N pairwise broadcast" in RULES["densify"]
    doc = (ROOT / "docs" / "corrolint.md").read_text(encoding="utf-8")
    assert [r for r in RULES if f"`{r}`" not in doc] == []
    assert set(ALL_CHECKERS) == {"lock-discipline", "strippable-assert"}
    assert set(PROJECT_CHECKERS) == {"lock-order", "sharding-contract", "dtype-flow",
                                     "densify"}


def _sharding(src):
    return check_source(textwrap.dedent(src), "fixture.py",
                        {"sharding-contract": PROJECT_CHECKERS["sharding-contract"]})


def test_sharding_fixtures_are_jax_nine():
    assert len(SHARDING_FIXTURES) == 9


@pytest.mark.parametrize("src,checkers", SHARDING_FIXTURES)
def test_sharding_fixture_rules_equal_jax(src, checkers):
    """One of JAX's sharding-contract fixtures through both rules: the same
    rules fire on the same lines."""
    want = j_check_source(textwrap.dedent(src), "fixture.py",
                          {"sharding-contract": J_PROJECT["sharding-contract"]})
    assert [(f.line, f.rule) for f in _sharding(src)] == [(f.line, f.rule) for f in want]


TORCH_IDIOMS = {
    "cpu": ("""
        def drive(cfg, mesh, st, net, key, inputs):
            st, infos = sharded_run(cfg, mesh, st, net, key, inputs)
            hlc = st.crdt.hlc.cpu()
            view = st.swim.view.to("cpu")
            return hlc, view, infos["fresh"].cpu()  # the summed infos: fine
    """, [(4, "shard-gather"), (5, "shard-gather")]),
    "numpy_through_a_helper": ("""
        def host(t):
            return t.detach().numpy()

        def drive(cfg, mesh, st, net, key, inputs):
            st, infos = sharded_run(cfg, mesh, st, net, key, inputs)
            return host(st.swim.view)
    """, [(7, "shard-gather")]),
    "assemble": ("""
        def drive(cfg, mesh, st, net, key, inp):
            out, info = sharded_step(cfg, mesh, st, net, key, inp)
            return out.assemble("cpu"), info["acked"].item()
    """, [(4, "shard-gather")]),
    "registered_drain": ("""
        import numpy as np

        def host_shard_copy(tree):
            return [np.asarray(x) for x in tree_leaves(tree)]

        def drive(cfg, mesh, st, net, key, inputs):
            (st, key), infos = sharded_scale_run_carry(cfg, mesh, st, net, key, inputs)
            return host_shard_copy(st), key.tolist()
    """, []),
}


@pytest.mark.parametrize("case", sorted(TORCH_IDIOMS))
def test_sharding_contract_on_torch_idioms(case):
    src, want = TORCH_IDIOMS[case]
    assert [(f.line, f.rule) for f in _sharding(src)] == want


def test_port_is_clean_under_the_sharding_contract():
    findings = run_paths([str(ROOT / "corrosion_tpu_torch")], ["sharding-contract"])
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_torch_device_sync_under_lock_is_blocking():
    """The port's blocking list names the card's syncs where JAX's names
    its device reads."""
    src = textwrap.dedent("""
        import threading
        import torch

        class Stepper:
            def __init__(self):
                self._mu = threading.Lock()

            def step(self, ev):
                with self._mu:
                    torch.cuda.synchronize()
                    ev.synchronize()
    """)
    found = check_source(src, "fixture.py", {"lock-discipline": ALL_CHECKERS["lock-discipline"]})
    assert [(f.line, f.rule) for f in found] == [(11, "blocking-under-lock"),
                                                 (12, "blocking-under-lock")]


def test_repo_is_clean():
    """The port and ``chip_smoke.py`` pass the port's analyzer: the lint
    gate of the port."""
    findings = run_paths([str(ROOT / "corrosion_tpu_torch"), str(ROOT / "chip_smoke.py")])
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_lint_cli_exit_codes(tmp_path, capsys, monkeypatch):
    """0 clean, 1 findings (text, JSON and the report file), 2 a usage
    error: a missing path or an unknown checker. No path lints the port
    from any working directory."""
    assert cli.main(["lint", str(ROOT / "corrosion_tpu_torch" / "analysis" / "base.py")]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):\n    assert x\n    return x\n")
    assert cli.main(["lint", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "bare-assert" in out and "bad.py:2" in out
    report = tmp_path / "out" / "lint.json"
    assert cli.main(["lint", "--format", "json", "--output-json", str(report), str(bad)]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert [(p["rule"], p["line"]) for p in payload] == [("bare-assert", 2)]
    doc = json.loads(report.read_text())
    assert doc["rule_counts"] == {"bare-assert": 1} and doc["files_checked"] == 1
    assert doc["clean"] is False and doc["rules_available"] == sorted(RULES)
    assert cli.main(["lint", str(tmp_path / "nope")]) == 2
    from corrosion_tpu_torch.analysis.__main__ import main as lint_main

    assert lint_main(["--checkers", "donation-safety", str(bad)]) == 2
    assert lint_main(["--list-rules"]) == 0
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    assert cli.main(["lint"]) == 0


def test_lint_changed_lints_only_touched_files(tmp_path, capsys, monkeypatch):
    def git(*argv):
        subprocess.run(["git", "-C", str(tmp_path), *argv], check=True,
                       capture_output=True)

    git("init", "-q")
    git("config", "user.email", "lint@test")
    git("config", "user.name", "lint")
    (tmp_path / "clean.py").write_text("def f(x):\n    assert x\n    return x\n")
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):\n    return x\n")
    git("add", ".")
    git("commit", "-qm", "seed")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["lint", "--changed", "HEAD", str(tmp_path)]) == 0
    assert "no python files changed" in capsys.readouterr().out
    bad.write_text("def f(x):\n    assert x\n    return x\n")
    assert cli.main(["lint", "--changed", "HEAD", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "bad.py" in out and "clean.py" not in out
    assert cli.main(["lint", "--changed", "HEAD", "no_such_dir"]) == 2
