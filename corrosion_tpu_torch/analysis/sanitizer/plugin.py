"""pytest plugin: sanitize a whole test run (port of
``corrosion_tpu/analysis/sanitizer/plugin.py``).

Opt-in via ``--corrosan`` or ``CORROSAN=1``; load it with
``pytest -p corrosion_tpu_torch.analysis.sanitizer.plugin``. One
session-wide window opens at configure time — before test modules
import, so module-level locks in late-imported code are instrumented
too — and gates at session finish:

- unsuppressed findings are printed and FAIL the run (exit status 1);
- the run section of the report lands in ``CORROSAN_REPORT`` (default
  ``artifacts/san_torch.json`` under the working directory), alongside
  the fixture-replay section ``python -m corrosion_tpu_torch san
  --output-json`` writes.

Loaded beside the JAX package's plugin (which registers the same
``--corrosan`` option and arms on the same variable), this one stands
down: the option is registered once, and a session that already holds a
sanitizer (``config._corrosan``) never installs a second.
"""

from __future__ import annotations

import os

import pytest


def pytest_addoption(parser):
    group = parser.getgroup("corrosan")
    try:
        group.addoption(
            "--corrosan", action="store_true", default=False,
            help="instrument threading/locks/files with the corrosan "
                 "runtime sanitizer and gate the session on its findings",
        )
    except ValueError:
        pass  # another corrosan plugin registered the option already


def _enabled(config) -> bool:
    return bool(config.getoption("--corrosan")
                or os.environ.get("CORROSAN") == "1")


@pytest.hookimpl(trylast=True)
def pytest_configure(config):
    # trylast: a plugin loaded beside this one has armed by now
    if not _enabled(config) or getattr(config, "_corrosan", None) is not None:
        return
    from corrosion_tpu_torch.analysis.sanitizer.runtime import Sanitizer

    san = Sanitizer()
    san.install()
    config._corrosan_torch = san


def pytest_sessionfinish(session, exitstatus):
    san = getattr(session.config, "_corrosan_torch", None)
    if san is None:
        return
    session.config._corrosan_torch = None
    san.uninstall()
    findings = san.gate()
    payload = san.report_payload(findings)
    payload["pytest_exitstatus"] = int(exitstatus)
    report_path = os.environ.get(
        "CORROSAN_REPORT", os.path.join("artifacts", "san_torch.json"))
    from corrosion_tpu_torch.analysis.sanitizer.report import write_section

    write_section(report_path, "pytest", payload)
    print(f"\ncorrosan: {len(payload['witnessed_edges'])} witnessed lock "
          f"edges, {payload['threads_spawned']} threads spawned, "
          f"{len(findings)} finding(s) (report: {report_path})")
    if findings:
        for f in findings:
            print(f"corrosan: {f.render()}")
        session.exitstatus = 1
