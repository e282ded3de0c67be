"""``python -m corrosion_tpu_torch san`` /
``python -m corrosion_tpu_torch.analysis.sanitizer`` (port of
``corrosion_tpu/analysis/sanitizer/__main__.py``).

Replays the seeded-race/leak fixtures (``fixtures.py``) — each in its
own sanitized window — and reports per-fixture verdicts. Exit 1 when
any fixture misbehaves: a seeded bug the sanitizer missed is a false
negative (the detector rotted), a clean twin it flagged is a false
positive (the detector lies). ``--output-json`` lands the verdicts in
the shared corrosan report next to the sanitized pytest section.
``--device`` places the agent-backed fixtures' cluster (default
``cuda``, which raises without a card).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m corrosion_tpu_torch san",
        description="corrosan fixture replay: seeded concurrency bugs "
                    "the runtime sanitizer must detect",
    )
    parser.add_argument("fixtures", nargs="*", default=None,
                        help="fixture names (default: all)")
    parser.add_argument("--list-fixtures", action="store_true",
                        help="list fixtures and expected findings")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--output-json", metavar="PATH", default=None,
                        help="write the fixtures section of the corrosan "
                             "report")
    parser.add_argument("--device", default="cuda",
                        help="device of the agent-backed fixtures "
                             "(default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)

    from corrosion_tpu_torch.analysis.sanitizer.fixtures import (
        FIXTURES,
        run_all_fixtures,
    )

    if args.list_fixtures:
        for name, (_fn, expect, doc) in sorted(FIXTURES.items()):
            want = ", ".join(expect) if expect else "clean"
            print(f"{name}: {doc} [expects: {want}]")
        return 0

    results = run_all_fixtures(args.fixtures or None,
                               device=args.device)
    ok = all(r.ok for r in results)
    payload = {
        "results": [r.to_json() for r in results],
        "ok": ok,
    }
    if args.output_json:
        from corrosion_tpu_torch.analysis.sanitizer.report import write_section

        write_section(args.output_json, "fixtures", payload)
    if args.format == "json":
        json.dump(payload, sys.stdout, indent=2)
        print()
    else:
        for r in results:
            verdict = "ok" if r.ok else "FAIL"
            want = ", ".join(r.expect) if r.expect else "clean"
            got = ", ".join(r.found) if r.found else "clean"
            print(f"{verdict}: {r.name} (expected {want}; got {got})")
            if not r.ok:
                for line in r.details:
                    print(f"    {line}")
        print("corrosan fixtures: "
              + ("all verdicts correct" if ok else "VERDICT MISMATCH"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
