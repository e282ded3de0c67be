"""Tiny runtime seams production code may call unconditionally (port of
``corrosion_tpu/analysis/sanitizer/hooks.py``).

Production call sites must NOT import this module directly — importing
any sanitizer submodule executes the package ``__init__`` and drags in
the whole instrumentation stack. The contract instead (see
``pubsub.SubsManager``): resolve via
``sys.modules.get("corrosion_tpu_torch.analysis.sanitizer.hooks")`` and call
only when present — a live sanitizer session has necessarily imported
this module already, and a production process without one pays zero
import cost.
"""

from __future__ import annotations


def watch_dir(path) -> None:
    """Register ``path`` with the active corrosan session's filesystem
    witness; no-op when no session is active."""
    from corrosion_tpu_torch.analysis.sanitizer import runtime

    san = runtime._ACTIVE
    if san is not None and san.active:
        san.fs.watch(path)
