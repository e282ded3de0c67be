"""Checkpoint retention: keep-last-K pruning + an atomic ``LATEST``
pointer (a copy of ``corrosion_tpu/resilience/retention.py``, pointed at
the port's checkpoint module).

A soak run's checkpoint root accumulates one directory per segment
(``seg-<completed rounds>``: its state file plus the manifest; retention
operates on whole directories). Two invariants:

- ``LATEST`` is a one-line file naming the newest *committed* checkpoint
  directory, updated via write-tmp + ``os.replace`` — readers never see
  a partial pointer, and the pointer only moves AFTER the directory it
  names is fully committed (manifest-last, see ``checkpoint.py``).
- pruning never removes the directory ``LATEST`` points at, so the
  recovery point survives even a keep-last-1 policy racing a new save.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

from corrosion_tpu_torch.utils import logger

LATEST_NAME = "LATEST"


def update_latest(root: str, name: str) -> None:
    """Atomically point ``root/LATEST`` at checkpoint directory ``name``
    (a path relative to ``root``)."""
    target = os.path.join(root, LATEST_NAME)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        f.write(name + "\n")
    os.replace(tmp, target)


def read_latest(root: str) -> Optional[str]:
    """The directory name ``LATEST`` points at, or None when there is no
    pointer (or it names a directory that no longer exists)."""
    target = os.path.join(root, LATEST_NAME)
    if not os.path.exists(target):
        return None
    with open(target) as f:
        name = f.read().strip()
    if not name or not os.path.isdir(os.path.join(root, name)):
        return None
    return name


def checkpoint_dirs(root: str) -> List[str]:
    """Candidate checkpoint directory names under ``root``, newest first
    (by manifest mtime — the manifest is written last, so its mtime is
    the commit time)."""
    if not os.path.isdir(root):
        return []
    found = []
    for name in os.listdir(root):
        manifest = os.path.join(root, name, "manifest.json")
        if os.path.isfile(manifest):
            found.append((os.path.getmtime(manifest), name))
    return [name for _, name in sorted(found, reverse=True)]


def prune_checkpoints(root: str, keep_last: int) -> List[str]:
    """Delete committed checkpoints beyond the newest ``keep_last``,
    never touching the one ``LATEST`` names. Returns the pruned names."""
    keep_last = max(1, keep_last)
    names = checkpoint_dirs(root)
    pinned = read_latest(root)
    pruned = []
    for name in names[keep_last:]:
        if name == pinned:
            continue
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        pruned.append(name)
    return pruned


def iter_valid_checkpoints(root: str):
    """Yield absolute paths of checkpoints under ``root`` that pass full
    integrity verification, newest-first (the ``LATEST`` pointer's
    target first when it is committed).

    A half-written or tampered side is logged and skipped — it must
    never mask an older good recovery point. Callers that can also fail
    AFTER verification (restore errors, config gates) keep iterating to
    the next-newest candidate."""
    from corrosion_tpu_torch.checkpoint import verify_checkpoint

    candidates = checkpoint_dirs(root)
    pinned = read_latest(root)
    if pinned in candidates:
        candidates = [pinned] + [n for n in candidates if n != pinned]
    for name in candidates:
        path = os.path.join(root, name)
        try:
            verify_checkpoint(path)
        except Exception:  # noqa: BLE001 — fall back to the next-newest
            logger.exception("checkpoint %s fails verification; trying "
                             "the next-newest", path)
            continue
        yield path


def latest_valid_checkpoint(root: str) -> Optional[str]:
    """Absolute path of the newest checkpoint under ``root`` that passes
    full integrity verification (see :func:`iter_valid_checkpoints`)."""
    return next(iter_valid_checkpoints(root), None)
