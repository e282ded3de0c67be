"""Checkpoints: the single-device format-3 layout (port of
``corrosion_tpu/checkpoint.py``).

A checkpoint is a directory: one ``shard-00000.npz`` holding every state
leaf (npz keys ``leaf_<i>_0``), and a ``manifest.json`` that records the
format, the mode (``"scale"`` or ``"full"``), the round, the sim config
(``dataclasses.asdict``), each leaf's shape and numpy dtype, where each
leaf lives, and each file's SHA-256. The files are the JAX package's, in
both directions: leaves go in the field order of the nested state
NamedTuples (``jax.tree.leaves`` order), dtypes are numpy names, and
``Book.seen``, which the port carries as int32 bit patterns, is written as
uint32 and read back as int32 bits. Formats 1 and 2 (one ``state.npz`` of
``leaf_<i>``) still load.

The mesh-sharded save and the elastic restore are not ported: a
checkpoint whose manifest records a mesh of more than one device is
refused whole, never loaded in part.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from corrosion_tpu_torch._device import resolve_device

FORMAT_VERSION = 3
_SUPPORTED_FORMATS = (1, 2, 3)
_SHARD_FILE = "shard-00000.npz"
#: the leaf the port holds as int32 bits and the files hold as uint32
_SEEN_PATH = ("crdt", "book", "seen")


class CheckpointIntegrityError(ValueError):
    """A checkpoint directory is incomplete, tampered with, or corrupt."""


#: sim-config keys that select an execution path without changing what
#: the simulation computes — excluded from checkpoint config-identity
#: checks, so a run may resume under another execution mode (a quiet
#: soak's checkpoint restores under dense and vice versa).
EXECUTION_ONLY_CONFIG_KEYS = (
    "fused", "quiet", "quiet_backstop_interval", "quiet_shards",
)

#: semantic config keys added after checkpoints already existed, with the
#: default the older code behaved as: a manifest written before the key
#: existed normalizes to this value, while a non-default setting still
#: refuses it.
COMPAT_DEFAULT_CONFIG_KEYS = {"narrow_int8": False,
                              "narrow_q_int8": False}


def config_identity(cfg_or_dict) -> dict:
    """The portion of a sim config that checkpoint compatibility is
    judged on: the ``dataclasses.asdict`` dict minus
    :data:`EXECUTION_ONLY_CONFIG_KEYS`, with absent late-added keys
    normalized per :data:`COMPAT_DEFAULT_CONFIG_KEYS`. Accepts a config
    dataclass or an already-serialized manifest ``sim_config`` dict."""
    d = (cfg_or_dict if isinstance(cfg_or_dict, dict)
         else dataclasses.asdict(cfg_or_dict))
    out = {k: v for k, v in d.items()
           if k not in EXECUTION_ONLY_CONFIG_KEYS}
    for k, default in COMPAT_DEFAULT_CONFIG_KEYS.items():
        out.setdefault(k, default)
    return out


def named_leaves(state, path=()) -> list:
    """``[(field path, tensor), ...]`` in the nested NamedTuples' field
    order (the ``jax.tree.leaves`` order of the JAX state); a plain tuple
    field (the store planes) contributes its items by index."""
    out = []
    for name, v in zip(state._fields, state):
        if hasattr(v, "_fields"):
            out += named_leaves(v, path + (name,))
        elif isinstance(v, tuple):
            out += [(path + (name, i), t) for i, t in enumerate(v)]
        else:
            out.append((path + (name,), v))
    return out


def _file_dtype(path, t: torch.Tensor) -> str:
    """The numpy dtype name a leaf has in the files."""
    return "uint32" if path == _SEEN_PATH else str(t.dtype).removeprefix("torch.")


def host_arrays(state) -> list:
    """The leaves as numpy arrays in their file dtypes (views of CPU
    tensors; device tensors are copied to the host)."""
    out = []
    for path, t in named_leaves(state):
        a = t.detach().cpu().numpy()
        out.append(a.view(np.uint32) if path == _SEEN_PATH else a)
    return out


def _rebuild(template, it):
    fields = []
    for v in template:
        if hasattr(v, "_fields"):
            fields.append(_rebuild(v, it))
        elif isinstance(v, tuple):
            fields.append(tuple(next(it) for _ in v))
        else:
            fields.append(next(it))
    return type(template)(*fields)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _verify_files(path: str, manifest: dict) -> None:
    """Recompute every recorded file hash; mismatch = corruption."""
    for name, want in (manifest.get("files") or {}).items():
        fp = os.path.join(path, name)
        if not os.path.exists(fp):
            raise CheckpointIntegrityError(
                f"checkpoint {path}: leaf file {name} is missing"
            )
        got = _file_sha256(fp)
        if got != want:
            raise CheckpointIntegrityError(
                f"checkpoint {path}: leaf file {name} content hash mismatch "
                f"(manifest {want[:12]}…, on disk {got[:12]}…) — the file "
                f"was truncated or tampered with after the checkpoint "
                f"was committed"
            )


def _publish_manifest(tmp: str, final: str) -> None:
    """The commit point: a checkpoint exists iff this rename lands (a
    module seam, so a test can crash a save between the state file and
    the manifest)."""
    os.replace(tmp, final)


def config_mode(cfg) -> str:
    """The manifest's ``mode`` of a config: ``"scale"`` for a
    :class:`ScaleSimConfig`, ``"full"`` for the full view's config."""
    from corrosion_tpu_torch.sim.scale_step import ScaleSimConfig

    return "scale" if isinstance(cfg, ScaleSimConfig) else "full"


def save_checkpoint(cfg, state, round_no: int, path: str,
                    extra: Optional[dict] = None) -> str:
    """Write ``state`` (of ``cfg``, after ``round_no`` rounds; on any
    device, the soak runner hands over CPU copies) to the directory
    ``path``.

    Crash-safe ordering: the manifest is removed first and written LAST
    through an atomic rename, so a directory without a manifest is
    incomplete by definition; the state file's SHA-256 is recorded in the
    manifest, so later corruption is detected on load. ``extra`` is a
    JSON-able payload stored in the manifest (the soak runner's carry)."""
    os.makedirs(path, exist_ok=True)
    manifest_path = os.path.join(path, "manifest.json")
    if os.path.exists(manifest_path):
        os.unlink(manifest_path)
    # stale state files of an earlier occupant go after the manifest
    for name in os.listdir(path):
        if name == "state.npz" or (
                name.startswith("shard-") and name.endswith(".npz")):
            os.unlink(os.path.join(path, name))
    arrays = host_arrays(state)
    buf = io.BytesIO()
    np.savez_compressed(buf, **{f"leaf_{i}_0": a for i, a in enumerate(arrays)})
    blob = buf.getvalue()
    with open(os.path.join(path, _SHARD_FILE), "wb") as f:
        f.write(blob)
    files = {_SHARD_FILE: hashlib.sha256(blob).hexdigest()}
    manifest = {
        "format": FORMAT_VERSION,
        "mode": config_mode(cfg),
        "round": round_no,
        "sim_config": dataclasses.asdict(cfg),
        "n_leaves": len(arrays),
        "mesh": None,
        "leaves": [
            {"dim": None, "axes": None, "shape": [int(s) for s in a.shape],
             "dtype": str(a.dtype)}
            for a in arrays
        ],
        "slices": {_SHARD_FILE: [{"leaf": i, "start": 0, "stop": None}
                                 for i in range(len(arrays))]},
        "files": files,
        "db": None,
    }
    if extra is not None:
        manifest["extra"] = extra
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    _publish_manifest(tmp, manifest_path)
    return path


def _refuse_sharded(path: str, manifest: dict) -> None:
    mesh = manifest.get("mesh")
    devices = math.prod(mesh["shape"]) if mesh else 1
    if devices > 1 or any(m.get("dim") is not None
                          for m in manifest.get("leaves") or []):
        raise ValueError(
            f"checkpoint {path} was saved sharded over a mesh of {devices} "
            f"devices; the port restores single-device checkpoints only "
            f"(the sharded restore is ROADMAP Queue 1 item 14)"
        )


def _load_slices_v3(path: str, manifest: dict) -> list:
    """The v3 slice files of a single-device save, as whole host leaves;
    every leaf once, in its manifest dtype and shape."""
    metas = manifest["leaves"]
    out: list = [None] * manifest["n_leaves"]
    for fname, entries in (manifest.get("slices") or {}).items():
        fp = os.path.join(path, fname)
        if not os.path.exists(fp):
            raise CheckpointIntegrityError(
                f"checkpoint {path}: slice file {fname} is missing"
            )
        with np.load(fp) as z:
            for e in entries:
                i, start = int(e["leaf"]), int(e["start"])
                arr = z[f"leaf_{i}_{start}"]
                meta = metas[i]
                if str(arr.dtype) != meta["dtype"]:
                    raise CheckpointIntegrityError(
                        f"checkpoint {path}: slice {fname}:{i}@{start} "
                        f"dtype {arr.dtype} != manifest {meta['dtype']}"
                    )
                if tuple(arr.shape) != tuple(meta["shape"]):
                    raise CheckpointIntegrityError(
                        f"checkpoint {path}: leaf {i} shape {arr.shape} != "
                        f"manifest {tuple(meta['shape'])}"
                    )
                if out[i] is not None:
                    raise CheckpointIntegrityError(
                        f"checkpoint {path}: unsharded leaf {i} has more "
                        f"than one slice"
                    )
                out[i] = arr
    for i, arr in enumerate(out):
        if arr is None:
            raise CheckpointIntegrityError(
                f"checkpoint {path}: no slices recorded for leaf {i}"
            )
    return out


def _state_template(mode: str, cfg):
    """The state's structure, shapes and dtypes, allocated nowhere."""
    if mode == "scale":
        from corrosion_tpu_torch.sim.scale_step import ScaleSimState

        return ScaleSimState.create(cfg, "meta")
    from corrosion_tpu_torch.sim.step import SimState

    return SimState.create(cfg, device="meta")


def _read(path: str, verify: bool):
    """-> (manifest, state template, host arrays), all on the host: the
    manifest, the hashes (with ``verify``) and every leaf's shape and
    dtype against a template built from the saved config."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise CheckpointIntegrityError(
            f"checkpoint {path}: no manifest — directory is incomplete "
            f"(a crash mid-save, or not a checkpoint)"
        )
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest["format"] not in _SUPPORTED_FORMATS:
        raise ValueError(f"unsupported checkpoint format {manifest['format']}")
    _refuse_sharded(path, manifest)
    if verify:
        _verify_files(path, manifest)
    if manifest["mode"] == "scale":
        from corrosion_tpu_torch.sim.scale_step import ScaleSimConfig as CfgCls
    else:
        from corrosion_tpu_torch.sim.config import SimConfig as CfgCls
    template = _state_template(manifest["mode"], CfgCls(**manifest["sim_config"]))
    if manifest["format"] >= 3:
        loaded = _load_slices_v3(path, manifest)
    else:  # v1/v2: one whole-state npz
        with np.load(os.path.join(path, "state.npz")) as z:
            loaded = [z[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    want = named_leaves(template)
    if len(want) != len(loaded):
        raise ValueError(
            f"checkpoint has {len(loaded)} leaves, config expects "
            f"{len(want)} — config drift"
        )
    for (leaf_path, t), a in zip(want, loaded):
        if tuple(t.shape) != tuple(a.shape):
            raise ValueError(
                f"leaf shape mismatch: checkpoint {a.shape} vs config "
                f"{tuple(t.shape)}"
            )
        if _file_dtype(leaf_path, t) != str(a.dtype):
            raise ValueError(
                f"leaf dtype mismatch: checkpoint {a.dtype} vs config "
                f"{_file_dtype(leaf_path, t)}"
            )
    return manifest, template, loaded


def load_checkpoint(path: str, verify: bool = True,
                    device="cuda") -> Tuple[dict, object]:
    """-> (manifest, state) with the state's leaves on ``device``. The
    state is rebuilt against a template constructed from the saved
    config, so leaf order, shape and dtype mismatches fail loudly; the
    file hashes are verified before anything is deserialized."""
    dev = resolve_device(device)
    manifest, template, loaded = _read(path, verify)
    tensors = [
        torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
        for a in loaded
    ]
    return manifest, _rebuild(template, iter(tensors))


def verify_checkpoint(path: str) -> dict:
    """Full integrity check of a checkpoint directory, on the host (no
    device is touched): manifest present and parseable, format
    supported, files hash-clean, and every leaf deserializes with the
    shape and dtype the saved config gives it. Returns a summary; raises
    (``CheckpointIntegrityError`` / ``ValueError``) on any defect."""
    manifest, _template, _loaded = _read(path, verify=True)
    return {
        "path": path,
        "format": manifest["format"],
        "mode": manifest["mode"],
        "round": manifest["round"],
        "n_leaves": manifest["n_leaves"],
        "shards": len(manifest["slices"]) if manifest.get("slices") else 1,
        "mesh": manifest.get("mesh"),
        "hashed_files": sorted((manifest.get("files") or {})),
        "extra": manifest.get("extra"),
    }
