"""Checkpoint/resume with ``torch.save`` and integrity manifests (port of
dba_mod_tpu/checkpoint.py:105-147, 189-291, 356-395).

Reference parity (helper.py:51-57, :420-435; image_helper.py:56-67): the
saved unit is {model state, epoch, lr}; resume restores the global model,
sets start_epoch = saved_epoch + 1 and overwrites the config lr.

A snapshot is a DIRECTORY (``model_last.pt.tar`` and friends, as the JAX
package's orbax step dirs are) holding ``state.pt``; its
``<name>.manifest.json`` carries sha256/size over every file in it, in the
JAX package's manifest scheme, written atomically after the save. Resume
verifies before restoring. The full-state sidecar, ``CheckpointManager``
(retention, ``.prev`` clones), auto-resume and quarantine are ROADMAP A15.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from dba_mod_tpu_torch.models import ModelVars

logger = logging.getLogger("dba_mod_tpu_torch")

AUX_SUFFIX = ".aux.pkl"
MANIFEST_SUFFIX = ".manifest.json"
CORRUPT_SUFFIX = ".corrupt"
STATE_FILE = "state.pt"


def save_checkpoint(path: str | Path, model_vars: ModelVars, epoch: int,
                    lr: float) -> None:
    """Write ``<path>/state.pt`` atomically (tmp + os.replace)."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    payload = {"params": {k: v.detach().cpu()
                          for k, v in model_vars.params.items()},
               "batch_stats": {k: v.detach().cpu()
                               for k, v in model_vars.batch_stats.items()},
               "epoch": int(epoch), "lr": float(lr)}
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path / STATE_FILE)


def load_checkpoint(path: str | Path, like: ModelVars
                    ) -> Tuple[ModelVars, int, float]:
    """Restore a snapshot onto `like`'s devices; the key sets and shapes
    must match `like` (a checkpoint of another model raises)."""
    path = Path(path).absolute()
    state = torch.load(path / STATE_FILE, map_location="cpu",
                       weights_only=True)

    def restore(saved: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]):
        if set(saved) != set(ref):
            raise ValueError(f"checkpoint {path} does not match this model: "
                             f"keys differ ({sorted(set(saved) ^ set(ref))})")
        out = {}
        for k, v in ref.items():
            if saved[k].shape != v.shape:
                raise ValueError(f"checkpoint {path}: {k} has shape "
                                 f"{tuple(saved[k].shape)}, model "
                                 f"{tuple(v.shape)}")
            out[k] = saved[k].to(device=v.device, dtype=v.dtype)
        return out

    mv = ModelVars(restore(state["params"], like.params),
                   restore(state["batch_stats"], like.batch_stats))
    return mv, int(state["epoch"]), float(state["lr"])


# ------------------------------------------------------- integrity manifests
def manifest_path(path: str | Path) -> Path:
    return Path(str(path) + MANIFEST_SUFFIX).absolute()


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _checkpoint_files(path: Path) -> Dict[str, Path]:
    """Every file a manifest covers: the snapshot dir's files (keyed by
    relative posix path under ``ckpt/``) plus an aux sidecar when
    present."""
    out: Dict[str, Path] = {}
    base = Path(path).absolute()
    if base.is_dir():
        for p in sorted(base.rglob("*")):
            if p.is_file():
                out["ckpt/" + p.relative_to(base).as_posix()] = p
    aux = Path(str(base) + AUX_SUFFIX)
    if aux.exists():
        out["aux"] = aux
    return out


def write_manifest(path: str | Path, epoch: int) -> Path:
    """Content-checksum manifest over a saved snapshot, written atomically
    (tmp + os.replace) so a crash mid-write leaves the previous manifest or
    none — never a half-manifest."""
    path = Path(path).absolute()
    files = {key: {"sha256": _sha256(p), "size": p.stat().st_size}
             for key, p in _checkpoint_files(path).items()}
    doc = {"version": 1, "epoch": int(epoch), "files": files}
    mpath = manifest_path(path)
    tmp = mpath.with_name(mpath.name + ".tmp")
    tmp.write_text(json.dumps(doc, indent=0, sort_keys=True))
    os.replace(tmp, mpath)
    return mpath


def manifest_epoch(path: str | Path) -> Optional[int]:
    """The epoch a snapshot's manifest records; None without a readable
    manifest."""
    try:
        return int(json.loads(manifest_path(path).read_text())["epoch"])
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError):
        return None


VERIFY_OK = "verified"
VERIFY_NO_MANIFEST = "no-manifest"


def verify_checkpoint(path: str | Path) -> Tuple[bool, str]:
    """Recompute checksums against the manifest. ``(True, 'verified')``,
    ``(False, 'no-manifest')`` for a snapshot saved without one (pretrain
    outputs), or ``(False, <reason>)`` for a detected corruption. Extra
    files beyond the manifest are ignored."""
    path = Path(path).absolute()
    mpath = manifest_path(path)
    if not mpath.exists():
        return False, VERIFY_NO_MANIFEST
    # broad catches: an unreadable manifest, valid JSON of the wrong shape
    # or a file vanishing mid-hash all mean "not verified", never an
    # exception into the resume path
    try:
        doc = json.loads(mpath.read_text())
        manifest_files = dict(doc["files"])
    except Exception as exc:  # noqa: BLE001
        return False, f"unreadable manifest: {exc!r}"
    if not path.is_dir():
        return False, "checkpoint dir missing"
    on_disk = _checkpoint_files(path)
    try:
        for key, want in manifest_files.items():
            p = on_disk.get(key)
            if p is None:
                return False, f"missing file: {key}"
            if p.stat().st_size != int(want["size"]):
                return False, (f"size mismatch: {key} "
                               f"({p.stat().st_size} != {want['size']})")
            if _sha256(p) != want["sha256"]:
                return False, f"checksum mismatch: {key}"
    except Exception as exc:  # noqa: BLE001
        return False, f"verification error: {exc!r}"
    return True, VERIFY_OK


def _discovery_candidates(folder: Path) -> List[Tuple[int, float, Path]]:
    """Manifested snapshot dirs under `folder`, newest first by (manifest
    epoch, mtime), the canonical snapshot before `.best` at equal epoch."""
    out = []
    if not folder.is_dir():
        return out
    for p in folder.iterdir():
        if not p.is_dir() or CORRUPT_SUFFIX in p.name:
            continue
        ep = manifest_epoch(p)
        if ep is None:
            continue
        out.append((ep, p.stat().st_mtime, p))
    out.sort(key=lambda t: (t[0], not t[2].name.endswith(".best"), t[1]),
             reverse=True)
    return out


def resolve_verified(path: str | Path) -> Path:
    """Verification gate for an explicitly named resume checkpoint.
    Verified → the path. Manifest-less → the path (pretrain snapshots carry
    no manifest). Corrupt → the newest verified snapshot of the SAME name
    family (``<name>.epoch_N``/``.best``/``.prev``); with none, raise. Never
    mutates the directory, which may be a shared checkpoint library."""
    path = Path(path).absolute()
    ok, reason = verify_checkpoint(path)
    if ok:
        return path
    if reason == VERIFY_NO_MANIFEST:
        if not path.is_dir():
            raise FileNotFoundError(f"resume checkpoint not found: {path}")
        return path
    logger.warning("resume checkpoint %s failed verification: %s",
                   path, reason)
    for ep, _, p in _discovery_candidates(path.parent):
        if p == path or not p.name.startswith(path.name + "."):
            continue
        if verify_checkpoint(p)[0]:
            logger.warning("resuming from fallback checkpoint %s "
                           "(epoch %d)", p, ep)
            return p
    raise RuntimeError(
        f"resume checkpoint {path} is corrupt ({reason}) and no verified "
        f"same-name fallback ({path.name}.prev/.epoch_N/.best) exists in "
        f"{path.parent}")
