"""Checkpoint/resume with ``torch.save``, integrity manifests, the
full-state sidecar, auto-resume and async saves (port of
dba_mod_tpu/checkpoint.py).

Reference parity (helper.py:51-57, :420-435; image_helper.py:56-67): the
saved unit is {model state, epoch, lr}; resume restores the global model,
sets start_epoch = saved_epoch + 1 and overwrites the config lr.

A snapshot is a DIRECTORY (``model_last.pt.tar`` and friends, as the JAX
package's orbax step dirs are) holding ``state.pt``. Beside it:

- ``<name>.aux.pt`` — the full-state sidecar (:func:`save_aux_state`): the
  reference checkpoints only the model while FoolsGold's memory lives in
  RAM (helper.py:545-549), so a restart silently resets the defense; the
  sidecar carries FoolsGold's memory, the best-val loss, every RNG stream's
  position, the stale lane's replay source and the health sentinel's EMA,
  so a resumed run replays the uninterrupted trajectory exactly;
- ``<name>.manifest.json`` — sha256/size over every file of the snapshot
  plus the sidecar, in the JAX package's manifest scheme, written
  atomically AFTER both. Resume verifies before restoring; a corrupt
  snapshot is quarantined to ``<name>.corrupt/`` and resume falls back to
  the newest verified one (:func:`latest_verified_checkpoint`).

:func:`find_auto_resume` implements ``resumed_model: auto``;
:class:`CheckpointManager` adds the ``.prev`` clone that keeps one verified
snapshot at every instant of an overwrite, retention GC (``keep_last_n``;
``model_last`` and ``.best`` always kept) and the startup sweep of
orphaned ``*.tmp`` files.

**Async saves** (``async_save=True``, used by ``pipeline_rounds`` /
``overlap_eval``): the writes go to ONE background writer thread that runs
its jobs in program order — the ``.prev`` clone, the state files, the
sidecar, then the manifest, which is therefore written only after its
files landed (:func:`queue_manifest`). The caller hands in host copies
captured at dispatch, so the writer never touches the device.
:func:`wait_for_async_saves` drains the writer and raises the first failed
job's error (a failed job's later jobs are skipped: a failed write never
gets a manifest); it is registered with ``atexit`` on first use.
"""
from __future__ import annotations

import atexit
import hashlib
import json
import logging
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dba_mod_tpu_torch.models import ModelVars
from dba_mod_tpu_torch.utils import telemetry

logger = logging.getLogger("dba_mod_tpu_torch")

AUX_SUFFIX = ".aux.pt"
MANIFEST_SUFFIX = ".manifest.json"
CORRUPT_SUFFIX = ".corrupt"
PREV_SUFFIX = ".prev"
STATE_FILE = "state.pt"


# ------------------------------------------------------------ async writer
class _AsyncWriter:
    """One daemon thread running checkpoint jobs in submission order. After
    a failed job the later ones are skipped, and the error is raised by the
    next :meth:`check` or :meth:`wait`."""

    def __init__(self):
        self._q: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self._error: Optional[BaseException] = None
        threading.Thread(target=self._loop, daemon=True,
                         name="dba-checkpoint-writer").start()

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            try:
                if self._error is None:
                    job()
            except BaseException as exc:  # noqa: BLE001 — re-raised
                self._error = exc
            finally:
                self._q.task_done()

    def submit(self, job: Callable[[], None]) -> None:
        self.check()
        self._q.put(job)

    def check(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("an async checkpoint write failed; its "
                               "snapshot got no manifest") from err

    def wait(self) -> None:
        self._q.join()
        self.check()


_writer: Optional[_AsyncWriter] = None
_writer_lock = threading.Lock()

# manifests owed to async saves whose files have not landed yet: abs path
# -> epoch. Module-level, so every manager of the process shares it.
_pending_manifests: Dict[str, int] = {}


def async_job(job: Callable[[], None]) -> None:
    """Run `job` on the checkpoint writer, after every job submitted
    before it (the writer starts at first use; every exit path then waits
    for it through ``atexit``)."""
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = _AsyncWriter()
            atexit.register(wait_for_async_saves)
    _writer.submit(job)


def _run(job: Callable[[], None], async_save: bool) -> None:
    if async_save:
        async_job(job)
    else:
        job()


def wait_for_async_saves() -> None:
    """Block until every queued checkpoint job has run (so every async
    snapshot and the manifests it was owed are on disk); raises the error
    of a failed job."""
    if _writer is not None:
        with telemetry.span("checkpoint/wait_async"):
            _writer.wait()


def _host_tree(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_checkpoint(path: str | Path, model_vars: ModelVars, epoch: int,
                    lr: float, *, async_save: bool = False) -> None:
    """Write ``<path>/state.pt`` atomically (tmp + os.replace). With
    `async_save` the write is queued on the writer thread; give it host
    tensors (copies captured at dispatch) so the caller never waits for
    the card."""
    path = Path(path).absolute()
    payload = {"params": _host_tree(model_vars.params),
               "batch_stats": _host_tree(model_vars.batch_stats),
               "epoch": int(epoch), "lr": float(lr)}

    def write():
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / (STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path / STATE_FILE)

    telemetry.count("checkpoint/saves")
    with telemetry.span("checkpoint/save_async_enqueue" if async_save
                        else "checkpoint/save"):
        _run(write, async_save)


def load_checkpoint(path: str | Path, like: ModelVars
                    ) -> Tuple[ModelVars, int, float]:
    """Restore a snapshot onto `like`'s devices; the key sets and shapes
    must match `like` (a checkpoint of another model raises)."""
    path = Path(path).absolute()
    telemetry.count("checkpoint/loads")
    with telemetry.span("checkpoint/load"):
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


# ----------------------------------------------------------- full-state aux
def save_aux_state(path: str | Path, aux: Dict[str, Any], *,
                   async_save: bool = False) -> None:
    """Write the experiment sidecar next to a snapshot directory, atomically
    (tmp + os.replace), so a crash mid-save leaves the previous sidecar.
    `aux` holds CPU tensors, python scalars, strings and tuples of them —
    what ``torch.load(weights_only=True)`` reads back. `async_save` queues
    the write on the writer thread."""
    path = Path(str(path) + AUX_SUFFIX).absolute()

    def write():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        torch.save(aux, tmp)
        os.replace(tmp, path)

    _run(write, async_save)


def load_aux_state(path: str | Path) -> Optional[Dict[str, Any]]:
    """Read the sidecar of `path`; None when absent (a pretrain snapshot:
    model-only resume is the reference behavior and stays supported). A
    truncated or corrupt sidecar also gives None, with a loud warning —
    model-only resume is the documented fallback, never a crash."""
    path = Path(str(path) + AUX_SUFFIX).absolute()
    if not path.exists():
        return None
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:  # noqa: BLE001 — any unreadable sidecar
        telemetry.count("checkpoint/corrupt_detected")
        logger.warning(
            "resume sidecar %s is corrupt (%r) — degrading to model-only "
            "resume (FoolsGold memory and RNG streams restart)", path, exc)
        return None


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
    with telemetry.span("checkpoint/manifest"):
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
    with telemetry.span("checkpoint/verify"):
        return _verify(path, mpath)


def _verify(path: Path, mpath: Path) -> Tuple[bool, str]:
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


def quarantine_checkpoint(path: str | Path) -> Path:
    """Move a corrupt snapshot (dir + sidecar + manifest) aside to
    ``<name>.corrupt/`` so it cannot be picked again and a human can
    inspect it. Returns the quarantine dir."""
    path = Path(path).absolute()
    dest = Path(str(path) + CORRUPT_SUFFIX)
    n = 0
    while dest.exists():
        n += 1
        dest = Path(str(path) + f"{CORRUPT_SUFFIX}-{n}")
    dest.mkdir(parents=True)
    for piece in (path, Path(str(path) + AUX_SUFFIX), manifest_path(path)):
        if piece.exists():
            shutil.move(str(piece), str(dest / piece.name))
    telemetry.count("checkpoint/quarantined")
    logger.warning("quarantined corrupt checkpoint %s -> %s", path, dest)
    return dest


# ----------------------------------------------------- discovery / fallback
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


def latest_verified_checkpoint(folder: str | Path,
                               quarantine: bool = True) -> Optional[Path]:
    """Newest snapshot in `folder` that passes verification. Corrupt
    candidates met on the way are logged and (by default) quarantined —
    resume falls back past them instead of crashing."""
    folder = Path(folder).absolute()
    for ep, _, p in _discovery_candidates(folder):
        ok, reason = verify_checkpoint(p)
        if ok:
            return p
        telemetry.count("checkpoint/corrupt_detected")
        logger.warning(
            "checkpoint %s (epoch %d) failed verification: %s — falling "
            "back to the previous verified snapshot", p, ep, reason)
        if quarantine:
            quarantine_checkpoint(p)
    return None


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
    telemetry.count("checkpoint/corrupt_detected")
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


def find_auto_resume(run_dir: str | Path, run_type: str,
                     run_name: str = "") -> Optional[Tuple[Path, Path]]:
    """``resumed_model: auto``: scan `run_dir` for this workload's run
    folders (``{type}_*``, or only ``run_name`` when one is fixed), newest
    first, and return ``(run_folder, checkpoint)`` for the newest verified
    checkpoint — None when no folder holds one (a fresh start)."""
    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        return None
    if run_name:
        folders = [p for p in (run_dir / run_name,) if p.is_dir()]
    else:
        folders = sorted((p for p in run_dir.glob(f"{run_type}_*")
                          if p.is_dir()),
                         key=lambda p: p.stat().st_mtime, reverse=True)
    for folder in folders:
        hit = latest_verified_checkpoint(folder)
        if hit is not None:
            return folder, hit
    return None


# ------------------------------------------------------ fallback protection
def _clone_file(src: Path, dst: Path) -> None:
    try:
        os.link(src, dst)  # same dir => same fs; shares data blocks
    except OSError:  # pragma: no cover — fs without hardlink support
        shutil.copy2(src, dst)


def protect_last(path: str | Path) -> Optional[Path]:
    """Clone a verified snapshot to ``<name>.prev`` (hardlinks: no data
    copied) BEFORE it is overwritten, so one verified snapshot exists at
    every instant of a save; a kill between the overwrite and the new
    manifest then resumes from the clone. The clone's manifest is written
    last, atomically, so a kill mid-clone never leaves an unverifiable
    candidate. Returns the clone, or None when nothing verified exists."""
    path = Path(path).absolute()
    mpath = manifest_path(path)
    if not path.is_dir() or not mpath.exists():
        return None
    dest = Path(str(path) + PREV_SUFFIX)
    unprotect_prev(path)  # a stale clone from an earlier crash
    for p in sorted(path.rglob("*")):
        rel = p.relative_to(path)
        if p.is_dir():
            (dest / rel).mkdir(parents=True, exist_ok=True)
        else:
            (dest / rel).parent.mkdir(parents=True, exist_ok=True)
            _clone_file(p, dest / rel)
    aux = Path(str(path) + AUX_SUFFIX)
    if aux.exists():
        _clone_file(aux, Path(str(dest) + AUX_SUFFIX))
    # the manifest's keys are relative (ckpt/..., aux): valid verbatim
    mdest = manifest_path(dest)
    tmp = mdest.with_name(mdest.name + ".tmp")
    tmp.write_text(mpath.read_text())
    os.replace(tmp, mdest)
    return dest


def unprotect_prev(path: str | Path) -> None:
    """Delete ``<name>.prev`` — manifest first, so a kill mid-delete
    demotes the clone to a non-candidate instead of leaving an
    unverifiable one. Call only once the replacement's own manifest is on
    disk."""
    dest = Path(str(Path(path).absolute()) + PREV_SUFFIX)
    m = manifest_path(dest)
    if m.exists():
        m.unlink()
    aux = Path(str(dest) + AUX_SUFFIX)
    if aux.exists():
        aux.unlink()
    if dest.is_dir():
        shutil.rmtree(dest, ignore_errors=True)


# -------------------------------------------------- pending async manifests
def queue_manifest(path: str | Path, epoch: int) -> None:
    """Owe `path` a manifest for `epoch`, written by the writer thread once
    the files queued before it have landed (and before any later save of
    the same path starts: the writer runs its jobs in order)."""
    key, epoch = str(Path(path).absolute()), int(epoch)
    _pending_manifests[key] = epoch
    async_job(lambda: _land_manifest(key, epoch))


def _land_manifest(key: str, epoch: int) -> None:
    if _pending_manifests.get(key) == epoch:
        del _pending_manifests[key]
    if Path(key).is_dir():
        write_manifest(key, epoch)
        unprotect_prev(key)  # the replacement verifies: drop the clone


# --------------------------------------------------------- retention + sweep
def sweep_stale(folder: str | Path) -> List[str]:
    """Startup sweep of a run folder: delete the ``*.tmp`` files a crash
    can leave behind (sidecar / manifest / recorder tempfiles whose
    ``os.replace`` never ran). Returns (and logs) what was removed."""
    folder = Path(folder).absolute()
    removed: List[str] = []
    if not folder.is_dir():
        return removed
    for p in sorted(folder.glob("*.tmp")):
        if p.is_file():
            p.unlink()
            removed.append(p.name)
    if removed:
        logger.warning("startup sweep of %s removed %d stale artifact(s): "
                       "%s", folder, len(removed), ", ".join(removed))
    return removed


class CheckpointManager:
    """Per-run-folder policy around the plain save/load functions above:
    integrity manifests, the ``.prev`` clone around an overwrite, and
    retention GC. Host-side bookkeeping only."""

    def __init__(self, folder: Optional[Path], *, keep_last_n: int = 0,
                 manifests: bool = True):
        self.folder = Path(folder) if folder is not None else None
        self.keep_last_n = int(keep_last_n)
        self.manifests = bool(manifests)

    def prepare_overwrite(self, paths: List[Path],
                          async_save: bool = False) -> None:
        """Call BEFORE re-saving existing snapshot paths: clone each
        verified one to ``<name>.prev`` so a kill at any point of the
        upcoming save still leaves a verified resume point (the clone goes
        once the replacement's manifest lands, in :meth:`note_saved`).
        With `async_save` this runs on the writer, after the previous
        save's manifests landed."""
        if not self.manifests:
            return

        def run():
            for p in paths:
                protect_last(p)
        _run(run, async_save)

    def note_saved(self, paths: List[Path], epoch: int,
                   async_save: bool = False) -> None:
        """Call AFTER a round's snapshots and their sidecars are written
        (or queued): each gets its manifest, then its ``.prev`` clone is
        dropped — for an async save on the writer, once the files before
        it landed."""
        if not self.manifests:
            return
        for p in paths:
            if async_save:
                queue_manifest(p, epoch)
            else:
                write_manifest(p, epoch)
                unprotect_prev(p)

    def sweep(self) -> List[str]:
        return sweep_stale(self.folder) if self.folder is not None else []

    def gc(self, async_save: bool = False) -> List[Path]:
        """Retention: with ``keep_last_n > 0``, delete per-epoch snapshots
        (``*.epoch_N`` + sidecar + manifest) beyond the newest N.
        ``model_last`` and the best-val snapshot are always kept, and so is
        a snapshot still owed its manifest; the default (0) keeps
        everything — ``save_on_epochs`` lists are explicit user asks. With
        `async_save` it runs on the writer after the queued saves (and
        returns [])."""
        if self.keep_last_n <= 0 or self.folder is None:
            return []
        if async_save:
            async_job(self.gc)
            return []
        snaps = []
        for p in self.folder.iterdir():
            if not p.is_dir() or CORRUPT_SUFFIX in p.name:
                continue
            _, sep, tail = p.name.rpartition(".epoch_")
            if not sep or not tail.isdigit():
                continue
            snaps.append((int(tail), p))
        snaps.sort()
        doomed = [p for _, p in snaps[:-self.keep_last_n]
                  if str(p.absolute()) not in _pending_manifests]
        for p in doomed:
            shutil.rmtree(p, ignore_errors=True)
            for extra in (Path(str(p) + AUX_SUFFIX), manifest_path(p)):
                if extra.exists():
                    extra.unlink()
            telemetry.count("checkpoint/gc_removed")
        if doomed:
            logger.info("checkpoint GC (keep_last_n=%d) removed %s",
                        self.keep_last_n, [p.name for p in doomed])
        return doomed
