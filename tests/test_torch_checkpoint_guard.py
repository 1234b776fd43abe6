"""The port's checkpoint integrity layer (dba_mod_tpu_torch/checkpoint.py +
the Experiment wiring), after the JAX package's
tests/test_checkpoint_guard.py: manifests over the snapshot and its
sidecar, a flipped model byte and a flipped sidecar byte (both detected,
quarantined, and resume falls back), the startup sweep, retention GC, the
``.prev`` clone, and ``resumed_model: auto`` — continuing the same folder,
on the aggregation-interval grid, past a corrupt newest snapshot, or
starting fresh with nothing to find. In-process and small (synthetic
MNIST); the subprocess kill and signal tests are in
tests/test_torch_resume.py."""
import json
import shutil
from pathlib import Path

import pytest
import torch

from dba_mod_tpu_torch import checkpoint as ckpt
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl.experiment import Experiment

CFG = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=6, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, is_poison=False, synthetic_data=True,
    synthetic_train_size=600, synthetic_test_size=256, momentum=0.9,
    decay=0.0005, sampling_dirichlet=False, local_eval=False, random_seed=3,
    save_model=True)

VOLATILE = {"time", "round_time", "dispatch_time", "finalize_time"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def port_log(caplog):
    with caplog.at_level("WARNING", logger="dba_mod_tpu_torch"):
        yield caplog


def _strip(row):
    return {k: v for k, v in row.items() if k not in VOLATILE}


def _metrics_rows(folder):
    with open(Path(folder) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def _flip_byte(path: Path, offset_frac=0.5):
    data = bytearray(path.read_bytes())
    data[int(len(data) * offset_frac) % len(data)] ^= 0xFF
    path.write_bytes(bytes(data))


def _state_file(snapshot: Path) -> Path:
    return snapshot / ckpt.STATE_FILE


def _run(cfg, epochs, save_results=True):
    e = Experiment(Params.from_dict(cfg), save_results=save_results,
                   device="cpu")
    e.run(epochs)
    return e


# ---------------------------------------------------------------- manifests
def test_manifest_verify_roundtrip(tmp_path):
    e = _run(dict(CFG, run_dir=str(tmp_path / "runs")), 2)
    path = e.folder / "model_last.pt.tar"
    ok, reason = ckpt.verify_checkpoint(path)
    assert ok and reason == ckpt.VERIFY_OK
    assert ckpt.manifest_epoch(path) == 2
    doc = json.loads(ckpt.manifest_path(path).read_text())
    assert "aux" in doc["files"]  # the sidecar is covered too
    aux = ckpt.load_aux_state(path)
    assert aux["epoch"] == 2 and aux["noise_gen_device"] == "cpu"
    assert set(aux) >= {"fg_memory", "best_loss", "select_rng", "plan_rng",
                        "noise_gen", "last_backdoor_acc"}


def test_flipped_model_byte_detected_quarantined_and_fallback(tmp_path):
    e = _run(dict(CFG, run_dir=str(tmp_path / "runs"),
                  save_on_epochs=[1, 2, 3]), 3)
    folder = e.folder
    # corrupt the newest snapshots (model_last and .epoch_3 hold epoch 3;
    # .best may too) so the fallback is epoch 2
    for name in ("model_last.pt.tar", "model_last.pt.tar.epoch_3",
                 "model_last.pt.tar.best"):
        _flip_byte(_state_file(folder / name))
    best = ckpt.latest_verified_checkpoint(folder)
    assert best is not None and best.name == "model_last.pt.tar.epoch_2"
    quarantined = sorted(p.name for p in folder.iterdir()
                         if ckpt.CORRUPT_SUFFIX in p.name)
    assert quarantined == ["model_last.pt.tar.best.corrupt",
                           "model_last.pt.tar.corrupt",
                           "model_last.pt.tar.epoch_3.corrupt"]
    q = folder / "model_last.pt.tar.corrupt"
    assert (q / "model_last.pt.tar").is_dir()
    assert (q / "model_last.pt.tar.manifest.json").exists()
    assert (q / ("model_last.pt.tar" + ckpt.AUX_SUFFIX)).exists()


def test_flipped_sidecar_byte_detected_quarantined_and_fallback(tmp_path):
    e = _run(dict(CFG, run_dir=str(tmp_path / "runs"),
                  save_on_epochs=[1, 2, 3]), 3)
    folder = e.folder
    for name in ("model_last.pt.tar", "model_last.pt.tar.epoch_3",
                 "model_last.pt.tar.best"):
        _flip_byte(folder / (name + ckpt.AUX_SUFFIX))
    best = ckpt.latest_verified_checkpoint(folder)
    assert best is not None and best.name == "model_last.pt.tar.epoch_2"
    ok, reason = ckpt.verify_checkpoint(best)
    assert ok, reason
    assert ckpt.load_aux_state(best)["epoch"] == 2


def test_corrupt_sidecar_without_manifest_degrades_to_model_only(tmp_path,
                                                                 port_log):
    like = Experiment(Params.from_dict(dict(CFG, save_model=False)),
                      save_results=False, device="cpu")
    p = tmp_path / "m.pt.tar"
    ckpt.save_checkpoint(p, like.global_vars, 1, 0.1)
    (tmp_path / ("m.pt.tar" + ckpt.AUX_SUFFIX)).write_bytes(
        b"PK\x03\x04 truncated garbage")
    assert ckpt.load_aux_state(p) is None
    assert any("model-only resume" in r.getMessage()
               for r in port_log.records)
    cfg = dict(CFG, save_model=False, checkpoint_dir=str(tmp_path),
               resumed_model=True, resumed_model_name="m.pt.tar")
    r = Experiment(Params.from_dict(cfg), save_results=False, device="cpu")
    assert r.start_epoch == 2 and r._resume_aux is None


def test_verify_never_raises_on_mangled_manifest(tmp_path):
    e = _run(dict(CFG, run_dir=str(tmp_path / "runs")), 1)
    path = e.folder / "model_last.pt.tar"
    m = ckpt.manifest_path(path)
    for doc in ('{"version": 1, "epoch": 1, "files": null}',
                '{"version": 1, "epoch": 1, "files": {"aux": 3}}',
                '{"version": 1, "epoch": 1, '
                '"files": {"aux": {"size": "y", "sha256": 1}}}',
                '[]', '{"epoch": 1}'):
        m.write_text(doc)
        ok, reason = ckpt.verify_checkpoint(path)
        assert not ok and reason, doc


# -------------------------------------------------------------- sweep + gc
def test_startup_sweep_removes_stale_tmp_artifacts(tmp_path, port_log):
    folder = tmp_path / "f"
    folder.mkdir()
    (folder / ("model_last.pt.tar" + ckpt.AUX_SUFFIX + ".tmp")).write_bytes(
        b"half a sidecar")
    (folder / "metrics.jsonl.tmp").write_text("{}")
    removed = ckpt.sweep_stale(folder)
    assert sorted(removed) == ["metrics.jsonl.tmp",
                               "model_last.pt.tar.aux.pt.tmp"]
    assert any("startup sweep" in r.getMessage() for r in port_log.records)
    assert ckpt.sweep_stale(folder) == []  # idempotent


def test_retention_gc_keeps_last_n_best_and_model_last(tmp_path):
    e = _run(dict(CFG, run_dir=str(tmp_path / "runs"), keep_last_n=2,
                  save_on_epochs=[1, 2, 3, 4, 5]), 5)
    folder = e.folder
    dirs = sorted(p.name for p in folder.iterdir() if p.is_dir())
    assert dirs == ["model_last.pt.tar", "model_last.pt.tar.best",
                    "model_last.pt.tar.epoch_4",
                    "model_last.pt.tar.epoch_5"]
    for ep in (1, 2, 3):
        base = folder / f"model_last.pt.tar.epoch_{ep}"
        assert not Path(str(base) + ckpt.AUX_SUFFIX).exists()
        assert not ckpt.manifest_path(base).exists()
    for name in dirs:
        ok, reason = ckpt.verify_checkpoint(folder / name)
        assert ok, (name, reason)
    # no .prev clone outlives its save
    assert not any(p.name.endswith(ckpt.PREV_SUFFIX)
                   for p in folder.iterdir())


def test_prev_clone_protects_mid_save_kill(tmp_path):
    """A kill in the middle of save_model: model_last was rewritten but its
    manifest was not (stale → quarantined on discovery), and .best was
    deleted. The .prev clone prepare_overwrite made is the surviving
    verified candidate, so auto-resume falls back one round instead of
    restarting."""
    e = _run(dict(CFG, run_dir=str(tmp_path / "runs")), 2)
    folder = e.folder
    path = folder / "model_last.pt.tar"
    prev = ckpt.protect_last(path)
    assert prev is not None and ckpt.verify_checkpoint(prev)[0]
    # the round-3 re-save replaced the file (the .prev hardlink keeps the
    # old inode) but its manifest never landed
    (path / ckpt.STATE_FILE).unlink()
    ckpt.save_checkpoint(path, e.global_vars, 3, 0.05)
    shutil.rmtree(folder / "model_last.pt.tar.best", ignore_errors=True)
    best = ckpt.latest_verified_checkpoint(folder)
    assert best is not None and best.name == "model_last.pt.tar.prev"
    ckpt.unprotect_prev(path)
    assert not prev.exists()
    assert not ckpt.manifest_path(prev).exists()


# ------------------------------------------------------------- auto-resume
def test_auto_resume_continues_same_folder_identical_trajectory(tmp_path):
    cfg = dict(CFG, run_dir=str(tmp_path / "runs"))
    ref = _run(dict(cfg, run_dir=str(tmp_path / "runs_ref")), 6)
    ref_rows = _metrics_rows(ref.folder)
    a = _run(cfg, 3)
    folder = a.folder
    del a
    b = Experiment(Params.from_dict(dict(cfg, resumed_model="auto")),
                   save_results=True, device="cpu")
    assert b.folder == folder          # reused, not a fresh folder
    assert b.start_epoch == 4
    assert b._resume_aux is not None   # the sidecar was restored
    b.run(6)
    rows = _metrics_rows(folder)
    assert [r["epoch"] for r in rows] == [1, 2, 3, 4, 5, 6]  # no dupes
    for x, y in zip(ref_rows, rows):
        assert _strip(x) == _strip(y)
    lines = (folder / "round_result.csv").read_text().strip().splitlines()
    assert [line.split(",")[0] for line in lines[1:]] == [
        "1", "2", "3", "4", "5", "6"]


def test_auto_resume_interval_two_stays_on_grid(tmp_path):
    cfg = dict(CFG, run_dir=str(tmp_path / "runs"), aggr_epoch_interval=2)
    ref = _run(dict(cfg, run_dir=str(tmp_path / "runs_ref")), 6)
    ref_rows = _metrics_rows(ref.folder)
    a = _run(cfg, 4)       # rounds at base epochs 1, 3
    folder = a.folder
    del a
    b = Experiment(Params.from_dict(dict(cfg, resumed_model="auto")),
                   save_results=True, device="cpu")
    assert b.folder == folder and b.start_epoch == 5
    b.run(6)
    rows = _metrics_rows(folder)
    assert [r["epoch"] for r in rows] == [r["epoch"] for r in ref_rows]
    for x, y in zip(ref_rows, rows):
        assert _strip(x) == _strip(y)


def test_auto_resume_falls_back_past_corrupt_newest(tmp_path, port_log):
    cfg = dict(CFG, run_dir=str(tmp_path / "runs"), save_on_epochs=[1, 2, 3])
    a = _run(cfg, 3)
    folder = a.folder
    del a
    for name in ("model_last.pt.tar", "model_last.pt.tar.epoch_3",
                 "model_last.pt.tar.best"):
        _flip_byte(_state_file(folder / name))
    b = Experiment(Params.from_dict(dict(cfg, resumed_model="auto")),
                   save_results=True, device="cpu")
    assert b.folder == folder
    assert b.start_epoch == 3  # fell back to the verified epoch-2 snapshot
    assert any("failed verification" in r.getMessage()
               for r in port_log.records)
    assert [r["epoch"] for r in b.recorder._jsonl_rows] == [1, 2]
    b.run(3)
    assert [r["epoch"] for r in _metrics_rows(folder)] == [1, 2, 3]


def test_auto_resume_with_nothing_to_find_starts_fresh(tmp_path, port_log):
    cfg = dict(CFG, run_dir=str(tmp_path / "empty_runs"),
               resumed_model="auto")
    e = Experiment(Params.from_dict(cfg), save_results=True, device="cpu")
    assert e.start_epoch == 1
    assert any("no verified checkpoint" in r.getMessage()
               for r in port_log.records)
