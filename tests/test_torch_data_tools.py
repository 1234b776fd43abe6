"""The port's data tooling (ROADMAP A21): dba_mod_tpu_torch/data/fetch.py
(tests/test_fetch.py's counterparts, with ``urllib.request.urlopen``
stubbed: nothing downloads), data/etl.py on files the tests write, held to
the JAX package's ETL on the same inputs, the four CLI subcommands
(``fetch``, ``cache-tiny``, ``loan-etl``, ``tiny-etl``) through
``main()``, and profile_round's LOAN path on the CPU at LOAN_AB's size.
"""
import gzip
import hashlib
import io
import json
import tarfile

import numpy as np
import torch
import yaml

from dba_mod_tpu.data import etl as jetl
from dba_mod_tpu.data import fetch as JF
from dba_mod_tpu_torch.data import etl
from dba_mod_tpu_torch.data import fetch as F
from dba_mod_tpu_torch.main import main

torch.set_num_threads(1)


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _repin(monkeypatch, payload):
    spec = F.DATASETS["cifar"]
    monkeypatch.setitem(
        F.DATASETS, "cifar",
        F.DatasetSpec(spec.name,
                      [F.RemoteFile(spec.files[0].relpath,
                                    spec.files[0].url, _sha(payload))],
                      spec.ready_probe, spec.post_steps))


class _FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ------------------------------------------------------------------ fetch
def test_pins_and_sources_are_the_reference_packages():
    """Every dataset, URL and sha256 pin is the JAX package's, and every
    artifact has an URL or a documented manual path."""
    assert set(F.DATASETS) == set(JF.DATASETS) == {
        "mnist", "cifar", "tiny-imagenet-200", "loan"}
    for name, spec in F.DATASETS.items():
        jspec = JF.DATASETS[name]
        assert [(f.relpath, f.url, f.sha256) for f in spec.files] == \
            [(f.relpath, f.url, f.sha256) for f in jspec.files]
        assert spec.ready_probe.__name__ == jspec.ready_probe.__name__
        assert spec.files
        for rf in spec.files:
            assert rf.url or spec.post_steps
    for rf in F.DATASETS["mnist"].files + F.DATASETS["cifar"].files:
        assert rf.sha256 and len(rf.sha256) == 64
        int(rf.sha256, 16)
    # the manual steps name the port's CLI
    assert "dba_mod_tpu_torch.main" in F.DATASETS["loan"].post_steps


def test_check_missing_reports_urls(tmp_path):
    status, details = F.check_dataset("cifar", tmp_path)
    assert status == F.MISSING
    assert any("cs.toronto.edu" in d for d in details)


def test_check_ready_short_circuits(tmp_path):
    (tmp_path / "cifar-10-batches-py").mkdir()
    (tmp_path / "cifar-10-batches-py" / "data_batch_1").write_bytes(b"x")
    assert F.check_dataset("cifar", tmp_path)[0] == F.READY


def test_check_archive_verifies_pinned_sha(tmp_path, monkeypatch):
    payload = b"definitely-a-cifar-tarball"
    (tmp_path / "cifar-10-python.tar.gz").write_bytes(payload)
    status, details = F.check_dataset("cifar", tmp_path)
    assert status == F.CORRUPT
    assert any("MISMATCH" in d for d in details)
    _repin(monkeypatch, payload)
    status, details = F.check_dataset("cifar", tmp_path)
    assert status == F.ARCHIVE
    assert any("verified" in d for d in details)


def test_check_unpinned_artifact_reports_computed_sha(tmp_path):
    payload = b"tiny-zip-bytes"
    (tmp_path / "tiny-imagenet-200.zip").write_bytes(payload)
    status, details = F.check_dataset("tiny-imagenet-200", tmp_path)
    assert status == F.ARCHIVE
    assert any(_sha(payload) in d for d in details)


def test_mnist_gz_files_are_loader_ready(tmp_path):
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for rf in F.DATASETS["mnist"].files:
        with gzip.open(raw / rf.relpath.split("/")[-1], "wb") as f:
            f.write(b"idx")
    assert F.check_dataset("mnist", tmp_path)[0] == F.READY


def test_loan_is_manual_then_ready(tmp_path):
    status, details = F.check_dataset("loan", tmp_path)
    assert status == F.MANUAL
    assert any("loan-etl" in d for d in details)
    (tmp_path / "loan").mkdir()
    (tmp_path / "loan" / "loan_CA.csv").write_text("loan_status\n1\n")
    assert F.check_dataset("loan", tmp_path)[0] == F.READY


def test_run_preflight_check_only_exit_codes(tmp_path, capsys):
    assert F.run_preflight(["cifar"], str(tmp_path), check_only=True) == 1
    assert "DETERMINISTIC SYNTHETIC" in capsys.readouterr().out
    (tmp_path / "cifar-10-batches-py").mkdir()
    (tmp_path / "cifar-10-batches-py" / "data_batch_1").write_bytes(b"x")
    assert F.run_preflight(["cifar"], str(tmp_path), check_only=True) == 0
    assert "DETERMINISTIC SYNTHETIC" not in capsys.readouterr().out


def test_run_preflight_fetch_downloads_and_extracts(tmp_path, monkeypatch):
    """The download path with urlopen stubbed: download → verify →
    extract → READY, no socket opened."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as t:
        data = b"batch-bytes"
        info = tarfile.TarInfo("cifar-10-batches-py/data_batch_1")
        info.size = len(data)
        t.addfile(info, io.BytesIO(data))
    payload = buf.getvalue()
    _repin(monkeypatch, payload)
    urls = []

    def fake(url, timeout=60):
        urls.append(url)
        return _FakeResponse(payload)
    monkeypatch.setattr("urllib.request.urlopen", fake)
    assert F.run_preflight(["cifar"], str(tmp_path), check_only=False) == 0
    assert (tmp_path / "cifar-10-batches-py" / "data_batch_1").exists()
    assert urls == [F.DATASETS["cifar"].files[0].url]


def test_run_preflight_fetch_failure_degrades_to_fallback_note(
        tmp_path, monkeypatch, capsys):
    def boom(url, timeout=60):
        raise OSError("no route to host")
    monkeypatch.setattr("urllib.request.urlopen", boom)
    assert F.run_preflight(["cifar"], str(tmp_path), check_only=False) == 1
    assert "DETERMINISTIC SYNTHETIC" in capsys.readouterr().out


# -------------------------------------------------------------------- ETL
def _raw_loan(path, n=60):
    import pandas as pd
    rng = np.random.RandomState(0)
    pd.DataFrame({
        "id": np.arange(n),                       # dropped
        "loan_status": rng.randint(0, 9, n),
        "grade": rng.choice(["A", "B", "C"], n),  # object → ordinal
        "big_num": rng.uniform(5000, 20000, n),   # mean > 1000 → /10000
        "mid_num": rng.uniform(15, 40, n),        # mean in (10, 100] → /10
        "addr_state": rng.choice(["CA", "NY", "TX"], n),
    }).to_csv(path, index=False)


def test_preprocess_loan_matches_jax(tmp_path):
    src = tmp_path / "loan.csv"
    _raw_loan(src)
    assert etl.preprocess_loan(src, tmp_path / "port") == 3
    assert jetl.preprocess_loan(src, tmp_path / "jax") == 3
    for state in ("CA", "NY", "TX"):
        got = (tmp_path / "port" / f"loan_{state}.csv").read_bytes()
        assert got == (tmp_path / "jax" / f"loan_{state}.csv").read_bytes()
    import pandas as pd
    out = pd.read_csv(tmp_path / "port" / "loan_CA.csv")
    assert "id" not in out.columns and "addr_state" not in out.columns
    assert out["big_num"].mean() < 10
    assert set(out["grade"].unique()) <= {0, 1, 2}


def _tiny_val(root):
    val = root / "val"
    (val / "images").mkdir(parents=True)
    for i in range(3):
        (val / "images" / f"val_{i}.JPEG").write_bytes(b"x")
    (val / "val_annotations.txt").write_text(
        "val_0.JPEG\tn01\t0\t0\t10\t10\n"
        "val_1.JPEG\tn01\t0\t0\t10\t10\n"
        "val_2.JPEG\tn02\t0\t0\t10\t10\n")
    return val


def test_reformat_tiny_imagenet_val(tmp_path):
    val = _tiny_val(tmp_path)
    assert etl.reformat_tiny_imagenet_val(tmp_path) == 3
    assert (val / "n01" / "val_0.JPEG").exists()
    assert (val / "n01" / "val_1.JPEG").exists()
    assert (val / "n02" / "val_2.JPEG").exists()
    assert not (val / "val_annotations.txt").exists()
    assert etl.reformat_tiny_imagenet_val(tmp_path) == 0   # idempotent


# ------------------------------------------------------- the subcommands
def test_fetch_subcommand(tmp_path, capsys):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump({
        "type": "cifar", "lr": 0.1, "batch_size": 4, "epochs": 1,
        "no_models": 2, "number_of_total_participants": 2, "eta": 1.0,
        "aggregation_methods": "mean", "data_dir": str(tmp_path / "d")}))
    assert main(["fetch", "--params", str(cfg), "--check-only"]) == 1
    out = capsys.readouterr().out
    assert "cifar" in out and "DETERMINISTIC SYNTHETIC" in out
    (tmp_path / "d" / "cifar-10-batches-py").mkdir(parents=True)
    (tmp_path / "d" / "cifar-10-batches-py" / "data_batch_1").write_bytes(
        b"x")
    assert main(["fetch", "--params", str(cfg), "--check-only"]) == 0
    assert main(["fetch", "--type", "loan", "--data-dir",
                 str(tmp_path / "d"), "--check-only"]) == 1


def test_loan_etl_and_tiny_etl_subcommands(tmp_path, capsys):
    src = tmp_path / "raw.csv"
    _raw_loan(src)
    assert main(["loan-etl", "--input", str(src), "--data-dir",
                 str(tmp_path)]) == 0
    assert "wrote 3 per-state loan CSVs" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "loan").iterdir()) == [
        "loan_CA.csv", "loan_NY.csv", "loan_TX.csv"]
    _tiny_val(tmp_path / "tiny-imagenet-200")
    assert main(["tiny-etl", "--data-dir", str(tmp_path)]) == 0
    assert "moved 3 val images" in capsys.readouterr().out


def test_cache_tiny_subcommand(tmp_path, capsys):
    """cache-tiny decodes the post-ETL folders into the .npz the loader
    reads first; without folders it exits 1."""
    from PIL import Image
    from dba_mod_tpu_torch.data.datasets import load_tiny_imagenet
    assert main(["cache-tiny", "--data-dir", str(tmp_path)]) == 1
    capsys.readouterr()
    root = tmp_path / "tiny-imagenet-200"
    rng = np.random.RandomState(0)
    for wnid in ("n01", "n02"):
        d = root / "train" / wnid / "images"
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)
                            ).save(d / f"{wnid}_{i}.JPEG")
        v = root / "val" / wnid
        v.mkdir(parents=True)
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
            v / f"val_{wnid}.JPEG")
    folders = load_tiny_imagenet(str(tmp_path))
    assert main(["cache-tiny", "--data-dir", str(tmp_path)]) == 0
    assert "cached 4 train / 2 val images" in capsys.readouterr().out
    cached = load_tiny_imagenet(str(tmp_path))     # now from the .npz
    assert (tmp_path / "tiny-imagenet-200.npz").exists()
    np.testing.assert_array_equal(cached.train_images,
                                  folders.train_images)
    np.testing.assert_array_equal(cached.test_labels, folders.test_labels)


# -------------------------------------------------- profile_round: LOAN
def test_profile_round_runs_loan_on_the_cpu(tmp_path, capsys):
    """profile_round takes LOAN (the dropout model) with the engine's
    keep masks: the phases run and the JSON line reports them (LOAN_AB
    with one local epoch and larger batches: the CPU profiler records
    every op)."""
    from benchmarks.parity_ab import LOAN_AB
    from dba_mod_tpu_torch import profile_round
    cfg = tmp_path / "loan.yaml"
    cfg.write_text(yaml.safe_dump(dict(
        LOAN_AB, epochs=2, internal_epochs=1, internal_poison_epochs=1,
        batch_size=256, test_batch_size=2048)))
    assert profile_round.main(["--params", str(cfg), "--device",
                               "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["device"] == "cpu" and rep["device_busy_s"] is None
    for k in ("train_s", "aggregate_s", "local_evals_s", "global_evals_s"):
        assert rep["timed"][k] > 0, k
    assert rep["timed"]["active_steps"] > 0
    assert rep["timed"]["fused_launches"] == 0     # no kernel on the CPU
