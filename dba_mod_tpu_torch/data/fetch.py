"""Dataset preflight: exact upstream URLs, sha256 checksums, and the
honest synthetic-fallback story (`python -m dba_mod_tpu_torch.main fetch`;
the port's own copy of dba_mod_tpu/data/fetch.py).

The reference downloads implicitly through torchvision at first use
(image_helper.py:186-219) — in an air-gapped or quota'd deployment that
turns the first training run into a surprise network job, and a truncated
download into silent garbage. This module makes ingestion explicit:

- every dataset's upstream artifacts are pinned here — URL + sha256 where
  upstream bytes are stable (MNIST idx archives, the CIFAR-10 python
  tarball); artifacts upstream does not publish a digest for
  (Tiny-ImageNet's zip) are verified by size and their computed sha256 is
  printed so a deployment can pin it;
- ``fetch`` downloads what is missing, verifies, and extracts into the
  exact on-disk layout `data/datasets.py` loads (MNIST gz files are read
  in place; CIFAR extracts to ``cifar-10-batches-py/``; Tiny-ImageNet
  extracts then still needs the documented ``tiny-etl`` + ``cache-tiny``
  passes); LOAN has no anonymous upstream (Kaggle auth) and is documented
  as a manual step through the existing ``loan-etl``;
- ``--check-only`` does the same audit with zero network, exits nonzero
  when anything is absent, and prints exactly what a training run will do
  instead: fall back to the deterministic synthetic stand-in
  (datasets.py) — never an error, but never silent either.
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys
import tarfile
import zipfile
from pathlib import Path
from typing import Callable, List, Optional

# statuses a dataset can preflight to
READY = "ready"          # loader-ready files on disk (verified when pinned)
ARCHIVE = "archive"      # verified archive present, extraction/ETL needed
MISSING = "missing"      # nothing usable on disk → synthetic fallback
CORRUPT = "corrupt"      # artifact present but fails its pinned checksum
MANUAL = "manual"        # no anonymous upstream; operator action required


@dataclasses.dataclass(frozen=True)
class RemoteFile:
    """One upstream artifact: where it lives, what its bytes hash to."""
    relpath: str                  # destination under data_dir
    url: Optional[str]            # None = manual acquisition
    sha256: Optional[str] = None  # None = upstream publishes no digest;
                                  # fetch prints the computed one to pin


# MNIST digests are the canonical published values for the four idx
# archives (mirrored by CVDF for programmatic access — yann.lecun.com now
# 403s unauthenticated clients); the CIFAR-10 digest is the published
# value for cifar-10-python.tar.gz from the Toronto origin.
_MNIST_BASE = "https://storage.googleapis.com/cvdf-datasets/mnist/"
_MNIST_FILES = [
    RemoteFile("MNIST/raw/train-images-idx3-ubyte.gz",
               _MNIST_BASE + "train-images-idx3-ubyte.gz",
               "440fcabf73cc546fa21475e81ea370265605f56be210a402"
               "4d2ca8f203523609"),
    RemoteFile("MNIST/raw/train-labels-idx1-ubyte.gz",
               _MNIST_BASE + "train-labels-idx1-ubyte.gz",
               "3552534a0a558bbed6aed32b30c495cca23d567ec52cac8b"
               "e1a0730e8010255c"),
    RemoteFile("MNIST/raw/t10k-images-idx3-ubyte.gz",
               _MNIST_BASE + "t10k-images-idx3-ubyte.gz",
               "8d422c7b0a1c1c79245a5bcf07fe86e33eeafee792b84584"
               "aec276f5a2dbc4e6"),
    RemoteFile("MNIST/raw/t10k-labels-idx1-ubyte.gz",
               _MNIST_BASE + "t10k-labels-idx1-ubyte.gz",
               "f7ae60f92e00ec6debd23a6088c31dbd2371eca3ffa0defa"
               "efb259924204aec6"),
]
_CIFAR_FILES = [
    RemoteFile("cifar-10-python.tar.gz",
               "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
               "6d958be074577803d12ecdefd02955f39262c83c16fe9348"
               "329d7fe0b5c001ce"),
]
_TINY_FILES = [
    # Stanford publishes no digest for the zip; fetch verifies a sane size
    # and prints the computed sha256 so deployments can pin it themselves.
    RemoteFile("tiny-imagenet-200.zip",
               "http://cs231n.stanford.edu/tiny-imagenet-200.zip", None),
]
_LOAN_FILES = [
    # Kaggle's lending-club dataset requires an authenticated session (the
    # reference shipped a Google-Drive copy, README.md:33-34) — manual:
    # download `accepted_2007_to_2018Q4.csv` (or the reference's
    # loan_data.csv), then run `python -m dba_mod_tpu_torch.main loan-etl
    # --input <csv>` to produce the per-state shards datasets.py loads.
    RemoteFile("loan/", None, None),
]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    files: List[RemoteFile]
    ready_probe: Callable[[Path], bool]   # loader-ready layout present?
    post_steps: str = ""                  # remaining ETL after download


def _mnist_ready(root: Path) -> bool:
    # same search paths as datasets.load_mnist (idx files, .gz accepted)
    names = ["train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"]
    dirs = [root, root / "MNIST" / "raw", root / "mnist"]
    return all(any((d / n).exists() or (d / (n + ".gz")).exists()
                   for d in dirs) for n in names)


def _cifar_ready(root: Path) -> bool:
    return (root / "cifar-10-batches-py" / "data_batch_1").exists()


def _tiny_ready(root: Path) -> bool:
    return ((root / "tiny-imagenet-200.npz").exists()
            or (root / "tiny-imagenet-200" / "train").exists())


def _loan_ready(root: Path) -> bool:
    return bool(list((root / "loan").glob("loan_*.csv")))


DATASETS = {
    "mnist": DatasetSpec("mnist", _MNIST_FILES, _mnist_ready),
    "cifar": DatasetSpec(
        "cifar", _CIFAR_FILES, _cifar_ready,
        post_steps="auto-extracted to cifar-10-batches-py/"),
    "tiny-imagenet-200": DatasetSpec(
        "tiny-imagenet-200", _TINY_FILES, _tiny_ready,
        post_steps="then: python -m dba_mod_tpu_torch.main tiny-etl && "
                   "python -m dba_mod_tpu_torch.main cache-tiny"),
    "loan": DatasetSpec(
        "loan", _LOAN_FILES, _loan_ready,
        post_steps="manual Kaggle download, then: python -m "
                   "dba_mod_tpu_torch.main loan-etl --input <raw csv>"),
}


def sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def check_dataset(name: str, data_dir: str | Path) -> "tuple[str, List[str]]":
    """Audit one dataset with zero network. Returns (status, detail lines):
    READY when the loader will find real data; ARCHIVE when a (verified)
    archive awaits extraction/ETL; CORRUPT when a pinned checksum fails;
    MANUAL for LOAN with nothing on disk; MISSING otherwise."""
    spec = DATASETS[name]
    root = Path(data_dir)
    details: List[str] = []
    if spec.ready_probe(root):
        return READY, [f"loader-ready files present under {root}"]
    status = MISSING
    for rf in spec.files:
        dst = root / rf.relpath
        if rf.url is None:
            details.append(f"{rf.relpath}: no anonymous upstream — "
                           f"{spec.post_steps}")
            status = MANUAL
            continue
        if not dst.exists():
            details.append(f"{rf.relpath}: absent (upstream: {rf.url})")
            continue
        if rf.sha256 is not None:
            got = sha256_file(dst)
            if got != rf.sha256:
                details.append(
                    f"{rf.relpath}: sha256 MISMATCH — expected "
                    f"{rf.sha256}, got {got} (truncated/tampered "
                    f"download; delete and re-fetch)")
                return CORRUPT, details
            details.append(f"{rf.relpath}: archive verified "
                           f"(sha256 {got[:12]}…)")
        else:
            details.append(
                f"{rf.relpath}: present, {dst.stat().st_size} bytes — "
                f"upstream publishes no digest; computed sha256 "
                f"{sha256_file(dst)} (pin it in your deploy config)")
        status = ARCHIVE
    return status, details


def _download(rf: RemoteFile, dst: Path) -> bool:
    """Stream one artifact; sha256-verify when pinned. Failure is reported
    and survivable — preflight continues to the fallback report."""
    import urllib.request
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(dst.suffix + ".fetch_tmp")
    try:
        print(f"  fetching {rf.url}")
        with urllib.request.urlopen(rf.url, timeout=60) as r, \
                open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        if rf.sha256 is not None:
            got = sha256_file(tmp)
            if got != rf.sha256:
                print(f"  sha256 mismatch for {dst.name}: expected "
                      f"{rf.sha256}, got {got} — discarding", file=sys.stderr)
                tmp.unlink(missing_ok=True)
                return False
            print(f"  verified sha256 {got[:12]}…")
        else:
            print(f"  downloaded; computed sha256 {sha256_file(tmp)} "
                  f"(upstream publishes none — pin this)")
        tmp.replace(dst)
        return True
    except Exception as exc:  # noqa: BLE001 — network failures must not
        print(f"  fetch failed: {exc!r}", file=sys.stderr)  # kill preflight
        tmp.unlink(missing_ok=True)
        return False


def _extract(name: str, data_dir: Path) -> None:
    """Unpack downloaded archives into the loader layout."""
    if name == "cifar":
        tar = data_dir / "cifar-10-python.tar.gz"
        if tar.exists() and not _cifar_ready(data_dir):
            print(f"  extracting {tar.name}")
            with tarfile.open(tar, "r:gz") as t:
                t.extractall(data_dir)  # noqa: S202 — pinned-sha archive
    elif name == "tiny-imagenet-200":
        z = data_dir / "tiny-imagenet-200.zip"
        if z.exists() and not (data_dir / "tiny-imagenet-200").exists():
            print(f"  extracting {z.name}")
            with zipfile.ZipFile(z) as f:
                f.extractall(data_dir)


_FALLBACK_NOTE = (
    "runs will use the DETERMINISTIC SYNTHETIC stand-in "
    "(data/datasets.py): same shapes/class counts, seeded by "
    "random_seed — every pipeline stage still runs, but accuracy "
    "curves are not the real dataset's")


def run_preflight(types: Optional[List[str]], data_dir: str,
                  check_only: bool = False) -> int:
    """The `fetch` subcommand body. Returns the process exit code: 0 when
    every requested dataset is loader-ready, 1 otherwise (preflight
    contract — CI gates on it)."""
    names = list(types) if types else list(DATASETS)
    root = Path(data_dir)
    all_ready = True
    for name in names:
        status, details = check_dataset(name, root)
        if status not in (READY,) and not check_only:
            spec = DATASETS[name]
            for rf in spec.files:
                if rf.url is None:
                    continue
                dst = root / rf.relpath
                if not dst.exists() or status == CORRUPT:
                    if status == CORRUPT:
                        dst.unlink(missing_ok=True)
                    _download(rf, dst)
            _extract(name, root)
            status, details = check_dataset(name, root)
        print(f"{name}: {status.upper()}")
        for d in details:
            print(f"  {d}")
        spec = DATASETS[name]
        if status == ARCHIVE and spec.post_steps:
            print(f"  next: {spec.post_steps}")
        if status != READY:
            all_ready = False
            print(f"  -> {_FALLBACK_NOTE}")
    return 0 if all_ready else 1
