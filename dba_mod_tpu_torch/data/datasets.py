"""Dataset ingestion: raw files when present, deterministic synthetic fallback.

Port of dba_mod_tpu/data/datasets.py (MNIST, CIFAR-10, Tiny-ImageNet and
the LOAN per-state shards); the synthetic sets consume the numpy RNG exactly
as the JAX package does, so both make the same data from one seed. The LOAN
CSV reader needs neither pandas nor sklearn: it reads with ``csv`` and
reproduces sklearn's ``train_test_split(test_size=0.2, random_state=42)``
with numpy.


The reference downloads via torchvision (image_helper.py:186-219) and reads
LOAN per-state CSVs produced by its ETL (loan_helper.py:111-132,
utils/loan_preprocess.py). This module reads the same on-disk artifacts
directly (idx/pickle/folder/CSV — no torch dependency in the data path) and,
when the files are absent, generates a *deterministic synthetic* stand-in with
the same shapes/class counts so every pipeline stage runs anywhere. Pixel
values match the reference's ToTensor() range [0,1] (no normalization —
image_helper.py:178-201); images are stored uint8 host-side and scaled on
device.
"""
from __future__ import annotations

import csv
import dataclasses
import gzip
import logging
import math
import pickle
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from dba_mod_tpu_torch import config as cfg

logger = logging.getLogger("dba_mod_tpu_torch")


@dataclasses.dataclass
class ImageData:
    """Host-side image classification data. Images uint8 NHWC in [0,255]."""
    train_images: np.ndarray
    train_labels: np.ndarray
    test_images: np.ndarray
    test_labels: np.ndarray
    num_classes: int
    synthetic: bool = False


@dataclasses.dataclass
class LoanData:
    """Host-side LOAN data: one shard per US state (natural non-IID clients,
    loan_helper.py:119-132). 80/20 train/test split per shard with
    sklearn(random_state=42) parity (loan_helper.py:172)."""
    state_names: List[str]
    train_x: List[np.ndarray]   # per state, [N_s, F] float32
    train_y: List[np.ndarray]
    test_x: List[np.ndarray]
    test_y: List[np.ndarray]
    feature_names: List[str]
    num_classes: int = 9
    synthetic: bool = False

    @property
    def feature_dict(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.feature_names)}


# ---------------------------------------------------------------------- MNIST
def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find(dirs: List[Path], names: List[str]) -> Optional[Path]:
    for d in dirs:
        for n in names:
            for cand in (d / n, d / (n + ".gz")):
                if cand.exists():
                    return cand
    return None


def load_mnist(data_dir: str) -> Optional[ImageData]:
    root = Path(data_dir)
    dirs = [root, root / "MNIST" / "raw", root / "mnist"]
    files = {
        "train_x": ["train-images-idx3-ubyte"],
        "train_y": ["train-labels-idx1-ubyte"],
        "test_x": ["t10k-images-idx3-ubyte"],
        "test_y": ["t10k-labels-idx1-ubyte"],
    }
    paths = {k: _find(dirs, v) for k, v in files.items()}
    if any(p is None for p in paths.values()):
        return None
    return ImageData(
        train_images=_read_idx(paths["train_x"])[..., None],
        train_labels=_read_idx(paths["train_y"]).astype(np.int32),
        test_images=_read_idx(paths["test_x"])[..., None],
        test_labels=_read_idx(paths["test_y"]).astype(np.int32),
        num_classes=10)


# --------------------------------------------------------------------- CIFAR10
def load_cifar10(data_dir: str) -> Optional[ImageData]:
    root = Path(data_dir) / "cifar-10-batches-py"
    if not root.exists():
        return None

    def read_batch(name):
        with open(root / name, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return imgs, np.array(d[b"labels"], np.int32)

    xs, ys = zip(*[read_batch(f"data_batch_{i}") for i in range(1, 6)])
    test_x, test_y = read_batch("test_batch")
    return ImageData(np.concatenate(xs), np.concatenate(ys), test_x, test_y,
                     num_classes=10)


# -------------------------------------------------------------- Tiny-ImageNet
def load_tiny_imagenet(data_dir: str) -> Optional[ImageData]:
    """Reads a prebuilt `tiny-imagenet-200.npz` cache (numpy only), or the
    post-ETL folders (train/<wnid>/images/*.JPEG + reformatted val/<wnid>/*)
    where PIL imports. None when neither is there."""
    root = Path(data_dir) / "tiny-imagenet-200"
    npz = root.with_suffix(".npz")
    if npz.exists():
        z = np.load(npz)
        return ImageData(z["train_x"], z["train_y"].astype(np.int32),
                         z["test_x"], z["test_y"].astype(np.int32), 200)
    if not (root / "train").exists():
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    wnids = sorted(p.name for p in (root / "train").iterdir() if p.is_dir())
    cls = {w: i for i, w in enumerate(wnids)}

    def read_split(split_dir: Path):
        xs, ys = [], []
        for wnid_dir in sorted(split_dir.iterdir()):
            if not wnid_dir.is_dir() or wnid_dir.name not in cls:
                continue
            img_dir = (wnid_dir / "images" if (wnid_dir / "images").exists()
                       else wnid_dir)
            for img_path in sorted(img_dir.glob("*.JPEG")):
                xs.append(np.asarray(Image.open(img_path).convert("RGB"),
                                     np.uint8))
                ys.append(cls[wnid_dir.name])
        return np.stack(xs), np.array(ys, np.int32)

    train_x, train_y = read_split(root / "train")
    test_x, test_y = read_split(root / "val")
    return ImageData(train_x, train_y, test_x, test_y, 200)


# ------------------------------------------------------------------ synthetic
_IMAGE_SHAPES = {cfg.TYPE_MNIST: (28, 28, 1, 10),
                 cfg.TYPE_CIFAR: (32, 32, 3, 10),
                 cfg.TYPE_TINYIMAGENET: (64, 64, 3, 200)}
_CHUNK_VALUES = 1 << 22   # noise values drawn per chunk (16 MB of float32)


def synthetic_image_dataset(dtype: str, train_size: int = 0,
                            test_size: int = 0, seed: int = 0,
                            noise_std: float = 25.0) -> ImageData:
    """Deterministic learnable stand-in: per-class low-frequency template +
    noise, labels balanced. Sized like the real dataset unless overridden.

    `noise_std` (config key `synthetic_noise_std`) sets the task's
    difficulty: 25 → models saturate at ~100% (handy for fast smoke runs);
    ~90 → a ResNet plateaus below saturation with nonzero loss, emulating
    the real-data converged regime.

    The noise is drawn and applied a chunk of rows at a time: the legacy
    numpy stream is sequential, so the bytes are the JAX package's, while
    the full Tiny-ImageNet set peaks at its own 1.2 GB instead of the ~25
    GB of whole-array float64 noise."""
    h, w, c, ncls = _IMAGE_SHAPES[dtype]
    defaults = {cfg.TYPE_MNIST: (60000, 10000), cfg.TYPE_CIFAR: (50000, 10000),
                cfg.TYPE_TINYIMAGENET: (100000, 10000)}
    n_train = train_size or defaults[dtype][0]
    n_test = test_size or defaults[dtype][1]
    rng = np.random.RandomState(seed)
    templates = rng.randint(40, 216, size=(ncls, h, w, c)).astype(np.float32)
    rows = max(1, _CHUNK_VALUES // (h * w * c))

    def make(n, rng):
        labels = rng.randint(0, ncls, size=n).astype(np.int32)
        imgs = np.empty((n, h, w, c), np.uint8)
        for a in range(0, n, rows):
            b = min(n, a + rows)
            noise = (rng.randn(b - a, h, w, c).astype(np.float32)
                     * float(noise_std))
            imgs[a:b] = np.clip(templates[labels[a:b]] + noise, 0,
                                255).astype(np.uint8)
        return imgs, labels

    train_x, train_y = make(n_train, rng)
    test_x, test_y = make(n_test, np.random.RandomState(seed + 1))
    return ImageData(train_x, train_y, test_x, test_y, ncls, synthetic=True)


_US_STATES = ["AK", "AL", "AR", "AZ", "CA", "CO", "CT", "DC", "DE", "FL", "GA",
              "HI", "IA", "ID", "IL", "IN", "KS", "KY", "LA", "MA", "MD", "ME",
              "MI", "MN", "MO", "MS", "MT", "NC", "ND", "NE", "NH", "NJ", "NM",
              "NV", "NY", "OH", "OK", "OR", "PA", "RI", "SC", "SD", "TN", "TX",
              "UT", "VA", "VT", "WA", "WI", "WV", "WY"]

# Feature names used by the reference LOAN trigger configs
# (utils/loan_params.yaml:31-36) must exist in the synthetic schema.
_LOAN_TRIGGER_FEATURES = ["num_tl_120dpd_2m", "num_tl_90g_dpd_24m",
                          "pub_rec_bankruptcies", "pub_rec", "acc_now_delinq",
                          "tax_liens", "out_prncp", "total_pymnt_inv",
                          "out_prncp_inv", "total_rec_prncp",
                          "last_pymnt_amnt", "all_util"]


def synthetic_loan_dataset(num_states: int = 51, num_features: int = 91,
                           rows_per_state: int = 800,
                           seed: int = 0) -> LoanData:
    """Synthetic LOAN: 9-class labels correlated with features through a
    fixed random linear map, per-state row counts varied deterministically
    (800-1,199 rows per state, the first 80% of each for training)."""
    feature_names = list(_LOAN_TRIGGER_FEATURES)
    feature_names += [f"feat_{i}" for i in range(num_features
                                                 - len(feature_names))]
    rng = np.random.RandomState(seed)
    proj = rng.randn(num_features, 9).astype(np.float32)
    names, tx, ty, sx, sy = [], [], [], [], []
    for s in range(num_states):
        n = rows_per_state + (s * 37) % 400
        x = rng.randn(n, num_features).astype(np.float32)
        logits = x @ proj + rng.randn(n, 9).astype(np.float32)
        y = np.argmax(logits, axis=1).astype(np.int32)
        k = max(1, int(0.8 * n))
        names.append(_US_STATES[s % len(_US_STATES)])
        tx.append(x[:k])
        ty.append(y[:k])
        sx.append(x[k:])
        sy.append(y[k:])
    return LoanData(names, tx, ty, sx, sy, feature_names, synthetic=True)


def split_80_20(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train rows, test rows) of sklearn's train_test_split(test_size=0.2,
    random_state=42) over n rows: its ShuffleSplit takes the first
    ceil(0.2·n) entries of RandomState(42).permutation(n) as the test set
    and the rest, in permutation order, as the train set."""
    perm = np.random.RandomState(42).permutation(n)
    n_test = int(math.ceil(0.2 * n))
    return perm[n_test:], perm[:n_test]


def _read_loan_csv(path: Path) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(feature names, x [N, F] float32, y [N] int32) of one state's CSV:
    every column but `loan_status` is a feature; empty cells are NaN."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cells = np.array([[float(v) if v != "" else np.nan for v in row]
                          for row in reader if row], np.float64)
    cells = cells.reshape(-1, len(header))
    label = header.index("loan_status")
    cols = [i for i in range(len(header)) if i != label]
    return ([header[i] for i in cols], cells[:, cols].astype(np.float32),
            cells[:, label].astype(np.int32))


def load_loan_csvs(data_dir: str) -> Optional[LoanData]:
    """Per-state CSVs from the LOAN ETL (utils/loan_preprocess.py:49-56;
    files named loan_<STATE>.csv with a `loan_status` label column), each
    split 80/20 as LoanDataset does (loan_helper.py:172). None when there
    are none."""
    root = Path(data_dir) / "loan"
    files = sorted(root.glob("loan_*.csv")) if root.exists() else []
    if not files:
        return None
    names, tx, ty, sx, sy, feature_names = [], [], [], [], [], None
    for f in files:
        cols, x, y = _read_loan_csv(f)
        if feature_names is None:
            feature_names = cols
        train, test = split_80_20(len(y))
        names.append(f.stem[5:7])
        tx.append(x[train])
        ty.append(y[train])
        sx.append(x[test])
        sy.append(y[test])
    return LoanData(names, tx, ty, sx, sy, feature_names)


# ------------------------------------------------------------------ dispatch
def load_image_dataset(params: cfg.Params) -> ImageData:
    """MNIST / CIFAR-10 / Tiny-ImageNet from the files under data_dir, else
    the synthetic stand-in. Logs which it used."""
    t = params.type
    data = None
    if not params.get("synthetic_data", False):
        loader = {cfg.TYPE_MNIST: load_mnist, cfg.TYPE_CIFAR: load_cifar10,
                  cfg.TYPE_TINYIMAGENET: load_tiny_imagenet}[t]
        data = loader(params.get("data_dir", "./data"))
    if data is None:
        data = synthetic_image_dataset(
            t, train_size=int(params.get("synthetic_train_size", 0) or 0),
            test_size=int(params.get("synthetic_test_size", 0) or 0),
            seed=int(params.get("random_seed", 1)),
            noise_std=float(params.get("synthetic_noise_std", 25.0)))
    logger.info("data: %s %s, %d train / %d test images", t,
                "synthetic stand-in" if data.synthetic
                else f"from {params.get('data_dir', './data')}",
                len(data.train_labels), len(data.test_labels))
    return data


def load_loan_dataset(params: cfg.Params) -> LoanData:
    """The LOAN state CSVs under data_dir/loan, else the synthetic stand-in
    (at least 51 states). Logs which it used."""
    data = None
    if not params.get("synthetic_data", False):
        data = load_loan_csvs(params.get("data_dir", "./data"))
    if data is None:
        data = synthetic_loan_dataset(
            num_states=max(51, int(params["number_of_total_participants"])),
            seed=int(params.get("random_seed", 1)))
    logger.info("data: loan %s, %d states, %d train / %d test rows",
                "synthetic stand-in" if data.synthetic
                else f"from {params.get('data_dir', './data')}/loan",
                len(data.state_names), sum(len(y) for y in data.train_y),
                sum(len(y) for y in data.test_y))
    return data
