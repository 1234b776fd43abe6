"""Dataset ingestion: raw files when present, deterministic synthetic fallback.

Port of dba_mod_tpu/data/datasets.py, trimmed to the image workloads this
slice runs (MNIST, CIFAR-10); the synthetic set consumes the numpy RNG
exactly as the JAX package does, so both make the same data from one seed.


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

import dataclasses
import gzip
import pickle
import struct
from pathlib import Path
from typing import List, Optional

import numpy as np

from dba_mod_tpu_torch import config as cfg


@dataclasses.dataclass
class ImageData:
    """Host-side image classification data. Images uint8 NHWC in [0,255]."""
    train_images: np.ndarray
    train_labels: np.ndarray
    test_images: np.ndarray
    test_labels: np.ndarray
    num_classes: int
    synthetic: bool = False


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


# ------------------------------------------------------------------ synthetic
_IMAGE_SHAPES = {cfg.TYPE_MNIST: (28, 28, 1, 10),
                 cfg.TYPE_CIFAR: (32, 32, 3, 10),
                 cfg.TYPE_TINYIMAGENET: (64, 64, 3, 200)}


def synthetic_image_dataset(dtype: str, train_size: int = 0,
                            test_size: int = 0, seed: int = 0,
                            noise_std: float = 25.0) -> ImageData:
    """Deterministic learnable stand-in: per-class low-frequency template +
    noise, labels balanced. Sized like the real dataset unless overridden.

    `noise_std` (config key `synthetic_noise_std`) sets the task's
    difficulty: 25 → models saturate at ~100% (handy for fast smoke runs);
    ~90 → a ResNet plateaus below saturation with nonzero loss, emulating
    the real-data converged regime (nonzero gradients at the plateau — the
    regime the reference resumes its attacks from; fully-saturated models
    make FoolsGold's gradient similarities rounding noise and turn
    post-attack recovery into a cliff)."""
    h, w, c, ncls = _IMAGE_SHAPES[dtype]
    defaults = {cfg.TYPE_MNIST: (60000, 10000), cfg.TYPE_CIFAR: (50000, 10000),
                cfg.TYPE_TINYIMAGENET: (100000, 10000)}
    n_train = train_size or defaults[dtype][0]
    n_test = test_size or defaults[dtype][1]
    rng = np.random.RandomState(seed)
    templates = rng.randint(40, 216, size=(ncls, h, w, c)).astype(np.float32)

    def make(n, rng):
        labels = rng.randint(0, ncls, size=n).astype(np.int32)
        noise = rng.randn(n, h, w, c).astype(np.float32) * float(noise_std)
        imgs = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
        return imgs, labels

    train_x, train_y = make(n_train, rng)
    test_x, test_y = make(n_test, np.random.RandomState(seed + 1))
    return ImageData(train_x, train_y, test_x, test_y, ncls, synthetic=True)


# ------------------------------------------------------------------ dispatch
def load_image_dataset(params: cfg.Params) -> ImageData:
    """MNIST / CIFAR-10 from raw files under data_dir, else the synthetic
    stand-in (Tiny-ImageNet is ROADMAP A11; config.check_ported rejects
    it before data loading)."""
    t = params.type
    data = None
    if not params.get("synthetic_data", False):
        loader = {cfg.TYPE_MNIST: load_mnist, cfg.TYPE_CIFAR: load_cifar10}[t]
        data = loader(params.get("data_dir", "./data"))
    if data is None:
        data = synthetic_image_dataset(
            t, train_size=int(params.get("synthetic_train_size", 0) or 0),
            test_size=int(params.get("synthetic_test_size", 0) or 0),
            seed=int(params.get("random_seed", 1)),
            noise_std=float(params.get("synthetic_noise_std", 25.0)))
    return data
