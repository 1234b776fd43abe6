"""The benchmark's inputs: the image sets and the starting model.

Images: class templates at a quarter of the image's side, upsampled to it,
plus Gaussian noise, clipped to uint8, drawn on the device in large calls
from the configuration's data seed. The labels are a fixed balanced
assignment (sample i has class i mod classes), so the Dirichlet partition,
and with it every round's amount of work, is the same in every run. The sets
are written once per checkout, in the format the port's own loader reads
(CIFAR-10's pickled batches, or Tiny-ImageNet's ``tiny-imagenet-200.npz``),
into a fixed directory inside the checkout that later runs reuse.

Starting model: drawn on the device from ``--seed`` in one call, each weight
uniform in +-1/sqrt(fan_in) (torch's default bound), BatchNorm at scale 1,
shift 0, running mean 0 and variance 1, and saved as the named checkpoint
the configuration resumes from.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
from pathlib import Path

import numpy as np
import torch

from perfbench.reference import state_shapes


def labels(n: int, classes: int) -> np.ndarray:
    return (np.arange(n) % classes).astype(np.int64)


def _images(n: int, templates: torch.Tensor, noise: float,
            gen: torch.Generator, classes: int) -> torch.Tensor:
    """[n, H, W, C] uint8 on the templates' device, in chunks of rows."""
    dev = templates.device
    h, w, c = templates.shape[1:]
    out = torch.empty((n, h, w, c), dtype=torch.uint8, device=dev)
    y = torch.from_numpy(labels(n, classes)).to(dev)
    step = max(1, (1 << 26) // (h * w * c))
    for a in range(0, n, step):
        b = min(n, a + step)
        z = torch.randn((b - a, h, w, c), generator=gen, device=dev)
        out[a:b] = (templates[y[a:b]] + noise * z).clamp_(0, 255).to(
            torch.uint8)
    return out


def make_images(ds: dict, device: torch.device):
    """(train_x, train_y, test_x, test_y) as numpy, drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(int(ds["data_seed"]))
    k, hw, classes = int(ds["channels"]), int(ds["image_size"]), int(
        ds["classes"])
    low = torch.randint(40, 216, (classes, k, hw // 4, hw // 4),
                        generator=gen, device=device).float()
    templates = torch.nn.functional.interpolate(
        low, size=(hw, hw), mode="nearest").permute(0, 2, 3, 1).contiguous()
    noise = float(ds["noise_std"])
    tr = _images(int(ds["train_size"]), templates, noise, gen, classes)
    te = _images(int(ds["test_size"]), templates, noise, gen, classes)
    return (tr.cpu().numpy(), labels(int(ds["train_size"]), classes),
            te.cpu().numpy(), labels(int(ds["test_size"]), classes))


def cache_dir(root: Path, ds: dict) -> Path:
    key = hashlib.sha256(json.dumps(ds, sort_keys=True).encode()
                         ).hexdigest()[:16]
    return root / f"{ds['format']}_{key}"


def ensure_images(root: Path, ds: dict, device: torch.device) -> Path:
    """The data directory the port reads (``data_dir``), written once."""
    out = cache_dir(root, ds)
    if (out / "done").exists():
        return out
    tmp = out.with_name(out.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    tr_x, tr_y, te_x, te_y = make_images(ds, device)
    if ds["format"] == "cifar10":
        d = tmp / "cifar-10-batches-py"
        d.mkdir()

        def dump(name, x, y):
            flat = np.ascontiguousarray(x.transpose(0, 3, 1, 2)).reshape(
                len(x), -1)
            with open(d / name, "wb") as f:
                pickle.dump({b"data": flat, b"labels": [int(v) for v in y]},
                            f, protocol=4)
        per = -(-len(tr_x) // 5)
        for i in range(5):
            dump(f"data_batch_{i + 1}", tr_x[i * per:(i + 1) * per],
                 tr_y[i * per:(i + 1) * per])
        dump("test_batch", te_x, te_y)
    elif ds["format"] == "tiny_npz":
        np.savez(tmp / "tiny-imagenet-200.npz", train_x=tr_x, train_y=tr_y,
                 test_x=te_x, test_y=te_y)
    else:
        raise ValueError(f"unknown image format {ds['format']!r}")
    (tmp / "done").write_text("ok\n")
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    return out


def read_images(data_dir: Path, ds: dict):
    """The benchmark's own reader of the files it wrote: numpy
    (train_x NHWC uint8, train_y, test_x, test_y)."""
    if ds["format"] == "cifar10":
        d = data_dir / "cifar-10-batches-py"

        def load(name):
            with open(d / name, "rb") as f:
                z = pickle.load(f, encoding="bytes")
            x = z[b"data"].reshape(-1, 3, ds["image_size"], ds["image_size"])
            return x.transpose(0, 2, 3, 1), np.asarray(z[b"labels"], np.int64)
        parts = [load(f"data_batch_{i}") for i in range(1, 6)]
        te = load("test_batch")
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]), te[0], te[1])
    z = np.load(data_dir / "tiny-imagenet-200.npz")
    return z["train_x"], z["train_y"], z["test_x"], z["test_y"]


def make_weights(arch: dict, seed: int, device: torch.device) -> tuple:
    """(params, BN stats) on `device` from `seed`: one uniform draw split
    over the weights."""
    shapes, stats, fan = state_shapes(arch)
    drawn = [k for k in shapes if k in fan]
    total = sum(int(np.prod(shapes[k])) for k in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((total,), generator=gen, device=device) * 2.0 - 1.0
    params, at = {}, 0
    for k, shape in shapes.items():
        if k in fan:
            n = int(np.prod(shape))
            params[k] = (u[at:at + n].reshape(shape)
                         / float(np.sqrt(fan[k]))).contiguous()
            at += n
        elif k.endswith(".weight"):
            params[k] = torch.ones(shape, device=device)
        else:
            params[k] = torch.zeros(shape, device=device)
    bn = {k: (torch.ones(s, device=device) if k.endswith("running_var")
              else torch.zeros(s, device=device)) for k, s in stats.items()}
    return params, bn


def write_checkpoint(path: Path, model: tuple, epoch: int, lr: float) -> None:
    """The snapshot a named resume reads: ``<path>/state.pt``."""
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"params": {k: v.cpu() for k, v in model[0].items()},
                "batch_stats": {k: v.cpu() for k, v in model[1].items()},
                "epoch": int(epoch), "lr": float(lr)}, path / "state.pt")
