"""Device-resident datasets and the fetch/stamp closures used by the client
step (port of dba_mod_tpu/fl/device_data.py).

The image train and test sets live on the device once, as uint8 NHWC, and
are scaled to [0, 1] at gather time (the reference's ToTensor()-only
pipeline, image_helper.py:178-201). The LOAN state shards are ragged: they
live on the device stacked to [states, max_n, F], and `slot` picks a row's
state; padded rows are never read, because the batch and eval plans index
real rows only (their masks cover the rest). A batch fetch is one index
gather: the host ships only the int32 batch plans.

Batches come out in the compute type (``compute_dtype``), as the JAX
package's do (dba_mod_tpu/fl/device_data.py:52-80): the images are divided
by 255 IN that type, and the LOAN arrays and the trigger banks are
stored in it. Under bf16 that rounds the inputs before the model sees
them — the JAX package's own behavior, kept as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.data.batching import stack_ragged
from dba_mod_tpu_torch.data.datasets import ImageData, LoanData
from dba_mod_tpu_torch.models import compute_dtype_of
from dba_mod_tpu_torch.ops import triggers

# fetch(slot, idx[..., B]) -> (x[..., B, H, W, ch] or [..., B, F] in the
#                              compute type, y[..., B] int64)
FetchFn = Callable[[torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor]]
# stamp(x, y, adv_index, k, poison_all) -> (x, y, poisoned_mask)
StampFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class DeviceData:
    fetch_train: FetchFn
    fetch_test: FetchFn
    stamp: StampFn
    num_train: int
    num_test: int
    device: torch.device
    compute_dtype: torch.dtype = torch.float32


def make_image_device_data(data: ImageData, params: cfg.Params,
                           device: torch.device) -> DeviceData:
    train_x = torch.from_numpy(np.ascontiguousarray(
        data.train_images)).to(device)                    # [N,H,W,ch] uint8
    train_y = torch.from_numpy(data.train_labels.astype(np.int64)).to(device)
    test_x = torch.from_numpy(np.ascontiguousarray(
        data.test_images)).to(device)
    test_y = torch.from_numpy(data.test_labels.astype(np.int64)).to(device)
    h, w = data.train_images.shape[1:3]
    dtype = compute_dtype_of(params)
    bank = torch.from_numpy(
        triggers.build_pixel_pattern_bank(params, h, w)).to(device, dtype)
    swap = int(params["poison_label_swap"])

    def fetch_train(slot, idx):
        idx = idx.long()
        return train_x[idx].to(dtype) / 255.0, train_y[idx]

    def fetch_test(slot, idx):
        idx = idx.long()
        return test_x[idx].to(dtype) / 255.0, test_y[idx]

    def stamp(x, y, adv_index, k, poison_all=False):
        return triggers.poison_batch(x, y, bank, adv_index, swap, k,
                                     poison_all)

    return DeviceData(fetch_train, fetch_test, stamp,
                      num_train=len(data.train_labels),
                      num_test=len(data.test_labels), device=device,
                      compute_dtype=dtype)


def make_loan_device_data(data: LoanData, params: cfg.Params,
                          device: torch.device) -> DeviceData:
    """LOAN: per-state shards stacked [S, max_n, F]; `slot` (a [C] or
    per-row tensor broadcast against idx) selects the state."""
    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    cdtype = compute_dtype_of(params)
    train_x = dev(stack_ragged(data.train_x), cdtype)
    train_y = dev(stack_ragged(data.train_y), torch.int64)
    test_x = dev(stack_ragged(data.test_x), cdtype)
    test_y = dev(stack_ragged(data.test_y), torch.int64)
    values, masks = triggers.build_feature_trigger_bank(
        params, data.feature_dict, train_x.shape[-1])
    values = dev(values, cdtype)
    masks = dev(masks, cdtype)
    swap = int(params["poison_label_swap"])

    def gather(x, y, slot, idx):
        slot = slot.long()
        slot = slot.reshape(slot.shape + (1,) * (idx.dim() - slot.dim()))
        idx = idx.long()
        return x[slot, idx], y[slot, idx]

    def fetch_train(slot, idx):
        return gather(train_x, train_y, slot, idx)

    def fetch_test(slot, idx):
        return gather(test_x, test_y, slot, idx)

    def stamp(x, y, adv_index, k, poison_all=False):
        return triggers.poison_batch_features(x, y, values, masks, adv_index,
                                              swap, k, poison_all)

    return DeviceData(fetch_train, fetch_test, stamp,
                      num_train=sum(len(y) for y in data.train_y),
                      num_test=sum(len(y) for y in data.test_y),
                      device=device, compute_dtype=cdtype)
