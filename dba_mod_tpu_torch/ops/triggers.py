"""Backdoor trigger machinery as batched torch ops (port of
dba_mod_tpu/ops/triggers.py).

- a *pattern bank*: [trigger_num + 1, H, W] {0,1} masks built once on the
  host, where row `i` is adversary i's sub-pattern and the LAST row is the
  combined (global) pattern used by `adv_index == -1`
  (image_helper.py:331-335); stamping is `img·(1-mask) + mask` broadcast
  over channels — trigger pixels are set to 1.0 in every channel
  (image_helper.py:336-348);
- a *feature-trigger bank* for LOAN: [trigger_num + 1, F] value rows plus
  {0,1} masks over feature columns, the last row again the combined trigger
  (loan_train.py:49-57); stamping is a select per column;
- batch poisoning as a per-sample boolean: training poisons the first
  `poisoning_per_batch` samples of each batch, evaluation poisons all
  (image_helper.py:306-319).

Images are NHWC. Every selector may be a per-client [C] tensor against
[C, B, H, W, ch] images ([C, B, F] rows), so one call stamps all clients'
batches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dba_mod_tpu_torch import config as cfg


def build_pixel_pattern_bank(params: cfg.Params, height: int,
                             width: int) -> np.ndarray:
    """[trigger_num + 1, H, W] float32 {0,1} masks; the last row is the
    union of all sub-patterns (the global/combined trigger)."""
    n = int(params["trigger_num"])
    bank = np.zeros((n + 1, height, width), np.float32)
    for i in range(n):
        for (r, c) in params.poison_pattern_for(i):
            bank[i, r, c] = 1.0
            bank[n, r, c] = 1.0
    return bank


def build_feature_trigger_bank(params: cfg.Params, feature_dict: dict,
                               num_features: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """LOAN: ([trigger_num + 1, F] values, [trigger_num + 1, F] {0,1}
    masks); the last row is every adversary's trigger together
    (loan_train.py:49-57). Later values win on overlap, as the reference's
    sequential assignment does."""
    n = int(params["trigger_num"])
    values = np.zeros((n + 1, num_features), np.float32)
    masks = np.zeros((n + 1, num_features), np.float32)
    for i in range(n):
        names, vals = params.poison_trigger_features_for(i)
        for name, val in zip(names, vals):
            col = feature_dict[name]
            values[i, col] = val
            masks[i, col] = 1.0
            values[n, col] = val
            masks[n, col] = 1.0
    return values, masks


def bank_row(adv_index: torch.Tensor, bank_size: int) -> torch.Tensor:
    """Adversarial index → bank row: -1 → the last row (combined
    pattern)."""
    return torch.where(adv_index < 0, torch.full_like(adv_index,
                                                      bank_size - 1),
                       adv_index)


def stamp_pixel_pattern(images: torch.Tensor, pattern_bank: torch.Tensor,
                        adv_index: torch.Tensor) -> torch.Tensor:
    """images [..., B, H, W, ch]; adv_index scalar or [...] matching the
    leading dims. Trigger pixels set to 1.0 in all channels."""
    mask = pattern_bank[bank_row(adv_index, pattern_bank.shape[0]).long()]
    lead = adv_index.dim()
    # [..., H, W] → [..., 1, H, W, 1]: broadcast over batch and channels
    mask = mask.reshape(mask.shape[:lead] + (1,) + mask.shape[lead:] + (1,))
    return images * (1.0 - mask) + mask


def stamp_feature_trigger(rows: torch.Tensor, value_bank: torch.Tensor,
                          mask_bank: torch.Tensor,
                          adv_index: torch.Tensor) -> torch.Tensor:
    """LOAN: assign the trigger's feature values. rows [..., B, F];
    adv_index scalar or [...] matching the leading dims."""
    k = bank_row(adv_index, value_bank.shape[0]).long()
    lead = adv_index.dim()
    values = value_bank[k].reshape(
        k.shape + (1,) * (rows.dim() - 1 - lead) + value_bank.shape[1:])
    mask = mask_bank[k].reshape(values.shape)
    return rows * (1.0 - mask) + values * mask


def _poison_selection(labels, poisoning_per_batch, poison_all):
    """[..., B] bool: the first `poisoning_per_batch` samples of each batch,
    or every sample when `poison_all`."""
    batch = labels.shape[-1]
    lead = labels.dim() - 1
    if poison_all:
        return torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
    k = poisoning_per_batch.reshape(
        poisoning_per_batch.shape + (1,) * (lead + 1 -
                                            poisoning_per_batch.dim()))
    return (torch.arange(batch, device=labels.device) < k).expand(
        labels.shape)


def poison_batch(images: torch.Tensor, labels: torch.Tensor,
                 pattern_bank: torch.Tensor, adv_index: torch.Tensor,
                 poison_label_swap: int, poisoning_per_batch: torch.Tensor,
                 poison_all: bool = False):
    """Poison batches the reference way (image_helper.py:298-326): the first
    `poisoning_per_batch` samples of each batch (all of them if
    `poison_all`, the evaluation mode) get the trigger stamped and their
    label set to `poison_label_swap`. images [..., B, H, W, ch], labels
    [..., B]; adv_index / poisoning_per_batch scalars or [...] tensors.
    Returns (images, labels, per-sample poisoned mask [..., B])."""
    sel = _poison_selection(labels, poisoning_per_batch, poison_all)
    stamped = stamp_pixel_pattern(images, pattern_bank, adv_index)
    sel_img = sel.reshape(sel.shape + (1,) * (images.dim() - sel.dim()))
    new_images = torch.where(sel_img, stamped, images)
    new_labels = torch.where(sel, torch.full_like(labels, poison_label_swap),
                             labels)
    return new_images, new_labels, sel


def poison_batch_features(rows: torch.Tensor, labels: torch.Tensor,
                          value_bank: torch.Tensor, mask_bank: torch.Tensor,
                          adv_index: torch.Tensor, poison_label_swap: int,
                          poisoning_per_batch: torch.Tensor,
                          poison_all: bool = False):
    """LOAN counterpart of :func:`poison_batch` (loan_train.py:99-107):
    rows [..., B, F], labels [..., B]. LOAN's poisoned eval stamps every
    sample, with no target-class filtering (test.py:75-81)."""
    sel = _poison_selection(labels, poisoning_per_batch, poison_all)
    stamped = stamp_feature_trigger(rows, value_bank, mask_bank, adv_index)
    new_rows = torch.where(sel.unsqueeze(-1), stamped, rows)
    new_labels = torch.where(sel, torch.full_like(labels, poison_label_swap),
                             labels)
    return new_rows, new_labels, sel
