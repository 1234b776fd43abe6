"""Backdoor trigger machinery as batched torch ops (port of
dba_mod_tpu/ops/triggers.py, pixel triggers).

- a *pattern bank*: [trigger_num + 1, H, W] {0,1} masks built once on the
  host, where row `i` is adversary i's sub-pattern and the LAST row is the
  combined (global) pattern used by `adv_index == -1`
  (image_helper.py:331-335); stamping is `img·(1-mask) + mask` broadcast
  over channels — trigger pixels are set to 1.0 in every channel
  (image_helper.py:336-348);
- batch poisoning as a per-sample boolean: training poisons the first
  `poisoning_per_batch` samples of each batch, evaluation poisons all
  (image_helper.py:306-319).

Images are NHWC. Every selector may be a per-client [C] tensor against
[C, B, H, W, ch] images, so one call stamps all clients' batches.
"""
from __future__ import annotations

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
    batch = labels.shape[-1]
    lead = labels.dim() - 1
    if poison_all:
        sel = torch.ones(labels.shape, dtype=torch.bool,
                         device=labels.device)
    else:
        k = poisoning_per_batch.reshape(
            poisoning_per_batch.shape + (1,) * (lead + 1 -
                                                poisoning_per_batch.dim()))
        sel = torch.arange(batch, device=labels.device) < k
        sel = sel.expand(labels.shape)
    stamped = stamp_pixel_pattern(images, pattern_bank, adv_index)
    sel_img = sel.reshape(sel.shape + (1,) * (images.dim() - sel.dim()))
    new_images = torch.where(sel_img, stamped, images)
    new_labels = torch.where(sel, torch.full_like(labels, poison_label_swap),
                             labels)
    return new_images, new_labels, sel
