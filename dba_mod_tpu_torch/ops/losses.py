"""Loss and norm functions used by the client step and evaluation (port of
dba_mod_tpu/ops/losses.py).

Reference semantics preserved:
- per-batch cross entropy is the MEAN over the batch (torch F.cross_entropy
  default, image_train.py:85); with padded batches we mean over valid
  entries;
- distance/global norms run over trainable parameters only — torch
  named_parameters excludes BN running stats but includes BN affine γ/β
  (helper.py:59-71, :110-123).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

Tree = Mapping[str, torch.Tensor]


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy over valid entries of the batch (the last axis of
    `labels`; a leading client axis, as the grouped client step passes,
    gives one mean per client). `logits` may already be log-probabilities
    (log_softmax is idempotent — MnistNet.py:31)."""
    nll = _nll(logits, labels)
    if mask is None:
        return torch.mean(nll, dim=-1)
    maskf = mask.to(nll.dtype)
    denom = torch.clamp_min(torch.sum(maskf, dim=-1), 1.0)
    return torch.sum(nll * maskf, dim=-1) / denom


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Summed cross entropy (reduction='sum'), used by the evaluation
    battery (test.py:21-22)."""
    nll = _nll(logits, labels)
    if mask is not None:
        nll = nll * mask.to(nll.dtype)
    return torch.sum(nll)


def _sq_sum(tree) -> torch.Tensor:
    acc = None
    for leaf in tree:
        s = torch.sum(torch.square(leaf))
        acc = s if acc is None else acc + s
    return acc


def tree_dist_norm(params: Tree, target_params: Tree) -> torch.Tensor:
    """‖w - w_target‖₂ over a params dict (helper.py:110-123), gradient-safe
    at zero distance: on a client's first step w == w_anchor and d√x/dx|₀ =
    ∞ would turn the blended loss's (1-α)·dist term into NaN; the
    double-where keeps the gradient exactly 0 there."""
    sq = _sq_sum(params[k] - target_params[k] for k in params)
    safe = torch.where(sq > 0.0, sq, torch.ones_like(sq))
    return torch.where(sq > 0.0, torch.sqrt(safe), torch.zeros_like(sq))


def tree_global_norm(params: Tree) -> torch.Tensor:
    """‖w‖₂ over a params dict (helper.py:59-64)."""
    return torch.sqrt(_sq_sum(params.values()))
