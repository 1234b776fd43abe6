"""torch-SGD helpers and the poison MultiStepLR schedule (port of
dba_mod_tpu/ops/sgd.py).

The reference trains every client with ``torch.optim.SGD(lr, momentum,
weight_decay)`` created fresh each round (image_train.py:33-35, :63-65), so
momentum buffers start at zero within a round; the update itself is the
fused kernel (ops/fused_update.py), and ``sgd_step`` is FoolsGold's
server step. The schedule keeps torch's float-milestone quirk
(image_train.py:66-68); the LOAN schedule steps before the epoch's batches
and its poison LR adapts to the backdoor accuracy.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch


def sgd_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero momentum buffers shaped like `params`."""
    return {k: torch.zeros_like(v) for k, v in params.items()}


def sgd_step(params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor],
             momentum_buf: Mapping[str, torch.Tensor], lr: float,
             momentum: float, weight_decay: float
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One torch-SGD step (dba_mod_tpu/ops/sgd.py:36), functional: g + wd·p,
    μ·buf + g, p - lr·buf. Returns (new_params, new_momentum_buf). FoolsGold
    applies its aggregate through one such step with fresh (zero) buffers,
    so momentum is a no-op there but weight decay is not."""
    new_p, new_b = {}, {}
    for k, p in params.items():
        g = grads[k] + weight_decay * p
        b = momentum * momentum_buf[k] + g
        new_p[k] = p - lr * b
        new_b[k] = b
    return new_p, new_b


def _milestone_hits(milestones: Sequence[float]) -> list:
    """torch MultiStepLR keys milestones by the raw float; an integer epoch
    only matches a float milestone that is exactly integral (2 == 2.0).
    internal_poison_epochs=6 gives [1.2000000000000002, 4.800000000000001],
    which NEVER fire, while E=10 gives [2.0, 8.0], which do."""
    return [int(m) for m in milestones if float(m) == int(m)]


def multistep_lr_array(num_epochs: int, milestones: Sequence[float],
                       gamma: float = 0.1, step_before: bool = False
                       ) -> np.ndarray:
    """Per-internal-epoch LR multipliers (relative to base lr), length
    `num_epochs`, for 1-based internal epochs. step_before=False (image,
    image_train.py:118-119): epoch i uses gamma^|{m <= i-1}|;
    step_before=True (LOAN, loan_train.py:90-92): gamma^|{m <= i}|."""
    hits = _milestone_hits(milestones)
    out = np.empty((max(num_epochs, 1),), np.float32)
    for i in range(1, max(num_epochs, 1) + 1):
        bound = i if step_before else i - 1
        k = sum(1 for m in hits if m <= bound)
        out[i - 1] = gamma ** k
    return out


def poison_multistep_lr_array(internal_poison_epochs: int,
                              gamma: float = 0.1,
                              step_before: bool = False) -> np.ndarray:
    """The reference's poison schedule: milestones at {0.2, 0.8}·E
    (image_train.py:66-68, loan_train.py:83-85)."""
    e = internal_poison_epochs
    return multistep_lr_array(e, [0.2 * e, 0.8 * e], gamma, step_before)


def loan_adaptive_poison_lr(base_poison_lr: float, backdoor_acc: float,
                            baseline: bool) -> float:
    """LOAN poison-LR decay by the global model's current backdoor accuracy
    (loan_train.py:71-75): acc > 20 → lr/5, additionally acc > 60 → lr/10
    (cumulative /50); `baseline` keeps the base lr. float32 arithmetic, as
    the JAX package computes it."""
    lr = np.float32(base_poison_lr)
    if baseline:
        return float(lr)
    acc = np.float32(backdoor_acc)
    if acc > 20.0:
        lr = lr / np.float32(5.0)
    if acc > 60.0:
        lr = lr / np.float32(10.0)
    return float(lr)
