"""Server aggregation over stacked client updates (port of
dba_mod_tpu/ops/aggregation.py:99-126, FedAvg only; the robust rules are
ROADMAP A12).

FedAvg (`average_shrink_models`, helper.py:240-257): global += η/no_models ·
Σ_c Δ_c, applied to EVERY state entry (weights and BN stats alike), with
optional DP Gaussian noise (helper.py:186-191, :253-254). The divisor is the
static `no_models`, not Σ samples — unweighted, kept for parity.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

Tree = Mapping[str, torch.Tensor]


def dp_noise_like(gen: torch.Generator, tree: Tree,
                  sigma: float) -> Dict[str, torch.Tensor]:
    """Gaussian DP noise per state entry (helper.py:186-191), drawn from an
    explicit generator on the tree's device."""
    return {k: torch.randn(v.shape, generator=gen, dtype=torch.float32,
                           device=v.device) * sigma
            for k, v in tree.items()}


def fedavg_update(global_state: Tree, stacked_deltas: Tree, eta: float,
                  no_models: int, dp_sigma: float = 0.0,
                  noise: Optional[Tree] = None,
                  gen: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """`global_state`: one flat dict of the full state (params + BN stats);
    `stacked_deltas`: the same keys with a leading clients axis. DP noise,
    when `dp_sigma` is set, is `noise` if given (tests pass the JAX
    package's draw in) or drawn from `gen`."""
    scale = eta / no_models
    new_state = {k: g + scale * torch.sum(stacked_deltas[k], dim=0)
                 for k, g in global_state.items()}
    if dp_sigma:
        if noise is None:
            if gen is None:
                raise ValueError("fedavg_update: DP noise needs `noise` or "
                                 "a generator")
            noise = dp_noise_like(gen, new_state, dp_sigma)
        new_state = {k: s + noise[k] for k, s in new_state.items()}
    return new_state
