"""Batch normalization with exact torch running-stat semantics, written as a
pure function (port of dba_mod_tpu/models/norm.py).

Train mode normalizes with the BIASED batch variance and updates the running
variance with the UNBIASED (n/(n-1)) one, as torch's nn.BatchNorm2d does;
momentum is in the flax convention ra = 0.9·ra + (1-0.9)·batch (flax 0.9 ≙
torch 0.1), eps 1e-5. The function returns the new running stats and mutates
no buffer, so it batches over the stacked client axis (torch.func.vmap).
Under bf16 compute the statistics and the normalization run in float32 on
the float32 cast of the input and the output is cast back to the input's
type, as the JAX package's BatchNorm does (dba_mod_tpu/models/norm.py:49-67);
a float64 input stays float64.
"""
from __future__ import annotations

from typing import Tuple

import torch

MOMENTUM = 0.9
EPSILON = 1e-5


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               ra_mean: torch.Tensor, ra_var: torch.Tensor, train: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [N, F, ...] (channels on dim 1). Returns (y in x's type,
    new_mean, new_var); in eval mode the running stats come back
    unchanged."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if train:
        dims = (0,) + tuple(range(2, x.dim()))
        n = x.numel() // x.shape[1]
        mean = torch.mean(xf, dim=dims)
        # biased variance normalizes the batch; clamp at 0 — E[x²]−E[x]²
        # can go slightly negative under f32 cancellation
        var = torch.clamp_min(
            torch.mean(torch.square(xf), dim=dims) - torch.square(mean), 0.0)
        bessel = n / max(n - 1, 1)
        m = MOMENTUM
        new_mean = m * ra_mean + (1.0 - m) * mean
        new_var = m * ra_var + (1.0 - m) * (var * bessel)
    else:
        mean, var = ra_mean, ra_var
        new_mean, new_var = ra_mean, ra_var
    y = ((xf - mean.reshape(shape)) * torch.rsqrt(var + EPSILON).reshape(shape)
         * scale.reshape(shape) + bias.reshape(shape))
    return y.to(x.dtype), new_mean, new_var
