"""Parameter initializers matching torch defaults (port of
dba_mod_tpu/ops/initializers.py).

torch's default ``nn.Conv2d``/``nn.Linear`` init — kaiming_uniform(a=sqrt(5))
for the weight, which reduces to U(-1/sqrt(fan_in), 1/sqrt(fan_in)), and the
same bound for the bias — is the distribution of both reference models this
slice runs (MnistNet.py, resnet_cifar.py). Draws come from an explicit
``torch.Generator``; they are not the JAX package's draws (jax.random and
torch give different streams from one seed) — tests carry weights across
with ``dba_mod_tpu_torch.convert`` instead.
"""
from __future__ import annotations

from typing import Sequence

import torch


def torch_uniform(shape: Sequence[int], fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — the torch default weight AND
    bias bound, float32 on the generator's device."""
    bound = 1.0 / (fan_in ** 0.5) if fan_in > 0 else 0.0
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (u * 2.0 - 1.0) * bound
