"""Parameter initializers matching torch defaults (port of
dba_mod_tpu/ops/initializers.py).

The reference models rely on two init regimes:

- torch's default ``nn.Conv2d``/``nn.Linear`` init: kaiming_uniform(a=sqrt(5))
  for the weight, which reduces to U(-1/sqrt(fan_in), 1/sqrt(fan_in)), and
  the same bound for the bias (MnistNet.py, resnet_cifar.py, loan_model.py);
- explicit kaiming_normal(fan_out, relu) for the convolutions of the
  Tiny-ImageNet ResNet-18 (resnet_tinyimagenet.py:158-163).

Draws come from an explicit ``torch.Generator``; they are not the JAX
package's draws (jax.random and torch give different streams from one seed)
— tests carry weights across with ``dba_mod_tpu_torch.convert`` instead.
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


def kaiming_normal_fan_out(shape: Sequence[int],
                           gen: torch.Generator) -> torch.Tensor:
    """N(0, sqrt(2/fan_out)) for a conv weight [out, in, kh, kw], fan_out =
    out·kh·kw: torch's kaiming_normal_(mode='fan_out', nonlinearity='relu'),
    the JAX package's variance_scaling(2.0, "fan_out", "normal")."""
    shape = tuple(shape)
    fan_out = shape[0]
    for k in shape[2:]:
        fan_out *= k
    std = (2.0 / fan_out) ** 0.5
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std
