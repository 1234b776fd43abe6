"""LeNet-style MNIST classifier as a pure function of a parameter dict (port
of dba_mod_tpu/models/mnist.py).

conv(1→20, 5×5, valid) → relu → maxpool2 → conv(20→50, 5×5, valid) → relu →
maxpool2 → fc(800→500) → relu → fc(500→10) → log_softmax (reference
models/MnistNet.py:7-33). Inputs are NHWC like the JAX package's; the
activations are flattened in NHWC order too, so ``fc1.weight`` is the flax
``Dense_0`` kernel transposed, with no permutation.

`dtype` is the compute type: the input and each layer's weight and bias are
cast to it, as flax's ``dtype=`` does with float32 params, and the
log_softmax head runs over float32 logits (the JAX module's
``x.astype(jnp.float32)``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from dba_mod_tpu_torch.ops.initializers import torch_uniform

PARAM_SHAPES = {"conv1.weight": ((20, 1, 5, 5), 25),
                "conv1.bias": ((20,), 25),
                "conv2.weight": ((50, 20, 5, 5), 500),
                "conv2.bias": ((50,), 500),
                "fc1.weight": ((500, 800), 800),
                "fc1.bias": ((500,), 800),
                "fc2.weight": ((10, 500), 500),
                "fc2.bias": ((10,), 500)}


def init_params(gen: torch.Generator) -> Dict[str, torch.Tensor]:
    return {k: torch_uniform(shape, fan_in, gen)
            for k, (shape, fan_in) in PARAM_SHAPES.items()}


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, Dict]:
    """x: [N, 28, 28, 1] float → (float32 log-probabilities [N, 10], {})."""
    def w(name):
        return params[name].to(dtype)

    x = x.to(dtype).permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, w("conv1.weight"), w("conv1.bias")))
    x = F.max_pool2d(x, 2, 2)
    x = F.relu(F.conv2d(x, w("conv2.weight"), w("conv2.bias")))
    x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten order
    x = F.relu(F.linear(x, w("fc1.weight"), w("fc1.bias")))
    x = F.linear(x, w("fc2.weight"), w("fc2.bias"))
    return F.log_softmax(x.to(torch.float32), dim=-1), {}
