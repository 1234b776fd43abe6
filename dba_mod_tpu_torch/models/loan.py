"""The LOAN tabular MLP as a pure function of a parameter dict (port of
dba_mod_tpu/models/loan.py).

91 → 46 → 23 → 9 with Dropout(0.5) *before* ReLU on each hidden layer (the
reference's Sequential order is Linear → Dropout → ReLU,
models/loan_model.py:10-27), raw logits out, torch-default inits.

Dropout takes its keep masks as inputs: ``where(mask, x / 0.5, 0)``, flax's
rule. Nothing inside the function draws random numbers, so it batches under
``torch.func.vmap`` and gives the same result on the card and on the CPU
for the same masks; :func:`draw_dropout_masks` makes a segment's masks from
a CPU generator.

`dtype` is the compute type: the input and each layer's weight and bias are
cast to it (flax ``dtype=``), and the logits come back float32, as the JAX
module's ``x.astype(jnp.float32)`` hands them back.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dba_mod_tpu_torch.ops.initializers import torch_uniform

IN_DIM, HIDDEN1, HIDDEN2, NUM_CLASSES = 91, 46, 23, 9
DROPOUT_RATE = 0.5
DROPOUT_WIDTHS = (HIDDEN1, HIDDEN2)
_LAYERS = ((IN_DIM, HIDDEN1), (HIDDEN1, HIDDEN2), (HIDDEN2, NUM_CLASSES))


def init_params(gen: torch.Generator) -> Dict[str, torch.Tensor]:
    params = {}
    for i, (fan_in, out) in enumerate(_LAYERS, start=1):
        params[f"fc{i}.weight"] = torch_uniform((out, fan_in), fan_in, gen)
        params[f"fc{i}.bias"] = torch_uniform((out,), fan_in, gen)
    return params


def _dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    keep_prob = 1.0 - DROPOUT_RATE
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
          dropout: Optional[Sequence[torch.Tensor]] = None,
          dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, Dict]:
    """x: [N, 91] float → (float32 logits [N, 9], {}). In train mode
    `dropout` is the pair of keep masks ([N, 46], [N, 23] bool)."""
    def dense(y, i):
        return F.linear(y, params[f"fc{i}.weight"].to(dtype),
                        params[f"fc{i}.bias"].to(dtype))

    x = x.to(dtype)
    for i in (1, 2):
        x = dense(x, i)
        if train:
            x = _dropout(x, dropout[i - 1])
        x = F.relu(x)
    return dense(x, 3).to(torch.float32), {}


def dropout_generator(seed: int, epoch: int, segment: int
                      ) -> torch.Generator:
    """A round segment's dropout stream: a CPU generator keyed by (seed,
    epoch, segment), so the card and the CPU draw the same masks."""
    key = np.random.SeedSequence([int(seed), int(epoch), int(segment)]
                                 ).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


def draw_dropout_masks(gen: torch.Generator, lead: Sequence[int]
                       ) -> Tuple[torch.Tensor, ...]:
    """Keep masks ([*lead, 46], [*lead, 23] bool, CPU) with keep
    probability 1 - DROPOUT_RATE; `lead` is the segment's [C, E, S, B]."""
    return tuple(torch.rand(tuple(lead) + (w,), generator=gen)
                 >= DROPOUT_RATE for w in DROPOUT_WIDTHS)
