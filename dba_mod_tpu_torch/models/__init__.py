"""Model registry (port of dba_mod_tpu/models/__init__.py).

Models are pure functions over dicts of tensors, so one definition serves a
single model and — under ``torch.func.vmap`` — the stacked [C, ...] client
axis. ``ModelDef`` keeps the JAX package's metadata:

- ``similarity_path``: the parameter standing in for the reference
  FoolsGold's "second-to-last named parameter" (helper.py:537) — the final
  linear layer's weight, stored here torch-style as [out, in];
- ``has_batch_stats``: whether the model carries BN running stats;
- ``num_classes``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.models import mnist, resnet

Tree = Dict[str, torch.Tensor]


class ModelVars(NamedTuple):
    """A model's full mutable state: trainable params + BN running stats
    (the unit clients perturb and the server aggregates; the reference
    averages BN buffers with the weights, helper.py:233-257)."""
    params: Tree
    batch_stats: Tree  # empty dict for models without BN


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    input_shape: Tuple[int, ...]   # one sample, NHWC
    num_classes: int
    similarity_path: Tuple[str, ...]
    has_batch_stats: bool
    _init: Callable[[torch.Generator], ModelVars]
    _apply: Callable[[Tree, Tree, torch.Tensor, bool], Tuple[torch.Tensor,
                                                             Tree]]

    def init_vars(self, seed: int, device: torch.device) -> ModelVars:
        """torch-default init from a CPU generator seeded with `seed`
        (device independent), moved to `device`."""
        gen = torch.Generator().manual_seed(int(seed))
        mv = self._init(gen)
        return ModelVars({k: v.to(device) for k, v in mv.params.items()},
                         {k: v.to(device) for k, v in mv.batch_stats.items()})

    def apply(self, model_vars: ModelVars, x: torch.Tensor, train: bool
              ) -> Tuple[torch.Tensor, Tree]:
        """Forward pass on NHWC float input. Returns (logits,
        new_batch_stats); eval mode returns the stats unchanged."""
        return self._apply(model_vars.params, model_vars.batch_stats, x,
                           train)

    def similarity_param(self, params: Tree) -> torch.Tensor:
        return params[self.similarity_path[0]]


def _mnist_init(gen):
    return ModelVars(mnist.init_params(gen), {})


def _mnist_apply(params, stats, x, train):
    return mnist.apply(params, x)


def _cifar_init(gen):
    return ModelVars(*resnet.init_vars(gen, 10))


def build_model(params: cfg.Params) -> ModelDef:
    t = params.type
    if t == cfg.TYPE_MNIST:
        return ModelDef(name="MnistNet", input_shape=(28, 28, 1),
                        num_classes=10, similarity_path=("fc2.weight",),
                        has_batch_stats=False, _init=_mnist_init,
                        _apply=_mnist_apply)
    if t == cfg.TYPE_CIFAR:
        return ModelDef(name="CifarResNet18", input_shape=(32, 32, 3),
                        num_classes=10, similarity_path=("fc.weight",),
                        has_batch_stats=True, _init=_cifar_init,
                        _apply=resnet.apply)
    raise NotImplementedError(f"workload {t!r} is not ported (ROADMAP A11)")
