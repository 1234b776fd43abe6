"""Model registry (port of dba_mod_tpu/models/__init__.py).

Models are pure functions over dicts of tensors, so one definition serves a
single model and — under ``torch.func.vmap`` — the stacked [C, ...] client
axis. ``ModelDef`` keeps the JAX package's metadata:

- ``similarity_path``: the parameter standing in for the reference
  FoolsGold's "second-to-last named parameter" (helper.py:537) — the final
  linear layer's weight, stored here torch-style as [out, in];
- ``has_batch_stats`` / ``has_dropout``: whether the model carries BN
  running stats / takes dropout keep masks in train mode;
- ``num_classes``;
- ``dtype``: the compute type (``compute_dtype``). Parameters, BN running
  stats and the logits stay float32; forward and backward run in it;
- ``resnet_spec``: a ResNet's ``models/resnet.py`` spec (None for the
  other models), which the grouped client layout reads (models/grouped.py).

``cifar_resnet34`` / ``50`` / ``101`` / ``152`` build the deeper CIFAR
ResNets; as in the JAX package no config key selects them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.models import loan, mnist, resnet

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
    input_shape: Tuple[int, ...]   # one sample, NHWC / features
    num_classes: int
    similarity_path: Tuple[str, ...]
    has_batch_stats: bool
    _init: Callable[[torch.Generator], ModelVars]
    # (params, stats, x, train, dropout) -> (logits, new_stats)
    _apply: Callable[..., Tuple[torch.Tensor, Tree]]
    has_dropout: bool = False
    dtype: torch.dtype = torch.float32
    resnet_spec: Optional[resnet.ResNetSpec] = None

    def init_vars(self, seed: int, device: torch.device) -> ModelVars:
        """torch-default init from a CPU generator seeded with `seed`
        (device independent), moved to `device`."""
        gen = torch.Generator().manual_seed(int(seed))
        mv = self._init(gen)
        return ModelVars({k: v.to(device) for k, v in mv.params.items()},
                         {k: v.to(device) for k, v in mv.batch_stats.items()})

    def apply(self, model_vars: ModelVars, x: torch.Tensor, train: bool,
              dropout: Optional[Sequence[torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Tree]:
        """Forward pass on NHWC float input (features for LOAN). Returns
        (logits, new_batch_stats); eval mode returns the stats unchanged.
        A dropout model needs its keep masks in train mode."""
        if self.has_dropout and train and not dropout:
            raise ValueError(f"{self.name}: dropout masks are required in "
                             f"train mode")
        return self._apply(model_vars.params, model_vars.batch_stats, x,
                           train, dropout)

    def similarity_param(self, params: Tree) -> torch.Tensor:
        return params[self.similarity_path[0]]


def _resnet(spec: resnet.ResNetSpec, num_classes: int, dtype: torch.dtype):
    def init(gen):
        return ModelVars(*resnet.init_vars(gen, num_classes, spec))

    def apply(params, stats, x, train, dropout):
        return resnet.apply(params, stats, x, train, spec, dtype)

    return init, apply


def _resnet_def(name: str, num_classes: int, dtype: torch.dtype) -> ModelDef:
    spec = resnet.SPECS[name]
    init, apply = _resnet(spec, num_classes, dtype)
    hw = 32 if spec.stem == "cifar" else 64
    return ModelDef(name=name, input_shape=(hw, hw, 3),
                    num_classes=num_classes, similarity_path=("fc.weight",),
                    has_batch_stats=True, _init=init, _apply=apply,
                    dtype=dtype, resnet_spec=spec)


def cifar_resnet34(dtype: torch.dtype = torch.float32) -> ModelDef:
    return _resnet_def("CifarResNet34", 10, dtype)


def cifar_resnet50(dtype: torch.dtype = torch.float32) -> ModelDef:
    return _resnet_def("CifarResNet50", 10, dtype)


def cifar_resnet101(dtype: torch.dtype = torch.float32) -> ModelDef:
    return _resnet_def("CifarResNet101", 10, dtype)


def cifar_resnet152(dtype: torch.dtype = torch.float32) -> ModelDef:
    return _resnet_def("CifarResNet152", 10, dtype)


def compute_dtype_of(params: cfg.Params) -> torch.dtype:
    """The compute type a config asks for (dba_mod_tpu/models/__init__.py:
    82-88)."""
    name = str(params.get("compute_dtype", "float32"))
    if name in ("float32", "f32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {name!r}")


def build_model(params: cfg.Params) -> ModelDef:
    t = params.type
    dtype = compute_dtype_of(params)
    if t == cfg.TYPE_MNIST:
        return ModelDef(name="MnistNet", input_shape=(28, 28, 1),
                        num_classes=10, similarity_path=("fc2.weight",),
                        has_batch_stats=False,
                        _init=lambda gen: ModelVars(mnist.init_params(gen),
                                                    {}),
                        _apply=lambda p, s, x, train, d: mnist.apply(
                            p, x, dtype),
                        dtype=dtype)
    if t == cfg.TYPE_CIFAR:
        return _resnet_def("CifarResNet18", 10, dtype)
    if t == cfg.TYPE_TINYIMAGENET:
        return _resnet_def("TinyResNet18", 200, dtype)
    if t == cfg.TYPE_LOAN:
        return ModelDef(name="LoanNet", input_shape=(loan.IN_DIM,),
                        num_classes=loan.NUM_CLASSES,
                        similarity_path=("fc3.weight",),
                        has_batch_stats=False,
                        _init=lambda gen: ModelVars(loan.init_params(gen),
                                                    {}),
                        _apply=lambda p, s, x, train, d: loan.apply(
                            p, x, train, d, dtype),
                        has_dropout=True, dtype=dtype)
    raise ValueError(f"unknown workload type {t!r}")
