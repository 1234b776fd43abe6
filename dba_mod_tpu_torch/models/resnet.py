"""The ResNet-18 variants as pure functions of parameter + BN-stat dicts (port
of dba_mod_tpu/models/resnet.py::ResNet, cifar_resnet18 and tiny_resnet18).

- ``CIFAR18`` — reference models/resnet_cifar.py:70-116: 3×3 stem, narrow
  widths 32/64/128/256, BasicBlock [2, 2, 2, 2], 4×4 average pool, linear
  head, raw logits, torch-default inits.
- ``TINY18`` — reference models/resnet_tinyimagenet.py:40-238: the standard
  64-base ResNet-18 with a 7×7/s2 stem, BN, ReLU and a 3×3/s2 max pool,
  global average pool, 200-class head; kaiming_normal(fan_out) convolutions
  and BN γ=1/β=0 (:158-163). The head keeps the torch-default init, as the
  JAX package's ``head_init=None`` does.

BatchNorm is models/norm.py's functional, unbiased-running-var rule. Inputs
are NHWC (the JAX package's layout, in which triggers are stamped); the model
permutes to NCHW for cuDNN.

`dtype` is the compute type, cast where flax casts (models/resnet.py of the
JAX package, ``dtype=`` on every layer): the input on entry, each weight at
its convolution or linear layer; BatchNorm computes in float32 and returns
the compute type. Parameters and running stats stay float32, and the head
hands back float32 logits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from dba_mod_tpu_torch.models.norm import batch_norm
from dba_mod_tpu_torch.ops.initializers import (kaiming_normal_fan_out,
                                                torch_uniform)


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    """The JAX ``ResNet`` module's knobs that the two variants set."""
    widths: Tuple[int, ...]
    stem: str            # "cifar": 3×3/s1; "imagenet": 7×7/s2 + max pool
    pool: str            # "avg4": 4×4 window; "global": mean over H, W
    conv_init: str       # "torch_uniform" or "kaiming_normal_fan_out"


CIFAR18 = ResNetSpec(widths=(32, 64, 128, 256), stem="cifar", pool="avg4",
                     conv_init="torch_uniform")
TINY18 = ResNetSpec(widths=(64, 128, 256, 512), stem="imagenet",
                    pool="global", conv_init="kaiming_normal_fan_out")
NUM_BLOCKS = (2, 2, 2, 2)   # BasicBlocks per stage: ResNet-18


def block_plan(spec: ResNetSpec = CIFAR18) -> List[Tuple[int, int, int]]:
    """(in_planes, planes, stride) of every BasicBlock, in order."""
    plan, in_planes = [], spec.widths[0]
    for stage, (planes, blocks) in enumerate(zip(spec.widths, NUM_BLOCKS)):
        for i in range(blocks):
            stride = (2 if stage > 0 else 1) if i == 0 else 1
            plan.append((in_planes, planes, stride))
            in_planes = planes
    return plan


def _has_shortcut(in_planes: int, planes: int, stride: int) -> bool:
    return stride != 1 or in_planes != planes


def init_vars(gen: torch.Generator, num_classes: int = 10,
              spec: ResNetSpec = CIFAR18
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    params: Dict[str, torch.Tensor] = {}
    stats: Dict[str, torch.Tensor] = {}

    def conv(name, cout, cin, k):
        shape = (cout, cin, k, k)
        params[f"{name}.weight"] = (
            kaiming_normal_fan_out(shape, gen)
            if spec.conv_init == "kaiming_normal_fan_out"
            else torch_uniform(shape, cin * k * k, gen))

    def bn(name, c):
        params[f"{name}.weight"] = torch.ones(c)
        params[f"{name}.bias"] = torch.zeros(c)
        stats[f"{name}.running_mean"] = torch.zeros(c)
        stats[f"{name}.running_var"] = torch.ones(c)

    conv("stem_conv", spec.widths[0], 3, 3 if spec.stem == "cifar" else 7)
    bn("stem_bn", spec.widths[0])
    for i, (cin, planes, stride) in enumerate(block_plan(spec)):
        conv(f"blocks.{i}.conv1", planes, cin, 3)
        bn(f"blocks.{i}.bn1", planes)
        conv(f"blocks.{i}.conv2", planes, planes, 3)
        bn(f"blocks.{i}.bn2", planes)
        if _has_shortcut(cin, planes, stride):
            conv(f"blocks.{i}.sc_conv", planes, cin, 1)
            bn(f"blocks.{i}.sc_bn", planes)
    feat = spec.widths[-1]
    params["fc.weight"] = torch_uniform((num_classes, feat), feat, gen)
    params["fc.bias"] = torch_uniform((num_classes,), feat, gen)
    return params, stats


def apply(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
          x: torch.Tensor, train: bool, spec: ResNetSpec = CIFAR18,
          dtype: torch.dtype = torch.float32
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [N, H, W, 3] float → (float32 logits [N, classes], new BN
    stats)."""
    new_stats: Dict[str, torch.Tensor] = {}

    def conv(y, name, **kw):
        return F.conv2d(y, params[f"{name}.weight"].to(dtype), **kw)

    def bn(name, y):
        out, m, v = batch_norm(y, params[f"{name}.weight"],
                               params[f"{name}.bias"],
                               stats[f"{name}.running_mean"],
                               stats[f"{name}.running_var"], train)
        new_stats[f"{name}.running_mean"] = m
        new_stats[f"{name}.running_var"] = v
        return out

    x = x.to(dtype).permute(0, 3, 1, 2)
    if spec.stem == "cifar":
        x = F.relu(bn("stem_bn", conv(x, "stem_conv", padding=1)))
    else:
        x = F.relu(bn("stem_bn", conv(x, "stem_conv", stride=2, padding=3)))
        # torch pads max pooling with -inf, as flax's nn.max_pool does with
        # explicit padding
        x = F.max_pool2d(x, 3, 2, padding=1)
    for i, (cin, planes, stride) in enumerate(block_plan(spec)):
        p = f"blocks.{i}"
        y = conv(x, f"{p}.conv1", stride=stride, padding=1)
        y = F.relu(bn(f"{p}.bn1", y))
        y = conv(y, f"{p}.conv2", padding=1)
        y = bn(f"{p}.bn2", y)
        if _has_shortcut(cin, planes, stride):
            r = conv(x, f"{p}.sc_conv", stride=stride)
            r = bn(f"{p}.sc_bn", r)
        else:
            r = x
        x = F.relu(y + r)
    if spec.pool == "avg4":
        x = F.avg_pool2d(x, 4, 4)
        x = x.reshape(x.shape[0], -1)
    else:
        x = torch.mean(x, dim=(2, 3))
    logits = F.linear(x, params["fc.weight"].to(dtype),
                      params["fc.bias"].to(dtype))
    return logits.to(torch.float32), new_stats
