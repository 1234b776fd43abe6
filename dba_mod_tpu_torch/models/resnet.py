"""The narrow CIFAR ResNet-18 as a pure function of parameter + BN-stat
dicts (port of dba_mod_tpu/models/resnet.py::cifar_resnet18).

Reference models/resnet_cifar.py:70-116: 3×3 stem, narrow widths
32/64/128/256, BasicBlock [2, 2, 2, 2], 4×4 average pool, linear head, raw
logits, torch-default inits. BatchNorm is models/norm.py's functional,
unbiased-running-var rule. Inputs are NHWC (the JAX package's layout, in
which triggers are stamped); the model permutes to NCHW for cuDNN.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from dba_mod_tpu_torch.models.norm import batch_norm
from dba_mod_tpu_torch.ops.initializers import torch_uniform

WIDTHS = (32, 64, 128, 256)
NUM_BLOCKS = (2, 2, 2, 2)


def block_plan(widths: Sequence[int] = WIDTHS,
               num_blocks: Sequence[int] = NUM_BLOCKS
               ) -> List[Tuple[int, int, int]]:
    """(in_planes, planes, stride) of every BasicBlock, in order."""
    plan, in_planes = [], widths[0]
    for stage, (planes, blocks) in enumerate(zip(widths, num_blocks)):
        for i in range(blocks):
            stride = (2 if stage > 0 else 1) if i == 0 else 1
            plan.append((in_planes, planes, stride))
            in_planes = planes
    return plan


def _has_shortcut(in_planes: int, planes: int, stride: int) -> bool:
    return stride != 1 or in_planes != planes


def init_vars(gen: torch.Generator, num_classes: int = 10
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    params: Dict[str, torch.Tensor] = {}
    stats: Dict[str, torch.Tensor] = {}

    def conv(name, cout, cin, k):
        params[f"{name}.weight"] = torch_uniform((cout, cin, k, k),
                                                 cin * k * k, gen)

    def bn(name, c):
        params[f"{name}.weight"] = torch.ones(c)
        params[f"{name}.bias"] = torch.zeros(c)
        stats[f"{name}.running_mean"] = torch.zeros(c)
        stats[f"{name}.running_var"] = torch.ones(c)

    conv("stem_conv", WIDTHS[0], 3, 3)
    bn("stem_bn", WIDTHS[0])
    for i, (cin, planes, stride) in enumerate(block_plan()):
        conv(f"blocks.{i}.conv1", planes, cin, 3)
        bn(f"blocks.{i}.bn1", planes)
        conv(f"blocks.{i}.conv2", planes, planes, 3)
        bn(f"blocks.{i}.bn2", planes)
        if _has_shortcut(cin, planes, stride):
            conv(f"blocks.{i}.sc_conv", planes, cin, 1)
            bn(f"blocks.{i}.sc_bn", planes)
    feat = WIDTHS[-1]
    params["fc.weight"] = torch_uniform((num_classes, feat), feat, gen)
    params["fc.bias"] = torch_uniform((num_classes,), feat, gen)
    return params, stats


def apply(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
          x: torch.Tensor, train: bool
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [N, 32, 32, 3] float → (logits [N, classes], new BN stats)."""
    new_stats: Dict[str, torch.Tensor] = {}

    def bn(name, y):
        out, m, v = batch_norm(y, params[f"{name}.weight"],
                               params[f"{name}.bias"],
                               stats[f"{name}.running_mean"],
                               stats[f"{name}.running_var"], train)
        new_stats[f"{name}.running_mean"] = m
        new_stats[f"{name}.running_var"] = v
        return out

    x = x.permute(0, 3, 1, 2)
    x = F.relu(bn("stem_bn", F.conv2d(x, params["stem_conv.weight"],
                                      padding=1)))
    for i, (cin, planes, stride) in enumerate(block_plan()):
        p = f"blocks.{i}"
        y = F.conv2d(x, params[f"{p}.conv1.weight"], stride=stride,
                     padding=1)
        y = F.relu(bn(f"{p}.bn1", y))
        y = F.conv2d(y, params[f"{p}.conv2.weight"], padding=1)
        y = bn(f"{p}.bn2", y)
        if _has_shortcut(cin, planes, stride):
            r = F.conv2d(x, params[f"{p}.sc_conv.weight"], stride=stride)
            r = bn(f"{p}.sc_bn", r)
        else:
            r = x
        x = F.relu(y + r)
    x = F.avg_pool2d(x, 4, 4)
    x = x.reshape(x.shape[0], -1)
    return F.linear(x, params["fc.weight"], params["fc.bias"]), new_stats
