"""The ResNets as pure functions of parameter + BN-stat dicts (port of
dba_mod_tpu/models/resnet.py::ResNet and its constructors).

- ``CIFAR18`` — reference models/resnet_cifar.py:70-116: 3×3 stem, narrow
  widths 32/64/128/256, BasicBlock [2, 2, 2, 2], 4×4 average pool, linear
  head, raw logits, torch-default inits.
- ``TINY18`` — reference models/resnet_tinyimagenet.py:40-238: the standard
  64-base ResNet-18 with a 7×7/s2 stem, BN, ReLU and a 3×3/s2 max pool,
  global average pool, 200-class head; kaiming_normal(fan_out) convolutions
  and BN γ=1/β=0 (:158-163). The head keeps the torch-default init, as the
  JAX package's ``head_init=None`` does.
- ``CIFAR34`` / ``CIFAR50`` / ``CIFAR101`` / ``CIFAR152`` — the deeper
  CIFAR variants (reference resnet_cifar.py:106-116; the JAX package's
  cifar_resnet34/50/101/152): the CIFAR-18 stem, widths, pool and inits,
  BasicBlock [3, 4, 6, 3] for 34 and Bottleneck blocks (1×1, 3×3 with the
  stride, 1×1 to 4·planes, each with BN; a 1×1 + BN shortcut when the
  stride or width changes) for 50/101/152. No config selects them.

BatchNorm is models/norm.py's functional, unbiased-running-var rule. Inputs
are NHWC (the JAX package's layout, in which triggers are stamped); the model
permutes to NCHW for cuDNN.

`dtype` is the compute type, cast where flax casts (models/resnet.py of the
JAX package, ``dtype=`` on every layer): the input on entry, each weight at
its convolution or linear layer; BatchNorm computes in float32 and returns
the compute type. Parameters and running stats stay float32, and the head
hands back float32 logits (float64 ones in a float64 pass).
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
    """The JAX ``ResNet`` module's knobs that the variants set."""
    widths: Tuple[int, ...]
    stem: str            # "cifar": 3×3/s1; "imagenet": 7×7/s2 + max pool
    pool: str            # "avg4": 4×4 window; "global": mean over H, W
    conv_init: str       # "torch_uniform" or "kaiming_normal_fan_out"
    num_blocks: Tuple[int, ...] = (2, 2, 2, 2)   # blocks per stage
    bottleneck: bool = False   # Bottleneck (×4) blocks, else BasicBlocks

    @property
    def expansion(self) -> int:
        return 4 if self.bottleneck else 1


CIFAR18 = ResNetSpec(widths=(32, 64, 128, 256), stem="cifar", pool="avg4",
                     conv_init="torch_uniform")
TINY18 = ResNetSpec(widths=(64, 128, 256, 512), stem="imagenet",
                    pool="global", conv_init="kaiming_normal_fan_out")
CIFAR34 = dataclasses.replace(CIFAR18, num_blocks=(3, 4, 6, 3))
CIFAR50 = dataclasses.replace(CIFAR34, bottleneck=True)
CIFAR101 = dataclasses.replace(CIFAR50, num_blocks=(3, 4, 23, 3))
CIFAR152 = dataclasses.replace(CIFAR50, num_blocks=(3, 8, 36, 3))
# ModelDef name → spec (models/__init__.py, convert.py)
SPECS = {"CifarResNet18": CIFAR18, "TinyResNet18": TINY18,
         "CifarResNet34": CIFAR34, "CifarResNet50": CIFAR50,
         "CifarResNet101": CIFAR101, "CifarResNet152": CIFAR152}


def block_plan(spec: ResNetSpec = CIFAR18) -> List[Tuple[int, int, int]]:
    """(in_planes, planes, stride) of every block, in order; a block puts
    out planes·expansion channels."""
    plan, in_planes = [], spec.widths[0]
    for stage, (planes, blocks) in enumerate(zip(spec.widths,
                                                 spec.num_blocks)):
        for i in range(blocks):
            stride = (2 if stage > 0 else 1) if i == 0 else 1
            plan.append((in_planes, planes, stride))
            in_planes = planes * spec.expansion
    return plan


def block_convs(spec: ResNetSpec, cin: int, planes: int, stride: int):
    """One block's convolutions as (name, out, in, kernel, stride,
    padding): (the main path's, in flax's creation order Conv_0, Conv_1,
    ...; the shortcut's or None). Each is followed by its BatchNorm; the
    shortcut's flax index comes after the main path's."""
    out = planes * spec.expansion
    if spec.bottleneck:
        main = [("1", planes, cin, 1, 1, 0), ("2", planes, planes, 3,
                                              stride, 1),
                ("3", out, planes, 1, 1, 0)]
    else:
        main = [("1", planes, cin, 3, stride, 1),
                ("2", planes, planes, 3, 1, 1)]
    sc = (("sc", out, cin, 1, stride, 0) if stride != 1 or cin != out
          else None)
    return main, sc


def conv_key(block: int, name: str) -> Tuple[str, str]:
    """The port's (conv, bn) keys of one block's convolution `name`."""
    p = f"blocks.{block}"
    return ((f"{p}.sc_conv", f"{p}.sc_bn") if name == "sc" else
            (f"{p}.conv{name}", f"{p}.bn{name}"))


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
        main, sc = block_convs(spec, cin, planes, stride)
        for name, cout, ci, k, _, _ in main + ([sc] if sc else []):
            ck, bk = conv_key(i, name)
            conv(ck, cout, ci, k)
            bn(bk, cout)
    feat = spec.widths[-1] * spec.expansion
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

    x = features(spec, x.to(dtype).permute(0, 3, 1, 2), conv, bn)
    x = x.reshape(x.shape[0], -1)
    logits = F.linear(x, params["fc.weight"].to(dtype),
                      params["fc.bias"].to(dtype))
    return logits.to(torch.promote_types(dtype, torch.float32)), new_stats


def features(spec: ResNetSpec, x: torch.Tensor, conv, bn) -> torch.Tensor:
    """Stem, blocks and pool on NCHW `x`: the network less its head, with
    the convolution ``conv(y, key, stride=, padding=)`` and the BatchNorm
    ``bn(key, y)`` the caller gives (the stacked path's plain ones, or the
    grouped layout's, models/grouped.py). Returns the pooled [N, F, h, w]
    (avg4) or [N, F] (global)."""
    if spec.stem == "cifar":
        x = F.relu(bn("stem_bn", conv(x, "stem_conv", padding=1)))
    else:
        x = F.relu(bn("stem_bn", conv(x, "stem_conv", stride=2, padding=3)))
        # torch pads max pooling with -inf, as flax's nn.max_pool does with
        # explicit padding
        x = F.max_pool2d(x, 3, 2, padding=1)
    for i, (cin, planes, stride) in enumerate(block_plan(spec)):
        main, sc = block_convs(spec, cin, planes, stride)
        y = x
        for j, (name, _, _, _, s, pad) in enumerate(main):
            ck, bk = conv_key(i, name)
            y = bn(bk, conv(y, ck, stride=s, padding=pad))
            if j < len(main) - 1:
                y = F.relu(y)
        r = x
        if sc:
            ck, bk = conv_key(i, "sc")
            r = bn(bk, conv(x, ck, stride=sc[4]))
        x = F.relu(y + r)
    if spec.pool == "avg4":
        return F.avg_pool2d(x, 4, 4)
    return torch.mean(x, dim=(2, 3))
