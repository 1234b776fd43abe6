"""Carry weights between the JAX package and the port.

``from_jax_numpy`` takes the JAX package's ``ModelVars`` as nested dicts of
numpy arrays (flax layout) and returns the port's ``ModelVars`` of CPU
tensors; ``to_jax_numpy`` is its inverse. The mapping:

- conv kernel ``[kh, kw, in, out]`` → torch weight ``[out, in, kh, kw]``;
- Dense kernel ``[in, out]`` → Linear weight ``[out, in]``;
- BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) →
  ``weight/bias`` and ``running_mean/running_var``.

The port's MnistNet flattens its activations in NHWC order like flax, so
its fc1 needs no row permutation. Every ResNet (CIFAR-18/34/50/101/152 and
Tiny-ImageNet's 18) is one flax class, so their trees share the module
names: ``BasicBlock_i`` or ``Bottleneck_i`` with ``Conv_j``/``BatchNorm_j``
in creation order, the shortcut's last (Tiny's stem kernel is 7×7);
LoanNet's ``Dense_i`` is the port's ``fc{i+1}``.
``fg_memory_from_jax`` / ``fg_memory_to_jax`` carry the FoolsGold memory,
whose rows flatten the similarity layer in each package's own layout. Used
by the parity tests and by anyone moving a checkpoint between the two
packages.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from dba_mod_tpu_torch.models import ModelVars
from dba_mod_tpu_torch.models.resnet import (SPECS, block_convs,
                                             block_plan, conv_key)

Nested = Dict[str, Any]


def _conv_in(k) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _conv_out(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _dense_in(k) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k).T)


_dense_out = _dense_in


def _pairs(model_name: str):
    """(flax path, port key, kind) for every parameter and BN stat."""
    if model_name == "MnistNet":
        return [(("Conv_0", "kernel"), "conv1.weight", "conv"),
                (("Conv_0", "bias"), "conv1.bias", "id"),
                (("Conv_1", "kernel"), "conv2.weight", "conv"),
                (("Conv_1", "bias"), "conv2.bias", "id"),
                (("Dense_0", "kernel"), "fc1.weight", "dense"),
                (("Dense_0", "bias"), "fc1.bias", "id"),
                (("Dense_1", "kernel"), "fc2.weight", "dense"),
                (("Dense_1", "bias"), "fc2.bias", "id")]
    if model_name == "LoanNet":
        return [pair for i in range(3) for pair in (
            ((f"Dense_{i}", "kernel"), f"fc{i + 1}.weight", "dense"),
            ((f"Dense_{i}", "bias"), f"fc{i + 1}.bias", "id"))]
    if model_name in SPECS:
        spec = SPECS[model_name]
        block = "Bottleneck" if spec.bottleneck else "BasicBlock"
        out = []

        def conv(path, key):
            out.append((path + ("kernel",), f"{key}.weight", "conv"))

        def bn(path, key):
            out.append((path + ("scale",), f"{key}.weight", "id"))
            out.append((path + ("bias",), f"{key}.bias", "id"))
            out.append((("stats",) + path + ("mean",),
                        f"{key}.running_mean", "id"))
            out.append((("stats",) + path + ("var",),
                        f"{key}.running_var", "id"))

        conv(("Conv_0",), "stem_conv")
        bn(("BatchNorm_0",), "stem_bn")
        for i, (cin, planes, stride) in enumerate(block_plan(spec)):
            main, sc = block_convs(spec, cin, planes, stride)
            for j, c in enumerate(main + ([sc] if sc else [])):
                ck, bk = conv_key(i, c[0])
                conv((f"{block}_{i}", f"Conv_{j}"), ck)
                bn((f"{block}_{i}", f"BatchNorm_{j}"), bk)
        out.append((("Dense_0", "kernel"), "fc.weight", "dense"))
        out.append((("Dense_0", "bias"), "fc.bias", "id"))
        return out
    raise NotImplementedError(f"no weight mapping for {model_name!r}")


def _get(tree: Nested, path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: Nested, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def from_jax_numpy(model_name: str, params: Nested, batch_stats: Nested,
                   dtype=np.float32) -> ModelVars:
    """flax-layout numpy trees → the port's ModelVars (CPU, float32 or
    ``dtype``)."""
    conv_in = {"conv": _conv_in, "dense": _dense_in, "id": np.asarray}
    p, s = {}, {}
    for path, key, kind in _pairs(model_name):
        if path[0] == "stats":
            s[key] = torch.from_numpy(np.array(_get(batch_stats, path[1:]),
                                               dtype))
        else:
            p[key] = torch.from_numpy(np.array(
                conv_in[kind](_get(params, path)), dtype))
    return ModelVars(p, s)


def to_jax_numpy(model_name: str, model_vars: ModelVars
                 ) -> Tuple[Nested, Nested]:
    """The port's ModelVars → (params, batch_stats) flax-layout numpy
    trees."""
    conv_out = {"conv": _conv_out, "dense": _dense_out, "id": np.asarray}
    params: Nested = {}
    stats: Nested = {}
    for path, key, kind in _pairs(model_name):
        if path[0] == "stats":
            _put(stats, path[1:],
                 model_vars.batch_stats[key].detach().cpu().numpy())
        else:
            _put(params, path, conv_out[kind](
                model_vars.params[key].detach().cpu().numpy()))
    return params, stats


def fg_memory_from_jax(memory, weight_shape) -> torch.Tensor:
    """The JAX package's FoolsGold memory [N, L] → the port's. A JAX row is
    the similarity layer's flax kernel [in, out] flattened; a port row is
    the torch weight [out, in] (`weight_shape`) flattened, so each row is
    transposed."""
    out_f, in_f = weight_shape
    m = np.asarray(memory, np.float32)
    rows = m.reshape(m.shape[0], in_f, out_f).transpose(0, 2, 1)
    return torch.from_numpy(np.ascontiguousarray(rows.reshape(m.shape[0],
                                                              -1)))


def fg_memory_to_jax(memory: torch.Tensor, weight_shape) -> np.ndarray:
    """Inverse of :func:`fg_memory_from_jax`."""
    out_f, in_f = weight_shape
    m = memory.detach().cpu().numpy()
    rows = m.reshape(m.shape[0], out_f, in_f).transpose(0, 2, 1)
    return np.ascontiguousarray(rows.reshape(m.shape[0], -1))
