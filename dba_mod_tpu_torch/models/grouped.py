"""The grouped client layout: a train-mode forward of C stacked BasicBlock
ResNets as ONE network of grouped convolutions (port of
dba_mod_tpu/models/grouped.py).

The stacked client step (fl/client.py) runs the per-client forward under
``torch.func.vmap``, whose batching rule turns each convolution into a
grouped one and regroups the activations around every convolution. Here the
grouped layout is held from the stem to the head instead:

- activations stay ``[B, C·f, H, W]`` (client-major channels, NCHW as
  everywhere else in the port); the step's only activation transpose is the
  input ``[C, B, H, W, 3]`` → ``[B, C·3, H, W]``;
- each convolution is ``F.conv2d(x, w.view(C·co, ci, kh, kw), groups=C)``;
- BatchNorm is models/norm.py's ``batch_norm`` on the merged channels, with
  the ``[C, f]`` scale, bias and running stats flattened to ``[C·f]``:
  channels never mix, so the per-channel statistics are the per-client
  ones (unbiased running variance included);
- the head is a per-client product, ``w [C, K, F] @ x [C, F, B]``
  transposed to ``[C, B, K]``, plus the bias, with float32 logits (float64
  ones in a float64 pass; in this order the weight's gradient comes back
  contiguous, as the fused update kernel needs; ``einsum("bcf,ckf->cbk")``
  returns it transposed).

Why the JAX package's ``conv_layout_in`` / ``conv_layout_out`` have no
counterpart: flax stores a conv kernel ``[kh, kw, ci, co]``, so the stacked
``[C, kh, kw, ci, co]`` kernel must move its client axis next to ``co``
before the grouped kernel ``[kh, kw, ci, C·co]`` is a free reshape, and the
JAX grouped step converts its state once per segment. A torch weight is
``[out, in/groups, kh, kw]``: the port's stacked leaf ``[C, co, ci, kh, kw]``
is already ``[C·co, ci, kh, kw]`` through a free ``view``, which is exactly
the weight of ``groups=C``. So the client state stays client-leading across
the segment and the fused update kernel (ops/fused_update.py) takes it
unchanged, one launch a step; the weight gradient comes back through the
same view, client-leading and contiguous.

Per-client math equals the vmapped path's but not bitwise: grouped and
vmapped convolutions sum in different orders (forward ≤ 5e-5,
tests/test_torch_grouped.py). Dtypes are cast where models/resnet.py casts.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from dba_mod_tpu_torch.models import ModelDef
from dba_mod_tpu_torch.models.norm import batch_norm
from dba_mod_tpu_torch.models.resnet import features

Tree = Dict[str, torch.Tensor]


def supports_grouped(model_def: ModelDef) -> bool:
    """The grouped layout covers the BasicBlock ResNets (the CIFAR and
    Tiny-ImageNet workloads); MnistNet, LoanNet and the Bottleneck variants
    take the vmapped path."""
    spec = model_def.resnet_spec
    return (spec is not None and not spec.bottleneck
            and not model_def.has_dropout)


def grouped_train_apply(model_def: ModelDef, params: Tree, batch_stats: Tree,
                        x_cb: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """Train-mode forward of C stacked clients in the grouped layout.

    params / batch_stats: the stacked ``[C, ...]`` trees of the port's
    layout; x_cb: ``[C, B, H, W, 3]``. Returns (float32 logits [C, B, K],
    the new BN running stats as ``[C, f]`` leaves)."""
    spec, dtype = model_def.resnet_spec, model_def.dtype
    C, B, H, W, ci = x_cb.shape
    new_stats: Tree = {}

    def conv(y, name, stride=1, padding=0):
        w = params[f"{name}.weight"]
        w = w.view((C * w.shape[1],) + tuple(w.shape[2:])).to(dtype)
        return F.conv2d(y, w, stride=stride, padding=padding, groups=C)

    def bn(name, y):
        f = params[f"{name}.weight"].shape[1]
        out, m, v = batch_norm(
            y, params[f"{name}.weight"].reshape(C * f),
            params[f"{name}.bias"].reshape(C * f),
            batch_stats[f"{name}.running_mean"].reshape(C * f),
            batch_stats[f"{name}.running_var"].reshape(C * f), True)
        new_stats[f"{name}.running_mean"] = m.reshape(C, f)
        new_stats[f"{name}.running_var"] = v.reshape(C, f)
        return out

    # the one activation transpose of a step: the 3-channel input
    x = x_cb.to(dtype).permute(1, 0, 4, 2, 3).reshape(B, C * ci, H, W)
    x = features(spec, x, conv, bn)
    # client-major channels: [B, C·f(·h·w)] → per-client features [C, F, B]
    x = x.reshape(B, C, -1).permute(1, 2, 0)
    logits = (torch.matmul(params["fc.weight"].to(dtype), x).transpose(1, 2)
              + params["fc.bias"].to(dtype)[:, None, :])
    return logits.to(torch.promote_types(dtype, torch.float32)), new_stats
