"""The grouped-layout client step: all C clients' forward and backward as
one network of grouped convolutions, with no vmap over clients (port of
dba_mod_tpu/fl/grouped_client.py).

Same contract as fl/client.py's ``make_client_step`` (the same arguments,
``active`` and ``dropout`` included, and the same ``SegmentResult``), and
the same segment loop (``make_segment_step``): every step ends in ONE
``fused_step_update`` call over the client-leading state (``sgd`` leaves
for every parameter, ``sgd_acc`` under FoolsGold, ``sel`` for the BN
running stats), and metrics, ``track_batches`` and the model-replacement
epilogue are the vmapped step's. Only the gradient differs in how it is
computed: the forward is models/grouped.py's ``grouped_train_apply``, and
the loss is the sum over clients of each client's masked-mean cross
entropy, plus, where α < 1, the per-client distance term with the
zero-gradient-safe norm. A client's parameters reach only its own loss, so
the gradient of the sum is each client's own gradient.

The JAX grouped step moves its conv kernels to a client-third layout once
per segment and back; the port's state needs no move (models/grouped.py),
so the fused kernel's one launch a step is unchanged.
"""
from __future__ import annotations

import torch
from torch.func import grad_and_value, vmap

from dba_mod_tpu_torch.fl.client import make_segment_step
from dba_mod_tpu_torch.fl.device_data import DeviceData
from dba_mod_tpu_torch.fl.state import RoundHyper
from dba_mod_tpu_torch.models import ModelDef
from dba_mod_tpu_torch.models.grouped import grouped_train_apply
from dba_mod_tpu_torch.ops.losses import cross_entropy, tree_dist_norm


def make_grouped_client_step(model_def: ModelDef, data: DeviceData,
                             hyper: RoundHyper, fg_enabled: bool = False):
    """Returns grouped_step with fl/client.py::make_client_step's contract
    (models/grouped.py::supports_grouped models only)."""
    use_dist = hyper.alpha_loss != 1.0
    dist_fn = vmap(tree_dist_norm)       # [C], the zero-gradient-safe norm

    def loss_fn(p, bn, x, y, bmask, anchor, alpha):
        logits, new_bn = grouped_train_apply(model_def, p, bn, x)
        loss = cross_entropy(logits, y, bmask)               # [C]
        if use_dist:
            loss = alpha * loss + (1.0 - alpha) * dist_fn(p, anchor)
        return torch.sum(loss), (loss, logits, new_bn)

    grad_sum = grad_and_value(loss_fn, has_aux=True)

    def grad_fn(p, bn, x, y, bmask, anchor, alpha, drop):
        grads, (_, (loss, logits, new_bn)) = grad_sum(p, bn, x, y, bmask,
                                                      anchor, alpha)
        return grads, (loss, (logits, new_bn))

    return make_segment_step(grad_fn, data, hyper, fg_enabled)
