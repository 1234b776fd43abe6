"""The local-training step over the stacked client axis (port of
dba_mod_tpu/fl/client.py:69-177).

All C clients of a round train together: their states are [C, ...] stacks,
forward and backward run under ``torch.func.vmap`` (which lowers the
per-client convolutions to grouped convolutions, as JAX's vmap does), and
every step ends in ONE call of the fused update kernel over the whole
stacked state (ops/fused_update.py). Reference semantics, as in the JAX
package:

- fresh torch-SGD per round; the benign optimizer lives for the whole
  round, so its momentum chains across segments, while a poison segment
  starts from zero momentum (image_train.py:33, :63);
- per-internal-epoch LR row (benign constant lr; poison MultiStepLR);
- loss = α·CE + (1-α)·‖w - w_anchor‖ (image_train.py:85-90);
- the first `poisoning_per_batch` samples of each batch are poisoned;
- padded steps are exact no-ops through `valid = sum(mask) > 0`;
- the model-replacement scaling epilogue w ← w_a + γ·(w - w_a) over the
  FULL state, BN stats included (image_train.py:166-171).

One call covers ONE global epoch (one `aggr_epoch_interval` segment). A
step whose batch mask is empty for EVERY client is skipped on the host: it
is an exact no-op in the JAX program too, and the plan (numpy) says so
without a device sync.

A dropout model (LoanNet) takes the segment's keep masks as an input, one
[C, E, S, B, width] tensor per dropout layer, and each step passes its
[C, B, width] slice into the vmapped loss: nothing draws random numbers
inside vmap, so the card and the CPU compute the same step from the same
masks, and the tests can hand in the JAX package's own masks.

Under FoolsGold the step also accumulates each client's raw gradient into
per-segment `fg` accumulators (zeros at the segment start,
dba_mod_tpu/fl/client.py:93), inside the same fused launch (the kernel's
`sgd_acc` leaves, valid clients only). Without FoolsGold it passes no `fg`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from dba_mod_tpu_torch.fl.device_data import DeviceData
from dba_mod_tpu_torch.fl.state import ClientTask, RoundHyper
from dba_mod_tpu_torch.models import ModelDef, ModelVars
from dba_mod_tpu_torch.ops.fused_update import fused_step_update
from dba_mod_tpu_torch.ops.losses import cross_entropy, tree_dist_norm


class ClientMetrics(NamedTuple):
    loss_sum: torch.Tensor      # [C, E] Σ batch-mean losses
    correct: torch.Tensor       # [C, E] correct predictions
    count: torch.Tensor         # [C, E] samples seen
    poison_count: torch.Tensor  # [C, E] poisoned samples seen


class SegmentResult(NamedTuple):
    end_vars: ModelVars         # post-scaling client states [C, ...]
    benign_mom: Dict            # benign-optimizer momentum after the segment
    fg_grads: Dict              # FoolsGold: Σ of the segment's raw gradients
                                # per client ({} when FoolsGold is off)
    metrics: ClientMetrics
    batch_loss: torch.Tensor    # [C, E*S] per-batch loss ([C, 0] when off)
    batch_dist: torch.Tensor    # [C, E*S] post-step ‖w-w_anchor‖


def _per_client(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1))


def make_client_step(model_def: ModelDef, data: DeviceData,
                     hyper: RoundHyper, fg_enabled: bool = False):
    """Returns client_step(start_vars, benign_mom, task, idx [C,E,S,B],
    mask [C,E,S,B], active [E,S], dropout) -> SegmentResult. `task` holds
    device tensors; idx/mask are device tensors and `active` is the
    host-side any-client-valid map of the same plan. `dropout`: the
    segment's keep masks ([C,E,S,B,width] bool per dropout layer) for a
    dropout model, else ()."""
    use_dist = hyper.alpha_loss != 1.0

    def loss_fn(p, bn, x, y, bmask, anchor, alpha, drop):
        logits, new_bn = model_def.apply(ModelVars(p, bn), x, train=True,
                                         dropout=drop)
        ce = cross_entropy(logits, y, bmask)
        if use_dist:
            loss = alpha * ce + (1.0 - alpha) * tree_dist_norm(p, anchor)
        else:
            # every reference config sets alpha_loss=1: the distance term
            # is identically zero, so its fwd+bwd is skipped
            loss = ce
        return loss, (logits, new_bn)

    return make_segment_step(vmap(grad_and_value(loss_fn, has_aux=True)),
                             data, hyper, fg_enabled)


def make_segment_step(grad_fn, data: DeviceData, hyper: RoundHyper,
                      fg_enabled: bool):
    """The segment loop around `grad_fn(params, bn, x, y, bmask, anchor,
    alpha, drop) -> (grads, (loss [C], (logits [C, B, K], new_bn)))` over
    the stacked [C, ...] state: the vmapped step above, or the grouped
    layout's (fl/grouped_client.py). Returns the client_step of
    make_client_step's contract."""
    dist_fn = vmap(tree_dist_norm)

    def client_step(start_vars: ModelVars, benign_mom: Dict,
                    task: ClientTask, idx: torch.Tensor, mask: torch.Tensor,
                    active: np.ndarray, dropout=()) -> SegmentResult:
        C, E, S, _ = idx.shape
        dev = idx.device
        params0, bn0 = start_vars.params, start_vars.batch_stats
        params = {k: v.clone() for k, v in params0.items()}
        bn = {k: v.clone() for k, v in bn0.items()}
        is_poison_seg = task.poisoning_per_batch > 0
        mom = {k: torch.where(_per_client(is_poison_seg, v),
                              torch.zeros_like(v), v)
               for k, v in benign_mom.items()}
        fg = ({k: torch.zeros_like(v) for k, v in params.items()}
              if fg_enabled else {})
        zeros = torch.zeros((C, E), dtype=torch.float32, device=dev)
        loss_sum, correct, count, pcount = (zeros.clone() for _ in range(4))
        width = E * S if hyper.track_batches else 0
        batch_loss = torch.zeros((C, width), dtype=torch.float32, device=dev)
        batch_dist = torch.zeros((C, width), dtype=torch.float32, device=dev)
        alpha = task.alpha.to(torch.float32)

        for e in range(E):
            lr = task.lr_row[:, e].to(torch.float32).contiguous()
            for s in range(S):
                if not active[e, s]:
                    continue
                bidx, bmask = idx[:, e, s], mask[:, e, s]
                x, y = data.fetch_train(task.slot, bidx)
                x, y, sel = data.stamp(x, y, task.adv_index,
                                       task.poisoning_per_batch)
                drop = tuple(d[:, e, s] for d in dropout)
                grads, (loss, (logits, new_bn)) = grad_fn(
                    params, bn, x, y, bmask, params0, alpha, drop)
                bmaskf = bmask.to(torch.float32)
                vf = (torch.sum(bmaskf, dim=-1) > 0).to(torch.float32)
                fused_step_update(lr, vf, params, grads, mom, fg, new_bn, bn,
                                  momentum=hyper.momentum,
                                  weight_decay=hyper.weight_decay)
                preds = torch.argmax(logits, dim=-1)
                loss_sum[:, e] += vf * loss
                correct[:, e] += vf * torch.sum((preds == y) * bmaskf, -1)
                count[:, e] += vf * torch.sum(bmaskf, -1)
                pcount[:, e] += vf * torch.sum(sel * bmaskf, -1)
                if hyper.track_batches:
                    # the reference measures the distance AFTER the step
                    # (image_train.py:238)
                    batch_loss[:, e * S + s] = vf * loss
                    batch_dist[:, e * S + s] = vf * dist_fn(params, params0)

        # a poison segment leaves the benign buffers untouched
        benign_out = {k: torch.where(_per_client(is_poison_seg, v), v,
                                     mom[k])
                      for k, v in benign_mom.items()}
        scale = task.scale.to(torch.float32)

        def rescale(a, w):
            return a + _per_client(scale, w) * (w - a)

        end_vars = ModelVars(
            {k: rescale(params0[k], params[k]) for k in params},
            {k: rescale(bn0[k], bn[k]) for k in bn})
        return SegmentResult(end_vars, benign_out, fg,
                             ClientMetrics(loss_sum, correct, count, pcount),
                             batch_loss, batch_dist)

    return client_step
