"""The evaluation battery — equivalents of reference test.py (port of
dba_mod_tpu/fl/evaluation.py:84-168).

- `Mytest` (test.py:7-51)                     → evaluate(poison=False)
- `Mytest_poison` (test.py:54-115)            → evaluate(poison=True, adv=-1)
- `Mytest_poison_trigger` (test.py:118-177)   → evaluate(poison=True, adv=j)
- `Mytest_poison_agent_trigger` (:180-239)    → stacked, per_client_trigger

Loss is a reduction='sum' divided by the count (test.py:21-22, :40);
poisoned accuracy divides by the valid-sample count, since evaluation
poisons every sample; the poisoned eval set drops target-label images
(image_helper.py:148-172), expressed in the eval plan's index set.

The stacked battery evaluates C client models over ONE shared plan: each
test batch is fetched (and, unless `per_client_trigger`, stamped) once and
only the forward passes are batched over clients (``torch.func.vmap``).

Under ``overlap_eval`` a round's batteries run on a second CUDA stream of
the same card (:func:`pick_eval_stream`, :func:`place_eval_inputs`), while
the next round trains on the main stream; :func:`instrument_eval` gives
each battery a synced telemetry span.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.func import vmap

from dba_mod_tpu_torch.fl.device_data import DeviceData
from dba_mod_tpu_torch.models import ModelDef, ModelVars
from dba_mod_tpu_torch.ops.losses import cross_entropy_sum
from dba_mod_tpu_torch.utils import telemetry


class EvalResult(NamedTuple):
    loss: torch.Tensor      # average loss (sum / count)
    acc: torch.Tensor       # percentage
    correct: torch.Tensor
    count: torch.Tensor     # dataset_size / poison_data_count


def instrument_eval(fn, name: str, batches: int = 0):
    """Telemetry wrapper for an eval battery: each call runs under a span
    ending at a device sync (the un-synced call time is only the launch),
    and counts `batches` test batches into ``eval/batches``. A passthrough
    while telemetry is off, so the batteries keep deferring their sync to
    the round's finalize and round pipelining is unaffected."""
    return telemetry.instrument(fn, name, batches=batches)


def pick_eval_stream(device: torch.device, overlap: bool,
                     mesh=None) -> Optional[torch.cuda.Stream]:
    """The stream the overlap_eval batteries run on: a second CUDA stream
    of the round's card, so round N's batteries run beside round N+1's
    training on the main stream. None (the current stream) without
    overlap, on the CPU, and with a clients mesh (the batteries stay on the
    mesh, as the JAX package's do: fl/evaluation.py::pick_eval_device)."""
    if not overlap or device.type != "cuda" or mesh is not None:
        return None
    return torch.cuda.Stream(device)


def place_eval_inputs(operands: Any, stream: Optional[torch.cuda.Stream]
                      ) -> Any:
    """Order the eval stream after everything the main stream has queued,
    which includes the round that produced `operands` (the superseded
    round's snapshots: the pre-round model, the pre-fault deltas, the new
    model). The caller holds `operands` until the batteries' host copy has
    landed, so the caching allocator cannot hand their memory to the next
    round while the eval stream still reads it. A passthrough without a
    stream."""
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(stream.device))
    return operands


def _finish(loss_sum, correct, count) -> EvalResult:
    safe = torch.clamp_min(count, 1.0)
    return EvalResult(loss=loss_sum / safe, acc=100.0 * correct / safe,
                      correct=correct, count=count)


def make_eval_fn(model_def: ModelDef, data: DeviceData, poison: bool):
    """evaluate(model_vars, idx[S,B], slots[S,B], mask[S,B], adv_index)
    -> EvalResult of scalars. `poison` stamps every sample with trigger
    `adv_index` and swaps labels (test.py:95, evaluation=True)."""

    @torch.no_grad()
    def evaluate(model_vars: ModelVars, idx, slots, mask,
                 adv_index) -> EvalResult:
        dev = idx.device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        correct = torch.zeros((), dtype=torch.float32, device=dev)
        count = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(idx.shape[0]):
            bmask = mask[s]
            x, y = data.fetch_test(slots[s], idx[s])
            if poison:
                x, y, _ = data.stamp(x, y, adv_index, None, poison_all=True)
            logits, _ = model_def.apply(model_vars, x, train=False)
            bmaskf = bmask.to(torch.float32)
            loss_sum = loss_sum + cross_entropy_sum(logits, y, bmask)
            preds = torch.argmax(logits, dim=-1)
            correct = correct + torch.sum((preds == y) * bmaskf)
            count = count + torch.sum(bmaskf)
        return _finish(loss_sum, correct, count)

    return evaluate


def make_stacked_eval_fn(model_def: ModelDef, data: DeviceData, poison: bool,
                         per_client_trigger: bool = False):
    """evaluate_stacked(stacked_vars [C, ...], idx[S,B], slots[S,B],
    mask[S,B], adv) -> EvalResult with [C] leaves. `per_client_trigger` is
    the Mytest_poison_agent_trigger variant (test.py:180-239): `adv` is [C]
    and each model is evaluated against its own trigger."""

    def per_model(mv: ModelVars, x, y, bmaskf):
        logits, _ = model_def.apply(mv, x, train=False)
        loss = cross_entropy_sum(logits, y, bmaskf)
        preds = torch.argmax(logits, dim=-1)
        return loss, torch.sum((preds == y) * bmaskf), torch.sum(bmaskf)

    shared = vmap(per_model, in_dims=(0, None, None, None))
    own = vmap(per_model, in_dims=(0, 0, 0, None))

    @torch.no_grad()
    def evaluate_stacked(stacked_vars: ModelVars, idx, slots, mask,
                         adv) -> EvalResult:
        C = next(iter(stacked_vars.params.values())).shape[0]
        dev = idx.device
        loss_sum = torch.zeros((C,), dtype=torch.float32, device=dev)
        correct = torch.zeros((C,), dtype=torch.float32, device=dev)
        count = torch.zeros((C,), dtype=torch.float32, device=dev)
        for s in range(idx.shape[0]):
            x, y = data.fetch_test(slots[s], idx[s])   # ONE gather, shared
            bmaskf = mask[s].to(torch.float32)
            if poison and per_client_trigger:
                xc = x.unsqueeze(0).expand((C,) + x.shape)
                yc = y.unsqueeze(0).expand((C,) + y.shape)
                xc, yc, _ = data.stamp(xc, yc, adv, None, poison_all=True)
                dl, dc, dn = own(stacked_vars, xc, yc, bmaskf)
            else:
                if poison:
                    x, y, _ = data.stamp(x, y, adv, None, poison_all=True)
                dl, dc, dn = shared(stacked_vars, x, y, bmaskf)
            loss_sum = loss_sum + dl
            correct = correct + dc
            count = count + dn
        return _finish(loss_sum, correct, count)

    return evaluate_stacked
