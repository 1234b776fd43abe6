"""Per-round client task rows and static round hyperparameters (port of
dba_mod_tpu/fl/state.py:19-149).

Every per-client branch of the reference (benign vs poison path,
image_train.py:56-191) is encoded as data, so one stacked client loop serves
all clients. ``build_client_tasks`` builds the rows on the host as numpy;
``ClientTask.to_device`` turns them into tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.ops.sgd import (loan_adaptive_poison_lr,
                                       poison_multistep_lr_array)


class ClientTask(NamedTuple):
    """Per-client round inputs; every field stacked to [C] (lr_row [C, E]).

    benign lane: poisoning_per_batch=0, alpha=1, scale=1, lr_row=lr
    poison lane: poisoning_per_batch=k, alpha=alpha_loss, scale=
    scale_weights_poison (1 when `baseline`), lr_row=poison MultiStepLR
    """
    slot: np.ndarray                 # data shard slot (LOAN state index)
    participant_id: np.ndarray       # global participant id
    adv_index: np.ndarray            # trigger bank row; -1 = combined
    adv_slot: np.ndarray             # position in adversary_list, -1 benign
    poisoning_per_batch: np.ndarray  # 0 disables poisoning
    alpha: np.ndarray                # blended-loss α (image_train.py:89)
    scale: np.ndarray                # model-replacement γ (:166-171)
    lr_row: np.ndarray               # [C, E] per-internal-epoch LR
    num_epochs: np.ndarray           # valid internal epochs (≤ E)

    def to_device(self, device: torch.device) -> "ClientTask":
        return ClientTask(*(torch.as_tensor(np.asarray(f)).to(device)
                            for f in self))


@dataclasses.dataclass(frozen=True)
class RoundHyper:
    """Static round hyperparameters (dba_mod_tpu/fl/state.py:51-84)."""
    momentum: float
    weight_decay: float
    lr: float                  # global lr: FoolsGold's apply step uses it
    eta: float
    no_models: int
    aggregation: str           # cfg.AGGR_*
    fg_use_memory: bool
    diff_privacy: bool
    sigma: float
    geom_median_maxiter: int
    max_update_norm: Optional[float] = None
    track_batches: bool = False
    alpha_loss: float = 1.0    # 1.0 ⇒ the blended-loss distance term is
                               # identically zero and is not computed
    krum_m: int = 1            # multi-Krum selection count (krum only)
    krum_f: int = 0            # assumed Byzantine count in the Krum score
    trim_beta: float = 0.1     # trimmed-mean per-coordinate trim fraction

    @classmethod
    def from_params(cls, p: cfg.Params) -> "RoundHyper":
        mun = p.get("max_update_norm")
        return cls(momentum=float(p["momentum"]),
                   weight_decay=float(p["decay"]),
                   lr=float(p["lr"]),
                   eta=float(p["eta"]), no_models=int(p["no_models"]),
                   aggregation=p.aggregation,
                   fg_use_memory=bool(p["fg_use_memory"]),
                   diff_privacy=bool(p["diff_privacy"]),
                   sigma=float(p["sigma"]),
                   geom_median_maxiter=int(p["geom_median_maxiter"]),
                   max_update_norm=(None if mun is None else float(mun)),
                   track_batches=bool(p.get("vis_train_batch_loss")
                                      or p.get("batch_track_distance")),
                   alpha_loss=float(p["alpha_loss"]),
                   krum_m=int(p.get("krum_m", 1)),
                   krum_f=int(p.get("krum_byzantine_f", 0)),
                   trim_beta=float(p.get("trimmed_mean_beta", 0.1)))


def build_client_tasks(params: cfg.Params, agent_names: list, epoch: int,
                       slots: np.ndarray, num_epochs_max: int,
                       backdoor_acc: Optional[float] = None) -> ClientTask:
    """Host-side construction of the stacked ClientTask for one round:
    adversarial index resolution (image_train.py:37-48), poison-epoch
    scheduling (:56), poison LR schedule (:59-68), the LOAN adaptive poison
    LR from the current global backdoor accuracy (loan_train.py:67-75),
    scaling/baseline flags (:148, :166). LOAN clients are keyed by their
    state's slot and step their schedule before the epoch's batches."""
    C = len(agent_names)
    is_loan = params.type == cfg.TYPE_LOAN
    is_poison_run = bool(params["is_poison"])
    baseline = bool(params["baseline"])
    lr = float(params["lr"])
    poison_lr = float(params["poison_lr"])
    if is_loan and backdoor_acc is not None:
        poison_lr = loan_adaptive_poison_lr(poison_lr, backdoor_acc,
                                            baseline)

    E = num_epochs_max
    internal_epochs = int(params["internal_epochs"])
    internal_poison = int(params["internal_poison_epochs"])
    step_lr_mult = (poison_multistep_lr_array(internal_poison,
                                              step_before=is_loan)
                    if bool(params["poison_step_lr"])
                    else np.ones((internal_poison,), np.float32))

    adv_idx = np.full((C,), -1, np.int32)
    adv_slot = np.full((C,), -1, np.int32)
    ppb = np.zeros((C,), np.int32)
    alpha = np.ones((C,), np.float32)
    scale = np.ones((C,), np.float32)
    lr_rows = np.full((C, E), lr, np.float32)
    n_epochs = np.full((C,), internal_epochs, np.int32)
    pids = np.zeros((C,), np.int32)

    for c, name in enumerate(agent_names):
        pids[c] = int(slots[c]) if is_loan else int(name)
        slot_of = params.adversary_slot_of(name)
        adv_slot[c] = slot_of
        poisoning_now = (is_poison_run and slot_of >= 0 and
                         epoch in params.poison_epochs_for(slot_of))
        if poisoning_now:
            adv_idx[c] = params.adversarial_index_of(name)
            ppb[c] = int(params["poisoning_per_batch"])
            alpha[c] = float(params["alpha_loss"])
            scale[c] = 1.0 if baseline else float(
                params["scale_weights_poison"])
            n_epochs[c] = internal_poison
            row = poison_lr * step_lr_mult
            lr_rows[c, :] = 0.0
            lr_rows[c, :min(E, internal_poison)] = row[:E]
    return ClientTask(slot=slots.astype(np.int32), participant_id=pids,
                      adv_index=adv_idx, adv_slot=adv_slot,
                      poisoning_per_batch=ppb, alpha=alpha,
                      scale=scale, lr_row=lr_rows, num_epochs=n_epochs)
