"""The round engine: train + aggregate over the stacked client axis, plus
the local/global evaluation batteries (port of dba_mod_tpu/fl/rounds.py:301-,
the FedAvg path; the robust, forensic, health and grouped branches are
ROADMAP A12-A19).

A round is

  train_fn     — for each `aggr_epoch_interval` segment (global epoch) the
                 stacked client step trains all clients, chaining each
                 client's state across segments (image_train.py:50-54,
                 :306); emits Δ = w_end - w_global, per-segment metrics and
                 the parameter-delta norms;
  aggregate_fn — FedAvg over the stacked deltas, BN stats included;
  evaluations  — the per-client local battery and the global battery.

`round_fn` runs all three and returns the payload in the order the JAX
package's ``Experiment.finalize_round`` unpacks it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.fl.client import ClientMetrics, make_client_step
from dba_mod_tpu_torch.fl.device_data import DeviceData
from dba_mod_tpu_torch.fl.evaluation import (EvalResult, make_eval_fn,
                                             make_stacked_eval_fn)
from dba_mod_tpu_torch.fl.state import ClientTask, RoundHyper
from dba_mod_tpu_torch.models import ModelDef, ModelVars
from dba_mod_tpu_torch.ops import aggregation as agg
from dba_mod_tpu_torch.ops.losses import tree_global_norm


class TrainResult(NamedTuple):
    deltas: ModelVars             # stacked [C, ...]: w_end - w_global
    metrics: ClientMetrics        # [I, C, E] per segment/client/epoch
    delta_norms: torch.Tensor     # [C] ‖Δ_params‖
    batch_loss: torch.Tensor      # [I, C, E*S] ([I, C, 0] when off)
    batch_dist: torch.Tensor      # [I, C, E*S]
    seg_deltas: List[ModelVars]   # cumulative deltas at each INTERMEDIATE
                                  # segment end (empty when I == 1)


class AggregateResult(NamedTuple):
    new_vars: ModelVars
    wv: torch.Tensor              # [C] aggregation weights (robust rules)
    alpha: torch.Tensor           # [C]
    num_oracle_calls: int
    is_updated: bool


class LocalEvals(NamedTuple):
    """Per-client local-model eval rows (all [C]). clean/pre rows evaluate
    the unscaled model (image_train.py:150-164), post rows the submitted
    one (:275-282, :291-295)."""
    clean: EvalResult
    poison_pre: EvalResult
    poison_post: EvalResult
    agent_trigger: EvalResult


class GlobalEvals(NamedTuple):
    clean: EvalResult             # Mytest(global) (main.py:198-201)
    poison: EvalResult            # Mytest_poison(global) (main.py:207-215)
    per_trigger: EvalResult       # [T] rows (main.py:225-231)


@dataclasses.dataclass
class EvalPlans:
    """Device-resident eval index plans, built once per experiment."""
    clean_idx: torch.Tensor       # [S, B]
    clean_slots: torch.Tensor
    clean_mask: torch.Tensor
    poison_idx: torch.Tensor      # [S', B] — target-label samples dropped
    poison_slots: torch.Tensor
    poison_mask: torch.Tensor


def _stack(tree: Dict[str, torch.Tensor], C: int) -> Dict[str, torch.Tensor]:
    return {k: v.unsqueeze(0).expand((C,) + v.shape).clone()
            for k, v in tree.items()}


def _bc(s: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """[C] → [C, 1, ...] for per-client scalars against [C, ...]."""
    return s.reshape((s.shape[0],) + (1,) * (leaf.dim() - 1))


def _map2(fn, a: ModelVars, b: ModelVars) -> ModelVars:
    return ModelVars({k: fn(v, b.params[k]) for k, v in a.params.items()},
                     {k: fn(v, b.batch_stats[k])
                      for k, v in a.batch_stats.items()})


class RoundEngine:
    """Holds the round + eval computations for one experiment config."""

    def __init__(self, params: cfg.Params, model_def: ModelDef,
                 data: DeviceData, plans: EvalPlans, num_segments: int = 1):
        self.params = params
        self.hyper = hyper = RoundHyper.from_params(params)
        self.model_def = model_def
        self.data = data
        self.plans = plans
        self.num_segments = num_segments
        self.device = data.device
        if hyper.aggregation != cfg.AGGR_MEAN:
            raise NotImplementedError("only FedAvg is ported (ROADMAP A12)")
        self.client_step = make_client_step(model_def, data, hyper)
        self.is_poison_run = bool(params["is_poison"])
        self.do_local_eval = bool(params.get("local_eval", True))
        self.eval_clean = make_eval_fn(model_def, data, poison=False)
        self.eval_poison = make_eval_fn(model_def, data, poison=True)
        self.eval_clean_s = make_stacked_eval_fn(model_def, data,
                                                 poison=False)
        self.eval_poison_s = make_stacked_eval_fn(model_def, data,
                                                  poison=True)
        self.eval_agent_s = make_stacked_eval_fn(model_def, data, poison=True,
                                                 per_client_trigger=True)
        # Global per-trigger battery (main.py:225-231): centralized mode
        # tests each sub-pattern by index — only when
        # `centralized_test_trigger` is set (main.py:226) — distributed mode
        # tests each adversary's pattern (= its slot).
        if params.is_centralized_attack:
            n_triggers = (int(params["trigger_num"])
                          if bool(params["centralized_test_trigger"]) else 0)
        else:
            n_triggers = params.num_adversaries
        self.num_global_triggers = n_triggers

    # ------------------------------------------------------------- train
    def train_fn(self, global_vars: ModelVars, tasks_seq: List[ClientTask],
                 idx_seq: np.ndarray, mask_seq: np.ndarray) -> TrainResult:
        """tasks_seq: one host ClientTask per segment; idx/mask [I, C, E, S,
        B] numpy plans."""
        dev = self.device
        n_seg, C = idx_seq.shape[0], idx_seq.shape[1]
        start = ModelVars(_stack(global_vars.params, C),
                          _stack(global_vars.batch_stats, C))
        benign_mom = {k: torch.zeros_like(v) for k, v in start.params.items()}
        seg_metrics, seg_bloss, seg_bdist, seg_deltas = [], [], [], []
        for s in range(n_seg):
            task = tasks_seq[s].to_device(dev)
            idx = torch.from_numpy(idx_seq[s]).to(dev)
            mask = torch.from_numpy(mask_seq[s]).to(dev)
            active = mask_seq[s].any(axis=(0, 3))         # [E, S] host-side
            res = self.client_step(start, benign_mom, task, idx, mask,
                                   active)
            start = res.end_vars
            benign_mom = res.benign_mom
            seg_metrics.append(res.metrics)
            seg_bloss.append(res.batch_loss)
            seg_bdist.append(res.batch_dist)
            if s < n_seg - 1:  # intermediate states feed per-epoch evals
                seg_deltas.append(self._delta(start, global_vars))
        deltas = self._delta(start, global_vars)
        metrics = ClientMetrics(*(torch.stack(ls) for ls in
                                  zip(*seg_metrics)))
        delta_norms = torch.func.vmap(tree_global_norm)(deltas.params)
        return TrainResult(deltas, metrics, delta_norms,
                           torch.stack(seg_bloss),
                           torch.stack(seg_bdist), seg_deltas)

    @staticmethod
    def _delta(stacked: ModelVars, global_vars: ModelVars) -> ModelVars:
        return _map2(lambda e, g: e - g, stacked, global_vars)

    # --------------------------------------------------------- aggregate
    def aggregate_fn(self, global_vars: ModelVars, deltas: ModelVars,
                     gen: Optional[torch.Generator] = None,
                     noise: Optional[ModelVars] = None) -> AggregateResult:
        """FedAvg over the full state (the mean branch of the JAX
        aggregate_fn). DP noise (diff_privacy) comes from `noise` when given,
        else from `gen`."""
        hyper = self.hyper
        C = next(iter(deltas.params.values())).shape[0]
        sigma = hyper.sigma if hyper.diff_privacy else 0.0
        new_p = agg.fedavg_update(global_vars.params, deltas.params,
                                  hyper.eta, hyper.no_models, sigma,
                                  noise.params if noise else None, gen)
        new_b = agg.fedavg_update(global_vars.batch_stats,
                                  deltas.batch_stats, hyper.eta,
                                  hyper.no_models, sigma,
                                  noise.batch_stats if noise else None, gen)
        zeros = torch.zeros((C,), dtype=torch.float32, device=self.device)
        return AggregateResult(ModelVars(new_p, new_b), zeros, zeros, 1,
                               True)

    # -------------------------------------------------------- evaluation
    def _zero_evals(self, n: int) -> EvalResult:
        z = torch.zeros((n,), dtype=torch.float32, device=self.device)
        return EvalResult(z, z, z, z)

    def _stacked_battery(self, unscaled: ModelVars, scaled: ModelVars,
                         adv_slots: torch.Tensor) -> LocalEvals:
        """The per-client battery: clean on the pre-scaling model
        (image_train.py:150-155, :268-271), poison pre on it (:157-164),
        poison post + per-agent trigger on the submitted one (:275-295)."""
        pl = self.plans
        minus1 = torch.tensor(-1, device=self.device)
        clean = self.eval_clean_s(unscaled, pl.clean_idx, pl.clean_slots,
                                  pl.clean_mask, minus1)
        if self.is_poison_run:
            pre = self.eval_poison_s(unscaled, pl.poison_idx, pl.poison_slots,
                                     pl.poison_mask, minus1)
            post = self.eval_poison_s(scaled, pl.poison_idx, pl.poison_slots,
                                      pl.poison_mask, minus1)
            agent = self.eval_agent_s(scaled, pl.poison_idx, pl.poison_slots,
                                      pl.poison_mask, adv_slots)
        else:
            pre = post = agent = self._zero_evals(adv_slots.shape[0])
        return LocalEvals(clean, pre, post, agent)

    def local_evals(self, global_vars: ModelVars, deltas: ModelVars,
                    task: ClientTask, prev_deltas: ModelVars) -> LocalEvals:
        """`prev_deltas` anchors the final segment: the pre-scaling model is
        (global + prev) + (Δ - prev)/scale."""
        def unscale(g, p, d):
            return g + p + (d - p) / _bc(task.scale.to(torch.float32), d)
        unscaled = ModelVars(
            {k: unscale(g, prev_deltas.params[k], deltas.params[k])
             for k, g in global_vars.params.items()},
            {k: unscale(g, prev_deltas.batch_stats[k], deltas.batch_stats[k])
             for k, g in global_vars.batch_stats.items()})
        scaled = _map2(lambda d, g: g + d, deltas, global_vars)
        return self._stacked_battery(unscaled, scaled, task.adv_slot)

    def seg_local_evals(self, global_vars: ModelVars,
                        seg_deltas: List[ModelVars],
                        tasks_seq: List[ClientTask]) -> List[LocalEvals]:
        """Per-epoch local evals for aggr_epoch_interval > 1: the battery of
        each INTERMEDIATE segment (the final one is local_evals)."""
        outs, prev = [], None
        for s, cur in enumerate(seg_deltas):
            if prev is None:
                prev = _map2(lambda c, _: torch.zeros_like(c), cur, cur)
            task = tasks_seq[s].to_device(self.device)
            outs.append(self.local_evals(global_vars, cur, task, prev))
            prev = cur
        return outs

    def global_evals(self, model_vars: ModelVars) -> GlobalEvals:
        pl = self.plans
        minus1 = torch.tensor(-1, device=self.device)
        clean = self.eval_clean(model_vars, pl.clean_idx, pl.clean_slots,
                                pl.clean_mask, minus1)
        n = self.num_global_triggers
        if self.is_poison_run:
            poison = self.eval_poison(model_vars, pl.poison_idx,
                                      pl.poison_slots, pl.poison_mask, minus1)
            if n > 0:
                rows = [self.eval_poison(model_vars, pl.poison_idx,
                                         pl.poison_slots, pl.poison_mask,
                                         torch.tensor(t, device=self.device))
                        for t in range(n)]
                per_trigger = EvalResult(*(torch.stack(f)
                                           for f in zip(*rows)))
            else:
                per_trigger = self._zero_evals(1)
        else:
            z = torch.zeros((), dtype=torch.float32, device=self.device)
            poison = EvalResult(z, z, z, z)
            per_trigger = self._zero_evals(max(n, 1))
        return GlobalEvals(clean, poison, per_trigger)

    def backdoor_acc(self, model_vars: ModelVars) -> torch.Tensor:
        """Combined-trigger backdoor accuracy of the global model."""
        pl = self.plans
        return self.eval_poison(model_vars, pl.poison_idx, pl.poison_slots,
                                pl.poison_mask,
                                torch.tensor(-1, device=self.device)).acc

    # ------------------------------------------------------------- round
    def round_fn(self, global_vars: ModelVars, tasks_seq: List[ClientTask],
                 idx_seq: np.ndarray, mask_seq: np.ndarray,
                 gen: Optional[torch.Generator] = None):
        """train → aggregate → local evals → global evals. Returns
        (new_vars, payload); the payload slots are ordered as
        the JAX package's round program orders them: (locals, globals,
        metrics, delta_norms, wv, alpha, track_pair, is_updated, seg_locals,
        robust_stats, forensic_stats)."""
        train = self.train_fn(global_vars, tasks_seq, idx_seq, mask_seq)
        res = self.aggregate_fn(global_vars, train.deltas, gen)
        prev = (train.seg_deltas[-1] if train.seg_deltas else
                _map2(lambda d, _: torch.zeros_like(d), train.deltas,
                      train.deltas))
        task_last = tasks_seq[-1].to_device(self.device)
        locals_ = (self.local_evals(global_vars, train.deltas, task_last,
                                    prev) if self.do_local_eval else None)
        seg_l = (self.seg_local_evals(global_vars, train.seg_deltas,
                                      tasks_seq)
                 if self.do_local_eval and self.num_segments > 1 else None)
        globals_ = self.global_evals(res.new_vars)
        track_pair = ((train.batch_loss, train.batch_dist)
                      if self.hyper.track_batches else None)
        payload = (locals_, globals_, train.metrics, train.delta_norms,
                   res.wv, res.alpha, track_pair, res.is_updated, seg_l,
                   None, None)
        return res.new_vars, payload
