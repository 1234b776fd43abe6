"""The round engine: train + aggregate over the stacked client axis, plus
the local/global evaluation batteries, the defense forensics and the
post-merge health sentinel (port of dba_mod_tpu/fl/rounds.py).

A round is

  train_fn     — for each `aggr_epoch_interval` segment (global epoch) the
                 stacked client step trains all clients, chaining each
                 client's state across segments (image_train.py:50-54,
                 :306); emits Δ = w_end - w_global, the FoolsGold gradient
                 accumulators, per-segment metrics and the delta norms;
  [faults → screen] — on the robust path (fault_injection or
                 screen_updates): the round's fault plan perturbs what the
                 server receives, and the quarantine pass turns the payloads
                 into a survivor mask;
  aggregate_fn — the configured rule over the stacked deltas (FedAvg, RFA,
                 Krum, trimmed mean, median over the full state, BN stats
                 included; FoolsGold over the accumulators, params only);
  evaluations  — the per-client local battery and the global battery.

The client step is fl/client.py's vmapped one, or with ``grouped_clients``
fl/grouped_client.py's grouped layout (BasicBlock ResNets only). With
``sequential_debug`` the round trains its clients one at a time through
width-1 ``train_fn`` calls (:meth:`RoundEngine.train_sequential`) and
stitches the results back together.

With a clients mesh (parallel/mesh.py) the round is sharded: each shard
trains its contiguous slice of the clients on its own device with the same
vmapped segment step (one fused update launch per shard per step; the
shards of distinct cards run on a thread each, so the cards train at
once), runs its clients' local battery there, and the per-client stacks
(deltas, FoolsGold accumulators, metrics, local-battery rows) are
gathered onto the mesh's first device — and, in a multi-process world,
all-gathered across ranks (parallel/distributed.py::gather_clients). The
server rule then runs unchanged on the full stack (the reduction order of
one device, so the rules have no sharded twin), and the global battery
runs on the replicated global model.

`round_fn` runs them all and returns the payload in the order the JAX
package's ``Experiment.finalize_round`` unpacks it, with RobustStats (or
None) in slot 9 and ForensicStats (``forensics: true``; None otherwise) in
the last slot. It is the composition of :meth:`RoundEngine.core_fn` (the
round minus its eval tail, which ``overlap_eval`` runs on the main stream)
and :meth:`RoundEngine.eval_batteries` (which it runs on a second stream);
each battery is a synced ``eval/*`` telemetry span when telemetry is on.
The forensics are computed on the device and come to the
host in the round's one transfer at finalize, with no sync of their own.
:class:`HealthSentinel` (``model_health_check``) checks a merged model
with one scalar host read per check.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import types
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.fl import faults as flt
from dba_mod_tpu_torch.fl.client import ClientMetrics, make_client_step
from dba_mod_tpu_torch.fl.device_data import DeviceData
from dba_mod_tpu_torch.fl.evaluation import (EvalResult, instrument_eval,
                                             make_eval_fn,
                                             make_stacked_eval_fn)
from dba_mod_tpu_torch.fl.grouped_client import make_grouped_client_step
from dba_mod_tpu_torch.fl.state import ClientTask, RoundHyper
from dba_mod_tpu_torch.models import ModelDef, ModelVars
from dba_mod_tpu_torch.models.grouped import supports_grouped
from dba_mod_tpu_torch.ops import aggregation as agg
from dba_mod_tpu_torch.ops.losses import tree_global_norm
from dba_mod_tpu_torch.utils import telemetry
from dba_mod_tpu_torch.utils.device import to_device


def count_bn_layers(batch_stats: Dict[str, torch.Tensor]) -> int:
    """Number of BatchNorm layers = number of `running_mean` entries. Each
    BN layer of the reference's state_dict carries one `num_batches_tracked`
    counter, and RFA's Weiszfeld distance sums over every state entry
    (helper.py:376-381), so the counter term enters once per BN layer."""
    return sum(1 for k in batch_stats if k.endswith("running_mean"))


def nbt_client_deltas(mask_seq: np.ndarray, scale_seq: np.ndarray
                      ) -> np.ndarray:
    """Per-client `num_batches_tracked` deltas of one round, [C] float32:
    torch BN counts one per real (non-padded) train batch, and the
    model-replacement epilogue scales the counter with the state and
    truncates it into int64 (image_train.py:166-171), once per segment:
    Σ_seg trunc(steps_seg · γ_seg). mask_seq: [S, C, E, steps, B];
    scale_seq: [S, C]."""
    steps = np.sum(np.any(mask_seq, axis=-1), axis=(2, 3))     # [S, C]
    return np.sum(np.trunc(steps.astype(np.float32)
                           * np.asarray(scale_seq, np.float32)),
                  axis=0).astype(np.float32)


class TrainResult(NamedTuple):
    deltas: ModelVars             # stacked [C, ...]: w_end - w_global
    fg_grads: Dict                # [C, ...] raw grads summed over the round
                                  # ({} when FoolsGold is off)
    fg_feature: Optional[torch.Tensor]  # [C, L] the similarity layer's part
                                  # of fg_grads, flattened (None when off)
    metrics: ClientMetrics        # [I, C, E] per segment/client/epoch
    delta_norms: torch.Tensor     # [C] ‖Δ_params‖
    batch_loss: torch.Tensor      # [I, C, E*S] ([I, C, 0] when off)
    batch_dist: torch.Tensor      # [I, C, E*S]
    seg_deltas: List[ModelVars]   # cumulative deltas at each INTERMEDIATE
                                  # segment end (empty when I == 1)
    # a sharded round's local battery, run by each shard on its clients:
    # (LocalEvals or None, [LocalEvals] of the intermediate segments or
    # None); None on the unsharded path, whose battery runs after the core
    local_rows: Optional[Tuple[Any, Any]] = None


class AggregateResult(NamedTuple):
    new_vars: ModelVars
    new_fg_state: Optional[agg.FoolsGoldState]
    wv: torch.Tensor              # [C] aggregation weights (robust rules)
    alpha: torch.Tensor           # [C] RFA distances / FoolsGold alphas /
                                  # Krum scores
    num_oracle_calls: Any         # RFA's Weiszfeld count (1 otherwise)
    is_updated: Any               # False iff RFA's max_update_norm rejected


class RobustStats(NamedTuple):
    """Per-round fault-tolerance outcome (None in the payload when the
    fault layer and the screen are off)."""
    n_dropped: torch.Tensor       # injected dropouts (never reported)
    n_quarantined: torch.Tensor   # reported but failed the screen
    n_surviving: torch.Tensor     # survivors among counted clients
    degraded: torch.Tensor        # bool: aggregation skipped (< min)
    global_finite: torch.Tensor   # bool: post-aggregation model finite
    survivor_mask: torch.Tensor   # [C] bool


class ForensicStats(NamedTuple):
    """Per-client defense-forensics diagnostics, computed on the device
    when `forensics: true` (None in the payload otherwise)."""
    recv_norms: torch.Tensor      # [C] ‖Δ_params‖ as RECEIVED by the server
                                  # (post fault injection; NaN/Inf for a
                                  # corrupted payload, honestly)
    cosine_to_agg: torch.Tensor   # [C] cos(received Δ_c, applied update)
    verdict: torch.Tensor         # [C] bool: client entered the aggregate
    reason: torch.Tensor          # [C] int32 quarantine reason (REASON_*)
    oracle_calls: torch.Tensor    # int32: RFA's Weiszfeld count (1 else)


# quarantine-reason codes carried in ForensicStats.reason
REASON_OK = 0           # aggregated
REASON_DROPPED = 1      # never reported (injected dropout)
REASON_NONFINITE = 2    # failed the finite screen
REASON_NORM = 3         # exceeded the norm-screen threshold
REASON_NAMES = {REASON_OK: "ok", REASON_DROPPED: "dropped",
                REASON_NONFINITE: "nonfinite", REASON_NORM: "norm_exceeded"}


def forensic_stats(global_vars: ModelVars, new_vars: ModelVars,
                   recv_deltas: ModelVars, survivor_mask: torch.Tensor,
                   reason: torch.Tensor, oracle_calls) -> ForensicStats:
    """The per-client forensics (dba_mod_tpu/fl/rounds.py:129-151):
    `recv_deltas` are what the server received (post-fault); each is
    compared by cosine with the update the server APPLIED (new - old
    params), which works the same under every rule (and gives 0 for a
    degraded round, whose update is zero). A NaN-corrupted row gives a NaN
    norm/cosine for that client only."""
    recv_norms = torch.func.vmap(tree_global_norm)(recv_deltas.params)
    pts = agg.flatten_stacked(recv_deltas.params)              # [C, P]
    upd = torch.cat([(new_vars.params[k] - global_vars.params[k]).reshape(-1)
                     for k in recv_deltas.params])             # [P]
    unorm = torch.sqrt(torch.sum(upd * upd))
    denom = torch.clamp_min(recv_norms * unorm, 1e-12)
    cos = (pts @ upd) / denom
    calls = (oracle_calls.to(torch.int32)
             if isinstance(oracle_calls, torch.Tensor)
             else torch.full((), int(oracle_calls), dtype=torch.int32,
                             device=recv_norms.device))
    return ForensicStats(recv_norms, cos, survivor_mask,
                         reason.to(torch.int32), calls)


def model_health_stats(old_vars: ModelVars, new_vars: ModelVars
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device half of the health sentinel (dba_mod_tpu/fl/rounds.py:
    191-205): (every leaf of the committed model finite, global L2 norm of
    the applied update over the full state), one pass over the tree."""
    old, new = _merged(old_vars), _merged(new_vars)
    dev = next(iter(new.values())).device
    finite = torch.ones((), dtype=torch.bool, device=dev)
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for k, n in new.items():
        if not n.is_floating_point():
            continue
        finite = finite & torch.all(torch.isfinite(n))
        d = (n - old[k]).to(torch.float32)
        sq = sq + torch.sum(d * d)
    return finite, torch.sqrt(sq)


class HealthSentinel:
    """Post-merge model-health gate (``model_health_check``; the JAX
    package's HealthSentinel, dba_mod_tpu/fl/rounds.py:208-261). An
    unhealthy merge is one whose committed model has a non-finite leaf,
    or — once ``warmup`` healthy merges have seeded the trailing EMA —
    whose update norm exceeds ``band`` × that EMA (``health_norm_band``; 0
    keeps only the finite check). Healthy commits feed the EMA and a
    last-good ring of up to ``ring_size`` model versions;
    ``rollback_target`` hands back the newest ring entry, or the caller's
    pre-merge fallback when the ring is off or empty. The ring lives in
    memory only; (ema, merges) ride the resume sidecar through
    state()/load_state(), so the band re-arms as it would have."""

    def __init__(self, band: float, ema_alpha: float, warmup: int,
                 ring_size: int):
        self.band = float(band)
        self.alpha = float(ema_alpha)
        self.warmup = int(warmup)
        self.ring_size = int(ring_size)
        self.ema = 0.0
        self.merges = 0
        self.ring: List[Tuple[int, Any]] = []  # (version, model vars)

    def check(self, old_vars: ModelVars, new_vars: ModelVars
              ) -> Tuple[bool, float]:
        """(healthy, update_norm) for one candidate merge — one host
        read."""
        finite, norm = model_health_stats(old_vars, new_vars)
        finite, norm = torch.stack((finite.to(norm.dtype), norm)).tolist()
        healthy = bool(finite)
        if (healthy and self.band > 0 and self.merges >= max(1, self.warmup)
                and self.ema > 0):
            healthy = norm <= self.band * self.ema
        return healthy, norm

    def commit(self, version: int, new_vars: ModelVars, norm: float) -> None:
        """Record one healthy committed merge: advance the EMA and push the
        model onto the last-good ring."""
        self.merges += 1
        self.ema = (norm if self.merges == 1
                    else self.alpha * norm + (1.0 - self.alpha) * self.ema)
        if self.ring_size > 0:
            self.ring.append((int(version), new_vars))
            if len(self.ring) > self.ring_size:
                self.ring.pop(0)

    def rollback_target(self, fallback: ModelVars) -> ModelVars:
        return self.ring[-1][1] if self.ring else fallback

    def state(self) -> Dict[str, Any]:
        return {"ema": float(self.ema), "merges": int(self.merges)}

    def load_state(self, st: Optional[Dict[str, Any]]) -> None:
        if st:
            self.ema = float(st.get("ema", 0.0))
            self.merges = int(st.get("merges", 0))


def _merged(mv: ModelVars) -> Dict[str, torch.Tensor]:
    """The full state as one flat dict (param and BN keys are disjoint)."""
    return {**mv.params, **mv.batch_stats}


def _per_client_finite(tree: Any) -> torch.Tensor:
    """[C] bool: every entry of each client's row is finite. `tree`: a
    ModelVars or a dict of stacked tensors."""
    leaves = (_merged(tree) if isinstance(tree, ModelVars) else tree).values()
    flags = None
    for l in leaves:
        f = torch.all(torch.isfinite(l.to(torch.float32)).reshape(
            l.shape[0], -1), dim=1)
        flags = f if flags is None else flags & f
    return flags


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """numpy's nanmedian of a vector: NaNs dropped, an even count averages
    the two central values (torch.nanmedian returns the lower one); NaN
    when nothing is left."""
    ok = ~torch.isnan(x)
    n = torch.sum(ok)
    s = torch.sort(torch.where(ok, x, torch.full_like(x, float("inf")))
                   ).values
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.div(n, 2, rounding_mode="floor").clamp(max=x.shape[0] - 1)
    med = 0.5 * (s[lo] + s[hi])
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def screen_client_updates(deltas: ModelVars, reported: torch.Tensor,
                          counted: torch.Tensor, norm_mult: float,
                          extra_trees=()):
    """The server's quarantine pass (dba_mod_tpu/fl/rounds.py:154-189).

    finite — every entry of the delta (and of `extra_trees`, e.g. the
             FoolsGold accumulators) must be finite;
    norm   — ‖Δ_params‖ must not exceed `norm_mult` × the median norm of
             the reported, finite, counted clients; `norm_mult` <= 0 turns
             the norm screen off.

    Returns (survivor_mask [C] bool, norms [C]). A client that never
    reported is excluded whatever the screens say."""
    finite = _per_client_finite(deltas)
    for t in extra_trees:
        finite = finite & _per_client_finite(t)
    norms = torch.func.vmap(tree_global_norm)(deltas.params)
    valid = reported & finite & counted
    med = _nanmedian(torch.where(valid, norms,
                                 torch.full_like(norms, float("nan"))))
    thresh = (norm_mult * med if norm_mult > 0
              else torch.full_like(med, float("inf")))
    return reported & finite & (norms <= thresh), norms


def _split(flat: Dict[str, torch.Tensor], like: ModelVars) -> ModelVars:
    return ModelVars({k: flat[k] for k in like.params},
                     {k: flat[k] for k in like.batch_stats})


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


def aggregate(hyper: RoundHyper, global_vars: ModelVars, deltas: ModelVars,
              gen: Optional[torch.Generator] = None,
              noise: Optional[ModelVars] = None, *,
              fg_state: Optional[agg.FoolsGoldState] = None,
              fg_grads: Optional[Dict] = None,
              fg_feature: Optional[torch.Tensor] = None,
              participant_ids: Optional[torch.Tensor] = None,
              num_samples: Optional[torch.Tensor] = None,
              nbt_deltas: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              counted: Optional[torch.Tensor] = None) -> AggregateResult:
    """The configured rule over the stacked deltas (the branches of the JAX
    package's aggregate_fn). DP noise (diff_privacy) comes from `noise`
    when given, else from `gen`. `mask` ([C] float, optional): the survivor
    mask of the quarantine pass, routed to the rules' masked forms; None is
    the dense path. FoolsGold needs fg_state, fg_grads, fg_feature and
    participant_ids; RFA and masked FedAvg need num_samples (RFA also
    nbt_deltas for the BN counters). `counted` ([C] bool): the lanes masked
    FedAvg's divisor counts, `num_samples > 0` when None; the async merge
    counts every buffer lane, so its divisor is the occupied survivors."""
    leaf = next(iter(deltas.params.values()))
    sigma = hyper.sigma if hyper.diff_privacy else 0.0
    zeros = torch.zeros((leaf.shape[0],), dtype=torch.float32,
                        device=leaf.device)
    wv, alpha, calls, is_updated, new_fg = zeros, zeros, 1, True, fg_state
    rule = hyper.aggregation
    if rule == cfg.AGGR_MEAN:
        if mask is not None and counted is None:
            counted = num_samples > 0

        def fedavg(g, d, nz):
            if mask is None:
                return agg.fedavg_update(g, d, hyper.eta, hyper.no_models,
                                         sigma, nz, gen)
            return agg.fedavg_update_masked(
                g, d, hyper.eta, hyper.no_models, mask, counted, sigma, nz,
                gen)
        new_vars = ModelVars(
            fedavg(global_vars.params, deltas.params,
                   noise.params if noise else None),
            fedavg(global_vars.batch_stats, deltas.batch_stats,
                   noise.batch_stats if noise else None))
    elif rule == cfg.AGGR_FOOLSGOLD:
        r = agg.foolsgold_update(
            global_vars.params, fg_grads, fg_feature, participant_ids,
            fg_state, hyper.eta, hyper.lr, hyper.momentum,
            hyper.weight_decay, use_memory=hyper.fg_use_memory,
            mask=mask)
        # BN stats are not aggregated by FoolsGold (the reference steps
        # an optimizer over named_parameters only, helper.py:286-290)
        new_vars = ModelVars(r.new_params, global_vars.batch_stats)
        new_fg, wv, alpha = r.new_fg_state, r.wv, r.alpha
    else:
        state, stacked = _merged(global_vars), _merged(deltas)
        nz = _merged(noise) if noise else None
        if rule == cfg.AGGR_GEO_MED:
            r = agg.geometric_median_update(
                state, stacked, num_samples, hyper.eta,
                maxiter=hyper.geom_median_maxiter,
                max_update_norm=hyper.max_update_norm, dp_sigma=sigma,
                noise=nz, gen=gen, nbt_deltas=nbt_deltas,
                n_bn=count_bn_layers(global_vars.batch_stats),
                mask=mask)
            calls, is_updated = r.num_oracle_calls, r.is_updated
            wv, alpha = r.wv, r.distances
        elif rule == cfg.AGGR_KRUM:
            r = agg.krum_update(state, stacked, hyper.eta, hyper.krum_m,
                                hyper.krum_f, mask=mask, dp_sigma=sigma,
                                noise=nz, gen=gen)
            # alpha records the Krum scores, clipped into a plottable
            # range (excluded clients' sentinels are ~1e35)
            wv, alpha = r.wv, torch.clamp(r.scores, max=1e30)
        elif rule == cfg.AGGR_TRIMMED_MEAN:
            r = agg.trimmed_mean_update(state, stacked, hyper.eta,
                                        hyper.trim_beta, mask=mask,
                                        dp_sigma=sigma, noise=nz, gen=gen)
            wv = r.wv
        elif rule == cfg.AGGR_MEDIAN:
            r = agg.coordinate_median_update(state, stacked, hyper.eta,
                                             mask=mask, dp_sigma=sigma,
                                             noise=nz, gen=gen)
            wv = r.wv
        else:
            raise ValueError(f"unknown aggregation rule {rule!r}")
        new_vars = _split(r.new_state, global_vars)
    return AggregateResult(new_vars, new_fg, wv, alpha, calls,
                           is_updated)


class RoundEngine:
    """Holds the round + eval computations for one experiment config."""

    def __init__(self, params: cfg.Params, model_def: ModelDef,
                 data: DeviceData, plans: EvalPlans, num_segments: int = 1,
                 mesh=None, shard_data: Optional[Dict] = None):
        """`mesh`: a parallel.mesh.ClientsMesh to shard the clients axis
        over (None: unsharded); `shard_data`: {device: DeviceData} for the
        mesh's devices other than `data`'s."""
        with telemetry.span("engine/build"):
            self._build(params, model_def, data, plans, num_segments, mesh,
                        shard_data or {})

    def _build(self, params: cfg.Params, model_def: ModelDef,
               data: DeviceData, plans: EvalPlans, num_segments: int,
               mesh, shard_data: Dict):
        self.params = params
        self.mesh = mesh
        # a watchdog zone around host-blocking collectives (the
        # experiment's guard.watch; a null context when unset)
        self.watch = lambda label: contextlib.nullcontext()
        self._shard_data = shard_data
        self._kits: Dict[torch.device, Any] = {}
        self.hyper = hyper = RoundHyper.from_params(params)
        self.model_def = model_def
        self.data = data
        self.plans = plans
        self.num_segments = num_segments
        self.device = data.device
        self.fg_enabled = hyper.aggregation == cfg.AGGR_FOOLSGOLD
        # the grouped client layout (models/grouped.py): default off; it
        # folds the clients axis into the features, so it cannot be sharded
        self.use_grouped = bool(params.get("grouped_clients", False))
        if self.use_grouped and not (supports_grouped(model_def)
                                     and mesh is None):
            raise ValueError(
                "grouped_clients=true requires a BasicBlock-ResNet "
                "model and an unsharded clients axis")
        make_step = (make_grouped_client_step if self.use_grouped
                     else make_client_step)
        self.client_step = make_step(model_def, data, hyper, self.fg_enabled)
        self.sequential = bool(params.get("sequential_debug", False))
        # the fault layer (fl/faults.py and the quarantine pass): with
        # fault_injection and the screen both off the robust path never runs
        self.fault_cfg = flt.FaultConfig.from_params(params)
        screen = params.get("screen_updates", "auto")
        self.screening = (self.fault_cfg.enabled if screen == "auto"
                          else bool(screen))
        self.robust = self.fault_cfg.enabled or self.screening
        self.min_surviving = max(1, int(params.get("min_surviving_clients",
                                                   1)))
        self.base_norm_mult = float(params.get("screen_norm_mult", 0.0))
        self.is_poison_run = bool(params["is_poison"])
        self.do_local_eval = bool(params.get("local_eval", True))
        # defense forensics: when off the payload's last slot stays None
        # and no forensic work runs
        self.forensics = bool(params.get("forensics", False))
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
        # each battery a synced telemetry span (a passthrough while
        # telemetry is off); `batches` counts the test batches it fetches
        clean = int(plans.clean_idx.shape[0])
        poison = int(plans.poison_idx.shape[0])
        local_b = clean + (3 * poison if self.is_poison_run else 0)
        global_b = clean + ((1 + n_triggers) * poison
                            if self.is_poison_run else 0)
        self._local_battery = instrument_eval(self._local_evals,
                                              "eval/local", local_b)
        self._seg_battery = instrument_eval(
            self._seg_local_evals, "eval/seg_local",
            (num_segments - 1) * local_b)
        self._global_battery = instrument_eval(self._global_evals,
                                               "eval/global", global_b)
        self._probe = instrument_eval(self._backdoor_acc,
                                      "eval/backdoor_probe", poison)
        self._kits[self.device] = types.SimpleNamespace(
            step=self.client_step, plans=plans, clean=self.eval_clean_s,
            poison=self.eval_poison_s, agent=self.eval_agent_s)

    def _kit(self, dev: torch.device):
        """A shard device's client step, stacked eval functions and eval
        plans (built at the device's first use; the engine's own device's
        are the engine's)."""
        if dev not in self._kits:
            data = self._shard_data[dev]
            md, pl = self.model_def, self.plans
            self._kits[dev] = types.SimpleNamespace(
                step=make_client_step(md, data, self.hyper, self.fg_enabled),
                plans=EvalPlans(*(getattr(pl, f.name).to(dev) for f in
                                  dataclasses.fields(EvalPlans))),
                clean=make_stacked_eval_fn(md, data, poison=False),
                poison=make_stacked_eval_fn(md, data, poison=True),
                agent=make_stacked_eval_fn(md, data, poison=True,
                                           per_client_trigger=True))
        return self._kits[dev]

    # ------------------------------------------------------------- train
    def train_fn(self, global_vars: ModelVars, tasks_seq: List[ClientTask],
                 idx_seq: np.ndarray, mask_seq: np.ndarray,
                 dropout_seq: Optional[List[tuple]] = None) -> TrainResult:
        """tasks_seq: one host ClientTask per segment; idx/mask [I, C, E, S,
        B] numpy plans; dropout_seq: a dropout model's keep masks, one tuple
        of [C, E, S, B, width] bool tensors per segment (moved to the
        device once per segment). With a mesh the clients are sharded
        (:meth:`train_sharded`)."""
        if self.model_def.has_dropout and dropout_seq is None:
            raise ValueError(f"{self.model_def.name}: train_fn needs the "
                             f"round's dropout masks")
        if self.mesh is not None:
            return self.train_sharded(global_vars, tasks_seq, idx_seq,
                                      mask_seq, dropout_seq)
        dev = self.device
        return self._train_stack(
            self.client_step, dev, global_vars, tasks_seq,
            [to_device(i, dev) for i in idx_seq],
            [to_device(m, dev) for m in mask_seq],
            [m.any(axis=(0, 3)) for m in mask_seq], dropout_seq)

    def _train_stack(self, step, dev: torch.device, global_vars: ModelVars,
                     tasks_seq: List[ClientTask], idx_seq, mask_seq,
                     active_seq, dropout_seq) -> TrainResult:
        """The segment loop over one stack of clients on `dev`: idx/mask
        per segment on the device, `active_seq` per segment [E, S] host
        bool."""
        n_seg, C = len(idx_seq), int(idx_seq[0].shape[0])
        start = ModelVars(_stack(global_vars.params, C),
                          _stack(global_vars.batch_stats, C))
        benign_mom = {k: torch.zeros_like(v) for k, v in start.params.items()}
        fg_total = ({k: torch.zeros_like(v) for k, v in start.params.items()}
                    if self.fg_enabled else {})
        seg_metrics, seg_bloss, seg_bdist, seg_deltas = [], [], [], []
        for s in range(n_seg):
            task = tasks_seq[s].to_device(dev)
            drop = (tuple(to_device(d, dev) for d in dropout_seq[s])
                    if self.model_def.has_dropout else ())
            res = step(start, benign_mom, task, idx_seq[s], mask_seq[s],
                       active_seq[s], drop)
            start = res.end_vars
            benign_mom = res.benign_mom
            fg_total = {k: v + res.fg_grads[k] for k, v in fg_total.items()}
            seg_metrics.append(res.metrics)
            seg_bloss.append(res.batch_loss)
            seg_bdist.append(res.batch_dist)
            if s < n_seg - 1:  # intermediate states feed per-epoch evals
                seg_deltas.append(self._delta(start, global_vars))
        deltas = self._delta(start, global_vars)
        metrics = ClientMetrics(*(torch.stack(ls) for ls in
                                  zip(*seg_metrics)))
        delta_norms = torch.func.vmap(tree_global_norm)(deltas.params)
        fg_feature = (self.model_def.similarity_param(fg_total).reshape(C, -1)
                      if self.fg_enabled else None)
        return TrainResult(deltas, fg_total, fg_feature, metrics, delta_norms,
                           torch.stack(seg_bloss),
                           torch.stack(seg_bdist), seg_deltas)

    def train_sharded(self, global_vars: ModelVars,
                      tasks_seq: List[ClientTask], idx_seq: np.ndarray,
                      mask_seq: np.ndarray,
                      dropout_seq: Optional[List[tuple]] = None
                      ) -> TrainResult:
        """The clients sharded over the mesh: each shard trains its slice
        on its device and runs its clients' local battery there (distinct
        cards from a thread each, :func:`_per_device`), then the per-client
        stacks are gathered onto the mesh's first device and, across ranks,
        through one all-gather. Returns the full-stack TrainResult with the
        local battery's rows in ``local_rows``."""
        from dba_mod_tpu_torch.parallel.mesh import (replicate_for_mesh,
                                                     shard_round_inputs)
        mesh = self.mesh
        first = mesh.first
        reps = replicate_for_mesh(mesh, global_vars)
        shards = shard_round_inputs(mesh, tasks_seq, idx_seq, mask_seq)
        for sh in shards:               # built here, not in the threads
            self._kit(sh.device)

        def run(sh) -> TrainResult:
            kit = self._kits[sh.device]
            gv = reps[sh.device]
            drop = (None if dropout_seq is None else
                    [tuple(d[sh.lo:sh.hi] for d in seg)
                     for seg in dropout_seq])
            res = self._train_stack(kit.step, sh.device, gv, sh.tasks_seq,
                                    sh.idx_seq, sh.mask_seq, sh.active_seq,
                                    drop)
            rows = None
            if self.do_local_eval:
                prev = (res.seg_deltas[-1] if res.seg_deltas else
                        _map2(lambda d, _: torch.zeros_like(d), res.deltas,
                              res.deltas))
                task = sh.tasks_seq[-1].to_device(sh.device)
                loc = self._local_evals(gv, res.deltas, task, prev, kit)
                seg = (self._seg_local_evals(gv, res.seg_deltas,
                                             sh.tasks_seq, kit)
                       if self.num_segments > 1 else None)
                rows = (loc, seg)
            return res._replace(local_rows=rows)

        outs = _per_device(shards, run)
        res = outs[0] if len(outs) == 1 else _cat_shards(outs, first)
        if mesh.world_size > 1:
            from dba_mod_tpu_torch.parallel.distributed import gather_clients
            with self.watch("round/all_gather"), \
                    telemetry.span("round/all_gather"):
                a, b = gather_clients(
                    [(_axis0_part(res), 0), (_axis1_part(res), 1)], first)
            res = _join_parts(a, b)
        return res

    def train_sequential(self, global_vars: ModelVars,
                         tasks_seq: List[ClientTask], idx_seq: np.ndarray,
                         mask_seq: np.ndarray,
                         dropout_seq: Optional[List[tuple]] = None
                         ) -> TrainResult:
        """``sequential_debug``: the clients one at a time, each a width-1
        :meth:`train_fn` call on its own slice of the task rows, plans and
        dropout keep masks, stitched back into the stacked TrainResult
        (dba_mod_tpu/fl/experiment.py::_train_sequential)."""
        C = idx_seq.shape[1]
        outs = []
        for c in range(C):
            tasks_c = [ClientTask(*(np.asarray(f)[c:c + 1] for f in t))
                       for t in tasks_seq]
            drop_c = (None if dropout_seq is None else
                      [tuple(d[c:c + 1] for d in seg) for seg in dropout_seq])
            outs.append(self.train_fn(global_vars, tasks_c,
                                      idx_seq[:, c:c + 1],
                                      mask_seq[:, c:c + 1], drop_c))

        def cat(trees, dim=0):
            return {k: torch.cat([t[k] for t in trees], dim)
                    for k in trees[0]}

        def cat_vars(vs):
            return ModelVars(cat([v.params for v in vs]),
                             cat([v.batch_stats for v in vs]))

        return TrainResult(
            deltas=cat_vars([o.deltas for o in outs]),
            fg_grads=cat([o.fg_grads for o in outs]),
            fg_feature=(torch.cat([o.fg_feature for o in outs])
                        if self.fg_enabled else None),
            metrics=ClientMetrics(*(torch.cat(f, dim=1) for f in
                                    zip(*(o.metrics for o in outs)))),
            delta_norms=torch.cat([o.delta_norms for o in outs]),
            batch_loss=torch.cat([o.batch_loss for o in outs], dim=1),
            batch_dist=torch.cat([o.batch_dist for o in outs], dim=1),
            seg_deltas=[cat_vars([o.seg_deltas[s] for o in outs])
                        for s in range(len(outs[0].seg_deltas))])

    @staticmethod
    def _delta(stacked: ModelVars, global_vars: ModelVars) -> ModelVars:
        return _map2(lambda e, g: e - g, stacked, global_vars)

    # --------------------------------------------------------- aggregate
    def aggregate_fn(self, global_vars: ModelVars, deltas: ModelVars,
                     gen: Optional[torch.Generator] = None,
                     noise: Optional[ModelVars] = None,
                     **kw) -> AggregateResult:
        """The configured rule: :func:`aggregate` with this engine's
        hyperparameters."""
        return aggregate(self.hyper, global_vars, deltas, gen, noise, **kw)

    # -------------------------------------------------------- evaluation
    def _const(self, v: int) -> torch.Tensor:
        """An int64 scalar on the engine's device, made by a fill (a
        host→device copy would hold the host until the stream drains)."""
        return torch.full((), v, dtype=torch.int64, device=self.device)

    def _zero_evals(self, n: int) -> EvalResult:
        z = torch.zeros((n,), dtype=torch.float32, device=self.device)
        return EvalResult(z, z, z, z)

    def _stacked_battery(self, unscaled: ModelVars, scaled: ModelVars,
                         adv_slots: torch.Tensor, kit=None) -> LocalEvals:
        """The per-client battery: clean on the pre-scaling model
        (image_train.py:150-155, :268-271), poison pre on it (:157-164),
        poison post + per-agent trigger on the submitted one (:275-295).
        `kit`: a shard device's eval functions and plans (the engine's
        own when None)."""
        kit = kit or self._kits[self.device]
        pl = kit.plans
        dev = adv_slots.device
        minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
        clean = kit.clean(unscaled, pl.clean_idx, pl.clean_slots,
                          pl.clean_mask, minus1)
        if self.is_poison_run:
            pre = kit.poison(unscaled, pl.poison_idx, pl.poison_slots,
                             pl.poison_mask, minus1)
            post = kit.poison(scaled, pl.poison_idx, pl.poison_slots,
                              pl.poison_mask, minus1)
            agent = kit.agent(scaled, pl.poison_idx, pl.poison_slots,
                              pl.poison_mask, adv_slots)
        else:
            z = torch.zeros((adv_slots.shape[0],), dtype=torch.float32,
                            device=dev)
            pre = post = agent = EvalResult(z, z, z, z)
        return LocalEvals(clean, pre, post, agent)

    def local_evals(self, global_vars: ModelVars, deltas: ModelVars,
                    task: ClientTask, prev_deltas: ModelVars) -> LocalEvals:
        """The per-client battery of the clients' trained models.
        `prev_deltas` anchors the final segment: the pre-scaling model is
        (global + prev) + (Δ - prev)/scale."""
        return self._local_battery(global_vars, deltas, task, prev_deltas)

    def _local_evals(self, global_vars: ModelVars, deltas: ModelVars,
                     task: ClientTask, prev_deltas: ModelVars, kit=None
                     ) -> LocalEvals:
        def unscale(g, p, d):
            return g + p + (d - p) / _bc(task.scale.to(torch.float32), d)
        unscaled = ModelVars(
            {k: unscale(g, prev_deltas.params[k], deltas.params[k])
             for k, g in global_vars.params.items()},
            {k: unscale(g, prev_deltas.batch_stats[k], deltas.batch_stats[k])
             for k, g in global_vars.batch_stats.items()})
        scaled = _map2(lambda d, g: g + d, deltas, global_vars)
        return self._stacked_battery(unscaled, scaled, task.adv_slot, kit)

    def seg_local_evals(self, global_vars: ModelVars,
                        seg_deltas: List[ModelVars],
                        tasks_seq: List[ClientTask]) -> List[LocalEvals]:
        """Per-epoch local evals for aggr_epoch_interval > 1: the battery of
        each INTERMEDIATE segment (the final one is local_evals)."""
        return self._seg_battery(global_vars, seg_deltas, tasks_seq)

    def _seg_local_evals(self, global_vars: ModelVars,
                         seg_deltas: List[ModelVars],
                         tasks_seq: List[ClientTask], kit=None
                         ) -> List[LocalEvals]:
        outs, prev = [], None
        for s, cur in enumerate(seg_deltas):
            if prev is None:
                prev = _map2(lambda c, _: torch.zeros_like(c), cur, cur)
            dev = next(iter(cur.params.values())).device
            task = tasks_seq[s].to_device(dev)
            outs.append(self._local_evals(global_vars, cur, task, prev,
                                          kit))
            prev = cur
        return outs

    def global_evals(self, model_vars: ModelVars) -> GlobalEvals:
        """The global battery of one model."""
        return self._global_battery(model_vars)

    def _global_evals(self, model_vars: ModelVars) -> GlobalEvals:
        pl = self.plans
        minus1 = self._const(-1)
        clean = self.eval_clean(model_vars, pl.clean_idx, pl.clean_slots,
                                pl.clean_mask, minus1)
        n = self.num_global_triggers
        if self.is_poison_run:
            poison = self.eval_poison(model_vars, pl.poison_idx,
                                      pl.poison_slots, pl.poison_mask, minus1)
            if n > 0:
                rows = [self.eval_poison(model_vars, pl.poison_idx,
                                         pl.poison_slots, pl.poison_mask,
                                         self._const(t))
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
        return self._probe(model_vars)

    def _backdoor_acc(self, model_vars: ModelVars) -> torch.Tensor:
        pl = self.plans
        return self.eval_poison(model_vars, pl.poison_idx, pl.poison_slots,
                                pl.poison_mask,
                                self._const(-1)).acc

    # ------------------------------------------------------------- round
    def round_fn(self, global_vars: ModelVars, tasks_seq: List[ClientTask],
                 idx_seq: np.ndarray, mask_seq: np.ndarray,
                 gen: Optional[torch.Generator] = None, **kw):
        """train → [faults → screen] → aggregate → local evals → global
        evals: :meth:`core_fn` then :meth:`eval_batteries` (keywords as
        core_fn's). Returns (new_vars, new_fg_state, payload, deltas_out);
        the payload slots are ordered as the JAX package's round program
        orders them: (locals, globals, metrics, delta_norms, wv, alpha,
        track_pair, is_updated, seg_locals, robust_stats,
        forensic_stats)."""
        new_vars, new_fg, payload, deltas_out, eval_in = self.core_fn(
            global_vars, tasks_seq, idx_seq, mask_seq, gen, **kw)
        evals = self.eval_batteries(global_vars, new_vars, tasks_seq,
                                    eval_in)
        return new_vars, new_fg, with_batteries(payload, *evals), deltas_out

    def eval_batteries(self, global_vars: ModelVars, new_vars: ModelVars,
                       tasks_seq: List[ClientTask], eval_in):
        """The round's eval tail on the core's outputs: the local battery of
        what each client TRAINED (the pre-fault deltas; faults model the
        uplink) against the pre-round model, the per-epoch batteries of an
        aggr_epoch_interval > 1 round, and the global battery of the
        committed model. Returns (locals, seg_locals, globals). A sharded
        round's shards ran their local batteries already (``rows``)."""
        deltas, prev, seg_deltas, rows = eval_in
        if rows is not None:
            locals_, seg_l = rows
            return locals_, seg_l, self.global_evals(new_vars)
        task_last = tasks_seq[-1].to_device(self.device)
        locals_ = (self.local_evals(global_vars, deltas, task_last, prev)
                   if self.do_local_eval else None)
        seg_l = (self.seg_local_evals(global_vars, seg_deltas, tasks_seq)
                 if self.do_local_eval and self.num_segments > 1 else None)
        return locals_, seg_l, self.global_evals(new_vars)

    def core_fn(self, global_vars: ModelVars, tasks_seq: List[ClientTask],
                idx_seq: np.ndarray, mask_seq: np.ndarray,
                gen: Optional[torch.Generator] = None, *,
                num_samples: np.ndarray,
                dropout_seq: Optional[List[tuple]] = None,
                fg_state: Optional[agg.FoolsGoldState] = None,
                fault_plan: Optional[flt.FaultPlan] = None,
                prev_deltas: Optional[ModelVars] = None,
                norm_mult: Optional[float] = None,
                tel=telemetry.NULL):
        """The round CORE: train → [faults → screen] → aggregate, the round
        minus its eval tail. Returns (new_vars, new_fg_state, payload,
        deltas_out, eval_in): the payload's battery slots (0, 1, 8) are
        None, and eval_in (train deltas, the final segment's anchor, the
        intermediate segments' deltas) feeds :meth:`eval_batteries`.
        Nothing it reads is written in place later, so the batteries may
        run after the next round has started.

        `num_samples` [C]: each client's sample count (RFA's alphas; zero
        marks a lane that is not counted). `dropout_seq`: a dropout model's
        keep masks per segment (train_fn). `norm_mult` switches the robust
        path on: the screen's norm multiplier, <= 0 for the finite screen
        only. With the fault layer on, `fault_plan` is the round's plan and
        `prev_deltas` the stale lane's replay source; deltas_out is then
        what the server received, for the next round's replay (None when
        the stale lane is off). `tel`: a telemetry instance to time the
        train and aggregate phases in synced ``round/train`` and
        ``round/aggregate`` spans (telemetry's split path)."""
        with tel.span("round/train"):
            train_fn = (self.train_sequential if self.sequential
                        else self.train_fn)
            train = train_fn(global_vars, tasks_seq, idx_seq, mask_seq,
                             dropout_seq)
            tel.sync(train.deltas)
        with tel.span("round/aggregate"):
            res, stats, fstats, deltas_out = self._aggregate_round(
                global_vars, tasks_seq, idx_seq, mask_seq, gen, train,
                num_samples, fg_state, fault_plan, prev_deltas, norm_mult)
            tel.sync(res.new_vars)
        prev = (train.seg_deltas[-1] if train.seg_deltas else
                _map2(lambda d, _: torch.zeros_like(d), train.deltas,
                      train.deltas))
        track_pair = ((train.batch_loss, train.batch_dist)
                      if self.hyper.track_batches else None)
        payload = (None, None, train.metrics, train.delta_norms, res.wv,
                   res.alpha, track_pair, res.is_updated, None, stats,
                   fstats)
        return (res.new_vars, res.new_fg_state, payload, deltas_out,
                (train.deltas, prev, train.seg_deltas, train.local_rows))

    def _aggregate_round(self, global_vars, tasks_seq, idx_seq, mask_seq,
                         gen, train: TrainResult, num_samples, fg_state,
                         fault_plan, prev_deltas, norm_mult):
        """[faults → screen] → aggregate of core_fn. Returns (the
        AggregateResult, RobustStats or None, ForensicStats or None,
        deltas_out)."""
        dev = self.device
        deltas, fg_grads, fg_feature = (train.deltas, train.fg_grads,
                                        train.fg_feature)
        ns = to_device(np.asarray(num_samples, np.float32), dev)
        pids = to_device(np.asarray(tasks_seq[0].participant_id, np.int64),
                         dev)
        nbt = to_device(nbt_client_deltas(
            mask_seq, np.stack([np.asarray(t.scale) for t in tasks_seq])),
            dev)
        agg_kw = dict(fg_state=fg_state, participant_ids=pids,
                      num_samples=ns, nbt_deltas=nbt)
        stats, fstats, deltas_out = None, None, None
        if norm_mult is not None:
            fcfg = self.fault_cfg
            counted = ns > 0
            reported = torch.ones_like(counted)
            n_dropped = torch.zeros((), dtype=torch.int64, device=dev)
            if fcfg.enabled:
                plan = fault_plan.to(dev)
                stale = prev_deltas if fcfg.stale_enabled else None
                deltas = flt.perturb_tree(deltas, plan, fcfg, stale)
                if self.fg_enabled:
                    # FoolsGold aggregates the accumulators, not the deltas:
                    # that payload is corrupted too (stale replay stays
                    # delta-only)
                    fg_grads = flt.perturb_tree(fg_grads, plan, fcfg)
                    fg_feature = flt.perturb_tree(fg_feature, plan, fcfg)
                reported = ~plan.dropped
                n_dropped = torch.sum(plan.dropped & counted)
            if fcfg.stale_enabled:
                deltas_out = deltas   # what the server RECEIVED
            if self.screening:
                extra = (fg_grads,) if self.fg_enabled else ()
                smask, _ = screen_client_updates(deltas, reported, counted,
                                                 norm_mult, extra)
            else:
                # a client that never reported cannot be aggregated, with or
                # without screening
                smask = reported
            n_quar = torch.sum(reported & ~smask & counted)
            n_surv = torch.sum(smask & counted)
            degraded = n_surv < self.min_surviving
            res = self.aggregate_fn(global_vars, deltas, gen,
                                    fg_grads=fg_grads, fg_feature=fg_feature,
                                    mask=smask.to(torch.float32), **agg_kw)
            # too few survivors: skip the aggregate, carry the global model
            # and the defense state
            new_vars = _map2(lambda g, a: torch.where(degraded, g, a),
                             global_vars, res.new_vars)
            new_fg = res.new_fg_state
            if self.fg_enabled:
                new_fg = agg.FoolsGoldState(torch.where(
                    degraded, fg_state.memory, new_fg.memory))
            gfin = torch.stack([torch.isfinite(v).all() for v in _merged(
                new_vars).values()]).all()
            stats = RobustStats(n_dropped, n_quar, n_surv, degraded, gfin,
                                smask)
            res = res._replace(new_vars=new_vars, new_fg_state=new_fg)
            if self.forensics:
                # the quarantine reason, consistent with the mask applied:
                # never reported → dropped; reported but screened out →
                # nonfinite or norm_exceeded (without screening smask ==
                # reported, so the middle branch never fires)
                if self.screening:
                    finite = _per_client_finite(deltas)
                    if self.fg_enabled:
                        finite = finite & _per_client_finite(fg_grads)
                else:
                    finite = torch.ones_like(smask)
                i32 = functools.partial(torch.full_like, smask,
                                        dtype=torch.int32)
                reason = torch.where(
                    ~reported, i32(REASON_DROPPED),
                    torch.where(reported & ~smask,
                                torch.where(finite, i32(REASON_NORM),
                                            i32(REASON_NONFINITE)),
                                i32(REASON_OK)))
                fstats = forensic_stats(global_vars, new_vars, deltas,
                                        smask, reason,
                                        res.num_oracle_calls)
        else:
            res = self.aggregate_fn(global_vars, deltas, gen,
                                    fg_grads=fg_grads, fg_feature=fg_feature,
                                    **agg_kw)
            if self.forensics:
                C = idx_seq.shape[1]
                fstats = forensic_stats(
                    global_vars, res.new_vars, deltas,
                    torch.ones((C,), dtype=torch.bool, device=dev),
                    torch.zeros((C,), dtype=torch.int32, device=dev),
                    res.num_oracle_calls)
        return res, stats, fstats, deltas_out


def _axis0_part(r: TrainResult):
    """The fields of a TrainResult whose clients axis is 0."""
    return (r.deltas, r.fg_grads, r.fg_feature, r.delta_norms, r.seg_deltas,
            r.local_rows)


def _axis1_part(r: TrainResult):
    """The fields of a TrainResult whose clients axis is 1 ([I, C, ...])."""
    return (r.metrics, r.batch_loss, r.batch_dist)


def _join_parts(a, b) -> TrainResult:
    deltas, fg_grads, fg_feature, norms, seg_deltas, rows = a
    metrics, bloss, bdist = b
    return TrainResult(deltas, fg_grads, fg_feature, metrics, norms, bloss,
                       bdist, list(seg_deltas), rows)


def _per_device(shards, fn) -> list:
    """[fn(shard) for shard in shards], each shard with its device made
    current. The shards of one device run one after the other; distinct
    devices each get a thread of their own, so one card's steps are
    enqueued while another's host thread waits on its card, and the cards
    train at once."""
    by_dev: Dict[torch.device, List[int]] = {}
    for i, sh in enumerate(shards):
        by_dev.setdefault(sh.device, []).append(i)
    out: list = [None] * len(shards)

    def work(dev, ids):
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            for i in ids:
                out[i] = fn(shards[i])

    if len(by_dev) == 1:
        work(*next(iter(by_dev.items())))
        return out
    with concurrent.futures.ThreadPoolExecutor(len(by_dev)) as pool:
        for f in [pool.submit(work, d, ids) for d, ids in by_dev.items()]:
            f.result()
    return out


def _cat_shards(outs: List[TrainResult], dev: torch.device) -> TrainResult:
    """The shards' TrainResults as one stack on `dev`, in shard order."""
    def cat(parts, axis):
        flat = [pytree.tree_flatten(p) for p in parts]
        leaves = [torch.cat([f[0][i].to(dev) for f in flat], axis)
                  if isinstance(flat[0][0][i], torch.Tensor)
                  else flat[0][0][i] for i in range(len(flat[0][0]))]
        return pytree.tree_unflatten(leaves, flat[0][1])
    return _join_parts(cat([_axis0_part(o) for o in outs], 0),
                       cat([_axis1_part(o) for o in outs], 1))


def with_batteries(payload, locals_, seg_locals, globals_):
    """A core payload with the eval batteries' results in their slots."""
    return ((locals_, globals_) + tuple(payload[2:8]) + (seg_locals,)
            + tuple(payload[9:]))
