"""The end-to-end FL experiment loop, synchronous path (port of
dba_mod_tpu/fl/experiment.py).

Data loading + partitioning once at startup, then per round: host-side
agent selection and plan building, the stacked-client round on the device
(train all clients → [faults → screen] → aggregate → local/global
evaluation batteries), one transfer of the round's results to the host,
and recording into the same CSV/JSONL files and columns as the JAX package.
The image workloads (MNIST, CIFAR, Tiny-ImageNet) partition one dataset
among the participants; LOAN's clients are US-state shards, its poisoned
rounds first probe the global model's backdoor accuracy for the adaptive
poison LR, and its dropout masks are drawn per round segment on the CPU.
The robust dispatch (fault_injection / screen_updates) retries a round whose
aggregate is non-finite — or, with the health sentinel on, outside its norm
band — from the captured pre-round state with an escalated norm screen,
and degrades it when retries run out (the last-good model is carried
forward). The plain path rolls an unhealthy merge back the same way.
``forensics: true`` streams each round's per-client defense evidence to
forensics.jsonl / client_forensics.csv.

Crash/preemption tolerance: the run loop stops at a round boundary after
SIGTERM/SIGINT (``graceful_shutdown``; the CLI then exits 75), a watchdog
aborts a stalled sync point (exit 76), and every snapshot ``save_model``
writes carries the full-state sidecar and an integrity manifest, so
``resumed_model: auto`` continues the killed run's trajectory exactly, in
its own run folder. ``mode: async`` hands the loop to the buffered-async
engine (fl/async_rounds.py) under the same guard; its streaming state rides
the sidecar under ``async_state``. Telemetry, round overlap and
multi-device runs are ROADMAP A17-A18; config.check_ported rejects their
knobs.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch import checkpoint as ckpt
from dba_mod_tpu_torch.data.batching import build_batch_plan, build_eval_plan
from dba_mod_tpu_torch.data.datasets import (load_image_dataset,
                                             load_loan_dataset)
from dba_mod_tpu_torch.data.partition import (equal_split_indices,
                                              poison_test_indices,
                                              sample_dirichlet_indices)
from dba_mod_tpu_torch.fl import faults as flt
from dba_mod_tpu_torch.fl.device_data import (make_image_device_data,
                                               make_loan_device_data)
from dba_mod_tpu_torch.fl.rounds import (REASON_NAMES, EvalPlans,
                                         HealthSentinel, RoundEngine)
from dba_mod_tpu_torch.fl.selection import select_agents
from dba_mod_tpu_torch.fl.state import build_client_tasks
from dba_mod_tpu_torch.models import ModelVars, build_model
from dba_mod_tpu_torch.models.loan import (draw_dropout_masks,
                                           dropout_generator)
from dba_mod_tpu_torch.ops.aggregation import foolsgold_init
from dba_mod_tpu_torch.ops.sgd import loan_adaptive_poison_lr
from dba_mod_tpu_torch.utils import run_guard
from dba_mod_tpu_torch.utils.device import pin_float32_math, resolve_device
from dba_mod_tpu_torch.utils.forensics import ForensicsWriter
from dba_mod_tpu_torch.utils.html import dict_html
from dba_mod_tpu_torch.utils.recorder import Recorder

logger = logging.getLogger("dba_mod_tpu_torch")


def to_host(tree: Any) -> Any:
    """Copy a payload tree (NamedTuples, lists, tuples, dicts of tensors)
    to numpy — the round's one device→host transfer."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_host(t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(t) for t in tree)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree


@dataclasses.dataclass
class RoundInFlight:
    """Device handles + host context of a dispatched round, awaiting its one
    blocking transfer in `finalize_round`."""
    epoch: int
    t0: float                    # perf_counter at dispatch start
    seg_epochs: List[int]
    agent_names: List[Any]
    adv_names: List[Any]
    tasks_list: List[Any]
    mask_list: List[Any]
    payload: Any
    dispatch_time: float = 0.0
    # the robust dispatch's outcome: retries consumed re-running the round
    # after a non-finite aggregate, and whether retries ran out and the
    # pre-round state was carried forward
    n_retries: int = 0
    forced_degraded: bool = False


class Experiment:
    def __init__(self, params: cfg.Params, save_results: bool = True,
                 device: str | torch.device = "cuda"):
        cfg.check_ported(params.raw)
        self.params = params
        self.device = resolve_device(device)
        self.model_def = build_model(params)
        if self.model_def.dtype == torch.float32:
            # float32 runs pin cuDNN and cuBLAS to full float32, as the JAX
            # reference computes; bf16 runs compute in bf16 either way
            pin_float32_math()
        # crash/preemption guard: stop flag checked at round boundaries +
        # watchdog around host sync points; inert with the default knobs
        self.guard = run_guard.RunGuard.from_params(params)
        self.interrupted = False
        self._ckpt_mgr: Optional[ckpt.CheckpointManager] = None
        # resumed_model: auto — find the newest VERIFIED checkpoint across
        # run_dir's run folders BEFORE making a new folder: the resumed run
        # re-enters the killed run's folder and continues its streams
        self._auto_resume_path: Optional[Path] = None
        resumed_folder: Optional[Path] = None
        if params.resume_mode == "auto":
            hit = ckpt.find_auto_resume(Path(str(params["run_dir"])),
                                        params.type, params.run_name)
            if hit is not None:
                resumed_folder, self._auto_resume_path = hit
        if not save_results:
            self.folder: Optional[Path] = None
        elif resumed_folder is not None:
            self.folder = resumed_folder
            ckpt.sweep_stale(self.folder)
            params.write_yaml(self.folder)
        else:
            self.folder = params.make_run_folder()
        if self.folder is not None:
            (self.folder / "params.html").write_text(
                dict_html(params.raw, params.current_time))
        self.recorder = Recorder(self.folder,
                                 tensorboard=bool(params.get("tensorboard")))
        # defense forensics: per-client rows from the round's ForensicStats
        # slot; no writer, no files and no device work when off
        self.forensics_writer: Optional[ForensicsWriter] = (
            ForensicsWriter(self.folder)
            if bool(params.get("forensics", False)) else None)
        seed = int(params.get("random_seed", 1))
        self.select_rng = random.Random(seed)
        self.plan_rng = np.random.RandomState(seed)
        # the DP-noise stream (diff_privacy); jax.random and torch draw
        # different numbers from one seed
        self.noise_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.seed = seed

        self._load_data_and_partition(seed)

        # Fixed plan shape across rounds (the JAX package compiles once)
        max_client = max((len(v) for v in self.client_indices.values()),
                         default=1)
        b = int(params["batch_size"])
        self.steps_per_epoch = max(1, int(np.ceil(max_client / b)))
        self.is_poison_run = bool(params["is_poison"])
        self.epochs_max = (max(int(params["internal_epochs"]),
                               int(params["internal_poison_epochs"]))
                           if self.is_poison_run
                           else int(params["internal_epochs"]))

        # Global model: fresh init or resume (image_helper.py:56-67)
        self.global_vars = self.model_def.init_vars(seed, self.device)
        self.start_epoch = 1
        self.interval = int(params["aggr_epoch_interval"])
        self._resume_aux: Optional[Dict[str, Any]] = None
        resume_path: Optional[Path] = None
        if params.resume_mode == "auto":
            resume_path = self._auto_resume_path
            if resume_path is None:
                logger.warning("resume auto: no verified checkpoint under "
                               "%s — starting a fresh run",
                               params["run_dir"])
        elif params.resume_mode == "named":
            path = (Path(str(params.get("checkpoint_dir", "saved_models")))
                    / str(params["resumed_model_name"]))
            # integrity gate: verified → load; manifest-less (pretrain) →
            # load unverified, the reference behavior; corrupt → the newest
            # verified same-name sibling
            resume_path = ckpt.resolve_verified(path)
        if resume_path is not None:
            self._resume_from(resume_path)

        self.engine = RoundEngine(params, self.model_def, self.device_data,
                                  self.eval_plans,
                                  num_segments=self.interval)
        self.max_round_retries = int(params.get("max_round_retries", 2))
        self.retry_backoff_s = float(params.get("retry_backoff_s", 0.0))
        # post-merge model-health sentinel (README "Self-healing
        # federation"): None when off — no check, no host read
        self._sentinel: Optional[HealthSentinel] = None
        if bool(params.get("model_health_check", False)):
            self._sentinel = HealthSentinel(
                band=float(params.get("health_norm_band", 0.0)),
                ema_alpha=float(params.get("health_ema_alpha", 0.1)),
                warmup=int(params.get("health_warmup_merges", 3)),
                ring_size=int(params.get("rollback_ring", 0)))
        # last round's received deltas: the stale lane's replay source (zero
        # before the first round; carried across a resume by the sidecar)
        self._prev_deltas: Optional[ModelVars] = None
        # FoolsGold's id-keyed memory, carried round to round (and across a
        # resume by the sidecar)
        grad_len = int(self.model_def.similarity_param(
            self.global_vars.params).numel())
        self.fg_state = foolsgold_init(self.num_participants, grad_len,
                                       self.device)
        self.local_eval = bool(params.get("local_eval", True))
        self.last_is_updated = True
        self.last_global_loss = float("inf")  # feeds the best-val checkpoint
        self.best_loss = float("inf")         # helper.py:433, main.py:120
        # stale_poison_probe (flag-gated deviation, LOAN only): the adaptive
        # poison-LR probe reads the most recently finalized round's backdoor
        # accuracy instead of evaluating the current global model
        # (loan_train.py:67-75), which saves the probe's host sync
        self.stale_poison_probe = bool(params.get("stale_poison_probe",
                                                  False))
        self.last_backdoor_acc: Optional[float] = None
        # Per-round step-count bucketing: size the plan to the round's own
        # max client, quantized to _STEP_BUCKET (identical numerics: dropped
        # steps were fully-masked no-ops)
        self.dynamic_steps = bool(params.get("dynamic_steps", False))
        self._apply_resume_aux()

    # ---------------------------------------------------------------- resume
    def _resume_from(self, resume_path: Path) -> None:
        """Restore the global model (and lr) from a verified or named
        snapshot and load its full-state sidecar, when it has one; an
        auto-resume also continues the run folder's streams."""
        params = self.params
        self.global_vars, saved_epoch, saved_lr = ckpt.load_checkpoint(
            resume_path, self.global_vars)
        # an auto-resume continues the killed run's round grid: the snapshot
        # records the completed round's BASE epoch, and with
        # aggr_epoch_interval > 1 the next round starts one interval on; a
        # named resume keeps the reference's +1
        self.start_epoch = saved_epoch + (
            self.interval if params.resume_mode == "auto" else 1)
        params.raw["lr"] = saved_lr
        # the sidecar (save_model runs write one; pretrain snapshots do not
        # — model-only resume, the reference behavior); a sidecar of another
        # epoch than the model's is discarded the same way
        self._resume_aux = ckpt.load_aux_state(resume_path)
        if (self._resume_aux is not None
                and int(self._resume_aux["epoch"]) != saved_epoch):
            logger.warning(
                "resume sidecar is for epoch %d but the model checkpoint is "
                "epoch %d — discarding the sidecar (model-only resume)",
                int(self._resume_aux["epoch"]), saved_epoch)
            self._resume_aux = None
        logger.info("resumed %s: lr=%s start_epoch=%d aux=%s", resume_path,
                    saved_lr, self.start_epoch, self._resume_aux is not None)
        if params.resume_mode == "auto" and self.folder is not None:
            # continue the killed run's streams through the resumed round's
            # FINAL epoch and drop the rest: a kill can land after round N
            # recorded but before its checkpoint verified, and the replayed
            # round N must not appear twice
            cut = saved_epoch + self.interval - 1
            kept = self.recorder.load_from_folder(cut)
            logger.info("resume auto: continuing the streams of %s (%d "
                        "metrics rows kept through epoch %d)", self.folder,
                        kept, cut)
            if self.forensics_writer is not None:
                self.forensics_writer.load_from_folder(cut)

    def _apply_resume_aux(self) -> None:
        """Restore the full-state sidecar: the RNG streams, FoolsGold's
        memory, the best-val loss, the stale lane's replay source and the
        sentinel's EMA — so a killed-and-resumed run continues the
        uninterrupted trajectory exactly (the reference cannot:
        helper.py:545-549 is RAM only). The fault-plan and dropout-mask
        streams are keyed by (seed, epoch[, segment]) and carry no state."""
        aux = self._resume_aux
        if not aux:
            return
        self.select_rng.setstate(aux["select_rng"])
        name, key, pos, has_gauss, cached = aux["plan_rng"]
        self.plan_rng.set_state((name, key.numpy().astype(np.uint32), pos,
                                 has_gauss, cached))
        if aux["noise_gen_device"] == self.noise_gen.device.type:
            self.noise_gen.set_state(aux["noise_gen"])
        else:   # CPU and CUDA generators keep different states
            logger.warning("resume sidecar's DP-noise stream is a %s "
                           "generator's; this run's is %s — it restarts "
                           "from the seed", aux["noise_gen_device"],
                           self.noise_gen.device.type)
        self.best_loss = float(aux["best_loss"])
        self.last_backdoor_acc = aux["last_backdoor_acc"]
        mem = aux["fg_memory"]
        if mem.shape != self.fg_state.memory.shape:
            raise ValueError(
                f"resume sidecar FoolsGold memory shape {tuple(mem.shape)} "
                f"does not match this run's "
                f"{tuple(self.fg_state.memory.shape)} — the checkpoint "
                "belongs to a different participant set or model")
        self.fg_state = self.fg_state._replace(memory=mem.to(self.device))
        pd = aux.get("prev_deltas")
        if pd is not None and self.engine.fault_cfg.stale_enabled:
            self._prev_deltas = ModelVars(
                {k: v.to(self.device) for k, v in pd["params"].items()},
                {k: v.to(self.device) for k, v in pd["batch_stats"].items()})
        if self._sentinel is not None:
            self._sentinel.load_state(aux.get("health"))

    def _snapshot_rng(self) -> Dict[str, Any]:
        """Every RNG stream a round consumes, as the sidecar stores it: the
        numpy key as an int64 tensor and the torch generator's state as a
        CPU byte tensor, so a sidecar loads on any machine."""
        name, key, pos, has_gauss, cached = self.plan_rng.get_state()
        return {"select_rng": self.select_rng.getstate(),
                "plan_rng": (name, torch.from_numpy(key.astype(np.int64)),
                             int(pos), int(has_gauss), float(cached)),
                "noise_gen": self.noise_gen.get_state().cpu(),
                "noise_gen_device": self.noise_gen.device.type}

    # ------------------------------------------------------------------ data
    def _load_data_and_partition(self, seed: int):
        params = self.params
        eb = int(params.get("eval_batch_size", 0) or
                 params["test_batch_size"])

        def dev(a):
            return torch.from_numpy(np.asarray(a)).to(self.device)

        if not params.is_image:
            self._load_loan(eb, dev)
            return
        data = self.image_data = load_image_dataset(params)
        self.device_data = make_image_device_data(data, params, self.device)
        if params["sampling_dirichlet"]:
            indices = sample_dirichlet_indices(
                data.train_labels,
                int(params["number_of_total_participants"]),
                float(params["dirichlet_alpha"]),
                py_rng=random.Random(seed),
                np_rng=np.random.RandomState(seed))
        else:
            indices = equal_split_indices(
                len(data.train_labels),
                int(params["number_of_total_participants"]),
                py_rng=random.Random(seed))
        self.client_indices = indices
        self.client_slots = {name: 0 for name in indices}
        if params["is_random_namelist"]:
            self.participants = list(
                range(int(params["number_of_total_participants"])))
        else:
            self.participants = list(params["participants_namelist"])
        self.benign_names = sorted(
            set(self.participants) - set(params.adversary_list))
        self.num_participants = int(params["number_of_total_participants"])

        clean = build_eval_plan(np.arange(len(data.test_labels)), eb)
        poison = build_eval_plan(
            poison_test_indices(data.test_labels,
                                int(params["poison_label_swap"])), eb)
        self.eval_plans = EvalPlans(
            clean_idx=dev(clean.idx),
            clean_slots=dev(np.zeros_like(clean.idx)),
            clean_mask=dev(clean.mask),
            poison_idx=dev(poison.idx),
            poison_slots=dev(np.zeros_like(poison.idx)),
            poison_mask=dev(poison.mask))

    def _load_loan(self, eb: int, dev) -> None:
        """LOAN: one client per state shard (slot = the state's index); the
        benign list is the first `number_of_total_participants` states that
        are not adversaries (loan_helper.py:134-141)."""
        params = self.params
        data = self.loan_data = load_loan_dataset(params)
        self.device_data = make_loan_device_data(data, params, self.device)
        state_of = {n: i for i, n in enumerate(data.state_names)}
        benign = []
        for j, name in enumerate(data.state_names):
            if j >= int(params["number_of_total_participants"]):
                break
            if name not in params.adversary_list:
                benign.append(name)
        self.benign_names = benign
        if params["is_random_namelist"]:
            self.participants = benign + params.adversary_list
        else:
            self.participants = list(params["participants_namelist"])
        self.client_indices = {
            name: list(range(len(data.train_y[state_of[name]])))
            for name in data.state_names}
        self.client_slots = state_of
        self.num_participants = len(data.state_names)

        # the eval plans run over every state's test shard (test.py:13-24),
        # each row with its state's slot; the plan's padded tail is masked
        pairs = [(s, i) for s, ys in enumerate(data.test_y)
                 for i in range(len(ys))]
        slots = np.array([p[0] for p in pairs], np.int64)
        rows = np.array([p[1] for p in pairs], np.int64)
        plan = build_eval_plan(np.arange(len(pairs)), eb)
        idx = rows[plan.idx.reshape(-1)].reshape(plan.idx.shape)
        slt = slots[plan.idx.reshape(-1)].reshape(plan.idx.shape)
        idx, slt, mask = (dev(idx.astype(np.int32)),
                          dev(slt.astype(np.int32)), dev(plan.mask))
        # LOAN's poisoned eval stamps every row (no target-class filter)
        self.eval_plans = EvalPlans(clean_idx=idx, clean_slots=slt,
                                    clean_mask=mask, poison_idx=idx,
                                    poison_slots=slt, poison_mask=mask)

    # ----------------------------------------------------------------- round
    _STEP_BUCKET = 2       # quantum of the per-round step-count buckets
    _STEP_BUCKET_MIN = 8   # floor: tiny rounds share one shape

    def _bucket_steps(self, s: int) -> int:
        b = self._STEP_BUCKET
        s = max(((s + b - 1) // b) * b, self._STEP_BUCKET_MIN)
        return min(s, max(self.steps_per_epoch, 1))

    def _round_min_steps(self, agent_names) -> int:
        """The plan's step count: the static one, or with dynamic_steps
        the round's own max client, bucketed."""
        if not self.dynamic_steps:
            return self.steps_per_epoch
        b = int(self.params["batch_size"])
        round_max = max((len(self.client_indices[n]) for n in agent_names),
                        default=1)
        return self._bucket_steps(max(1, int(np.ceil(round_max / b))))

    def build_static_round_inputs(self, epoch: int):
        """Round inputs at the STATIC plan shape, for diagnostics that call
        the engine directly. Consumes the experiment's selection/plan RNG
        streams. Returns (tasks_seq, idx_seq, mask_seq, num_samples) — one
        host ClientTask per segment and [1, C, E, S, B] numpy plans."""
        params = self.params
        agent_names, _ = select_agents(params, epoch, self.participants,
                                       self.benign_names, self.select_rng)
        slots = np.array([self.client_slots[n] for n in agent_names],
                         np.int64)
        tasks = build_client_tasks(params, agent_names, epoch, slots,
                                   self.epochs_max)
        plan = build_batch_plan(
            [self.client_indices[n] for n in agent_names],
            [int(e) for e in tasks.num_epochs], int(params["batch_size"]),
            self.plan_rng, min_steps=self.steps_per_epoch,
            min_epochs=self.epochs_max)
        return ([tasks], plan.idx[None], plan.mask[None],
                plan.num_samples.astype(np.float32))

    def run_round(self, epoch: int) -> Dict[str, Any]:
        return self.finalize_round(self.dispatch_round(epoch))

    def dispatch_round(self, epoch: int) -> RoundInFlight:
        t0 = time.perf_counter()
        fl = self._dispatch(epoch, t0)
        fl.dispatch_time = time.perf_counter() - t0
        return fl

    def _dispatch(self, epoch: int, t0: float) -> RoundInFlight:
        """Host-side planning + the round's device work; the results stay
        on the device until `finalize_round`."""
        params = self.params
        agent_names, adv_names = select_agents(
            params, epoch, self.participants, self.benign_names,
            self.select_rng)
        logger.info("Server Epoch:%d choose agents: %s", epoch, agent_names)
        backdoor_acc = self._poison_probe(epoch, agent_names)
        slots = np.array([self.client_slots[n] for n in agent_names],
                         np.int64)
        # one segment per global epoch in the aggregation interval
        # (image_train.py:50: the local model trains continuously across the
        # interval; the server applies the summed update once)
        seg_epochs = list(range(epoch, epoch + self.interval))
        min_steps = self._round_min_steps(agent_names)
        tasks_list, idx_list, mask_list = [], [], []
        num_samples = None
        for ep in seg_epochs:
            tasks_s = build_client_tasks(params, agent_names, ep, slots,
                                         self.epochs_max, backdoor_acc)
            plan = build_batch_plan(
                [self.client_indices[n] for n in agent_names],
                [int(e) for e in tasks_s.num_epochs],
                int(params["batch_size"]), self.plan_rng,
                min_steps=min_steps, min_epochs=self.epochs_max)
            if num_samples is None:
                num_samples = plan.num_samples.astype(np.float32)
            tasks_list.append(tasks_s)
            idx_list.append(plan.idx)
            mask_list.append(plan.mask)
        idx_seq, mask_seq = np.stack(idx_list), np.stack(mask_list)
        dropout_seq = self._dropout_masks(epoch, idx_seq.shape)
        if self.engine.robust:
            return self._dispatch_robust(epoch, t0, seg_epochs, agent_names,
                                         adv_names, tasks_list, idx_seq,
                                         mask_seq, mask_list, num_samples,
                                         dropout_seq)
        new_vars, new_fg, payload, _ = self.engine.round_fn(
            self.global_vars, tasks_list, idx_seq, mask_seq, self.noise_gen,
            num_samples=num_samples, fg_state=self.fg_state,
            dropout_seq=dropout_seq)
        rolled = False
        if self._sentinel is not None:
            new_vars, payload, rolled = self._health_gate(
                epoch, self.global_vars, new_vars, payload)
            if rolled:
                new_fg = self.fg_state
        self.global_vars, self.fg_state = new_vars, new_fg
        return RoundInFlight(epoch=epoch, t0=t0, seg_epochs=seg_epochs,
                             agent_names=agent_names, adv_names=adv_names,
                             tasks_list=tasks_list, mask_list=mask_list,
                             payload=payload, forced_degraded=rolled)

    def _loan_poisons(self, epoch: int, agent_names) -> bool:
        """A poisoned LOAN run in which a selected adversary poisons at
        `epoch`: the rounds whose poison LR adapts to the backdoor
        accuracy."""
        params = self.params
        return (params.type == cfg.TYPE_LOAN and self.is_poison_run
                and any(params.adversary_slot_of(n) >= 0 and epoch in
                        params.poison_epochs_for(params.adversary_slot_of(n))
                        for n in agent_names))

    def _poison_probe(self, epoch: int, agent_names) -> Optional[float]:
        """LOAN's adaptive poison-LR probe (loan_train.py:67-75): in a round
        where a selected adversary poisons, the current global model's
        backdoor accuracy (one host sync, as in the JAX package), or with
        stale_poison_probe the last finalized round's. None otherwise."""
        params = self.params
        if not self._loan_poisons(epoch, agent_names):
            return None
        if self.stale_poison_probe and self.last_backdoor_acc is not None:
            acc = self.last_backdoor_acc      # round N-1's battery
        else:
            with self.guard.watch("round/poison_probe"):
                acc = float(self.engine.backdoor_acc(self.global_vars))
        logger.info("epoch %d: poison probe backdoor acc %.4f -> poison lr "
                    "%r", epoch, acc, loan_adaptive_poison_lr(
                        float(params["poison_lr"]), acc,
                        bool(params["baseline"])))
        return acc

    def _dropout_masks(self, epoch: int, plan_shape) -> Optional[List]:
        """A dropout model's keep masks for each segment of the round, drawn
        on the CPU from a generator keyed by (random_seed, epoch, segment):
        the same masks on the card and on the CPU. None without dropout."""
        if not self.model_def.has_dropout:
            return None
        return [draw_dropout_masks(dropout_generator(self.seed, epoch, s),
                                   plan_shape[1:])
                for s in range(plan_shape[0])]

    def _zero_deltas(self, n_clients: int) -> ModelVars:
        """A [C]-stacked all-zero delta tree: the stale lane's replay source
        before any round was received."""
        def z(tree):
            return {k: torch.zeros((n_clients,) + tuple(v.shape),
                                   dtype=v.dtype, device=v.device)
                    for k, v in tree.items()}
        return ModelVars(z(self.global_vars.params),
                         z(self.global_vars.batch_stats))

    def _robust_round_args(self, epoch: int, num_samples: np.ndarray,
                           norm_mult: Optional[float] = None) -> Dict:
        """The robust round's extra inputs: the fault plan (a pure function
        of (fault_seed, epoch), so a retry sees the same faults), the stale
        lane's replay source and the screen's norm multiplier."""
        fcfg = self.engine.fault_cfg
        plan = prev = None
        if fcfg.enabled:
            plan = flt.make_fault_plan(
                fcfg, flt.fault_generator(fcfg.seed, epoch),
                torch.from_numpy(num_samples > 0))
        if fcfg.stale_enabled:
            prev = (self._prev_deltas if self._prev_deltas is not None
                    else self._zero_deltas(len(num_samples)))
        nm = self.engine.base_norm_mult if norm_mult is None else norm_mult
        return dict(fault_plan=plan, prev_deltas=prev, norm_mult=nm)

    def _health_check(self, epoch: int, vars_before: ModelVars,
                      new_vars: ModelVars):
        """The sentinel's decision on a merged model: (model to commit,
        rolled back). A healthy merge is committed to the EMA and ring
        here."""
        healthy, unorm = self._sentinel.check(vars_before, new_vars)
        if healthy:
            self._sentinel.commit(epoch, new_vars, unorm)
        self._note_health(epoch, healthy, unorm)
        if healthy:
            return new_vars, False
        return self._sentinel.rollback_target(vars_before), True

    def _note_health(self, epoch: int, healthy: bool, unorm: float) -> None:
        """Log the sentinel's decision on a round (after its commit)."""
        st = self._sentinel
        logger.log(logging.INFO if healthy else logging.WARNING,
                   "epoch %d: health check %s: update norm %.6g, EMA %.6g "
                   "after %d merges, band %gx", epoch,
                   "healthy" if healthy else "rolled back to last-good model",
                   unorm, st.ema, st.merges, st.band)

    def _health_gate(self, epoch: int, vars_before: ModelVars,
                     new_vars: ModelVars, payload):
        """The sentinel on the plain (non-retrying) path: _health_check,
        plus — since the round already ran the global battery on the
        rejected model — a re-run on the restored one, spliced into the
        payload so the recorded round stays finite. Returns (vars,
        payload, rolled_back)."""
        target, rolled = self._health_check(epoch, vars_before, new_vars)
        if not rolled:
            return target, payload, False
        return (target, payload[:1] + (self.engine.global_evals(target),)
                + payload[2:], True)

    @staticmethod
    def _escalate_norm_mult(cur: float) -> float:
        """Retry-k screening escalation: switch the norm screen on at 10×
        the survivor median if it was off, then halve it each further retry,
        floored at 1× the median."""
        return 10.0 if cur <= 0 else max(cur / 2.0, 1.0)

    def _dispatch_robust(self, epoch, t0, seg_epochs, agent_names, adv_names,
                         tasks_list, idx_seq, mask_seq, mask_list,
                         num_samples, dropout_seq=None) -> RoundInFlight:
        """The robust round: run it, then, only when screening is on, check
        that the aggregated model is finite (one host sync) — and, with the
        sentinel on, healthy — and re-run the round from the captured
        pre-round state with an escalated norm screen, up to
        max_round_retries. When retries run out the round is degraded: the
        last-good model (the pre-round state without a ring) is carried
        forward and the global battery re-run on it."""
        vars_before, fg_before = self.global_vars, self.fg_state
        # every attempt draws the same DP noise, as the JAX package's fixed
        # per-round key does
        gen_state = self.noise_gen.get_state()
        norm_mult: Optional[float] = None
        retries = 0
        finite, healthy, unorm = True, True, 0.0
        while True:
            self.noise_gen.set_state(gen_state)
            new_vars, new_fg, payload, deltas_out = self.engine.round_fn(
                vars_before, tasks_list, idx_seq, mask_seq, self.noise_gen,
                num_samples=num_samples, fg_state=fg_before,
                dropout_seq=dropout_seq,
                **self._robust_round_args(epoch, num_samples, norm_mult))
            if not self.engine.screening:
                # unscreened injection: faults flow through; with no norm
                # screen to escalate an unhealthy merge goes straight to
                # the rollback below
                if self._sentinel is not None:
                    healthy, unorm = self._sentinel.check(vars_before,
                                                          new_vars)
                break
            with self.guard.watch("round/screen_sync"):
                finite = bool(payload[9].global_finite)  # the one host sync
            healthy, unorm = True, 0.0
            if finite and self._sentinel is not None:
                healthy, unorm = self._sentinel.check(vars_before, new_vars)
            if (finite and healthy) or retries >= self.max_round_retries:
                break
            retries += 1
            cur = (self.engine.base_norm_mult if norm_mult is None
                   else norm_mult)
            norm_mult = self._escalate_norm_mult(cur)
            if self.retry_backoff_s > 0:
                time.sleep(min(self.retry_backoff_s * 2 ** (retries - 1),
                               30.0))
            logger.warning(
                "epoch %d: aggregated model %s; retry %d/%d with norm "
                "screen at %.2f× median", epoch,
                "non-finite" if not finite else "outside the health band",
                retries, self.max_round_retries, norm_mult)
        forced = (self.engine.screening and not finite) or not healthy
        if forced:
            logger.warning(
                "epoch %d: aggregated model %s after %d retries; degraded "
                "round (last-good model carried forward)", epoch,
                "non-finite" if not finite else "outside the health band",
                retries)
            new_vars = (self._sentinel.rollback_target(vars_before)
                        if self._sentinel is not None else vars_before)
            new_fg = fg_before
            payload = (payload[:1] + (self.engine.global_evals(new_vars),)
                       + payload[2:])
        elif self._sentinel is not None:
            self._sentinel.commit(epoch, new_vars, unorm)
        if self._sentinel is not None:
            self._note_health(epoch, not forced, unorm)
        self.global_vars, self.fg_state = new_vars, new_fg
        if self.engine.fault_cfg.stale_enabled:
            self._prev_deltas = deltas_out
        return RoundInFlight(epoch=epoch, t0=t0, seg_epochs=seg_epochs,
                             agent_names=agent_names, adv_names=adv_names,
                             tasks_list=tasks_list, mask_list=mask_list,
                             payload=payload, n_retries=retries,
                             forced_degraded=forced)

    def finalize_round(self, fl: RoundInFlight) -> Dict[str, Any]:
        t_fin = time.perf_counter()
        # the round's one blocking transfer — where a wedged runtime
        # stalls, hence the watchdog zone
        with self.guard.watch("round/finalize"):
            (locals_, globals_, metrics, delta_norms, wv, alpha,
             batches, is_updated, seg_locals, rstats,
             fstats) = to_host(fl.payload)
        finalize_time = time.perf_counter() - t_fin
        times = {"round_time": time.perf_counter() - fl.t0,
                 "dispatch_time": fl.dispatch_time,
                 "finalize_time": finalize_time}
        self.last_is_updated = bool(is_updated)
        self.last_global_loss = float(globals_.clean.loss)
        if self.is_poison_run:
            self.last_backdoor_acc = float(globals_.poison.acc)
        # robust counters: from the round's screen plus the host retry path
        robust = {"n_quarantined": 0, "n_dropped": 0,
                  "n_retries": int(fl.n_retries),
                  "degraded": bool(fl.forced_degraded)}
        if rstats is not None:
            robust["n_quarantined"] = int(rstats.n_quarantined)
            robust["n_dropped"] = int(rstats.n_dropped)
            robust["degraded"] = (bool(rstats.degraded)
                                  or bool(fl.forced_degraded))
        self._record(fl.epoch, fl.seg_epochs, fl.agent_names, fl.adv_names,
                     fl.tasks_list, metrics, locals_, globals_, delta_norms,
                     wv, alpha, times, batches, fl.mask_list, seg_locals,
                     robust)
        if self.forensics_writer is not None and fstats is not None:
            self._record_forensics(fl, locals_, delta_norms, wv, alpha,
                                   fstats, robust)
        return {"epoch": fl.epoch, "agents": fl.agent_names,
                "global_acc": float(globals_.clean.acc),
                "backdoor_acc": (float(globals_.poison.acc)
                                 if self.is_poison_run else None),
                **times, **robust}

    # ------------------------------------------------------------- recording
    def _record_forensics(self, fl: RoundInFlight, locals_, delta_norms,
                          wv, alpha, fstats, robust) -> None:
        """One forensic record per round: the round's ForensicStats slot
        plus what only the experiment knows (names, adversary membership,
        defense weights, the local poison battery)."""
        params = self.params
        names = list(fl.agent_names)
        adv = set(params.adversary_list)
        poison_acc = None
        if self.is_poison_run and locals_ is not None:
            poison_acc = np.asarray(locals_.poison_post.acc)
        robust_agg = params.aggregation != cfg.AGGR_MEAN
        self.forensics_writer.add_round(
            epoch=fl.epoch, aggregation=params.aggregation, names=names,
            participant_ids=np.asarray(fl.tasks_list[0].participant_id),
            adversary_flags=[int(n in adv) for n in names],
            delta_norms=np.asarray(delta_norms),
            recv_norms=np.asarray(fstats.recv_norms),
            cosine=np.asarray(fstats.cosine_to_agg),
            verdict=np.asarray(fstats.verdict),
            reason_codes=np.asarray(fstats.reason),
            reason_names=REASON_NAMES,
            weights=np.asarray(wv) if robust_agg else None,
            alpha=np.asarray(alpha) if robust_agg else None,
            poison_acc=poison_acc,
            oracle_calls=int(fstats.oracle_calls),
            n_retries=int(robust.get("n_retries", 0)),
            degraded=bool(robust.get("degraded", False)))
        self.forensics_writer.save()

    def _record(self, epoch, seg_epochs, agent_names, adv_names, tasks_list,
                metrics, locals_, globals_, delta_norms, wv, alpha, times,
                batches=None, mask_list=None, seg_locals=None, robust=None):
        # metrics leaves are [I, C, E]; tasks_list one ClientTask per segment.
        # Local clean evals: final segment from locals_, intermediate
        # segments (interval > 1) from seg_locals — matching the reference's
        # per-global-epoch cadence (image_train.py:268-271, :150-155). The
        # poison battery stays round-final: the reference runs it in the
        # poison branch against the round's submitted update.
        params = self.params
        rec = self.recorder
        tasks = tasks_list[-1]
        # round-final rows carry the round's LAST global epoch, like the
        # reference's temp_global_epoch = epoch + interval - 1 (main.py:196)
        final_ep = seg_epochs[-1]
        # per-client flags hold if ANY segment of the round poisoned
        # (a client may poison at epoch 3 of a (3,4) interval round)
        poisoning_any = np.zeros(len(agent_names), bool)
        adv_slot_any = np.full(len(agent_names), -1, np.int64)
        for t in tasks_list:
            poisoning_any |= np.asarray(t.poisoning_per_batch)[
                :len(agent_names)] > 0
            adv_slot_any = np.maximum(adv_slot_any,
                                      np.asarray(t.adv_slot)
                                      [:len(agent_names)])
        for c, name in enumerate(agent_names):
            for s, ep in enumerate(seg_epochs):
                n_e = int(tasks_list[s].num_epochs[c])
                self._record_train_rows(name, c, s, ep, n_e, metrics)
                if batches is not None:
                    # [I, C, E*S] per-batch channels; only steps whose batch
                    # mask is non-empty ran (padded epochs/steps are no-ops).
                    # The loss channel is benign-only: the reference calls
                    # train_batch_vis in the benign branch alone
                    # (image_train.py:225-228), while distance is tracked in
                    # both branches (:107-112, :235-240).
                    bloss, bdist = batches
                    S = mask_list[s].shape[2]
                    valid = mask_list[s][c].any(axis=-1).reshape(-1)  # [E*S]
                    seg_poisons = (np.asarray(
                        tasks_list[s].poisoning_per_batch)[c] > 0)
                    want_loss = (bool(params.get("vis_train_batch_loss"))
                                 and not seg_poisons)
                    want_dist = bool(params.get("batch_track_distance"))
                    for st in np.nonzero(valid)[0]:
                        e_i, b_i = int(st) // S, int(st) % S
                        tle = (ep - 1) * n_e + e_i + 1
                        if want_loss:
                            rec.add_batch_loss(name, tle, ep, e_i + 1, b_i, S,
                                               float(bloss[s, c, st]))
                        if want_dist:
                            rec.add_batch_distance(
                                name, tle, ep, e_i + 1, b_i, S,
                                float(bdist[s, c, st]))
            poisoning = bool(poisoning_any[c])
            # the FINAL segment's clean row gates on that segment's own
            # poisoning flag (a client may poison epoch 3 of a (3,4) round
            # and still get its benign epoch-4 row, image_train.py:267-271)
            final_seg_poisons = bool(
                np.asarray(tasks_list[-1].poisoning_per_batch)[c] > 0)
            baseline = bool(params["baseline"])
            if seg_locals is not None:
                # intermediate-segment rows (interval > 1): the reference
                # runs the whole battery inside the per-global-epoch loop —
                # same gating as the final segment below
                for s, seg_ev in enumerate(seg_locals):
                    seg_poisons = bool(np.asarray(
                        tasks_list[s].poisoning_per_batch)[c] > 0)
                    self._record_local_rows(
                        name, c, seg_epochs[s], seg_ev,
                        not (seg_poisons and baseline), seg_poisons,
                        int(np.asarray(tasks_list[s].adv_slot)[c]) >= 0)
            if locals_ is not None:
                # the local clean eval for a poisoning client happens inside
                # `if not baseline` in the reference (image_train.py:148-155);
                # benign clients always get one (:267-271)
                self._record_local_rows(
                    name, c, final_ep, locals_,
                    not (final_seg_poisons and baseline), poisoning,
                    int(adv_slot_any[c]) >= 0)
            if poisoning and not baseline:
                rec.scale_temp_one_row.extend(
                    [epoch, round(float(delta_norms[c]), 4)])
        self._record_round(epoch, final_ep, list(agent_names), adv_names,
                           globals_, wv, alpha, times, robust or {})

    def _record_train_rows(self, name, c: int, s: int, ep: int, n_e: int,
                           metrics) -> None:
        """Client `c`'s train rows of segment `s` (global epoch `ep`), one
        per internal epoch."""
        for e in range(n_e):
            count = max(float(metrics.count[s, c, e]), 1.0)
            self.recorder.add_train(
                name, (ep - 1) * n_e + e + 1, ep, e + 1,
                float(metrics.loss_sum[s, c, e]) / count,
                100.0 * float(metrics.correct[s, c, e]) / count,
                int(metrics.correct[s, c, e]), int(count))

    def _record_local_rows(self, name, c: int, ep: int, ev, clean_row: bool,
                           poisoning: bool, adversary: bool) -> None:
        """Client `c`'s local-battery rows at epoch `ep` from `ev`
        (LocalEvals): the clean row when `clean_row` (image_train.py:
        148-155, :267-271); a poisoning client's pre-scale (unless
        `baseline`, :157-164) and post-scale (:275-282) poison rows; an
        adversary's own-trigger row, every global epoch (:285-295)."""
        rec = self.recorder
        if clean_row:
            rec.add_test(name, ep, float(ev.clean.loss[c]),
                         float(ev.clean.acc[c]), int(ev.clean.correct[c]),
                         int(ev.clean.count[c]))
        if poisoning and self.is_poison_run:
            rows = ((ev.poison_post,) if bool(self.params["baseline"])
                    else (ev.poison_pre, ev.poison_post))
            for r in rows:
                rec.add_poisontest(name, ep, float(r.loss[c]),
                                   float(r.acc[c]), int(r.correct[c]),
                                   int(r.count[c]))
        if self.is_poison_run and adversary:
            r = ev.agent_trigger
            rec.add_triggertest(name, f"{name}_trigger", "", ep,
                                float(r.loss[c]), float(r.acc[c]),
                                int(r.correct[c]), int(r.count[c]))

    def _record_round(self, epoch: int, ep: int, names, adv_names, globals_,
                      wv, alpha, times, robust) -> None:
        """The global battery's rows at epoch `ep`, the scale row's close,
        the defense weights of a robust rule and the metrics.jsonl /
        round_result.csv row keyed by `epoch`, then the save. `robust` may
        carry more keys for the JSON row (the async extras)."""
        params = self.params
        rec = self.recorder
        g = globals_
        rec.add_test("global", ep, float(g.clean.loss), float(g.clean.acc),
                     int(g.clean.correct), int(g.clean.count))
        if self.is_poison_run:
            rec.add_poisontest("global", ep, float(g.poison.loss),
                               float(g.poison.acc), int(g.poison.correct),
                               int(g.poison.count))
            rec.add_triggertest("global", "combine", "", ep,
                                float(g.poison.loss), float(g.poison.acc),
                                int(g.poison.correct), int(g.poison.count))
            if params.is_centralized_attack:
                # gated on centralized_test_trigger (main.py:226)
                tnames = [f"global_in_index_{j}_trigger"
                          for j in range(self.engine.num_global_triggers)]
            else:
                tnames = [f"global_in_{a}_trigger"
                          for a in params.adversary_list]
            for j, tname in enumerate(tnames):
                rec.add_triggertest(
                    "global", tname, "", ep,
                    float(g.per_trigger.loss[j]), float(g.per_trigger.acc[j]),
                    int(g.per_trigger.correct[j]),
                    int(g.per_trigger.count[j]))
        if rec.scale_temp_one_row:
            rec.scale_temp_one_row.append(round(float(g.clean.acc), 4))
        if params.aggregation != cfg.AGGR_MEAN:
            rec.add_weight_result(names,
                                  np.asarray(wv)[:len(names)].tolist(),
                                  np.asarray(alpha)[:len(names)].tolist(),
                                  epoch=epoch)
        rec.add_round_json(
            epoch=epoch, agents=[str(a) for a in names],
            adversaries=[str(a) for a in adv_names],
            is_updated=self.last_is_updated,
            global_acc=float(g.clean.acc), global_loss=float(g.clean.loss),
            backdoor_acc=(float(g.poison.acc) if self.is_poison_run
                          else None),
            **times, **robust)
        rec.save(self.is_poison_run)

    # ------------------------------------------------------------------- run
    @property
    def checkpoint_manager(self) -> ckpt.CheckpointManager:
        """Manifest/retention policy bound to the CURRENT run folder
        (rebuilt when the folder changes)."""
        if self._ckpt_mgr is None or self._ckpt_mgr.folder != self.folder:
            self._ckpt_mgr = ckpt.CheckpointManager(
                self.folder,
                keep_last_n=int(self.params.get("keep_last_n", 0)),
                manifests=bool(self.params.get("checkpoint_manifests",
                                               True)))
        return self._ckpt_mgr

    def save_model(self, epoch: int,
                   extra_aux: Optional[Dict[str, Any]] = None) -> None:
        """Checkpoint the round's post-aggregation state: model_last, plus
        .epoch_N for save_on_epochs and .best whenever the global eval loss
        improves (helper.py:433-435). Every snapshot gets the full-state
        sidecar, then its manifest (covering the sidecar); a snapshot being
        overwritten is cloned to .prev until its replacement verifies;
        retention GC runs last. `extra_aux` merges more keys into the
        sidecar: the async engine's streaming state (``async_state``)."""
        params = self.params
        if not params["save_model"] or self.folder is None:
            return
        t0 = time.perf_counter()
        mgr = self.checkpoint_manager
        path = self.folder / "model_last.pt.tar"
        lr = float(params["lr"])
        written = [path]
        if epoch in list(params["save_on_epochs"]):
            written.append(Path(str(path) + f".epoch_{epoch}"))
        if self.last_global_loss < self.best_loss:
            written.append(Path(str(path) + ".best"))
            self.best_loss = self.last_global_loss
        mgr.prepare_overwrite(written)
        # the sidecar (a deviation from the reference, which loses these on
        # restart): every snapshot gets one, so resuming from .epoch_N or
        # .best does not silently reset the defense either
        aux = {"epoch": int(epoch),
               "fg_memory": self.fg_state.memory.detach().cpu(),
               "best_loss": float(self.best_loss),
               "last_backdoor_acc": self.last_backdoor_acc,
               **self._snapshot_rng()}
        if self.engine.fault_cfg.stale_enabled and \
                self._prev_deltas is not None:
            # the stale lane's replay source: what the server received this
            # round (model-sized × C; the lane is opt-in)
            aux["prev_deltas"] = {
                "params": {k: v.detach().cpu()
                           for k, v in self._prev_deltas.params.items()},
                "batch_stats": {k: v.detach().cpu() for k, v in
                                self._prev_deltas.batch_stats.items()}}
        if self._sentinel is not None:
            aux["health"] = self._sentinel.state()
        if extra_aux:
            aux.update(extra_aux)
        for p in written:
            ckpt.save_checkpoint(p, self.global_vars, epoch, lr)
            ckpt.save_aux_state(p, aux)
        mgr.note_saved(written, epoch)
        mgr.gc()
        logger.info("epoch %d: saved %d snapshot(s) in %.3fs: %s", epoch,
                    len(written), time.perf_counter() - t0,
                    [p.name for p in written])

    def run(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        """Run rounds start_epoch..epochs (the config's when None) under
        the guard: SIGTERM/SIGINT handlers are installed around the loop
        (and the previous ones restored after) when graceful_shutdown is
        on."""
        self.interrupted = False
        with self.guard:
            return self._run_rounds(epochs)

    def _run_rounds(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        if self.params["mode"] == "async":
            # the buffered-async engine owns the whole loop: cohort
            # dispatch, arrivals, K-arrival merges, recording and
            # checkpoints
            from dba_mod_tpu_torch.fl.async_rounds import AsyncDriver
            return AsyncDriver(self).run(epochs)
        last: Dict[str, Any] = {}
        end = epochs if epochs is not None else int(self.params["epochs"])
        for epoch in range(self.start_epoch, end + 1, self.interval):
            if self.guard.stop_requested:
                # round-boundary stop: the previous round's save_model
                # already wrote a verified checkpoint and the recorder
                # saved — nothing in flight to lose
                self._note_interrupted(epoch)
                break
            self.guard.watchdog.epoch = epoch
            last = self.run_round(epoch)
            self.save_model(epoch)
            logger.info("epoch %d done in %.2fs acc=%.2f backdoor=%s",
                        epoch, last["round_time"], last["global_acc"],
                        last["backdoor_acc"])
        return last

    def _note_interrupted(self, next_epoch: int) -> None:
        """A graceful stop was honored at a round boundary: record it so
        the CLI exits with run_guard.EXIT_INTERRUPTED and a wrapper can
        relaunch with ``--resume auto``."""
        self.interrupted = True
        logger.warning(
            "graceful stop honored at the round boundary before epoch %d — "
            "exiting (resume with --resume auto)", next_epoch)
