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
the sidecar under ``async_state``.

Observability: ``telemetry: true`` times every phase in synced spans
(``round/dispatch``, ``round/train``, ``round/aggregate``, ``eval/*``,
``round/finalize``, ``round/checkpoint``; utils/telemetry.py) and runs the
loop sequentially; ``profile_dir`` traces the first post-warm-up round with
torch.profiler into that folder; ``tensorboard: true`` mirrors the recorder
rows into ``<run>/tb``.

Round overlap: ``pipeline_rounds`` dispatches round N+1 before round N's
host work (fetch, recording, checkpoint) runs; ``overlap_eval`` also moves
round N's eval batteries to a second CUDA stream
(:meth:`Experiment._dispatch_overlap`), enqueued by a worker thread beside
N+1's training on the main stream (the launch queue lets the host run only
a short way ahead of the card, so one thread enqueueing both would
serialize them). Both record byte-identical outputs: a dispatch ends by
enqueueing its payload's copy into pinned host memory (:class:`HostCopy`),
finalize waits for that copy only, and checkpoints write host copies
captured at dispatch on a background writer.
Multi-device runs are ROADMAP A18; config.check_ported rejects them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import random
import time
from concurrent.futures import Future, ThreadPoolExecutor
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
from dba_mod_tpu_torch.fl.evaluation import (pick_eval_stream,
                                             place_eval_inputs)
from dba_mod_tpu_torch.fl.rounds import (REASON_NAMES, EvalPlans,
                                         HealthSentinel, RoundEngine,
                                         with_batteries)
from dba_mod_tpu_torch.fl.selection import select_agents
from dba_mod_tpu_torch.fl.state import build_client_tasks
from dba_mod_tpu_torch.models import ModelVars, build_model
from dba_mod_tpu_torch.models.loan import (draw_dropout_masks,
                                           dropout_generator)
from dba_mod_tpu_torch.ops.aggregation import foolsgold_init
from dba_mod_tpu_torch.ops.sgd import loan_adaptive_poison_lr
from dba_mod_tpu_torch.utils import run_guard, telemetry
from dba_mod_tpu_torch.utils.device import pin_float32_math, resolve_device
from dba_mod_tpu_torch.utils.forensics import ForensicsWriter
from dba_mod_tpu_torch.utils.html import dict_html
from dba_mod_tpu_torch.utils.recorder import Recorder

logger = logging.getLogger("dba_mod_tpu_torch")


def map_tensors(tree: Any, fn) -> Any:
    """`fn` applied to every tensor of a payload tree (NamedTuples, lists,
    tuples, dicts); other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(t, fn) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    return tree


def to_host(tree: Any) -> Any:
    """Copy a payload tree to numpy (a blocking copy for CUDA tensors)."""
    return map_tensors(tree, lambda t: t.detach().cpu().numpy())


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    if not t.is_cuda:
        return t.detach()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class HostCopy:
    """A payload tree's device→host copy, enqueued now and waited for
    later. CUDA tensors are copied into pinned host buffers by non-blocking
    copies on `stream` (the current stream when None), and an event is
    recorded after them, so :meth:`wait` waits for that event only — not
    for the work queued on the stream after it (the next round's). The
    device tensors stay referenced until the copy has landed. CPU tensors
    are taken as they are."""

    def __init__(self, tree: Any, stream: Optional[torch.cuda.Stream] = None):
        self._src = tree
        self._event = None
        dev = telemetry.cuda_device_of(tree)
        if dev is None:
            self._host = map_tensors(tree, torch.Tensor.detach)
            return
        stream = stream or torch.cuda.current_stream(dev)
        with torch.cuda.stream(stream):
            self._host = map_tensors(tree, _pinned_copy)
            self._event = torch.cuda.Event()
            self._event.record(stream)

    @property
    def host(self) -> Any:
        """The host tree, which holds the copy once :meth:`wait` (or a
        wait on another thread) has returned."""
        return self._host

    def wait(self) -> Any:
        """The host tree (CPU tensors), once the copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        self._src = None
        return self._host


class PendingCopy:
    """A :class:`HostCopy` still being made on the eval worker thread (the
    batteries enqueue there, then their copy); :meth:`wait` waits for the
    thread, then for the copy, and re-raises the thread's error."""

    def __init__(self, future: "Future[HostCopy]"):
        self._future = future

    def wait(self) -> Any:
        return self._future.result().wait()


@dataclasses.dataclass
class RoundPlan:
    """A round's host-side plan: who trains, on which batches."""
    seg_epochs: List[int]
    agent_names: List[Any]
    adv_names: List[Any]
    tasks_list: List[Any]
    idx_seq: np.ndarray
    mask_seq: np.ndarray
    mask_list: List[Any]
    num_samples: np.ndarray
    dropout_seq: Optional[List]


@dataclasses.dataclass
class RoundInFlight:
    """Device handles + host context of a dispatched round, awaiting its
    host copy in `finalize_round`."""
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
    # the state after this round, captured at dispatch: under pipelining
    # the live attributes already belong to round N+1 when round N
    # checkpoints, so save_model saves these
    vars_after: Any = None       # global ModelVars
    fg_after: Any = None         # FoolsGoldState
    rng_after: Optional[Dict[str, Any]] = None
    deltas_after: Any = None     # the stale lane's replay source (or None)
    health_after: Optional[Dict[str, Any]] = None
    # the payload's host copy (enqueued at the end of dispatch, or by the
    # eval worker for a pipelined overlapped round), and the captured
    # state's (pipelined runs that save)
    host: Any = None             # HostCopy or PendingCopy
    saved: Optional[HostCopy] = None
    # overlap_eval: the round's batteries ran on the eval stream; `keep`
    # holds their inputs until the host copy has landed, and
    # eval_dispatch_t is the perf_counter when they were handed on
    overlapped: bool = False
    keep: Any = None
    eval_dispatch_t: float = 0.0


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
        # one run-folder log.txt handler that follows the active experiment
        telemetry.setup_logging(self.folder)
        if self.folder is not None:
            (self.folder / "params.html").write_text(
                dict_html(params.raw, params.current_time))
        self.recorder = Recorder(self.folder,
                                 tensorboard=bool(params.get("tensorboard")))
        tb_sink = (self.recorder._scalar if self.recorder._tb is not None
                   else None)
        # telemetry (utils/telemetry.py): spans, metrics, kernel builds and
        # device memory; files land in telemetry_dir (default the run
        # folder; in memory when neither exists). The instance is the
        # process-wide current one, so the spans of shared code
        # (checkpoint.py, the batteries) resolve to it
        tdir = str(params.get("telemetry_dir", "") or "")
        self.telemetry = telemetry.configure(
            enabled=bool(params.get("telemetry", False)),
            folder=Path(tdir) if tdir else self.folder, tb_sink=tb_sink,
            device=self.device)
        # defense forensics: per-client rows from the round's ForensicStats
        # slot; no writer, no files and no device work when off
        self.forensics_writer: Optional[ForensicsWriter] = (
            ForensicsWriter(self.folder, tb_sink=tb_sink)
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
        # sequential_debug trains through width-1 calls that the fault
        # layer's injection and screen do not cover: refuse the combination
        # rather than silently not injecting (as the JAX package does)
        if self.engine.robust and self.engine.sequential:
            raise ValueError("fault_injection/screen_updates are not "
                             "supported with sequential_debug")
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
        # overlap_eval: round N's batteries run on a second stream of the
        # card (none on the CPU), beside round N+1's train on the main one
        # (_dispatch_overlap, the pipelined loop in _run_rounds)
        self._overlap = bool(params.get("overlap_eval", False))
        self._eval_stream = pick_eval_stream(self.device, self._overlap)
        self._overlap_rounds = 0
        self._overlap_hidden_s = 0.0  # cumulative eval+fetch seconds hidden
        self._overlap_wait_s = 0.0    # cumulative finalize blocking seconds
        # rounds whose finalize returned while the card's main stream still
        # ran later work (the next round's, under pipelining)
        self._finalized_ahead = 0
        # set inside the pipelined loop: dispatch then hands an overlapped
        # round's batteries to the eval worker thread, and, when the run
        # saves, captures the round's state in host memory for save_model
        self._pipelining = False
        self._eval_worker: Optional[ThreadPoolExecutor] = None
        self.async_driver = None   # the AsyncDriver of a mode: async run
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

    @property
    def _telemetry_split(self) -> bool:
        """Synced per-phase spans only while THIS experiment's telemetry is
        the process-wide current instance: after another Experiment took
        over, the batteries' spans land on that one, so the round runs
        without the phase syncs (its dispatch/finalize spans, recorded on
        this instance, stay honest)."""
        return (self.telemetry.enabled and not self.engine.robust
                and telemetry.current() is self.telemetry)

    def dispatch_round(self, epoch: int) -> RoundInFlight:
        """Host planning and the round's device work under the
        ``round/dispatch`` span, ending with the payload's host copy
        enqueued (on the eval stream for an overlapped round) and, in a
        pipelined run that saves, the host copy of the state after the
        round. Its perf_counter duration is ``dispatch_time``."""
        t0 = time.perf_counter()
        self.telemetry.set_epoch(epoch)
        with self.telemetry.span("round/dispatch"):
            fl = self._dispatch(epoch, t0)
            if fl.host is None:
                fl.host = HostCopy(fl.payload)
            if (self._pipelining and self.params["save_model"]
                    and self.folder is not None):
                fl.saved = HostCopy(self._state_after(fl))
        fl.dispatch_time = time.perf_counter() - t0
        return fl

    def _plan_round(self, epoch: int) -> RoundPlan:
        """Host-side planning: agent selection, LOAN's poison probe, the
        task rows and batch plans of every segment, the dropout masks."""
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
        return RoundPlan(seg_epochs, agent_names, adv_names, tasks_list,
                         idx_seq, mask_seq, mask_list, num_samples,
                         self._dropout_masks(epoch, idx_seq.shape))

    def _dispatch(self, epoch: int, t0: float) -> RoundInFlight:
        """Host-side planning + the round's device work; the results stay
        on the device until `finalize_round`."""
        plan = self._plan_round(epoch)
        if self._overlap:
            return self._dispatch_overlap(epoch, t0, plan)
        if self.engine.robust:
            return self._dispatch_robust(epoch, t0, plan)
        vars_before, fg_before = self.global_vars, self.fg_state
        new_vars, new_fg, payload, _ = self.engine.round_fn(
            vars_before, plan.tasks_list, plan.idx_seq, plan.mask_seq,
            self.noise_gen, num_samples=plan.num_samples, fg_state=fg_before,
            dropout_seq=plan.dropout_seq,
            tel=self.telemetry if self._telemetry_split else telemetry.NULL)
        rolled = False
        if self._sentinel is not None:
            new_vars, payload, rolled = self._health_gate(
                epoch, vars_before, new_vars, payload)
            if rolled:
                new_fg = fg_before
        return self._commit(epoch, t0, plan, payload, new_vars, new_fg,
                            forced=rolled)

    def _commit(self, epoch: int, t0: float, plan: RoundPlan, payload,
                new_vars: ModelVars, new_fg, *, n_retries: int = 0,
                forced: bool = False, deltas_out=None) -> RoundInFlight:
        """Commit the round's decided model update (round N+1 may be
        dispatched from here on) and return its in-flight record, with the
        state after it captured for save_model."""
        self.global_vars, self.fg_state = new_vars, new_fg
        stale = self.engine.fault_cfg.stale_enabled
        if stale:
            self._prev_deltas = deltas_out
        return RoundInFlight(
            epoch=epoch, t0=t0, seg_epochs=plan.seg_epochs,
            agent_names=plan.agent_names, adv_names=plan.adv_names,
            tasks_list=plan.tasks_list, mask_list=plan.mask_list,
            payload=payload, n_retries=n_retries, forced_degraded=forced,
            vars_after=new_vars, fg_after=new_fg,
            rng_after=self._snapshot_rng(),
            deltas_after=deltas_out if stale else None,
            health_after=(self._sentinel.state()
                          if self._sentinel is not None else None))

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
        """The sentinel's decision on a merged model, made before anything
        of round N+1 commits: (model to commit, rolled back). A healthy
        merge is committed to the EMA and ring here."""
        healthy, unorm = self._sentinel.check(vars_before, new_vars)
        if healthy:
            self._sentinel.commit(epoch, new_vars, unorm)
        else:
            self.telemetry.counter("health_rollbacks").inc()
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

    def _dispatch_robust(self, epoch: int, t0: float,
                         plan: RoundPlan) -> RoundInFlight:
        """The robust round, serial: the retry loop over the whole round."""
        (new_vars, new_fg, payload, deltas_out, _, retries,
         forced) = self._robust_attempts(epoch, plan, core=False)
        return self._commit(epoch, t0, plan, payload, new_vars, new_fg,
                            n_retries=retries, forced=forced,
                            deltas_out=deltas_out)

    def _robust_attempts(self, epoch: int, plan: RoundPlan, core: bool):
        """The robust round's retry loop: run it (the round, or with `core`
        the round core without its batteries), then, only when screening
        is on, check that the aggregated model is finite (one host sync) —
        and, with the sentinel on, healthy — and re-run from the captured
        pre-round state with an escalated norm screen, up to
        max_round_retries. When retries run out the round is degraded: the
        last-good model (the pre-round state without a ring) is carried
        forward, and the serial round's global battery re-run on it.
        Returns (new_vars, new_fg, payload, deltas_out, eval_in, retries,
        forced)."""
        vars_before, fg_before = self.global_vars, self.fg_state
        fn = self.engine.core_fn if core else self.engine.round_fn
        # every attempt draws the same DP noise, as the JAX package's fixed
        # per-round key does
        gen_state = self.noise_gen.get_state()
        norm_mult: Optional[float] = None
        retries = 0
        finite, healthy, unorm = True, True, 0.0
        while True:
            self.noise_gen.set_state(gen_state)
            with self.telemetry.span("round/compute"):
                out = fn(vars_before, plan.tasks_list, plan.idx_seq,
                         plan.mask_seq, self.noise_gen,
                         num_samples=plan.num_samples, fg_state=fg_before,
                         dropout_seq=plan.dropout_seq,
                         **self._robust_round_args(epoch, plan.num_samples,
                                                   norm_mult))
            new_vars, new_fg, payload, deltas_out = out[:4]
            if not self.engine.screening:
                # unscreened injection: faults flow through; with no norm
                # screen to escalate an unhealthy merge goes straight to
                # the rollback below
                if self._sentinel is not None:
                    healthy, unorm = self._sentinel.check(vars_before,
                                                          new_vars)
                break
            with self.guard.watch("round/screen_sync"), \
                    self.telemetry.span("round/screen_sync"):
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
            if self._sentinel is not None and not healthy:
                self.telemetry.counter("health_rollbacks").inc()
            if not core:
                payload = (payload[:1]
                           + (self.engine.global_evals(new_vars),)
                           + payload[2:])
        elif self._sentinel is not None:
            self._sentinel.commit(epoch, new_vars, unorm)
        if self._sentinel is not None:
            self._note_health(epoch, not forced, unorm)
        return (new_vars, new_fg, payload, deltas_out,
                out[4] if core else None, retries, forced)

    def _dispatch_overlap(self, epoch: int, t0: float,
                          plan: RoundPlan) -> RoundInFlight:
        """The overlap scheduler (overlap_eval): run the round CORE (train →
        [faults → screen] → aggregate) on the main stream, decide and
        commit the model update, THEN enqueue round N's eval batteries on
        the eval stream against the superseded round's snapshots. The
        pipelined loop dispatches round N+1's core right after this
        returns, so the batteries and round N's host work run beside N+1's
        training. Contracts:

        * bit identity — the batteries are the functions round_fn runs, on
          the same inputs (pre-fault deltas, the pre-round model, the
          committed model); nothing they read is written in place later;
        * sentinel before commit — the health check gates the merged model
          between the core and the battery dispatch, so the sentinel
          observes round N before anything of N+1 is enqueued;
        * retry cancellation — a rejected robust attempt never has a
          battery in flight: the batteries are enqueued once, for the
          accepted (or degraded) attempt, whose train deltas are those of
          every attempt (the plans and the start state are fixed)."""
        engine = self.engine
        vars_before, fg_before = self.global_vars, self.fg_state
        if engine.robust:
            (new_vars, new_fg, payload, deltas_out, eval_in, retries,
             forced) = self._robust_attempts(epoch, plan, core=True)
        else:
            new_vars, new_fg, payload, deltas_out, eval_in = engine.core_fn(
                vars_before, plan.tasks_list, plan.idx_seq, plan.mask_seq,
                self.noise_gen, num_samples=plan.num_samples,
                fg_state=fg_before, dropout_seq=plan.dropout_seq,
                tel=(self.telemetry if self._telemetry_split
                     else telemetry.NULL))
            retries, forced = 0, False
            if self._sentinel is not None:
                new_vars, forced = self._health_check(epoch, vars_before,
                                                      new_vars)
                if forced:
                    new_fg = fg_before
        fl = self._commit(epoch, t0, plan, payload, new_vars, new_fg,
                          n_retries=retries, forced=forced,
                          deltas_out=deltas_out)
        stream = self._eval_stream
        fl.keep = place_eval_inputs((vars_before, new_vars, eval_in), stream)

        def batteries() -> HostCopy:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                evals = engine.eval_batteries(vars_before, new_vars,
                                              plan.tasks_list, eval_in)
            return HostCopy(with_batteries(payload, *evals), stream)

        # in the pipelined loop a worker thread enqueues them: the host
        # runs only ~0.15 s ahead of the card (the launch queue is
        # shallow), so one thread enqueueing both the batteries and round
        # N+1 would serialize them
        fl.host = (PendingCopy(self.eval_worker().submit(batteries))
                   if self._pipelining else batteries())
        fl.overlapped = True
        fl.eval_dispatch_t = time.perf_counter()
        return fl

    def eval_worker(self) -> ThreadPoolExecutor:
        """The one thread that enqueues overlapped batteries, in order
        (made at first use; run() shuts it down)."""
        if self._eval_worker is None:
            self._eval_worker = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dba-eval")
        return self._eval_worker

    def finalize_round(self, fl: RoundInFlight) -> Dict[str, Any]:
        t_fin = time.perf_counter()
        self.telemetry.set_epoch(fl.epoch)
        # the wait for the round's host copy — where a wedged runtime
        # stalls, hence the watchdog zone
        with self.guard.watch("round/finalize"), \
                self.telemetry.span("round/finalize"):
            (locals_, globals_, metrics, delta_norms, wv, alpha,
             batches, is_updated, seg_locals, rstats,
             fstats) = to_host(fl.host.wait())
        fl.keep = None
        finalize_time = time.perf_counter() - t_fin
        if (self.device.type == "cuda"
                and not torch.cuda.current_stream(self.device).query()):
            self._finalized_ahead += 1
        # under pipelining round_time spans the overlap with the next
        # round's dispatch; dispatch_time and finalize_time are the honest
        # per-phase components
        times = {"round_time": time.perf_counter() - fl.t0,
                 "dispatch_time": fl.dispatch_time,
                 "finalize_time": finalize_time}
        if fl.overlapped:
            # of the wall time since the batteries were enqueued, finalize
            # only BLOCKED for finalize_time: the rest ran behind whatever
            # the caller dispatched in between (round N+1's core under the
            # pipelined loop)
            hidden = max(0.0, time.perf_counter() - fl.eval_dispatch_t
                         - finalize_time)
            self._overlap_rounds += 1
            self._overlap_hidden_s += hidden
            self._overlap_wait_s += finalize_time
            t = self.telemetry
            if t.enabled:
                t.counter("overlap/rounds").inc()
                t.gauge("overlap/hidden_eval_s").set(self._overlap_hidden_s)
                t.gauge("overlap/dispatch_ahead_depth").set(1.0)
                t.histogram("overlap/eval_wait_s").observe(finalize_time)
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
        self._flush_round_telemetry(fl, robust, delta_norms, times)
        return {"epoch": fl.epoch, "agents": fl.agent_names,
                "global_acc": float(globals_.clean.acc),
                "backdoor_acc": (float(globals_.poison.acc)
                                 if self.is_poison_run else None),
                **times, **robust}

    def _flush_round_telemetry(self, fl: RoundInFlight, robust: Dict[str,
                               Any], delta_norms, times) -> None:
        """Per-round metrics update + flush: one telemetry.jsonl line with
        the round's counters and gauges and the span-duration and
        delta-norm histogram windows (mirrored to TensorBoard when
        wired)."""
        t = self.telemetry
        if not t.enabled:
            return
        t.counter("rounds").inc()
        if fl.n_retries:
            t.counter("round_retries").inc(fl.n_retries)
        if robust.get("n_quarantined"):
            t.counter("clients_quarantined").inc(robust["n_quarantined"])
        if robust.get("n_dropped"):
            t.counter("clients_dropped").inc(robust["n_dropped"])
        if robust.get("degraded"):
            t.counter("degraded_rounds").inc()
        for n in np.asarray(delta_norms).reshape(-1):
            t.histogram("delta_norm").observe(float(n))
        t.histogram("round_seconds").observe(times["round_time"])
        t.flush_round(fl.epoch)

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

    def _state_after(self, fl: Optional[RoundInFlight]) -> Dict[str, Any]:
        """What a snapshot saves of the device state: the global model,
        FoolsGold's memory and (stale lane) the received deltas — after
        round `fl`, or the live ones."""
        if fl is None:
            vars_, fg, prev = self.global_vars, self.fg_state, \
                self._prev_deltas
        else:
            vars_, fg, prev = fl.vars_after, fl.fg_after, fl.deltas_after
        if not self.engine.fault_cfg.stale_enabled:
            prev = None
        return {"vars": vars_, "fg": fg.memory, "prev": prev}

    def save_model(self, epoch: int, fl: Optional[RoundInFlight] = None,
                   async_save: bool = False,
                   extra_aux: Optional[Dict[str, Any]] = None) -> None:
        """Checkpoint the round's post-aggregation state: model_last, plus
        .epoch_N for save_on_epochs and .best whenever the global eval loss
        improves (helper.py:433-435). Every snapshot gets the full-state
        sidecar, then its manifest (covering the sidecar); a snapshot being
        overwritten is cloned to .prev until its replacement verifies;
        retention GC runs last. With `fl` the state captured at that
        round's dispatch is saved (under pipelining the live attributes
        already belong to the next round); `async_save` queues the writes
        on the checkpoint writer thread (run() waits for it before it
        returns). `extra_aux` merges more keys into the sidecar: the async
        engine's streaming state (``async_state``)."""
        params = self.params
        if not params["save_model"] or self.folder is None:
            return
        with self.telemetry.span("round/checkpoint"):
            self._save(epoch, fl, async_save, extra_aux)

    def _save(self, epoch: int, fl: Optional[RoundInFlight],
              async_save: bool, extra_aux: Optional[Dict[str, Any]]) -> None:
        t0 = time.perf_counter()
        mgr = self.checkpoint_manager
        if fl is None:
            src, rng = self._state_after(None), self._snapshot_rng()
            health = (self._sentinel.state() if self._sentinel is not None
                      else None)
        else:
            rng, health = fl.rng_after, fl.health_after
            if fl.saved is None:
                src = self._state_after(fl)
            elif async_save:
                # the writer waits for the copy, the caller does not
                ckpt.async_job(fl.saved.wait)
                src = fl.saved.host
            else:
                src = fl.saved.wait()
        path = self.folder / "model_last.pt.tar"
        lr = float(self.params["lr"])
        written = [path]
        if epoch in list(self.params["save_on_epochs"]):
            written.append(Path(str(path) + f".epoch_{epoch}"))
        if self.last_global_loss < self.best_loss:
            written.append(Path(str(path) + ".best"))
            self.best_loss = self.last_global_loss
        # (the async keyword only when set: wrappers of the plain calls
        # keep working)
        kw = {"async_save": True} if async_save else {}
        mgr.prepare_overwrite(written, **kw)
        # the sidecar (a deviation from the reference, which loses these on
        # restart): every snapshot gets one, so resuming from .epoch_N or
        # .best does not silently reset the defense either
        aux = {"epoch": int(epoch),
               "fg_memory": src["fg"].detach().cpu(),
               "best_loss": float(self.best_loss),
               "last_backdoor_acc": self.last_backdoor_acc, **rng}
        if src["prev"] is not None:
            # the stale lane's replay source: what the server received this
            # round (model-sized × C; the lane is opt-in)
            aux["prev_deltas"] = {
                "params": {k: v.detach().cpu()
                           for k, v in src["prev"].params.items()},
                "batch_stats": {k: v.detach().cpu() for k, v in
                                src["prev"].batch_stats.items()}}
        if health is not None:
            aux["health"] = health
        if extra_aux:
            aux.update(extra_aux)
        for p in written:
            ckpt.save_checkpoint(p, src["vars"], epoch, lr,
                                 async_save=async_save)
            ckpt.save_aux_state(p, aux, async_save=async_save)
        mgr.note_saved(written, epoch, **kw)
        mgr.gc(**kw)
        logger.info("epoch %d: %s %d snapshot(s) in %.3fs: %s", epoch,
                    "queued" if async_save else "saved", len(written),
                    time.perf_counter() - t0, [p.name for p in written])

    def run(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        """Run rounds start_epoch..epochs (the config's when None) under
        the guard: SIGTERM/SIGINT handlers are installed around the loop
        (and the previous ones restored after) when graceful_shutdown is
        on. Every exit path waits for the queued checkpoint writes and
        writes the telemetry trace and summary."""
        self.interrupted = False
        with self.guard:
            try:
                return self._run_rounds(epochs)
            finally:
                try:
                    if self._eval_worker is not None:
                        self._eval_worker.shutdown(wait=True)
                        self._eval_worker = None
                    with self.guard.watch("checkpoint/wait_async"):
                        ckpt.wait_for_async_saves()
                finally:
                    self._finish_telemetry()

    def _finish_telemetry(self) -> None:
        t = self.telemetry
        if not t.enabled:
            return
        t.record_memory()
        t.close()
        print(t.summary_table(), flush=True)

    def _warm_kernels(self) -> None:
        """Build (or load) every kernel library the rounds launch — on the
        card, the fused update's — before the first round: mark_warm()
        fires after the first full round, and a build after it is counted
        as a regression. Nothing to build on the CPU."""
        if self.device.type == "cuda":
            from dba_mod_tpu_torch.ops import fused_update
            fused_update._load()

    @contextlib.contextmanager
    def _profile(self, folder: str, epoch: int):
        """torch.profiler over one round (CPU and, on the card, CUDA
        activity), exported as a Chrome trace into `folder`."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        out = Path(folder)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"round_{epoch}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        logger.info("epoch %d: torch.profiler trace written to %s", epoch,
                    path)

    def _run_rounds(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        if self.params["mode"] == "async":
            # the buffered-async engine owns the whole loop: cohort
            # dispatch, arrivals, K-arrival merges, recording and
            # checkpoints
            from dba_mod_tpu_torch.fl.async_rounds import AsyncDriver
            self.async_driver = AsyncDriver(self)
            return self.async_driver.run(epochs)
        end = epochs if epochs is not None else int(self.params["epochs"])
        profile_dir = str(self.params.get("profile_dir", "") or "")
        if self.telemetry.enabled:
            with self.telemetry.span("engine/warm_buckets"):
                self._warm_kernels()
        # pipeline_rounds / overlap_eval: the depth-1 pipelined loop.
        # Profiling forces sequential rounds (a trace needs one round
        # alone on the timeline), and so does telemetry: finalize(N)
        # flushes round N's histogram window, which dispatch(N+1) would
        # otherwise fill with round N+1's spans
        if ((bool(self.params.get("pipeline_rounds", False))
                or self._overlap)
                and not profile_dir and not self.telemetry.enabled):
            return self._run_pipelined(end)
        last: Dict[str, Any] = {}
        for epoch in range(self.start_epoch, end + 1, self.interval):
            if self.guard.stop_requested:
                # round-boundary stop: the previous round's save_model
                # already wrote a verified checkpoint and the recorder
                # saved — nothing in flight to lose
                self._note_interrupted(epoch)
                break
            self.guard.watchdog.epoch = epoch
            if profile_dir and epoch == self.start_epoch + self.interval:
                # trace the first round after warm-up
                with self._profile(profile_dir, epoch):
                    last = self.run_round(epoch)
            else:
                last = self.run_round(epoch)
            self.save_model(epoch)
            self.telemetry.mark_warm()   # the first full round ends warm-up
            logger.info("epoch %d done in %.2fs acc=%.2f backdoor=%s",
                        epoch, last["round_time"], last["global_acc"],
                        last["backdoor_acc"])
        return last

    def _run_pipelined(self, end: int) -> Dict[str, Any]:
        """Depth 1: round N+1 is dispatched before round N is finalized,
        so N's host work (and, under overlap_eval, its batteries on the
        eval stream) runs beside N+1's device work. Checkpoints are async
        saves of the state captured at dispatch, written in program
        order."""
        def finalize_and_log(fl: RoundInFlight) -> Dict[str, Any]:
            r = self.finalize_round(fl)
            self.save_model(fl.epoch, fl=fl, async_save=True)
            self.telemetry.mark_warm()
            logger.info("epoch %d done in %.2fs acc=%.2f backdoor=%s",
                        r["epoch"], r["round_time"], r["global_acc"],
                        r["backdoor_acc"])
            return r

        self._pipelining = True
        last: Dict[str, Any] = {}
        pending: Optional[RoundInFlight] = None
        try:
            for epoch in range(self.start_epoch, end + 1, self.interval):
                if self.guard.stop_requested:
                    self._note_interrupted(epoch)
                    break
                self.guard.watchdog.epoch = epoch
                fl = self.dispatch_round(epoch)
                if pending is not None:
                    last = finalize_and_log(pending)
                pending = fl
            if pending is not None:
                last = finalize_and_log(pending)
        finally:
            self._pipelining = False
        return last

    def _note_interrupted(self, next_epoch: int) -> None:
        """A graceful stop was honored at a round boundary: record it so
        the CLI exits with run_guard.EXIT_INTERRUPTED and a wrapper can
        relaunch with ``--resume auto``."""
        self.interrupted = True
        telemetry.count("run/interrupted")
        logger.warning(
            "graceful stop honored at the round boundary before epoch %d — "
            "exiting (resume with --resume auto)", next_epoch)
