"""Experiment configuration.

Accepts the reference's flat-YAML schema verbatim (same key names, including the
stringly per-adversary keys ``{i}_poison_epochs`` / ``{i}_poison_pattern`` /
``{i}_poison_trigger_names`` / ``{i}_poison_trigger_values`` — see reference
`utils/cifar_params.yaml`, `image_train.py:43`, `loan_train.py:51-57`), but exposes
them through typed accessors so the rest of the framework never string-concatenates
config keys.

Unlike the reference (which mutates the params dict at runtime, `helper.py:44-48`),
``Params`` is read-mostly: runtime-derived fields live in explicit attributes.

The PyTorch port's own copy of ``dba_mod_tpu/config.py``: it accepts every
key of the same schema, with the same validation.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, List

import yaml

# Dataset type tags (reference config.py:10-13).
TYPE_CIFAR = "cifar"
TYPE_MNIST = "mnist"
TYPE_TINYIMAGENET = "tiny-imagenet-200"
TYPE_LOAN = "loan"

IMAGE_TYPES = (TYPE_CIFAR, TYPE_MNIST, TYPE_TINYIMAGENET)

# Aggregation method names (reference config.py:4-6).
AGGR_MEAN = "mean"
AGGR_GEO_MED = "geom_median"
AGGR_FOOLSGOLD = "foolsgold"
# Byzantine-robust rules beyond the reference (ROADMAP item 3; no reference
# counterpart — ops/aggregation.py documents the papers and the
# survivor-mask contract they share with the three above).
AGGR_KRUM = "krum"
AGGR_TRIMMED_MEAN = "trimmed_mean"
AGGR_MEDIAN = "median"
AGGR_ALL = (AGGR_MEAN, AGGR_GEO_MED, AGGR_FOOLSGOLD, AGGR_KRUM,
            AGGR_TRIMMED_MEAN, AGGR_MEDIAN)

_REQUIRED_KEYS = ("type", "lr", "batch_size", "epochs", "no_models",
                  "number_of_total_participants", "eta", "aggregation_methods")

_DEFAULTS: Dict[str, Any] = {
    "test_batch_size": 64,
    "momentum": 0.9,
    "decay": 0.0005,
    "internal_epochs": 1,
    "internal_poison_epochs": 1,
    "poisoning_per_batch": 1,
    "aggr_epoch_interval": 1,
    "geom_median_maxiter": 10,
    "fg_use_memory": True,
    "participants_namelist": [],
    "is_random_namelist": True,
    "is_random_adversary": False,
    "is_poison": False,
    "baseline": False,
    "scale_weights_poison": 1.0,
    "sampling_dirichlet": True,
    "dirichlet_alpha": 0.5,
    "poison_label_swap": 0,
    "adversary_list": [],
    "centralized_test_trigger": True,
    "trigger_num": 0,
    "poison_epochs": [],
    "poison_lr": 0.05,
    "poison_step_lr": True,
    "alpha_loss": 1.0,
    "diff_privacy": False,
    "sigma": 0.01,
    "save_model": False,
    "save_on_epochs": [],
    "resumed_model": False,
    "resumed_model_name": "",
    # per-batch tracking channels (reference image_train.py:108-117, :232-246;
    # the reference only plots these to visdom — here they are recorded)
    "vis_train_batch_loss": False,
    "batch_track_distance": False,
    # RFA update-norm rejection threshold (reference helper.py:360-369; its
    # MAX_UPDATE_NORM constant at config.py:7 is dormant — None keeps parity)
    "max_update_norm": None,
    "environment_name": "dba_tpu",
    "log_interval": 2,
    "results_json": True,
    "random_seed": 1,
    # framework-specific knobs (not in the reference schema)
    "compute_dtype": "float32",    # "bfloat16" runs fwd/bwd on the MXU in
                                   # bf16; params/optimizer/aggregation stay
                                   # float32
    "eval_batch_size": 0,          # 0 = use test_batch_size
    "local_eval": True,            # per-client eval battery (reference
                                   # image_train.py:150-164, 268-299)
    "profile_dir": "",             # non-empty: profiler traces per round
    "tensorboard": False,          # scalar summaries (imports TensorFlow)
    "telemetry": False,            # span tracing + metrics registry + XLA
                                   # compile/memory instrumentation
                                   # (utils/telemetry.py): writes
                                   # telemetry.jsonl + Chrome-trace
                                   # trace.json per run, adds honest
                                   # device-sync points to phase spans
                                   # (serializes round pipelining); off =
                                   # no files, no per-round work beyond a
                                   # no-op check
    "telemetry_dir": "",           # where telemetry files land; "" = the
                                   # run folder (in-memory only when the
                                   # run saves no results)
    "forensics": False,            # defense-forensics layer
                                   # (utils/forensics.py): per-client
                                   # aggregation diagnostics — delta/received
                                   # norms, cosine to the applied update,
                                   # screening verdict + quarantine reason,
                                   # FoolsGold/RFA weights and similarities,
                                   # poison-battery accuracy — ride the
                                   # round payload's single fetch and stream
                                   # to forensics.jsonl +
                                   # client_forensics.csv (TensorBoard
                                   # mirror under forensics/ when
                                   # tensorboard is on); `report` renders
                                   # the HTML round-audit. Off = strict
                                   # no-op: nothing traced, no files,
                                   # bit-identical recorded metrics
    "sequential_debug": False,     # run clients one-by-one (A/B vs vmapped)
    "data_dir": "./data",
    "synthetic_data": False,       # force the synthetic dataset backend
    "synthetic_train_size": 0,     # 0 = backend default
    "synthetic_test_size": 0,      # 0 = backend default
    "synthetic_noise_std": 25.0,   # task difficulty: 25 saturates (smoke
                                   # runs); ~90 plateaus below 100% like
                                   # real data (datasets.py docstring)
    "num_devices": 0,              # 0 = use all visible devices on the clients mesh
    "run_dir": "./runs",
    "checkpoint_dir": "saved_models",  # root for resume/pretrain checkpoints
    "dynamic_steps": False,        # size each round's batch plan to the
                                   # round's own max client (bucketed to limit
                                   # recompiles) instead of the global max;
                                   # identical numerics (padding steps are
                                   # fully-masked no-ops)
    "pipeline_rounds": False,      # overlap round N's host fetch with round
                                   # N+1's device compute in Experiment.run
    "overlap_eval": False,         # split the fused round program and overlap
                                   # round N's eval batteries + host
                                   # record/checkpoint with round N+1's
                                   # train/aggregate dispatch (async engine:
                                   # pipeline host bookkeeping with the next
                                   # merge). Eval inputs are snapshots of the
                                   # superseded model, so recorded metrics are
                                   # bit-identical to the serial path; off
                                   # (default) is a strict bit-identical no-op
    "fused_updates": "auto",       # JAX package: fused Pallas per-step
                                   # update; read and ignored by the port
                                   # (the CUDA kernel is its only path)
    "fused_interpret": False,      # JAX package: Pallas interpret mode;
                                   # read and ignored by the port
    "grouped_clients": False,      # grouped-layout client execution
                                   # (models/grouped.py; BasicBlock
                                   # ResNets only)
    # --- wider defense grid (ops/aggregation.py; ROADMAP item 3) ---
    "krum_m": 1,                   # multi-Krum selection count (1 = classic
                                   # Krum): the m lowest-scoring clients are
                                   # averaged into the applied update
    "krum_byzantine_f": 0,         # assumed Byzantine count f in the Krum
                                   # score (each client scored over its
                                   # n-f-2 nearest peers)
    "trimmed_mean_beta": 0.1,      # per-coordinate trim fraction: drop the
                                   # floor(beta*n) smallest and largest
                                   # survivor values before averaging
    # --- asynchronous buffered federation (fl/async_rounds.py; README
    #     "Asynchronous federation"). mode: "sync" (default) is a strict
    #     no-op for every knob in this block — the lockstep engine does not
    #     read them.
    "mode": "sync",                # "async" = FedBuff-style buffered
                                   # streaming server: clients arrive
                                   # continuously, the server merges every
                                   # buffer_k arrivals with
                                   # staleness-weighted partial
                                   # participation
    "buffer_k": 0,                 # merge every K arrivals; 0 = no_models
                                   # (with zero staleness weighting that
                                   # reduces bit-exactly to the sync round)
    "staleness_weighting": "none",  # per-update weight w(s) of merge-step
                                   # staleness s: "none" (w=1 — the parity
                                   # mode), "polynomial" (1/(1+s)^alpha),
                                   # "exponential" (alpha^s)
    "staleness_alpha": 0.5,        # the alpha of polynomial/exponential
    "arrival_rate": 1.0,           # mean client arrivals per unit virtual
                                   # time (exponential inter-arrival)
    "arrival_jitter": 0.0,         # lognormal sigma multiplying each
                                   # client's service delay (0 = none)
    "straggler_tail": 0.0,         # P(client is a straggler this wave)
    "straggler_factor": 10.0,      # straggler delay multiplier
    "async_steps": 0,              # aggregation steps to run; 0 = derive
                                   # from epochs (epochs*no_models/buffer_k
                                   # — the same total client-update budget
                                   # as the sync run)
    # --- self-healing server loop (fl/async_rounds.py, fl/experiment.py;
    #     README "Self-healing federation"). Every knob here is a strict
    #     bit-identical no-op at its default.
    "merge_timeout_v": 0.0,        # virtual-seconds merge deadline: fire a
                                   # partial merge when the oldest buffered
                                   # arrival has waited this long and >=
                                   # merge_min_k updates are buffered
                                   # (inert-lane padding handles the short
                                   # batch); 0 = K-arrivals-only merges
    "merge_min_k": 1,              # minimum buffered updates for a
                                   # deadline-triggered partial merge
    "starvation_policy": "abort",  # after 200 consecutive empty cohorts:
                                   # "abort" (raise — the pre-existing
                                   # behaviour), "carry" (record a carried
                                   # no-op step and keep going), "wait"
                                   # (keep drawing cohorts indefinitely;
                                   # the watchdog is the backstop)
    "max_outstanding_waves": 0,    # admission control: stop dispatching
                                   # new waves while this many are still
                                   # resident (straggler tails otherwise
                                   # grow _waves unboundedly); 0 = no cap
    "arrival_ttl_v": 0.0,          # expire heap arrivals older (in virtual
                                   # seconds) than this at pop time — the
                                   # update never reaches the buffer and
                                   # its lane is freed; 0 = never expire
    "model_health_check": False,   # jitted post-merge sentinel in BOTH
                                   # engines: all-finite params + update
                                   # norm vs a trailing EMA band; an
                                   # unhealthy merge rolls back to the
                                   # last-good ring and re-merges the same
                                   # buffer with escalated screening
    "health_norm_band": 0.0,       # flag a merge whose update norm exceeds
                                   # band × trailing-EMA(update norm);
                                   # 0 disables the norm band (the finite
                                   # check still runs when the sentinel is
                                   # on)
    "health_ema_alpha": 0.1,       # EMA smoothing for the trailing update
                                   # norm (new = a*obs + (1-a)*old)
    "health_warmup_merges": 3,     # merges before the norm band arms (the
                                   # EMA needs history; finite check is
                                   # active from merge 1)
    "rollback_ring": 0,            # last-good in-memory model versions
                                   # kept for health rollback; 0 = ring off
                                   # (an unhealthy merge then only skips +
                                   # carries, it cannot roll back)
    # --- fault model & robustness (fl/faults.py, README "Fault model") ---
    "fault_injection": False,      # master switch for the deterministic
                                   # fault harness (fl/faults.py); off =
                                   # nothing traced, zero cost
    "fault_seed": 0,               # fault plans are f(fault_seed, epoch) —
                                   # independent of every other RNG stream
    "fault_dropout_prob": 0.0,     # P(client never reports this round)
    "fault_corrupt_prob": 0.0,     # P(payload arrives NaN-corrupted)
    "fault_blowup_prob": 0.0,      # P(payload scaled by blowup factor)
    "fault_blowup_factor": 1e8,    # norm-blowup magnitude
    "fault_stale_prob": 0.0,       # P(client replays last round's delta)
    "fault_host_loss_prob": 0.0,   # P(the round loses one whole HOST):
                                   # multi-process runs SIGKILL the victim
                                   # process at the round boundary (CI for
                                   # the elastic detect→restart path);
                                   # single-process runs drop the victim
                                   # virtual host's client slice through
                                   # the survivor mask
    "fault_num_hosts": 0,          # virtual host count for single-process
                                   # host-loss simulation (>= 2 required
                                   # when the lane is on); multi-process
                                   # runs use the real process count
    "screen_updates": "auto",      # server-side delta validation/quarantine
                                   # (finite + norm screen): "auto" = on iff
                                   # fault_injection; true/false to force
    "screen_norm_mult": 0.0,       # quarantine ‖Δ‖ > mult × survivor-median
                                   # norm; 0 disables the norm screen (the
                                   # finite screen always runs when
                                   # screening is on); retries escalate this
    "max_round_retries": 2,        # re-runs of a round whose aggregated
                                   # model goes non-finite (escalated
                                   # screening each attempt)
    "retry_backoff_s": 0.0,        # host backoff before retry k:
                                   # min(retry_backoff_s · 2^(k-1), 30 s)
    "min_surviving_clients": 1,    # fewer survivors → skip aggregation,
                                   # carry the global model, mark the round
                                   # degraded
    # --- crash/preemption tolerance (utils/run_guard.py, checkpoint.py;
    #     README "Crash & preemption tolerance") ---
    # resumed_model additionally accepts the string "auto": discover the
    # newest VERIFIED checkpoint across run_dir's run folders, reuse that
    # run folder, and continue its recorder stream past the resume epoch
    "graceful_shutdown": False,    # SIGTERM/SIGINT → finish the round,
                                   # write a final verified checkpoint,
                                   # flush recorder/telemetry, exit 75;
                                   # second signal forces immediate exit.
                                   # Off = no signal handlers installed
    "watchdog_soft_s": 0.0,        # stall diagnostic (span stack, epoch,
                                   # elapsed) when a host sync point blocks
                                   # this long; 0 = off (no thread)
    "watchdog_hard_s": 0.0,        # abort the process (exit 76) when a
                                   # sync point blocks this long — a wedged
                                   # run dies checkpointed instead of
                                   # burning quota; 0 = off
    "checkpoint_manifests": True,  # write + verify per-snapshot integrity
                                   # manifests (sha256 over the orbax step
                                   # dir + aux sidecar); required for
                                   # resumed_model: auto, which restores
                                   # only verified snapshots
    "keep_last_n": 0,              # checkpoint retention: keep only the
                                   # newest N *.epoch_N snapshots
                                   # (model_last and .best always kept);
                                   # 0 = keep all
    # --- elastic multi-host (parallel/distributed.py::PeerHealth;
    #     README "Elastic multi-host"). All strict no-ops single-host or
    #     when heartbeat_interval_s is 0: no thread, no files, no
    #     per-round work.
    "heartbeat_interval_s": 0.0,   # per-host heartbeat cadence in a
                                   # multi-process run; 0 = elastic layer
                                   # off
    "heartbeat_timeout_s": 0.0,    # heartbeat staleness past this = the
                                   # peer is GONE (not slow) → exit 77;
                                   # 0 = 6 × heartbeat_interval_s
    "heartbeat_barrier_s": 0.0,    # bounded round-boundary barrier: wait
                                   # up to this long for every peer to
                                   # reach the boundary (timeout = slow
                                   # peer, proceed; stale = PeerLost);
                                   # 0 = non-blocking staleness check only
    "heartbeat_dir": "",           # shared dir for heartbeat files; "" =
                                   # <run_folder>/_peers (per-run — twin
                                   # worlds in one run_dir must not read
                                   # each other's beats), or
                                   # <run_dir>/_peers when the run saves
                                   # no results. Must be on a filesystem
                                   # every host can reach.
    "run_name": "",                # fixed run-folder name (run_dir/
                                   # run_name) instead of the timestamped
                                   # default — REQUIRED for multi-process
                                   # runs that save results/checkpoints,
                                   # so every process and every elastic
                                   # relaunch agrees on one folder
}


@dataclasses.dataclass
class Params:
    """Typed view over a reference-schema config dict."""

    raw: Dict[str, Any]
    current_time: str = dataclasses.field(
        default_factory=lambda: time.strftime("%b.%d_%H.%M.%S"))

    # ------------------------------------------------------------------ loading
    @classmethod
    def from_yaml(cls, path: str | Path) -> "Params":
        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Params":
        merged = copy.deepcopy(_DEFAULTS)
        merged.update(raw or {})
        missing = [k for k in _REQUIRED_KEYS if k not in merged]
        if missing:
            raise ValueError(f"config missing required keys: {missing}")
        if merged["aggregation_methods"] not in AGGR_ALL:
            raise ValueError(
                f"unknown aggregation_methods: {merged['aggregation_methods']!r}")
        if merged["type"] not in IMAGE_TYPES + (TYPE_LOAN,):
            raise ValueError(f"unknown workload type: {merged['type']!r}")
        if merged["screen_updates"] not in ("auto", True, False):
            raise ValueError(
                f"screen_updates must be 'auto'/true/false, got "
                f"{merged['screen_updates']!r}")
        if int(merged["max_round_retries"]) < 0:
            raise ValueError("max_round_retries must be >= 0")
        if int(merged["min_surviving_clients"]) < 1:
            raise ValueError("min_surviving_clients must be >= 1")
        rm = merged["resumed_model"]
        if not isinstance(rm, bool) and rm != "auto":
            raise ValueError(
                f"resumed_model must be true/false/'auto', got {rm!r}")
        if rm == "auto" and not bool(merged["checkpoint_manifests"]):
            # auto-resume restores only VERIFIED snapshots — without
            # manifests it can never find one and every relaunch would
            # silently discard all progress
            raise ValueError(
                "resumed_model: auto requires checkpoint_manifests: true "
                "(auto-resume only restores manifest-verified checkpoints)")
        soft = float(merged["watchdog_soft_s"])
        hard = float(merged["watchdog_hard_s"])
        if soft < 0 or hard < 0:
            raise ValueError("watchdog_soft_s/watchdog_hard_s must be >= 0")
        if 0 < hard < soft:
            raise ValueError(
                f"watchdog_hard_s ({hard}) must be >= watchdog_soft_s "
                f"({soft}) — the soft diagnostic must fire before the abort")
        if int(merged["keep_last_n"]) < 0:
            raise ValueError("keep_last_n must be >= 0")
        hb = float(merged["heartbeat_interval_s"])
        hb_to = float(merged["heartbeat_timeout_s"])
        hb_bar = float(merged["heartbeat_barrier_s"])
        if hb < 0 or hb_to < 0 or hb_bar < 0:
            raise ValueError("heartbeat_interval_s/heartbeat_timeout_s/"
                             "heartbeat_barrier_s must be >= 0")
        if 0 < hb_to <= hb:
            raise ValueError(
                f"heartbeat_timeout_s ({hb_to}) must exceed "
                f"heartbeat_interval_s ({hb}) — a peer must get at least "
                "one beat window before being declared gone")
        if int(merged["fault_num_hosts"]) < 0:
            raise ValueError("fault_num_hosts must be >= 0")
        if not isinstance(merged["forensics"], bool):
            raise ValueError(
                f"forensics must be true/false, got {merged['forensics']!r}")
        if int(merged["krum_m"]) < 1:
            raise ValueError("krum_m must be >= 1")
        if int(merged["krum_byzantine_f"]) < 0:
            raise ValueError("krum_byzantine_f must be >= 0")
        beta = float(merged["trimmed_mean_beta"])
        if not 0.0 <= beta < 0.5:
            raise ValueError(
                f"trimmed_mean_beta must be in [0, 0.5), got {beta}")
        if merged["mode"] not in ("sync", "async"):
            raise ValueError(
                f"mode must be 'sync' or 'async', got {merged['mode']!r}")
        if int(merged["buffer_k"]) < 0:
            raise ValueError("buffer_k must be >= 0 (0 = no_models)")
        if merged["staleness_weighting"] not in ("none", "polynomial",
                                                 "exponential"):
            raise ValueError(
                "staleness_weighting must be 'none'/'polynomial'/"
                f"'exponential', got {merged['staleness_weighting']!r}")
        if float(merged["arrival_rate"]) <= 0:
            raise ValueError("arrival_rate must be > 0")
        if float(merged["arrival_jitter"]) < 0:
            raise ValueError("arrival_jitter must be >= 0")
        tail = float(merged["straggler_tail"])
        if not 0.0 <= tail <= 1.0:
            raise ValueError(f"straggler_tail must be in [0, 1], got {tail}")
        if float(merged["straggler_factor"]) < 1.0:
            raise ValueError("straggler_factor must be >= 1")
        if int(merged["async_steps"]) < 0:
            raise ValueError("async_steps must be >= 0")
        if float(merged["merge_timeout_v"]) < 0:
            raise ValueError("merge_timeout_v must be >= 0 (0 = off)")
        if int(merged["merge_min_k"]) < 1:
            raise ValueError("merge_min_k must be >= 1")
        if merged["starvation_policy"] not in ("wait", "carry", "abort"):
            raise ValueError(
                "starvation_policy must be 'wait'/'carry'/'abort', got "
                f"{merged['starvation_policy']!r}")
        if int(merged["max_outstanding_waves"]) < 0:
            raise ValueError("max_outstanding_waves must be >= 0 (0 = no cap)")
        if float(merged["arrival_ttl_v"]) < 0:
            raise ValueError("arrival_ttl_v must be >= 0 (0 = never expire)")
        if float(merged["health_norm_band"]) < 0:
            raise ValueError("health_norm_band must be >= 0 (0 = off)")
        alpha_h = float(merged["health_ema_alpha"])
        if not 0.0 < alpha_h <= 1.0:
            raise ValueError(
                f"health_ema_alpha must be in (0, 1], got {alpha_h}")
        if int(merged["health_warmup_merges"]) < 0:
            raise ValueError("health_warmup_merges must be >= 0")
        if int(merged["rollback_ring"]) < 0:
            raise ValueError("rollback_ring must be >= 0 (0 = ring off)")
        if merged["mode"] == "async":
            # the async engine's constraints, rejected at validation so a
            # bad combo fails before data loading: FoolsGold's cross-round
            # memory is keyed to lockstep rounds (a buffered merge has no
            # per-round participant row to update), interval>1 segment
            # chaining has no arrival-process analog, and sequential_debug
            # bypasses the vmapped wave training the engine dispatches.
            if merged["aggregation_methods"] == AGGR_FOOLSGOLD:
                raise ValueError(
                    "mode: async does not support foolsgold aggregation "
                    "(cross-round memory is keyed to lockstep rounds)")
            if int(merged["aggr_epoch_interval"]) != 1:
                raise ValueError(
                    "mode: async requires aggr_epoch_interval: 1")
            if merged["sequential_debug"]:
                raise ValueError(
                    "mode: async is incompatible with sequential_debug")
        return cls(raw=merged)

    # ------------------------------------------------------------- dict access
    def __getitem__(self, key: str) -> Any:
        return self.raw[key]

    def __contains__(self, key: str) -> bool:
        return key in self.raw

    def get(self, key: str, default: Any = None) -> Any:
        return self.raw.get(key, default)

    # ------------------------------------------------------------- shorthands
    @property
    def type(self) -> str:
        return self.raw["type"]

    @property
    def is_image(self) -> bool:
        return self.type in IMAGE_TYPES

    @property
    def aggregation(self) -> str:
        return self.raw["aggregation_methods"]

    @property
    def resume_mode(self) -> str:
        """'off' | 'named' (checkpoint_dir/resumed_model_name) | 'auto'
        (discover the newest verified checkpoint under run_dir)."""
        rm = self.raw["resumed_model"]
        if rm == "auto":
            return "auto"
        return "named" if rm else "off"

    @property
    def adversary_list(self) -> List[Any]:
        return list(self.raw["adversary_list"])

    @property
    def num_adversaries(self) -> int:
        return len(self.raw["adversary_list"])

    @property
    def is_centralized_attack(self) -> bool:
        # A single adversary means "centralized" mode: it stamps the *global*
        # (combined) pattern instead of a per-adversary sub-pattern
        # (reference image_train.py:47-48, main.py:225-231).
        return self.num_adversaries == 1

    # ------------------------------------------------- per-adversary accessors
    def is_adversary(self, agent_name: Any) -> bool:
        return agent_name in self.raw["adversary_list"]

    def adversary_slot_of(self, agent_name: Any) -> int:
        """Position of `agent_name` in adversary_list, or -1 if benign.

        The *slot* keys the poison schedule (``{slot}_poison_epochs``) even in
        centralized mode — the reference resolves the schedule before forcing
        the pattern index to -1 (image_train.py:38-48).
        """
        try:
            return self.adversary_list.index(agent_name)
        except ValueError:
            return -1

    def adversarial_index_of(self, agent_name: Any) -> int:
        """Trigger-pattern index for `agent_name`: its slot, or -1 for benign
        agents AND for the lone attacker in centralized mode, which trains on
        the combined/global pattern (image_train.py:47-48). Use
        :meth:`is_adversary` to distinguish the two -1 cases.
        """
        idx = self.adversary_slot_of(agent_name)
        if idx >= 0 and self.is_centralized_attack:
            return -1
        return idx

    def poison_epochs_for(self, adv_slot: int) -> List[int]:
        """Poison schedule for adversary slot `adv_slot` (``{slot}_poison_epochs``).

        A missing per-slot key for a real adversary slot is a config error and
        raises KeyError, matching the reference's unconditional lookup
        (image_train.py:43, main.py:151); the global ``poison_epochs`` list is
        only the benign-agent default (image_train.py:38).
        """
        if adv_slot >= 0:
            return list(self.raw[f"{adv_slot}_poison_epochs"])
        return list(self.raw["poison_epochs"])

    def poison_pattern_for(self, adv_index: int) -> List[List[int]]:
        """Pixel trigger for adversary slot; -1 = union of all sub-patterns
        (reference image_helper.py:328-335)."""
        if adv_index == -1:
            pattern: List[List[int]] = []
            for i in range(int(self.raw["trigger_num"])):
                pattern.extend(self.raw[f"{i}_poison_pattern"])
            return pattern
        return list(self.raw[f"{adv_index}_poison_pattern"])

    def poison_trigger_features_for(self, adv_index: int):
        """LOAN feature trigger (names, values) for slot; -1 = all
        concatenated (reference loan_train.py:47-57)."""
        names: List[str] = []
        values: List[float] = []
        if adv_index == -1:
            for i in range(int(self.raw["trigger_num"])):
                names.extend(self.raw[f"{i}_poison_trigger_names"])
                values.extend(self.raw[f"{i}_poison_trigger_values"])
        else:
            names = list(self.raw[f"{adv_index}_poison_trigger_names"])
            values = list(self.raw[f"{adv_index}_poison_trigger_values"])
        return names, values

    # ---------------------------------------------------------------- run dir
    def write_yaml(self, folder: Path) -> None:
        """Record the effective config in a run folder (overwrites — an
        auto-resumed run re-records the config it resumed with)."""
        with open(Path(folder) / "params.yaml", "w") as f:
            yaml.dump(self.raw, f)

    @property
    def run_name(self) -> str:
        """Fixed run-folder name ('' = timestamped default). Multi-process
        runs that save results must set it: every process — and every
        elastic relaunch of the survivors — has to agree on ONE folder,
        which per-process timestamps cannot guarantee."""
        return str(self.raw.get("run_name", "") or "")

    def make_run_folder(self) -> Path:
        name = self.run_name or f"{self.type}_{self.current_time}"
        folder = Path(self.raw["run_dir"]) / name
        folder.mkdir(parents=True, exist_ok=True)
        self.write_yaml(folder)
        return folder
