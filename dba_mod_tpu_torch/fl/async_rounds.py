"""Buffered-asynchronous federation, the FedBuff-style streaming engine
(port of dba_mod_tpu/fl/async_rounds.py; Nguyen et al., *Federated Learning
with Buffered Asynchronous Aggregation*, AISTATS 2022).

The synchronous engine (fl/experiment.py) is a barrier per round. Here the
server admits client updates as they arrive, buffers them, and merges every
K arrivals with a staleness-weighted partial-participation rule:

  - Client work is dispatched in *cohorts* ("waves") through the same
    ``RoundEngine.train_fn`` the lockstep rounds run (so every local step
    of every wave is one launch of the fused update kernel), one wave per
    selection epoch, trained against the global model current at dispatch.
    A wave's lanes then become individual *arrivals*, each with a service
    delay drawn from :class:`ArrivalProcess`; a new wave is dispatched
    whenever the arrival queue drains, so stragglers of earlier cohorts
    interleave with later cohorts and accumulate staleness. A wave's deltas
    stay on the device until its last lane is merged.
  - The arrival process is a pure function of ``(random_seed, wave)``
    (numpy), the same draws as the JAX package's. Virtual time: merge ORDER
    is what matters, no wall-clock sleeps.
  - Every K arrivals (``buffer_k``; 0 ⇒ no_models) the buffer is merged
    over the padded [K] batch: occupancy is a mask and the padding lanes
    are zero deltas, so occupancy < K (a deadline merge, a backpressure
    flush, the final flush of a gracefully stopped run) is the same
    computation. FedAvg's divisor is the number of occupied surviving lanes
    (``counted`` is all ones), so a full unscreened buffer at K = C is
    bitwise the dense FedAvg; every other rule gets the mask.
  - Staleness of a buffered update = merges applied since its wave was
    dispatched. ``staleness_weighting``: "none" (no multiply at all, not
    even × 1.0), "polynomial" w(s) = (1+s)^-staleness_alpha or
    "exponential" w(s) = staleness_alpha^s.
  - Faults (fl/faults.py) become arrival events: the plan of the port's own
    ``(fault_seed, wave epoch)`` stream is drawn, but a *dropped* client
    never arrives, a *stale* client becomes a straggler (its delay ×
    ``straggler_factor``), and *corrupt*/*blowup* perturb the payload in
    transit; with ``screen_updates`` on, the merge screens the buffer and
    quarantines via the mask.

Sync reduction (tests/test_torch_async.py): with ``buffer_k == no_models``
a merge fires exactly when a full wave has arrived and the next wave is
dispatched only after the merge, so cadence, random streams, train step,
divisor and batteries reduce to the synchronous round and the recorded rows
are bitwise the sync run's (less wall times and the async-only keys), for
any arrival knobs: the merge sorts its buffer by (wave, lane).

Deviations from the lockstep engine, documented:
  - DP noise comes from the experiment's one ``noise_gen`` stream, drawn
    once per merge in merge order (a health re-merge redraws the same
    noise). At K = C that is exactly the sync stream; at K ≠ C merges are
    not 1:1 with waves, which is the port's counterpart of the JAX
    package's "DP noise draws use the newest merged wave's aggregation
    key".
  - LOAN's adaptive poison-LR probe never blocks the stream: it uses the
    last finalized backdoor accuracy (``last_backdoor_acc``), one merge
    stale.
  - The per-batch channels (vis_train_batch_loss / batch_track_distance)
    are not recorded.
  - Updates still buffered or in flight when the merge budget is spent
    are discarded; a graceful stop flushes the partial buffer as one final
    padded merge instead, checkpoints, and the CLI exits 75.

Checkpoint/resume: the streaming state (version, wave counter, virtual
clock, arrival heap, buffer, arrival times and every live wave's payload,
moved to the CPU) rides the full-state sidecar under ``async_state``, so a
kill between merges resumes bitwise from the last committed merge. A resume
from a checkpoint without it (a pretrain, a sync run) restarts the stream
at ``version = start_epoch - 1`` and ``wave = version·K // C``.

Self-healing knobs, each a bitwise no-op at its default: ``merge_timeout_v``
+ ``merge_min_k`` (deadline merges), ``starvation_policy`` (abort / carry /
wait after STARVATION_LIMIT empty cohorts), ``max_outstanding_waves``
(backpressure), ``arrival_ttl_v`` (expiry), ``model_health_check`` (an
unhealthy merge re-merges the same buffer with an escalated norm screen up
to ``max_round_retries``, then rolls back to the last-good ring) and
``min_surviving_clients`` (skip-and-carry).

``overlap_eval`` pipelines the merges (depth 1): merge S is dispatched —
buffer consumed, merged under the sentinel's loop, the ring committed, the
new model committed, its global battery enqueued on the eval stream and its
host copy after it — and finalized (rows recorded, checkpoint written from
the state captured at dispatch) only after merge S+1 was dispatched, so
S's battery and host work run beside S+1's wave training. The recorded
stream is byte-identical to the serial one: finalize replays the deferred
wave rows in resolution order. The pipeline stands down under telemetry
(honest per-step spans) and for poisoned LOAN runs (the adaptive poison-LR
probe reads ``last_backdoor_acc`` at wave dispatch, which pipelining would
make one more merge stale). Telemetry counts the driver's events under
``async/*``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.data.batching import build_batch_plan
from dba_mod_tpu_torch.fl import faults as flt
from dba_mod_tpu_torch.fl.client import ClientMetrics
from dba_mod_tpu_torch.fl.evaluation import EvalResult, place_eval_inputs
from dba_mod_tpu_torch.fl.experiment import (HostCopy, PendingCopy,
                                             RoundInFlight, to_host)
from dba_mod_tpu_torch.fl.rounds import (LocalEvals, _map2, aggregate,
                                         nbt_client_deltas,
                                         screen_client_updates)
from dba_mod_tpu_torch.fl.selection import select_agents
from dba_mod_tpu_torch.fl.state import ClientTask, build_client_tasks
from dba_mod_tpu_torch.models import ModelVars
from dba_mod_tpu_torch.ops.aggregation import _bc_mask
from dba_mod_tpu_torch.utils.device import to_device

logger = logging.getLogger("dba_mod_tpu_torch.async_rounds")

# consecutive empty cohorts before the stream counts as starved and
# starvation_policy decides; module-level so tests can starve cheaply
STARVATION_LIMIT = 200


def staleness_weights(staleness: np.ndarray, weighting: str,
                      alpha: float) -> np.ndarray:
    """w(s) per buffered update, float32. "none" ⇒ ones (the merge skips
    the multiply entirely), "polynomial" ⇒ (1+s)^-alpha (FedBuff §5),
    "exponential" ⇒ alpha^s."""
    s = np.asarray(staleness, np.float32)
    if weighting == "none":
        return np.ones_like(s)
    if weighting == "polynomial":
        return (1.0 + s) ** np.float32(-alpha)
    if weighting == "exponential":
        return np.float32(alpha) ** s
    raise ValueError(f"unknown staleness_weighting {weighting!r}")


class ArrivalProcess:
    """Deterministic per-(seed, wave) service delays for a cohort's lanes:
    a pure function of ``SeedSequence((seed, wave))``, so a resumed run
    replays the identical arrival plan."""

    def __init__(self, seed: int, rate: float, jitter: float,
                 straggler_tail: float, straggler_factor: float):
        if rate <= 0:
            raise ValueError(f"arrival_rate must be > 0, got {rate}")
        self.seed = int(seed)
        self.rate = float(rate)
        self.jitter = float(jitter)
        self.straggler_tail = float(straggler_tail)
        self.straggler_factor = float(straggler_factor)

    def delays(self, wave: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, int(wave))))
        d = rng.exponential(1.0 / self.rate, size=n)
        if self.jitter > 0:
            d = d * rng.lognormal(0.0, self.jitter, size=n)
        if self.straggler_tail > 0:
            tail = rng.random(n) < self.straggler_tail
            d = np.where(tail, d * self.straggler_factor, d)
        return d.astype(np.float64)


@dataclasses.dataclass
class _Wave:
    """One dispatched cohort: its device payloads and host metadata, kept
    until every lane is consumed (merged, dropped or expired) and its
    per-client rows are recorded."""
    wave: int                    # 0-based cohort counter
    epoch: int                   # wave+1: selection / poison-schedule epoch
    base_version: int            # merge count at dispatch (staleness base)
    names: List[Any]
    adv_names: List[Any]
    tasks: ClientTask            # host rows (numpy)
    deltas: ModelVars            # [C] stacked, post-fault, on the device
    nbt: torch.Tensor            # [C] num_batches_tracked deltas
    num_samples: np.ndarray      # [C] float32
    metrics: Any                 # ClientMetrics [1, C, E] (tensors)
    locals_: Any                 # LocalEvals or None
    delta_norms: torch.Tensor    # [C]
    outstanding: int             # lanes not yet consumed
    recorded: bool = False
    t_dispatch: float = 0.0      # virtual clock at dispatch (arrival_ttl_v)
    rows: Optional[HostCopy] = None  # the row payload's host copy, enqueued
                                     # when the cohort resolves


@dataclasses.dataclass
class _MergeInFlight:
    """One dispatched, not yet finalized merge: its outputs' host copy and
    every host value finalize needs, captured at dispatch — by finalize
    time the live driver state (version, clock, heap, RNG streams, global
    model) already belongs to the next step's fill."""
    step: int
    t0: float                    # perf_counter at dispatch start
    host: Any                    # HostCopy (PendingCopy under the
                                 # pipeline) of (globals, wv, alpha,
                                 # is_updated, n_quar, degraded)
    names: List[Any]
    adversaries: List[Any]
    occupancy: int
    retries: int
    rolled_back: bool
    n_dropped: int
    dispatch_wall: float
    extras: Dict[str, Any]
    rows: List[_Wave]            # cohorts resolved since the previous merge,
                                 # recorded (in order) before the merge row
    keep: Any = None             # the battery's inputs, held until the copy
    t_dispatch_end: float = 0.0
    # checkpoint capture (run() under the pipeline): the streaming sidecar
    # and the state after the merge — what save_model persists for it
    snapshot: Optional[Dict[str, Any]] = None
    saved: Optional[RoundInFlight] = None


def _pack(x: Any) -> Any:
    """A payload as the sidecar stores it: tensors on the CPU, numpy arrays
    as tensors, NamedTuples as dicts (what torch.load(weights_only=True)
    reads back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _pack(v) for f, v in zip(x._fields, x)}
    if isinstance(x, dict):
        return {k: _pack(v) for k, v in x.items()}
    return x


def _model_vars(d: Dict[str, Dict[str, torch.Tensor]],
                dev: torch.device) -> ModelVars:
    return ModelVars({k: v.to(dev) for k, v in d["params"].items()},
                     {k: v.to(dev) for k, v in d["batch_stats"].items()})


class AsyncDriver:
    """The persistent buffered-async server loop over one Experiment."""

    def __init__(self, exp):
        p = exp.params
        if exp.world_size > 1:
            raise ValueError("mode: async is single-process only")
        if exp.mesh is not None:
            raise ValueError(
                "mode: async does not support a sharded clients mesh "
                "(set num_devices: 0); its wave training is single-device")
        self.exp = exp
        self.C = int(p["no_models"])
        self.K = int(p.get("buffer_k", 0) or 0) or self.C
        self.weighting = str(p.get("staleness_weighting", "none"))
        self.alpha = float(p.get("staleness_alpha", 0.5))
        self.arrivals = ArrivalProcess(
            seed=int(p.get("random_seed") or 0),
            rate=float(p.get("arrival_rate", 1.0)),
            jitter=float(p.get("arrival_jitter", 0.0)),
            straggler_tail=float(p.get("straggler_tail", 0.0)),
            straggler_factor=float(p.get("straggler_factor", 10.0)))
        if bool(p.get("vis_train_batch_loss")) or bool(
                p.get("batch_track_distance")):
            logger.warning("async mode does not record per-batch channels; "
                           "vis_train_batch_loss/batch_track_distance rows "
                           "will be absent")
        hyper = exp.engine.hyper
        if hyper.aggregation == cfg.AGGR_FOOLSGOLD:  # config.py rejects too
            raise ValueError("foolsgold is stateful per-round and has no "
                             "buffered-async form; pick another rule")
        # the merge's rule: the engine's, over the [K] buffer
        self._hyper = dataclasses.replace(hyper, no_models=self.K)
        self._min_surv = int(p.get("min_surviving_clients", 1))
        # self-healing knobs, each a bitwise no-op at its default
        self.merge_timeout_v = float(p.get("merge_timeout_v", 0.0))
        self.merge_min_k = int(p.get("merge_min_k", 1))
        self.starvation_policy = str(p.get("starvation_policy", "abort"))
        self.max_outstanding = int(p.get("max_outstanding_waves", 0))
        self.arrival_ttl_v = float(p.get("arrival_ttl_v", 0.0))
        self._sentinel = exp._sentinel  # shared HealthSentinel or None
        # overlap_eval: the depth-1 merge pipeline (module docstring), off
        # under telemetry and for poisoned LOAN runs
        self._pipeline = (bool(p.get("overlap_eval", False))
                          and not exp.telemetry.enabled
                          and not (p.type == cfg.TYPE_LOAN
                                   and exp.is_poison_run))
        self._eval_stream = exp._eval_stream if self._pipeline else None
        self._overlap_merges = 0
        self._overlap_hidden_s = 0.0
        # streaming state
        self.version = 0          # merges applied
        self.wave = 0             # cohorts dispatched
        self.clock = 0.0          # virtual time of the last consumed arrival
        self._seq = 0             # heap tie-break
        # (t, seq, wid, lane)
        self._heap: List[Tuple[float, int, int, int]] = []
        self._buffer: List[Tuple[int, int]] = []            # (wid, lane)
        self._arrival_t: Dict[Tuple[int, int], float] = {}  # buffered → t
        self._waves: Dict[int, _Wave] = {}
        self._pending_dropped = 0
        self._dispatch_wall = 0.0
        self._total_arrivals = 0
        # the driver's own counters (stats())
        self._starved_cohorts = 0
        self._expired_arrivals = 0
        self._deadline_merges = 0
        self._backpressure_hits = 0
        self._rollbacks = 0
        self._waves_highwater = 0
        self._merge_latencies: List[float] = []
        # cohorts fully resolved whose per-client rows are not written yet:
        # replayed, in resolution order, before the next merge's rows
        self._pending_rows: List[_Wave] = []
        self._restore(exp._resume_aux)

    # --------------------------------------------------------------- running
    def run(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        """The server loop: fill the buffer from the arrival queue
        (dispatching cohorts on demand), merge, record, checkpoint — until
        the merge budget is spent or a graceful stop lands. Under the
        pipeline ONE merge is held dispatched but unfinalized across the
        next fill."""
        exp = self.exp
        p = exp.params
        eps = int(epochs if epochs is not None else p["epochs"])
        total = int(p.get("async_steps", 0) or 0)
        if total <= 0:
            # the client-update budget of `epochs` sync rounds: at K == C
            # exactly `epochs` merges
            total = max(1, eps * self.C // self.K)
        last: Dict[str, Any] = {}
        pending: Optional[_MergeInFlight] = None

        def log_merge(r):
            logger.info(
                "merge %d/%d done acc=%.2f staleness_mean=%.2f "
                "occupancy=%d/%d", r["epoch"], total, r["global_acc"],
                r["staleness_mean"], r["buffer_occupancy"], self.K)

        def drain(h: Optional[_MergeInFlight]):
            if h is None:
                return last
            r = self._finalize_merge(h)
            self._save_pending(h)
            exp.telemetry.mark_warm()
            log_merge(r)
            return r

        while self.version < total:
            exp.guard.watchdog.epoch = self.version + 1
            merge = not exp.guard.stop_requested and self._fill_buffer()
            if exp.guard.stop_requested:
                # graceful stop (it may land while a wave trains; the fill
                # then dispatches no more): what the buffer holds is
                # flushed as one final padded merge and checkpointed
                last = drain(pending)
                pending = None
                if self._buffer:
                    last = self._merge_and_record()
                    self._save()
                exp.interrupted = True
                logger.warning(
                    "graceful stop honored at the merge boundary after "
                    "step %d (resume with --resume auto)", self.version)
                break
            if merge and self._pipeline:
                nxt = self._dispatch_merge(capture_save=True)
                last = drain(pending)
                pending = nxt
                continue
            last = drain(pending)
            pending = None
            last = (self._merge_and_record() if merge
                    else self._carry_starved_step())
            self._save()
            exp.telemetry.mark_warm()
            log_merge(last)
        last = drain(pending)
        leftovers = len(self._buffer) + len(self._heap)
        if leftovers and not exp.interrupted:
            exp.telemetry.counter("async/unmerged_leftovers").inc(leftovers)
            logger.info("run end: %d buffered/in-flight updates discarded "
                        "(budget of %d merges spent)", leftovers, total)
        logger.info("async stats: %s", self.stats())
        return last

    def run_steps(self, n: int) -> Dict[str, Any]:
        """Run n merges, no checkpoints (fewer when a stop is requested;
        the stop flush is run()'s). Under the pipeline the merges are
        pipelined as in run(), and the last one is drained before this
        returns."""
        last: Dict[str, Any] = {}
        pending: Optional[_MergeInFlight] = None
        for _ in range(n):
            merge = self._fill_buffer()
            if self.exp.guard.stop_requested:
                break
            if merge and self._pipeline:
                nxt = self._dispatch_merge()
                if pending is not None:
                    last = self._finalize_merge(pending)
                pending = nxt
                continue
            if pending is not None:
                last = self._finalize_merge(pending)
                pending = None
            last = (self._merge_and_record() if merge
                    else self._carry_starved_step())
        if pending is not None:
            last = self._finalize_merge(pending)
        return last

    def stats(self) -> Dict[str, Any]:
        """p95 virtual merge latency (arrival → merge, virtual seconds),
        the backpressure / starvation / expiry / deadline / rollback
        counters, the outstanding-waves high-water mark, and the pipeline's
        merges finalized one step late with the host seconds that ran
        behind the next step."""
        lat = sorted(self._merge_latencies)
        p95 = float(lat[int(0.95 * (len(lat) - 1))]) if lat else 0.0
        return {"merge_latency_v_p95": p95,
                "outstanding_waves_highwater": self._waves_highwater,
                "starved_cohorts": self._starved_cohorts,
                "expired_arrivals": self._expired_arrivals,
                "deadline_merges": self._deadline_merges,
                "backpressure_hits": self._backpressure_hits,
                "health_rollbacks": self._rollbacks,
                "pipelined_merges": self._overlap_merges,
                "hidden_finalize_s": round(self._overlap_hidden_s, 6)}

    def _save(self):
        if self.exp.params["save_model"] and self.exp.folder is not None:
            self.exp.save_model(self.version,
                                extra_aux={"async_state": self._snapshot()})

    # ------------------------------------------------------ arrivals / waves
    def _deadline_due(self) -> bool:
        """True when a merge_timeout_v deadline merge should fire: the
        oldest buffered update has waited past the deadline (>= merge_min_k
        buffered) and the next known arrival, if any, lands after it.
        Firing advances the virtual clock to the deadline instant."""
        if self.merge_timeout_v <= 0 or len(self._buffer) < self.merge_min_k:
            return False
        oldest = self._arrival_t.get(tuple(self._buffer[0]), self.clock)
        deadline = oldest + self.merge_timeout_v
        if self._heap and self._heap[0][0] < deadline:
            return False
        self.clock = max(self.clock, deadline)
        return True

    def _expire_arrival(self, t: float, wid: int) -> bool:
        """arrival_ttl_v: an update whose service delay exceeded the TTL is
        expired at pop time; it never reaches the buffer, its lane is
        freed, and a fully-resolved cohort is recorded."""
        w = self._waves[wid]
        if t - w.t_dispatch <= self.arrival_ttl_v:
            return False
        self._expired_arrivals += 1
        self.exp.telemetry.counter("async/expired_arrivals").inc()
        w.outstanding -= 1
        if w.outstanding == 0 and not w.recorded:
            self._resolve_wave(w)
            del self._waves[wid]
        return True

    def _fill_buffer(self) -> bool:
        """Pop arrivals into the buffer until it holds K, or until a
        deadline or backpressure flush fires a partial merge. Dispatches a
        new cohort whenever the queue drains. Returns True when the buffer
        should be merged, False when the stream is starved and
        starvation_policy says to carry a no-op step. A requested stop ends
        the fill early (the caller flushes)."""
        tel = self.exp.telemetry
        empty_waves = 0
        while len(self._buffer) < self.K:
            if self._deadline_due():
                self._deadline_merges += 1
                tel.counter("async/deadline_merges").inc()
                return True
            while not self._heap:
                if (self.max_outstanding > 0 and self._buffer
                        and len(self._waves) >= self.max_outstanding):
                    # admission control: flush instead of dispatching
                    self._backpressure_hits += 1
                    tel.counter("async/backpressure_hits").inc()
                    return True
                before = len(self._heap)
                self._dispatch_wave()
                if len(self._heap) == before:
                    empty_waves += 1
                    self._starved_cohorts += 1
                    tel.counter("async/starved_cohorts").inc()
                    if empty_waves > STARVATION_LIMIT:
                        if self.starvation_policy == "carry":
                            return bool(self._buffer)
                        if self.starvation_policy == "wait":
                            # the watchdog (watchdog_hard_s) is the backstop
                            empty_waves = 0
                            continue
                        raise RuntimeError(
                            "async arrival queue starved: "
                            f"{STARVATION_LIMIT} consecutive cohorts "
                            "produced no arrivals (fault dropout too "
                            "aggressive?)")
                else:
                    empty_waves = 0
            if self.exp.guard.stop_requested:
                return True
            t, _seq, wid, lane = heapq.heappop(self._heap)
            if self.arrival_ttl_v > 0 and self._expire_arrival(t, wid):
                continue
            self.clock = max(self.clock, t)
            self._buffer.append((wid, lane))
            self._arrival_t[(wid, lane)] = self.clock
            self._total_arrivals += 1
            tel.counter("async/arrivals").inc()
            tel.gauge("async/buffer_occupancy").set(len(self._buffer))
        return True

    def _dispatch_wave(self):
        """Select and train one cohort through the lockstep train step and
        enqueue its lanes as future arrivals. Consumes the selection and
        plan streams exactly as a sync round does."""
        t0 = time.perf_counter()
        tel = self.exp.telemetry
        with tel.span("async/dispatch_wave"):
            self._train_wave()
        if len(self._waves) > self._waves_highwater:
            self._waves_highwater = len(self._waves)
            tel.gauge("async/outstanding_waves_highwater").set(
                self._waves_highwater)
        tel.counter("async/waves").inc()
        self._dispatch_wall += time.perf_counter() - t0

    def _train_wave(self):
        exp = self.exp
        p = exp.params
        dev = exp.device
        wid = self.wave
        self.wave += 1
        epoch = wid + 1
        agent_names, adv_names = select_agents(
            p, epoch, exp.participants, exp.benign_names, exp.select_rng)
        # LOAN's adaptive poison LR never blocks the stream on a probe: the
        # last finalized backdoor accuracy, one merge stale
        backdoor_acc = (exp.last_backdoor_acc
                        if exp._loan_poisons(epoch, agent_names) else None)
        slots = np.array([exp.client_slots[n] for n in agent_names],
                         np.int64)
        tasks = build_client_tasks(p, agent_names, epoch, slots,
                                   exp.epochs_max, backdoor_acc)
        plan = build_batch_plan(
            [exp.client_indices[n] for n in agent_names],
            [int(e) for e in tasks.num_epochs], int(p["batch_size"]),
            exp.plan_rng, min_steps=exp._round_min_steps(agent_names),
            min_epochs=exp.epochs_max)
        idx_seq, mask_seq = plan.idx[None], plan.mask[None]
        train = exp.engine.train_fn(
            exp.global_vars, [tasks], idx_seq, mask_seq,
            exp._dropout_masks(epoch, idx_seq.shape))
        nbt = to_device(nbt_client_deltas(
            mask_seq, np.asarray(tasks.scale)[None]), dev)
        locals_ = None
        if exp.local_eval:
            zeros = _map2(lambda d, _: torch.zeros_like(d), train.deltas,
                          train.deltas)
            locals_ = exp.engine.local_evals(
                exp.global_vars, train.deltas, tasks.to_device(dev), zeros)
        deltas = train.deltas
        C = len(agent_names)
        dropped = np.zeros(C, bool)
        delay_mult = np.ones(C)
        fcfg = exp.engine.fault_cfg
        if fcfg.enabled:
            # faults as arrival events, from the (fault_seed, epoch) plan:
            # dropped never arrives, stale straggles, corrupt/blowup perturb
            # the payload in transit
            fplan = flt.make_fault_plan(
                fcfg, flt.fault_generator(fcfg.seed, epoch),
                torch.ones((C,), dtype=torch.bool))
            dropped = fplan.dropped.numpy()
            delay_mult = np.where(fplan.stale.numpy(),
                                  self.arrivals.straggler_factor, 1.0)
            deltas = flt.perturb_tree(deltas, fplan.to(dev), fcfg)
        self._pending_dropped += int(dropped.sum())
        delays = self.arrivals.delays(wid, C) * delay_mult
        for c in range(C):
            if dropped[c]:
                continue
            heapq.heappush(self._heap, (self.clock + float(delays[c]),
                                        self._seq, wid, c))
            self._seq += 1
        w = self._waves[wid] = _Wave(
            wave=wid, epoch=epoch, base_version=self.version,
            names=list(agent_names), adv_names=list(adv_names), tasks=tasks,
            deltas=deltas, nbt=nbt,
            num_samples=plan.num_samples.astype(np.float32),
            metrics=train.metrics,
            locals_=locals_, delta_norms=train.delta_norms,
            outstanding=int(C - dropped.sum()), t_dispatch=self.clock)
        if w.outstanding == 0:
            # fully dropped cohort: resolve its train rows and free it
            self._resolve_wave(w)
            del self._waves[wid]

    # ----------------------------------------------------------------- merge
    def _merge(self, global_vars: ModelVars, deltas: ModelVars,
               nbt: torch.Tensor, ns: torch.Tensor, occ: torch.Tensor,
               w: torch.Tensor, norm_mult: float):
        """The staleness-weighted partial-participation merge over the
        padded [K] buffer: the engine's rule (rounds.aggregate) with the
        buffer as the participation unit — the occupancy (and survivor)
        mask for every rule, FedAvg's divisor over the occupied surviving
        lanes — then the min_surviving_clients skip-and-carry. Returns
        (new_vars, wv, alpha, is_updated, n_quarantined, degraded)."""
        exp = self.exp
        if self.weighting != "none":
            deltas = ModelVars(*({k: (v * _bc_mask(w, v)
                                      if v.is_floating_point() else v)
                                  for k, v in tree.items()}
                                 for tree in deltas))
        mask = occ
        n_quar = torch.zeros((), dtype=torch.int64, device=occ.device)
        if exp.engine.screening:
            surv, _ = screen_client_updates(deltas, occ, occ, norm_mult)
            mask = occ & surv
            n_quar = torch.sum(occ & ~surv)
        res = aggregate(self._hyper, global_vars, deltas, exp.noise_gen,
                        num_samples=ns, nbt_deltas=nbt,
                        mask=mask.to(torch.float32),
                        counted=torch.ones_like(occ))
        # too few surviving occupied lanes: the global model is carried
        # (a where with a False scalar passes the aggregate through)
        degraded = torch.sum(mask) < self._min_surv
        new_vars = _map2(lambda g, a: torch.where(degraded, g, a),
                         global_vars, res.new_vars)
        return (new_vars, res.wv, res.alpha, res.is_updated, n_quar,
                degraded)

    def _merge_and_record(self) -> Dict[str, Any]:
        """Merge the buffer (padded to K) and record it: the serial
        composition of the merge's two phases."""
        return self._finalize_merge(self._dispatch_merge())

    def _dispatch_merge(self, capture_save: bool = False) -> _MergeInFlight:
        """Phase 1 of a merge: consume the buffer, merge it under the
        sentinel's retry loop, commit the ring, the new model and the
        version, enqueue the global battery (on the eval stream under the
        pipeline) and the outputs' host copy — without waiting for them.
        With `capture_save` the checkpoint payload (streaming snapshot and
        the state after the merge) is captured too, as a serial post-merge
        save would see it."""
        exp = self.exp
        dev = exp.device
        tel = exp.telemetry
        t0 = time.perf_counter()
        step = self.version + 1
        tel.set_epoch(step)
        entries = sorted(self._buffer)     # (wave, lane): deterministic
        self._buffer = []
        B = len(entries)
        # per-client rows of cohorts that resolved with this batch: queued
        # and recorded at finalize, before the merge's own rows, in both
        # modes
        for wid, _lane in entries:
            self._waves[wid].outstanding -= 1
        for wid in sorted({w for w, _ in entries}):
            w = self._waves[wid]
            if w.outstanding == 0 and not w.recorded:
                self._resolve_wave(w)
        names = [self._waves[w].names[lane] for w, lane in entries]
        merged_by_wave: Dict[int, set] = {}
        for wid, lane in entries:
            merged_by_wave.setdefault(wid, set()).add(lane)
        adversaries: List[Any] = []
        for wid in sorted(merged_by_wave):
            w = self._waves[wid]
            present = {w.names[ln] for ln in merged_by_wave[wid]}
            adversaries.extend(n for n in w.adv_names if n in present)
        for e in entries:
            lat = max(0.0, self.clock - self._arrival_t.pop(e, self.clock))
            self._merge_latencies.append(lat)
            tel.histogram("async/merge_latency_v").observe(lat)
        if len(self._merge_latencies) > 100_000:
            del self._merge_latencies[:-50_000]
        with tel.span("async/merge"):
            deltas, nbt, ns = self._gather(entries)
            staleness = np.array([self.version - self._waves[w].base_version
                                  for w, _ in entries], np.float32)
            for v in staleness:
                tel.histogram("staleness").observe(float(v))
            w_full = np.zeros((self.K,), np.float32)
            w_full[:B] = staleness_weights(staleness, self.weighting,
                                           self.alpha)
            occ = np.zeros((self.K,), bool)
            occ[:B] = True
            occ_t = to_device(occ, dev)
            w_t = to_device(w_full, dev)
            ns_t = to_device(ns, dev)
            vars_before = exp.global_vars
            # the health sentinel's loop: an unhealthy candidate re-merges
            # the SAME buffer, with the same DP noise, under an escalated
            # screen
            gen_state = exp.noise_gen.get_state()
            norm_mult: Optional[float] = None
            retries, rolled_back = 0, False
            healthy, unorm = True, 0.0
            while True:
                nm = (exp.engine.base_norm_mult if norm_mult is None
                      else norm_mult)
                exp.noise_gen.set_state(gen_state)
                new_vars, wv, alpha, is_updated, n_quar, degr = self._merge(
                    vars_before, deltas, nbt, ns_t, occ_t, w_t, nm)
                if self._sentinel is None:
                    break
                healthy, unorm = self._sentinel.check(vars_before, new_vars)
                if (healthy or not exp.engine.screening
                        or retries >= exp.max_round_retries):
                    break
                retries += 1
                norm_mult = exp._escalate_norm_mult(nm)
                logger.warning(
                    "merge %d: unhealthy aggregate; re-merge %d/%d with "
                    "norm screen at %.2fx median", step, retries,
                    exp.max_round_retries, norm_mult)
            if self._sentinel is not None and not healthy:
                # retries exhausted (or unscreened): roll back to the
                # last-good ring and record the step degraded
                rolled_back = True
                self._rollbacks += 1
                tel.counter("async/health_rollbacks").inc()
                new_vars = self._sentinel.rollback_target(vars_before)
                logger.warning(
                    "merge %d: unhealthy aggregate after %d re-merges "
                    "(update norm %.3g vs EMA %.3g); rolled back to "
                    "last-good model", step, retries, unorm,
                    self._sentinel.ema)
        exp.global_vars = new_vars
        self.version = step
        # free fully-consumed cohorts (merged and resolved)
        for wid in [w for w, v in self._waves.items()
                    if v.outstanding == 0 and v.recorded]:
            del self._waves[wid]
        if self._sentinel is not None and not rolled_back \
                and not bool(degr):
            # the ring commits at DISPATCH, so the sentinel observes merge
            # S before merge S+1's candidate is checked against it, as on
            # the serial path (the check above already synced the host)
            self._sentinel.commit(step, new_vars, unorm)
        stream = self._eval_stream
        keep = place_eval_inputs(new_vars, stream)

        def battery() -> HostCopy:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                globals_dev = exp.engine.global_evals(new_vars)
            return HostCopy((globals_dev, wv, alpha,
                             torch.as_tensor(is_updated), n_quar, degr),
                            stream)

        # under the pipeline the eval worker thread enqueues the battery,
        # so the next fill's waves are enqueued beside it
        host = (PendingCopy(exp.eval_worker().submit(battery))
                if self._pipeline else battery())
        extras = {"mode": "async", "buffer_occupancy": B,
                  "staleness_mean": float(staleness.mean()) if B else 0.0,
                  "staleness_max": float(staleness.max()) if B else 0.0,
                  "waves_dispatched": self.wave,
                  "arrivals_total": self._total_arrivals,
                  "virtual_time": self.clock}
        h = _MergeInFlight(
            step=step, t0=t0, host=host, names=names,
            adversaries=adversaries, occupancy=B, retries=retries,
            rolled_back=rolled_back, n_dropped=self._pending_dropped,
            dispatch_wall=self._dispatch_wall, extras=extras,
            rows=self._pending_rows, keep=keep)
        self._pending_rows = []
        self._pending_dropped = 0
        self._dispatch_wall = 0.0
        if capture_save and exp.params["save_model"] \
                and exp.folder is not None:
            h.snapshot = self._snapshot()
            h.saved = RoundInFlight(
                epoch=step, t0=t0, seg_epochs=[], agent_names=[],
                adv_names=[], tasks_list=[], mask_list=[], payload=None,
                vars_after=new_vars, fg_after=exp.fg_state,
                rng_after=exp._snapshot_rng(),
                health_after=(self._sentinel.state()
                              if self._sentinel is not None else None))
            h.saved.saved = HostCopy(exp._state_after(h.saved))
        h.t_dispatch_end = time.perf_counter()
        return h

    def _finalize_merge(self, h: _MergeInFlight) -> Dict[str, Any]:
        """Phase 2 of a merge: wait for its host copy, record the deferred
        per-client rows (in resolution order), then the merge's. Under the
        pipeline this runs one step late; everything it touches rides the
        handle, so the recorded stream is byte-identical to the serial
        composition."""
        exp = self.exp
        with exp.telemetry.span("async/finalize"):
            t_fin = time.perf_counter()
            # the merge's blocking wait
            with exp.guard.watch("async/finalize"):
                (globals_, wv_h, alpha_h, is_upd_h, n_quar_h,
                 degr_h) = to_host(h.host.wait())
        h.keep = None
        finalize_time = time.perf_counter() - t_fin
        if self._pipeline:
            self._overlap_merges += 1
            self._overlap_hidden_s += max(0.0, t_fin - h.t_dispatch_end)
        for w in h.rows:
            self._record_wave_rows(w)
        degraded = bool(degr_h) or h.rolled_back
        exp.last_is_updated = bool(is_upd_h)
        exp.last_global_loss = float(globals_.clean.loss)
        if exp.is_poison_run:
            exp.last_backdoor_acc = float(globals_.poison.acc)
        times = {"round_time": time.perf_counter() - h.t0,
                 "dispatch_time": h.dispatch_wall,
                 "finalize_time": finalize_time}
        robust = {"n_quarantined": int(n_quar_h), "n_dropped": h.n_dropped,
                  "n_retries": h.retries, "degraded": degraded}
        exp._record_round(h.step, h.step, [str(n) for n in h.names],
                          h.adversaries, globals_, wv_h, alpha_h, times,
                          {**robust, **h.extras})
        exp.telemetry.counter("async/merges").inc()
        exp.telemetry.counter("async/updates_merged").inc(h.occupancy)
        self._flush_merge_telemetry(h.step, robust, times)
        return {"epoch": h.step, "agents": h.names,
                "global_acc": float(globals_.clean.acc),
                "backdoor_acc": (float(globals_.poison.acc)
                                 if exp.is_poison_run else None),
                **times, **robust, **h.extras}

    def _save_pending(self, h: _MergeInFlight):
        """Checkpoint a finalized pipelined merge from its dispatch-time
        capture. Runs AFTER _finalize_merge(h): save_model reads
        last_global_loss (best-val), which finalize just set from this
        merge's battery, as a serial save would; and the recorder now
        holds exactly the rows a serial save would count."""
        if h.saved is not None:
            h.snapshot["recorder_rows"] = self.exp.recorder.row_counts()
            self.exp.save_model(h.step, fl=h.saved,
                                extra_aux={"async_state": h.snapshot})

    def _flush_merge_telemetry(self, step, robust, times):
        t = self.exp.telemetry
        if not t.enabled:
            return
        t.counter("rounds").inc()
        if robust.get("n_quarantined"):
            t.counter("clients_quarantined").inc(robust["n_quarantined"])
        if robust.get("n_dropped"):
            t.counter("clients_dropped").inc(robust["n_dropped"])
        if robust.get("n_retries"):
            t.counter("round_retries").inc(robust["n_retries"])
        if robust.get("degraded"):
            t.counter("degraded_rounds").inc()
        t.histogram("round_seconds").observe(times["round_time"])
        t.flush_round(step)

    def _carry_starved_step(self) -> Dict[str, Any]:
        """starvation_policy "carry": the stream produced no arrivals for
        STARVATION_LIMIT consecutive cohorts and the buffer is empty — one
        merge step is consumed as a recorded no-op (model unchanged, row
        degraded), so a starved run ends inside its budget."""
        exp = self.exp
        t0 = time.perf_counter()
        step = self.version + 1
        exp.telemetry.set_epoch(step)
        self._flush_pending_rows()  # cohorts resolved during the fill
        globals_ = to_host(exp.engine.global_evals(exp.global_vars))
        self.version = step
        exp.last_is_updated = False
        exp.last_global_loss = float(globals_.clean.loss)
        if exp.is_poison_run:
            exp.last_backdoor_acc = float(globals_.poison.acc)
        times = {"round_time": time.perf_counter() - t0,
                 "dispatch_time": self._dispatch_wall, "finalize_time": 0.0}
        self._dispatch_wall = 0.0
        robust = {"n_quarantined": 0, "n_dropped": self._pending_dropped,
                  "n_retries": 0, "degraded": True}
        self._pending_dropped = 0
        extras = {"mode": "async", "buffer_occupancy": 0,
                  "staleness_mean": 0.0, "staleness_max": 0.0,
                  "waves_dispatched": self.wave,
                  "arrivals_total": self._total_arrivals,
                  "virtual_time": self.clock}
        zeros = np.zeros((self.K,), np.float32)
        exp._record_round(step, step, [], [], globals_, zeros, zeros, times,
                          {**robust, **extras})
        exp.telemetry.counter("async/starved_steps").inc()
        self._flush_merge_telemetry(step, robust, times)
        logger.warning("merge %d: starved stream carried as a degraded "
                       "no-op step (starvation_policy: carry)", step)
        return {"epoch": step, "agents": [],
                "global_acc": float(globals_.clean.acc),
                "backdoor_acc": (float(globals_.poison.acc)
                                 if exp.is_poison_run else None),
                **times, **robust, **extras}

    def _gather(self, entries):
        """The padded [K] merge batch from the per-wave stacked payloads,
        one index op per cohort. A whole cohort in its own order is taken
        as it is, with no index op (the K == C parity path). Padding lanes
        are zero deltas, masked out by occupancy."""
        groups: List[Tuple[_Wave, List[int]]] = []
        for wid, lane in entries:  # entries sorted ⇒ groups contiguous
            w = self._waves[wid]
            if groups and groups[-1][0] is w:
                groups[-1][1].append(lane)
            else:
                groups.append((w, [lane]))
        d_parts, n_parts, ns_parts = [], [], []
        for w, lanes in groups:
            if lanes == list(range(len(w.names))):
                d_parts.append(w.deltas)
                n_parts.append(w.nbt)
            else:
                idx = to_device(np.asarray(lanes, np.int64), w.nbt.device)
                d_parts.append(ModelVars(*({k: v.index_select(0, idx)
                                            for k, v in tree.items()}
                                           for tree in w.deltas)))
                n_parts.append(w.nbt.index_select(0, idx))
            ns_parts.append(w.num_samples[lanes])
        pad = self.K - len(entries)
        if pad:
            d_parts.append(ModelVars(*(
                {k: v.new_zeros((pad,) + tuple(v.shape[1:]))
                 for k, v in tree.items()} for tree in d_parts[0])))
            n_parts.append(n_parts[0].new_zeros((pad,)))
            ns_parts.append(np.zeros((pad,), np.float32))
        if len(d_parts) == 1:
            deltas, nbt = d_parts[0], n_parts[0]
        else:
            deltas = ModelVars(*(
                {k: torch.cat([getattr(d, tree)[k] for d in d_parts])
                 for k in getattr(d_parts[0], tree)}
                for tree in ModelVars._fields))
            nbt = torch.cat(n_parts)
        return deltas, nbt, np.concatenate(ns_parts).astype(np.float32)

    # ------------------------------------------------------------- recording
    def _resolve_wave(self, w: _Wave):
        """Mark a fully-consumed cohort resolved, enqueue its row payload's
        host copy and queue its per-client rows for the next merge's
        record (under the pipeline the wait for that copy rides the
        deferred finalize)."""
        w.recorded = True
        w.rows = HostCopy((w.metrics, w.locals_, w.delta_norms))
        self._pending_rows.append(w)

    def _flush_pending_rows(self):
        rows, self._pending_rows = self._pending_rows, []
        for w in rows:
            self._record_wave_rows(w)

    def _record_wave_rows(self, w: _Wave):
        """Per-client rows of one fully-resolved cohort: train metrics and
        (with local_eval) the local battery, as the lockstep recorder writes
        an interval-1 round's, keyed by the cohort's selection epoch."""
        exp = self.exp
        baseline = bool(exp.params["baseline"])
        metrics, locals_, delta_norms = to_host(w.rows.wait())
        w.metrics = w.locals_ = w.rows = None
        ppb = np.asarray(w.tasks.poisoning_per_batch)
        adv_slot = np.asarray(w.tasks.adv_slot)
        for c, name in enumerate(w.names):
            exp._record_train_rows(name, c, 0, w.epoch,
                                   int(w.tasks.num_epochs[c]), metrics)
            poisoning = bool(ppb[c] > 0)
            if locals_ is not None:
                exp._record_local_rows(name, c, w.epoch, locals_,
                                       not (poisoning and baseline),
                                       poisoning, int(adv_slot[c]) >= 0)
            if poisoning and not baseline:
                exp.recorder.scale_temp_one_row.extend(
                    [w.epoch, round(float(delta_norms[c]), 4)])

    # ------------------------------------------------------ checkpoint state
    def _snapshot(self) -> Dict[str, Any]:
        """The streaming state for the sidecar: everything needed to resume
        the arrival queue and buffer bitwise. Every live wave's payload is
        copied to the CPU."""
        waves = {}
        live = {e[2] for e in self._heap} | {w for w, _ in self._buffer}
        for wid in sorted(live):
            w = self._waves[wid]
            waves[int(wid)] = {
                "wave": w.wave, "epoch": w.epoch,
                "base_version": w.base_version, "names": list(w.names),
                "adv_names": list(w.adv_names), "tasks": _pack(w.tasks),
                "deltas": _pack(w.deltas), "nbt": _pack(w.nbt),
                "num_samples": _pack(w.num_samples),
                "metrics": _pack(w.metrics), "locals": _pack(w.locals_),
                "delta_norms": _pack(w.delta_norms),
                "outstanding": w.outstanding, "recorded": w.recorded,
                "t_dispatch": w.t_dispatch}
        return {"version": self.version, "wave": self.wave,
                "clock": self.clock, "seq": self._seq,
                "heap": [tuple(e) for e in self._heap],
                "buffer": [tuple(e) for e in self._buffer],
                "arrival_t": [[wid, lane, t] for (wid, lane), t
                              in self._arrival_t.items()],
                "health": (self._sentinel.state()
                           if self._sentinel is not None else None),
                "pending_dropped": self._pending_dropped,
                "total_arrivals": self._total_arrivals, "waves": waves,
                "recorder_rows": self.exp.recorder.row_counts()}

    def _restore(self, aux: Optional[Dict[str, Any]]):
        st = (aux or {}).get("async_state")
        if st is None:
            if self.exp.start_epoch > 1:
                # model-only resume (no sidecar, or one without the
                # streaming state): restart the stream at the committed
                # version with an empty buffer
                self.version = self.exp.start_epoch - 1
                self.wave = self.version * self.K // max(self.C, 1)
                logger.warning(
                    "async resume without a streaming sidecar: restarting "
                    "the arrival queue at merge %d (buffer state lost)",
                    self.version)
            return
        exp = self.exp
        dev = exp.device
        rows = st.get("recorder_rows")
        if (rows is not None and exp.params.resume_mode == "auto"
                and exp.folder is not None):
            # the per-client rows carry wave epochs, which can run ahead of
            # the merge step the resume cut the streams at: continue them
            # at exactly the rows recorded when this checkpoint was taken
            exp.recorder.reload_rows(rows)
        self.version = int(st["version"])
        self.wave = int(st["wave"])
        self.clock = float(st["clock"])
        self._seq = int(st["seq"])
        self._heap = [tuple(e) for e in st["heap"]]
        heapq.heapify(self._heap)
        self._buffer = [tuple(e) for e in st["buffer"]]
        self._arrival_t = {(int(a), int(b)): float(t)
                           for a, b, t in st.get("arrival_t", [])}
        if self._sentinel is not None:
            self._sentinel.load_state(st.get("health"))
        self._pending_dropped = int(st["pending_dropped"])
        self._total_arrivals = int(st["total_arrivals"])

        def on_dev(d):
            return {k: v.to(dev) for k, v in d.items()}

        for wid, d in st["waves"].items():
            loc = d["locals"]
            self._waves[int(wid)] = _Wave(
                wave=int(d["wave"]), epoch=int(d["epoch"]),
                base_version=int(d["base_version"]), names=d["names"],
                adv_names=d["adv_names"],
                tasks=ClientTask(**{k: v.numpy()
                                    for k, v in d["tasks"].items()}),
                deltas=_model_vars(d["deltas"], dev), nbt=d["nbt"].to(dev),
                num_samples=d["num_samples"].numpy(),
                metrics=ClientMetrics(**on_dev(d["metrics"])),
                locals_=(None if loc is None else LocalEvals(
                    **{k: EvalResult(**on_dev(v)) for k, v in loc.items()})),
                delta_norms=d["delta_norms"].to(dev),
                outstanding=int(d["outstanding"]),
                recorded=bool(d["recorded"]),
                t_dispatch=float(d.get("t_dispatch", 0.0)))
        logger.info("async resume: merge %d, %d cohorts live, %d buffered, "
                    "%d in flight", self.version, len(self._waves),
                    len(self._buffer), len(self._heap))
