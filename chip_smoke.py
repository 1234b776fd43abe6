#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dba_mod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard failure (non-zero exit) when it goes wrong:

1. the card: name and power limit from nvidia-smi;
2. the build: every hand-written kernel is built from the sources in this
   checkout (nvcc, at first use, into dba_mod_tpu_torch/_build/);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (the CIFAR ResNet-18 state at C = 10 clients, with
   invalid lanes, FoolsGold on and off, BN present): bitwise equal. Then,
   FoolsGold off and on, its device time (launches of one prepared leaf
   table), its launches per step, the wrapper's host time, its bound, the
   plain version's time and one PyTorch library call's time as a
   yardstick, each also as device time from torch.profiler;
4. the main path through the CLI, dba_mod_tpu_torch.main.main: pretrain one
   round of the full-width CIFAR workload (100 participants, 10 per round,
   batch 64, 4 adversaries, synthetic CIFAR at its full size), then resume
   it by name and train two FedAvg rounds that both poison. The kernel's
   launch count over that run must equal the local steps it ran (derived
   from the recorded train_result.csv); the recorder files must exist and
   the accuracies and the saved global model must be finite;
4b. the robust server on the same workload: two poisoned rounds each under
   FoolsGold and RFA through the CLI, resumed from phase 4's pretrained
   model. One fused launch per local step (FoolsGold's accumulators ride
   in it), finite weight_result.csv rows, FoolsGold leaves the global BN
   running stats bitwise the resumed model's, RFA's oracle count lies in
   [1, maxiter + 1]; each round's round_time and server aggregate time
   (FedAvg's too, in phase 4);
4c. every aggregation rule's server aggregate at the full CIFAR size, timed;
5. a small input held against a reference: one poisoned MNIST smoke round
   on the card against the same round on the CPU (the plain path), from the
   same weights, under FedAvg and under FoolsGold;
5b. one MNIST smoke round on the card with a corrupt fault lane and the
   quarantine screen on: at least one client quarantined, the committed
   global model finite;
6. the Tiny-ImageNet path at full width (configs/tiny_params.yaml: the
   64-base ResNet-18, 11.28 M parameters, on the synthetic set of the full
   100,000 / 10,000 size, made once and read back from its npz cache):
   pretrain one round, resume it by name, two poisoned FedAvg rounds, then
   one poisoned FoolsGold round from the same pretrain. One fused launch
   per local step; round_time, the engine's train / aggregate / local and
   global battery seconds and the peak device memory of each run;
7. LOAN through the CLI (configs/loan_params.yaml, 51 synthetic states):
   pretrain, resume, two poisoned rounds with the adaptive poison LR that
   each round's probe chose, one fused launch per step; then one poisoned
   LOAN round on the card against the same round on the CPU, from the same
   weights and the same CPU-drawn dropout masks: global max abs diff at
   most 5e-6;
8. bf16 compute at full width: phase 4's CIFAR config with
   ``compute_dtype: bfloat16``, resumed from phase 4's pretrain, two
   poisoned FedAvg rounds through the CLI, in a fresh process — one fused
   launch per local step (its leaves stay float32), every round recorded,
   the first round's clean accuracy finite; round_time, train ms a step,
   battery seconds and peak memory beside phase 4's float32 numbers. Then one poisoned MNIST bf16
   round on the card against the same round on the CPU: accuracies within
   1 point, the global-model distance printed;
9. the health sentinel, defense forensics and crash/resume at full width: a
   CIFAR FoolsGold config with ``forensics``, ``model_health_check`` (band
   3, armed after one merge), ``graceful_shutdown``, ``keep_last_n: 2``,
   no local battery and three poisoned rounds, under deterministic
   kernels, run once
   uninterrupted and once through dba_mod_tpu_torch.crash_smoke's launcher
   (SIGTERM once round 1 commits → exit 75 → ``--resume auto``). The two
   final models are bitwise equal, their round_result.csv (less the clock
   columns), forensics.jsonl and client_forensics.csv rows equal, every
   snapshot left verifies, ``main report`` writes the HTML audit, every
   round has one forensic row per client with the adversaries flagged, and
   each run's fused launches equal its local steps; the sentinel's
   decision per round is printed.

10. the buffered-async engine (``mode: async``): (a) in a fresh process
   under deterministic kernels, the poisoned MNIST smoke run with the local
   battery, async at buffer_k == no_models against sync — bitwise equal
   global models and recorded outputs (less clocks and the async-only
   keys); (b) full-width CIFAR async through the CLI with bench.py's
   --async knobs (K = 5, polynomial staleness weighting 0.5, arrival rate 2,
   jitter 0.5, straggler tail 0.1 x 5), model-only resumed from phase 4's
   pretrain, four merges with poisoned waves: one fused launch per local
   step of every dispatched wave; per merge round_time, dispatch_time,
   occupancy and staleness; waves dispatched, the outstanding-waves
   high-water mark, the sidecar's bytes and save seconds, peak memory and
   updates absorbed per second; (c) an MNIST async run at
   configs/async_smoke_params.yaml's knobs under deterministic kernels,
   straight and SIGKILLed once merge 3 committed then ``--resume auto``:
   bitwise equal final models, equal metrics rows and CSVs.

Phase 3 also runs (as 3b) at the Tiny-ImageNet size (FoolsGold off and on)
and at the LOAN size, so the kernels line has five rows. The CIFAR row's
launches are phase 4's plus phase 10b's.

The last lines are a JSON object with the kernels' numbers, the card's name
and power limit, and the result line {"ok": true, "device": {...}}. Exits
non-zero, printing no result, without a CUDA card or without the package.
"""
from __future__ import annotations

import contextlib
import csv
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call of `fn` in steady state: CUDA events around
    `reps` back-to-back calls, over `reps`. Where the host enqueues faster
    than the card runs, this is the card's time; where it does not, it is
    the host's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn, reps: int = 50) -> float:
    """Median host milliseconds to return from `fn` (the enqueue), with the
    card drained before each call so a full queue never blocks it."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, reps: int = 20, name: str = "") -> float | None:
    """Device milliseconds per call of `fn` from torch.profiler: the summed
    durations of the device activities (whose name holds `name`) over
    `reps` calls, over `reps`. User annotations are left out: they span
    kernels already counted (Optimizer.step marks its kernels so). None
    when the profiler saw none."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)
          and name in e.name]
    return sum(us) / reps / 1e3 if us else None


# ---------------------------------------------------------------- phase 3
def check_fused_update(dev, config: str = "cifar_params.yaml",
                       label: str = "", fg_cases=(False, True)) -> list:
    """The kernel against its plain version on the state of `config`'s
    model at C = 10 (FoolsGold on and off, with invalid lanes), then timed
    for each of `fg_cases`. `label` tags the rows' names."""
    import torch
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.models import build_model
    from dba_mod_tpu_torch.ops import fused_update as fu

    params = Params.from_yaml(REPO / "configs" / config)
    mv = build_model(params).init_vars(0, dev)
    C, mu, wd = 10, float(params["momentum"]), float(params["decay"])
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(like):
        return torch.randn((C,) + tuple(like.shape), generator=gen,
                           device=dev)

    def state(fg_on):
        def tree():
            return {k: rnd(v) for k, v in mv.params.items()}
        st = {"params": tree(), "grads": tree(), "mom": tree(),
              "fg": tree() if fg_on else {},
              "bn_new": {k: rnd(v) for k, v in mv.batch_stats.items()},
              "bn_old": {k: rnd(v) for k, v in mv.batch_stats.items()}}
        return st

    lr = torch.rand((C,), generator=gen, device=dev)
    max_err = 0.0
    for fg_on in (False, True):
        for valid in (torch.tensor([1, 0, 1, 1, 0, 1, 1, 1, 0, 1.0],
                                   device=dev),
                      torch.ones((C,), device=dev)):
            st = state(fg_on)
            want = fu.fused_step_update_reference(
                lr, valid, st["params"], st["grads"], st["mom"], st["fg"],
                st["bn_new"], st["bn_old"], momentum=mu, weight_decay=wd)
            fu.fused_step_update(lr, valid, st["params"], st["grads"],
                                 st["mom"], st["fg"], st["bn_new"],
                                 st["bn_old"], momentum=mu, weight_decay=wd)
            torch.cuda.synchronize()
            for got, ref in zip((st["params"], st["mom"], st["fg"],
                                 st["bn_old"]), want):
                for k in ref:
                    err = float((got[k] - ref[k]).abs().max())
                    max_err = max(max_err, err)
                    if not torch.equal(got[k], ref[k]):
                        raise AssertionError(
                            f"fused_step_update differs from its plain "
                            f"version (fg={fg_on}, leaf {k}): max abs "
                            f"{err}")
    n_el = sum(v.numel() for v in mv.params.values())
    log(f"phase 3{'b' if label else ''}: fused_step_update bitwise equal to "
        f"its plain version on {config} ({len(mv.params)} param + "
        f"{len(mv.batch_stats)} BN leaves, {n_el} params per client, C={C}, "
        f"FoolsGold on/off, invalid lanes)")
    del st, want
    torch.cuda.empty_cache()

    # timing at the main path's shapes, every client valid: FoolsGold off
    # (FedAvg, RFA, ...) and on (the sgd_acc leaves)
    return [time_fused_update(state(fg_on), lr, mu, wd, max_err, fg_on, C,
                              label) for fg_on in fg_cases]


def time_fused_update(st, lr, mu, wd, max_err, fg_on, C, label="") -> dict:
    """The kernel's time over launches of one prepared leaf table (so the
    wrapper's host work is not in it), that host work on its own, the whole
    wrapper in steady state, the plain version, and a PyTorch library
    yardstick: SGD(fused=True).step() over the same param leaves with one
    lr (no validity or BN select), followed with FoolsGold on by
    torch._foreach_add_ of the grads into the accumulators."""
    import torch
    from dba_mod_tpu_torch.ops import fused_update as fu
    dev = lr.device
    ones = torch.ones((C,), device=dev)
    args = (lr, ones, st["params"], st["grads"], st["mom"], st["fg"],
            st["bn_new"], st["bn_old"])
    kw = {"momentum": mu, "weight_decay": wd}
    launch = fu.prepare_launch(*args, **kw)
    before = fu.fused_step_update.launches
    fu.fused_step_update(*args, **kw)
    per_call = fu.fused_step_update.launches - before
    ms = cuda_ms(launch)
    kernel_profiler_ms = device_ms(launch, name="fused_step_update_kernel")
    wrapper_ms = cuda_ms(lambda: fu.fused_step_update(*args, **kw))
    wrapper_host_ms = host_ms(lambda: fu.fused_step_update(*args, **kw))

    def plain():
        fu.fused_step_update_reference(*args, **kw)

    plain_ms = cuda_ms(plain)
    plain_device_ms = device_ms(plain)
    # never used by the port
    leaves = [t.clone().requires_grad_(True) for t in st["params"].values()]
    for t, g in zip(leaves, st["grads"].values()):
        t.grad = g
    opt = torch.optim.SGD(leaves, lr=0.1, momentum=mu, weight_decay=wd,
                          fused=True)
    accs = [t.clone() for t in st["fg"].values()]
    grads = list(st["grads"].values())

    def library():
        opt.step()
        if fg_on:
            torch._foreach_add_(accs, grads)

    library_ms = cuda_ms(library)
    library_device_ms = device_ms(library)
    n_p = sum(t.numel() for t in st["params"].values())
    n_b = sum(t.numel() for t in st["bn_old"].values())
    # each input read once, each output written once, as this run's data
    # needs: sgd reads w, g, m and writes w, m (20 B), sgd_acc also reads
    # and writes fg (28 B); with every client valid, sel reads bn_new and
    # writes bn_old (8 B)
    nbytes = (28 if fg_on else 20) * n_p + 8 * n_b
    flops = (7 if fg_on else 6) * n_p
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP32_FLOPS * 1e3
    tags = [t for t in (label, "foolsgold" if fg_on else "") if t]
    return {"name": "fused_step_update" + (f"[{','.join(tags)}]" if tags
                                           else ""), "route": "cuda",
            "source": "dba_mod_tpu_torch/csrc/fused_update.cu",
            "replaces": "dba_mod_tpu/ops/fused_update.py:69",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "library_ms": library_ms,
            "launches_per_step": per_call,
            "kernel_profiler_ms": kernel_profiler_ms,
            "wrapper_ms": wrapper_ms, "wrapper_host_ms": wrapper_host_ms,
            "plain_device_ms": plain_device_ms,
            "library_device_ms": library_device_ms, "bytes": nbytes}


# ---------------------------------------------------------------- phase 4
def steps_by_epoch(train_csv: Path, batch: int) -> dict:
    """Local steps each recorded round ran, by epoch: in each (round,
    internal epoch) the stacked step loop runs the steps where ANY client
    has a sample, i.e. max over clients of ceil(samples / batch). A client
    with no samples is recorded with total 1 and loss 0."""
    steps: dict = {}
    with open(train_csv, newline="") as f:
        for row in csv.DictReader(f):
            n = int(row["total_data"])
            if n == 1 and float(row["average_loss"]) == 0.0:
                n = 0
            key = (int(row["epoch"]), int(row["internal_epoch"]))
            steps[key] = max(steps.get(key, 0), -(-n // batch))
    out: dict = {}
    for (epoch, _), n in steps.items():
        out[epoch] = out.get(epoch, 0) + n
    return out


def expected_launches(train_csv: Path, batch: int) -> int:
    """Local steps the recorded rounds ran (see steps_by_epoch)."""
    return sum(steps_by_epoch(train_csv, batch).values())


def _watch_aggregate(record: list):
    """Wrap RoundEngine.aggregate_fn to record each call's device-synced
    seconds and RFA's oracle count; returns the undo function."""
    import torch
    from dba_mod_tpu_torch.fl import rounds
    real = rounds.RoundEngine.aggregate_fn

    def timed(self, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real(self, *args, **kw)
        torch.cuda.synchronize()
        record.append({"seconds": time.perf_counter() - t,
                       "oracle_calls": int(res.num_oracle_calls)})
        return res

    rounds.RoundEngine.aggregate_fn = timed
    return lambda: setattr(rounds.RoundEngine, "aggregate_fn", real)


def run_main_path(tmp: Path) -> dict:
    """Phase 4 (see the module docstring); also the float32 phase seconds
    and peak memory that phase 8 compares bf16 against."""
    import torch
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.main import main as cli_main
    from dba_mod_tpu_torch.models import build_model
    from dba_mod_tpu_torch.ops import fused_update as fu

    raw = yaml.safe_load((REPO / "configs" / "cifar_params.yaml").read_text())
    raw.update(synthetic_data=True, run_dir=str(tmp / "runs"),
               checkpoint_dir=str(tmp / "ckpt"), save_model=True,
               save_on_epochs=[2, 3],
               **{"0_poison_epochs": [2], "1_poison_epochs": [3]})
    cfg_path = tmp / "cifar_smoke.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))

    t0 = time.perf_counter()
    if cli_main(["pretrain", "--params", str(cfg_path), "--epochs", "1",
             "--out", "cifar_pretrain/smoke"]) != 0:
        raise AssertionError("pretrain failed")
    pretrain_s = time.perf_counter() - t0
    aggs: list = []
    phases: dict = {}
    undo = _watch_aggregate(aggs)
    undo_phases = _watch_phases(phases)
    fu.fused_step_update.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        if cli_main(["train", "--params", str(cfg_path), "--resume",
                     "cifar_pretrain/smoke", "--epochs", "3"]) != 0:
            raise AssertionError("train failed")
        torch.cuda.synchronize()
    finally:
        undo_phases()
        undo()
    train_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    launches = fu.fused_step_update.launches

    runs = list((tmp / "runs").iterdir())
    if len(runs) != 1:
        raise AssertionError(f"expected one run folder, found {runs}")
    folder = runs[0]
    for name in ("train_result.csv", "test_result.csv",
                 "posiontest_result.csv", "poisontriggertest_result.csv",
                 "round_result.csv", "scale_result.csv", "metrics.jsonl",
                 "params.yaml", "params.html"):
        if not (folder / name).is_file():
            raise AssertionError(f"recorder file missing: {name}")
    by_epoch = steps_by_epoch(folder / "train_result.csv",
                              int(raw["batch_size"]))
    want = sum(by_epoch.values())
    if launches != want or launches == 0:
        raise AssertionError(f"fused kernel launched {launches} times, the "
                             f"rounds ran {want} local steps")
    rows = [json.loads(l) for l in
            (folder / "metrics.jsonl").read_text().splitlines() if l.strip()]
    if [r["epoch"] for r in rows] != [2, 3]:
        raise AssertionError(f"recorded epochs {[r['epoch'] for r in rows]}")
    for r in rows:
        for k in ("global_acc", "backdoor_acc"):
            if not math.isfinite(float(r[k])):
                raise AssertionError(f"non-finite {k} in {r}")
        if not r["adversaries"]:
            raise AssertionError(f"round {r['epoch']} did not poison")
    params = Params.from_yaml(cfg_path)
    like = build_model(params).init_vars(0, torch.device("cpu"))
    min_var = {}
    for ep, name in ((2, "model_last.pt.tar.epoch_2"),
                     (3, "model_last.pt.tar")):
        ok, why = ckpt.verify_checkpoint(folder / name)
        if not ok:
            raise AssertionError(f"saved global model {name} not verified: "
                                 f"{why}")
        gv, epoch, _ = ckpt.load_checkpoint(folder / name, like)
        if epoch != ep:
            raise AssertionError(f"{name} holds epoch {epoch}, not {ep}")
        for k, v in list(gv.params.items()) + list(gv.batch_stats.items()):
            if not torch.isfinite(v).all():
                raise AssertionError(f"non-finite global model leaf {k} "
                                     f"after epoch {ep}")
        # FedAvg averages the BN running stats with the scaled deltas
        # (helper.py:240-257): a ×100 adversary can leave a running
        # variance below zero, and the eval loss of that round is then NaN
        # (rsqrt of a negative) while the weights stay finite
        min_var[ep] = min(float(v.min()) for k, v in gv.batch_stats.items()
                          if k.endswith("running_var"))
    with open(folder / "round_result.csv", newline="") as f:
        round_s = [float(r["round_time"]) for r in csv.DictReader(f)]
    log(f"phase 4: pretrain {pretrain_s:.1f}s; resumed train of 2 poisoned "
        f"rounds {train_s:.1f}s; round_time per round {round_s}; FedAvg "
        f"aggregate {[round(a['seconds'], 4) for a in aggs]}s; "
        f"{launches} fused launches = {want} local steps; final "
        f"acc={rows[-1]['global_acc']:.2f} "
        f"backdoor={rows[-1]['backdoor_acc']:.2f}; global eval loss "
        f"{[r['global_loss'] for r in rows]}, min BN running var "
        f"{min_var}")
    return {"launches": launches, "steps": want,
            "round_steps": [by_epoch[ep] for ep in (2, 3)], "round_s": round_s,
            "aggregate_s": [a["seconds"] for a in aggs],
            "phase_s": {k: [round(x, 4) for x in v]
                        for k, v in phases.items()},
            "peak_mb": peak_mb, "pretrain_s": pretrain_s, "train_s": train_s,
            "global_acc": [r["global_acc"] for r in rows],
            "global_loss": [r["global_loss"] if math.isfinite(
                float(r["global_loss"])) else str(r["global_loss"])
                for r in rows],
            "min_running_var": [min_var[2], min_var[3]],
            "backdoor_acc": [r["backdoor_acc"] for r in rows]}


# --------------------------------------------------------------- phase 4b
def run_robust_rounds(tmp: Path) -> dict:
    """Two poisoned full-width CIFAR rounds under FoolsGold and two under
    RFA through the CLI, resumed from phase 4's pretrained model, with
    phase 4's config changed only in aggregation_methods and the run
    folder. The first round's server aggregate carries the process's
    first use of the rule's kernels; the second shows the steady state."""
    import torch
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.main import main as cli_main
    from dba_mod_tpu_torch.models import build_model
    from dba_mod_tpu_torch.ops import fused_update as fu

    base = yaml.safe_load((tmp / "cifar_smoke.yaml").read_text())
    like = build_model(Params.from_dict(base)).init_vars(
        0, torch.device("cpu"))
    resumed, _, _ = ckpt.load_checkpoint(ckpt.resolve_verified(
        tmp / "ckpt" / "cifar_pretrain" / "smoke"), like)
    out = {}
    for rule in ("foolsgold", "geom_median"):
        raw = dict(base, aggregation_methods=rule,
                   run_dir=str(tmp / f"runs_{rule}"))
        cfg_path = tmp / f"cifar_{rule}.yaml"
        cfg_path.write_text(yaml.safe_dump(raw))
        aggs: list = []
        undo = _watch_aggregate(aggs)
        fu.fused_step_update.launches = 0
        try:
            if cli_main(["train", "--params", str(cfg_path), "--resume",
                         "cifar_pretrain/smoke", "--epochs", "3"]) != 0:
                raise AssertionError(f"{rule} rounds failed")
            torch.cuda.synchronize()
        finally:
            undo()
        launches = fu.fused_step_update.launches
        (folder,) = list((tmp / f"runs_{rule}").iterdir())
        steps = expected_launches(folder / "train_result.csv",
                                  int(raw["batch_size"]))
        if launches != steps or launches == 0:
            raise AssertionError(f"{rule}: fused kernel launched {launches} "
                                 f"times, the round ran {steps} local steps "
                                 f"(one launch per step)")
        rows = [r for r in csv.reader(open(folder / "weight_result.csv"))]
        weights = [[float(x) for x in r] for i, r in enumerate(rows)
                   if i % 3]   # names, wv, alpha per round
        if len(rows) != 6 or not all(math.isfinite(x) for r in weights
                                     for x in r):
            raise AssertionError(f"{rule}: weight_result rows {rows}")
        recs = [json.loads(l) for l in (folder / "metrics.jsonl")
                .read_text().splitlines() if l.strip()]
        if [r["epoch"] for r in recs] != [2, 3] or not all(
                r["adversaries"] for r in recs):
            raise AssertionError(f"{rule}: rounds {recs}")
        row = recs[-1]
        gv, _, _ = ckpt.load_checkpoint(folder / "model_last.pt.tar", like)
        if not all(bool(torch.isfinite(v).all()) for v in
                   list(gv.params.values()) + list(gv.batch_stats.values())):
            raise AssertionError(f"{rule}: non-finite global model")
        calls = [a["oracle_calls"] for a in aggs]
        if rule == "foolsgold":
            # FoolsGold steps the parameters only (helper.py:286-290)
            for k, v in resumed.batch_stats.items():
                if not torch.equal(gv.batch_stats[k], v):
                    raise AssertionError(f"foolsgold moved BN stat {k}")
        elif not all(1 <= c <= int(raw["geom_median_maxiter"]) + 1
                     for c in calls):
            raise AssertionError(f"RFA oracle calls {calls}")
        with open(folder / "round_result.csv", newline="") as f:
            round_s = [float(r["round_time"]) for r in csv.DictReader(f)]
        agg_s = [a["seconds"] for a in aggs]
        out[rule] = {"launches": launches, "round_s": round_s,
                     "aggregate_s": agg_s, "oracle_calls": calls,
                     "wv": weights[-2], "global_acc": row["global_acc"],
                     "backdoor_acc": row["backdoor_acc"]}
        log(f"phase 4b: {rule}, 2 poisoned CIFAR rounds: round_time "
            f"{round_s}, aggregate {[round(s, 4) for s in agg_s]}s, "
            f"{launches} fused launches = {steps} local steps x 1, oracle "
            f"calls {calls}, last wv {[round(w, 4) for w in weights[-2]]}, "
            f"acc {row['global_acc']:.2f} backdoor "
            f"{row['backdoor_acc']:.2f}"
            + ("; global BN stats bitwise the resumed model's"
               if rule == "foolsgold" else ""))
    return out


# --------------------------------------------------------------- phase 4c
def time_aggregation_rules(dev) -> dict:
    """Each rule's server aggregate on the full CIFAR ResNet-18 state at
    C = 10 (random deltas, every client a survivor), timed on the card:
    CUDA events around back-to-back calls of fl/rounds.aggregate, and the
    peak device memory of one call."""
    import torch
    import yaml
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.rounds import aggregate
    from dba_mod_tpu_torch.fl.state import RoundHyper
    from dba_mod_tpu_torch.models import ModelVars, build_model
    from dba_mod_tpu_torch.ops.aggregation import foolsgold_init

    raw = yaml.safe_load((REPO / "configs" / "cifar_params.yaml")
                         .read_text())
    mv = build_model(Params.from_dict(raw)).init_vars(0, dev)
    C = 10
    gen = torch.Generator(device=dev).manual_seed(1)

    def stacked(tree):
        return {k: 1e-3 * torch.randn((C,) + tuple(v.shape), generator=gen,
                                      device=dev) for k, v in tree.items()}

    deltas = ModelVars(stacked(mv.params), stacked(mv.batch_stats))
    fg_grads = stacked(mv.params)
    feat = fg_grads["fc.weight"].reshape(C, -1)
    ns = torch.full((C,), 500.0, device=dev)
    ids = torch.arange(C, device=dev) * 7
    out = {}
    for rule in ("mean", "foolsgold", "geom_median", "krum",
                 "trimmed_mean", "median"):
        hyper = RoundHyper.from_params(Params.from_dict(
            dict(raw, aggregation_methods=rule)))
        fg = foolsgold_init(100, feat.shape[1], dev)

        def call():
            return aggregate(hyper, mv, deltas, fg_state=fg,
                             fg_grads=fg_grads, fg_feature=feat,
                             participant_ids=ids, num_samples=ns)

        res = call()
        if not all(bool(torch.isfinite(v).all()) for v in
                   list(res.new_vars.params.values())
                   + list(res.new_vars.batch_stats.values())):
            raise AssertionError(f"{rule}: non-finite aggregate")
        torch.cuda.reset_peak_memory_stats()
        out[rule] = {"ms": cuda_ms(call, reps=10, warmup=2),
                     "peak_mb": torch.cuda.max_memory_allocated() / 1e6}
    log("phase 4c: server aggregate at full CIFAR size, C=10 (ms, peak MB): "
        + ", ".join(f"{k} {v['ms']:.2f} ({v['peak_mb']:.0f})"
                    for k, v in out.items()))
    return out


# ---------------------------------------------------------------- phase 6
def _watch_phases(record: dict):
    """Wrap the round engine's phases (train, aggregate, local and global
    battery) so each call adds its device-synced seconds to record[name];
    returns the undo function. The syncs add a few host waits a round."""
    import torch
    from dba_mod_tpu_torch.fl import rounds
    names = ("train_fn", "aggregate_fn", "local_evals", "global_evals")
    real = {n: getattr(rounds.RoundEngine, n) for n in names}

    def timed(name):
        def call(self, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = real[name](self, *args, **kw)
            torch.cuda.synchronize()
            record.setdefault(name, []).append(time.perf_counter() - t)
            return res
        return call

    for n in names:
        setattr(rounds.RoundEngine, n, timed(n))
    return lambda: [setattr(rounds.RoundEngine, n, f)
                    for n, f in real.items()]


def _train_rounds(cfg_path: Path, resume: str, epochs: int, run_dir: Path,
                  batch: int, want_epochs: list, what: str,
                  finite_rounds: int | None = None) -> dict:
    """Resume `resume` and train through `epochs` via the CLI; check one
    fused launch per local step, the recorded epochs, that every round
    poisoned and that accuracies are finite (in the first `finite_rounds`
    rounds' clean accuracy only, when given). Returns the rounds' numbers:
    round_time, the engine's phase seconds and the peak device memory."""
    import torch
    from dba_mod_tpu_torch.main import main as cli_main
    from dba_mod_tpu_torch.ops import fused_update as fu

    phases: dict = {}
    undo = _watch_phases(phases)
    fu.fused_step_update.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        if cli_main(["train", "--params", str(cfg_path), "--resume", resume,
                     "--epochs", str(epochs)]) != 0:
            raise AssertionError(f"{what}: train failed")
        torch.cuda.synchronize()
    finally:
        undo()
    train_s = time.perf_counter() - t0
    launches = fu.fused_step_update.launches
    (folder,) = list(run_dir.iterdir())
    by_epoch = steps_by_epoch(folder / "train_result.csv", batch)
    steps = sum(by_epoch.values())
    if launches != steps or launches == 0:
        raise AssertionError(f"{what}: fused kernel launched {launches} "
                             f"times, the rounds ran {steps} local steps")
    rows = [json.loads(l) for l in
            (folder / "metrics.jsonl").read_text().splitlines() if l.strip()]
    if [r["epoch"] for r in rows] != want_epochs:
        raise AssertionError(f"{what}: recorded epochs "
                             f"{[r['epoch'] for r in rows]}")
    for i, r in enumerate(rows):
        if not r["adversaries"]:
            raise AssertionError(f"{what}: round {r['epoch']} did not poison")
        keys = (("global_acc", "backdoor_acc") if finite_rounds is None
                else ("global_acc",) if i < finite_rounds else ())
        for k in keys:
            if not math.isfinite(float(r[k])):
                raise AssertionError(f"{what}: non-finite {k} in {r}")
    with open(folder / "round_result.csv", newline="") as f:
        round_s = [float(r["round_time"]) for r in csv.DictReader(f)]
    return {"folder": folder, "launches": launches, "steps": steps,
            "round_steps": [by_epoch[ep] for ep in want_epochs],
            "train_s": train_s, "round_s": round_s,
            "phase_s": {k: [round(x, 4) for x in v]
                        for k, v in phases.items()},
            "peak_mb": torch.cuda.max_memory_allocated() / 1e6,
            "global_acc": [r["global_acc"] for r in rows],
            "backdoor_acc": [r["backdoor_acc"] for r in rows],
            "global_loss": [r["global_loss"] if math.isfinite(
                float(r["global_loss"])) else str(r["global_loss"])
                for r in rows]}


def run_tiny_path(tmp: Path) -> dict:
    """The Tiny-ImageNet main path at full width: configs/tiny_params.yaml
    (full 64-base ResNet-18, 100 participants, 10 per round, batch 64,
    Dirichlet 0.01, 4 adversaries) on the synthetic set of the full
    100,000 / 10,000 size. The set is made once with the port's generator
    and written as the tiny-imagenet-200.npz cache that load_tiny_imagenet
    reads, so the three CLI runs load it instead of drawing 1.2 G normal
    values each. Pretrain one round, resume it by name, two FedAvg rounds
    that both poison, then one FoolsGold round from the same pretrain."""
    import numpy as np
    import torch
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.data.datasets import synthetic_image_dataset
    from dba_mod_tpu_torch.main import main as cli_main
    from dba_mod_tpu_torch.models import build_model

    raw = yaml.safe_load((REPO / "configs" / "tiny_params.yaml").read_text())
    t0 = time.perf_counter()
    data = synthetic_image_dataset("tiny-imagenet-200",
                                   seed=int(raw["random_seed"]))
    (tmp / "tiny_data").mkdir()
    np.savez(tmp / "tiny_data" / "tiny-imagenet-200.npz",
             train_x=data.train_images, train_y=data.train_labels,
             test_x=data.test_images, test_y=data.test_labels)
    n_train, n_test = len(data.train_labels), len(data.test_labels)
    del data
    data_s = time.perf_counter() - t0
    if (n_train, n_test) != (100000, 10000):
        raise AssertionError(f"synthetic Tiny set of {n_train}/{n_test}")
    raw.update(data_dir=str(tmp / "tiny_data"), run_dir=str(tmp / "runs_tiny"),
               checkpoint_dir=str(tmp / "ckpt"), save_model=True,
               save_on_epochs=[2, 3],
               **{"0_poison_epochs": [2], "1_poison_epochs": [3],
                  "2_poison_epochs": [], "3_poison_epochs": []})
    cfg_path = tmp / "tiny_smoke.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    t0 = time.perf_counter()
    if cli_main(["pretrain", "--params", str(cfg_path), "--epochs", "1",
                 "--out", "tiny_pretrain/smoke"]) != 0:
        raise AssertionError("tiny pretrain failed")
    pretrain_s = time.perf_counter() - t0
    b = int(raw["batch_size"])
    fedavg = _train_rounds(cfg_path, "tiny_pretrain/smoke", 3,
                           tmp / "runs_tiny", b, [2, 3], "tiny FedAvg")
    like = build_model(Params.from_dict(raw)).init_vars(
        0, torch.device("cpu"))
    gv, epoch, _ = ckpt.load_checkpoint(fedavg["folder"] / "model_last.pt.tar",
                                        like)
    ok, why = ckpt.verify_checkpoint(fedavg["folder"] / "model_last.pt.tar")
    if not ok or epoch != 3 or not all(
            bool(torch.isfinite(v).all()) for v in gv.params.values()):
        raise AssertionError(f"tiny saved model: epoch {epoch}, {why}")
    # FedAvg averages the BN running stats with the ×100 adversary's delta,
    # as CIFAR's phase 4 shows: a negative running variance makes the
    # round's eval loss NaN while the weights stay finite
    min_var = min(float(v.min()) for k, v in gv.batch_stats.items()
                  if k.endswith("running_var"))
    fg_raw = dict(raw, aggregation_methods="foolsgold",
                  run_dir=str(tmp / "runs_tiny_fg"))
    fg_path = tmp / "tiny_foolsgold.yaml"
    fg_path.write_text(yaml.safe_dump(fg_raw))
    fg = _train_rounds(fg_path, "tiny_pretrain/smoke", 2,
                       tmp / "runs_tiny_fg", b, [2], "tiny FoolsGold")
    for name, r in (("FedAvg", fedavg), ("FoolsGold", fg)):
        log(f"phase 6: Tiny-ImageNet {name}, {len(r['round_s'])} poisoned "
            f"full-width round(s): round_time {r['round_s']}; phase seconds "
            f"{r['phase_s']}; {r['launches']} fused launches = {r['steps']} "
            f"local steps; peak {r['peak_mb']:.0f} MB; acc "
            f"{r['global_acc']} backdoor {r['backdoor_acc']} global loss "
            f"{r['global_loss']}")
    log(f"phase 6: synthetic Tiny set {n_train}/{n_test} made and cached in "
        f"{data_s:.1f}s; pretrain {pretrain_s:.1f}s; FedAvg min BN running "
        f"var {min_var:.4g}")
    for r in (fedavg, fg):
        del r["folder"]
    return {"data_s": data_s, "pretrain_s": pretrain_s, "fedavg": fedavg,
            "foolsgold": fg, "min_running_var": min_var}


# ---------------------------------------------------------------- phase 7
@contextlib.contextmanager
def _probe_lines():
    """Collects the experiment's poison-probe log lines: the adaptive LOAN
    poison LR each poisoned round used."""
    import logging
    lines: list = []

    class Grab(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "poison probe" in msg:
                lines.append(msg)

    grab, logger = Grab(), logging.getLogger("dba_mod_tpu_torch")
    logger.addHandler(grab)
    try:
        yield lines
    finally:
        logger.removeHandler(grab)


def run_loan_path(tmp: Path) -> dict:
    """LOAN through the CLI: configs/loan_params.yaml (51 synthetic
    states, 10 per round, batch 64, LoanNet with dropout, 3 adversary
    states with feature triggers, scale 30) — pretrain one round, resume
    it, two poisoned rounds (the adversaries' poison epochs cut to 2 and
    3), each with its adaptive poison LR from the probe; then one poisoned
    round on the card against the same round on the CPU, from the same
    weights and the same CPU-drawn dropout masks."""
    import yaml
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.main import main as cli_main

    raw = yaml.safe_load((REPO / "configs" / "loan_params.yaml").read_text())
    raw.update(synthetic_data=True, run_dir=str(tmp / "runs_loan"),
               checkpoint_dir=str(tmp / "ckpt"),
               **{"0_poison_epochs": [2], "1_poison_epochs": [3],
                  "2_poison_epochs": []})
    cfg_path = tmp / "loan_smoke.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    t0 = time.perf_counter()
    if cli_main(["pretrain", "--params", str(cfg_path), "--epochs", "1",
                 "--out", "loan_pretrain/smoke"]) != 0:
        raise AssertionError("loan pretrain failed")
    pretrain_s = time.perf_counter() - t0
    with _probe_lines() as probe:
        r = _train_rounds(cfg_path, "loan_pretrain/smoke", 3,
                          tmp / "runs_loan", int(raw["batch_size"]), [2, 3],
                          "LOAN")
    if len(probe) != 2:
        raise AssertionError(f"LOAN probe lines {probe}")
    del r["folder"]
    r["probe"] = probe
    log(f"phase 7: LOAN, 2 poisoned rounds: round_time {r['round_s']}; "
        f"phase seconds {r['phase_s']}; {r['launches']} fused launches = "
        f"{r['steps']} local steps; peak {r['peak_mb']:.0f} MB; acc "
        f"{r['global_acc']} backdoor {r['backdoor_acc']}; probe "
        f"{probe}; pretrain {pretrain_s:.1f}s")

    # one round card vs CPU: the same init (a CPU generator), plans and
    # dropout masks (drawn on the CPU, keyed by seed, epoch and segment)
    one = dict(raw, resumed_model=False, **{"0_poison_epochs": [1]})
    outs = {}
    for name in ("cuda", "cpu"):
        exp = Experiment(Params.from_dict(dict(
            one, run_dir=str(tmp / f"loan_{name}"))), save_results=False,
            device=name)
        res = exp.run_round(1)
        outs[name] = (res, {k: v.cpu() for k, v in
                            exp.global_vars.params.items()})
    diff = max(float((outs["cuda"][1][k] - outs["cpu"][1][k]).abs().max())
               for k in outs["cpu"][1])
    acc_gap = abs(outs["cuda"][0]["global_acc"] - outs["cpu"][0]["global_acc"])
    if not diff <= 5e-6 or not acc_gap <= 1.0:
        raise AssertionError(f"card vs CPU LOAN round: global max abs diff "
                             f"{diff}, accuracy gap {acc_gap}")
    log(f"phase 7: LOAN round card vs CPU: global max abs diff {diff:.3g}, "
        f"accuracy gap {acc_gap:.3g}")
    r.update(pretrain_s=pretrain_s, card_vs_cpu=diff, acc_gap=acc_gap)
    return r


# ---------------------------------------------------------------- phase 5
def check_small_reference(tmp: Path) -> dict:
    """One poisoned MNIST smoke round (smoke_params.yaml at its own small
    size) on the card against the same round on the CPU (the plain path:
    plain fused update, CPU convolutions), from the same initial weights
    and plans, under FedAvg and under FoolsGold. Bound 1e-4 on the global
    state: f32 convolutions sum in another order in cuDNN than on the CPU,
    and the ~1e-7 relative differences compound over the round's SGD
    steps."""
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment

    result = {}
    for rule in ("mean", "foolsgold"):
        outs = {}
        for name in ("cuda", "cpu"):
            p = Params.from_yaml(REPO / "configs" / "smoke_params.yaml")
            p.raw.update(run_dir=str(tmp / f"small_{name}"),
                         aggregation_methods=rule)
            exp = Experiment(p, save_results=False, device=name)
            r = exp.run_round(3)       # adversary 0 poisons from round 3
            outs[name] = (r, {k: v.cpu() for k, v in
                              exp.global_vars.params.items()})
        diff = max(float((outs["cuda"][1][k] - outs["cpu"][1][k])
                         .abs().max()) for k in outs["cpu"][1])
        acc_gap = abs(outs["cuda"][0]["global_acc"]
                      - outs["cpu"][0]["global_acc"])
        if not diff <= 1e-4 or not acc_gap <= 1.0:
            raise AssertionError(f"card vs CPU MNIST {rule} round: global "
                                 f"max abs diff {diff}, accuracy gap "
                                 f"{acc_gap}")
        log(f"phase 5: MNIST {rule} round card vs CPU: global max abs diff "
            f"{diff:.3g}, accuracy gap {acc_gap:.3g}")
        result[rule] = {"global_max_abs_diff": diff, "acc_gap": acc_gap}
    return result


def check_fault_round(tmp: Path) -> dict:
    """One MNIST smoke round on the card with the fault layer on: a corrupt
    lane that hits clients 1 and 2 of epoch 3 (fault_seed 0, probability
    0.5, the port's own plan) and the screen on. The round must quarantine
    them and commit a finite global model."""
    import torch
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment

    p = Params.from_yaml(REPO / "configs" / "smoke_params.yaml")
    p.raw.update(run_dir=str(tmp / "fault"), fault_injection=True,
                 fault_corrupt_prob=0.5, fault_seed=0, screen_updates=True)
    exp = Experiment(p, save_results=True, device="cuda")
    r = exp.run_round(3)
    finite = all(bool(torch.isfinite(v).all()) for v in
                 list(exp.global_vars.params.values())
                 + list(exp.global_vars.batch_stats.values()))
    if r["n_quarantined"] < 1 or r["degraded"] or not finite or \
            not math.isfinite(r["global_acc"]):
        raise AssertionError(f"fault round on the card: {r}, finite model "
                             f"{finite}")
    log(f"phase 5b: MNIST fault round on the card: quarantined "
        f"{r['n_quarantined']}, dropped {r['n_dropped']}, retries "
        f"{r['n_retries']}, acc {r['global_acc']:.2f}, finite global model")
    return {k: r[k] for k in ("n_quarantined", "n_dropped", "n_retries",
                              "degraded", "global_acc")}


# ---------------------------------------------------------------- phase 8
def _per_step(r: dict) -> dict:
    """Train ms a step and battery seconds of each round, and peak MB, of a
    run whose phases _watch_phases recorded."""
    ph = r["phase_s"]
    return {"train_ms_per_step": [round(1e3 * t / n, 2) for t, n in
                                  zip(ph["train_fn"], r["round_steps"])],
            "battery_s": [round(a + b, 4) for a, b in
                          zip(ph["local_evals"], ph["global_evals"])],
            "round_s": r["round_s"], "peak_mb": round(r["peak_mb"], 1)}


def bf16_rounds(tmp: Path) -> int:
    """Phase 8's two CIFAR bf16 rounds, in the fresh process run_bf16
    starts; prints their numbers as one JSON line."""
    import yaml
    raw = dict(yaml.safe_load((tmp / "cifar_smoke.yaml").read_text()),
               compute_dtype="bfloat16", run_dir=str(tmp / "runs_bf16"))
    cfg_path = tmp / "cifar_bf16.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    r = _train_rounds(cfg_path, "cifar_pretrain/smoke", 3,
                      tmp / "runs_bf16", int(raw["batch_size"]), [2, 3],
                      "CIFAR bf16", finite_rounds=1)
    del r["folder"]
    print(json.dumps(r), flush=True)
    return 0


def run_bf16(tmp: Path, f32: dict) -> dict:
    """Phase 8: two poisoned full-width CIFAR FedAvg rounds in bf16 from
    phase 4's pretrain, beside phase 4's float32 numbers; then one
    poisoned MNIST bf16 round card vs CPU. The bf16 rounds run in a fresh
    process: their step is partly host-bound (PERF.md §5), and a
    host-bound step slows as a process accumulates state, where phase 4's
    device-bound float32 step does not."""
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment

    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                          "bf16-rounds", str(tmp)], capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"bf16 rounds failed:\n{out.stdout[-4000:]}"
                             f"\n{out.stderr[-4000:]}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    bf16, fp32 = _per_step(r), _per_step(f32)
    log(f"phase 8: CIFAR bf16, 2 poisoned full-width rounds: round_time "
        f"{bf16['round_s']} (float32 {fp32['round_s']}); train "
        f"{bf16['train_ms_per_step']} ms a step (float32 "
        f"{fp32['train_ms_per_step']}; the fresh process's first round "
        f"also pays cuDNN's first use of each bf16 shape); local + global "
        f"battery "
        f"{bf16['battery_s']} s (float32 {fp32['battery_s']}); peak "
        f"{bf16['peak_mb']:.0f} MB (float32 {fp32['peak_mb']:.0f}); "
        f"{r['launches']} fused launches = {r['steps']} local steps; clean "
        f"acc {r['global_acc']} (float32 {f32['global_acc']}), backdoor "
        f"{r['backdoor_acc']} (float32 {f32['backdoor_acc']}), global loss "
        f"{r['global_loss']}")
    outs = {}
    for name in ("cuda", "cpu"):
        p = Params.from_yaml(REPO / "configs" / "smoke_params.yaml")
        p.raw.update(run_dir=str(tmp / f"bf16_small_{name}"),
                     compute_dtype="bfloat16")
        exp = Experiment(p, save_results=False, device=name)
        res = exp.run_round(3)       # adversary 0 poisons from round 3
        outs[name] = (res, {k: v.cpu() for k, v in
                            exp.global_vars.params.items()})
    diff = max(float((outs["cuda"][1][k] - outs["cpu"][1][k]).abs().max())
               for k in outs["cpu"][1])
    gaps = {k: abs(outs["cuda"][0][k] - outs["cpu"][0][k])
            for k in ("global_acc", "backdoor_acc")}
    if not all(g <= 1.0 for g in gaps.values()):
        raise AssertionError(f"card vs CPU MNIST bf16 round: accuracy gaps "
                             f"{gaps}")
    log(f"phase 8: MNIST bf16 round card vs CPU: accuracy gaps {gaps}, "
        f"global-model max abs diff {diff:.3g}")
    return {"cifar": dict(bf16, launches=r["launches"], steps=r["steps"],
                          global_acc=r["global_acc"],
                          backdoor_acc=r["backdoor_acc"],
                          global_loss=r["global_loss"]),
            "cifar_float32": fp32,
            "mnist_card_vs_cpu": {"acc_gaps": gaps,
                                  "global_max_abs_diff": diff}}


# ---------------------------------------------------------------- phase 9
def _launches_logged(log_file: Path) -> list:
    """The fused-launch counts each `main train` process logged."""
    return [int(line.rsplit(":", 1)[1]) for line in
            log_file.read_text().splitlines()
            if "fused update kernel launches:" in line]


def _health_lines(log_file: Path) -> list:
    return [line.split("epoch ", 1)[1] for line in
            log_file.read_text().splitlines() if ": health check " in line]


def _save_seconds(log_file: Path) -> list:
    """(snapshots, seconds) of each round's save_model, from its log."""
    out = []
    for line in log_file.read_text().splitlines():
        if " snapshot(s) in " in line:
            n, rest = line.split(": saved ", 1)[1].split(" snapshot(s) in ")
            out.append((int(n), float(rest.split("s:", 1)[0])))
    return out


def _round_rows(folder: Path) -> list:
    """round_result.csv less its clock columns."""
    with open(folder / "round_result.csv", newline="") as f:
        return [{k: v for k, v in row.items() if not k.endswith("time")}
                for row in csv.DictReader(f)]


def run_crash_resume(tmp: Path) -> dict:
    """Phase 9 (see the module docstring)."""
    import torch
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch import crash_smoke
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.main import main as cli_main
    from dba_mod_tpu_torch.models import build_model

    base = yaml.safe_load((tmp / "cifar_smoke.yaml").read_text())
    # no local battery: phases 4-8 run it, and it is half a CIFAR round
    base.update(aggregation_methods="foolsgold", local_eval=False,
                forensics=True,
                model_health_check=True, health_norm_band=3.0,
                health_warmup_merges=1, graceful_shutdown=True,
                keep_last_n=2, save_model=True, save_on_epochs=[2, 3, 4],
                resumed_model=True,
                resumed_model_name="cifar_pretrain/smoke",
                **{"0_poison_epochs": [2, 4], "1_poison_epochs": [3]})
    args = ["--epochs", "4", "--deterministic"]
    runs = {}
    for name in ("straight", "resumed"):
        raw = dict(base, run_dir=str(tmp / f"runs_crash_{name}"))
        cfg_path = tmp / f"cifar_crash_{name}.yaml"
        cfg_path.write_text(yaml.safe_dump(raw))
        t0 = time.perf_counter()
        if name == "straight":
            run_dir = Path(raw["run_dir"])
            run_dir.mkdir()
            log_file = tmp / f"runs_crash_{name}.crash_smoke.log"
            proc = crash_smoke.launch(cfg_path, "cuda", args, log_file)
            try:
                rc = proc.wait(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise
            if rc != 0:
                raise AssertionError(f"uninterrupted run exited {rc}:\n"
                                     + log_file.read_text()[-4000:])
            (folder,) = crash_smoke.run_folders(run_dir, base["type"])
            info = {}
        else:
            info = crash_smoke.interrupted_run(cfg_path, "cuda", 1, args,
                                               timeout=900)
            folder = info.pop("folder")
            log_file = tmp / f"runs_crash_{name}.crash_smoke.log"
        runs[name] = dict(info, folder=folder, log=log_file,
                          seconds=time.perf_counter() - t0)

    a, b = runs["straight"], runs["resumed"]
    like = build_model(Params.from_dict(base)).init_vars(
        0, torch.device("cpu"))
    ga, ea, _ = ckpt.load_checkpoint(a["folder"] / "model_last.pt.tar", like)
    gb, eb, _ = ckpt.load_checkpoint(b["folder"] / "model_last.pt.tar", like)
    unequal = [k for k in list(ga.params) + list(ga.batch_stats)
               if not torch.equal({**ga.params, **ga.batch_stats}[k],
                                  {**gb.params, **gb.batch_stats}[k])]
    if ea != eb or ea != 4 or unequal:
        raise AssertionError(f"resumed run's model differs from the "
                             f"uninterrupted one (epochs {ea}/{eb}): "
                             f"{unequal[:5]}")
    if _round_rows(a["folder"]) != _round_rows(b["folder"]):
        raise AssertionError("round_result.csv rows differ")
    for name in ("forensics.jsonl", "client_forensics.csv"):
        if (a["folder"] / name).read_bytes() != \
                (b["folder"] / name).read_bytes():
            raise AssertionError(f"{name} differs")
    snaps = {}
    for run in (a, b):
        for p in sorted(run["folder"].iterdir()):
            if p.is_dir():
                ok, why = ckpt.verify_checkpoint(p)
                if not ok:
                    raise AssertionError(f"{p} not verified: {why}")
                snaps.setdefault(p.name, 0)
                snaps[p.name] += 1
    if "model_last.pt.tar.epoch_2" in snaps:
        raise AssertionError(f"keep_last_n: 2 kept {sorted(snaps)}")
    recs = [json.loads(l) for l in (a["folder"] / "forensics.jsonl")
            .read_text().splitlines() if l.strip()]
    with open(a["folder"] / "client_forensics.csv", newline="") as f:
        crows = list(csv.DictReader(f))
    C = int(base["no_models"])
    adv = {str(x) for x in base["adversary_list"]}
    for r in recs:
        mine = [row for row in crows if int(row["epoch"]) == r["epoch"]]
        flagged = {row["name"] for row in mine if row["adversary"] == "1"}
        if (len(r["clients"]) != C or len(mine) != C or not r["adversaries"]
                or flagged != set(r["adversaries"]) or not flagged <= adv):
            raise AssertionError(f"forensic round {r['epoch']}: {r}")
    if cli_main(["report", "--run", str(a["folder"])]) != 0:
        raise AssertionError("report failed")
    html = a["folder"] / "forensics_report.html"
    if html.stat().st_size == 0:
        raise AssertionError("empty forensics report")
    launches = {}
    for name, run in runs.items():
        steps = expected_launches(run["folder"] / "train_result.csv",
                                  int(base["batch_size"]))
        got = _launches_logged(run["log"])
        if sum(got) != steps or steps == 0:
            raise AssertionError(f"{name}: fused launches {got}, local "
                                 f"steps {steps}")
        launches[name] = {"per_process": got, "steps": steps}
    aux = ckpt.manifest_path(a["folder"] / "model_last.pt.tar")
    sidecar = a["folder"] / ("model_last.pt.tar" + ckpt.AUX_SUFFIX)
    state = a["folder"] / "model_last.pt.tar" / ckpt.STATE_FILE
    with open(a["folder"] / "round_result.csv", newline="") as f:
        round_s = [float(r["round_time"]) for r in csv.DictReader(f)]
    decisions = _health_lines(a["log"])
    log(f"phase 9: CIFAR FoolsGold with forensics + sentinel, 3 poisoned "
        f"rounds: uninterrupted {a['seconds']:.1f}s (round_time {round_s}); "
        f"interrupted: SIGTERM after {b['signalled_after_rounds']} "
        f"committed round(s), exit 75 with epochs {b['stopped_epochs']} "
        f"recorded ({b['first_run_s']:.1f}s), --resume auto to "
        f"{b['epochs']} ({b['resume_run_s']:.1f}s); final models bitwise "
        f"equal, round_result/forensics rows equal; snapshots verified "
        f"{snaps}; fused launches {launches}; sentinel per round "
        f"{decisions}; resumed run {_health_lines(b['log'])}; sidecar "
        f"{sidecar.stat().st_size} B beside a {state.stat().st_size} B "
        f"model, manifest {aux.stat().st_size} B; save_model (snapshots, "
        f"s) {_save_seconds(a['log'])}; report {html.stat().st_size} B")
    return {"round_s": round_s, "straight_s": a["seconds"],
            "interrupted": {k: b[k] for k in (
                "signalled_after_rounds", "stopped_epochs", "epochs",
                "first_run_s", "resume_run_s")},
            "launches": launches, "health": decisions,
            "save_s": _save_seconds(a["log"]),
            "sidecar_bytes": sidecar.stat().st_size,
            "model_bytes": state.stat().st_size,
            "report_bytes": html.stat().st_size}


# --------------------------------------------------------------- phase 10
ASYNC_ONLY = ("mode", "buffer_occupancy", "staleness_mean", "staleness_max",
              "waves_dispatched", "arrivals_total", "virtual_time")
CLOCK_KEYS = ("time", "round_time", "dispatch_time", "finalize_time")


def _metrics_rows(folder: Path, drop=CLOCK_KEYS) -> list:
    return [{k: v for k, v in json.loads(l).items() if k not in drop}
            for l in (folder / "metrics.jsonl").read_text().splitlines()
            if l.strip()]


def async_keystone(tmp: Path) -> int:
    """Phase 10a, in the fresh process run_async starts (deterministic
    kernels must be chosen before anything runs on the card): the poisoned
    MNIST smoke run with the local battery, synchronous and then
    buffered-async at buffer_k == no_models with non-trivial arrival knobs.
    Prints one JSON line: whether the global models are bitwise equal and
    the recorded outputs (less clocks and the async-only keys) equal, and
    each run's fused launches, local steps and seconds."""
    from dba_mod_tpu_torch.utils.device import use_deterministic_kernels
    use_deterministic_kernels()
    import torch
    import yaml
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.ops import fused_update as fu
    from dba_mod_tpu_torch.utils.recorder import canonical_run_outputs

    raw = dict(yaml.safe_load(
        (REPO / "configs" / "smoke_params.yaml").read_text()),
        epochs=4, save_model=False)
    knobs = {"sync": {}, "async": dict(mode="async", arrival_rate=3.0,
                                       arrival_jitter=0.7,
                                       straggler_tail=0.25,
                                       straggler_factor=6.0)}
    runs = {}
    for mode, extra in knobs.items():
        p = Params.from_dict(dict(raw, run_dir=str(tmp / f"keystone_{mode}"),
                                  **extra))
        exp = Experiment(p, save_results=True, device="cuda")
        fu.fused_step_update.launches = 0
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        runs[mode] = {"exp": exp, "s": time.perf_counter() - t0,
                      "launches": fu.fused_step_update.launches,
                      "steps": expected_launches(
                          exp.folder / "train_result.csv",
                          int(raw["batch_size"]))}
    a, b = runs["sync"]["exp"], runs["async"]["exp"]
    ma = {**a.global_vars.params, **a.global_vars.batch_stats}
    mb = {**b.global_vars.params, **b.global_vars.batch_stats}
    unequal = [k for k in ma if not torch.equal(ma[k], mb[k])]
    want, got = (canonical_run_outputs(e.folder) for e in (a, b))
    got["metrics.jsonl"] = [{k: v for k, v in r.items()
                             if k not in ASYNC_ONLY}
                            for r in got["metrics.jsonl"]]
    differ = sorted(k for k in set(want) | set(got)
                    if want.get(k) != got.get(k))
    rows = _metrics_rows(b.folder, drop=())
    print(json.dumps({
        "model_bitwise_equal": not unequal, "unequal_leaves": unequal[:5],
        "outputs_differ": differ, "merges": len(rows),
        "occupancy": [r["buffer_occupancy"] for r in rows],
        "staleness_max": max(r["staleness_max"] for r in rows),
        **{f"{m}_{k}": r[k] for m, r in runs.items()
           for k in ("s", "launches", "steps")}}), flush=True)
    return 0


def _watch_async(record: dict):
    """Wrap the async driver's run (its wall seconds and the driver, for
    stats()), its merge (device-synced seconds), the engine's train_fn (the
    local steps each dispatched wave runs: those where any client has a
    sample) and save_model (device-synced seconds, and the model_last
    sidecar's bytes after it); returns the undo function."""
    import numpy as np
    import torch
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch.fl import async_rounds, rounds
    from dba_mod_tpu_torch.fl.experiment import Experiment
    real = {"run": async_rounds.AsyncDriver.run,
            "merge": async_rounds.AsyncDriver._merge,
            "train": rounds.RoundEngine.train_fn,
            "save": Experiment.save_model}

    def run(self, *args, **kw):
        record["driver"] = self
        t = time.perf_counter()
        try:
            return real["run"](self, *args, **kw)
        finally:
            torch.cuda.synchronize()
            record["run_s"] = time.perf_counter() - t

    def merge(self, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real["merge"](self, *args, **kw)
        torch.cuda.synchronize()
        record.setdefault("merge_s", []).append(time.perf_counter() - t)
        return res

    def train(self, global_vars, tasks_seq, idx_seq, mask_seq, *args,
              **kw):
        record.setdefault("wave_steps", []).append(
            int(np.asarray(mask_seq).any(axis=(1, 4)).sum()))
        return real["train"](self, global_vars, tasks_seq, idx_seq,
                             mask_seq, *args, **kw)

    def save(self, epoch, extra_aux=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real["save"](self, epoch, extra_aux=extra_aux)
        record.setdefault("save_s", []).append(time.perf_counter() - t)
        side = self.folder / ("model_last.pt.tar" + ckpt.AUX_SUFFIX)
        record.setdefault("sidecar_bytes", []).append(side.stat().st_size)

    async_rounds.AsyncDriver.run = run
    async_rounds.AsyncDriver._merge = merge
    rounds.RoundEngine.train_fn = train
    Experiment.save_model = save

    def undo():
        async_rounds.AsyncDriver.run = real["run"]
        async_rounds.AsyncDriver._merge = real["merge"]
        rounds.RoundEngine.train_fn = real["train"]
        Experiment.save_model = real["save"]
    return undo


def run_async_cifar(tmp: Path) -> dict:
    """Phase 10b: the full-width CIFAR buffered-async path through the CLI,
    resumed from phase 4's pretrain (no streaming sidecar: a model-only
    resume, so the stream starts at version = the pretrain's epoch and
    wave = version·K // C), four merges, poisoning on every wave epoch it
    reaches."""
    import torch
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.main import main as cli_main
    from dba_mod_tpu_torch.models import build_model
    from dba_mod_tpu_torch.ops import fused_update as fu

    pre_epoch = int(torch.load(tmp / "ckpt" / "cifar_pretrain" / "smoke" /
                               ckpt.STATE_FILE, weights_only=True)["epoch"])
    raw = yaml.safe_load((tmp / "cifar_smoke.yaml").read_text())
    K, C = 5, int(raw["no_models"])
    first_wave_epoch = pre_epoch * K // C + 1
    poison = list(range(first_wave_epoch, first_wave_epoch + 4))
    # bench.py's --async knobs
    raw.update(mode="async", buffer_k=K, staleness_weighting="polynomial",
               staleness_alpha=0.5, arrival_rate=2.0, arrival_jitter=0.5,
               straggler_tail=0.1, straggler_factor=5.0,
               async_steps=pre_epoch + 4, save_model=True, save_on_epochs=[],
               run_dir=str(tmp / "runs_async"),
               **{"0_poison_epochs": poison, "1_poison_epochs": poison})
    cfg_path = tmp / "cifar_async.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    rec: dict = {}
    phases: dict = {}
    undo_phases = _watch_phases(phases)
    undo = _watch_async(rec)
    fu.fused_step_update.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        if cli_main(["train", "--params", str(cfg_path), "--resume",
                     "cifar_pretrain/smoke"]) != 0:
            raise AssertionError("async CIFAR train failed")
        torch.cuda.synchronize()
    finally:
        undo()
        undo_phases()
    cli_s = time.perf_counter() - t0
    launches = fu.fused_step_update.launches
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    (folder,) = list((tmp / "runs_async").iterdir())
    rows = _metrics_rows(folder, drop=())
    want = list(range(pre_epoch + 1, pre_epoch + 5))
    if [r["epoch"] for r in rows] != want:
        raise AssertionError(f"async merges recorded "
                             f"{[r['epoch'] for r in rows]}, expected {want}")
    steps = sum(rec["wave_steps"])
    waves = rows[-1]["waves_dispatched"] - (pre_epoch * K // C)
    if launches != steps or launches == 0 or len(rec["wave_steps"]) != waves:
        raise AssertionError(f"fused kernel launched {launches} times; the "
                             f"{waves} dispatched waves ran "
                             f"{rec['wave_steps']} local steps")
    adv = {a for r in rows for a in r["adversaries"]}
    for r in rows:
        if r["mode"] != "async" or not 0 < r["buffer_occupancy"] <= K:
            raise AssertionError(f"bad async row {r}")
        for k in ("global_acc", "backdoor_acc"):
            if not math.isfinite(float(r[k])):
                raise AssertionError(f"non-finite {k} in {r}")
    if not adv:
        raise AssertionError("no merge held a poisoned update")
    ok, why = ckpt.verify_checkpoint(folder / "model_last.pt.tar")
    aux = ckpt.load_aux_state(folder / "model_last.pt.tar")
    if not ok or aux is None or aux.get("async_state") is None:
        raise AssertionError(f"model_last not verified ({why}) or its "
                             f"sidecar holds no async_state")
    like = build_model(Params.from_yaml(cfg_path)).init_vars(
        0, torch.device("cpu"))
    gv, _, _ = ckpt.load_checkpoint(folder / "model_last.pt.tar", like)
    if not all(torch.isfinite(v).all() for v in gv.params.values()):
        raise AssertionError("non-finite global weights after the merges")
    # as in phase 4, a x100 update can drive a BN running variance below
    # zero, and the eval loss (and the argmax) of that model is then NaN
    min_var = min((float(v.min()) for k, v in gv.batch_stats.items()
                   if k.endswith("running_var")), default=float("nan"))
    stats = rec["driver"].stats()
    absorbed = sum(r["buffer_occupancy"] for r in rows)
    per_merge = [{k: r[k] for k in ("epoch", "round_time", "dispatch_time",
                                    "buffer_occupancy", "staleness_mean",
                                    "staleness_max", "adversaries")}
                 for r in rows]
    out = {"merges": per_merge, "waves_dispatched": waves,
           "wave_steps": rec["wave_steps"], "launches": launches,
           "outstanding_waves_highwater":
               stats["outstanding_waves_highwater"],
           "merge_s": [round(x, 4) for x in rec["merge_s"]],
           "phase_s": {k: [round(x, 4) for x in v]
                       for k, v in phases.items()},
           "save_s": [round(x, 4) for x in rec["save_s"]],
           "sidecar_bytes": rec["sidecar_bytes"],
           "model_bytes": (folder / "model_last.pt.tar" /
                           ckpt.STATE_FILE).stat().st_size,
           "peak_mb": peak_mb, "run_s": rec["run_s"], "cli_s": cli_s,
           "updates_absorbed": absorbed,
           "updates_per_s": absorbed / rec["run_s"],
           "global_acc": [r["global_acc"] for r in rows],
           "backdoor_acc": [r["backdoor_acc"] for r in rows],
           "global_loss": [r["global_loss"] if math.isfinite(
               float(r["global_loss"])) else str(r["global_loss"])
               for r in rows],
           "min_running_var": min_var}
    log(f"phase 10b: CIFAR async (K={K}, polynomial 0.5, bench.py's "
        f"arrival knobs), 4 merges after a model-only resume at version "
        f"{pre_epoch}: per merge (round_time s, dispatch_time s, occupancy, "
        f"staleness mean/max, adversaries) "
        + "; ".join(f"{m['round_time']:.3f}, {m['dispatch_time']:.3f}, "
                    f"{m['buffer_occupancy']}, {m['staleness_mean']:.2f}/"
                    f"{m['staleness_max']:.0f}, {m['adversaries']}"
                    for m in per_merge)
        + f"; {waves} waves dispatched (local steps {rec['wave_steps']}), "
        f"outstanding-waves high-water {out['outstanding_waves_highwater']}"
        f"; {launches} fused launches = {steps} local steps; merge "
        f"{out['merge_s']} s; engine phases {out['phase_s']}; save_model "
        f"{out['save_s']} s with a model_last sidecar of "
        f"{rec['sidecar_bytes']} B beside a {out['model_bytes']} B model; "
        f"peak {peak_mb:.0f} MB; {absorbed} updates in {rec['run_s']:.1f} s "
        f"= {out['updates_per_s']:.3f} updates/s; clean acc "
        f"{out['global_acc']}, backdoor {out['backdoor_acc']}, global "
        f"loss {out['global_loss']}, min BN running var {min_var:.4g}")
    return out


def run_async_kill_resume(tmp: Path) -> dict:
    """Phase 10c: the MNIST async run at configs/async_smoke_params.yaml's
    knobs (12 merges instead of 8, so the kill has room to land), under
    deterministic kernels, straight and SIGKILLed once merge 3's checkpoint
    is committed, then ``--resume auto``; the two final models are bitwise
    equal, and so are their metrics rows (less clocks) and train CSVs."""
    import signal
    import torch
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch import crash_smoke
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.models import build_model

    base = dict(yaml.safe_load(
        (REPO / "configs" / "async_smoke_params.yaml").read_text()),
        async_steps=12)
    args = ["--deterministic"]
    runs = {}
    for name in ("straight", "killed"):
        raw = dict(base, run_dir=str(tmp / f"runs_async_{name}"))
        cfg_path = tmp / f"async_{name}.yaml"
        cfg_path.write_text(yaml.safe_dump(raw))
        log_file = tmp / f"runs_async_{name}.crash_smoke.log"
        t0 = time.perf_counter()
        if name == "straight":
            run_dir = Path(raw["run_dir"])
            run_dir.mkdir()
            proc = crash_smoke.launch(cfg_path, "cuda", args, log_file)
            try:
                rc = proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise
            if rc != 0:
                raise AssertionError(f"straight async run exited {rc}:\n"
                                     + log_file.read_text()[-4000:])
            (folder,) = crash_smoke.run_folders(run_dir, base["type"])
            info = {}
        else:
            info = crash_smoke.interrupted_run(cfg_path, "cuda", 3, args,
                                               timeout=600,
                                               sig=signal.SIGKILL)
            folder = info.pop("folder")
        runs[name] = dict(info, folder=folder, log=log_file,
                          seconds=time.perf_counter() - t0)
    a, b = runs["straight"], runs["killed"]
    like = build_model(Params.from_dict(base)).init_vars(
        0, torch.device("cpu"))
    ga, ea, _ = ckpt.load_checkpoint(a["folder"] / "model_last.pt.tar", like)
    gb, eb, _ = ckpt.load_checkpoint(b["folder"] / "model_last.pt.tar", like)
    ma, mb = {**ga.params, **ga.batch_stats}, {**gb.params, **gb.batch_stats}
    unequal = [k for k in ma if not torch.equal(ma[k], mb[k])]
    if ea != eb or ea != 12 or unequal:
        raise AssertionError(f"killed-and-resumed async model differs from "
                             f"the straight one (steps {ea}/{eb}): "
                             f"{unequal[:5]}")
    ra, rb = _metrics_rows(a["folder"]), _metrics_rows(b["folder"])
    if ra != rb or [r["epoch"] for r in ra] != list(range(1, 13)):
        raise AssertionError("async metrics rows differ after the resume")
    for name in ("train_result.csv", "test_result.csv"):
        if (a["folder"] / name).read_bytes() != \
                (b["folder"] / name).read_bytes():
            raise AssertionError(f"{name} differs after the resume")
    launches = {n: _launches_logged(r["log"]) for n, r in runs.items()}
    log(f"phase 10c: MNIST async (async_smoke knobs, 12 merges, "
        f"deterministic): straight {a['seconds']:.1f}s; SIGKILL once merge "
        f"3 committed ({b['signalled_after_rounds']} merge rows recorded "
        f"then, {b['stopped_epochs']} on disk after the kill; "
        f"{b['first_run_s']:.1f}s), --resume auto from "
        f"{b['resumed_from']} to {b['epochs'][-1]} "
        f"({b['resume_run_s']:.1f}s); final models bitwise equal, metrics "
        f"rows and train/test CSVs equal; fused launches per process "
        f"{launches}")
    return {"straight_s": a["seconds"],
            "killed": {k: b[k] for k in (
                "signalled_after_rounds", "stopped_epochs", "resumed_from",
                "epochs", "first_run_s", "resume_run_s")},
            "launches": launches}


def run_async(tmp: Path) -> dict:
    """Phase 10: the buffered-async engine (10a in a fresh process, 10b,
    10c)."""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                          "async-keystone", str(tmp)], capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"async keystone failed:\n{out.stdout[-4000:]}"
                             f"\n{out.stderr[-4000:]}")
    ks = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"phase 10a: MNIST poisoned smoke run with the local battery, "
        f"async at buffer_k = no_models against sync, deterministic "
        f"kernels: model bitwise equal {ks['model_bitwise_equal']}, "
        f"outputs differing {ks['outputs_differ']}; {ks['merges']} merges "
        f"of occupancy {ks['occupancy']}, staleness max "
        f"{ks['staleness_max']}; fused launches sync {ks['sync_launches']} "
        f"/ async {ks['async_launches']} = local steps {ks['sync_steps']} / "
        f"{ks['async_steps']}; {ks['sync_s']:.1f} / {ks['async_s']:.1f} s")
    if (not ks["model_bitwise_equal"] or ks["outputs_differ"]
            or ks["sync_launches"] != ks["sync_steps"]
            or ks["async_launches"] != ks["async_steps"]
            or ks["sync_launches"] != ks["async_launches"]
            or ks["sync_launches"] == 0):
        raise AssertionError(f"async keystone on the card: {ks}")
    cifar = run_async_cifar(tmp)
    kill = run_async_kill_resume(tmp)
    return {"keystone": ks, "cifar": cifar, "kill_resume": kill,
            "launches": cifar["launches"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dba_mod_tpu_torch.ops import fused_update as fu
    from dba_mod_tpu_torch.utils import cuda_build
    from dba_mod_tpu_torch.utils.device import (pin_float32_math,
                                                resolve_device)

    dev = resolve_device("cuda")
    pin_float32_math()
    card = card_line()
    log(f"phase 1: card: {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    fu._load()
    log(f"phase 2: built {sorted(cuda_build.build_seconds) or 'nothing'} "
        f"(nvcc seconds {cuda_build.build_seconds}); load total "
        f"{time.perf_counter() - t0:.2f}s")

    kernels = (check_fused_update(dev)
               + check_fused_update(dev, "tiny_params.yaml", "tiny")
               + check_fused_update(dev, "loan_params.yaml", "loan",
                                   fg_cases=(False,)))
    torch.cuda.empty_cache()
    for k in kernels:
        log(f"phase 3: {k['name']} kernel {k['ms']:.4f} ms (profiler "
            f"{k['kernel_profiler_ms']}), bound {k['bound_ms']:.4f} ms "
            f"({k['bytes'] / 1e6:.1f} MB), {k['launches_per_step']} launch "
            f"per step; wrapper {k['wrapper_ms']:.4f} ms per call, of which "
            f"host {k['wrapper_host_ms']:.4f} ms; plain {k['plain_ms']:.4f} "
            f"ms (device {k['plain_device_ms']}); library "
            f"{k['library_ms']:.4f} ms (device {k['library_device_ms']})")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        tmp = Path(td)
        path = run_main_path(tmp)
        kernels[0]["launches"] = path["launches"]
        robust = run_robust_rounds(tmp)
        kernels[1]["launches"] = robust["foolsgold"]["launches"]
        rules = time_aggregation_rules(dev)
        small = check_small_reference(tmp)
        fault = check_fault_round(tmp)
        tiny = run_tiny_path(tmp)
        kernels[2]["launches"] = tiny["fedavg"]["launches"]
        kernels[3]["launches"] = tiny["foolsgold"]["launches"]
        loan = run_loan_path(tmp)
        kernels[4]["launches"] = loan["launches"]
        bf16 = run_bf16(tmp, path)
        crash = run_crash_resume(tmp)
        asyn = run_async(tmp)
        kernels[0]["launches"] = path["launches"] + asyn["launches"]

    for k in kernels:
        del k["bytes"]
    print(json.dumps({"main_path": path, "robust_rounds": robust,
                      "aggregate_ms": rules, "small_reference": small,
                      "fault_round": fault, "tiny_path": tiny,
                      "loan_path": loan, "bf16": bf16,
                      "crash_resume": crash, "async": asyn}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["bf16-rounds"]:     # phase 8's fresh process
        sys.path.insert(0, str(REPO))
        sys.exit(bf16_rounds(Path(sys.argv[2])))
    if sys.argv[1:2] == ["async-keystone"]:  # phase 10a's fresh process
        sys.path.insert(0, str(REPO))
        sys.exit(async_keystone(Path(sys.argv[2])))
    sys.exit(main())
