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
   batch 64, 4 adversaries, synthetic CIFAR at its full size, written once
   as CIFAR batches that every CIFAR run of the script reads), then resume
   it by name and train two FedAvg rounds that both poison. The kernel's
   launch count over that run must equal the local steps it ran (derived
   from the recorded train_result.csv); the recorder files must exist and
   the accuracies and the saved global model must be finite;
4b. the robust server on the same workload: one poisoned round each under
   FoolsGold and RFA through the CLI, resumed from phase 4's pretrained
   model, without the local battery. One fused launch per local step
   (FoolsGold's accumulators ride in it), finite weight_result.csv rows,
   FoolsGold leaves the global BN
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
   100,000 / 10,000 size, made once — in a process started beside phases
   4-5 — and read back from its npz cache):
   pretrain one round, resume it by name, one poisoned FedAvg round, then
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
   kernels, run uninterrupted and, side by side with it on the card,
   through dba_mod_tpu_torch.crash_smoke's launcher (SIGTERM once round 1
   commits → exit 75 → ``--resume auto``). The two
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
   pretrain, two merges of one poisoned wave: one fused launch per local
   step of every dispatched wave; per merge round_time, dispatch_time,
   occupancy and staleness; waves dispatched, the outstanding-waves
   high-water mark, the sidecar's bytes and save seconds, peak memory and
   updates absorbed per second; (c) an MNIST async run at
   configs/async_smoke_params.yaml's knobs under deterministic kernels,
   straight and, side by side, SIGKILLed once merge 3 committed then
   ``--resume auto``:
   bitwise equal final models, equal metrics rows and CSVs.
11. telemetry and round overlap: (a) phase 4's CIFAR config with
   ``telemetry`` and ``tensorboard``, two poisoned rounds from phase 4's
   pretrain through the CLI: trace.json with every phase span, one
   telemetry.jsonl row a round, the tb/ event file, no kernel library built
   after warm-up, one fused launch per local step, the per-phase span
   seconds beside phase 4's and the summary table; (b) three poisoned
   full-width CIFAR rounds through the CLI in fresh deterministic
   processes, serial and with ``overlap_eval`` + ``pipeline_rounds``: every
   recorded output (wall clocks aside) and the final checkpoint
   byte-identical, one fused launch per local step, each run's seconds a
   round and in all, the hidden eval seconds and how many finalizes
   returned while the card still ran the next round; (c) in phase 10a's
   fresh deterministic process, the MNIST async run at async_smoke's knobs,
   serial and with the merge pipeline: bitwise equal, pipelined_merges and
   hidden_finalize_s; (d) ``profile_dir`` on a two-round MNIST run: the
   torch.profiler trace of round 2 exists and holds kernel events.
12. the grouped client layout (``grouped_clients``), ``sequential_debug``
   and the deeper CIFAR ResNets: (a) at full CIFAR width (C = 10, batch 64,
   float32, from phase 4's pretrain) one experiment's poisoned round
   inputs and the same global state through the vmapped and the grouped
   RoundEngine.train_fn: one fused launch per local step of every call,
   the train-phase seconds (device-synced, min of 3) of each layout, a
   torch.profiler table of each layout's first four steps with the share
   of device time in layout transposes (cuDNN's genericTranspose,
   nchwToNhwc, nhwcToNchw) and copy kernels, the deltas' max abs
   difference (params and BN stats) between the layouts and between two
   vmapped calls, and one train-mode forward of the round's first batch
   through both layouts within 5e-5 (logits and new BN stats); (b) the same at Tiny-ImageNet width on phase 6's set
   and pretrain, over the round's first 16 steps; (c) one poisoned CIFAR
   round with ``grouped_clients: true`` through the CLI from phase 4's
   pretrain, without the local battery: finite accuracies, one fused
   launch per local step, round_time and train seconds beside phase 4's;
   (d) one poisoned MNIST round with ``sequential_debug`` against the
   stacked round on the card: global within 2e-3, accuracy within 0.5, one
   fused launch per step of every width-1 call; (e) one train-mode forward
   of each deeper CIFAR ResNet (34/50/101/152) at batch 8, card against
   CPU, logits and running stats within 2e-3.
13. the clients mesh, multi-process worlds and the elastic layer: (a) in
   a fresh process under deterministic kernels, phase 4's config from its
   pretrain: one poisoned round without the local battery through a
   2-shard mesh on [cuda:0, cuda:0] (its fused launches are its shards'
   local steps, round_time beside phase 4's); the round's training run
   through the unsharded engine one shard's slice at a time, joined in
   client order and held bitwise to the mesh's gathered stack; the same
   round through an unsharded experiment that aggregates those slices'
   results, its new global model held bitwise to the mesh's; one
   train-mode forward of the round's first batch as one stack and as two
   shards, and one local step per client through both engines at full
   width, each within 5e-5 (one fused launch a step, two on the mesh);
   (b) a 2-rank world on the
   one card (gloo) as two ``main train`` processes with torchrun's
   environment, one poisoned round of phase 4's config without the local
   battery from its pretrain: bitwise-equal rank models (each rank's
   logged digest), rank 0 alone writes the run folder, round_time and the
   all-gather seconds, each rank's fused launches; (c) the elastic drill
   at MNIST size under deterministic kernels: a 2-rank world with
   heartbeats, rank 1 SIGKILLed once two rounds are committed, the
   survivor exits 77 within watchdog_hard_s plus 10 s, one process
   relaunched with ``--resume auto`` finishes in the same folder with
   every round once, and the rows through the resume point equal an
   uninterrupted 2-rank world's, run beside it.

Phase 3 also runs (as 3b) at the Tiny-ImageNet size (FoolsGold off and on)
and at the LOAN size, so the kernels line has five rows. The CIFAR row's
launches are phase 4's plus phase 10b's, 11a's, both 11b runs', the
grouped ones of 12a and 12c, 13a's mesh round and both 13b ranks'; the Tiny
row's are phase 6's plus 12b's grouped
ones. The script prints its own total seconds.

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


def write_cifar_batches(raw: dict, root: Path) -> float:
    """The synthetic CIFAR set that `raw` with ``synthetic_data: true``
    makes, written once as the reference's python-pickle batches under
    root/cifar-10-batches-py, which load_cifar10 reads back as the same
    arrays: the script's CIFAR runs load it instead of drawing it anew.
    Returns the seconds it took."""
    import pickle
    import numpy as np
    from dba_mod_tpu_torch.data.datasets import synthetic_image_dataset

    t0 = time.perf_counter()
    d = synthetic_image_dataset(
        "cifar", train_size=int(raw.get("synthetic_train_size", 0) or 0),
        test_size=int(raw.get("synthetic_test_size", 0) or 0),
        seed=int(raw.get("random_seed", 1)),
        noise_std=float(raw.get("synthetic_noise_std", 25.0)))
    out = root / "cifar-10-batches-py"
    out.mkdir(parents=True)

    def dump(name, x, y):
        with open(out / name, "wb") as f:
            pickle.dump({b"data": x.transpose(0, 3, 1, 2).reshape(len(x), -1),
                         b"labels": y.tolist()}, f)

    for i, rows in enumerate(np.array_split(np.arange(len(d.train_labels)),
                                            5)):
        dump(f"data_batch_{i + 1}", d.train_images[rows], d.train_labels[rows])
    dump("test_batch", d.test_images, d.test_labels)
    return time.perf_counter() - t0


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
    # the synthetic set at its full size, written once as CIFAR batches
    # that every CIFAR config of this script (derived from this one) reads
    data_s = write_cifar_batches(raw, tmp / "cifar_data")
    raw.update(synthetic_data=False, data_dir=str(tmp / "cifar_data"),
               run_dir=str(tmp / "runs"),
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
    log(f"phase 4: synthetic CIFAR set written as CIFAR batches in "
        f"{data_s:.1f}s; pretrain {pretrain_s:.1f}s; resumed train of 2 "
        f"poisoned "
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
    """One poisoned full-width CIFAR round under FoolsGold and one under
    RFA through the CLI, resumed from phase 4's pretrained model, with
    phase 4's config changed only in aggregation_methods, the run folder
    and no local battery (phase 4 runs it; it is half a round). Each
    round's server aggregate carries the process's first use of the rule's
    kernels (phase 4c times the steady state)."""
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
        raw = dict(base, aggregation_methods=rule, local_eval=False,
                   run_dir=str(tmp / f"runs_{rule}"))
        cfg_path = tmp / f"cifar_{rule}.yaml"
        cfg_path.write_text(yaml.safe_dump(raw))
        aggs: list = []
        undo = _watch_aggregate(aggs)
        fu.fused_step_update.launches = 0
        try:
            if cli_main(["train", "--params", str(cfg_path), "--resume",
                         "cifar_pretrain/smoke", "--epochs", "2"]) != 0:
                raise AssertionError(f"{rule} round failed")
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
        if len(rows) != 3 or not all(math.isfinite(x) for r in weights
                                     for x in r):
            raise AssertionError(f"{rule}: weight_result rows {rows}")
        recs = [json.loads(l) for l in (folder / "metrics.jsonl")
                .read_text().splitlines() if l.strip()]
        if [r["epoch"] for r in recs] != [2] or not all(
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
        log(f"phase 4b: {rule}, 1 poisoned CIFAR round: round_time "
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
    battery) so each call adds its device-synced seconds to record[name],
    and to record[name + "_tail"] the seconds the card still ran after the
    call returned (how far the host ran ahead of the card); returns the
    undo function. The syncs add a few host waits a round."""
    import torch
    from dba_mod_tpu_torch.fl import rounds
    names = ("train_fn", "aggregate_fn", "local_evals", "global_evals")
    real = {n: getattr(rounds.RoundEngine, n) for n in names}

    def timed(name):
        def call(self, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = real[name](self, *args, **kw)
            t_host = time.perf_counter()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            record.setdefault(name, []).append(t_end - t)
            record.setdefault(f"{name}_tail", []).append(t_end - t_host)
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


def write_tiny_data(tmp: Path) -> int:
    """Phase 6's data, in the process main() starts beside phases 4-5 (it
    is host work): the synthetic Tiny-ImageNet set of the full 100,000 /
    10,000 size, made once with the port's generator and written as the
    tiny-imagenet-200.npz cache that load_tiny_imagenet reads, so the CLI
    runs load it instead of drawing 1.2 G normal values each. Prints one
    JSON line: the set's sizes and seconds."""
    import numpy as np
    import yaml
    from dba_mod_tpu_torch.data.datasets import synthetic_image_dataset

    raw = yaml.safe_load((REPO / "configs" / "tiny_params.yaml").read_text())
    t0 = time.perf_counter()
    data = synthetic_image_dataset("tiny-imagenet-200",
                                   seed=int(raw["random_seed"]))
    (tmp / "tiny_data").mkdir()
    np.savez(tmp / "tiny_data" / "tiny-imagenet-200.npz",
             train_x=data.train_images, train_y=data.train_labels,
             test_x=data.test_images, test_y=data.test_labels)
    print(json.dumps({"n_train": len(data.train_labels),
                      "n_test": len(data.test_labels),
                      "s": time.perf_counter() - t0}), flush=True)
    return 0


def start_tiny_data(tmp: Path) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"),
                             "tiny-data", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def run_tiny_path(tmp: Path, data_proc: subprocess.Popen) -> dict:
    """The Tiny-ImageNet main path at full width: configs/tiny_params.yaml
    (full 64-base ResNet-18, 100 participants, 10 per round, batch 64,
    Dirichlet 0.01, 4 adversaries) on the synthetic set of the full
    100,000 / 10,000 size that `data_proc` (write_tiny_data) writes.
    Pretrain one round, resume it by name, one poisoned FedAvg round, then
    one poisoned FoolsGold round from the same pretrain."""
    import torch
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.main import main as cli_main
    from dba_mod_tpu_torch.models import build_model

    raw = yaml.safe_load((REPO / "configs" / "tiny_params.yaml").read_text())
    t0 = time.perf_counter()
    out, err = data_proc.communicate(timeout=900)
    if data_proc.returncode != 0:
        raise AssertionError(f"synthetic Tiny set failed:\n{err[-4000:]}")
    made = json.loads(out.strip().splitlines()[-1])
    n_train, n_test, data_s = made["n_train"], made["n_test"], made["s"]
    log(f"phase 6: waited {time.perf_counter() - t0:.1f}s for the "
        f"synthetic Tiny set, made beside phases 3-5 in {data_s:.1f}s")
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
    fedavg = _train_rounds(cfg_path, "tiny_pretrain/smoke", 2,
                           tmp / "runs_tiny", b, [2], "tiny FedAvg")
    like = build_model(Params.from_dict(raw)).init_vars(
        0, torch.device("cpu"))
    gv, epoch, _ = ckpt.load_checkpoint(fedavg["folder"] / "model_last.pt.tar",
                                        like)
    ok, why = ckpt.verify_checkpoint(fedavg["folder"] / "model_last.pt.tar")
    if not ok or epoch != 2 or not all(
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


def _beside(cfg_path: Path, args: list, log_file: Path, timeout: float,
            work):
    """Run `main train` on `cfg_path` (an uninterrupted twin) in a process
    beside `work()` (the interrupted run it is held against): returns
    work()'s result and the twin's wall seconds. The twin is killed if
    anything fails."""
    import threading
    from dba_mod_tpu_torch import crash_smoke
    t0 = time.perf_counter()
    proc = crash_smoke.launch(cfg_path, "cuda", args, log_file)
    ended: list = []
    waiter = threading.Thread(
        target=lambda: (proc.wait(), ended.append(time.perf_counter())),
        daemon=True)
    waiter.start()
    try:
        out = work()
        waiter.join(timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if not ended or proc.returncode != 0:
        raise AssertionError(f"uninterrupted run exited {proc.returncode}:"
                             f"\n" + log_file.read_text()[-4000:])
    return out, ended[0] - t0


def run_crash_resume(tmp: Path) -> dict:
    """Phase 9 (see the module docstring); the uninterrupted run goes
    beside the interrupted one."""
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
    cfgs, logs = {}, {}
    for name in ("straight", "resumed"):
        cfgs[name] = tmp / f"cifar_crash_{name}.yaml"
        cfgs[name].write_text(yaml.safe_dump(
            dict(base, run_dir=str(tmp / f"runs_crash_{name}"))))
        logs[name] = tmp / f"runs_crash_{name}.crash_smoke.log"
    run_dir = tmp / "runs_crash_straight"
    run_dir.mkdir()
    t0 = time.perf_counter()
    info, straight_s = _beside(
        cfgs["straight"], args, logs["straight"], 900,
        lambda: crash_smoke.interrupted_run(cfgs["resumed"], "cuda", 1,
                                            args, timeout=900))
    resumed_s = time.perf_counter() - t0
    resumed_folder = info.pop("folder")
    (straight_folder,) = crash_smoke.run_folders(run_dir, base["type"])
    runs = {"straight": {"folder": straight_folder, "log": logs["straight"],
                         "seconds": straight_s},
            "resumed": dict(info, folder=resumed_folder,
                            log=logs["resumed"], seconds=resumed_s)}
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
        f"rounds: uninterrupted {a['seconds']:.1f}s beside the interrupted "
        f"run (round_time {round_s}); "
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
        "phase": "10a",
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
    wave = version·K // C), two merges (one wave), poisoning on every wave
    epoch it reaches."""
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
               async_steps=pre_epoch + 2, save_model=True, save_on_epochs=[],
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
    want = list(range(pre_epoch + 1, pre_epoch + 3))
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
        f"arrival knobs), 2 merges after a model-only resume at version "
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
    cfgs, logs = {}, {}
    for name in ("straight", "killed"):
        cfgs[name] = tmp / f"async_{name}.yaml"
        cfgs[name].write_text(yaml.safe_dump(
            dict(base, run_dir=str(tmp / f"runs_async_{name}"))))
        logs[name] = tmp / f"runs_async_{name}.crash_smoke.log"
    run_dir = tmp / "runs_async_straight"
    run_dir.mkdir()
    info, straight_s = _beside(
        cfgs["straight"], args, logs["straight"], 600,
        lambda: crash_smoke.interrupted_run(cfgs["killed"], "cuda", 3, args,
                                            timeout=600,
                                            sig=signal.SIGKILL))
    killed_folder = info.pop("folder")
    (straight_folder,) = crash_smoke.run_folders(run_dir, base["type"])
    runs = {"straight": {"folder": straight_folder, "log": logs["straight"],
                         "seconds": straight_s},
            "killed": dict(info, folder=killed_folder, log=logs["killed"])}
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
        f"deterministic): straight {a['seconds']:.1f}s beside the killed "
        f"run; SIGKILL once merge "
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


def _json_lines(stdout: str) -> dict:
    """The JSON result lines of a fresh-process phase, by their "phase"."""
    out = {}
    for line in stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            out[row.get("phase")] = row
    return out


def run_async(tmp: Path) -> dict:
    """Phase 10: the buffered-async engine (10a in a fresh process, which
    then runs phase 11c too; 10b, 10c)."""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                          "deterministic-mnist", str(tmp)],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"async keystone / 11c failed:\n"
                             f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    results = _json_lines(out.stdout)
    ks = results["10a"]
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
            "launches": cifar["launches"], "11c": results["11c"]}


# --------------------------------------------------------------- phase 11
TEL_SPANS = ("round/dispatch", "round/train", "round/aggregate", "eval/local",
             "eval/global", "round/finalize", "round/checkpoint")


def run_telemetry_cifar(tmp: Path, f32: dict) -> dict:
    """Phase 11a: phase 4's CIFAR config with telemetry and tensorboard,
    resumed from phase 4's pretrain, two poisoned FedAvg rounds through the
    CLI (in this process): the trace, one telemetry.jsonl row a round and
    the TensorBoard events exist, every phase span is there, no kernel
    library was built after warm-up, one fused launch per local step. The
    per-phase span seconds print beside phase 4's (device-synced
    _watch_phases) numbers."""
    import torch
    import yaml
    from dba_mod_tpu_torch.main import main as cli_main
    from dba_mod_tpu_torch.ops import fused_update as fu

    raw = dict(yaml.safe_load((tmp / "cifar_smoke.yaml").read_text()),
               telemetry=True, tensorboard=True,
               run_dir=str(tmp / "runs_tel"))
    cfg_path = tmp / "cifar_telemetry.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    fu.fused_step_update.launches = 0
    t0 = time.perf_counter()
    if cli_main(["train", "--params", str(cfg_path), "--resume",
                 "cifar_pretrain/smoke", "--epochs", "3"]) != 0:
        raise AssertionError("telemetry rounds failed")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fu.fused_step_update.launches
    (folder,) = list((tmp / "runs_tel").iterdir())
    steps = expected_launches(folder / "train_result.csv",
                              int(raw["batch_size"]))
    if launches != steps or launches == 0:
        raise AssertionError(f"11a: fused kernel launched {launches} times, "
                             f"the rounds ran {steps} local steps")
    trace = json.loads((folder / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    missing = sorted(set(TEL_SPANS + ("engine/build", "engine/warm_buckets"))
                     - names)
    rows = [json.loads(l) for l in
            (folder / "telemetry.jsonl").read_text().splitlines() if l]
    events = list((folder / "tb").glob("events.out.tfevents.*"))
    late = rows[-1]["counters"].get("cuda/kernel_builds_after_warmup")
    if missing or [r["epoch"] for r in rows] != [2, 3] or late != 0 \
            or not events:
        raise AssertionError(f"11a: spans missing {missing}, telemetry rows "
                             f"{[r['epoch'] for r in rows]}, kernel builds "
                             f"after warm-up {late}, tb events {events}")
    spans = {n: [round(r["histograms"].get(f"span/{n}", {}).get("sum", 0.0),
                       4) for r in rows] for n in TEL_SPANS}
    mem = rows[-1]["gauges"]
    with open(folder / "round_result.csv", newline="") as f:
        round_s = [float(r["round_time"]) for r in csv.DictReader(f)]
    out = {"run_s": run_s, "launches": launches, "round_s": round_s,
           "span_s": spans, "peak_mb": mem.get("memory/peak_bytes_in_use",
                                                0) / 1e6,
           "kernel_builds": rows[-1]["counters"].get("cuda/kernel_builds"),
           "tb_event_bytes": sum(p.stat().st_size for p in events)}
    log(f"phase 11a: CIFAR, 2 poisoned rounds with telemetry + tensorboard "
        f"in {run_s:.1f}s: round_time {round_s}; span seconds per round "
        f"{spans} (phase 4, device-synced: {f32['phase_s']}); "
        f"{launches} fused launches = {steps} local steps; kernel builds "
        f"{out['kernel_builds']}, after warm-up {late}; peak "
        f"{out['peak_mb']:.0f} MB; tb events {out['tb_event_bytes']} B")
    return out


_OVERLAP_LINE = "overlap: "


def _overlap_logged(log_file: Path) -> dict:
    """The overlap clocks a `main train` process logged, as numbers."""
    for line in log_file.read_text().splitlines():
        if _OVERLAP_LINE in line:
            nums = [float(w.rstrip(",")) for w in
                    line.split(_OVERLAP_LINE, 1)[1].split()
                    if w.rstrip(",").replace(".", "", 1).isdigit()]
            return dict(zip(("rounds", "hidden_eval_s", "eval_wait_s",
                             "finalized_ahead"), nums))
    return {}


def run_overlap_cifar(tmp: Path) -> dict:
    """Phase 11b: three poisoned FedAvg rounds at full CIFAR width from
    phase 4's pretrain through the CLI, each run in a fresh process under
    deterministic kernels: serial, then with overlap_eval and
    pipeline_rounds. Every recorded output (wall clocks aside) and the
    final checkpoint must be byte-identical; one fused launch per local
    step in each."""
    import yaml
    from dba_mod_tpu_torch import crash_smoke
    from dba_mod_tpu_torch.utils.recorder import canonical_run_outputs

    base = dict(yaml.safe_load((tmp / "cifar_smoke.yaml").read_text()),
                save_on_epochs=[4],
                **{"0_poison_epochs": [2, 4], "1_poison_epochs": [3]})
    runs = {}
    for name, knobs in (("serial", {}),
                        ("overlap", dict(overlap_eval=True,
                                         pipeline_rounds=True))):
        run_dir = tmp / f"runs_ovl_{name}"
        run_dir.mkdir()
        cfg_path = tmp / f"cifar_overlap_{name}.yaml"
        cfg_path.write_text(yaml.safe_dump(dict(base, run_dir=str(run_dir),
                                                **knobs)))
        log_file = tmp / f"overlap_{name}.log"
        t0 = time.perf_counter()
        proc = crash_smoke.launch(
            cfg_path, "cuda", ["--deterministic", "--resume",
                               "cifar_pretrain/smoke", "--epochs", "4"],
            log_file)
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
        if rc != 0:
            raise AssertionError(f"11b {name} run exited {rc}:\n"
                                 + log_file.read_text()[-4000:])
        (folder,) = list(run_dir.iterdir())
        with open(folder / "round_result.csv", newline="") as f:
            rr = list(csv.DictReader(f))
        runs[name] = {"folder": folder, "s": time.perf_counter() - t0,
                      "round_s": [float(r["round_time"]) for r in rr],
                      "finalize_s": [float(r["finalize_time"]) for r in rr],
                      "launches": sum(_launches_logged(log_file)),
                      "steps": expected_launches(folder / "train_result.csv",
                                                 int(base["batch_size"])),
                      **_overlap_logged(log_file)}
    a, b = runs["serial"], runs["overlap"]
    want, got = (canonical_run_outputs(r["folder"]) for r in (a, b))
    differ = sorted(k for k in set(want) | set(got)
                    if want.get(k) != got.get(k))
    state = [(r["folder"] / "model_last.pt.tar" / "state.pt").read_bytes()
             for r in (a, b)]
    epochs = [json.loads(l)["epoch"] for l in
              (b["folder"] / "metrics.jsonl").read_text().splitlines() if l]
    clocks = ("rounds", "hidden_eval_s", "eval_wait_s", "finalized_ahead")
    for name, r in runs.items():
        log(f"phase 11b: CIFAR {name}, 3 poisoned rounds in a fresh "
            f"deterministic process: {r['s']:.1f}s in all; round_time "
            f"{r['round_s']}, finalize_time {r['finalize_s']}; "
            f"{r['launches']} fused launches = {r['steps']} local steps; "
            f"overlap clocks {({k: r[k] for k in clocks if k in r})}")
    log(f"phase 11b: serial vs overlapped: outputs differing {differ}, "
        f"final checkpoint byte-identical {state[0] == state[1]}")
    counts = [(r["launches"], r["steps"]) for r in runs.values()]
    if (differ or state[0] != state[1] or epochs != [2, 3, 4]
            or b.get("rounds") != 3
            or any(n != steps or steps == 0 for n, steps in counts)):
        raise AssertionError(f"11b: serial and overlapped CIFAR runs differ "
                             f"({differ}, checkpoint equal "
                             f"{state[0] == state[1]}, epochs {epochs}) or "
                             f"launches against steps {counts}")
    for r in runs.values():
        del r["folder"]
    return {**runs, "launches": a["launches"] + b["launches"]}


def overlap_small(tmp: Path) -> int:
    """Phase 11c, in phase 10a's fresh process (deterministic kernels must
    be chosen before anything runs on the card): the MNIST async run at
    configs/async_smoke_params.yaml's knobs, serial and with overlap_eval
    (the merge pipeline). Prints one JSON line: whether the global models
    are bitwise equal and the recorded outputs equal, the driver's stats,
    and each run's fused launches and wave steps."""
    from dba_mod_tpu_torch.utils.device import use_deterministic_kernels
    use_deterministic_kernels()
    import numpy as np
    import torch
    import yaml
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl import rounds
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.ops import fused_update as fu
    from dba_mod_tpu_torch.utils.recorder import canonical_run_outputs

    raw = yaml.safe_load(
        (REPO / "configs" / "async_smoke_params.yaml").read_text())
    real_train = rounds.RoundEngine.train_fn
    wave_steps: list = []

    def train(self, global_vars, tasks_seq, idx_seq, mask_seq, *a, **kw):
        wave_steps.append(int(np.asarray(mask_seq).any(axis=(1, 4)).sum()))
        return real_train(self, global_vars, tasks_seq, idx_seq, mask_seq,
                          *a, **kw)

    rounds.RoundEngine.train_fn = train
    runs = {}
    for name, knobs in (("serial", {}), ("overlap", {"overlap_eval": True})):
        p = Params.from_dict(dict(raw, run_dir=str(tmp / f"ovl_async_{name}"),
                                  **knobs))
        exp = Experiment(p, save_results=True, device="cuda")
        wave_steps.clear()
        fu.fused_step_update.launches = 0
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        runs[name] = {"exp": exp, "s": time.perf_counter() - t0,
                      "launches": fu.fused_step_update.launches,
                      "steps": sum(wave_steps),
                      "stats": exp.async_driver.stats()}
    a, b = runs["serial"]["exp"], runs["overlap"]["exp"]
    ma = {**a.global_vars.params, **a.global_vars.batch_stats}
    mb = {**b.global_vars.params, **b.global_vars.batch_stats}
    unequal = [k for k in ma if not torch.equal(ma[k], mb[k])]
    want, got = (canonical_run_outputs(e.folder) for e in (a, b))
    differ = sorted(k for k in set(want) | set(got)
                    if want.get(k) != got.get(k))
    print(json.dumps({
        "phase": "11c",
        "model_bitwise_equal": not unequal, "outputs_differ": differ,
        "merges": len(got.get("metrics.jsonl", [])),
        **{f"{m}_{k}": r[k] for m, r in runs.items()
           for k in ("s", "launches", "steps", "stats")}}), flush=True)
    return 0


def run_profile_round(tmp: Path) -> dict:
    """Phase 11d: profile_dir on an MNIST smoke run of two rounds on the
    card: torch.profiler traces the round after warm-up into the folder."""
    import torch
    import yaml
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.ops import fused_update as fu

    raw = dict(yaml.safe_load(
        (REPO / "configs" / "smoke_params.yaml").read_text()), epochs=2,
        profile_dir=str(tmp / "prof"), run_dir=str(tmp / "runs_prof"))
    exp = Experiment(Params.from_dict(raw), save_results=True,
                     device="cuda")
    fu.fused_step_update.launches = 0
    t0 = time.perf_counter()
    exp.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fu.fused_step_update.launches
    steps = expected_launches(exp.folder / "train_result.csv",
                              int(raw["batch_size"]))
    traces = list((tmp / "prof").glob("round_2.pt.trace.json"))
    kernels = (sum(1 for e in json.loads(traces[0].read_text())
                   .get("traceEvents", []) if e.get("cat") == "kernel")
               if traces else 0)
    if not traces or kernels == 0 or launches != steps or launches == 0:
        raise AssertionError(f"11d: traces {traces} with {kernels} kernel "
                             f"events; launches {launches}, steps {steps}")
    out = {"run_s": run_s, "trace_bytes": traces[0].stat().st_size,
           "kernel_events": kernels, "launches": launches}
    log(f"phase 11d: MNIST, 2 rounds with profile_dir in {run_s:.1f}s: "
        f"{traces[0].name} of {out['trace_bytes']} B with {kernels} kernel "
        f"events; {launches} fused launches = {steps} local steps")
    return out


def run_phase11(tmp: Path, f32: dict, small: dict) -> dict:
    """Phase 11: telemetry (a), sync overlap A/B (b), the async merge
    pipeline A/B (c: `small`, the result phase 10a's fresh process
    printed) and profile_dir (d)."""
    t0 = time.perf_counter()
    tel = run_telemetry_cifar(tmp, f32)
    ovl = run_overlap_cifar(tmp)
    log(f"phase 11c: MNIST async (async_smoke knobs) serial vs overlap_eval, "
        f"deterministic: model bitwise equal {small['model_bitwise_equal']}, "
        f"outputs differing {small['outputs_differ']}; {small['merges']} "
        f"merges; pipelined_merges "
        f"{small['overlap_stats']['pipelined_merges']}, hidden_finalize_s "
        f"{small['overlap_stats']['hidden_finalize_s']}; fused launches "
        f"{small['serial_launches']} / {small['overlap_launches']} = wave "
        f"steps {small['serial_steps']} / {small['overlap_steps']}; "
        f"{small['serial_s']:.1f} / {small['overlap_s']:.1f} s")
    if (not small["model_bitwise_equal"] or small["outputs_differ"]
            or small["overlap_stats"]["pipelined_merges"] == 0
            or small["serial_launches"] != small["serial_steps"]
            or small["overlap_launches"] != small["overlap_steps"]
            or small["serial_launches"] == 0):
        raise AssertionError(f"11c: async merge pipeline on the card: "
                             f"{small}")
    prof = run_profile_round(tmp)
    total = time.perf_counter() - t0
    log(f"phase 11: {total:.1f}s")
    return {"telemetry": tel, "overlap": ovl, "async_overlap": small,
            "profile": prof, "seconds": total,
            "launches": tel["launches"] + ovl["launches"]}


# --------------------------------------------------------------- phase 12
LAYOUT_KERNELS = ("genericTranspose", "nchwToNhwc", "nhwcToNchw")


def _first_steps(mask, n: int):
    """The plan with only its first `n` active local steps left active (a
    step is active where any client has a sample): the others' masks are
    cleared, so train_fn skips them on the host."""
    import numpy as np
    out = np.array(mask, copy=True)
    active = out[0].any(axis=(0, 3))                   # [E, S]
    for k, (e, s) in enumerate(zip(*np.nonzero(active))):
        if k >= n:
            out[:, :, e, s, :] = False
    return out


def _device_kernels(fn) -> dict:
    """One call of fn under torch.profiler: its device time by kernel, and
    the shares of the layout transposes (cuDNN's genericTranspose and its
    NCHW <-> NHWC conversions) and of the copy kernels."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ks = sorted(((e.key, e.self_device_time_total)
                 for e in prof.key_averages()
                 if getattr(e, "device_type", None)
                 == torch.autograd.DeviceType.CUDA and
                 e.self_device_time_total > 0), key=lambda kv: -kv[1])
    total = sum(t for _, t in ks)
    tr = sum(t for k, t in ks if any(p in k for p in LAYOUT_KERNELS))
    cp = sum(t for k, t in ks if "copy" in k.lower()
             and not any(p in k for p in LAYOUT_KERNELS))
    return {"device_ms": total / 1e3,
            "transpose_share": tr / total if total else None,
            "copy_share": cp / total if total else None,
            "layout_share": (tr + cp) / total if total else None,
            "top_kernels_us": [(k[:90], round(t, 1)) for k, t in ks[:6]]}


def _max_diffs(a, b) -> dict:
    return {part: max(float((getattr(a, part)[k] - getattr(b, part)[k])
                            .abs().max()) for k in getattr(a, part))
            for part in ("params", "batch_stats")}


def _forward_ab(exp, task, idx) -> dict:
    """The round's first batch (trigger stamped) through the vmapped
    model_def.apply and grouped_train_apply in train mode, from the global
    model stacked over the clients: max abs difference of the logits and
    of the new BN running stats."""
    import torch
    from dba_mod_tpu_torch.models import ModelVars
    from dba_mod_tpu_torch.models.grouped import grouped_train_apply

    md, data, gv = exp.model_def, exp.device_data, exp.global_vars
    task = task.to_device(exp.device)
    C = int(idx.shape[1])
    x, y = data.fetch_train(task.slot,
                            torch.from_numpy(idx[0][:, 0, 0]).to(exp.device))
    x, _, _ = data.stamp(x, y, task.adv_index, task.poisoning_per_batch)
    p, s = ({k: v.expand((C,) + v.shape).contiguous() for k, v in t.items()}
            for t in gv)
    with torch.no_grad():
        lv, sv = torch.func.vmap(lambda pp, ss, xx: md.apply(
            ModelVars(pp, ss), xx, train=True))(p, s, x)
        lg, sg = grouped_train_apply(md, p, s, x)
    return {"logits": float((lv - lg).abs().max()),
            "batch_stats": max(float((sv[k] - sg[k]).abs().max())
                               for k in sv)}


def layout_ab(cfg_path: Path, resume: str, epoch: int, what: str,
              steps: int | None = None, reps: int = 3,
              prof_steps: int = 4) -> dict:
    """The port of benchmarks/grouped_ab.py: one experiment's round inputs
    (`epoch`, a poisoned round; its first `steps` active steps when given)
    and the same global state, resumed from `resume`, through the vmapped
    and the grouped RoundEngine.train_fn. One fused launch per local step
    of each call; the train-phase seconds, device-synced, min of `reps`
    calls; each layout's device time by kernel over its first
    `prof_steps` steps. Numerics: the deltas' max abs difference between
    the layouts and, as its yardstick, between two vmapped calls (cuDNN's
    default algorithms are not deterministic, and BatchNorm's float32
    backward and the ×100 adversary amplify any difference over a round's
    steps); and one train-mode forward of the round's first batch through
    both layouts, logits and new BN stats within 5e-5
    (tests/test_grouped_clients.py's forward bound)."""
    import torch
    import yaml
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.fl.rounds import RoundEngine
    from dba_mod_tpu_torch.ops import fused_update as fu

    raw = dict(yaml.safe_load(cfg_path.read_text()), resumed_model=True,
               resumed_model_name=resume)
    t0 = time.perf_counter()
    exp = Experiment(Params.from_dict(raw), save_results=False,
                     device="cuda")
    engines = {"vmapped": exp.engine,
               "grouped": RoundEngine(
                   Params.from_dict(dict(raw, grouped_clients=True)),
                   exp.model_def, exp.device_data, exp.eval_plans)}
    if not engines["grouped"].use_grouped or exp.engine.use_grouped:
        raise AssertionError(f"{what}: engines not built as asked")
    tasks, idx, mask, _ = exp.build_static_round_inputs(epoch)
    if not tasks[0].poisoning_per_batch.any():
        raise AssertionError(f"{what}: round {epoch} does not poison")
    if steps is not None:
        mask = _first_steps(mask, steps)
    n_steps = int(mask[0].any(axis=(0, 3)).sum())
    gv = exp.global_vars
    setup_s = time.perf_counter() - t0
    out, deltas = {"setup_s": setup_s, "steps": n_steps}, {}
    for name, eng in engines.items():
        secs, launches = [], []
        for rep in range(reps):
            torch.cuda.synchronize()
            fu.fused_step_update.launches = 0
            t = time.perf_counter()
            train = eng.train_fn(gv, tasks, idx, mask)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            launches.append(fu.fused_step_update.launches)
            if rep < 2:
                deltas[name, rep] = train.deltas
            del train
        if any(n != n_steps for n in launches):
            raise AssertionError(f"{what} {name}: fused launches {launches} "
                                 f"per call, {n_steps} local steps")
        prof = _device_kernels(lambda: eng.train_fn(
            gv, tasks, idx, _first_steps(mask, prof_steps)))
        out[name] = {"train_s": min(secs), "train_s_all": secs,
                     "ms_per_step": 1e3 * min(secs) / n_steps,
                     "launches": launches[0], **prof}
    v = deltas["vmapped", 0]
    if not all(bool(torch.isfinite(t).all()) for d in deltas.values()
               for t in list(d.params.values())
               + list(d.batch_stats.values())):
        raise AssertionError(f"{what}: non-finite deltas")
    out["layouts"] = _max_diffs(v, deltas["grouped", 0])
    out["vmapped_run_to_run"] = _max_diffs(v, deltas["vmapped", 1])
    out["size"] = {part: max(float(t.abs().max())
                             for t in getattr(v, part).values())
                   for part in ("params", "batch_stats")}
    del deltas, v
    out["forward"] = _forward_ab(exp, tasks[0], idx)
    for name in engines:
        r = out[name]
        log(f"phase 12 {what} {name}: train {r['train_s']:.3f}s (min of "
            f"{reps}: {[round(s, 3) for s in r['train_s_all']]}) for "
            f"{n_steps} steps, {r['ms_per_step']:.2f} ms a step; "
            f"{r['launches']} fused launches = {n_steps} local steps; "
            f"profiled {prof_steps} steps: device {r['device_ms']:.2f} ms, "
            f"transposes {r['transpose_share']:.4f}, copies "
            f"{r['copy_share']:.4f}, both {r['layout_share']:.4f}; top "
            f"{r['top_kernels_us']}")
    log(f"phase 12 {what}: deltas' max abs diff (params, BN): grouped vs "
        f"vmapped {out['layouts']}, vmapped vs vmapped "
        f"{out['vmapped_run_to_run']}, of deltas up to {out['size']}; "
        f"one train-mode forward of the round's first batch, grouped vs "
        f"vmapped: {out['forward']}; set-up {setup_s:.1f}s")
    if not max(out["forward"].values()) <= 5e-5:
        raise AssertionError(f"{what}: grouped forward against vmapped "
                             f"{out['forward']}")
    del exp, engines
    torch.cuda.empty_cache()
    return out


def sequential_on_card(tmp: Path) -> dict:
    """12d: one poisoned MNIST smoke round (round 3), clients one at a time
    (sequential_debug) against stacked, both on the card: global ≤ 2e-3
    and accuracy within 0.5 (tests/test_fl_integration.py:268-283); one
    fused launch per local step of every width-1 call."""
    import numpy as np
    import torch
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl import rounds
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.ops import fused_update as fu

    real = rounds.RoundEngine.train_fn
    steps: list = []

    def train(self, global_vars, tasks_seq, idx_seq, mask_seq, *a, **kw):
        steps.append(int(np.asarray(mask_seq).any(axis=(1, 4)).sum()))
        return real(self, global_vars, tasks_seq, idx_seq, mask_seq, *a,
                    **kw)

    outs = {}
    rounds.RoundEngine.train_fn = train
    try:
        for name, seq in (("stacked", False), ("sequential", True)):
            p = Params.from_yaml(REPO / "configs" / "smoke_params.yaml")
            p.raw.update(run_dir=str(tmp / f"seq_{name}"),
                         sequential_debug=seq)
            exp = Experiment(p, save_results=False, device="cuda")
            steps.clear()
            fu.fused_step_update.launches = 0
            t = time.perf_counter()
            r = exp.run_round(3)
            torch.cuda.synchronize()
            outs[name] = {"round_s": time.perf_counter() - t,
                          "launches": fu.fused_step_update.launches,
                          "steps": sum(steps), "calls": len(steps),
                          "acc": r["global_acc"],
                          "vars": exp.global_vars.params}
    finally:
        rounds.RoundEngine.train_fn = real
    a, b = outs["stacked"], outs["sequential"]
    diff = max(float((a["vars"][k] - b["vars"][k]).abs().max())
               for k in a["vars"])
    gap = abs(a["acc"] - b["acc"])
    log(f"phase 12d: MNIST round 3 sequential vs stacked on the card: "
        f"global max abs diff {diff:.3g}, accuracy gap {gap:.3g}; "
        f"{b['calls']} width-1 train calls, fused launches "
        f"{a['launches']} / {b['launches']} = steps {a['steps']} / "
        f"{b['steps']}; {a['round_s']:.2f} / {b['round_s']:.2f} s")
    if (not diff <= 2e-3 or not gap < 0.5 or b["calls"] < 2
            or any(r["launches"] != r["steps"] or r["steps"] == 0
                   for r in (a, b))):
        raise AssertionError(f"12d: sequential vs stacked: diff {diff}, "
                             f"gap {gap}, {b['calls']} calls, launches "
                             f"{[(r['launches'], r['steps']) for r in (a, b)]}")
    return {"global_max_abs_diff": diff, "acc_gap": gap,
            **{f"{n}_{k}": r[k] for n, r in outs.items()
               for k in ("round_s", "launches", "steps")}}


def deep_resnets_on_card() -> dict:
    """12e: one train-mode forward of each deeper CIFAR ResNet (34, 50,
    101, 152) at batch 8 on the card against the same forward on the CPU,
    from the same weights and input: logits and new running stats within
    2e-3 (float32 summation order over 34-152 layers; the CPU tests hold
    the CPU forward to flax)."""
    import numpy as np
    import torch
    from dba_mod_tpu_torch import models

    out = {}
    x = torch.from_numpy(np.random.RandomState(1).rand(8, 32, 32, 3)
                         .astype(np.float32))
    for fn in (models.cifar_resnet34, models.cifar_resnet50,
               models.cifar_resnet101, models.cifar_resnet152):
        md = fn()
        cpu = md.init_vars(0, torch.device("cpu"))
        card = md.init_vars(0, torch.device("cuda"))
        with torch.no_grad():
            l_cpu, s_cpu = md.apply(cpu, x, train=True)
            l_gpu, s_gpu = md.apply(card, x.cuda(), train=True)
        d_logits = float((l_gpu.cpu() - l_cpu).abs().max())
        d_stats = max(float((s_gpu[k].cpu() - s_cpu[k]).abs().max())
                      for k in s_cpu)
        out[md.name] = {"logits": d_logits, "stats": d_stats,
                        "params": sum(v.numel() for v in cpu.params.values())}
        if not (d_logits <= 2e-3 and d_stats <= 2e-3):
            raise AssertionError(f"12e: {md.name} card vs CPU: logits "
                                 f"{d_logits}, running stats {d_stats}")
    log(f"phase 12e: deeper CIFAR ResNets, train-mode forward at batch 8, "
        f"card vs CPU max abs diff: {out}")
    return out


def run_phase12(tmp: Path, f32: dict) -> dict:
    """Phase 12: the grouped client layout against the vmapped one at
    full CIFAR (a) and Tiny-ImageNet (b) width, the grouped main path
    through the CLI (c), sequential_debug on the card (d) and the deeper
    CIFAR ResNets (e)."""
    import yaml
    t0 = time.perf_counter()
    cifar = layout_ab(tmp / "cifar_smoke.yaml", "cifar_pretrain/smoke", 2,
                      "12a CIFAR")
    tiny = layout_ab(tmp / "tiny_smoke.yaml", "tiny_pretrain/smoke", 2,
                     "12b Tiny-ImageNet", steps=16)
    raw = dict(yaml.safe_load((tmp / "cifar_smoke.yaml").read_text()),
               grouped_clients=True, local_eval=False,
               run_dir=str(tmp / "runs_grouped"))
    (tmp / "runs_grouped").mkdir()
    cfg = tmp / "cifar_grouped.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    cli = _train_rounds(cfg, "cifar_pretrain/smoke", 2, tmp / "runs_grouped",
                        int(raw["batch_size"]), [2], "12c grouped CIFAR")
    del cli["folder"]
    log(f"phase 12c: grouped CIFAR, 1 poisoned round through the CLI "
        f"(no local battery): round_time {cli['round_s']} (phase 4, vmapped "
        f"with the local battery: {f32['round_s']}); train "
        f"{cli['phase_s'].get('train_fn')} s for {cli['steps']} steps "
        f"(phase 4: {f32['phase_s'].get('train_fn')} s for "
        f"{f32['round_steps']}); {cli['launches']} fused launches = "
        f"{cli['steps']} local steps; acc {cli['global_acc']} backdoor "
        f"{cli['backdoor_acc']}")
    seq = sequential_on_card(tmp)
    deep = deep_resnets_on_card()
    total = time.perf_counter() - t0
    log(f"phase 12: {total:.1f}s")
    return {"cifar_ab": cifar, "tiny_ab": tiny, "cli": cli,
            "sequential": seq, "deep": deep, "seconds": total,
            "cifar_launches": cifar["grouped"]["launches"] + cli["launches"],
            "tiny_launches": tiny["grouped"]["launches"]}


# --------------------------------------------------------------- phase 13
def _world_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for one rank of a `world`-rank run on this
    host (all ranks share the one card, so the port picks gloo)."""
    import os
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world))
    env["PYTHONPATH"] = str(REPO) + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_world(cfg_path: Path, world: int, args: list, logs: list):
    """`world` ranks of `main train` on the card, rank r's output in
    logs[r]."""
    from dba_mod_tpu_torch import crash_smoke
    port = _free_port()
    return [crash_smoke.launch(cfg_path, "cuda", args, logs[r],
                               env=_world_env(r, world, port))
            for r in range(world)]


def _wait_all(procs, timeout: float) -> list:
    t_end = time.monotonic() + timeout
    try:
        return [p.wait(timeout=max(1.0, t_end - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def mesh_shards(tmp: Path) -> int:
    """13a, in a fresh process under deterministic kernels: phase 4's
    config from its pretrain, a 2-shard mesh on [cuda:0, cuda:0] against
    the unsharded engine. One poisoned round without the local battery
    through the mesh experiment; the same round's training run through the
    unsharded engine one shard's slice of clients at a time (the width
    each shard trains at, so cuDNN picks the same algorithms), the slices'
    deltas and metrics joined here in client order and held bitwise to the
    mesh's gathered stack; then the same round through an unsharded
    experiment whose train_fn returns those slices' results, so its server
    rule aggregates the unsharded engine's deltas: its new global model is
    held bitwise to the mesh round's. Also one train-mode forward of the
    round's first batch (the 10 clients vmapped at once, and as two shards
    of 5) and one local step per client through both engines' train_fn at
    full width, within 5e-5. Prints one JSON line."""
    import numpy as np
    import torch
    import yaml
    from dba_mod_tpu_torch.utils.device import use_deterministic_kernels
    use_deterministic_kernels()
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl import rounds
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.models import ModelVars
    from dba_mod_tpu_torch.ops import fused_update as fu
    from dba_mod_tpu_torch.parallel.mesh import shard_bounds

    raw = dict(yaml.safe_load((tmp / "cifar_smoke.yaml").read_text()),
               resumed_model=True, resumed_model_name="cifar_pretrain/smoke",
               local_eval=False, save_model=False)
    t0 = time.perf_counter()
    exps = {"plain": Experiment(Params.from_dict(raw), save_results=False,
                                device="cuda"),
            "mesh": Experiment(Params.from_dict(raw), save_results=False,
                               device="cuda",
                               mesh_devices=["cuda:0", "cuda:0"])}
    setup_s = time.perf_counter() - t0
    plain, mesh = exps["plain"], exps["mesh"]
    if mesh.engine.mesh is None or mesh.engine.mesh.size != 2:
        raise AssertionError("13a: the mesh engine is not sharded")
    gv = plain.global_vars          # the pretrain, before the rounds
    bounds = shard_bounds(mesh.engine.mesh, int(plain.params["no_models"]))

    # the mesh round; its train_fn's inputs and gathered result are kept
    seen = {}
    real = mesh.engine.train_fn

    def mesh_spy(gv_, tasks_, idx_, mask_, *a):
        seen.update(tasks=tasks_, idx=idx_, mask=mask_)
        seen["res"] = real(gv_, tasks_, idx_, mask_, *a)
        return seen["res"]
    mesh.engine.train_fn = mesh_spy
    fu.fused_step_update.launches = 0
    r = mesh.run_round(2)
    torch.cuda.synchronize()
    tasks, idx, mask, got = (seen["tasks"], seen["idx"], seen["mask"],
                             seen["res"])
    steps = sum(int(mask[i][lo:hi].any(axis=(0, 3)).sum())
                for i in range(mask.shape[0]) for lo, hi in bounds)
    mesh_round = {"round_time": r["round_time"],
                  "launches": fu.fused_step_update.launches, "steps": steps,
                  "global_acc": r["global_acc"],
                  "backdoor_acc": r["backdoor_acc"]}
    if mesh_round["launches"] != steps or steps == 0:
        raise AssertionError(f"13a mesh round: {mesh_round}")
    if not tasks[0].poisoning_per_batch.any():
        raise AssertionError("13a: round 2's inputs do not poison")

    # the same training, one shard's slice at a time, unsharded engine
    fu.fused_step_update.launches = 0
    t1 = time.perf_counter()
    parts = [plain.engine.train_fn(
        gv, [type(t)(*(np.asarray(f)[lo:hi] for f in t)) for t in tasks],
        np.ascontiguousarray(idx[:, lo:hi]),
        np.ascontiguousarray(mask[:, lo:hi])) for lo, hi in bounds]
    torch.cuda.synchronize()
    slices_s = time.perf_counter() - t1
    slice_launches = fu.fused_step_update.launches
    if slice_launches != steps:
        raise AssertionError(f"13a: the slices launched {slice_launches} "
                             f"times for {steps} steps")
    gather = {}
    for part in ("params", "batch_stats"):
        gather[part] = max(float((getattr(got.deltas, part)[k] - torch.cat(
            [getattr(q.deltas, part)[k] for q in parts])).abs().max())
            for k in getattr(got.deltas, part))
    gather["metrics"] = max(float((a - torch.cat(
        [m[j] for m in (q.metrics for q in parts)], 1)).abs().max())
        for j, a in enumerate(got.metrics))
    gather["delta_norms"] = float((got.delta_norms - torch.cat(
        [q.delta_norms for q in parts])).abs().max())

    # the same round through an unsharded experiment that aggregates the
    # slices' results
    def plain_train(gv_, tasks_, idx_, mask_, *a):
        if not (np.array_equal(idx_, idx) and np.array_equal(mask_, mask)):
            raise AssertionError("13a: the two experiments' round 2 "
                                 "inputs differ")
        return rounds._cat_shards(parts, plain.device)
    plain.engine.train_fn = plain_train
    fu.fused_step_update.launches = 0
    rp = plain.run_round(2)
    torch.cuda.synchronize()
    agg = {part: max(float((getattr(plain.global_vars, part)[k]
                            - getattr(mesh.global_vars, part)[k])
                           .abs().max())
                     for k in getattr(plain.global_vars, part))
           for part in ("params", "batch_stats")}
    agg_acc = {k: [rp[k], r[k]] for k in ("global_acc", "backdoor_acc")}
    moved = max(float((mesh.global_vars.params[k] - gv.params[k])
                      .abs().max()) for k in gv.params)
    del parts, got, seen

    # one train-mode forward of the round's first batch, stamped
    tasks, idx, mask, _ = plain.build_static_round_inputs(2)
    C = int(idx.shape[1])
    md, data, dev = plain.model_def, plain.device_data, plain.device
    task = tasks[0].to_device(dev)
    x, y = data.fetch_train(task.slot,
                            torch.from_numpy(idx[0][:, 0, 0]).to(dev))
    x, _, _ = data.stamp(x, y, task.adv_index, task.poisoning_per_batch)
    p, st = ({k: v.expand((C,) + v.shape).contiguous() for k, v in t.items()}
             for t in gv)

    def fwd(lo, hi):
        return torch.func.vmap(lambda pp, ss, xx: md.apply(
            ModelVars(pp, ss), xx, train=True))(
            {k: v[lo:hi] for k, v in p.items()},
            {k: v[lo:hi] for k, v in st.items()}, x[lo:hi])
    with torch.no_grad():
        lv, sv = fwd(0, C)
        fparts = [fwd(lo, hi) for lo, hi in bounds]
    ls = torch.cat([q[0] for q in fparts])
    ss = {k: torch.cat([q[1][k] for q in fparts]) for k in sv}
    forward = {"logits": float((lv - ls).abs().max()),
               "batch_stats": max(float((sv[k] - ss[k]).abs().max())
                                  for k in sv)}
    # one local step per client through each engine, at full width
    one = _first_steps(mask, 1)
    del plain.engine.train_fn, mesh.engine.train_fn     # the spies
    launches, deltas = {}, {}
    for name, e in exps.items():
        fu.fused_step_update.launches = 0
        deltas[name] = e.engine.train_fn(gv, tasks, idx, one).deltas
        torch.cuda.synchronize()
        launches[name] = fu.fused_step_update.launches
    if launches != {"plain": 1, "mesh": 2}:
        raise AssertionError(f"13a: one step's fused launches {launches}")
    step = _max_diffs(deltas["plain"], deltas["mesh"])
    step_size = {part: max(float(t.abs().max()) for t in
                           getattr(deltas["plain"], part).values())
                 for part in ("params", "batch_stats")}
    out = {"setup_s": setup_s, "shards": bounds, "forward": forward,
           "one_step": step, "one_step_size": step_size,
           "mesh_round": mesh_round, "slices_train_s": slices_s,
           "gather_max_diff": gather, "aggregate_max_diff": agg,
           "aggregate_acc": agg_acc, "global_moved": moved,
           "finite": all(bool(torch.isfinite(v).all()) for v in
                         list(mesh.global_vars.params.values())
                         + list(mesh.global_vars.batch_stats.values()))}
    print(json.dumps(out), flush=True)
    return 0


def mesh_cards() -> int:
    """``python3 chip_smoke.py mesh-cards``, on a machine with two or more
    cards (not part of the one-card run): full-width CIFAR
    (configs/cifar_params.yaml, its synthetic set, random weights from its
    seed) under deterministic kernels, one benign round's train_fn through
    the unsharded engine on cuda:0, a 2-shard mesh on [cuda:0, cuda:0] and
    one on [cuda:0, cuda:1]: the two meshes' deltas bit for bit, each
    shard's fused launches, and the train seconds of each layout (the
    median of 3 after a warm-up), so the two-card mesh's overlap shows
    against the one-card mesh. Prints one JSON line."""
    import statistics as st
    import torch
    import yaml
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("mesh-cards needs two CUDA cards", file=sys.stderr)
        return 1
    from dba_mod_tpu_torch.utils.device import use_deterministic_kernels
    use_deterministic_kernels()
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.ops import fused_update as fu
    from dba_mod_tpu_torch.parallel.mesh import shard_bounds

    raw = dict(yaml.safe_load(
        (REPO / "configs" / "cifar_params.yaml").read_text()),
        synthetic_data=True, resumed_model=False, local_eval=False,
        save_model=False)
    layouts = {"unsharded": None, "mesh_one_card": ["cuda:0", "cuda:0"],
               "mesh_two_cards": ["cuda:0", "cuda:1"]}
    exps = {n: Experiment(Params.from_dict(raw), save_results=False,
                          device="cuda", mesh_devices=d)
            for n, d in layouts.items()}
    first = exps["unsharded"]
    gv = first.global_vars
    tasks, idx, mask, _ = first.build_static_round_inputs(1)
    steps = int(sum(mask[i].any(axis=(0, 3)).sum()
                    for i in range(mask.shape[0])))
    shard_steps = sum(int(mask[i][lo:hi].any(axis=(0, 3)).sum())
                      for i in range(mask.shape[0]) for lo, hi in
                      shard_bounds(exps["mesh_one_card"].mesh,
                                   int(idx.shape[1])))

    def sync():
        for d in range(2):
            torch.cuda.synchronize(d)

    out, deltas = {"card": card_line(), "steps": steps,
                   "shard_steps": shard_steps}, {}
    for name, e in exps.items():
        e.engine.train_fn(gv, tasks, idx, mask)         # warm-up
        sync()
        times = []
        for _ in range(3):
            fu.fused_step_update.launches = 0
            t0 = time.perf_counter()
            res = e.engine.train_fn(gv, tasks, idx, mask)
            sync()
            times.append(time.perf_counter() - t0)
        out[name] = {"train_s": st.median(times), "train_s_all": times,
                     "launches": fu.fused_step_update.launches}
        deltas[name] = res.deltas
    a, b = deltas["mesh_one_card"], deltas["mesh_two_cards"]
    out["two_vs_one_card_max_diff"] = max(
        float((getattr(a, part)[k] - getattr(b, part)[k]).abs().max())
        for part in ("params", "batch_stats") for k in getattr(a, part))
    print(json.dumps(out), flush=True)
    ok = (out["two_vs_one_card_max_diff"] == 0.0
          and out["unsharded"]["launches"] == steps
          and out["mesh_one_card"]["launches"] == shard_steps
          and out["mesh_two_cards"]["launches"] == shard_steps)
    return 0 if ok else 1


def run_mesh_shards(tmp: Path, f32: dict) -> dict:
    """13a in its fresh process (see mesh_shards)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                           "mesh-shards", str(tmp)], capture_output=True,
                          text=True, timeout=400)
    if proc.returncode != 0:
        raise AssertionError("13a failed:\n" + proc.stdout[-3000:]
                             + proc.stderr[-3000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["seconds"] = time.perf_counter() - t0
    r = out["mesh_round"]
    log(f"phase 13a: 2-shard mesh on [cuda:0, cuda:0], deterministic "
        f"kernels: shards {out['shards']}; one poisoned round (no local "
        f"battery) through the mesh: {r} (phase 4, with the local battery: "
        f"round_time {f32['round_s']}); its gathered stack against the "
        f"unsharded engine run one shard's slice at a time "
        f"({out['slices_train_s']:.2f}s): max abs diff "
        f"{out['gather_max_diff']}; the unsharded experiment's aggregate "
        f"of those slices against the mesh round's global model: "
        f"{out['aggregate_max_diff']}, accuracies (unsharded, mesh) "
        f"{out['aggregate_acc']}; the round moved the model by up to "
        f"{out['global_moved']:.3g}; one train-mode forward, 2 shards vs 10 "
        f"lanes at once: {out['forward']}; one local step per client "
        f"through the mesh vs the unsharded engine at full width: deltas' "
        f"max abs diff {out['one_step']} of deltas up to "
        f"{out['one_step_size']}; {out['seconds']:.1f}s")
    if any(v != 0.0 for v in out["gather_max_diff"].values()):
        raise AssertionError(f"13a: gathered stack {out['gather_max_diff']}")
    if any(v != 0.0 for v in out["aggregate_max_diff"].values()):
        raise AssertionError(f"13a: aggregate {out['aggregate_max_diff']}")
    if any(a != b for a, b in out["aggregate_acc"].values()):
        raise AssertionError(f"13a: accuracies {out['aggregate_acc']}")
    if not out["global_moved"] > 0.0:
        raise AssertionError("13a: the round left the global model as it "
                             "was")
    if not max(out["forward"].values()) <= 5e-5:
        raise AssertionError(f"13a: sharded forward {out['forward']}")
    if not max(out["one_step"].values()) <= 5e-5:
        raise AssertionError(f"13a: one sharded step {out['one_step']}")
    if not out["finite"]:
        raise AssertionError("13a: non-finite mesh global model")
    return out


def _digests(text: str) -> list:
    import re
    return re.findall(r"global model sha256 ([0-9a-f]{64})", text)


def run_world_cifar(tmp: Path, f32: dict) -> dict:
    """13b: a 2-rank world on the one card (gloo), launched as two `main
    train` processes with torchrun's environment: phase 4's config without
    the local battery, one poisoned round from its pretrain. Both ranks end with bitwise the same
    model (their logged digests), only rank 0 writes the run folder, each
    rank's fused launches are its clients' local steps."""
    import re
    import yaml
    raw = dict(yaml.safe_load((tmp / "cifar_smoke.yaml").read_text()),
               num_devices=-1, run_name="world", save_on_epochs=[],
               local_eval=False, run_dir=str(tmp / "runs_world"))
    cfg = tmp / "cifar_world.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    logs = [tmp / f"world_rank{r}.log" for r in range(2)]
    t0 = time.perf_counter()
    rcs = _wait_all(_launch_world(cfg, 2, ["--resume", "cifar_pretrain/smoke",
                                           "--epochs", "2"], logs), 400)
    wall = time.perf_counter() - t0
    texts = [p.read_text() for p in logs]
    if rcs != [0, 0]:
        raise AssertionError(f"13b: ranks exited {rcs}:\n"
                             + "\n".join(t[-3000:] for t in texts))
    digests = [_digests(t) for t in texts]
    if len(digests[0]) != 1 or digests[0] != digests[1]:
        raise AssertionError(f"13b: rank models differ: {digests}")
    if "backend gloo" not in texts[0] or "saved" in texts[1]:
        raise AssertionError("13b: backend or writer wrong")
    folder = tmp / "runs_world" / "world"
    rows = [json.loads(l) for l in
            (folder / "metrics.jsonl").read_text().splitlines() if l.strip()]
    if [r["epoch"] for r in rows] != [2] or not rows[0]["adversaries"] \
            or not math.isfinite(float(rows[0]["global_acc"])):
        raise AssertionError(f"13b: recorded rows {rows}")
    launches = [int(re.findall(r"fused update kernel launches: (\d+)",
                               t)[-1]) for t in texts]
    gather_s = [float(x) for t in texts for x in re.findall(
        r"client stacks: \d+ bytes a rank in ([\d.]+)s", t)]
    out = {"digest": digests[0][0], "launches": launches,
           "round_time": rows[0]["round_time"], "gather_s": gather_s,
           "global_acc": rows[0]["global_acc"],
           "backdoor_acc": rows[0]["backdoor_acc"], "wall_s": wall}
    log(f"phase 13b: 2-rank gloo world on one card, 1 poisoned CIFAR round "
        f"through the CLI: both ranks' global model sha256 "
        f"{digests[0][0][:16]}... equal; rank 0 alone wrote "
        f"{sorted(p.name for p in folder.iterdir() if p.is_file())}; "
        f"round_time {rows[0]['round_time']:.3f}s (phase 4: "
        f"{f32['round_s']}); all-gather seconds {gather_s}; fused launches "
        f"by rank {launches}; acc {rows[0]['global_acc']} backdoor "
        f"{rows[0]['backdoor_acc']}; {wall:.1f}s for the two processes")
    return out


ELASTIC_MNIST = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=5, no_models=4,
    number_of_total_participants=8, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, is_poison=False, synthetic_data=True,
    synthetic_train_size=1024, synthetic_test_size=256, momentum=0.9,
    decay=0.0005, sampling_dirichlet=False, local_eval=False,
    random_seed=5, num_devices=-1, run_name="elastic", save_model=True,
    graceful_shutdown=True, heartbeat_interval_s=0.2,
    heartbeat_timeout_s=1.2, watchdog_soft_s=10, watchdog_hard_s=20)


def run_elastic_drill(tmp: Path) -> dict:
    """13c: the elastic drill at MNIST size on the card, under
    deterministic kernels: a 2-rank world with heartbeats SIGKILLs rank 1
    once two rounds are committed; the survivor exits 77 within
    watchdog_hard_s plus slack; one relaunched process (--resume auto)
    finishes in the same folder with every round once; the rows through
    the resume point are bitwise those of an uninterrupted 2-rank world
    run beside it."""
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch import crash_smoke
    from dba_mod_tpu_torch.utils.run_guard import EXIT_PEER_LOST
    cfgs = {}
    for name in ("ref", "crash"):
        cfgs[name] = tmp / f"elastic_{name}.yaml"
        cfgs[name].write_text(yaml.safe_dump(dict(
            ELASTIC_MNIST, run_dir=str(tmp / f"elastic_{name}"))))
    logs = {n: [tmp / f"elastic_{n}_{r}.log" for r in range(2)]
            for n in cfgs}
    t0 = time.perf_counter()
    ref = _launch_world(cfgs["ref"], 2, ["--deterministic"], logs["ref"])
    crash = _launch_world(cfgs["crash"], 2, ["--deterministic"],
                          logs["crash"])
    folder = tmp / "elastic_crash" / "elastic"
    try:
        t_end = time.monotonic() + 300
        while (ckpt.manifest_epoch(folder / "model_last.pt.tar") or 0) < 2:
            if time.monotonic() > t_end or any(p.poll() is not None
                                               for p in crash):
                raise AssertionError(
                    "13c: no two committed rounds before the kill:\n"
                    + logs["crash"][0].read_text()[-3000:])
            time.sleep(0.02)
        crash[1].kill()
        crash[1].wait()
        t_kill = time.perf_counter()
        rc = crash[0].wait(timeout=ELASTIC_MNIST["watchdog_hard_s"] + 40)
        exit_s = time.perf_counter() - t_kill
    finally:
        for p in crash:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rc != EXIT_PEER_LOST or exit_s > ELASTIC_MNIST["watchdog_hard_s"] \
            + 10 or "peer lost" not in logs["crash"][0].read_text():
        raise AssertionError(f"13c: survivor exited {rc} after {exit_s:.1f}s"
                             f":\n" + logs["crash"][0].read_text()[-3000:])
    resume_pt = ckpt.latest_verified_checkpoint(folder, quarantine=False)
    resume_epoch = ckpt.manifest_epoch(resume_pt) if resume_pt else None
    if not resume_epoch or resume_epoch < 2:
        raise AssertionError(f"13c: resume point {resume_pt}")
    relog = tmp / "elastic_relaunch.log"
    t1 = time.perf_counter()
    rp = crash_smoke.launch(cfgs["crash"], "cuda",
                            ["--deterministic", "--resume", "auto"], relog)
    if rp.wait(timeout=300) != 0:
        raise AssertionError("13c: relaunch failed:\n"
                             + relog.read_text()[-3000:])
    relaunch_s = time.perf_counter() - t1
    if _wait_all(ref, 300) != [0, 0]:
        raise AssertionError("13c: the uninterrupted world failed:\n"
                             + logs["ref"][0].read_text()[-3000:])
    want = _metrics_rows(tmp / "elastic_ref" / "elastic")
    got = _metrics_rows(folder)
    epochs = list(range(1, ELASTIC_MNIST["epochs"] + 1))
    if [r["epoch"] for r in got] != epochs or \
            [r["epoch"] for r in want] != epochs:
        raise AssertionError(f"13c: rows {[r['epoch'] for r in got]}")
    if got[:resume_epoch] != want[:resume_epoch]:
        raise AssertionError("13c: rows through the resume point differ")
    ok, why = ckpt.verify_checkpoint(folder / "model_last.pt.tar")
    if not ok:
        raise AssertionError(f"13c: final snapshot {why}")
    out = {"survivor_rc": rc, "exit_s_after_kill": exit_s,
           "resume_epoch": resume_epoch, "relaunch_s": relaunch_s,
           "seconds": time.perf_counter() - t0}
    log(f"phase 13c: elastic drill at MNIST size (2 ranks, gloo, one card, "
        f"deterministic): rank 1 SIGKILLed after round 2 committed; the "
        f"survivor exited {rc} {exit_s:.2f}s later (watchdog_hard_s "
        f"{ELASTIC_MNIST['watchdog_hard_s']}); relaunched with --resume "
        f"auto from epoch {resume_epoch}, finished in {relaunch_s:.1f}s "
        f"with rounds {epochs} once each; rows through epoch "
        f"{resume_epoch} equal the uninterrupted world's; "
        f"{out['seconds']:.1f}s")
    return out


def run_phase13(tmp: Path, f32: dict) -> dict:
    """Phase 13: the clients mesh (a), a multi-process world (b) and the
    elastic drill (c)."""
    t0 = time.perf_counter()
    a = run_mesh_shards(tmp, f32)
    b = run_world_cifar(tmp, f32)
    c = run_elastic_drill(tmp)
    total = time.perf_counter() - t0
    log(f"phase 13: {total:.1f}s")
    return {"mesh": a, "world": b, "elastic": c, "seconds": total,
            "cifar_launches": a["mesh_round"]["launches"]
            + sum(b["launches"])}


def main() -> int:
    t_start = time.perf_counter()
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

    phase_s: dict = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            phase_s[name] = round(time.perf_counter() - t, 1)

    t3 = time.perf_counter()
    kernels = (check_fused_update(dev)
               + check_fused_update(dev, "tiny_params.yaml", "tiny")
               + check_fused_update(dev, "loan_params.yaml", "loan",
                                   fg_cases=(False,)))
    phase_s["3"] = round(time.perf_counter() - t3, 1)
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
        tiny_data = start_tiny_data(tmp)
        try:
            out = run_phases(tmp, dev, kernels, timed, tiny_data)
        finally:
            if tiny_data.poll() is None:
                tiny_data.kill()
                tiny_data.wait()
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all; phase "
        f"seconds {phase_s}")
    for k in kernels:
        del k["bytes"]
    print(json.dumps({**out, "phase_s": phase_s,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(tmp: Path, dev, kernels: list, timed, tiny_data) -> dict:
    """Phases 4-12, each under `timed`; fills in the kernels' launches."""
    path = timed("4", run_main_path, tmp)
    kernels[0]["launches"] = path["launches"]
    robust = timed("4b", run_robust_rounds, tmp)
    kernels[1]["launches"] = robust["foolsgold"]["launches"]
    rules = timed("4c", time_aggregation_rules, dev)
    small = timed("5", check_small_reference, tmp)
    fault = timed("5b", check_fault_round, tmp)
    tiny = timed("6", run_tiny_path, tmp, tiny_data)
    kernels[2]["launches"] = tiny["fedavg"]["launches"]
    kernels[3]["launches"] = tiny["foolsgold"]["launches"]
    loan = timed("7", run_loan_path, tmp)
    kernels[4]["launches"] = loan["launches"]
    bf16 = timed("8", run_bf16, tmp, path)
    crash = timed("9", run_crash_resume, tmp)
    asyn = timed("10", run_async, tmp)
    ph11 = timed("11", run_phase11, tmp, path, asyn["11c"])
    ph12 = timed("12", run_phase12, tmp, path)
    ph13 = timed("13", run_phase13, tmp, path)
    kernels[0]["launches"] = (path["launches"] + asyn["launches"]
                              + ph11["launches"] + ph12["cifar_launches"]
                              + ph13["cifar_launches"])
    kernels[2]["launches"] += ph12["tiny_launches"]
    return {"main_path": path, "robust_rounds": robust,
            "aggregate_ms": rules, "small_reference": small,
            "fault_round": fault, "tiny_path": tiny, "loan_path": loan,
            "bf16": bf16, "crash_resume": crash, "async": asyn,
            "phase11": ph11, "phase12": ph12, "phase13": ph13}


if __name__ == "__main__":
    if sys.argv[1:2] == ["bf16-rounds"]:     # phase 8's fresh process
        sys.path.insert(0, str(REPO))
        sys.exit(bf16_rounds(Path(sys.argv[2])))
    if sys.argv[1:2] == ["tiny-data"]:       # phase 6's data, made early
        sys.path.insert(0, str(REPO))
        sys.exit(write_tiny_data(Path(sys.argv[2])))
    if sys.argv[1:2] == ["mesh-cards"]:      # two cards or more only
        sys.path.insert(0, str(REPO))
        sys.exit(mesh_cards())
    if sys.argv[1:2] == ["mesh-shards"]:     # 13a's fresh process
        sys.path.insert(0, str(REPO))
        sys.exit(mesh_shards(Path(sys.argv[2])))
    if sys.argv[1:2] == ["deterministic-mnist"]:  # 10a's and 11c's process
        sys.path.insert(0, str(REPO))
        sys.exit(async_keystone(Path(sys.argv[2]))
                 or overlap_small(Path(sys.argv[2])))
    sys.exit(main())
