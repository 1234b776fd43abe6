"""Where one round's time goes, on the card.

    python -m dba_mod_tpu_torch.profile_round [--params configs/cifar_params.yaml]

Every workload: the image ones and LOAN, whose round gets its dropout keep
masks as the engine's do (drawn on the CPU from the (random_seed, epoch,
segment) stream). Builds the experiment at the config's full width on synthetic data (fresh
weights: the timing does not depend on them), runs one warm-up round, then
times one poisoned round phase by phase with the device synchronised
between phases (train, aggregate under the config's rule, local battery,
global battery), and runs the same round's inputs again under
torch.profiler for the device time by kernel and the device's busy time
(the union of kernel intervals; its share is taken against the untraced
round's wall). Prints the profiler's table and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--params", default="configs/cifar_params.yaml")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import yaml
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment

    raw = yaml.safe_load(Path(args.params).read_text())
    with tempfile.TemporaryDirectory(prefix="profile_round_") as tmp:
        raw.update(synthetic_data=True, resumed_model=False, run_dir=tmp,
                   **{"0_poison_epochs": [2], "1_poison_epochs": [3]})
        exp = Experiment(Params.from_dict(raw), save_results=False,
                         device=args.device)
        report = _profile(exp)
    print(report["table"])
    del report["table"]
    print(json.dumps(report), flush=True)
    return 0


def _profile(exp) -> dict:
    from dba_mod_tpu_torch.ops import fused_update as fu
    dev, eng = exp.device, exp.engine
    t0 = time.perf_counter()
    exp.run_round(1)                                   # warm-up
    _sync(dev)
    warm_s = time.perf_counter() - t0

    def phases(inputs):
        tasks, idx, mask, num_samples, drop = inputs
        out = {"active_steps": int(mask[0].any(axis=(0, 3)).sum())}
        gv = exp.global_vars
        _sync(dev)
        t = time.perf_counter()
        fu.fused_step_update.launches = 0
        train = eng.train_fn(gv, tasks, idx, mask, drop)
        _sync(dev)
        out["train_s"] = time.perf_counter() - t
        out["fused_launches"] = fu.fused_step_update.launches
        t = time.perf_counter()
        agg = eng.aggregate_fn(
            gv, train.deltas, fg_state=exp.fg_state, fg_grads=train.fg_grads,
            fg_feature=train.fg_feature,
            participant_ids=torch.from_numpy(
                tasks[0].participant_id.astype("int64")).to(dev),
            num_samples=torch.from_numpy(num_samples).to(dev))
        _sync(dev)
        out["aggregate_s"] = time.perf_counter() - t
        t = time.perf_counter()
        prev = type(train.deltas)(
            {k: torch.zeros_like(v) for k, v in train.deltas.params.items()},
            {k: torch.zeros_like(v)
             for k, v in train.deltas.batch_stats.items()})
        eng.local_evals(gv, train.deltas, tasks[-1].to_device(dev), prev)
        _sync(dev)
        out["local_evals_s"] = time.perf_counter() - t
        t = time.perf_counter()
        eng.global_evals(agg.new_vars)
        _sync(dev)
        out["global_evals_s"] = time.perf_counter() - t
        out["round_s"] = sum(out[k] for k in ("train_s", "aggregate_s",
                                              "local_evals_s",
                                              "global_evals_s"))
        out["train_ms_per_step"] = 1e3 * out["train_s"] / max(
            out["active_steps"], 1)
        return out

    # one poisoned round's inputs, run twice: timed, then traced
    inputs = exp.build_static_round_inputs(2)
    inputs = inputs + (exp._dropout_masks(2, inputs[1].shape),)
    timed = phases(inputs)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        traced = phases(inputs)
    traced_wall = time.perf_counter() - t
    # device busy time: the union of all device-kernel intervals
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    events = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total) for e in events
                      if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA),
                     key=lambda kv: -kv[1])
    on_card = dev.type == "cuda"
    return {
        "table": events.table(sort_by="self_device_time_total" if on_card
                              else "self_cpu_time_total", row_limit=25),
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "warmup_round_s": warm_s, "timed": timed, "traced": traced,
        "traced_wall_s": traced_wall,
        # kernel time over the UNTRACED round's wall (same inputs): the
        # profiler slows the host, not the device. A CPU run has no device.
        "device_busy_s": busy_us / 1e6 if on_card else None,
        "device_busy_share": (busy_us / 1e6 / timed["round_s"]
                              if on_card and timed["round_s"] else None),
        "top_kernels_us": kernels[:12]}


if __name__ == "__main__":
    sys.exit(main())
