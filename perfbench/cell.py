"""One run of one cell: set-up, the judged round, the window, the
reference, the metrics (see perfbench/run.py for what each part times)."""
from __future__ import annotations

import gc
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import compare, counting, inputs, reference
from perfbench.manifest import Manifest
from perfbench.plan import RoundPlanner
from perfbench.run import banned_modules, process_start
from perfbench.trace import RoundTrace


# the judged round's first steps whose change the comparison reads
STEPS = 3


def _note(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Capture:
    """Keeps what the program's judged round produces, by wrapping, for
    that round only, the calls it already makes: the fused update's first
    call (the first gradient as the optimizer gets it), the round core
    (start model, new model, client deltas and metrics) and the eval
    batteries (their results). Nothing is computed twice and nothing is
    changed."""

    def __init__(self, exp):
        self.exp = exp
        self.grad0 = None
        self.valid0 = None
        self.core = None
        self.before = None
        self.evals = None
        self.steps = 0
        self.state_k = None

    def __enter__(self):
        import dba_mod_tpu_torch.fl.client as client_mod
        self._client = client_mod
        self._update = client_mod.fused_step_update
        eng = self.exp.engine
        core, evals = eng.core_fn, eng.eval_batteries

        def update(lr, valid, params, grads, *a, **k):
            if self.grad0 is None:
                self.grad0 = {n: g.reshape(g.shape[0], -1).double().norm(
                    dim=1).cpu() for n, g in grads.items()}
                self.valid0 = (valid != 0).cpu()
            out = self._update(lr, valid, params, grads, *a, **k)
            if self.steps < STEPS:
                # the state after this step (the update is in place); the
                # last one kept is the state after the first STEPS steps
                self.steps += 1
                self.state_k = ({n: p.clone() for n, p in params.items()},
                                {n: b.clone() for n, b in a[3].items()})
            return out

        def core_fn(global_vars, *a, **k):
            out = core(global_vars, *a, **k)
            self.before, self.core = global_vars, out
            return out

        def eval_batteries(*a, **k):
            self.evals = evals(*a, **k)
            return self.evals

        client_mod.fused_step_update = update
        eng.core_fn, eng.eval_batteries = core_fn, eval_batteries
        return self

    def __exit__(self, *exc):
        self._client.fused_step_update = self._update
        del self.exp.engine.core_fn
        del self.exp.engine.eval_batteries
        return False

    def outputs(self, n_clients: int, epochs: List[int]) -> dict:
        """The judged round's outputs on the host, in compare.numbers'
        structure (and the models the reference's batteries run on)."""
        new_vars, _, payload, _, eval_in = self.core
        deltas = eval_in[0]
        metrics = payload[2]
        locals_, _, globals_ = self.evals

        def host(t):
            return t.detach().cpu()

        out = {"grad0": [], "losses": [], "deltas": [], "battery": {}}
        for c in range(n_clients):
            out["grad0"].append({k: float(v[c]) for k, v in
                                 self.grad0.items()})
            out["losses"].append(host(metrics.loss_sum[-1, c, :epochs[c]]))
            out["deltas"].append(({k: host(v[c]) for k, v in
                                   deltas.params.items()},
                                  {k: host(v[c]) for k, v in
                                   deltas.batch_stats.items()}))
        out["new_global"] = ({k: host(v) for k, v in new_vars.params.items()},
                             {k: host(v) for k, v in
                              new_vars.batch_stats.items()})
        before = ({k: host(v) for k, v in self.before.params.items()},
                  {k: host(v) for k, v in self.before.batch_stats.items()})
        out["server"] = tuple({k: out["new_global"][i][k] - v
                               for k, v in before[i].items()}
                              for i in range(2))
        out["valid0"] = [bool(v) for v in self.valid0[:n_clients]]
        out["steps_k"] = self.steps
        out["change_k"] = [tuple({k: host(v[c]) - before[i][k]
                                  for k, v in self.state_k[i].items()}
                                 for i in range(2))
                           for c in range(n_clients)]

        def row(name, r, i=None):
            sel = (lambda t: float(t)) if i is None else (
                lambda t: float(t[i]))
            out["battery"][name] = (sel(r.loss), sel(r.acc))

        row("global.clean", globals_.clean)
        row("global.poison", globals_.poison)
        for t in range(int(globals_.per_trigger.loss.shape[0])):
            row(f"global.trigger{t}", globals_.per_trigger, t)
        if locals_ is not None:
            for c in range(n_clients):
                for part in ("clean", "pre", "post", "agent"):
                    field = {"pre": "poison_pre", "post": "poison_post",
                             "agent": "agent_trigger"}.get(part, part)
                    row(f"local{c}.{part}", getattr(locals_, field), c)
        return out


class Ctx:
    """What the per-layer metric readers read."""

    def __init__(self, rounds: List[dict], trace: RoundTrace,
                 update_bytes: List[int], pk: dict, peak_flops: float):
        self.rounds = rounds
        self.trace = trace
        self.update_bytes = update_bytes
        self.peaks = pk
        self.peak_flops = peak_flops
        self.launches = sum(r["launches"] for r in rounds)
        self.train_flops = sum(r["flops"]["train"] for r in rounds)

    def span_total(self, name: str) -> Optional[float]:
        vals = [sum(r["spans"][name]) for r in self.rounds
                if r["spans"].get(name)]
        return sum(vals) if len(vals) == len(self.rounds) and vals else None

    def span_mean(self, name: str) -> Optional[float]:
        tot = self.span_total(name)
        return None if tot is None else tot / len(self.rounds)


def _spans_since(tel, before: Dict[str, int]) -> Dict[str, List[float]]:
    return {k: list(v[before.get(k, 0):])
            for k, v in getattr(tel, "_span_all", {}).items()
            if len(v) > before.get(k, 0)}


def _span_counts(tel) -> Dict[str, int]:
    return {k: len(v) for k, v in getattr(tel, "_span_all", {}).items()}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             overrides: Optional[dict] = None,
             cache: Optional[Path] = None):
    """Returns (result dict, lines for standard error). `overrides`
    ({"params"|"arch"|"dataset": {key: value}}) and `cache` (instead of
    the checkout's .perfbench_cache) serve the CPU tests."""
    t_start = process_start()
    man = Manifest(root)
    cell = man.cell(workload)
    conf = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    cfg = dict(conf["params"])
    cfg.update(traffic["params"])
    arch, ds = dict(conf["arch"]), dict(conf["dataset"])
    for part, vals in (overrides or {}).items():
        {"params": cfg, "arch": arch, "dataset": ds}[part].update(vals)
    pk = man.peaks()
    peak_flops = float(pk[conf["peak"]]["flops_per_s"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cache = Path(cache) if cache is not None else root / ".perfbench_cache"
    data_dir = inputs.ensure_images(cache / "data", ds, dev)
    start = inputs.make_weights(arch, seed, dev)
    tmp = Path(tempfile.mkdtemp(prefix="perfbench_"))
    try:
        return _run(root, man, cell, cfg, arch, ds, traffic, pk, peak_flops,
                    dev, data_dir, start, tmp, seed, seconds, trace,
                    t_start, workload)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_experiment(cfg: dict, traffic: dict, start: tuple, tmp: Path,
                     data_dir: Path, dev: torch.device, trace: bool):
    """The port's Experiment on the benchmark's inputs, resumed from the
    starting model saved as its named checkpoint."""
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment
    import logging
    logging.getLogger("dba_mod_tpu_torch").setLevel(logging.WARNING)
    e0 = int(traffic["start_epoch"])
    inputs.write_checkpoint(tmp / "ckpt" / cfg["resumed_model_name"], start,
                            e0 - 1, float(cfg["lr"]))
    cfg.update(data_dir=str(data_dir), checkpoint_dir=str(tmp / "ckpt"),
               run_dir=str(tmp / "runs"), resumed_model=True,
               save_model=False, telemetry=bool(trace))
    exp = Experiment(Params.from_dict(cfg), save_results=False,
                     device=str(dev))
    if exp.start_epoch != e0:
        raise RuntimeError(f"the port resumed at epoch {exp.start_epoch}, "
                           f"the traffic starts at {e0}")
    return exp


def judged_round(exp, e0: int, dev: torch.device):
    """The first round from the seed, through the window's own call, with
    its outputs kept: (Capture, the agents run_round reports)."""
    with Capture(exp) as cap:
        r = exp.run_round(e0)
    _sync(dev)
    return cap, list(r["agents"])


def _run(root, man, cell, cfg, arch, ds, traffic, pk, peak_flops, dev,
         data_dir, start, tmp, seed, seconds, trace, t_start, workload):
    from dba_mod_tpu_torch.ops import fused_update as fu
    e0 = int(traffic["start_epoch"])
    _note(f"inputs ready at {time.time() - t_start:.3f} s")
    exp = build_experiment(cfg, traffic, start, tmp, data_dir, dev, trace)
    local_eval = bool(cfg.get("local_eval", True))
    _note(f"experiment built at {time.time() - t_start:.3f} s")
    cap, agents0 = judged_round(exp, e0, dev)
    exp.telemetry.mark_warm()
    _note(f"judged round {e0} done at {time.time() - t_start:.3f} s")
    t_w0 = time.perf_counter()
    setup_s = time.time() - t_start

    # the window
    rounds: List[dict] = []
    rt = RoundTrace() if trace else None
    epoch = e0 + 1
    while True:
        # with --trace 1, one more round under the profiler once the
        # window's time is up
        done = bool(rounds) and rounds[-1]["end"] - t_w0 >= seconds
        if done and (not trace or rounds[-1]["profiled"]):
            break
        spans0 = _span_counts(exp.telemetry)
        l0 = fu.fused_step_update.launches
        if done:
            with rt.record(dev):
                r = exp.run_round(epoch)
        else:
            r = exp.run_round(epoch)
        _sync(dev)
        _note(f"round {epoch} ({'profiled' if done else 'plain'}) "
              f"ended {time.perf_counter() - t_w0:.3f} s into the window")
        rounds.append({"epoch": epoch, "agents": list(r["agents"]),
                       "end": time.perf_counter(), "profiled": done,
                       "launches": fu.fused_step_update.launches - l0,
                       "spans": _spans_since(exp.telemetry, spans0)})
        epoch += 1
    window_s = rounds[-1]["end"] - t_w0
    mem_peak = (int(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else 0)
    jax_loaded = banned_modules()
    if trace:
        rt.add_spans(list(exp.telemetry._trace_events),
                     exp.telemetry._origin)

    n_clients = len(agents0)
    planner_labels = inputs.labels(int(ds["train_size"]), int(ds["classes"]))
    planner = RoundPlanner(cfg, planner_labels)
    plan0 = planner.next_round(e0)
    epochs0 = [r.epochs for r in plan0["rows"]]
    prog = cap.outputs(n_clients, epochs0)
    del cap, exp
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the work of the window's rounds, by the benchmark's own count
    tr_x, tr_y, te_x, te_y = inputs.read_images(data_dir, ds)
    n_poison = int(np.sum(te_y != int(cfg["poison_label_swap"])))
    for rd in rounds:
        p = planner.next_round(rd["epoch"], with_plan=False)
        rd["plan_agents"] = p["agents"]
        rd["flops"] = counting.round_flops(arch, cfg, p, len(te_y), n_poison,
                                           local_eval)
        if rd["profiled"]:
            rd["update_bytes"] = counting.update_bytes(
                arch, p, int(cfg["batch_size"]))

    # the reference, once the program's state is freed
    data = reference.Images(tr_x, tr_y, te_x, te_y, dev)
    del tr_x, te_x
    judged = {"new_global": tuple({k: v.to(dev) for k, v in t.items()}
                                  for t in prog["new_global"]),
              "deltas": [tuple({k: v.to(dev) for k, v in t.items()}
                               for t in d) for d in prog["deltas"]]}
    t_ref = time.perf_counter()
    ref = reference.reference_round(start, plan0, data, cfg, arch,
                                    local_eval, judged,
                                    steps_k=prog["steps_k"])
    _note(f"reference took {time.perf_counter() - t_ref:.3f} s")
    ref_h = _host_outputs(ref, start, plan0)
    nums = compare.numbers(prog, ref_h)
    limits = man.limits(workload)
    verdicts = compare.judge(nums, limits)
    plan_ok = (agents0 == plan0["agents"] and all(
        rd["agents"] == rd["plan_agents"] for rd in rounds))
    correct = plan_ok and all(v[3] for v in verdicts) and not jax_loaded

    # metrics
    result_metrics = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": mem_peak}
    out = {"correct": bool(correct), "attempted": len(rounds), "failed": 0}
    if not trace:
        total = sum(rd["flops"]["total"] for rd in rounds)
        values = {"round_s": window_s / len(rounds),
                  "mfu": 100.0 * total / (window_s * peak_flops),
                  "setup_s": setup_s}
        for m in man.metrics("end_to_end", workload):
            if m["name"] in values:
                result_metrics[m["name"]] = {"value": values[m["name"]],
                                             "unit": m["unit"]}
    else:
        prof = next(rd for rd in rounds if rd["profiled"])
        ctx = Ctx([rd for rd in rounds if not rd["profiled"]], rt,
                  prof["update_bytes"], pk, peak_flops)
        for m in man.metrics("per_layer", workload):
            v = man.reader(m["name"])(ctx)
            if v is not None and math.isfinite(v):
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = rt.busy_s()
        device_info["window_s"] = rt.window_s
        out["breakdown"] = {"device_ops": rt.top_ops(10),
                            "idle_gaps": rt.idle_gaps(10)}
    out["metrics"] = result_metrics
    out["device"] = device_info
    out["compared"] = {n: {"value": v, "limit": lim}
                       for n, v, lim, _ in verdicts}
    lines = [f"not compared {n} {v!r}" for n, v in nums.items()
             if n not in limits]
    lines += [f"compared {n} {v!r} limit {lim!r} "
              f"{'within' if ok else 'OVER'}" for n, v, lim, ok in verdicts]
    if trace and rt.first_event_s is not None:
        lines.insert(0, f"trace: first device event "
                        f"{rt.first_event_s:.6f} s after the traced round's "
                        f"start")
    if not plan_ok:
        lines.insert(0, "compared plan: the port's agents differ from the "
                        "benchmark's plan")
    if jax_loaded:
        lines.insert(0, "loaded: " + ", ".join(jax_loaded))
    return out, lines


def _host_outputs(ref: dict, start: tuple, plan: dict) -> dict:
    def host(t):
        return t.detach().cpu()
    return {"grad0": [None if g is None else {k: float(v) for k, v in
                                              g.items()}
                      for g in ref["grad0"]],
            "losses": [host(v) for v in ref["losses"]],
            "deltas": [tuple({k: host(v) for k, v in t.items()} for t in d)
                       for d in ref["deltas"]],
            "server": tuple({k: host(ref["new_global"][i][k] - v)
                             for k, v in start[i].items()}
                            for i in range(2)),
            "battery": ref["battery"],
            "rule_global": tuple({k: host(v) for k, v in t.items()}
                                 for t in ref["rule_global"]),
            "rule_change": tuple({k: host(ref["rule_global"][i][k]
                                      - v.double())
                                  for k, v in start[i].items()}
                                 for i in range(2)),
            "change_k": [tuple({k: host(v) for k, v in t.items()}
                               for t in c) for c in ref["change_k"]],
            "valid0": [n > 0 for n in plan["sizes"]]}
