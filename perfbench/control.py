"""Readings that set the limits of ``correct``: for each seed, the numbers
of perfbench/compare.py for

- ``program``    the port's judged round (the lower reading);
- ``tf32``       the control: the plain reference in TF32 in the port's
                 place, against the reference in float32 (TF32 off), the
                 precision the configurations state;
- ``half_batch`` the reference with the loss over the first half of each
                 batch, the mean taken over the rest (its batteries are the
                 float32 reference's);
- ``answer``     the port's outputs with one answer altered where it is
                 produced: the global battery's main-task accuracy one
                 percentage point higher;
- ``unchanged``  the port's outputs with every client's state left
                 unchanged by its round (zero deltas, the global model
                 unmoved);
- ``server_unchanged`` the port's outputs with the server's step
                 returning the global model unchanged;
- ``half_clients`` the port's outputs with the server's mean taken over
                 the first half of the clients' deltas, the rest left out.

``--data-seed`` draws the images from another data seed than the
configuration's (in a cache directory of their own), to read the same
numbers on other pixels.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \
        [--faults tf32,half_batch,...] [--data-seed n]

One process reads every seed (set-up is paid once for the images). One
JSON line per seed on standard output. The benchmark's runs do not run
this; perfbench/tests/test_perfbench_control.py runs it at a small size.
"""
from __future__ import annotations

import argparse
import copy
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import compare, inputs, reference
from perfbench.cell import (_host_outputs, build_experiment, judged_round)
from perfbench.manifest import Manifest
from perfbench.plan import RoundPlanner
from perfbench.run import cache_env


def readings(root: Path, workload: str, seeds, device: str = "cuda",
             overrides=None, cache=None, faults=("tf32", "half_batch",
                                                 "answer", "unchanged",
                                                 "server_unchanged",
                                                 "half_clients")):
    """Yields one dict of readings per seed."""
    man = Manifest(root)
    cell = man.cell(workload)
    conf = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    base = dict(conf["params"])
    base.update(traffic["params"])
    arch, ds = dict(conf["arch"]), dict(conf["dataset"])
    for part, vals in (overrides or {}).items():
        {"params": base, "arch": arch, "dataset": ds}[part].update(vals)
    dev = torch.device(device)
    cache = Path(cache) if cache is not None else root / ".perfbench_cache"
    data_dir = inputs.ensure_images(cache / "data", ds, dev)
    tr_x, tr_y, te_x, te_y = inputs.read_images(data_dir, ds)
    data = reference.Images(tr_x, tr_y, te_x, te_y, dev)
    e0 = int(traffic["start_epoch"])
    local_eval = bool(base.get("local_eval", True))
    for seed in seeds:
        t0 = time.perf_counter()
        cfg = dict(base)
        start = inputs.make_weights(arch, seed, dev)
        tmp = Path(tempfile.mkdtemp(prefix="perfbench_control_"))
        try:
            exp = build_experiment(cfg, traffic, start, tmp, data_dir, dev,
                                   False)
            cap, agents = judged_round(exp, e0, dev)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        plan = RoundPlanner(cfg, inputs.labels(int(ds["train_size"]),
                                               int(ds["classes"]))
                            ).next_round(e0)
        prog = cap.outputs(len(agents), [r.epochs for r in plan["rows"]])
        del cap, exp
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_prog = time.perf_counter() - t0
        judged = {"new_global": tuple({k: v.to(dev) for k, v in t.items()}
                                      for t in prog["new_global"]),
                  "deltas": [tuple({k: v.to(dev) for k, v in t.items()}
                                   for t in d) for d in prog["deltas"]]}

        def ref_run(**kw):
            return _host_outputs(reference.reference_round(
                start, plan, data, cfg, arch, local_eval, judged,
                steps_k=prog["steps_k"], **kw), start, plan)
        t1 = time.perf_counter()
        ref = ref_run()
        t_ref = time.perf_counter() - t1
        out = {"seed": seed, "agents_match": agents == plan["agents"],
               "program": compare.numbers(prog, ref),
               "loss_by_epoch": compare.loss_by_epoch(prog, ref)}
        if "tf32" in faults:
            out["tf32"] = compare.numbers(ref_run(mode="tf32"), ref)
        if "half_batch" in faults:
            half = ref_run(half_batch=True, battery=False)
            half["battery"] = ref["battery"]
            out["half_batch"] = compare.numbers(half, ref)
        if "answer" in faults:
            alt = copy.copy(prog)
            alt["battery"] = dict(prog["battery"])
            loss, acc = alt["battery"]["global.clean"]
            alt["battery"]["global.clean"] = (loss, acc + 1.0)
            out["answer"] = compare.numbers(alt, ref)
        if "unchanged" in faults:
            still = copy.copy(prog)
            still["deltas"] = [tuple({k: torch.zeros_like(v) for k, v in
                                      t.items()} for t in d)
                               for d in prog["deltas"]]
            still["server"] = tuple({k: torch.zeros_like(v) for k, v in
                                     t.items()} for t in prog["server"])
            still["change_k"] = [tuple({k: torch.zeros_like(v) for k, v in
                                        t.items()} for t in d)
                                 for d in prog["change_k"]]
            out["unchanged"] = compare.numbers(still, ref)
        start_h = tuple({k: v.cpu() for k, v in t.items()} for t in start)
        if "server_unchanged" in faults:
            still = dict(prog, new_global=start_h)
            out["server_unchanged"] = compare.numbers(still, ref)
        if "half_clients" in faults:
            h = len(prog["deltas"]) // 2
            scale = float(cfg["eta"]) / h
            half = dict(prog, new_global=tuple(
                {k: g + scale * torch.stack([d[i][k] for d in
                                             prog["deltas"][:h]]).sum(0)
                 for k, g in start_h[i].items()} for i in range(2)))
            out["half_clients"] = compare.numbers(half, ref)
        out["seconds"] = {"program": t_prog, "reference": t_ref,
                          "all": time.perf_counter() - t0}
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--faults", default="tf32,half_batch,answer,unchanged,"
                                        "server_unchanged,half_clients",
                    help="comma-separated readings beside the program's "
                         "(empty: the program's alone)")
    ap.add_argument("--data-seed", type=int, default=None,
                    help="draw the images from this data seed instead of "
                         "the configuration's")
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    faults = tuple(f for f in args.faults.split(",") if f)
    over = (None if args.data_seed is None
            else {"dataset": {"data_seed": args.data_seed}})
    for r in readings(root, args.workload, seeds, faults=faults,
                      overrides=over):
        r["data_seed"] = args.data_seed
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
