"""Does the same run, from the same seed, give the same model twice?

    python -m dba_mod_tpu_torch.repeatability [--params configs/cifar_params.yaml]
        [--runs 2] [--deterministic] [--device cuda|cpu]

Runs chip_smoke.py's main path `--runs` times in this process, each in a
fresh directory: pretrain one round on synthetic data, resume it by name and
train two rounds that both poison (``0_poison_epochs: [2]``,
``1_poison_epochs: [3]``), all through the CLI. For each run it prints the
recorded global accuracy, global eval loss and backdoor accuracy per round,
the least BatchNorm running variance of the final global model, and a
sha256 over the pretrained and the final global model's tensors. The last
line is a JSON summary: whether all runs gave bitwise the same models.

``--deterministic`` asks PyTorch for deterministic kernels before anything
runs on the card (cuDNN's deterministic algorithms, no autotuning,
``torch.use_deterministic_algorithms(True, warn_only=True)`` and the cuBLAS
workspace setting that needs), and lists the operations that warned that
they have no deterministic implementation.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import warnings
from pathlib import Path


def _digest(model_vars) -> str:
    h = hashlib.sha256()
    for tree in (model_vars.params, model_vars.batch_stats):
        for k in sorted(tree):
            h.update(k.encode())
            h.update(tree[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _one_run(raw: dict, device: str, tmp: Path) -> dict:
    import torch
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.main import main as cli_main
    from dba_mod_tpu_torch.models import build_model

    raw = dict(raw, synthetic_data=True, run_dir=str(tmp / "runs"),
               checkpoint_dir=str(tmp / "ckpt"), save_model=True,
               save_on_epochs=[],
               **{"0_poison_epochs": [2], "1_poison_epochs": [3]})
    cfg_path = tmp / "params.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    common = ["--params", str(cfg_path), "--device", device]
    if cli_main(["pretrain", *common, "--epochs", "1", "--out",
                 "pretrain/run"]) != 0:
        raise RuntimeError("pretrain failed")
    if cli_main(["train", *common, "--resume", "pretrain/run",
                 "--epochs", "3"]) != 0:
        raise RuntimeError("train failed")
    (folder,) = (tmp / "runs").iterdir()
    rows = [json.loads(line) for line in
            (folder / "metrics.jsonl").read_text().splitlines() if line]
    like = build_model(Params.from_yaml(cfg_path)).init_vars(
        0, torch.device("cpu"))
    pre, _, _ = ckpt.load_checkpoint(tmp / "ckpt" / "pretrain" / "run", like)
    final, _, _ = ckpt.load_checkpoint(folder / "model_last.pt.tar", like)
    var = [v for k, v in final.batch_stats.items()
           if k.endswith("running_var")]
    return {"epochs": [r["epoch"] for r in rows],
            "global_acc": [r["global_acc"] for r in rows],
            "global_loss": [str(r["global_loss"]) for r in rows],
            "backdoor_acc": [r["backdoor_acc"] for r in rows],
            "min_running_var": (min(float(v.min()) for v in var)
                                if var else None),
            "pretrain_sha256": _digest(pre), "final_sha256": _digest(final)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--params", default="configs/cifar_params.yaml")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    import yaml
    from dba_mod_tpu_torch.utils.device import use_deterministic_kernels
    saved = (os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    if args.deterministic:
        use_deterministic_kernels()
    raw = yaml.safe_load(Path(args.params).read_text())
    runs, flagged = [], set()
    try:
        for i in range(args.runs):
            with tempfile.TemporaryDirectory(prefix="repeatability_") as td, \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run = _one_run(raw, args.device, Path(td))
            flagged |= {str(w.message).splitlines()[0] for w in caught
                        if "deterministic" in str(w.message)}
            print(json.dumps(dict(run, run=i)), flush=True)
            runs.append(run)
    finally:       # the switches are process-wide: leave them as found
        env, algos, warn_only, cudnn_det, cudnn_bench = saved
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        torch.use_deterministic_algorithms(algos, warn_only=warn_only)
        torch.backends.cudnn.deterministic = cudnn_det
        torch.backends.cudnn.benchmark = cudnn_bench
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    print(json.dumps({
        "device": card, "deterministic": args.deterministic,
        "runs": len(runs),
        "pretrain_identical": len({r["pretrain_sha256"] for r in runs}) == 1,
        "final_identical": len({r["final_sha256"] for r in runs}) == 1,
        "final_global_acc": [r["global_acc"][-1] for r in runs],
        "nondeterministic_ops": sorted(flagged)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
