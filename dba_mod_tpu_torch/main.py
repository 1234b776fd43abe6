"""CLI of the PyTorch port — the same surface as dba_mod_tpu.main for the
synchronous and the buffered-async (``mode: async``) engines:

    python -m dba_mod_tpu_torch.main --params configs/cifar_params.yaml
    python -m dba_mod_tpu_torch.main pretrain --params ... --epochs N
    python -m dba_mod_tpu_torch.main train --params ... --resume NAME|auto
    python -m dba_mod_tpu_torch.main report --run RUN_FOLDER

It runs on the card; ``--device cpu`` asks for the CPU. Asking for CUDA on
a machine without a card raises. ``train`` exits 75 after a graceful stop
(``graceful_shutdown: true`` and SIGTERM/SIGINT; relaunch with ``--resume
auto``; an async run first flushes its partial buffer as one padded merge
and checkpoints it), and the watchdog's hard abort exits 76. ``report``
renders a run folder's forensics.jsonl (``forensics: true``) into a
standalone HTML round-audit.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from dba_mod_tpu_torch.config import Params


def _load_params(args) -> Params:
    params = Params.from_yaml(args.params)
    if args.epochs is not None:
        params.raw["epochs"] = args.epochs
    if args.synthetic:
        params.raw["synthetic_data"] = True
    return params


def _train(args) -> int:
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.utils import run_guard
    params = _load_params(args)
    if args.resume == "auto":
        # the same guard as config validation: this override lands after
        # from_yaml validated the file
        if not bool(params.raw.get("checkpoint_manifests", True)):
            raise SystemExit(
                "--resume auto requires checkpoint_manifests: true "
                "(auto-resume only restores manifest-verified checkpoints)")
        params.raw["resumed_model"] = "auto"
    elif args.resume:
        params.raw.update(resumed_model=True, resumed_model_name=args.resume)
    if args.deterministic:
        from dba_mod_tpu_torch.utils.device import use_deterministic_kernels
        use_deterministic_kernels()
    exp = Experiment(params, save_results=not args.no_save,
                     device=args.device)
    last = exp.run()
    from dba_mod_tpu_torch.ops import fused_update as fu
    logging.getLogger("dba_mod_tpu_torch").info(
        "fused update kernel launches: %d", fu.fused_step_update.launches)
    if exp.interrupted:
        done = last.get("epoch") if last else exp.start_epoch - 1
        print(f"interrupted: graceful stop after epoch {done} — resume "
              f"with --resume auto", flush=True)
        return run_guard.EXIT_INTERRUPTED
    if not last:  # resume checkpoint already at/after the final epoch
        print(f"no rounds to run: start_epoch={exp.start_epoch} > "
              f"epochs={params['epochs']}")
        return 0
    print(f"final: epoch={last.get('epoch')} "
          f"acc={last.get('global_acc'):.2f} "
          f"backdoor={last.get('backdoor_acc')}")
    return 0


def _pretrain(args) -> int:
    from dba_mod_tpu_torch import checkpoint as ckpt
    from dba_mod_tpu_torch.fl.experiment import Experiment
    params = _load_params(args)
    params.raw.update(is_poison=False, resumed_model=False,
                      save_model=False)
    exp = Experiment(params, save_results=False, device=args.device)
    last = exp.run()
    out = Path(str(params.get("checkpoint_dir", "saved_models"))) / (
        args.out or f"{params.type}_pretrain/model_last.pt.tar.epoch_"
                    f"{params['epochs']}")
    ckpt.save_checkpoint(out, exp.global_vars, int(params["epochs"]),
                         float(params["lr"]))
    acc = last.get("global_acc")
    print(f"pretrained to epoch {params['epochs']} "
          f"acc={acc if acc is None else round(acc, 2)} -> {out}")
    return 0


def _report(args) -> int:
    from dba_mod_tpu_torch.utils.forensics import write_report
    out = write_report(Path(args.run), Path(args.out) if args.out else None)
    print(f"wrote {out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dba_mod_tpu_torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="cmd")

    def common(p):
        p.add_argument("--params", required=True,
                       help="YAML config (reference schema)")
        p.add_argument("--epochs", type=int, default=None)
        p.add_argument("--synthetic", action="store_true",
                       help="force the synthetic dataset backend")
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where to run (default: the card; raises when "
                            "there is none)")

    train = sub.add_parser("train", help="run an FL experiment (default)")
    common(train)
    train.add_argument("--no-save", action="store_true")
    train.add_argument(
        "--resume", default=None, metavar="auto|NAME",
        help="'auto': the newest verified checkpoint under run_dir, "
             "continuing its run folder; any other value resumes "
             "checkpoint_dir/NAME (overrides the YAML's resumed_model keys)")
    train.add_argument("--deterministic", action="store_true",
                       help="deterministic kernels (cuDNN, cuBLAS): the same "
                            "run gives bitwise the same model")
    pre = sub.add_parser("pretrain", help="train+save a clean model")
    common(pre)
    pre.add_argument("--out", default=None,
                     help="checkpoint path under checkpoint_dir")
    rp = sub.add_parser(
        "report", help="render forensics.jsonl into a standalone HTML "
                       "round-audit (a run with forensics: true)")
    rp.add_argument("--run", required=True,
                    help="run folder containing forensics.jsonl")
    rp.add_argument("--out", default=None,
                    help="output path (default: RUN/forensics_report.html)")
    return parser


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in ("train", "pretrain", "report", "-h",
                                "--help"):
        argv = ["train"] + argv  # reference style: --params only
    args = build_parser().parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(message)s")
    return {"train": _train, "pretrain": _pretrain,
            "report": _report}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
