"""CLI of the PyTorch port — the same surface as dba_mod_tpu.main for the
synchronous and the buffered-async (``mode: async``) engines:

    python -m dba_mod_tpu_torch.main --params configs/cifar_params.yaml
    python -m dba_mod_tpu_torch.main pretrain --params ... --epochs N
    python -m dba_mod_tpu_torch.main train --params ... --resume NAME|auto
    python -m dba_mod_tpu_torch.main report --run RUN_FOLDER
    python -m dba_mod_tpu_torch.main fetch [--params ...] [--check-only]
    python -m dba_mod_tpu_torch.main cache-tiny | tiny-etl [--data-dir D]
    python -m dba_mod_tpu_torch.main loan-etl --input RAW.csv

It runs on the card; ``--device cpu`` asks for the CPU. Asking for CUDA on
a machine without a card raises. ``train`` exits 75 after a graceful stop
(``graceful_shutdown: true`` and SIGTERM/SIGINT; relaunch with ``--resume
auto``; an async run first flushes its partial buffer as one padded merge
and checkpoints it), the watchdog's hard abort exits 76, and a lost peer
in a multi-process run exits 77 (relaunch the survivors with WORLD_SIZE
shrunk and ``--resume auto``). A multi-process run is launched the way
torchrun launches one: every rank runs ``train`` with ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set.
``report`` renders a run folder's forensics.jsonl (``forensics: true``)
into a standalone HTML round-audit. ``fetch`` is the dataset preflight
(pinned URLs and sha256 checksums, download and verify, or
``--check-only``; an absent dataset falls back to the synthetic backend at
run time), ``cache-tiny`` decodes the Tiny-ImageNet folders once into an
.npz cache, and ``loan-etl`` / ``tiny-etl`` are the reference's offline
data prep.
"""
from __future__ import annotations

import argparse
import logging
import os
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
    from dba_mod_tpu_torch.parallel.distributed import PeerLostError
    exp = Experiment(params, save_results=not args.no_save,
                     device=args.device)
    try:
        last = exp.run()
    except PeerLostError as e:
        # a peer is gone; the run's finally already flushed checkpoints and
        # the recorder. os._exit: the process group's teardown would block
        # on the dead rank
        print(f"peer lost: {e} — relaunch the survivors with WORLD_SIZE "
              f"shrunk and --resume auto", flush=True)
        sys.stderr.flush()
        logging.shutdown()
        os._exit(run_guard.EXIT_PEER_LOST)
    from dba_mod_tpu_torch.ops import fused_update as fu
    lg = logging.getLogger("dba_mod_tpu_torch")
    lg.info("fused update kernel launches: %d", fu.fused_step_update.launches)
    if exp.world_size > 1:
        from dba_mod_tpu_torch.parallel.distributed import state_digest
        lg.info("rank %d/%d: global model sha256 %s", exp.rank,
                exp.world_size, state_digest(exp.global_vars))
    if exp._overlap_rounds or exp._finalized_ahead:
        lg.info("overlap: %d rounds, hidden eval seconds %.6f, eval wait "
                "seconds %.6f, finalized ahead of the device %d",
                exp._overlap_rounds, exp._overlap_hidden_s,
                exp._overlap_wait_s, exp._finalized_ahead)
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


def _fetch(args) -> int:
    from dba_mod_tpu_torch.data.fetch import run_preflight
    data_dir = args.data_dir
    types = [args.type] if args.type and args.type != "all" else None
    if args.params:
        params = Params.from_yaml(args.params)
        types = [params.type]
        if args.data_dir == "./data":  # the YAML's unless overridden
            data_dir = str(params.get("data_dir", "./data"))
    return run_preflight(types, data_dir, check_only=args.check_only)


def _cache_tiny(args) -> int:
    import numpy as np
    from dba_mod_tpu_torch.data.datasets import load_tiny_imagenet
    data = load_tiny_imagenet(args.data_dir)
    if data is None:
        print("tiny-imagenet-200 folders not found (or PIL missing)",
              file=sys.stderr)
        return 1
    out = Path(args.data_dir) / "tiny-imagenet-200.npz"
    np.savez_compressed(out, train_x=data.train_images,
                        train_y=data.train_labels, test_x=data.test_images,
                        test_y=data.test_labels)
    print(f"cached {len(data.train_labels)} train / "
          f"{len(data.test_labels)} val images -> {out}")
    return 0


def _loan_etl(args) -> int:
    from dba_mod_tpu_torch.data.etl import preprocess_loan
    n = preprocess_loan(args.input, Path(args.data_dir) / "loan")
    print(f"wrote {n} per-state loan CSVs")
    return 0


def _tiny_etl(args) -> int:
    from dba_mod_tpu_torch.data.etl import reformat_tiny_imagenet_val
    n = reformat_tiny_imagenet_val(Path(args.data_dir) / "tiny-imagenet-200")
    print(f"moved {n} val images into per-class folders")
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
    fe = sub.add_parser(
        "fetch", help="dataset preflight: check/download + sha256-verify "
                      "the real datasets; absent ones fall back to the "
                      "deterministic synthetic backend at run time")
    fe.add_argument("--params", default=None,
                    help="YAML config: preflight exactly the dataset this "
                         "experiment needs (type + data_dir)")
    fe.add_argument("--type", default="all",
                    choices=["all", "cifar", "mnist", "tiny-imagenet-200",
                             "loan"])
    fe.add_argument("--data-dir", default="./data")
    fe.add_argument("--check-only", action="store_true",
                    help="no network: report presence/integrity and the "
                         "synthetic-fallback consequences, exit nonzero "
                         "if anything is missing")
    ct = sub.add_parser("cache-tiny")
    ct.add_argument("--data-dir", default="./data")
    le = sub.add_parser("loan-etl")
    le.add_argument("--input", required=True, help="raw lending-club CSV")
    le.add_argument("--data-dir", default="./data")
    te = sub.add_parser("tiny-etl")
    te.add_argument("--data-dir", default="./data")
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
    known = {"train", "pretrain", "fetch", "cache-tiny", "loan-etl",
             "tiny-etl", "report", "-h", "--help"}
    if argv and argv[0] not in known:
        argv = ["train"] + argv  # reference style: --params only
    args = build_parser().parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(message)s")
    return {"train": _train, "pretrain": _pretrain, "fetch": _fetch,
            "cache-tiny": _cache_tiny, "loan-etl": _loan_etl,
            "tiny-etl": _tiny_etl, "report": _report}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
