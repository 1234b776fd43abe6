"""Run one benchmark cell of dba_mod_tpu_torch once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as ``setup_s``, from the process's start): the cell's image
sets are written once per checkout under ``.perfbench_cache/`` in the
format the port's loader reads; the starting model is drawn on the card
from ``--seed`` and saved as the named checkpoint the configuration resumes
from; the port's ``Experiment`` is built on them and runs the traffic's
first round through ``Experiment.run_round`` (which warms every shape the
window uses, and is the round that ``correct`` judges).

Window: further rounds through ``run_round``, one after another, until
``--seconds`` have passed; the window closes at the end of the round that
crosses that mark, and counts all its whole rounds. ``round_s`` is the
window's wall time over its rounds, ``mfu`` the benchmark's count of their
useful FLOPs over the window's time and the configuration's peak.

With ``--trace 1`` the port's telemetry is on (synced spans) and the
window's rounds run as above; once ``--seconds`` have passed, one more
round runs under torch.profiler. The span and counter metrics are taken
over the window's rounds, which the profiler does not slow, and the device
metrics (``busy_s``, ``device_idle``, the kernels' shares, ``breakdown``)
from the profiled round.

After the window the program's state is freed and the plain reference
(perfbench/reference.py) works the judged round out again; the numbers of
perfbench/compare.py against their limits decide ``correct``. The last
lines on standard error, and the ``compared`` key of the result, give each
number beside its limit. The result is the last line of standard output.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

BANNED = ("jax", "jaxlib", "flax", "dba_mod_tpu")
_T_IMPORT = time.time()


def process_start() -> float:
    """The process's start on the wall clock (Linux /proc), or this
    module's import where /proc is not there."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _T_IMPORT


def banned_modules(names=None) -> list:
    """Top-level names (the part before the first dot, whole) of the
    loaded modules, or of `names`, that the port must not load."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def cache_env(root: Path) -> None:
    """Build and kernel caches in fixed directories inside the checkout."""
    cache = root / ".perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    from perfbench.manifest import Manifest
    cell = Manifest(root).cell(args.workload)
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count="
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from perfbench.cell import run_cell
    result, lines = run_cell(root, args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda")
    found = banned_modules()
    if found:
        print("perfbench: modules that must not load were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    import json
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
