"""Build a hand-written CUDA source into a shared library and load it.

Each kernel source under ``dba_mod_tpu_torch/csrc/`` exports a plain
``extern "C"`` launch function. It is compiled at first use with ``nvcc
-O3 -arch=sm_90a`` into ``dba_mod_tpu_torch/_build/`` (listed in
.gitignore) and loaded with ``ctypes``. The library's file name carries a
hash of the source and flags, so an edited source is rebuilt and a stale
library is never loaded. No PyTorch header is included, so a build takes
seconds. Each build is reported to telemetry (``cuda/kernel_builds``; a
build after warm-up is counted apart and logged).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from dba_mod_tpu_torch.utils import telemetry

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc per library, for the smoke script's report
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of dba_mod_tpu_torch are built at first "
                           "use and need the CUDA toolkit")
    return found


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def load_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if its library is missing, then load it."""
    with _lock:
        if source in _loaded:
            return _loaded[source]
        out = library_path(source)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            build_seconds[source] = time.perf_counter() - t0
            os.replace(tmp, out)
            telemetry.kernel_built(source, build_seconds[source])
        lib = ctypes.CDLL(str(out))
        _loaded[source] = lib
        return lib
