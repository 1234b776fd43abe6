"""Device selection for the port's entry points.

The entry points run on the card unless the caller asks for the CPU. Asking
for CUDA on a machine without a card raises: the port never falls back to
the CPU on its own.
"""
from __future__ import annotations

import os

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' (--device cpu) to run on the "
                "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev


def pin_float32_math() -> None:
    """float32 runs in full float32 on the card. cuDNN convolutions default
    to TF32 (about three decimal digits), and the JAX reference is f32, so
    both TF32 switches are turned off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def use_deterministic_kernels() -> None:
    """Deterministic kernels for the rest of the process, so the same run
    from the same seed gives bitwise the same model on the card: cuDNN's
    deterministic algorithms without autotuning, and
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` with the
    cuBLAS workspace setting it needs (read when cuBLAS makes its first
    handle, so call this before anything runs on the card)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
