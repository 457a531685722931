"""Which version of a kernel a wrapper runs.

A wrapper runs its plain PyTorch version for a tensor on the CPU and its CUDA
kernel for a tensor on the card. ``reference_kernels()`` makes the wrappers
run the plain versions on the card too; it exists for comparing a whole run
against the plain path, and nothing on the main path enters it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def reference_active() -> bool:
    return getattr(_state, "reference", False)


@contextlib.contextmanager
def reference_kernels():
    """Run every kernel wrapper's plain version inside this block."""
    prev = reference_active()
    _state.reference = True
    try:
        yield
    finally:
        _state.reference = prev


def use_kernel(x: torch.Tensor) -> bool:
    """True where the wrapper must launch its CUDA kernel for ``x``."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    return not reference_active()


def stream_handle(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(x: torch.Tensor, name: str) -> int:
    try:
        return _DTYPE_CODES[x.dtype]
    except KeyError:
        raise ValueError(f"{name}: no kernel for dtype {x.dtype}") from None
