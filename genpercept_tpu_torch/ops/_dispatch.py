"""Which version of a kernel a wrapper runs.

A wrapper runs its plain PyTorch version for a tensor on the CPU and its CUDA
kernel for a tensor on the card. ``reference_kernels()`` makes the wrappers
run the plain versions on the card too; it exists for comparing a whole run
against the plain path, and nothing on the main path enters it. The switch
is process-wide, not per thread: the autograd engine runs a CUDA backward
pass, and the forwards that checkpoints recompute in it, on threads of its
own, which a thread-local switch would not reach.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0  # open reference_kernels() blocks


def reference_active() -> bool:
    return _depth > 0


@contextlib.contextmanager
def reference_kernels():
    """Run every kernel wrapper's plain version inside this block, in every
    thread of the process."""
    global _depth
    with _lock:
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1


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


def dtype_code(x: torch.Tensor | torch.dtype, name: str) -> int:
    """The kernels' code for a tensor's dtype (or a dtype); raise on others."""
    dtype = x if isinstance(x, torch.dtype) else x.dtype
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise ValueError(f"{name}: no kernel for dtype {dtype}") from None
