"""Build and load the package's CUDA kernels (csrc/*.cu) at first CUDA use.

Each source is compiled by its own ``nvcc`` for ``sm_90a``, all at once, so
the build takes about as long as its largest source however many are added,
and the objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library goes into
``csrc/build/`` under a name that carries a hash of the sources, headers
and flags, so an edited source is rebuilt and an unchanged one is loaded as
it is. Nothing here runs at import: the CPU never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last compile, if any


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgenpercept_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of a failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # compile into a private directory, then rename the library: concurrent
    # processes never see a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(_sources(), objs)])
        lib = Path(tmp) / out.name
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, p]
    lib.flash_attn_fwd.restype = i
    lib.flash_attn_fwd_scratch_bytes.argtypes = [i] * 5
    lib.flash_attn_fwd_scratch_bytes.restype = ctypes.c_longlong
    for name in ("flash_attn_fwd_f32_body", "flash_attn_fwd_bf16_body",
                 "flash_attn_fwd_bf16_d512_body", "fused_geglu_ff_f32_body",
                 "fused_geglu_ff_bf16_body", "fused_geglu_ff_bf16_wide_body",
                 "fused_gn_silu_conv3x3_f32_body",
                 "fused_gn_silu_conv3x3_bf16_body", "flash_attn_int8_d64_body",
                 "flash_attn_int8_d512_body",
                 "fused_geglu_ff_int8_body", "quantized_conv3x3_body"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_char_p
    lib.flash_attn_fwd_tiled.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, i, i, p]
    lib.flash_attn_fwd_tiled.restype = i
    for name in ("flash_bf16_softmax", "flash_nomax"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, i, f, i, i, p]
        fn.restype = i
    lib.fused_geglu_ff_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.fused_geglu_ff_fwd.restype = i
    lib.fused_geglu_ff_scratch_bytes.argtypes = [i] * 4
    lib.fused_geglu_ff_scratch_bytes.restype = ctypes.c_longlong
    for name in ("flash_attn_bwd_f32_body", "flash_attn_bwd_bf16_body",
                 "flash_attn_bwd_bf16_d512_body"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_char_p
    lib.flash_attn_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, i, p]
    lib.flash_attn_bwd_dq.restype = i
    lib.flash_attn_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, i, p]
    lib.flash_attn_bwd_dkv.restype = i
    lib.flash_attn_int8.argtypes = [p] * 8 + [i] * 5 + [f, i, p]
    lib.flash_attn_int8.restype = i
    lib.flash_attn_int8_scratch_bytes.argtypes = [i] * 6
    lib.flash_attn_int8_scratch_bytes.restype = ctypes.c_longlong
    lib.fused_geglu_ff_int8.argtypes = [p] * 16 + [i] * 4 + [p]
    lib.fused_geglu_ff_int8.restype = i
    lib.fused_geglu_ff_int8_scratch_bytes.argtypes = [i] * 3
    lib.fused_geglu_ff_int8_scratch_bytes.restype = ctypes.c_longlong
    lib.fused_gn_silu_conv3x3.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.fused_gn_silu_conv3x3.restype = i
    lib.quantized_conv3x3.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.quantized_conv3x3.restype = i


def load() -> ctypes.CDLL:
    """The kernel library, compiled first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
