"""Edited copies of a kernel source, each built into a library of its own.

The tuning scripts (scripts/tune_k1.py, scripts/tune_k34.py) time a
kernel's variants beside the shipped one in one process: each variant is a
csrc source with one edit (a tiling, a split form), written with its own
common.cuh into a directory of its own and compiled by nvcc with the
package's flags (_build.NVCC_FLAGS) plus ``-Xptxas -v``. All variants build
at once, one nvcc each. Needs nvcc, so it runs on the card's machine.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from genpercept_tpu_torch import _build  # noqa: E402
from kernel_resources import ptxas_info  # noqa: E402


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _build_one(name: str, source: str, src: str, hdr: str, out: Path):
    work = out / name
    work.mkdir()
    (work / "common.cuh").write_text(hdr)
    (work / source).write_text(src)
    lib = work / "lib.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                          "-o", str(lib), str(work / source)], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{res.stderr[-3000:]}")
    return ctypes.CDLL(str(lib)), ptxas_info(res.stdout + res.stderr)


def build_variants(source: str, todo: dict[str, tuple[str, str]],
                   out: Path) -> dict[str, tuple[ctypes.CDLL, dict[str, dict]]]:
    """{name: (source text, common.cuh text)} -> {name: (library, ptxas
    resources by mangled kernel name)}, built in parallel under ``out``;
    ``source`` is the file name the text is compiled as."""
    with ThreadPoolExecutor(len(todo)) as ex:
        built = ex.map(lambda kv: _build_one(kv[0], source, *kv[1], out), todo.items())
        return dict(zip(todo, built))
