"""Time a training checkpoint's write: ``torch.save`` with its defaults
against ``io.checkpoints.save_train_checkpoint`` (pinned host copies, no
CRC-32 of each record), on a state shaped as a full-width run's (the UNet's
865 M f32 parameters and their two Adam moments, in 686 tensors), and check
that the port's file loads back equal.

    python3 scripts/time_checkpoint_save.py [--reps 2] [--device cuda]

Runs on the card unless ``--device cpu`` is given (then at ``--params``'
size, small by default there). Prints one JSON line of seconds per write,
in the order parent-style, port, port, parent-style for each repetition.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from genpercept_tpu_torch.io.checkpoints import load_train_checkpoint, save_train_checkpoint  # noqa: E402

N_TENSORS = 686


def make_state(params: int, device: str) -> dict:
    g = torch.Generator(device=device).manual_seed(0)
    size = params // N_TENSORS

    def draw(positive=False):
        return (torch.rand if positive else torch.randn)(size, device=device, generator=g)

    return {"trainable": {f"p{i}": draw() for i in range(N_TENSORS)},
            "opt_state": {"state": {i: {"mu": draw(), "nu": draw(True)}
                                    for i in range(N_TENSORS)}, "count": 1},
            "counters": {"effective_iter": 1}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", type=int, default=None,
                    help="parameters (default: 865e6 on the card, 2e6 on the CPU)")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("time_checkpoint_save: no card (pass --device cpu)")
    params = args.params or (865_000_000 if args.device == "cuda" else 2_000_000)
    state = make_state(params, args.device)
    if args.device == "cuda":
        torch.cuda.synchronize()
    tmp = Path(tempfile.mkdtemp())
    times: dict = {"torch_save_defaults": [], "save_train_checkpoint": []}
    try:
        for _ in range(args.reps):
            for kind in ("torch_save_defaults", "save_train_checkpoint", "save_train_checkpoint",
                         "torch_save_defaults"):
                t0 = time.perf_counter()
                if kind == "torch_save_defaults":
                    torch.save(state, tmp / "plain.pt")
                else:
                    save_train_checkpoint(str(tmp), state, "final")
                times[kind].append(time.perf_counter() - t0)
                (tmp / "plain.pt").unlink(missing_ok=True)
                if kind == "save_train_checkpoint" and not (tmp / "checked").exists():
                    back = load_train_checkpoint(str(tmp), "final", map_location="cpu")
                    equal = all(torch.equal(back["trainable"][k], v.cpu())
                                for k, v in state["trainable"].items()) and all(
                        torch.equal(back["opt_state"]["state"][i][m], st[m].cpu())
                        for i, st in state["opt_state"]["state"].items() for m in ("mu", "nu"))
                    del back
                    if not equal:
                        raise SystemExit("time_checkpoint_save: the written state differs")
                    (tmp / "checked").touch()
                shutil.rmtree(tmp / "final", ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gb = sum(t.numel() * t.element_size() for t in state["trainable"].values()) * 3 / 1e9
    card = None
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True
                              ).stdout.strip()
    print(json.dumps({"device": args.device, "card": card, "state_gb": gb,
                      "seconds": times, "loaded_back_equal": True,
                      "host_cpus": os.cpu_count()}))


if __name__ == "__main__":
    main()
