#!/usr/bin/env python3
"""The port against golden/torch_golden_768_dpt.npz at full SD2.1 width,
where transformers is not installed.

tests/test_torch_golden_768.py::test_port_golden_768_dpt builds the golden's
DPT head from transformers' DPT pieces (through tests/test_models.py, which
imports jax), so it runs only where both are installed. This script splits
that test in two steps:

    # where transformers and jax are installed (small: the head alone)
    python scripts/golden_768_dpt_torch.py --write_head _archive/dpt_head_768.safetensors
    # anywhere the port runs (full width: many minutes and tens of GB on a CPU)
    python scripts/golden_768_dpt_torch.py --head _archive/dpt_head_768.safetensors \
        [--device cpu|cuda]

The second step writes the golden's weights (seeds 0 and 1, fingerprinted
first) and the head as a DPT-identity checkpoint with the port's writer,
loads it with the port's loader, runs ``build_single_infer`` on the
golden's rgb in f32 (TF32 off on the card) and prints z and pred against the
golden (mean, p99, max) beside the test's bar, pred's mean <= 1e-2. It
exits 1 past the bar.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
GOLDEN_DPT = REPO / "golden" / "torch_golden_768_dpt.npz"
BAR = 1e-2  # tests/test_torch_golden_768.py BAR: pred's mean abs error
DPT_SEED = 2  # scripts/make_torch_golden.py DPT_SEED


def write_head(path: str) -> None:
    """The golden's head, built as tests/test_torch_golden_768.py builds it."""
    sys.path.insert(0, str(REPO / "tests"))
    sys.path.insert(0, str(REPO))
    from test_torch_dpt_head import transformers_dpt_head

    from genpercept_tpu_torch.io.weights import save_safetensors

    head = transformers_dpt_head({"final_act": "identity"}, DPT_SEED)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    save_safetensors(head.state_dict(), path)
    print(json.dumps({"wrote": path, "tensors": len(head.state_dict())}))


def reading(head_path: str, device: str) -> dict:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import chip_smoke
    from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
    from genpercept_tpu_torch.io.weights import load_safetensors
    from genpercept_tpu_torch.models import DPT_IDENTITY

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with np.load(GOLDEN_DPT) as zf:
        golden = {k: zf[k] for k in zf.files}
    unet, vae = chip_smoke.oracle_modules(chip_smoke.SD21_ORACLE)
    fp = {"unet": chip_smoke.fingerprint(unet), "vae": chip_smoke.fingerprint(vae)}
    if not chip_smoke.fingerprint_matches(fp):
        raise SystemExit(f"the golden's weights differ: {fp}")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt = chip_smoke.write_oracle_checkpoint(
            root / "ckpt", unet, vae, chip_smoke.SD21_ORACLE["unet"],
            chip_smoke.SD21_ORACLE["vae"], golden["ctx"])
        del unet, vae
        dpt = chip_smoke.write_dpt_checkpoint(root / "dpt", ckpt, load_safetensors(head_path),
                                              DPT_IDENTITY)
        models = load_genpercept_checkpoint(str(dpt), device=device)
        out = chip_smoke.golden_reading(models, golden, torch.float32)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    return {"op": "port_golden_768_dpt", "device": name, **out, "bar": BAR}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--write_head", default=None, metavar="PATH")
    p.add_argument("--head", default=None, metavar="PATH")
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    if args.write_head:
        write_head(args.write_head)
        return
    if not args.head:
        p.error("--head or --write_head")
    rec = reading(args.head, args.device)
    print(json.dumps(rec), flush=True)
    if rec["pred"]["mean"] > BAR:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
