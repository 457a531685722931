"""The port against the committed 768^2 torch goldens, on the CPU.

golden/torch_golden_768.npz, golden/torch_golden_768_dpt.npz and
golden/torch_golden_768_marigold.npz are full SD2.1-width torch f32
forwards of the independent oracles (scripts/make_torch_golden.py; the
marigold one 10 DDIM steps from its stored noise, with conv_in widened to 8
channels). Here the same weights (seeds 0, 1 and, for the head, 2;
fingerprinted first) are written as published-layout checkpoints with the
port's writer, loaded with the port's loader and run through
``build_single_infer`` on the golden's rgb, text embedding and noise. z,
v (where stored) and pred are reported as mean, p99 and max abs error, as
``compare_ours`` reports them; the bar is its own, pred's mean <= 1e-2.

Full width on the CPU takes many minutes and tens of GB, so these tests run
only with RUN_GOLDEN_768=1, and the module is marked slow. The DPT head is
built from transformers' DPT pieces through tests/test_models.py, which
imports jax, so the DPT golden needs the JAX side's environment;
chip_smoke.py holds the card to the first golden.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
from genpercept_tpu_torch.models import DPT_IDENTITY

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not os.environ.get("RUN_GOLDEN_768"),
                       reason="full SD2.1 width at 768^2 on the CPU: many minutes and tens of "
                              "GB; set RUN_GOLDEN_768=1 to run"),
]

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "golden"
BAR = 1e-2  # scripts/make_torch_golden.py BAR: pred's mean abs error


def load_golden(name: str) -> dict:
    with np.load(GOLDEN_DIR / name) as zf:
        return {k: zf[k] for k in zf.files}


def golden_checkpoint(root: Path, ctx: np.ndarray, marigold: bool = False) -> Path:
    unet, vae = chip_smoke.oracle_modules(chip_smoke.SD21_ORACLE)
    fp = {"unet": chip_smoke.fingerprint(unet), "vae": chip_smoke.fingerprint(vae)}
    assert chip_smoke.fingerprint_matches(fp), fp
    if marigold:
        unet = chip_smoke.golden_script_function("_conv_in_8ch")(unet)
    return chip_smoke.write_oracle_checkpoint(root, unet, vae, chip_smoke.SD21_ORACLE["unet"],
                                              chip_smoke.SD21_ORACLE["vae"], ctx,
                                              in_channels=8 if marigold else 4)


def report(name: str, reading: dict) -> None:
    print(json.dumps({"op": f"port_golden_768_{name}", **reading, "bar": BAR}), flush=True)


def test_port_golden_768(tmp_path):
    golden = load_golden("torch_golden_768.npz")
    ckpt = golden_checkpoint(tmp_path / "ckpt", golden["ctx"])
    models = load_genpercept_checkpoint(str(ckpt), device="cpu")
    reading = chip_smoke.golden_reading(models, golden, torch.float32)
    report("genpercept", reading)
    assert reading["pred"]["mean"] <= BAR, reading


def test_port_golden_768_dpt(tmp_path):
    from test_torch_dpt_head import transformers_dpt_head

    golden = load_golden("torch_golden_768_dpt.npz")
    ckpt = golden_checkpoint(tmp_path / "ckpt", golden["ctx"])
    head = transformers_dpt_head({"final_act": "identity"}, 2)  # make_torch_golden DPT_SEED
    dpt = chip_smoke.write_dpt_checkpoint(tmp_path / "dpt", ckpt, head.state_dict(),
                                          DPT_IDENTITY)
    models = load_genpercept_checkpoint(str(dpt), device="cpu")
    reading = chip_smoke.golden_reading(models, golden, torch.float32)
    report("dpt", reading)
    assert reading["pred"]["mean"] <= BAR, reading


def test_port_golden_768_marigold(tmp_path):
    golden = load_golden("torch_golden_768_marigold.npz")
    ckpt = golden_checkpoint(tmp_path / "ckpt", golden["ctx"], marigold=True)
    models = load_genpercept_checkpoint(str(ckpt), device="cpu")
    assert models.unet.cfg.in_channels == 8
    reading, _, _ = chip_smoke.marigold_reading(models, golden, torch.float32)
    report("marigold", reading)
    assert reading["pred"]["mean"] <= BAR, reading
