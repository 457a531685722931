"""Export a training run's checkpoint in the published safetensors layout.

    python -m genpercept_tpu_torch.cli.export --run_dir RUN \
        --base_checkpoint /path/to/sd21 --name final --output_dir OUT [--device cuda]

Counterpart of ``genpercept_tpu/cli/export.py``, with its flags and
``--device``: reads ``RUN/checkpoint/<name>/state.pt`` (the trainer's dotted
``unet.*``, ``vae.decoder.*`` and ``vae.post_quant_conv.*`` parameters) and
writes ``unet/`` (the base checkpoint's UNet with the trained tensors laid
over it, in the base's dtype, and its config.json), ``vae_decoder/`` and
``vae_post_quant_conv/`` for decoder-trained runs, and the base's
empty_text_embed.npy. The result loads with ``load_genpercept_checkpoint``
(with the base checkpoint as ``base_ckpt_dir`` for the VAE). A LoRA run's
``unet_lora.*`` adapters are merged into the exported UNet (``merge_lora``);
a DPT-head run's ``dpt_head.*`` go to ``dpt_head_identity/`` when the trained
head's final activation is the identity (the run records the head's config),
else ``dpt_head/``, with a config.json of the head's widths. The export is host work: the base's tensors are read on
the CPU whatever ``--device`` says. ``--device`` names the card by default,
as the other CLIs do, so a run without one is refused unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import shutil

_PARTS = ("unet.", "unet_lora.", "dpt_head.", "vae.decoder.", "vae.post_quant_conv.")


def build_parser():
    p = argparse.ArgumentParser(description="Export trained checkpoint (PyTorch)")
    p.add_argument("--run_dir", required=True, help="training output dir")
    p.add_argument("--base_checkpoint", required=True,
                   help="base SD2.1 checkpoint the run started from")
    p.add_argument("--name", default="latest")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--mode", default="depth",
                   help="accepted for parity with the JAX CLI; the loader sniffs the layout")
    p.add_argument("--device", default="cuda",
                   help="the card (default) or cpu; refused when no card is present")
    return p


def _overlay(module, trainable, prefix: str):
    """module's state dict with the trained tensors under ``prefix`` laid
    over it, each cast to the module's dtype."""
    state = {k: v.detach() for k, v in module.state_dict().items()}
    for key, value in trainable.items():
        if key.startswith(prefix):
            name = key[len(prefix):]
            if name not in state:
                raise KeyError(f"{key}: no such tensor in the base checkpoint")
            state[name] = value.to(state[name].dtype)
    return state


def _head_state(state, cfg):
    """The run's trained head as a state dict of a ``cfg`` head, checked
    against that head's keys and shapes."""
    import torch

    from genpercept_tpu_torch.models import DPTHead

    with torch.device("meta"):
        want = DPTHead(cfg).state_dict()
    got = {k[len("dpt_head."):]: v for k, v in state.items() if k.startswith("dpt_head.")}
    bad = sorted(set(got) ^ set(want)) + sorted(
        k for k in set(got) & set(want) if got[k].shape != want[k].shape)
    if bad:
        raise KeyError(f"the run's DPT head does not match a {cfg} head: {bad[:3]}")
    return got


def main(argv=None):
    import torch

    from genpercept_tpu_torch.io.checkpoints import (
        load_genpercept_checkpoint,
        load_train_checkpoint,
    )
    from genpercept_tpu_torch.io.weights import save_safetensors
    from genpercept_tpu_torch.models import DPTHeadConfig
    from genpercept_tpu_torch.train.lora import merge_lora

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device is available; "
                           "pass --device cpu")

    state = load_train_checkpoint(osp.join(args.run_dir, "checkpoint"), args.name,
                                  map_location="cpu")
    trainable = state["trainable"]
    other = sorted(k for k in trainable if not k.startswith(_PARTS))
    if other:
        raise KeyError(f"the run holds parameters no export writes: {other[:3]}")
    models = load_genpercept_checkpoint(args.base_checkpoint, device="cpu")
    unet_state = _overlay(models.unet, trainable, "unet.")
    lora = {k[len("unet_lora."):]: v for k, v in trainable.items() if k.startswith("unet_lora.")}
    if lora:  # the adapters merged into the base, in its dtype
        with torch.no_grad():
            models.unet.load_state_dict(unet_state)
        unet_state = merge_lora(models.unet, lora)
    head = None
    if any(k.startswith("dpt_head.") for k in trainable):
        head_cfg = DPTHeadConfig(**state["dpt_head_cfg"])
        head = ("dpt_head" if head_cfg.final_act == "relu" else "dpt_head_identity",
                _head_state(trainable, head_cfg))

    os.makedirs(osp.join(args.output_dir, "unet"), exist_ok=True)
    save_safetensors(unet_state,
                     osp.join(args.output_dir, "unet/diffusion_pytorch_model.safetensors"))
    src_cfg = osp.join(args.base_checkpoint, "unet/config.json")
    if osp.isfile(src_cfg):
        shutil.copy(src_cfg, osp.join(args.output_dir, "unet/config.json"))

    if head is not None:  # with the widths the loader reads from config.json
        os.makedirs(osp.join(args.output_dir, head[0]), exist_ok=True)
        save_safetensors(head[1], osp.join(args.output_dir, head[0], "model.safetensors"))
        with open(osp.join(args.output_dir, head[0], "config.json"), "w") as f:
            json.dump({"neck_hidden_sizes": list(head_cfg.neck_hidden_sizes),
                       "fusion_hidden_size": head_cfg.fusion_hidden_size,
                       "add_projection": head_cfg.add_projection,
                       "head_in_index": head_cfg.head_in_index}, f)
    if any(k.startswith("vae.") for k in trainable):  # decoder-trained runs
        for sub, part in (("vae_decoder", "decoder"), ("vae_post_quant_conv", "post_quant_conv")):
            os.makedirs(osp.join(args.output_dir, sub), exist_ok=True)
            tensors = _overlay(getattr(models.vae, part), trainable, f"vae.{part}.")
            save_safetensors({f"{part}.{k}": v for k, v in tensors.items()},
                             osp.join(args.output_dir, sub, "model.safetensors"))

    # the VAE and text embedding travel with the base checkpoint; the
    # embedding is copied so the exported directory serves alone with a base
    embed = osp.join(args.base_checkpoint, "empty_text_embed.npy")
    if osp.isfile(embed):
        shutil.copy(embed, osp.join(args.output_dir, "empty_text_embed.npy"))
    logging.info(f"exported to {args.output_dir}")


if __name__ == "__main__":
    main()
