"""Published inference checkpoints, and training checkpoints.

Counterpart of ``genpercept_tpu/io/checkpoints.py``.

Inference checkpoints are directories of torch safetensors in the published
GenPercept/SD2.1 layout, sniffed as the JAX loader sniffs them:

  unet/diffusion_pytorch_model.safetensors   (conv_out dropped when a DPT
                                              head is present)
  vae/diffusion_pytorch_model.safetensors
  text_encoder/model.safetensors
  dpt_head/ | dpt_head_identity/ model.safetensors [config.json]
  vae_decoder/, vae_post_quant_conv/         (decoder-finetuned checkpoints)
  tokenizer/vocab.json, merges.txt
  empty_text_embed.npy

Training checkpoints (the JAX package writes orbax directories): here
``out_dir/name/state.pt`` holds the state dict (trainable parameters,
optimizer state, counters), with the reference's ``_old_`` backup rotation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import shutil
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from genpercept_tpu_torch.io.weights import load_safetensors
from genpercept_tpu_torch.models import (
    DPT_GENERAL,
    DPT_IDENTITY,
    SD21_UNET,
    SD21_VAE,
    AutoencoderKL,
    CLIPTextModel,
    DPTHead,
    UNet2DConditionModel,
    UNetConfig,
    VAEConfig,
)
from genpercept_tpu_torch.utils.tokenizer import load_tokenizer

_FILE = "state.pt"
_UNET_HEAD_DROP = ("conv_norm_out.", "conv_out.")
# transformers' DPT fusion layer 0 carries a residual unit it never runs;
# published heads keep its weights, no module here holds them
_DPT_UNUSED = "neck.fusion_stage.layers.0.residual_layer1."


def _find_safetensors(subdir: str) -> Optional[str]:
    if not osp.isdir(subdir):
        return None
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        p = osp.join(subdir, name)
        if osp.isfile(p):
            return p
    cands = sorted(f for f in os.listdir(subdir) if f.endswith(".safetensors"))
    return osp.join(subdir, cands[0]) if cands else None


def _read_json(path: str) -> Optional[dict]:
    if not osp.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _unet_config_from_json(subdir: str, with_conv_out: bool) -> UNetConfig:
    """A UNetConfig from a diffusers config.json where there is one."""
    c = _read_json(osp.join(subdir, "config.json"))
    if c is None:
        return dataclasses.replace(SD21_UNET, with_conv_out=with_conv_out)
    chans = tuple(c.get("block_out_channels", SD21_UNET.block_out_channels))
    heads = c.get("num_attention_heads") or c.get("attention_head_dim", [5, 10, 20, 20])
    if isinstance(heads, int):
        heads = [heads] * len(chans)
    down_types = c.get("down_block_types", ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
    return UNetConfig(
        in_channels=c.get("in_channels", 4),
        out_channels=c.get("out_channels", 4),
        block_out_channels=chans,
        layers_per_block=c.get("layers_per_block", 2),
        down_block_has_attn=tuple("CrossAttn" in t for t in down_types),
        attention_heads=tuple(heads),
        cross_attention_dim=c.get("cross_attention_dim", 1024),
        norm_eps=c.get("norm_eps", 1e-5),
        with_conv_out=with_conv_out,
    )


def _vae_config_from_json(subdir: str) -> VAEConfig:
    c = _read_json(osp.join(subdir, "config.json"))
    if c is None:
        return SD21_VAE
    return VAEConfig(
        in_channels=c.get("in_channels", 3),
        out_channels=c.get("out_channels", 3),
        latent_channels=c.get("latent_channels", 4),
        block_out_channels=tuple(c.get("block_out_channels", SD21_VAE.block_out_channels)),
        layers_per_block=c.get("layers_per_block", 2),
        norm_num_groups=c.get("norm_num_groups", 32),
        scaling_factor=c.get("scaling_factor", 0.18215),
    )


def _without(state: Mapping[str, torch.Tensor], prefixes) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state.items() if not k.startswith(tuple(prefixes))}


def _submodule_state(state: Mapping[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
    """A file's keys relative to submodule ``name`` (an override's
    ``decoder.``, the text encoder's ``text_model.``): with or without the
    ``name.`` prefix, as the JAX loader takes them."""
    prefix = name + "."
    if any(k.startswith(prefix) for k in state):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    return dict(state)


def _materialize(make: Callable[[], nn.Module], device: torch.device,
                 dtype: torch.dtype) -> nn.Module:
    """An uninitialised module of ``dtype`` on ``device``, built without
    running any initializer (the weights come from a file)."""
    with torch.device("meta"):
        module = make()
    return module.to(dtype).to_empty(device=device).eval()


def load_genpercept_checkpoint(
    ckpt_dir: str,
    dtype: torch.dtype = torch.float32,
    base_ckpt_dir: Optional[str] = None,
    device: torch.device | str = "cuda",
):
    """Sniff a checkpoint directory and build ``GenPerceptModels`` in
    ``dtype`` on ``device`` (the card unless the caller asks for the CPU).

    Layouts, as ``genpercept_tpu/io/checkpoints.py::load_genpercept_checkpoint``
    takes them:
      - the diffusers layout (unet/ vae/ [text_encoder/ dpt_head*/ ...]);
      - a unet-only directory (the safetensors directly in ``ckpt_dir``):
        vae, text encoder and the unet's config.json come from
        ``base_ckpt_dir`` (default: the BASE_CKPT_DIR environment variable),
        and dpt_head*/ and the VAE overrides are looked for in the parent;
      - no unet at all (frozen-unet recipes): the base checkpoint's unet.
    A dpt_head_identity/ (identity final activation) is taken before a
    dpt_head/ (ReLU); either one drops the UNet's conv_norm_out/conv_out,
    and its config.json sets the head's widths. vae_decoder/ and
    vae_post_quant_conv/ replace those parts of the VAE.

    Each tensor is read from a memory map of its file and copied once, into
    its module. The tokenizer (tokenizer/vocab.json and merges.txt, from
    ``ckpt_dir`` or else the base checkpoint) is attached where there is
    one: ``GenPerceptModels.encode_prompt`` needs it for any prompt but the
    empty one, whose embedding comes from empty_text_embed.npy or the text
    encoder."""
    from genpercept_tpu_torch.pipeline import GenPerceptModels

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_genpercept_checkpoint loads onto the card by default and no "
                           "CUDA device is available; pass device=\"cpu\"")
    base_ckpt_dir = base_ckpt_dir or os.environ.get("BASE_CKPT_DIR")

    unet_dir = osp.join(ckpt_dir, "unet")
    unet_path = _find_safetensors(unet_dir)
    unet_only = False
    if unet_path is None:
        unet_path = _find_safetensors(ckpt_dir)
        if unet_path:
            unet_dir, unet_only = ckpt_dir, True
    if unet_path is None and base_ckpt_dir:
        unet_dir = osp.join(base_ckpt_dir, "unet")
        unet_path = _find_safetensors(unet_dir)
    if unet_path is None:
        raise FileNotFoundError(
            f"no unet safetensors under {ckpt_dir}[/unet]"
            + ("" if base_ckpt_dir else
               " (for unet-only checkpoints, pass base_ckpt_dir= or set "
               "BASE_CKPT_DIR to the SD2.1 base checkpoint)"))

    # heads and overrides sit next to the unet subdir, or in the parent of
    # a unet-only directory
    roots = [ckpt_dir] + ([osp.dirname(osp.abspath(ckpt_dir))] if unet_only else [])
    head_dir, dpt_cfg = None, DPT_GENERAL
    for root in roots:
        if osp.isdir(osp.join(root, "dpt_head_identity")):
            head_dir, dpt_cfg = osp.join(root, "dpt_head_identity"), DPT_IDENTITY
            break
        if osp.isdir(osp.join(root, "dpt_head")):
            head_dir = osp.join(root, "dpt_head")
            break

    cfg_dir = unet_dir
    if not osp.isfile(osp.join(cfg_dir, "config.json")) and base_ckpt_dir:
        cfg_dir = osp.join(base_ckpt_dir, "unet")
    unet_cfg = _unet_config_from_json(cfg_dir, with_conv_out=head_dir is None)
    unet = _materialize(lambda: UNet2DConditionModel(unet_cfg), device, dtype)
    unet_state = load_safetensors(unet_path)
    if head_dir is not None:
        unet_state = _without(unet_state, _UNET_HEAD_DROP)
    unet.load_state_dict(unet_state)

    vae_dir = osp.join(ckpt_dir, "vae")
    vae_path = _find_safetensors(vae_dir)
    if vae_path is None and base_ckpt_dir:
        vae_dir = osp.join(base_ckpt_dir, "vae")
        vae_path = _find_safetensors(vae_dir)
    if vae_path is None:
        raise FileNotFoundError(
            f"no vae safetensors under {ckpt_dir}/vae"
            + ("" if base_ckpt_dir else
               " (unet-only checkpoints need the SD2.1 vae: pass base_ckpt_dir= "
               "or set BASE_CKPT_DIR)"))
    vae_cfg = _vae_config_from_json(vae_dir)
    vae = _materialize(lambda: AutoencoderKL(vae_cfg), device, dtype)
    vae.load_state_dict(load_safetensors(vae_path))
    for root in roots:
        dec_path = _find_safetensors(osp.join(root, "vae_decoder"))
        if dec_path:
            vae.decoder.load_state_dict(_submodule_state(load_safetensors(dec_path), "decoder"))
        pq_path = _find_safetensors(osp.join(root, "vae_post_quant_conv"))
        if pq_path:
            vae.post_quant_conv.load_state_dict(
                _submodule_state(load_safetensors(pq_path), "post_quant_conv"))
        if dec_path or pq_path:
            break

    dpt_head = None
    if head_dir is not None:
        hc = _read_json(osp.join(head_dir, "config.json"))
        if hc is not None:
            dpt_cfg = dataclasses.replace(
                dpt_cfg,
                neck_hidden_sizes=tuple(hc.get("neck_hidden_sizes", dpt_cfg.neck_hidden_sizes)),
                fusion_hidden_size=hc.get("fusion_hidden_size", dpt_cfg.fusion_hidden_size),
                add_projection=hc.get("add_projection", dpt_cfg.add_projection),
                head_in_index=hc.get("head_in_index", dpt_cfg.head_in_index))
        dpt_head = _materialize(lambda: DPTHead(dpt_cfg), device, dtype)
        dpt_head.load_state_dict(
            _without(load_safetensors(_find_safetensors(head_dir)), (_DPT_UNUSED,)))

    clip = None
    te_path = _find_safetensors(osp.join(ckpt_dir, "text_encoder"))
    if te_path is None and base_ckpt_dir:
        te_path = _find_safetensors(osp.join(base_ckpt_dir, "text_encoder"))
    if te_path:
        clip = _materialize(CLIPTextModel, device, dtype)
        clip.load_state_dict(_submodule_state(load_safetensors(te_path), "text_model"))
    text_embed = None
    embed_path = osp.join(ckpt_dir, "empty_text_embed.npy")
    if osp.isfile(embed_path):
        text_embed = torch.as_tensor(np.load(embed_path), dtype=dtype, device=device)

    tokenizer = load_tokenizer(ckpt_dir) or (load_tokenizer(base_ckpt_dir) if base_ckpt_dir
                                             else None)
    return GenPerceptModels(unet=unet, vae=vae, text_embed=text_embed, clip=clip,
                            dpt_head=dpt_head, tokenizer=tokenizer)


def save_train_checkpoint(out_dir: str, state: Dict[str, Any], name: str = "latest") -> str:
    """Save ``state`` under out_dir/name; an existing checkpoint of that name
    is kept as ``_old_<name>`` until the new one is on disk. ``torch.save``
    copies card tensors through pinned host memory and writes no CRC-32 of
    each record (``torch.load`` reads the file as it reads any other): the
    defaults' pageable copies and checksums took most of a full-width
    state's write (``scripts/time_checkpoint_save.py`` times both)."""
    from torch.utils.serialization import config

    os.makedirs(out_dir, exist_ok=True)
    path = osp.abspath(osp.join(out_dir, name))
    backup = osp.join(out_dir, f"_old_{name}")
    if osp.exists(path):
        if osp.exists(backup):
            shutil.rmtree(backup)
        os.rename(path, backup)
    os.makedirs(path)
    with config.patch({"save.compute_crc32": False, "save.use_pinned_memory_for_d2h": True}):
        torch.save(state, osp.join(path, _FILE))
    if osp.exists(backup):
        shutil.rmtree(backup)
    return path


def load_train_checkpoint(out_dir: str, name: str = "latest", map_location=None):
    """The state dict saved by ``save_train_checkpoint`` (tensors only, so
    it loads with ``weights_only=True``), from a memory map of the file: a
    tensor is read when it is used."""
    return torch.load(osp.join(out_dir, name, _FILE), map_location=map_location,
                      weights_only=True, mmap=True)
