from genpercept_tpu_torch.models.vae import (
    SD21_VAE, AutoencoderKL, VAEConfig, vae_decode, vae_encode)
from genpercept_tpu_torch.models.unet import (
    SD21_UNET, UNet2DConditionModel, UNetConfig, unet_apply)
from genpercept_tpu_torch.models.clip_text import (
    SD21_CLIP_TEXT, CLIPTextConfig, CLIPTextModel, clip_text_apply, empty_prompt_ids)
from genpercept_tpu_torch.models.dpt_head import (
    DPT_ELU, DPT_GENERAL, DPT_IDENTITY, DPTHead, DPTHeadConfig, dpt_head_apply,
    init_dpt_head)
from genpercept_tpu_torch.models.layers import init_params_

__all__ = [
    "SD21_VAE", "AutoencoderKL", "VAEConfig", "vae_decode", "vae_encode",
    "SD21_UNET", "UNet2DConditionModel", "UNetConfig", "unet_apply",
    "SD21_CLIP_TEXT", "CLIPTextConfig", "CLIPTextModel", "clip_text_apply",
    "empty_prompt_ids", "init_params_",
    "DPT_ELU", "DPT_GENERAL", "DPT_IDENTITY", "DPTHead", "DPTHeadConfig", "dpt_head_apply",
    "init_dpt_head",
]
