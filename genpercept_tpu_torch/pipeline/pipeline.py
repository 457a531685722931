"""One-step GenPercept inference on PyTorch.

Counterpart of ``genpercept_tpu/pipeline/pipeline.py`` for the genpercept
arch without a DPT head:
    z_rgb  = 0.18215 * mean(vae.encode(2*rgb - 1))
    v      = unet(z_rgb, t=1, empty_text_embed)
    z_pred = -v                           # beta == 1 scheduler algebra
    pred   = vae.decode(z_pred) -> channel mean -> clip [-1,1] -> (x+1)/2
``GenPerceptPipeline`` adds the resize to the processing resolution, the
resize back and the Spectral colorizing. Its public API keeps the JAX
package's layouts: images (H, W, 3) in, depth (H, W) out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from genpercept_tpu_torch.diffusion import (
    GENPERCEPT_SCHEDULER,
    SchedulerConfig,
    leading_timesteps,
)
from genpercept_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModel,
    UNet2DConditionModel,
    clip_text_apply,
    empty_prompt_ids,
    unet_apply,
    vae_decode,
    vae_encode,
)
from genpercept_tpu_torch.ops.colorize import colorize_depth
from genpercept_tpu_torch.ops.resize import max_res_shape, resize
from genpercept_tpu_torch.pipeline.tasks import TASKS, TaskSpec

# Fields of the JAX package's PipelineConfig that this port does not
# implement yet: each accepts only its default.
_UNPORTED = (
    "arch", "denoising_steps", "ensemble_size", "fix_timesteps", "fused_vae",
    "int8_vae", "int8_margin", "int8_unet", "int8_unet_dense", "int8_unet_ff",
    "int8_refine", "int8_selfcheck", "int8_asymmetric", "int8_gptq",
    "int8_weight_clip", "int8_vae_attn", "int8_exclude",
)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The JAX package's PipelineConfig fields. Fields this port does not
    implement yet raise NotImplementedError when set to another value than
    their default."""

    mode: str = "depth"
    arch: str = "genpercept"
    processing_res: int = 768  # 0 = keep input resolution
    match_input_res: bool = True
    denoising_steps: int = 1
    ensemble_size: int = 1
    fix_timesteps: Optional[int] = None
    resample_method: str = "bilinear"
    dtype: torch.dtype = torch.float32
    fused_vae: bool = False
    int8_vae: bool = False
    int8_margin: float = 1.1
    int8_unet: bool = False
    int8_unet_dense: bool = False
    int8_unet_ff: bool = False
    int8_refine: bool = True
    int8_selfcheck: bool = True
    int8_asymmetric: bool = True
    int8_gptq: bool = False
    int8_weight_clip: bool = False
    int8_vae_attn: bool = False
    int8_exclude: tuple = ("encoder.down_blocks.0.", "encoder.down_blocks.1.",
                           "decoder.up_blocks.3.")

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name in _UNPORTED and getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"PipelineConfig.{f.name}={getattr(self, f.name)!r} is not "
                    f"ported yet (only {f.default!r})")
        if self.task.dpt_head is not None:
            raise NotImplementedError(f"mode {self.mode!r} needs the DPT head")

    @property
    def task(self) -> TaskSpec:
        return TASKS[self.mode]

    @property
    def scheduler(self) -> SchedulerConfig:
        return GENPERCEPT_SCHEDULER


@dataclasses.dataclass
class GenPerceptModels:
    """The modules of one checkpoint, all on one device."""

    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_embed: Optional[torch.Tensor] = None  # precomputed (1, 77, ctx)
    clip: Optional[CLIPTextModel] = None

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @torch.no_grad()
    def get_text_embed(self) -> torch.Tensor:
        """Empty-prompt CLIP embedding, computed once and cached."""
        if self.text_embed is None:
            if self.clip is None:
                raise ValueError("need CLIP weights or a precomputed text_embed")
            self.text_embed = clip_text_apply(
                self.clip, empty_prompt_ids(self.clip.cfg, device=self.device))
        return self.text_embed


def build_single_infer(models: GenPerceptModels, cfg: PipelineConfig):
    """Returns fn(rgb) -> prediction, rgb: (B, H, W, 3) float in [0, 1] at
    the processing resolution (H, W multiples of 8), on the models' device.
    Returns (B, H, W) float32 in [0, 1] (or (B, H, W, 3) for 3-channel
    tasks)."""
    task = cfg.task
    t_host = int(leading_timesteps(cfg.scheduler, cfg.denoising_steps)[0])
    dtype = cfg.dtype

    @torch.no_grad()
    def single_infer(rgb: torch.Tensor) -> torch.Tensor:
        x = rgb.to(dtype).permute(0, 3, 1, 2) * 2.0 - 1.0
        rgb_latent = vae_encode(models.vae, x)
        embed = models.get_text_embed().to(dtype)
        text = embed.expand((rgb.shape[0],) + tuple(embed.shape[-2:]))
        t = torch.tensor(t_host, dtype=torch.long, device=rgb.device)
        v = unet_apply(models.unet, rgb_latent, t, text)
        decoded = vae_decode(models.vae, -v)  # beta == 1: pred_x0 == -v
        if task.channel_mean:
            decoded = decoded.mean(dim=1)
        else:
            decoded = decoded.permute(0, 2, 3, 1)
        pred = decoded.clamp(-1.0, 1.0)
        return ((pred + 1.0) / 2.0).float()

    return single_infer


@dataclasses.dataclass
class GenPerceptOutput:
    pred_np: np.ndarray  # (H, W) or (H, W, 3) float in [0, 1]
    pred_colored: Optional[np.ndarray]  # (H, W, 3) uint8 or None


class GenPerceptPipeline:
    """Host-side orchestration: numpy images in, predictions out.

    ``device`` is where the models run; they are moved there once."""

    def __init__(self, models: GenPerceptModels, cfg: PipelineConfig,
                 device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        models.unet.to(self.device)
        models.vae.to(self.device)
        if models.clip is not None:
            models.clip.to(self.device)
        if models.text_embed is not None:
            models.text_embed = models.text_embed.to(self.device)
        self.models = models
        self.cfg = cfg
        self._infer = build_single_infer(models, cfg)

    def _to_tensor(self, image: np.ndarray) -> torch.Tensor:
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        return torch.as_tensor(np.asarray(image, np.float32), device=self.device)

    def _resize_back(self, pred: torch.Tensor, hw: tuple) -> torch.Tensor:
        """pred: (1, h, w[, 3]) -> (1, H, W[, 3]) when match_input_res."""
        cfg = self.cfg
        if not cfg.match_input_res or tuple(pred.shape[1:3]) == tuple(hw):
            return pred
        if pred.ndim == 3:
            return resize(pred[..., None], hw, cfg.resample_method)[..., 0]
        return resize(pred, hw, cfg.resample_method)

    def _output(self, pred: torch.Tensor,
                color_map: Optional[str]) -> GenPerceptOutput:
        if color_map == "auto":
            color_map = self.cfg.task.color_map
        colored = None
        if color_map is not None and pred.ndim == 3:
            colored = (colorize_depth(pred[0]) * 255).to(torch.uint8).cpu().numpy()
        return GenPerceptOutput(pred_np=pred[0].cpu().numpy(), pred_colored=colored)

    def __call__(self, image: np.ndarray,
                 color_map: Optional[str] = "auto") -> GenPerceptOutput:
        """image: (H, W, 3) uint8 or float in [0, 1]."""
        cfg = self.cfg
        h, w = image.shape[:2]
        x = self._to_tensor(image)[None]
        ph, pw = max_res_shape(h, w, cfg.processing_res) if cfg.processing_res > 0 \
            else (h, w)
        x = resize(x, (ph, pw), cfg.resample_method, antialias=True)
        pred = self._resize_back(self._infer(x), (h, w)).clamp(0.0, 1.0)
        return self._output(pred, color_map)

    def batch(self, images: List[np.ndarray], batch_size: int,
              color_map: Optional[str] = "auto") -> List[GenPerceptOutput]:
        """Batched inference over (H, W, 3) arrays: images are resized to
        the processing resolution, grouped by that shape into batches of
        ``batch_size``, run, then resized back one by one. ``batch_size``
        must be given: no table of batch sizes is measured on a GPU yet."""
        cfg = self.cfg
        if batch_size <= 0:
            raise ValueError("batch_size must be > 0")
        if cfg.processing_res <= 0:
            raise ValueError("batched mode needs a fixed processing_res")
        groups: Dict[tuple, list] = {}
        for idx, image in enumerate(images):
            h, w = image.shape[:2]
            ph, pw = max_res_shape(h, w, cfg.processing_res)
            groups.setdefault((ph, pw), []).append((idx, image, (h, w)))

        results: List[Any] = [None] * len(images)
        for (ph, pw), items in groups.items():
            for start in range(0, len(items), batch_size):
                chunk = items[start:start + batch_size]
                x = torch.cat([
                    resize(self._to_tensor(im)[None], (ph, pw),
                           cfg.resample_method, antialias=True)
                    for _, im, _ in chunk])
                preds = self._infer(x).clamp(0.0, 1.0)
                for bi, (idx, _, hw) in enumerate(chunk):
                    results[idx] = self._output(
                        self._resize_back(preds[bi:bi + 1], hw), color_map)
        return results
