"""One-step GenPercept inference on PyTorch.

Counterpart of ``genpercept_tpu/pipeline/pipeline.py`` for the genpercept
arch without a DPT head:
    z_rgb  = 0.18215 * mean(vae.encode(2*rgb - 1))
    v      = unet(z_rgb, t=1, empty_text_embed)
    z_pred = -v                           # beta == 1 scheduler algebra
    pred   = vae.decode(z_pred) -> channel mean -> clip [-1,1] -> (x+1)/2
``GenPerceptPipeline`` adds the resize to the processing resolution, the
resize back and the Spectral colorizing, and W8A8 int8 inference: the first
batch calibrates, every later one runs int8 (``ops/quant.py``). Its public
API keeps the JAX package's layouts: images (H, W, 3) in, depth (H, W) out.
It runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
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
from genpercept_tpu_torch.ops import quant
from genpercept_tpu_torch.ops.attention import attention_projection
from genpercept_tpu_torch.ops.colorize import colorize_depth
from genpercept_tpu_torch.ops.resize import max_res_shape, resize
from genpercept_tpu_torch.pipeline.tasks import TASKS, TaskSpec

# Fields of the JAX package's PipelineConfig that this port does not
# implement yet: each accepts only its default.
_UNPORTED = (
    "arch", "denoising_steps", "ensemble_size", "fix_timesteps", "fused_vae",
    "int8_gptq",
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
        if self.int8_unet and not self.int8_vae:
            raise AssertionError("int8_unet rides the int8_vae calibration")
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


def _int8_hooks(cfg: PipelineConfig, quant_mode: Optional[str], vq: Optional[Dict]):
    """The hooks of one forward (JAX build_single_infer :288-358):
    (enc_conv, dec_conv, enc_dense, dec_dense, unet_conv, unet_dense,
    int8 attention, stats) with stats the calibration record or None."""
    hooks = dict(enc=None, dec=None, enc_dense=None, dec_dense=None, u_conv=None,
                 u_dense=None, vattn=False, stats=None)
    if quant_mode is None:
        return hooks
    if quant_mode == "calibrate":
        refine = cfg.int8_refine
        stats = {"enc": {}, "dec": {}, "unet": {}}
        corr = {"enc": {}, "dec": {}, "unet": {}} if refine else None
        kw = dict(clip_search=refine, margin=1.0 if refine else cfg.int8_margin,
                  weight_clip=cfg.int8_weight_clip, asymmetric=cfg.int8_asymmetric)

        def calib(group, make):
            return make(stats[group], corr=corr[group] if refine else None, **kw)

        hooks.update(enc=calib("enc", quant.make_calib_conv_fn),
                     dec=calib("dec", quant.make_calib_conv_fn))
        if cfg.int8_vae_attn:
            hooks.update(enc_dense=calib("enc", quant.make_calib_dense_fn),
                         dec_dense=calib("dec", quant.make_calib_dense_fn))
        if cfg.int8_unet:
            hooks["u_conv"] = calib("unet", quant.make_calib_conv_fn)
            if cfg.int8_unet_dense:
                hooks["u_dense"] = calib("unet", quant.make_calib_dense_fn)
            elif cfg.int8_unet_ff:
                # stats for the GEGLU feed-forward matmuls only; the attention
                # projections run full precision, uncalibrated
                inner_fn = calib("unet", quant.make_calib_dense_fn)

                def u_dense(name, weight, bias, x):
                    if ".ff.net." in name:
                        return inner_fn(name, weight, bias, x)
                    return attention_projection(x, weight, bias)

                hooks["u_dense"] = u_dense
        hooks["stats"] = dict(stats, **({"corr": corr} if refine else {}))
        return hooks
    if quant_mode == "quant":
        hooks.update(enc=quant.make_quant_conv_fn(vq["enc"]),
                     dec=quant.make_quant_conv_fn(vq["dec"]))
        if cfg.int8_vae_attn:
            hooks.update(vattn=True, enc_dense=quant.make_quant_dense_fn(vq["enc"]),
                         dec_dense=quant.make_quant_dense_fn(vq["dec"]))
        if cfg.int8_unet:
            hooks["u_conv"] = quant.make_quant_conv_fn(vq["unet"])
            if cfg.int8_unet_dense or cfg.int8_unet_ff:
                # with int8_unet_ff the tree holds only .ff.net. paths; the
                # feed-forward fuses a fully quantized FF through .qtree
                hooks["u_dense"] = quant.make_quant_dense_fn(vq["unet"])
        return hooks
    raise NotImplementedError(f"quant_mode {quant_mode!r} is not ported")


def build_single_infer(models: GenPerceptModels, cfg: PipelineConfig,
                       quant_mode: Optional[str] = None):
    """Returns fn(rgb, vae_quant=None) -> prediction, rgb: (B, H, W, 3) float
    in [0, 1] at the processing resolution (H, W multiples of 8), on the
    models' device. Returns (B, H, W) float32 in [0, 1] (or (B, H, W, 3) for
    3-channel tasks).

    quant_mode (W8A8, ops/quant.py):
      None        full precision;
      "calibrate" full precision, returning (pred, stats) with stats
                  {"enc"|"dec"|"unet": {path: stat}} and, with int8_refine,
                  "corr" (the bias-correction residuals);
      "quant"     the calibrated layers in int8, from ``vae_quant`` =
                  {"enc"|"dec"[|"unet"]: {path: QConv|QDense}}.
    The JAX package's diagnostic "fake:" modes are not ported."""
    task = cfg.task
    t_host = int(leading_timesteps(cfg.scheduler, cfg.denoising_steps)[0])
    dtype = cfg.dtype

    def attn_kept(path):
        return not any(e in path for e in cfg.int8_exclude)

    @torch.no_grad()
    def single_infer(rgb: torch.Tensor, vae_quant: Optional[Dict] = None):
        hk = _int8_hooks(cfg, quant_mode, vae_quant)
        x = rgb.to(dtype).permute(0, 3, 1, 2) * 2.0 - 1.0
        rgb_latent = vae_encode(
            models.vae, x, conv_fn=hk["enc"], dense_fn=hk["enc_dense"],
            attn_int8=hk["vattn"] and attn_kept("encoder.mid_block.attentions.0"))
        embed = models.get_text_embed().to(dtype)
        text = embed.expand((rgb.shape[0],) + tuple(embed.shape[-2:]))
        t = torch.tensor(t_host, dtype=torch.long, device=rgb.device)
        v = unet_apply(models.unet, rgb_latent, t, text, conv_fn=hk["u_conv"],
                       dense_fn=hk["u_dense"])
        decoded = vae_decode(  # beta == 1: pred_x0 == -v
            models.vae, -v, conv_fn=hk["dec"], dense_fn=hk["dec_dense"],
            attn_int8=hk["vattn"] and attn_kept("decoder.mid_block.attentions.0"))
        if task.channel_mean:
            decoded = decoded.mean(dim=1)
        else:
            decoded = decoded.permute(0, 2, 3, 1)
        pred = ((decoded.clamp(-1.0, 1.0) + 1.0) / 2.0).float()
        if hk["stats"] is not None:
            return pred, hk["stats"]
        return pred

    return single_infer


@dataclasses.dataclass
class GenPerceptOutput:
    pred_np: np.ndarray  # (H, W) or (H, W, 3) float in [0, 1]
    pred_colored: Optional[np.ndarray]  # (H, W, 3) uint8 or None


class GenPerceptPipeline:
    """Host-side orchestration: numpy images in, predictions out.

    ``device`` is where the models run ("cuda" unless the caller passes
    another); they are moved there once. Without a card, the default raises:
    the pipeline never falls back to the CPU unasked.

    With ``cfg.int8_vae`` the first batch runs the full-precision
    calibration pass in chunks (returning its prediction) and builds the
    int8 tree that every later batch runs; ``save_calibration`` /
    ``load_calibration`` keep that tree in the JAX package's file format."""

    def __init__(self, models: GenPerceptModels, cfg: PipelineConfig,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GenPerceptPipeline runs on the card by default and no CUDA "
                               "device is available; pass device=\"cpu\" to run on the CPU")
        models.unet.to(self.device)
        models.vae.to(self.device)
        if models.clip is not None:
            models.clip.to(self.device)
        if models.text_embed is not None:
            models.text_embed = models.text_embed.to(self.device)
        self.models = models
        self.cfg = cfg
        self._infer = build_single_infer(models, cfg, "quant" if cfg.int8_vae else None)
        self._calib_infer = build_single_infer(models, cfg, "calibrate") if cfg.int8_vae \
            else None
        self.vae_quant: Optional[Dict[str, Dict]] = None
        self.int8_mean_dev: Optional[float] = None  # set by the post-calibration check

    @property
    def calibrated(self) -> bool:
        return not self.cfg.int8_vae or self.vae_quant is not None

    @torch.no_grad()
    def _calibrate(self, x: torch.Tensor) -> torch.Tensor:
        """The calibration pass over x (JAX GenPerceptPipeline._run :507-568):
        stats in chunks of 2 images with asymmetric stats, else 4; the int8
        trees of the kept layers, bias-corrected; the self-check. Returns
        the full-precision prediction."""
        cfg = self.cfg
        chunk = 2 if cfg.int8_asymmetric else 4
        pred, stats = quant.calibrate_chunked(self._calib_infer, x, chunk=chunk)
        m = 1.0 if cfg.int8_refine else cfg.int8_margin

        def keep(st):
            return {k: v for k, v in st.items() if not any(e in k for e in cfg.int8_exclude)}

        wc = cfg.int8_weight_clip
        vq = {g: quant.quantize_from_stats(self.models.vae, keep(stats[g]), m, weight_clip=wc)
              for g in ("enc", "dec")}
        if cfg.int8_unet:
            vq["unet"] = quant.quantize_from_stats(self.models.unet, keep(stats["unet"]), m,
                                                   asymmetric_downsample=False, weight_clip=wc)
        if cfg.int8_refine:
            vq = {k: quant.apply_bias_correction(v, stats["corr"][k]) for k, v in vq.items()}
        self.vae_quant = vq
        if cfg.int8_selfcheck:
            # one quantized forward on the calibration batch against the
            # full-precision prediction in hand
            q_pred = self._infer(x, vq)
            self.int8_mean_dev = float((q_pred.float() - pred.float()).abs().mean())
            if self.int8_mean_dev > 1e-2:
                logging.getLogger(__name__).warning(
                    "int8 self-check: mean deviation %.3e vs full precision on the "
                    "calibration batch exceeds the 1e-2 bar; consider a shallower "
                    "int8_exclude placement (max fidelity: ('encoder.', "
                    "'decoder.up_blocks.3.'))", self.int8_mean_dev)
        return pred

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        """One device batch: the calibration pass first if int8 is set and
        not yet calibrated, else the (quantized) forward."""
        if not self.calibrated:
            return self._calibrate(x)
        return self._infer(x, self.vae_quant)

    def save_calibration(self, path) -> None:
        """Write the int8 tree built by the first batch (JAX's .npz layout)."""
        if not (self.cfg.int8_vae and self.calibrated):
            raise RuntimeError("run at least one batch with int8_vae=True before saving")
        quant.save_calibration(path, self.vae_quant)

    def load_calibration(self, path) -> None:
        """Load an int8 tree (written by either package); skips calibration."""
        if not self.cfg.int8_vae:
            raise RuntimeError("calibration needs int8_vae=True")
        self.vae_quant = quant.load_calibration(path, self.device)

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
        pred = self._resize_back(self._run(x), (h, w)).clamp(0.0, 1.0)
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
                preds = self._run(x).clamp(0.0, 1.0)
                for bi, (idx, _, hw) in enumerate(chunk):
                    results[idx] = self._output(
                        self._resize_back(preds[bi:bi + 1], hw), color_map)
        return results
