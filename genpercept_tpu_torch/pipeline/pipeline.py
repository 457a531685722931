"""GenPercept inference on PyTorch.

Counterpart of ``genpercept_tpu/pipeline/pipeline.py``. The genpercept arch
is one step:
    z_rgb  = 0.18215 * mean(vae.encode(2*rgb - 1))
    v      = unet(z_rgb, t=1, empty_text_embed)
    z_pred = -v                           # beta == 1 scheduler algebra
    pred   = vae.decode(z_pred) -> channel mean -> clip [-1,1] -> (x+1)/2
and, for a checkpoint with a DPT head, the UNet's up-block features at t=1
through the head and a per-image min-max instead of the decode. The
rgb_blending and marigold archs run DDIM over the SD2.1 betas from z_rgb
(rgb_blending) or from Gaussian noise with z_rgb concatenated to the UNet's
input (marigold, 8 channels), and decode the last step's pred_x0.
``GenPerceptPipeline`` adds the resize to the processing resolution, the
noise draw and test-time ensembling (``pipeline/ensemble.py``), the resize
back and the Spectral colorizing, W8A8 int8 inference: the first batch
calibrates, every later one runs int8 (``ops/quant.py``; GPTQ rounding with
``int8_gptq``), the fused VAE resblocks (``fused_vae``,
``ops/fused_conv.py``), and data parallelism over several devices (a
replica of the models on each, every batch split between them). Its public
API keeps the JAX package's layouts: images (H, W, 3) in, depth (H, W) out,
noise (B, h/8, w/8, 4). It runs on the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from genpercept_tpu_torch.diffusion import (
    GENPERCEPT_SCHEDULER,
    SchedulerConfig,
    ddim_step,
    leading_timesteps,
    make_scheduler,
)
from genpercept_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModel,
    DPTHead,
    DPTHeadConfig,
    UNet2DConditionModel,
    clip_text_apply,
    dpt_head_apply,
    empty_prompt_ids,
    unet_apply,
    vae_decode,
    vae_encode,
)
from genpercept_tpu_torch.ops import quant
from genpercept_tpu_torch.ops.attention import attention_projection
from genpercept_tpu_torch.ops.colorize import colorize_depth
from genpercept_tpu_torch.ops.resize import max_res_shape, resize
from genpercept_tpu_torch.pipeline.ensemble import ensemble_predictions
from genpercept_tpu_torch.pipeline.tasks import TASKS, TaskSpec
from genpercept_tpu_torch.utils.batchsize import find_batch_size
from genpercept_tpu_torch.utils.tokenizer import CLIPTokenizer


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The JAX package's PipelineConfig fields. int8_gptq rounds the VAE's
    int8 weights by GPTQ error compensation against each layer's calibrated
    input Gram (``ops/quant.py::gptq_round``): the same int8 tree format,
    work at calibration time only."""

    mode: str = "depth"
    arch: str = "genpercept"  # genpercept | rgb_blending | marigold
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
        if self.arch == "genpercept" and (self.denoising_steps, self.ensemble_size) != (1, 1):
            # one step, no ensemble (reference run.py:209-211)
            raise AssertionError("the genpercept arch runs one step and no ensemble")
        if self.int8_unet and not self.int8_vae:
            raise AssertionError("int8_unet rides the int8_vae calibration")

    @property
    def task(self) -> TaskSpec:
        return TASKS[self.mode]

    @property
    def scheduler(self) -> SchedulerConfig:
        if self.arch == "genpercept":
            return GENPERCEPT_SCHEDULER
        return SchedulerConfig()  # the SD2.1 betas of the DDIM archs


@dataclasses.dataclass
class GenPerceptModels:
    """The modules of one checkpoint, all on one device."""

    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_embed: Optional[torch.Tensor] = None  # precomputed (1, 77, ctx)
    clip: Optional[CLIPTextModel] = None
    dpt_head: Optional[DPTHead] = None  # with it, the UNet has no conv_out
    tokenizer: Optional[CLIPTokenizer] = None
    # LoRA adapters of the UNet's attention projections while training them
    # (train/lora.py); the pipeline runs the base UNet, as the JAX trainer's
    # validation does, and cli/export.py merges them
    unet_lora: Optional[Dict[str, torch.Tensor]] = None

    @property
    def dpt_cfg(self) -> Optional[DPTHeadConfig]:
        return None if self.dpt_head is None else self.dpt_head.cfg

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @torch.no_grad()
    def get_text_embed(self) -> torch.Tensor:
        """Empty-prompt CLIP embedding, computed once and cached."""
        if self.text_embed is None:
            if self.clip is None:
                raise ValueError("need CLIP weights or a precomputed text_embed")
            self.text_embed = clip_text_apply(self.clip, empty_prompt_ids(
                self.clip.cfg, device=next(self.clip.parameters()).device))
        return self.text_embed

    @torch.no_grad()
    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """CLIP embedding (1, 77, ctx) of a prompt (reference infer.py
        --prompt), on the CLIP weights' device. The empty prompt is the cached
        embedding; any other needs the CLIP weights and the checkpoint's
        tokenizer files."""
        if not prompt:
            return self.get_text_embed()
        if self.clip is None:
            raise ValueError("custom prompts need CLIP weights")
        if self.tokenizer is None:
            raise ValueError("custom prompts need tokenizer files (tokenizer/vocab.json)")
        device = next(self.clip.parameters()).device
        ids = torch.as_tensor(self.tokenizer(prompt), dtype=torch.long, device=device)
        return clip_text_apply(self.clip, ids)


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
        # GPTQ Grams for the VAE's groups only, as the JAX package
        hess = {"enc": {}, "dec": {}} if cfg.int8_gptq else None
        kw = dict(clip_search=refine, margin=1.0 if refine else cfg.int8_margin,
                  weight_clip=cfg.int8_weight_clip, asymmetric=cfg.int8_asymmetric)

        def calib(group, make):
            return make(stats[group], corr=corr[group] if refine else None,
                        hess=hess.get(group) if hess else None, **kw)

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
        hooks["stats"] = dict(stats, **({"corr": corr} if refine else {}),
                              **({"hess": hess} if hess else {}))
        return hooks
    # a group the calibration left empty (the decoder, with a DPT head) may
    # be missing from a tree loaded from a file
    def tree(group):
        return vq.get(group, {})

    if quant_mode == "quant":
        hooks.update(enc=quant.make_quant_conv_fn(tree("enc")),
                     dec=quant.make_quant_conv_fn(tree("dec")))
        if cfg.int8_vae_attn:
            hooks.update(vattn=True, enc_dense=quant.make_quant_dense_fn(tree("enc")),
                         dec_dense=quant.make_quant_dense_fn(tree("dec")))
        if cfg.int8_unet:
            hooks["u_conv"] = quant.make_quant_conv_fn(tree("unet"))
            if cfg.int8_unet_dense or cfg.int8_unet_ff:
                # with int8_unet_ff the tree holds only .ff.net. paths; the
                # feed-forward fuses a fully quantized FF through .qtree
                hooks["u_dense"] = quant.make_quant_dense_fn(tree("unet"))
        return hooks
    if quant_mode.startswith("fake:"):
        # the conv hooks only: no dense hook, no int8 attention
        side = quant_mode.split(":", 1)[1]
        hooks.update(enc=quant.make_fakequant_conv_fn(tree("enc"), side),
                     dec=quant.make_fakequant_conv_fn(tree("dec"), side))
        if cfg.int8_unet:
            hooks["u_conv"] = quant.make_fakequant_conv_fn(tree("unet"), side)
        return hooks
    raise ValueError(f"unknown quant_mode {quant_mode!r}")


def build_single_infer(models: GenPerceptModels, cfg: PipelineConfig,
                       quant_mode: Optional[str] = None):
    """Returns fn(rgb, vae_quant=None, noise=None) -> prediction, rgb:
    (B, H, W, 3) float in [0, 1] at the processing resolution (H, W
    multiples of 8), on the models' device. Returns (B, H, W) float32 in
    [0, 1] (or (B, H, W, 3) for 3-channel tasks).

    The arch picks the denoising: genpercept one UNet pass at the first
    timestep; rgb_blending DDIM from the rgb latent; marigold DDIM from
    ``noise`` (B, H/8, W/8, 4), required, with the rgb latent concatenated
    before it on the UNet's 8 input channels. The timesteps are
    ``cfg.fix_timesteps`` repeated, else the 'leading' spacing. Every UNet
    input and the decode run in ``cfg.dtype``; the DDIM update runs in f32.

    quant_mode (W8A8, ops/quant.py):
      None        full precision;
      "calibrate" full precision, returning (pred, stats) with stats
                  {"enc"|"dec"|"unet": {path: stat}} and, with int8_refine,
                  "corr" (the bias-correction residuals), with int8_gptq
                  "hess" ({"enc"|"dec": {path: Gram}});
      "quant"     the calibrated layers in int8, from ``vae_quant`` =
                  {"enc"|"dec"[|"unet"]: {path: QConv|QDense}};
      "fake:w" | "fake:a" | "fake:wa"
                  error attribution on the same ``vae_quant``: full-precision
                  convolutions with the weight side, the activation side or
                  both of the quantization simulated (dense layers and the
                  attention full precision).

    With ``models.dpt_head`` (as the JAX package chooses the branch, by the
    checkpoint and not the mode) the UNet's features go through the head
    and each image is min-max normalized; the UNet's hooks apply there too,
    and no decoder runs, so the "dec" group stays empty."""
    task = cfg.task
    sched_cfg = cfg.scheduler
    sched = make_scheduler(sched_cfg, device=models.device)
    if cfg.fix_timesteps:
        ts = np.full((cfg.denoising_steps,), cfg.fix_timesteps, np.int64)
    else:
        ts = leading_timesteps(sched_cfg, cfg.denoising_steps)
    dtype = cfg.dtype

    def attn_kept(path):
        return not any(e in path for e in cfg.int8_exclude)

    @torch.no_grad()
    def single_infer(rgb: torch.Tensor, vae_quant: Optional[Dict] = None,
                     noise: Optional[torch.Tensor] = None):
        hk = _int8_hooks(cfg, quant_mode, vae_quant)
        x = rgb.to(dtype).permute(0, 3, 1, 2) * 2.0 - 1.0
        rgb_latent = vae_encode(
            models.vae, x, conv_fn=hk["enc"], dense_fn=hk["enc_dense"], fused=cfg.fused_vae,
            attn_int8=hk["vattn"] and attn_kept("encoder.mid_block.attentions.0"))
        embed = models.get_text_embed().to(dtype)
        b = rgb.shape[0]
        text = embed.expand((b,) + tuple(embed.shape[-2:]))

        def timestep(t_host):
            return torch.full((b,), int(t_host), dtype=torch.long, device=rgb.device)

        if models.dpt_head is not None:
            _, feats = unet_apply(models.unet, rgb_latent, timestep(ts[0]), text,
                                  return_features=True, conv_fn=hk["u_conv"],
                                  dense_fn=hk["u_dense"])
            pred = dpt_head_apply(models.dpt_head, feats[::-1])
            # per-image min-max in the compute dtype, as the JAX package
            lo = pred.amin(dim=(1, 2), keepdim=True)
            hi = pred.amax(dim=(1, 2), keepdim=True)
            pred = ((pred - lo) / torch.clamp(hi - lo, min=1e-6)).float()
            return pred if hk["stats"] is None else (pred, hk["stats"])
        if cfg.arch in ("genpercept", "rgb_blending"):
            pred_latent = rgb_latent
        elif noise is None:
            raise ValueError("the marigold arch needs initial noise")
        else:
            pred_latent = noise.to(rgb.device, dtype).permute(0, 3, 1, 2)

        if cfg.arch == "genpercept":
            v = unet_apply(models.unet, pred_latent, timestep(ts[0]), text,
                           conv_fn=hk["u_conv"], dense_fn=hk["u_dense"])
            pred_latent = -v  # beta == 1: pred_x0 == -v
        else:
            for t_host in ts:
                t = timestep(t_host)
                unet_in = (torch.cat([rgb_latent, pred_latent], dim=1)
                           if cfg.arch == "marigold" else pred_latent)
                v = unet_apply(models.unet, unet_in, t, text, conv_fn=hk["u_conv"],
                               dense_fn=hk["u_dense"])
                prev, pred_x0 = ddim_step(sched_cfg, sched, v, t, pred_latent,
                                          cfg.denoising_steps)
                # the update runs in f32; every UNet pass and the decode in dtype
                pred_latent = prev.to(dtype)
            pred_latent = pred_x0.to(dtype)
        decoded = vae_decode(
            models.vae, pred_latent, conv_fn=hk["dec"], dense_fn=hk["dec_dense"],
            fused=cfg.fused_vae,
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
    # per-pixel disagreement of the aligned ensemble members (median
    # absolute deviation, in the merged output's units) when ensemble_size > 1
    uncertainty: Optional[np.ndarray] = None


def replicate_models(models: GenPerceptModels, device: torch.device | str) -> GenPerceptModels:
    """A copy of ``models`` on ``device`` (modules deep-copied, the text
    embedding and the tokenizer shared or moved)."""
    device = torch.device(device)

    def moved(m):
        return None if m is None else copy.deepcopy(m).to(device)

    return dataclasses.replace(
        models, unet=moved(models.unet), vae=moved(models.vae), clip=moved(models.clip),
        dpt_head=moved(models.dpt_head),
        text_embed=None if models.text_embed is None else models.text_embed.to(device),
        unet_lora=None if models.unet_lora is None else {
            k: v.detach().to(device) for k, v in models.unet_lora.items()})


def _tree_to(vq: Dict[str, Dict], device: torch.device) -> Dict[str, Dict]:
    def moved(t):
        return None if t is None else t.to(device)

    return {g: {k: dataclasses.replace(q, w_int8=moved(q.w_int8), inv_a=moved(q.inv_a),
                                       o_scale=moved(q.o_scale), bias=moved(q.bias),
                                       zp=moved(q.zp))
                for k, q in tree.items()}
            for g, tree in vq.items()}


class GenPerceptPipeline:
    """Host-side orchestration: numpy images in, predictions out.

    ``device`` is where the models run ("cuda" unless the caller passes
    another); they are moved there once. Without a card, the default raises:
    the pipeline never falls back to the CPU unasked.

    ``devices`` (a list, the counterpart of the JAX package's ``mesh=``)
    runs the pipeline data-parallel: the models move to the first device
    and a replica goes to each other one; every device batch is padded to a
    multiple of the device count (the padded rows repeat the last image and
    are dropped), split in equal parts, and each part runs on its replica,
    one thread each; the predictions come back on the first device.

    With ``cfg.int8_vae`` the first batch runs the full-precision
    calibration pass in chunks (returning its prediction) and builds the
    int8 tree that every later batch runs; ``save_calibration`` /
    ``load_calibration`` keep that tree in the JAX package's file format.
    Data-parallel, the calibration keeps the one-device chunk: each replica
    calibrates a chunk at a time, the replicas at once, and the records
    merge on the first device in the chunks' order, so that N devices
    build the tree one device builds from the same images (where the JAX
    package's sharded program takes one chunk of N times the images over
    its mesh), with a device's memory at the one-device size; the tree is
    copied to every device."""

    def __init__(self, models: GenPerceptModels, cfg: PipelineConfig,
                 device: torch.device | str = "cuda",
                 devices: Optional[List[torch.device | str]] = None):
        devices = [torch.device(d) for d in devices] if devices else [torch.device(device)]
        self.device = devices[0]
        if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
            raise RuntimeError("GenPerceptPipeline runs on the card by default and no CUDA "
                               "device is available; pass device=\"cpu\" to run on the CPU")
        models.unet.to(self.device)
        models.vae.to(self.device)
        if models.dpt_head is not None:
            models.dpt_head.to(self.device)
        if models.clip is not None:
            models.clip.to(self.device)
        if models.text_embed is not None:
            models.text_embed = models.text_embed.to(self.device)
        self.models = models
        self.cfg = cfg
        self.devices = devices
        self.replicas = [models] + [replicate_models(models, d) for d in devices[1:]]
        quant_mode = "quant" if cfg.int8_vae else None
        self._infers = [build_single_infer(m, cfg, quant_mode) for m in self.replicas]
        self._infer = self._infers[0]
        self._calib_infer = build_single_infer(models, cfg, "calibrate") if cfg.int8_vae \
            else None
        self._replica_calib_infers = [build_single_infer(m, cfg, "calibrate")
                                      for m in self.replicas[1:]] if cfg.int8_vae else []
        self.vae_quant: Optional[Dict[str, Dict]] = None
        self._vq_copies: List[Optional[Dict[str, Dict]]] = [None] * len(devices)
        self.int8_mean_dev: Optional[float] = None  # set by the post-calibration check
        self.calibration_seconds: Optional[float] = None

    @property
    def calibrated(self) -> bool:
        return not self.cfg.int8_vae or self.vae_quant is not None

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def _set_quant(self, vq: Dict[str, Dict]) -> None:
        self.vae_quant = vq
        self._vq_copies = [vq] + [_tree_to(vq, d) for d in self.devices[1:]]

    def _on_replica(self, i: int, fn):
        """fn(x, *extra) run on device i: its tensors moved there, under
        that device's CUDA context."""
        dev = self.devices[i]

        def run(x, *extra):
            ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with ctx:
                return fn(x.to(dev), *(e.to(dev) if isinstance(e, torch.Tensor) else e
                                       for e in extra))

        return run

    def _forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The (quantized) forward of one device batch, split between the
        replicas."""
        n = self.n_devices
        if n == 1:
            return self._infer(x, self.vae_quant, noise)
        b = x.shape[0]
        pad = -b % n

        def padded(t):
            if t is None or not pad:
                return t
            return torch.cat([t, t[-1:].expand((pad,) + tuple(t.shape[1:]))])

        xs = padded(x).chunk(n)
        ns = [None] * n if noise is None else padded(noise).chunk(n)

        def part(i):
            return self._on_replica(i, self._infers[i])(xs[i], self._vq_copies[i], ns[i])

        with ThreadPoolExecutor(max_workers=n) as pool:
            outs = list(pool.map(part, range(n)))
        return torch.cat([o.to(self.device) for o in outs])[:b]

    @torch.no_grad()
    def _calibrate(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The calibration pass over x (JAX GenPerceptPipeline._run :507-568):
        stats in chunks of 2 images with asymmetric stats or GPTQ, else 4
        (a chunk a replica at once when data-parallel); the int8 trees of the kept layers (GPTQ-rounded where the
        calibration recorded Grams), bias-corrected; the self-check.
        Returns the full-precision prediction."""
        cfg = self.cfg
        t0 = time.perf_counter()
        chunk = 2 if (cfg.int8_gptq or cfg.int8_asymmetric) else 4
        fns = self._calib_infer if self.n_devices == 1 else [
            self._on_replica(i, f)
            for i, f in enumerate([self._calib_infer, *self._replica_calib_infers])]
        pred, stats = quant.calibrate_chunked(fns, x, None, noise, chunk=chunk)
        m = 1.0 if cfg.int8_refine else cfg.int8_margin

        def keep(st):
            return {k: v for k, v in st.items() if not any(e in k for e in cfg.int8_exclude)}

        wc = cfg.int8_weight_clip
        hess = stats.get("hess", {})
        vq = {g: quant.quantize_from_stats(self.models.vae, keep(stats[g]), m, weight_clip=wc,
                                           hess=hess.get(g))
              for g in ("enc", "dec")}
        if cfg.int8_unet:
            vq["unet"] = quant.quantize_from_stats(self.models.unet, keep(stats["unet"]), m,
                                                   asymmetric_downsample=False, weight_clip=wc)
        if cfg.int8_refine:
            vq = {k: quant.apply_bias_correction(v, stats["corr"][k]) for k, v in vq.items()}
        del stats, hess
        self._set_quant(vq)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.calibration_seconds = time.perf_counter() - t0
        if cfg.int8_selfcheck:
            # one quantized forward on the calibration batch against the
            # full-precision prediction in hand
            q_pred = self._forward(x, noise)
            self.int8_mean_dev = float((q_pred.float() - pred.float()).abs().mean())
            if self.int8_mean_dev > 1e-2:
                logging.getLogger(__name__).warning(
                    "int8 self-check: mean deviation %.3e vs full precision on the "
                    "calibration batch exceeds the 1e-2 bar; consider a shallower "
                    "int8_exclude placement (max fidelity: ('encoder.', "
                    "'decoder.up_blocks.3.')) or int8_gptq", self.int8_mean_dev)
        return pred

    def _run(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One device batch (with the marigold arch's initial noise): the
        calibration pass first if int8 is set and not yet calibrated, else
        the (quantized) forward."""
        if not self.calibrated:
            return self._calibrate(x, noise)
        return self._forward(x, noise)

    def save_calibration(self, path) -> None:
        """Write the int8 tree built by the first batch (JAX's .npz layout)."""
        if not (self.cfg.int8_vae and self.calibrated):
            raise RuntimeError("run at least one batch with int8_vae=True before saving")
        quant.save_calibration(path, self.vae_quant)

    def load_calibration(self, path) -> None:
        """Load an int8 tree (written by either package); skips calibration."""
        if not self.cfg.int8_vae:
            raise RuntimeError("calibration needs int8_vae=True")
        self._set_quant(quant.load_calibration(path, self.device))

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

    def _output(self, pred: torch.Tensor, color_map: Optional[str],
                uncertainty: Optional[torch.Tensor] = None) -> GenPerceptOutput:
        if color_map == "auto":
            color_map = self.cfg.task.color_map
        colored = None
        if color_map is not None and pred.ndim == 3:
            colored = (colorize_depth(pred[0]) * 255).to(torch.uint8).cpu().numpy()
        return GenPerceptOutput(
            pred_np=pred[0].cpu().numpy(), pred_colored=colored,
            uncertainty=None if uncertainty is None else uncertainty.cpu().numpy())

    def __call__(self, image: np.ndarray, color_map: Optional[str] = "auto", *,
                 generator: Optional[torch.Generator] = None) -> GenPerceptOutput:
        """image: (H, W, 3) uint8 or float in [0, 1].

        With ``ensemble_size`` E > 1 the image runs as E members in one
        batch, each from its own noise, and the members are ensembled (the
        output then carries an uncertainty map); the marigold arch draws its
        initial noise, (E, h/8, w/8, 4), from ``generator``, a generator on
        the pipeline's device (default: one seeded 0, so that an unseeded
        call is deterministic)."""
        cfg = self.cfg
        h, w = image.shape[:2]
        x = self._to_tensor(image)[None]
        ph, pw = max_res_shape(h, w, cfg.processing_res) if cfg.processing_res > 0 \
            else (h, w)
        x = resize(x, (ph, pw), cfg.resample_method, antialias=True)
        lh, lw = ph, pw  # the latent: three stride-2 convs, each a floor-halving
        for _ in range(3):
            lh, lw = lh // 2, lw // 2
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)

        def draw(n):
            return torch.randn((n, lh, lw, 4), generator=generator, device=self.device)

        e = cfg.ensemble_size
        uncertainty = None
        if e > 1:
            preds = self._run(x.expand(e, ph, pw, 3), draw(e))
            pred, uncertainty = ensemble_predictions(preds, return_uncertainty=True)
            pred = pred[None]
        else:
            pred = self._run(x, draw(1) if cfg.arch == "marigold" else None)
        if uncertainty is not None:
            uncertainty = self._resize_back(uncertainty[None], (h, w))[0]
        pred = self._resize_back(pred, (h, w)).clamp(0.0, 1.0)
        return self._output(pred, color_map, uncertainty)

    def batch(self, images: List[np.ndarray], batch_size: int = 0,
              color_map: Optional[str] = "auto") -> List[GenPerceptOutput]:
        """Batched inference over (H, W, 3) arrays: images are resized to
        the processing resolution, grouped by that shape into batches of
        ``batch_size``, run, then resized back one by one. ``batch_size`` 0
        (or less) takes the largest batch measured to fit one H100 80GB at
        the processing resolution and dtype (``utils/batchsize.py``), times
        the device count. It
        runs each image once: no ensemble, and no noise, so the marigold
        arch raises here as in the JAX package."""
        cfg = self.cfg
        if cfg.processing_res <= 0:
            raise ValueError("batched mode needs a fixed processing_res")
        if batch_size <= 0:
            batch_size = find_batch_size(
                cfg.ensemble_size, cfg.processing_res,
                "bfloat16" if cfg.dtype == torch.bfloat16 else "float32") * self.n_devices
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
