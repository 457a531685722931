"""The GenPercept training step in PyTorch.

Counterpart of ``genpercept_tpu/train/train_step.py``, every arch, mode and
loss of the JAX step:

  1. valid-mask downscale to the latent grid (max-pool 8 of the invalid mask)
  2. the frozen VAE encodes rgb and gt under ``torch.no_grad()``
  3. t ~ U[0, 1000) from a ``torch.Generator``, or fixed; the noise is the
     rgb latent (genpercept, rgb_blending) or, for marigold, a gaussian or
     multi-resolution draw (``train/noise.py``) after t, as JAX draws them
  4. noisy = add_noise(gt_latent, noise, t), cast to the compute dtype;
     target = velocity, f32; marigold's UNet input is [rgb_latent, noisy]
     (the 8-channel conv_in of ``replace_unet_conv_in``)
  5. UNet forward (optionally rematerialized), with LoRA the adapted
     attention projections handed in as tensors (``train/lora.py``);
     masked latent losses and/or pixel losses on the decoded prediction
     (depth: mse x1 + ssi x0.5 + grad x2 and the metric3d losses on depth
     shifted +2; other modes: mse, l1 or angular on 3 channels), gradients
     flowing through the frozen decoder; or, with a DPT head, the head on
     the UNet's up-block features, its raw output the prediction
  6. gradients accumulated in f32 over micro-batches, then the optax-Adam
     update (``make_optimizer``)

Data-parallel (``parallel/``), each model group runs the step on its slice
of the global micro-batch: it draws the global micro-batch's random numbers
and keeps its data index's rows, its losses divide by the global batch's
counts, and the gradients and metrics are summed over the data group, so N
groups compute what one process computes on the global batch. Within a
tensor-parallel model group every rank sees the same rows and draws, and
holds its share of the UNet's attention and GEGLU layers
(``parallel/tensor.py``).

The models are ``nn.Module``s holding their parameters, so where the JAX
step threads (trainable, frozen) trees, this one marks parameters trainable
with ``requires_grad`` and returns them keyed by their dotted names. Every
random number comes from the ``generator`` a call is handed; a test can hand
the loss another generator's numbers instead (``draws``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from genpercept_tpu_torch.diffusion import (
    GENPERCEPT_SCHEDULER,
    SchedulerConfig,
    add_noise,
    get_velocity,
    make_scheduler,
)
from genpercept_tpu_torch import parallel
from genpercept_tpu_torch.parallel import tensor as TP
from genpercept_tpu_torch.models import dpt_head_apply, unet_apply, vae_decode, vae_encode
from genpercept_tpu_torch.train import losses as L
from genpercept_tpu_torch.train import metric3d_losses as M3D
from genpercept_tpu_torch.train.lora import apply_lora, init_lora
from genpercept_tpu_torch.train.noise import multi_res_noise_like
from genpercept_tpu_torch.train.lr import iter_exponential_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Every field of the JAX package's TrainConfig; dtypes are torch dtypes.
    loss_names: a subset of {latent_mse, latent_l1, latent_mean_abs_rel,
    mse, ssi, ssi_medium, grad, angular, l1, vnl, hdnr, hdsnr} (vnl needs
    batch["intrinsic"])."""

    mode: str = "depth"
    arch: str = "genpercept"  # genpercept | rgb_blending | marigold
    loss_names: Tuple[str, ...] = ("mse", "ssi", "grad")
    unet_lora_rank: Optional[int] = None
    multi_res_noise_strength: Optional[float] = None
    multi_res_noise_strategy: str = "original"
    multi_res_noise_annealed: bool = False
    fix_timesteps: Optional[int] = None
    num_train_timesteps: int = 1000
    lr: float = 3e-5
    decoder_lr: Optional[float] = None  # None = lr for everything
    lr_total_iter_length: int = 25000
    lr_final_ratio: float = 0.01
    lr_warmup_steps: int = 100
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_mu_dtype: Optional[torch.dtype] = None  # first-moment dtype
    master_dtype: Optional[torch.dtype] = None  # trainable-parameter dtype
    grad_accum_steps: int = 1
    train_unet: bool = True
    train_dpt_head: bool = True
    train_vae_decoder: bool = False
    compute_dtype: torch.dtype = torch.float32
    remat_unet: bool = False
    remat_granularity: str = "unet"  # "unet" | "block"
    remat_vae_decode: bool = True
    scheduler: SchedulerConfig = GENPERCEPT_SCHEDULER


@torch.no_grad()
def replace_unet_conv_in(unet: nn.Module) -> nn.Module:
    """Marigold's conv_in surgery, in place: the (C, 4, 3, 3) kernel
    concatenated with itself along the input channels and halved, so the
    output at [rgb_latent, noisy] is SD2.1's at their mean; the UNet's
    config gets in_channels 8."""
    old = unet.conv_in
    if old.weight.shape[1] != 4:
        raise ValueError(f"conv_in already has {old.weight.shape[1]} input channels")
    with torch.device("meta"):
        new = nn.Conv2d(8, old.out_channels, old.kernel_size)
    new = new.to(old.weight.dtype).to_empty(device=old.weight.device)
    new.weight.copy_(torch.cat([old.weight, old.weight], dim=1) * 0.5)
    new.bias.copy_(old.bias)
    unet.conv_in = new
    unet.cfg = dataclasses.replace(unet.cfg, in_channels=8)
    return unet


def downscale_valid_mask(valid_mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """(B, H, W) bool -> (B, H/f, W/f) bool: a latent cell is valid iff all
    its pixels are (max-pool of the invalid mask)."""
    invalid = (~valid_mask).float()[:, None]
    return F.max_pool2d(invalid, factor, factor)[:, 0] < 0.5


def _unet_remat(cfg: TrainConfig) -> Optional[str]:
    if not cfg.remat_unet:
        return None
    return "block" if cfg.remat_granularity == "block" else "unet"


def _depth_loss(name: str, pred, targ, m, batch, draw):
    """(loss, weight) of a depth-mode pixel loss on depth shifted to [1, 3].
    draw(name, fn, per_image) draws fn(generator) for the global batch and
    keeps this rank's rows when per_image."""
    if name == "mse":
        return L.masked_mse(pred, targ, m), 1.0
    if name == "ssi":
        return L.ssi_loss(pred, targ, m, "least_square"), 0.5
    if name == "ssi_medium":
        return L.ssi_loss(pred, targ, m, "medium"), 0.5
    if name == "grad":
        return L.gradient_loss(pred, targ, m), 2.0
    if name == "l1":
        return L.masked_l1(pred, targ, m), 1.0
    if name == "vnl":
        # the draw follows each image's mask: the global batch's masks
        return M3D.vnl_core(pred, targ, m, batch["intrinsic"].float(), draw(
            name, lambda g: M3D.vnl_draw(g, parallel.all_gather_batch(m)))), 1.0
    if name == "hdnr":
        n = pred.shape[0] * parallel.data_world()
        return M3D.hdnl_core(pred, targ, m, draw(name, lambda g: M3D.hdnl_draw(g, n))), 1.0
    if name == "hdsnr":
        h, w = pred.shape[1:]
        # one set of windows for the whole batch
        return M3D.hdsnl_core(pred, targ, m, draw(name, lambda g: M3D.hdsnl_draw(g, h, w),
                                                  per_image=False)), 1.0
    raise ValueError(name)


def _other_loss(name: str, pred, targ, m):
    """(loss, weight) of a pixel loss outside depth mode, on (B, H, W, 3)."""
    if name == "mse":
        return L.masked_mse(pred, targ, m[..., None].expand(pred.shape)), 1.0
    if name == "l1":
        return L.masked_l1(pred, targ, m[..., None].expand(pred.shape)), 1.0
    if name == "angular":
        return L.angular_loss(pred, targ, m), 1.0
    raise ValueError(name)


def build_loss_fn(cfg: TrainConfig, models):
    """models: ``pipeline.GenPerceptModels`` (with ``unet_lora`` set when
    cfg.unet_lora_rank is, see ``split_trainable``). Returns
    loss_fn(batch, generator=None, draws=None) -> (loss, aux) on the models'
    current parameters. batch: "rgb_norm" and "gt_norm" (B, H, W, 3) in
    [-1, 1], "valid_mask" (B, H, W) bool, "intrinsic" (B, 3, 3) for vnl.
    ``generator`` draws, in the JAX step's order, the timesteps, marigold's
    noise and each metric3d loss's samples; ``draws`` may give any of them
    instead: "t" (B,), "noise" (B, 4, h, w), and the loss names' draws
    (``train/metric3d_losses.py``)."""
    sched = make_scheduler(cfg.scheduler)
    remat = _unet_remat(cfg)
    lora_mode = cfg.unet_lora_rank is not None

    def loss_fn(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, Any]] = None):
        draws = draws or {}
        cd = cfg.compute_dtype
        rgb = batch["rgb_norm"].to(cd).permute(0, 3, 1, 2)
        gt = batch["gt_norm"].to(cd).permute(0, 3, 1, 2)
        valid = batch["valid_mask"]
        bsz, dev = rgb.shape[0], rgb.device
        rows = parallel.batch_slice(bsz)  # this rank's rows of the global batch

        def draw(name, fn, per_image=True):
            """draws[name], or fn(generator) drawn for the global batch with
            this rank's rows kept."""
            if name in draws:
                return draws[name]
            x = fn(generator)
            if not per_image or parallel.data_world() == 1:
                return x
            return tuple(v[rows] for v in x) if isinstance(x, tuple) else x[rows]

        with torch.no_grad():  # the frozen encoder: stop_gradient
            rgb_latent = vae_encode(models.vae, rgb)
            gt_latent = vae_encode(models.vae, gt)
        n_global = bsz * parallel.data_world()
        if cfg.fix_timesteps is not None:
            t_global = torch.full((n_global,), cfg.fix_timesteps, dtype=torch.long, device=dev)
        elif "t" in draws:
            t_global = None
        else:
            t_global = torch.randint(0, cfg.num_train_timesteps, (n_global,),
                                     generator=generator).to(dev)
        t = draws["t"].to(dev) if t_global is None else t_global[rows]
        latent_global = (n_global,) + tuple(gt_latent.shape[1:])
        if cfg.arch in ("genpercept", "rgb_blending"):
            noise = rgb_latent
        elif cfg.multi_res_noise_strength is not None:
            def mrn(g):
                strength = cfg.multi_res_noise_strength
                if cfg.multi_res_noise_annealed:
                    tg = t if t_global is None else t_global
                    strength = strength * (tg.float() / cfg.num_train_timesteps).reshape(
                        -1, 1, 1, 1)
                return multi_res_noise_like(g, latent_global, strength,
                                            cfg.multi_res_noise_strategy, cd, dev)

            noise = draw("noise", mrn)
        else:
            noise = draw("noise", lambda g: torch.randn(
                latent_global, generator=g, dtype=cd, device=None if g is None else g.device))
        noise = noise.to(dev)
        noisy = add_noise(sched, gt_latent, noise, t).to(cd)
        target = get_velocity(sched, gt_latent, noise, t)
        unet_in = torch.cat([rgb_latent, noisy], dim=1) if cfg.arch == "marigold" else noisy
        embed = models.get_text_embed()
        text = embed.to(cd).expand((bsz,) + tuple(embed.shape[-2:]))
        attn_weights = apply_lora(models.unet, models.unet_lora) if lora_mode else None

        aux: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), dtype=torch.float32, device=dev)
        pixel = [n for n in cfg.loss_names if not n.startswith("latent")]

        if models.dpt_head is not None:
            _, feats = unet_apply(models.unet, unet_in, t, text, remat=remat,
                                  return_features=True, attn_weights=attn_weights)
            pred_px = dpt_head_apply(models.dpt_head, feats[::-1])  # (B, H, W), raw
        else:
            v = unet_apply(models.unet, unet_in, t, text, remat=remat,
                           attn_weights=attn_weights)
            mask_latent = downscale_valid_mask(valid)[:, None]  # (B, 1, h, w)
            for name in cfg.loss_names:
                if not name.startswith("latent"):
                    continue
                vm = mask_latent.expand(v.shape)
                v32, t32 = v.float(), target.float()
                if name in ("latent_mse", "latent_mse_loss"):
                    l = L.masked_mse(v32, t32, vm)
                elif name in ("latent_l1", "latent_l1_loss", "latent_l1_loss_with_mask"):
                    l = L.masked_l1(v32, t32, vm)
                elif name == "latent_mean_abs_rel":
                    mm = vm.float()
                    rel = torch.abs(v32 - t32) / torch.clamp(torch.abs(t32), min=1e-6)
                    l = torch.sum(rel * mm) / (parallel.global_sum(torch.sum(mm)) + 1e-6)
                else:
                    raise ValueError(name)
                aux[name] = l
                total = total + l
            if not pixel:
                return total, aux
            decoded = vae_decode(models.vae, -v, remat=cfg.remat_vae_decode)
            pred_px = decoded.mean(dim=1) if cfg.mode == "depth" else decoded.permute(0, 2, 3, 1)

        if cfg.mode == "depth":
            pred = pred_px.float() + 2.0  # [-1, 1] -> [1, 3]
            targ = gt[:, 0].float() + 2.0
            losses = {n: _depth_loss(n, pred, targ, valid, batch, draw) for n in pixel}
        else:
            pred = pred_px.float()
            if pred.ndim == 3:
                pred = pred[..., None].expand(pred.shape + (3,))
            targ = gt.permute(0, 2, 3, 1).float()
            losses = {n: _other_loss(n, pred, targ, valid) for n in pixel}
        for name, (l, w) in losses.items():
            aux[name] = l
            total = total + w * l
        return total, aux

    return loss_fn


def split_trainable(models, cfg: TrainConfig, generator: Optional[torch.Generator] = None
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(trainable, frozen), keyed by dotted parameter names ("unet.conv_in.
    weight", ...), per the reference's trainability matrix: the UNet when
    train_unet and no LoRA; the DPT head when train_dpt_head; the VAE decoder
    and post_quant_conv when train_vae_decoder; the rest and the text
    embedding frozen. With cfg.unet_lora_rank the base UNet is frozen and
    the adapters (``models.unet_lora``, drawn from ``generator`` by
    ``init_lora`` when not set yet) are trainable as "unet_lora.<name>".
    Sets ``requires_grad`` to match."""
    lora_mode = cfg.unet_lora_rank is not None
    trainable: Dict[str, torch.Tensor] = {}
    frozen: Dict[str, torch.Tensor] = {}
    parts = [("unet", models.unet), ("vae", models.vae)]
    if models.dpt_head is not None:
        parts.append(("dpt_head", models.dpt_head))
    for prefix, module in parts:
        for name, p in module.named_parameters():
            if prefix == "unet":
                train = cfg.train_unet and not lora_mode
            elif prefix == "dpt_head":
                train = cfg.train_dpt_head
            else:
                train = cfg.train_vae_decoder and name.split(".")[0] in (
                    "decoder", "post_quant_conv")
            p.requires_grad_(train)
            (trainable if train else frozen)[f"{prefix}.{name}"] = p
    if lora_mode:
        if models.unet_lora is None:
            models.unet_lora = init_lora(generator, models.unet, cfg.unet_lora_rank)
        for name, x in models.unet_lora.items():
            trainable[f"unet_lora.{name}"] = x.requires_grad_(True)
    frozen["text_embed"] = models.get_text_embed()
    return trainable, frozen


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    """The scalar x in like's dtype: a Python float meets a JAX array as a
    weakly typed constant, rounded to the array's dtype (0.9 is 0.8984375
    against a bf16 moment), where PyTorch would compute it in f32."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


class OptaxAdam(torch.optim.Optimizer):
    """``optax.adam(schedule, b1, b2, mu_dtype=...)`` as a torch optimizer:
    mu in ``mu_dtype`` (the parameter's dtype when None), nu in the
    parameter's dtype, bias correction, eps outside the square root, and the
    learning rate read from the schedule at the count before the update (0
    on the first). Each parameter group carries a ``scale`` on its update
    (the decoder group's decoder_lr / lr) and the shared ``count``.
    ``step(grads)`` takes the gradients in the groups' parameter order."""

    def __init__(self, groups: List[Dict[str, Any]], schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None):
        super().__init__(groups, {"scale": 1.0, "count": 0})
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.mu_dtype = mu_dtype

    def _state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
            st["nu"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self, grads: Iterable[torch.Tensor]):
        grads = iter(grads)
        f32 = np.float32
        for group in self.param_groups:
            count = group["count"]
            lr = self.schedule(count)
            bc1 = float(f32(1) - f32(self.b1) ** f32(count + 1))
            bc2 = float(f32(1) - f32(self.b2) ** f32(count + 1))
            for p in group["params"]:
                g = next(grads)
                st = self._state(p)
                mu = _c(1 - self.b1, g) * g + _c(self.b1, st["mu"]) * st["mu"]
                nu = _c(1 - self.b2, g) * g * g + _c(self.b2, st["nu"]) * st["nu"]
                upd = (mu / _c(bc1, mu)) / (torch.sqrt(nu / _c(bc2, nu)) + _c(self.eps, nu))
                upd = upd * _c(-lr, upd)
                if group["scale"] != 1.0:
                    upd = upd * _c(group["scale"], upd)
                p.copy_((p + upd).to(p.dtype))
                st["mu"] = mu if self.mu_dtype is None else mu.to(self.mu_dtype)
                st["nu"] = nu
            group["count"] = count + 1

    def load_state_dict(self, state_dict):
        # torch casts floating state to the parameter's dtype; mu keeps its own
        super().load_state_dict(state_dict)
        if self.mu_dtype is not None:
            for st in self.state.values():
                st["mu"] = st["mu"].to(self.mu_dtype)


def make_optimizer(cfg: TrainConfig, trainable: Dict[str, torch.Tensor]) -> OptaxAdam:
    """One group, or with decoder_lr != lr a second group for the VAE (and
    head) parameters whose update is scaled by decoder_lr / lr: exactly a
    second Adam group at decoder_lr under the shared schedule."""
    sched = iter_exponential_schedule(cfg.lr, cfg.lr_total_iter_length,
                                      cfg.lr_final_ratio, cfg.lr_warmup_steps)
    split = cfg.decoder_lr is not None and cfg.decoder_lr != cfg.lr
    main = [p for k, p in trainable.items() if not (split and k.startswith(("vae.", "dpt_head.")))]
    dec = [p for k, p in trainable.items() if split and k.startswith(("vae.", "dpt_head."))]
    groups = [{"params": main, "scale": 1.0}]
    if dec:
        groups.append({"params": dec, "scale": cfg.decoder_lr / cfg.lr})
    return OptaxAdam([g for g in groups if g["params"]], sched, cfg.adam_b1, cfg.adam_b2,
                     mu_dtype=cfg.adam_mu_dtype)


def init_train_state(models, cfg: TrainConfig, generator: Optional[torch.Generator] = None):
    """-> (trainable, frozen, optimizer); trainable parameters cast to
    master_dtype when it is set; ``generator`` draws fresh LoRA adapters."""
    trainable, frozen = split_trainable(models, cfg, generator)
    if cfg.master_dtype is not None:
        for p in trainable.values():
            p.data = p.data.to(cfg.master_dtype)
    return trainable, frozen, make_optimizer(cfg, trainable)


def build_train_step(cfg: TrainConfig, models, optimizer):
    """Returns step(batch, generator=None) -> metrics ({"loss", **aux}, 0-dim
    f32 tensors). With grad_accum_steps > 1 every batch entry has a leading
    accumulation axis; gradients and the per-loss aux are summed in f32 over
    it, in order, and divided by its length, as the JAX step's lax.scan.
    ``optimizer``: an ``OptaxAdam``, or its ZeRO-1 form (``parallel.zero1``).
    In a data-parallel run the batch is this data index's slice; the
    gradients and the metrics are summed over the data group before the
    update (``parallel.reduce_gradients_``: a tensor-parallel replica's
    replicated gradients also averaged over its model group)."""
    loss_fn = build_loss_fn(cfg, models)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    sharded = [TP.split_of(p) is not None for p in params]

    def grads_of(loss):
        return torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        n = cfg.grad_accum_steps
        if n > 1:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            aux: Dict[str, torch.Tensor] = {}
            for i in range(n):
                l, a = loss_fn({k: v[i] for k, v in batch.items()}, generator)
                for s, g in zip(acc, grads_of(l)):
                    s.add_(g.float())
                loss = loss + l.detach()
                for k, v in a.items():
                    aux[k] = aux.get(k, 0.0) + v.detach().float()
            grads = [s / n for s in acc]
            loss = loss / n
            aux = {k: v / n for k, v in aux.items()}
        else:
            loss, aux = loss_fn(batch, generator)
            grads = list(grads_of(loss))
            loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        parallel.reduce_gradients_(grads, sharded)
        optimizer.step(grads)
        return parallel.sum_metrics({"loss": loss, **aux})

    return step
