"""The GenPercept training step in PyTorch.

Counterpart of ``genpercept_tpu/train/train_step.py`` for the genpercept arch
in depth mode without a DPT head:

  1. valid-mask downscale to the latent grid (max-pool 8 of the invalid mask)
  2. the frozen VAE encodes rgb and gt under ``torch.no_grad()``
  3. t ~ U[0, 1000) from a ``torch.Generator``, or fixed; noise = rgb_latent
  4. noisy = add_noise(gt_latent, noise, t) (== noise at beta == 1), cast to
     the compute dtype; target = velocity (== -gt_latent), f32
  5. UNet forward (optionally rematerialized); masked latent losses and/or
     pixel losses on the decoded prediction (mse x1 + ssi x0.5 + grad x2 on
     depth shifted +2), gradients flowing through the frozen decoder
  6. gradients accumulated in f32 over micro-batches, then the optax-Adam
     update (``make_optimizer``)

The models are ``nn.Module``s holding their parameters, so where the JAX
step threads (trainable, frozen) trees, this one marks parameters trainable
with ``requires_grad`` and returns them keyed by their dotted names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from genpercept_tpu_torch.diffusion import (
    GENPERCEPT_SCHEDULER,
    SchedulerConfig,
    add_noise,
    get_velocity,
    make_scheduler,
)
from genpercept_tpu_torch.models import unet_apply, vae_decode, vae_encode
from genpercept_tpu_torch.train import losses as L
from genpercept_tpu_torch.train.lr import iter_exponential_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Every field of the JAX package's TrainConfig; dtypes are torch dtypes.
    Fields the port does not implement yet raise NotImplementedError when a
    loss function or train state is built (``check_ported``)."""

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


_UNPORTED_LOSSES = ("vnl", "hdnr", "hdsnr")


def check_ported(cfg: TrainConfig, models) -> None:
    """Raise NotImplementedError for what the port does not train yet."""
    defaults = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    unported = [name for name in ("unet_lora_rank", "multi_res_noise_strength",
                                  "multi_res_noise_strategy", "multi_res_noise_annealed")
                if getattr(cfg, name) != defaults[name]]
    if cfg.arch != "genpercept":
        unported.append(f"arch={cfg.arch!r}")
    if cfg.mode != "depth":
        unported.append(f"mode={cfg.mode!r}")
    unported += [f"loss {n!r}" for n in cfg.loss_names if n in _UNPORTED_LOSSES]
    if getattr(models, "dpt_head", None) is not None:
        unported.append("a DPT head")
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")


def downscale_valid_mask(valid_mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """(B, H, W) bool -> (B, H/f, W/f) bool: a latent cell is valid iff all
    its pixels are (max-pool of the invalid mask)."""
    invalid = (~valid_mask).float()[:, None]
    return F.max_pool2d(invalid, factor, factor)[:, 0] < 0.5


def _unet_remat(cfg: TrainConfig) -> Optional[str]:
    if not cfg.remat_unet:
        return None
    return "block" if cfg.remat_granularity == "block" else "unet"


def build_loss_fn(cfg: TrainConfig, models):
    """models: ``pipeline.GenPerceptModels``. Returns
    loss_fn(batch, generator=None) -> (loss, aux) on the models' current
    parameters. batch: "rgb_norm" and "gt_norm" (B, H, W, 3) in [-1, 1],
    "valid_mask" (B, H, W) bool; ``generator`` draws the timesteps."""
    check_ported(cfg, models)
    sched = make_scheduler(cfg.scheduler)
    remat = _unet_remat(cfg)

    def loss_fn(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        cd = cfg.compute_dtype
        rgb = batch["rgb_norm"].to(cd).permute(0, 3, 1, 2)
        gt = batch["gt_norm"].to(cd).permute(0, 3, 1, 2)
        valid = batch["valid_mask"]
        bsz, dev = rgb.shape[0], rgb.device

        with torch.no_grad():  # the frozen encoder: stop_gradient
            rgb_latent = vae_encode(models.vae, rgb)
            gt_latent = vae_encode(models.vae, gt)
        if cfg.fix_timesteps is not None:
            t = torch.full((bsz,), cfg.fix_timesteps, dtype=torch.long, device=dev)
        else:
            t = torch.randint(0, cfg.num_train_timesteps, (bsz,),
                              generator=generator).to(dev)
        noise = rgb_latent
        noisy = add_noise(sched, gt_latent, noise, t).to(cd)
        target = get_velocity(sched, gt_latent, noise, t)
        embed = models.get_text_embed()
        text = embed.to(cd).expand((bsz,) + tuple(embed.shape[-2:]))

        aux: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), dtype=torch.float32, device=dev)
        mask_latent = downscale_valid_mask(valid)[:, None]  # (B, 1, h, w)

        v = unet_apply(models.unet, noisy, t, text, remat=remat)
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
                l = torch.sum(rel * mm) / (torch.sum(mm) + 1e-6)
            else:
                raise ValueError(name)
            aux[name] = l
            total = total + l
        if all(n.startswith("latent") for n in cfg.loss_names):
            return total, aux
        decoded = vae_decode(models.vae, -v, remat=cfg.remat_vae_decode)

        pred = decoded.mean(dim=1).float() + 2.0  # depth: [-1, 1] -> [1, 3]
        targ = gt[:, 0].float() + 2.0
        table = {"mse": (L.masked_mse, 1.0),
                 "ssi": (lambda p, t_, m_: L.ssi_loss(p, t_, m_, "least_square"), 0.5),
                 "ssi_medium": (lambda p, t_, m_: L.ssi_loss(p, t_, m_, "medium"), 0.5),
                 "grad": (L.gradient_loss, 2.0),
                 "l1": (L.masked_l1, 1.0)}
        for name in cfg.loss_names:
            if name.startswith("latent"):
                continue
            if name not in table:
                raise ValueError(name)
            fn, w = table[name]
            l = fn(pred, targ, valid)
            aux[name] = l
            total = total + w * l
        return total, aux

    return loss_fn


def split_trainable(models, cfg: TrainConfig
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(trainable, frozen), keyed by dotted parameter names ("unet.conv_in.
    weight", ...), per the reference's trainability matrix: the UNet when
    train_unet; the VAE decoder and post_quant_conv when train_vae_decoder;
    the rest and the text embedding frozen. Sets ``requires_grad`` to match."""
    trainable: Dict[str, torch.Tensor] = {}
    frozen: Dict[str, torch.Tensor] = {}
    for prefix, module in (("unet", models.unet), ("vae", models.vae)):
        for name, p in module.named_parameters():
            if prefix == "unet":
                train = cfg.train_unet and cfg.unet_lora_rank is None
            else:
                train = cfg.train_vae_decoder and name.split(".")[0] in (
                    "decoder", "post_quant_conv")
            p.requires_grad_(train)
            (trainable if train else frozen)[f"{prefix}.{name}"] = p
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


def init_train_state(models, cfg: TrainConfig):
    """-> (trainable, frozen, optimizer); trainable parameters cast to
    master_dtype when it is set."""
    check_ported(cfg, models)
    trainable, frozen = split_trainable(models, cfg)
    if cfg.master_dtype is not None:
        for p in trainable.values():
            p.data = p.data.to(cfg.master_dtype)
    return trainable, frozen, make_optimizer(cfg, trainable)


def build_train_step(cfg: TrainConfig, models, optimizer: OptaxAdam):
    """Returns step(batch, generator=None) -> metrics ({"loss", **aux}, 0-dim
    f32 tensors). With grad_accum_steps > 1 every batch entry has a leading
    accumulation axis; gradients and the per-loss aux are summed in f32 over
    it, in order, and divided by its length, as the JAX step's lax.scan."""
    loss_fn = build_loss_fn(cfg, models)
    params = [p for group in optimizer.param_groups for p in group["params"]]

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
            grads = grads_of(loss)
            loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        optimizer.step(grads)
        return {"loss": loss, **aux}

    return step
