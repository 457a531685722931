"""The port's training slice held to the JAX package's, at tiny widths.

The same inputs, made with numpy from a seed, go through the JAX functions
(on the CPU, Pallas in interpret mode where a kernel is reached) and the
port's (plain versions on CPU tensors). Weights are the JAX ``init_*`` trees
filled from numpy seeds, moved with ``state_dict_from_jax``. Tolerances are
stated beside each test.
"""

import glob
import math
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genpercept_tpu.cli.train import resolve_train_config as j_resolve
from genpercept_tpu.data import sampler as j_sampler
from genpercept_tpu.diffusion import schedulers as j_sched
from genpercept_tpu.models import UNetConfig as JUNetConfig
from genpercept_tpu.models import VAEConfig as JVAEConfig
from genpercept_tpu.models import init_unet, init_vae
from genpercept_tpu.ops import norms as j_norms
from genpercept_tpu.pipeline import GenPerceptModels as JModels
from genpercept_tpu.train import losses as JL
from genpercept_tpu.train import train_step as JT
from genpercept_tpu.train.lr import iter_exponential_schedule as j_schedule
from genpercept_tpu.utils.config import recursive_load_config as j_load_config
from genpercept_tpu.utils.logging_util import eval_dic_to_text as j_eval_text
from genpercept_tpu.utils.seeding import generate_seed_sequence as j_seeds
from genpercept_tpu.utils.seeding import seed_all as j_seed_all
from genpercept_tpu_torch.cli.train import resolve_train_config as t_resolve
from genpercept_tpu_torch.data import sampler as t_sampler
from genpercept_tpu_torch.diffusion import schedulers as t_sched
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.models import (
    AutoencoderKL,
    UNet2DConditionModel,
    UNetConfig,
    VAEConfig,
    unet_apply,
    vae_decode,
    vae_encode,
)
from genpercept_tpu_torch.ops import norms as t_norms
from genpercept_tpu_torch.pipeline import GenPerceptModels
from genpercept_tpu_torch.train import losses as TL
from genpercept_tpu_torch.train import train_step as TT
from genpercept_tpu_torch.train.lr import iter_exponential_schedule as t_schedule
from genpercept_tpu_torch.train import trainer as trainer_mod
from genpercept_tpu_torch.train.trainer import Trainer
from genpercept_tpu_torch.utils.config import recursive_load_config as t_load_config
from genpercept_tpu_torch.utils.logging_util import eval_dic_to_text as t_eval_text
from genpercept_tpu_torch.utils.seeding import generate_seed_sequence as t_seeds
from genpercept_tpu_torch.utils.seeding import seed_all as t_seed_all
from test_torch_models import numpy_params

torch.set_num_threads(1)

TINY_UNET = dict(block_out_channels=(32, 64, 128, 128),
                 attention_heads=(1, 2, 4, 4), cross_attention_dim=48)
TINY_VAE = dict(block_out_channels=(32, 32, 64, 64))
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, None: None}


def t(x, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))).to(
        dtype or torch.float32) if np.asarray(x).dtype != bool else torch.from_numpy(
        np.asarray(x))


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def global_rel_l2(a, b):
    """Relative L2 over all parameters of two {name: gradient} dicts."""
    return math.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in a)
                     / sum(np.sum(b[k] ** 2) for k in a))


# ------------------------------------------------------------ small modules


def test_group_norm_native_apply_bf16():
    """bf16 apply in x's dtype, f32 statistics: one bf16 ulp (7.8e-3 at the
    outputs' magnitude 1-4) of the JAX function's output."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 6, 5, 64)) * 3 + 1).astype(np.float32)
    s, b = (rng.normal(size=(64,)).astype(np.float32) for _ in range(2))
    ref = j_norms.group_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s), jnp.asarray(b),
                             32, 1e-6, native_apply=True)
    out = t_norms.group_norm(t(x.transpose(0, 3, 1, 2), torch.bfloat16), t(s), t(b), 32,
                             1e-6, native_apply=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref, np.float32), atol=3e-2, rtol=8e-3)


def _loss_inputs(seed=0, masked="block"):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(1.0, 3.0, size=(2, 12, 10)).astype(np.float32)
    targ = rng.uniform(1.0, 3.0, size=(2, 12, 10)).astype(np.float32)
    mask = np.ones((2, 12, 10), bool)
    if masked == "block":
        mask[:, :4, :3] = False
    elif masked == "all":
        mask[:] = False
    return pred, targ, mask


LOSSES = {
    "masked_mse": lambda m: m.masked_mse,
    "masked_l1": lambda m: m.masked_l1,
    "l1_disp_loss": lambda m: m.l1_disp_loss,
    "l1_inverse_loss": lambda m: m.l1_inverse_loss,
    "sig_loss": lambda m: m.sig_loss,
    "ssi_least_square": lambda m: lambda p, q, k: m.ssi_loss(p, q, k, "least_square"),
    "ssi_medium": lambda m: lambda p, q, k: m.ssi_loss(p, q, k, "medium"),
    "gradient_loss": lambda m: m.gradient_loss,
    "gradient_loss_2scales": lambda m: lambda p, q, k: m.gradient_loss(p, q, k, 2),
    "gradient_log_loss": lambda m: m.gradient_log_loss,
    "silog_mse_masked": lambda m: lambda p, q, k: m.silog_mse(p, q, mask=k),
    "silog_mse": lambda m: lambda p, q, k: m.silog_mse(p, q),
    "silog_rmse": lambda m: lambda p, q, k: m.silog_rmse(p, q, mask=k, alpha=2.0),
    "mean_abs_rel": lambda m: lambda p, q, k: m.mean_abs_rel(p, q),
}


@pytest.mark.parametrize("masked", ["block", "all"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name, masked):
    """Value and gradient w.r.t. the prediction, f32: 1e-5 relative (sums
    in another order); the all-masked case must give the same finite
    fallback as JAX (ssi's median of an empty set is 1)."""
    pred, targ, mask = _loss_inputs(masked=masked)
    jfn, tfn = LOSSES[name](JL), LOSSES[name](TL)
    jval, jgrad = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(targ), jnp.asarray(mask)))(
        jnp.asarray(pred))
    tp = t(pred).requires_grad_()
    tval = tfn(tp, t(targ), t(mask))
    (tgrad,) = torch.autograd.grad(tval, tp, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(np.asarray(jgrad)).max())))


@pytest.mark.parametrize("n", [120, 119])
def test_ssi_medium_median_is_the_midpoint(n):
    """jnp.median averages the two middle values of an even count, where
    torch.median takes the lower; _masked_median stays the LOWER median."""
    x = np.random.default_rng(1).normal(size=(2, n)).astype(np.float32)
    np.testing.assert_array_equal(TL._median(t(x)).numpy(), np.asarray(jnp.median(x, axis=1)))
    mask = np.random.default_rng(2).uniform(size=(2, n)) > 0.3
    np.testing.assert_array_equal(TL._masked_median(t(x), t(mask)).numpy(),
                                  np.asarray(JL._masked_median(jnp.asarray(x),
                                                               jnp.asarray(mask))))


@pytest.mark.parametrize("kappa", [False, True])
def test_normal_losses_match_jax(kappa):
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(2, 6, 5, 4 if kappa else 3)).astype(np.float32)
    targ = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 6, 5)) > 0.2
    for jfn, tfn in ((JL.angular_loss, TL.angular_loss), (JL.normal_l1_loss, TL.normal_l1_loss)):
        np.testing.assert_allclose(float(tfn(t(pred), t(targ), t(mask))),
                                   float(jfn(jnp.asarray(pred), jnp.asarray(targ),
                                             jnp.asarray(mask))), rtol=1e-5)


def test_compute_scale_and_shift_and_get_loss():
    """(s, t) to 1e-5 absolute: t cancels two products of ~1e3 sums (reading
    1.8e-6); the factory's losses to 1e-5 relative."""
    pred, targ, mask = _loss_inputs(seed=4)
    for a, b in zip(TL.compute_scale_and_shift(t(pred), t(targ), t(mask)),
                    JL.compute_scale_and_shift(*map(jnp.asarray, (pred, targ, mask)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for name in ("silog_mse", "silog_rmse", "mse_loss", "l1_loss", "l1_loss_with_mask",
                 "mean_abs_rel"):
        np.testing.assert_allclose(
            float(TL.get_loss(name)(t(pred), t(targ), mask=t(mask))),
            float(JL.get_loss(name)(jnp.asarray(pred), jnp.asarray(targ),
                                    mask=jnp.asarray(mask))), rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("step", [0, 1, 99, 100, 5000, 25000, 30000])
def test_iter_exponential_schedule(step):
    """f32 in both: equal to 1e-6 relative (exp in another library)."""
    args = (3e-5, 25000, 0.01, 100)
    np.testing.assert_allclose(t_schedule(*args)(step), float(j_schedule(*args)(step)),
                               rtol=1e-6, atol=0)


def test_downscale_valid_mask():
    m = np.random.default_rng(5).uniform(size=(2, 32, 24)) > 0.02
    np.testing.assert_array_equal(TT.downscale_valid_mask(t(m)).numpy(),
                                  np.asarray(JT.downscale_valid_mask(jnp.asarray(m))))


@pytest.mark.parametrize("cfg", [j_sched.GENPERCEPT_SCHEDULER, j_sched.SchedulerConfig(),
                                 j_sched.SchedulerConfig(beta_schedule="scaled_linear_power",
                                                         power_beta_curve=2.0,
                                                         rescale_betas_zero_snr=True)])
def test_add_noise_and_get_velocity(cfg):
    """bf16 sample and noise, int timesteps: f32 results, 1e-6 relative."""
    tcfg = t_sched.SchedulerConfig(**vars(cfg))
    rng = np.random.default_rng(6)
    x0, noise = (rng.normal(size=(3, 4, 5, 6)).astype(np.float32) for _ in range(2))
    ts = np.array([0, 17, 999])
    js, ts_ = j_sched.make_scheduler(cfg), t_sched.make_scheduler(tcfg)
    np.testing.assert_allclose(ts_.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    for jf, tf in ((j_sched.add_noise, t_sched.add_noise),
                   (j_sched.get_velocity, t_sched.get_velocity)):
        ref = jf(js, jnp.asarray(x0, jnp.bfloat16), jnp.asarray(noise, jnp.bfloat16),
                 jnp.asarray(ts))
        out = tf(ts_, t(x0, torch.bfloat16), t(noise, torch.bfloat16), torch.from_numpy(ts))
        assert out.dtype == torch.float32 and ref.dtype == jnp.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_seeding_and_eval_table_match_jax():
    assert t_seeds(7, 50) == j_seeds(7, 50)
    assert t_seeds(None, 3) == [None] * 3
    states = []
    for seed_all in (j_seed_all, t_seed_all):
        seed_all(2**40 + 3)
        states.append((random.random(), np.random.random()))
    assert states[0] == states[1]
    metrics = {"abs_relative_difference": 0.0712, "delta1_acc": 0.951}
    assert (t_eval_text(metrics, "nyu", "test.txt", diff="x")
            == j_eval_text(metrics, "nyu", "test.txt", diff="x"))


# ---------------------------------------------------------------- the slice


def make_batch(b=2, hw=64, seed=11):
    """tests/test_train.py's batch: a contiguous invalid block, because a
    scattered one invalidates every 8x8 latent cell. The seed is one where
    no L1 residual of the pixel losses lies near 0 (see _l1_margin)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, hw, hw), bool)
    mask[:, : hw // 4, : hw // 4] = False
    return {"rgb_norm": rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
            "gt_norm": rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
            "valid_mask": mask}


@pytest.fixture(scope="module")
def tiny():
    ucfg, vcfg = JUNetConfig(**TINY_UNET), JVAEConfig(**TINY_VAE)
    unet_p = numpy_params(init_unet, ucfg, seed=20)
    vae_p = numpy_params(init_vae, vcfg, seed=21)
    embed = np.random.default_rng(22).normal(size=(1, 77, 48)).astype(np.float32)
    jmodels = JModels(unet=unet_p, vae=vae_p, unet_cfg=ucfg, vae_cfg=vcfg,
                      text_embed=jnp.asarray(embed))
    return jmodels, unet_p, vae_p, embed


def port_models(tiny, dtype=torch.float32):
    _, unet_p, vae_p, embed = tiny
    unet = UNet2DConditionModel(UNetConfig(**TINY_UNET))
    unet.load_state_dict(state_dict_from_jax(unet_p), strict=True)
    vae = AutoencoderKL(VAEConfig(**TINY_VAE))
    vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
    return GenPerceptModels(unet=unet.to(dtype), vae=vae.to(dtype),
                            text_embed=torch.from_numpy(embed).to(dtype))


def torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def port_loss_and_grads(tiny, cfg, batch, dtype=torch.float32):
    models = port_models(tiny, dtype)
    trainable, _, _ = TT.init_train_state(models, cfg)
    loss, aux = TT.build_loss_fn(cfg, models)(torch_batch(batch))
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return loss.item(), {k: v.item() for k, v in aux.items()}, {
        k: g.float().numpy() for k, g in zip(trainable, grads)}


_JAX_CACHE = {}


def jax_loss_and_grads(tiny, losses, dtype=jnp.float32):
    """jax.value_and_grad of the JAX build_loss_fn (remat off: in f32 it
    changes no number), flattened to the port's names and layouts."""
    key = (losses, dtype)
    if key not in _JAX_CACHE:
        jmodels = tiny[0]
        cfg = JT.TrainConfig(loss_names=losses, fix_timesteps=1, compute_dtype=dtype)
        trainable, frozen = JT.split_trainable(jmodels.params(), cfg)
        fn = jax.jit(jax.value_and_grad(JT.build_loss_fn(cfg, jmodels), has_aux=True))
        batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
        (loss, aux), grads = fn(trainable, frozen, batch, jax.random.key(0))
        flat = state_dict_from_jax({"unet": jax.tree.map(
            lambda g: np.asarray(g, np.float32), grads["unet"])})
        _JAX_CACHE[key] = (float(loss), {k: float(v) for k, v in aux.items()},
                           {k: v.numpy() for k, v in flat.items()})
    return _JAX_CACHE[key]


def _l1_margin(tiny, batch):
    """The smallest |residual| under an L1 of the pixel losses (the gradient
    loss's neighbour differences, the least-square SSI's aligned residual)
    over valid pixels, on the port's f32 prediction. The two frameworks'
    predictions differ by ~3e-5 here (sums in another order), and a residual
    within that of 0 can take opposite signs in the two: one such sign flips
    the gradient of the gradient loss by ~2% (batch seed 0 has one)."""
    models = port_models(tiny)
    tb = torch_batch(batch)
    with torch.no_grad():
        x = tb["rgb_norm"].permute(0, 3, 1, 2)
        v = unet_apply(models.unet, vae_encode(models.vae, x), torch.tensor(1),
                       models.text_embed.expand(2, 77, 48))
        pred = vae_decode(models.vae, -v).mean(1) + 2
    targ, m = tb["gt_norm"][..., 0] + 2, tb["valid_mask"]
    d = (pred - targ) * m
    res = [(d[:, :, 1:] - d[:, :, :-1])[m[:, :, 1:] & m[:, :, :-1]],
           (d[:, 1:] - d[:, :-1])[m[:, 1:] & m[:, :-1]]]
    s, t_ = TL.compute_scale_and_shift(pred, targ, m)
    res.append((pred * s[:, None, None] + t_[:, None, None] - targ)[m])
    return float(torch.cat(res).abs().min())


REMAT = {"off": dict(remat_unet=False),
         "unet": dict(remat_unet=True, remat_granularity="unet"),
         "block": dict(remat_unet=True, remat_granularity="block")}


@pytest.mark.parametrize("remat", sorted(REMAT))
@pytest.mark.parametrize("losses", [("mse", "ssi", "grad"), ("latent_mse", "latent_l1")])
def test_loss_fn_matches_jax_f32(tiny, losses, remat):
    """f32, fix_timesteps=1: loss and each aux to 1e-5 relative; the
    gradients to 1e-4 global relative L2 and each parameter's to 1e-3
    relative L2 (summation order through ~60 layers; readings up to 5e-5
    and 1e-4), skipping the parameters whose gradient is 0 up to rounding
    (< 1e-6 of the largest: biases that a GroupNorm cancels). With remat
    on, the port's gradients equal its own without remat bit for bit (the
    recompute repeats the same CPU ops)."""
    if "grad" in losses:
        assert _l1_margin(tiny, make_batch()) >= 1e-4
    jloss, jaux, jgrads = jax_loss_and_grads(tiny, losses)
    cfg = TT.TrainConfig(loss_names=losses, fix_timesteps=1, **REMAT[remat])
    loss, aux, grads = port_loss_and_grads(tiny, cfg, make_batch())
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert aux.keys() == jaux.keys()
    for k in aux:
        np.testing.assert_allclose(aux[k], jaux[k], rtol=1e-5, err_msg=k)
    assert grads.keys() == jgrads.keys()
    assert global_rel_l2(grads, jgrads) <= 1e-4
    top = max(np.linalg.norm(g) for g in jgrads.values())
    worst = max(rel_l2(grads[k], jgrads[k]) for k in grads
                if np.linalg.norm(jgrads[k]) > 1e-6 * top)
    assert worst <= 1e-3, worst
    if remat != "off":
        _, _, plain = port_loss_and_grads(
            tiny, TT.TrainConfig(loss_names=losses, fix_timesteps=1), make_batch())
        for k in grads:
            np.testing.assert_array_equal(grads[k], plain[k], err_msg=k)


def test_latent_mean_abs_rel_matches_jax(tiny):
    """|v - t| / max(|t|, 1e-6) over latent cells: the cells whose target is
    near 0 dominate the loss (~80 here) and amplify the encoders' f32
    differences in t, so the bounds are loose and stated: loss 1e-2 relative
    (reading 3.1e-3), gradients 2e-2 global relative L2 (reading 6.9e-3)."""
    losses = ("latent_mean_abs_rel",)
    jloss, _, jgrads = jax_loss_and_grads(tiny, losses)
    loss, _, grads = port_loss_and_grads(
        tiny, TT.TrainConfig(loss_names=losses, fix_timesteps=1), make_batch())
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    assert global_rel_l2(grads, jgrads) <= 2e-2


def test_loss_fn_matches_jax_bf16(tiny):
    """bf16 compute (the recipe) on f32 weights, cast per op in both. The
    bf16 gradients of this tiny random model lie far from its f32 ones in
    both frameworks, since each bf16 rounding of an activation moves and the
    L1 terms' signs follow (readings, global relative L2 to JAX's f32
    gradients: JAX bf16 0.41, the port 0.53). Bounds: the port's bf16
    gradients no farther from JAX's f32 gradients than 1.5x JAX's own bf16
    gradients are; the loss within 1e-2 of JAX's bf16 loss (reading 5e-4)."""
    losses = ("mse", "ssi", "grad")
    jloss, _, jgrads = jax_loss_and_grads(tiny, losses, jnp.bfloat16)
    _, _, jgrads32 = jax_loss_and_grads(tiny, losses)
    cfg = TT.TrainConfig(loss_names=losses, fix_timesteps=1, compute_dtype=torch.bfloat16,
                         remat_unet=True)
    loss, _, grads = port_loss_and_grads(tiny, cfg, make_batch())
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    assert global_rel_l2(grads, jgrads32) <= 1.5 * global_rel_l2(jgrads, jgrads32)


# ------------------------------------------------------- optimizer and step


def test_optimizer_matches_optax_adam():
    """Identical gradients, 3 steps, bf16 first moment, warmup 2 (the first
    update at lr 0) and a decoder group at 3x lr: parameters to 1e-6
    relative and f32 ulp-level absolute (1e-10), mu equal after bf16 rounding
    up to one bf16 ulp."""
    rng = np.random.default_rng(30)
    params = {"unet": {"w": rng.normal(size=(6, 5)).astype(np.float32)},
              "vae": {"b": rng.normal(size=(7,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
             for _ in range(3)]
    kw = dict(lr=1e-2, decoder_lr=3e-2, lr_warmup_steps=2, lr_total_iter_length=10)
    jtx = JT.make_optimizer(JT.TrainConfig(adam_mu_dtype=jnp.bfloat16, **kw))
    jp = jax.tree.map(jnp.asarray, params)
    state = jtx.init(jp)
    for g in grads:
        upd, state = jtx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {"unet.w": torch.nn.Parameter(t(params["unet"]["w"])),
          "vae.b": torch.nn.Parameter(t(params["vae"]["b"]))}
    opt = TT.make_optimizer(TT.TrainConfig(adam_mu_dtype=torch.bfloat16, **kw), tp)
    for g in grads:
        opt.step([t(g["unet"]["w"]), t(g["vae"]["b"])])
    np.testing.assert_allclose(tp["unet.w"].detach().numpy(), np.asarray(jp["unet"]["w"]),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(tp["vae.b"].detach().numpy(), np.asarray(jp["vae"]["b"]),
                               rtol=1e-6, atol=1e-10)
    assert opt.state[tp["unet.w"]]["mu"].dtype == torch.bfloat16
    jmu = np.asarray(state[0][0].mu["unet"]["w"], np.float32)
    np.testing.assert_allclose(opt.state[tp["unet.w"]]["mu"].float().numpy(), jmu,
                               rtol=8e-3)


def test_train_step_with_accumulation_matches_jax(tiny):
    """One optimizer step over 2 micro-batches of 1, f32, at the recipe's
    lr 0 first update (count 0 of a 100-step warmup): the parameters stay,
    the metrics agree to 1e-5 relative, and the first moments, 0.1 x the
    accumulated gradient, to 1e-4 global relative L2 and 1e-3 per parameter
    (as the loss test; gradients < 1e-6 of the largest are rounding)."""
    cfg_kw = dict(loss_names=("mse", "ssi", "grad"), fix_timesteps=1, grad_accum_steps=2)
    batch = {k: v.reshape((2, 1) + v.shape[1:]) for k, v in make_batch().items()}
    jmodels = tiny[0]
    jcfg = JT.TrainConfig(**cfg_kw)
    trainable, frozen, tx, opt_state = JT.init_train_state(jmodels.params(), jcfg)
    jstep = jax.jit(JT.build_train_step(jcfg, jmodels, tx))
    _, jstate, jmetrics = jstep(trainable, frozen, opt_state,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.key(0))
    jmu = {k: v.numpy() for k, v in state_dict_from_jax({"unet": jax.tree.map(
        np.asarray, jstate[0].mu["unet"])}).items()}

    models = port_models(tiny)
    before = {k: p.detach().clone() for k, p in models.unet.named_parameters()}
    cfg = TT.TrainConfig(**cfg_kw)
    trainable, _, opt = TT.init_train_state(models, cfg)
    metrics = TT.build_train_step(cfg, models, opt)(torch_batch(batch))
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    for k, p in models.unet.named_parameters():
        assert torch.equal(p.detach(), before[k]), k
    mu = {k: opt.state[p]["mu"].numpy() for k, p in trainable.items()}
    assert global_rel_l2(mu, jmu) <= 1e-4
    top = max(np.linalg.norm(m) for m in jmu.values())
    worst = max(rel_l2(mu[k], jmu[k]) for k in mu if np.linalg.norm(jmu[k]) > 1e-6 * top)
    assert worst <= 1e-3, worst


class RecordGrads:
    """Stands in for the optimizer: keeps the gradients it is handed."""

    def __init__(self, params):
        self.param_groups = [{"params": list(params)}]

    def step(self, grads):
        self.grads = [g.clone() for g in grads]


def test_accumulation_matches_one_big_batch(tiny):
    """2 micro-batches of 1 give the gradient of 1 batch of 2 (both means),
    f32: 1e-4 relative L2 per parameter (sums in another order; reading
    ~1e-6), skipping gradients that are rounding (< 1e-6 of the largest)."""
    cfg_kw = dict(loss_names=("latent_mse",), fix_timesteps=1)
    batch = torch_batch(make_batch())
    results = []
    for accum, b in ((1, batch), (2, {k: v.reshape((2, 1) + v.shape[1:])
                                      for k, v in batch.items()})):
        cfg = TT.TrainConfig(grad_accum_steps=accum, **cfg_kw)
        models = port_models(tiny)
        trainable, _, _ = TT.init_train_state(models, cfg)
        rec = RecordGrads(trainable.values())
        TT.build_train_step(cfg, models, rec)(b)
        results.append(rec.grads)
    top = max(float(g.norm()) for g in results[0])
    for g1, g2 in zip(*results):
        if float(g1.norm()) > 1e-6 * top:
            assert rel_l2(g2.numpy(), g1.numpy()) <= 1e-4


def test_split_trainable_matches_jax(tiny):
    jmodels = tiny[0]
    for kw in (dict(), dict(train_unet=True, train_vae_decoder=True),
               dict(train_unet=False, train_vae_decoder=True)):
        jt, jf = JT.split_trainable(jmodels.params(), JT.TrainConfig(**kw))
        tt, tf = TT.split_trainable(port_models(tiny), TT.TrainConfig(**kw))
        assert set(tt) == set(state_dict_from_jax(jt)), kw
        assert set(tf) == set(state_dict_from_jax(jf)), kw
        assert all(p.requires_grad for p in tt.values())
        assert not any(p.requires_grad for p in tf.values())


def test_unported_fields_raise(tiny):
    """The non-depth modes, the marigold arch, LoRA, multi-resolution noise
    and the metric3d losses are ported: their train states build (the
    CLI's one refusal, tensor parallelism, ROADMAP Queue 1 item 12, is
    tests/test_torch_train_cli.py's)."""
    for kw in (dict(arch="marigold"), dict(unet_lora_rank=4), dict(mode="normal"),
               dict(multi_res_noise_strength=0.9), dict(loss_names=("mse", "vnl"))):
        models = port_models(tiny)
        trainable, _, _ = TT.init_train_state(models, TT.TrainConfig(**kw))
        TT.build_loss_fn(TT.TrainConfig(**kw), models)
        assert trainable
    assert not hasattr(TT, "check_ported")


# ---------------------------------------------------------------- recipes

RECIPES = sorted(glob.glob("configs/train/**/*.yaml", recursive=True))


def as_port_config(jcfg) -> TT.TrainConfig:
    fields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    for f in ("adam_mu_dtype", "master_dtype", "compute_dtype"):
        fields[f] = DTYPES[None if fields[f] is None else jnp.dtype(fields[f]).type]
    fields["scheduler"] = t_sched.SchedulerConfig(**vars(jcfg.scheduler))
    return TT.TrainConfig(**fields)


def test_recipe_count():
    assert len(RECIPES) == 61


@pytest.mark.parametrize("path", RECIPES)
def test_resolve_train_config_matches_jax(path):
    """Every recipe gives the TrainConfig JAX's resolves to (dtypes mapped),
    or the same exception type."""
    try:
        want = as_port_config(j_resolve(j_load_config(path)))
    except Exception as e:  # noqa: BLE001 - the port must raise the same type
        with pytest.raises(type(e)):
            t_resolve(t_load_config(path))
        return
    assert t_resolve(t_load_config(path)) == want


def test_chip_smoke_config_is_the_main_paper_recipe():
    import chip_smoke

    assert chip_smoke.TRAIN_CFG == t_resolve(t_load_config("configs/train/main_paper/depth.yaml"))


# ------------------------------------------------------- sampler and trainer


def test_sampler_stream_and_skip_match_jax():
    sizes = (13, 7, 20)
    datasets = [[{"i": np.int64(i)} for i in range(n)] for n in sizes]
    streams = []
    for mod in (j_sampler, t_sampler):
        concat = mod.ConcatDataset(datasets)
        sampler = mod.MixedBatchSampler(datasets, batch_size=3, prob=[0.5, 0.2, 0.3],
                                        generator=np.random.default_rng(5))
        loader = mod.DataLoader(concat, sampler)
        streams.append(([b["i"].tolist() for b in loader],
                        [b["i"].tolist() for b in mod.skip_first_batches(loader, 4)]))
    assert streams[0] == streams[1]
    assert len(streams[1][0]) == sum(n // 3 for n in sizes)


class _Synthetic:
    """Training samples from a numpy seed, in the dataset readers' layout."""

    def __init__(self, n, hw, seed):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            mask = np.ones((hw, hw), bool)
            mask[: hw // 4, : hw // 4] = False
            self.items.append({"rgb_norm": rng.uniform(-1, 1, (hw, hw, 3)).astype(np.float32),
                               "depth_raw_norm": rng.uniform(-1, 1, (hw, hw)).astype(np.float32),
                               "valid_mask_raw": mask})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _trainer(tiny, out_dir, max_iter):
    data = _Synthetic(8, 32, seed=40)
    loader = t_sampler.DataLoader(data, t_sampler.MixedBatchSampler(
        [data], batch_size=2, generator=np.random.default_rng(41)))
    cfg = TT.TrainConfig(loss_names=("mse", "ssi", "grad"), lr=1e-3, lr_warmup_steps=1,
                         grad_accum_steps=2, adam_mu_dtype=torch.bfloat16,
                         remat_unet=True)
    return Trainer(cfg, port_models(tiny), loader, str(out_dir), max_iter=max_iter,
                   save_period=0, main_seed=3)


def test_trainer_resume_is_bitwise(tiny, tmp_path, monkeypatch):
    """4 steps straight equal 2 steps, a save, a fresh Trainer, a load and 2
    more, bit for bit (timesteps drawn from the replayed seed sequence)."""
    straight = _trainer(tiny, tmp_path / "a", 4)
    straight.train()
    first = _trainer(tiny, tmp_path / "b", 4)
    clock = iter([0.0, 0.0, 10.0])  # the time budget ends after step 2
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(time=lambda: next(clock)))
    first.train(t_end=5.0)
    monkeypatch.undo()
    assert first.effective_iter == 2
    resumed = _trainer(tiny, tmp_path / "b", 4)
    resumed.load_checkpoint("latest")
    assert (resumed.effective_iter, resumed.n_batch_in_epoch) == (2, 2)
    resumed.train()
    assert resumed.effective_iter == 4
    for k, p in straight.trainable.items():
        np.testing.assert_array_equal(resumed.trainable[k].detach().numpy(),
                                      p.detach().numpy(), err_msg=k)
    lines = (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4 * 4  # loss, mse, ssi, grad per step


def test_trainer_validates_on_rank0_only(tiny, tmp_path, monkeypatch):
    """In a data-parallel run rank 0 alone validates and visualizes, then
    every rank meets at a barrier, as the JAX trainer's processes do; the
    others write no metrics (tests/test_torch_parallel.py runs two ranks)."""
    from genpercept_tpu_torch import parallel

    met = []
    monkeypatch.setattr(parallel, "check_replicated", lambda tensors, what="": None)
    monkeypatch.setattr(parallel, "barrier", lambda: met.append(parallel.rank()))
    for rank in (1, 0):
        monkeypatch.setattr(parallel, "rank", lambda r=rank: r)
        trainer = Trainer(TT.TrainConfig(), port_models(tiny), [], str(tmp_path / str(rank)),
                          val_period=10, vis_period=5)
        ran = []
        monkeypatch.setattr(trainer, "validate", lambda: ran.append("val"))
        monkeypatch.setattr(trainer, "visualize", lambda: ran.append("vis"))
        trainer.effective_iter = 10
        trainer._periodic_callbacks()
        assert ran == ([] if rank else ["val", "vis"]) and met[-1] == rank
        assert (tmp_path / str(rank) / "metrics.jsonl").exists() == (rank == 0)


# ------------------------------------------------ kernel launches per step


def _jax_step_launches(h, w, b, monkeypatch):
    """Pallas kernel calls in one JAX training micro-step (value_and_grad of
    the loss, remat off), traced abstractly with the kernels stubbed."""
    import genpercept_tpu.ops.flash_attention as jfa
    import genpercept_tpu.ops.fused_ff as jff

    seen = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def flash(qh, kh, vh, scale, kv_valid=None):
        seen["K1"] += 1
        return jnp.zeros_like(qh), jnp.zeros(qh.shape[:2] + (1,), jnp.float32)

    def flash_bwd(qh, kh, vh, oh, do, lse, scale, kv_valid=None):
        seen["K3"] += 1
        seen["K4"] += 1
        return jnp.zeros_like(qh), jnp.zeros_like(kh), jnp.zeros_like(vh)

    def ff(x, *args):
        seen["K2"] += 1
        return jnp.zeros_like(x)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfa, "_flash_bhsd", flash)
    monkeypatch.setattr(jfa, "_flash_bwd_bhsd", flash_bwd)
    monkeypatch.setattr(jff, "_fused_geglu_fwd_impl", ff)
    sds = jax.ShapeDtypeStruct
    models = JModels(unet=jax.eval_shape(init_unet, jax.random.key(0)),
                     vae=jax.eval_shape(init_vae, jax.random.key(0)),
                     text_embed=sds((1, 77, 1024), jnp.float32))
    cfg = JT.TrainConfig(fix_timesteps=1, compute_dtype=jnp.bfloat16, remat_unet=False,
                         remat_vae_decode=False)
    trainable, frozen = JT.split_trainable(models.params(), cfg)
    batch = {"rgb_norm": sds((b, h, w, 3), jnp.float32), "gt_norm": sds((b, h, w, 3), jnp.float32),
             "valid_mask": sds((b, h, w), jnp.bool_)}
    jax.eval_shape(jax.value_and_grad(JT.build_loss_fn(cfg, models), has_aux=True),
                   trainable, frozen, batch, jax.random.key(0))
    monkeypatch.undo()
    return seen


def _port_step_launches(h, w, b, remat, monkeypatch):
    """Kernel launches in one of the port's micro-steps (loss and backward)
    at full SD2.1 width on the meta device, the launchers stubbed by
    counters and the dispatch told that meta tensors take kernels."""
    from genpercept_tpu_torch.ops import _dispatch
    from genpercept_tpu_torch.ops import flash_attention as tfa
    from genpercept_tpu_torch.ops import fused_ff as tff

    seen = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def bump(name, out):
        seen[name] += 1
        return out

    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(tfa, "_flash_bhsd", lambda qh, kh, vh, scale: bump(
        "K1", (torch.empty_like(qh), torch.empty(qh.shape[:2] + (1,), device=qh.device))))
    monkeypatch.setattr(tfa, "_flash_bwd_dq", lambda qh, *a: bump("K3", torch.empty_like(qh)))
    monkeypatch.setattr(tfa, "_flash_bwd_dkv", lambda qh, kh, vh, *a: bump(
        "K4", (torch.empty_like(kh), torch.empty_like(vh))))
    monkeypatch.setattr(tff, "_fused_geglu_ff_fwd", lambda x, *a: bump("K2", torch.empty_like(x)))
    with torch.device("meta"):
        models = GenPerceptModels(unet=UNet2DConditionModel(), vae=AutoencoderKL(),
                                  text_embed=torch.empty(1, 77, 1024))
        batch = {"rgb_norm": torch.empty(b, h, w, 3), "gt_norm": torch.empty(b, h, w, 3),
                 "valid_mask": torch.empty(b, h, w, dtype=torch.bool)}
    cfg = TT.TrainConfig(fix_timesteps=1, compute_dtype=torch.bfloat16, remat_unet=remat,
                         remat_vae_decode=remat)
    trainable, _, _ = TT.init_train_state(models, cfg)
    loss, _ = TT.build_loss_fn(cfg, models)(batch)
    torch.autograd.grad(loss, list(trainable.values()))
    monkeypatch.undo()
    return seen


# (image, micro-batch): per micro-step launches with remat_unet and
# remat_vae_decode (the recipe). 480x640: K1 = 2 encoder + 5 UNet level-0 +
# 1 decoder + 6 recomputed, K2 = 5 + 5 recomputed, K3 = K4 = 5 + 1 backward.
# 768^2 adds UNet levels 1 and 2 (2304 and 576 tokens) to each K1 count.
STEP_LAUNCHES = {((480, 640), 8): {"K1": 14, "K2": 10, "K3": 6, "K4": 6},
                 ((768, 768), 2): {"K1": 34, "K2": 10, "K3": 16, "K4": 16}}


@pytest.mark.parametrize("image,micro", list(STEP_LAUNCHES))
def test_training_launches_match_jax_routing(image, micro, monkeypatch):
    """Without remat the port launches each kernel as often per micro-step
    as JAX calls its Pallas kernel on an accelerator (JAX's abstract trace
    does not re-enter Python for rematerialized forwards, so remat is off
    there); with the recipe's remat the recomputed forwards add K1 and K2
    launches: the counts chip_smoke.py checks on the card."""
    h, w = image
    jax_seen = _jax_step_launches(h, w, micro, monkeypatch)
    assert _port_step_launches(h, w, micro, False, monkeypatch) == jax_seen
    remat = STEP_LAUNCHES[(image, micro)]
    assert jax_seen == {"K1": remat["K1"] - remat["K3"], "K2": remat["K2"] // 2,
                        "K3": remat["K3"], "K4": remat["K4"]}
    assert _port_step_launches(h, w, micro, True, monkeypatch) == remat
