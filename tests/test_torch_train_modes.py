"""The port's training step beyond the depth recipe, held to the JAX package's.

The non-depth modes and their losses, a DPT head (depth, disparity_dpt_head,
a frozen UNet), the marigold and rgb_blending archs (marigold's conv_in
surgery, gaussian and multi-resolution noise), and the metric3d losses in
the step, on tests/test_torch_train.py's tiny models and batch. The same
weights go into both packages (numpy seeds, ``state_dict_from_jax``); where
the JAX step draws random numbers, the test replays its key sequence and
hands the draws to the port's loss (``draws``). Bars as
tests/test_torch_train.py's f32 ones: loss and aux to 1e-5 relative,
gradients to 1e-4 global relative L2 and 1e-3 per parameter (those at least
1e-6 of the largest). Also: the datasets' intrinsics, the trainer's
``batch["intrinsic"]``, the registry, and what the CLIs no longer refuse.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpercept_tpu.cli.train import resolve_train_config as j_resolve
from genpercept_tpu.data import datasets as JD
from genpercept_tpu.models import dpt_head as j_dpt
from genpercept_tpu.pipeline import GenPerceptModels as JModels
from genpercept_tpu.train import metric3d_losses as J3
from genpercept_tpu.train import noise as JN
from genpercept_tpu.train import registry as j_registry
from genpercept_tpu.train import train_step as JT
from genpercept_tpu.utils.config import recursive_load_config as j_load_config
from genpercept_tpu_torch.data import datasets as TD
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.models import DPTHead, DPTHeadConfig
from genpercept_tpu_torch.train import registry as t_registry
from genpercept_tpu_torch.train import train_step as TT
from genpercept_tpu_torch.train.trainer import Trainer
from test_torch_metric3d import hdnl_uniforms, hdsnl_windows, vnl_indices
from test_torch_models import numpy_params
from test_torch_train import (  # noqa: F401  (tiny is a module-scoped fixture)
    as_port_config,
    global_rel_l2,
    make_batch,
    port_models,
    rel_l2,
    tiny,
    torch_batch,
)

torch.set_num_threads(1)

TINY_DPT = dict(neck_hidden_sizes=(32, 64, 128, 128), fusion_hidden_size=16)


def grads_close(grads, jgrads, global_bar=1e-4):
    assert grads.keys() == jgrads.keys()
    assert global_rel_l2(grads, jgrads) <= global_bar
    top = max(np.linalg.norm(g) for g in jgrads.values())
    worst = max(rel_l2(grads[k], jgrads[k]) for k in grads
                if np.linalg.norm(jgrads[k]) > 1e-6 * top)
    assert worst <= 1e-3, worst


def jax_loss_and_grads(jmodels, jcfg, batch, key=None, trainable_override=None):
    """JAX's value_and_grad of its loss on (trainable, frozen) from
    split_trainable, flattened to the port's names and layouts. Under bf16
    compute the frozen tree is stored in bf16, as the JAX Trainer casts it
    (genpercept_tpu/train/trainer.py:94-103)."""
    trainable, frozen = JT.split_trainable(jmodels.params(), jcfg, jax.random.key(0))
    if trainable_override:
        trainable = {**trainable, **trainable_override}
    if jcfg.compute_dtype == jnp.bfloat16:
        frozen = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                              if hasattr(x, "dtype") and x.dtype == jnp.float32 else x, frozen)
    fn = jax.jit(jax.value_and_grad(JT.build_loss_fn(jcfg, jmodels), has_aux=True))
    (loss, aux), grads = fn(trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.key(0) if key is None else key)
    flat = state_dict_from_jax(jax.tree.map(lambda g: np.asarray(g, np.float32), grads))
    return float(loss), {k: float(v) for k, v in aux.items()}, {
        k: v.numpy() for k, v in flat.items()}


def port_loss_and_grads(models, cfg, batch, draws=None):
    trainable, _, _ = TT.init_train_state(models, cfg)
    loss, aux = TT.build_loss_fn(cfg, models)(torch_batch(batch), draws=draws)
    grads = torch.autograd.grad(loss, list(trainable.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.item(), {k: v.item() for k, v in aux.items()}, {
        k: g.float().numpy() for k, g in zip(trainable, grads)}


def assert_match(port, ref, global_bar=1e-4):
    (loss, aux, grads), (jloss, jaux, jgrads) = port, ref
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert aux.keys() == jaux.keys()
    for k in aux:
        np.testing.assert_allclose(aux[k], jaux[k], rtol=1e-5, err_msg=k)
    grads_close(grads, jgrads, global_bar)


def jax_cfg(**kw):
    return JT.TrainConfig(fix_timesteps=1, **kw)


# ------------------------------------------------------------ non-depth modes

# mode -> loss names: normal's angular, and seg's (dis's and matting's take
# the same branch) mse with l1 behind a with_latent_loss recipe's latent_mse
MODES = {
    "normal": ("angular",),
    "seg": ("latent_mse", "mse", "l1"),
}
# angular's gradient carries arccos' 1 / sqrt(1 - cos^2) (up to ~70 at the
# 1 - 1e-4 clip), which amplifies the two frameworks' ~3e-5 prediction
# differences at aligned pixels: 3e-4 global (reading 1.4e-4)
GLOBAL_BAR = {"normal": 3e-4}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_non_depth_modes_match_jax(tiny, mode):
    losses = MODES[mode]
    jcfg = jax_cfg(mode=mode, loss_names=losses)
    ref = jax_loss_and_grads(tiny[0], jcfg, make_batch())
    assert_match(port_loss_and_grads(port_models(tiny), as_port_config(jcfg), make_batch()), ref,
                 GLOBAL_BAR.get(mode, 1e-4))


@pytest.mark.parametrize("mode", ["disparity", "disparity_dpt_head"])
def test_disparity_with_ssi_raises_in_both(tiny, mode):
    """The main-paper disparity recipes resolve to (mse, ssi, grad) outside
    depth mode, where the JAX step knows only mse, l1 and angular: both
    packages raise ValueError('ssi') on the first call."""
    jcfg = j_resolve(j_load_config(f"configs/train/main_paper/"
                                   f"{'disparity' if mode == 'disparity' else 'disparity_dpt_head_identity'}.yaml"))
    assert jcfg.mode == mode and jcfg.loss_names == ("mse", "ssi", "grad")
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32, fix_timesteps=1)
    with pytest.raises(ValueError, match="ssi"):
        jax_loss_and_grads(tiny[0], jcfg, make_batch())
    cfg = as_port_config(jcfg)
    with pytest.raises(ValueError, match="ssi"):
        port_loss_and_grads(port_models(tiny), cfg, make_batch())


# ------------------------------------------------------------------ DPT head

@pytest.fixture(scope="module")
def head_params():
    return numpy_params(j_dpt.init_dpt_head, j_dpt.DPTHeadConfig(final_act="identity", **TINY_DPT),
                        seed=60)


def head_models(tiny, head_params):
    jmodels, unet_p, vae_p, embed = tiny
    jm = JModels(unet=unet_p, vae=vae_p, unet_cfg=jmodels.unet_cfg, vae_cfg=jmodels.vae_cfg,
                 text_embed=jnp.asarray(embed), dpt_head=head_params,
                 dpt_cfg=j_dpt.DPTHeadConfig(final_act="identity", **TINY_DPT))
    models = port_models(tiny)
    head = DPTHead(DPTHeadConfig(final_act="identity", **TINY_DPT))
    head.load_state_dict(state_dict_from_jax(head_params), strict=True)
    models.dpt_head = head
    return jm, models


@pytest.mark.parametrize("case", ["depth", "frozen_unet"])
def test_dpt_head_training_matches_jax(tiny, head_params, case):
    """The head on the UNet's features, its raw output the prediction; the
    UNet keeps its conv_out (a fresh head on a base checkpoint), whose
    gradients are 0 in both."""
    jm, models = head_models(tiny, head_params)
    kw = dict(mode="depth" if case == "depth" else "disparity_dpt_head", loss_names=("mse",))
    # the frozen-UNet case is ablation/lora/dpt_head_identity_freeze_unet's
    if case == "frozen_unet":
        kw["train_unet"] = False
    jcfg = jax_cfg(**kw)
    ref = jax_loss_and_grads(jm, jcfg, make_batch())
    cfg = dataclasses.replace(as_port_config(jcfg), remat_unet=True)
    port = port_loss_and_grads(models, cfg, make_batch())
    assert_match(port, ref)
    assert any(k.startswith("dpt_head.") for k in port[2])
    assert (case == "frozen_unet") == (not any(k.startswith("unet.") for k in port[2]))


# ---------------------------------------------------- marigold, rgb_blending

def test_replace_unet_conv_in_is_exact(tiny):
    jmodels = tiny[0]
    jp, jcfg = JT.replace_unet_conv_in(jmodels.unet, jmodels.unet_cfg)
    models = port_models(tiny)
    TT.replace_unet_conv_in(models.unet)
    assert models.unet.cfg.in_channels == jcfg.in_channels == 8
    want = state_dict_from_jax({"conv_in": jp["conv_in"]})
    for k, v in want.items():
        assert torch.equal(models.unet.conv_in.state_dict()[k.split(".", 1)[1]], v), k
    with pytest.raises(ValueError):
        TT.replace_unet_conv_in(models.unet)


def jax_draws(jcfg, shape, key):
    """JAX's t and noise in its loss's order: t from the first split, the
    noise (gaussian or multi-resolution, by JAX's own helper) from the
    second; the noise in NCHW."""
    rng, tkey = jax.random.split(key)
    t = jax.random.randint(tkey, (shape[0],), 0, jcfg.num_train_timesteps)
    rng, nkey = jax.random.split(rng)
    if jcfg.multi_res_noise_strength is not None:
        strength = jcfg.multi_res_noise_strength
        if jcfg.multi_res_noise_annealed:
            strength = strength * (t.astype(jnp.float32)
                                   / jcfg.num_train_timesteps).reshape(-1, 1, 1, 1)
        noise = JN.multi_res_noise_like(nkey, shape, strength, jcfg.multi_res_noise_strategy,
                                        jcfg.compute_dtype)
    else:
        noise = jax.random.normal(nkey, shape, jcfg.compute_dtype)
    return {"t": torch.from_numpy(np.asarray(t).astype(np.int64)),
            "noise": torch.from_numpy(np.asarray(noise, np.float32).transpose(0, 3, 1, 2).copy())}


ARCHS = {  # the other noise strategies: tests/test_torch_noise.py; the gaussian
    # draw: test_marigold_gaussian_draws_t_then_noise
    "marigold_multi_res": "configs/train/depth_marigold.yaml",
    "rgb_blending": "configs/train/ablation/beta_values/rgb_blending_0p00085_0p012.yaml",
}
MARIGOLD_GAUSSIAN = ("configs/train/ablation/beta_values/"
                     "wo_rgb_blending_0p0002125_0p003_wo_multi_res_noise.yaml")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_ddpm_archs_match_jax_on_replayed_draws(tiny, arch):
    """The recipe's config (f32, remat off in JAX: it changes no f32 number)
    with JAX's timesteps and noise handed to the port."""
    jcfg = dataclasses.replace(j_resolve(j_load_config(ARCHS[arch])), compute_dtype=jnp.float32,
                               remat_unet=False)
    assert jcfg.arch == arch.split("_")[0] + ("_blending" if arch == "rgb_blending" else "")
    jmodels = tiny[0]
    models = port_models(tiny)
    if jcfg.arch == "marigold":
        up, ucfg = JT.replace_unet_conv_in(jmodels.unet, jmodels.unet_cfg)
        jmodels = dataclasses.replace(jmodels, unet=up, unet_cfg=ucfg)
        TT.replace_unet_conv_in(models.unet)
    key = jax.random.key(3)
    batch = make_batch()
    ref = jax_loss_and_grads(jmodels, jcfg, batch, key)
    draws = jax_draws(jcfg, (2, 8, 8, 4), key)
    cfg = dataclasses.replace(as_port_config(jcfg), remat_unet=True)
    assert_match(port_loss_and_grads(models, cfg, batch, draws), ref)


def test_marigold_port_draws_are_seeded(tiny):
    """Without draws the port takes t and the noise from the generator:
    equal seeds give equal losses, other seeds others."""
    cfg = as_port_config(dataclasses.replace(j_resolve(j_load_config(ARCHS["marigold_multi_res"])),
                                             compute_dtype=jnp.float32))
    models = port_models(tiny)
    TT.replace_unet_conv_in(models.unet)
    fn = TT.build_loss_fn(cfg, models)
    with torch.no_grad():
        a, b, c = (fn(torch_batch(make_batch()), torch.Generator().manual_seed(s))[0]
                   for s in (0, 0, 1))
    assert float(a) == float(b) and float(a) != float(c)


def test_marigold_gaussian_draws_t_then_noise(tiny):
    """The gaussian-noise recipe: the port's loss on its own draws equals
    the loss on t and randn drawn in JAX's order (t first) from the same
    seed and handed in; the loss given the draws is the multi-res recipe's
    code, held to JAX above."""
    cfg = as_port_config(dataclasses.replace(j_resolve(j_load_config(MARIGOLD_GAUSSIAN)),
                                             compute_dtype=jnp.float32))
    assert cfg.arch == "marigold" and cfg.multi_res_noise_strength is None
    assert cfg.fix_timesteps is None
    models = port_models(tiny)
    TT.replace_unet_conv_in(models.unet)
    fn = TT.build_loss_fn(cfg, models)
    g = torch.Generator().manual_seed(0)
    t = torch.randint(0, cfg.num_train_timesteps, (2,), generator=g)
    draws = {"t": t, "noise": torch.randn((2, 4, 8, 8), generator=g)}
    with torch.no_grad():
        own = fn(torch_batch(make_batch()), torch.Generator().manual_seed(0))[0]
        given = fn(torch_batch(make_batch()), draws=draws)[0]
    assert float(own) == float(given)


# --------------------------------------------------- metric3d in the step

def test_metric3d_losses_in_the_step_match_jax(tiny):
    """loss_names (mse, vnl, hdnr, hdsnr) with the batch's K: JAX splits one
    key per metric3d loss in loss_names order; the port takes the replayed
    samples."""
    losses = ("mse", "vnl", "hdnr", "hdsnr")
    batch = make_batch()
    k = np.array([[50.0, 0, 31.5], [0, 50.0, 31.5], [0, 0, 1]], np.float32)
    batch["intrinsic"] = np.stack([k, k])
    key = jax.random.key(5)
    ref = jax_loss_and_grads(tiny[0], jax_cfg(loss_names=losses), batch, key)
    rng, draws = key, {}
    mask = batch["valid_mask"]
    for name in losses[1:]:
        rng, lkey = jax.random.split(rng)
        draws[name] = {"vnl": lambda: vnl_indices(lkey, mask),
                       "hdnr": lambda: hdnl_uniforms(lkey, 2, 32),
                       "hdsnr": lambda: hdsnl_windows(lkey, 64, 64, 32)}[name]()
    port = port_loss_and_grads(port_models(tiny), as_port_config(jax_cfg(loss_names=losses)),
                               batch, draws)
    assert_match(port, ref)
    assert J3 is not None


# ---------------------------------------------------- data, trainer, registry

CAMERAS = ["KITTIDataset", "VirtualKITTIDataset", "NYUDataset", "HypersimDataset",
           "ScanNetDataset", "TaskonomyDataset"]


def bare(module, name, **attrs):
    obj = object.__new__(getattr(module, name))
    for k, v in attrs.items():
        setattr(obj, k, v)
    return obj


@pytest.mark.parametrize("name", CAMERAS)
@pytest.mark.parametrize("crop", [True, False])
def test_intrinsic_for_and_flip_match_jax(name, crop):
    for hw in ((480, 640), (768, 1024), (352, 1216), (375, 1242)):
        want = bare(JD, name, kitti_bm_crop=crop)._intrinsic_for(hw)
        got = bare(TD, name, kitti_bm_crop=crop)._intrinsic_for(hw)
        np.testing.assert_array_equal(got, want)
    rasters = {"rgb_norm": np.zeros((480, 640, 3), np.float32),
               "intrinsic": bare(TD, name, kitti_bm_crop=crop)._intrinsic_for((480, 640))}
    flip = types.SimpleNamespace(lr_flip_p=1.0)
    outs = [bare(m, name, rng=np.random.default_rng(0), augm_args=flip)._augment_data(
        {k: v.copy() for k, v in rasters.items()}) for m in (JD, TD)]
    np.testing.assert_array_equal(outs[1]["intrinsic"], outs[0]["intrinsic"])
    assert outs[1]["intrinsic"][0, 2] == 639 - rasters["intrinsic"][0, 2]


def test_trainer_device_batch_carries_the_intrinsic(tiny, tmp_path):
    cfg = TT.TrainConfig(grad_accum_steps=2)
    trainer = Trainer(cfg, port_models(tiny), [], str(tmp_path))
    raw = {"rgb_norm": np.zeros((4, 8, 8, 3), np.float32),
           "depth_raw_norm": np.zeros((4, 8, 8), np.float32),
           "valid_mask_raw": np.ones((4, 8, 8), bool),
           "intrinsic": np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))}
    batch = trainer._device_batch(raw)
    assert batch["intrinsic"].shape == (2, 2, 3, 3)
    assert batch["intrinsic"].dtype == torch.float32


@pytest.mark.parametrize("recipe", ["main_paper/dis.yaml", "main_paper/seg.yaml",
                                    "others/matting_mse_with_latent_loss.yaml",
                                    "main_paper/depth.yaml"])
def test_single_dataset_recipes_sample(recipe):
    """A single-dataset recipe keeps the depth mixture's prob_ls from its
    base: the JAX CLI hands it to MixedBatchSampler with one dataset, which
    raises on the first batch; the port's CLI passes it for a mixture only."""
    from genpercept_tpu.data import sampler as j_sampler
    from genpercept_tpu_torch.cli.train import sampler_prob
    from genpercept_tpu_torch.data import sampler as t_sampler
    from genpercept_tpu_torch.utils.config import recursive_load_config as t_load_config

    cfg = t_load_config(f"configs/train/{recipe}")
    mixed = cfg.get_path("dataset.train.name") == "mixed"
    assert cfg.get_path("dataset.train.prob_ls") == [0.9, 0.1]
    sources = [list(range(6))] * (2 if mixed else 1)
    if not mixed:
        with pytest.raises(ValueError):
            next(iter(j_sampler.MixedBatchSampler(sources, batch_size=2,
                                                  prob=cfg.get_path("dataset.train.prob_ls"),
                                                  generator=np.random.default_rng(0))))
    assert (sampler_prob(cfg) is None) != mixed
    batches = list(t_sampler.MixedBatchSampler(sources, batch_size=2, prob=sampler_prob(cfg),
                                               generator=np.random.default_rng(0)))
    assert len(batches) == 3 * len(sources)


def test_registry_mirrors_jax():
    assert set(t_registry.trainer_cls_name_dict) == set(j_registry.trainer_cls_name_dict)
    assert t_registry.get_trainer_cls("GenPerceptTrainer") is Trainer
    with pytest.raises(KeyError):
        t_registry.get_trainer_cls("nope")


# ------------------------------------------------ chip_smoke's train_extras

def _meta_step_launches(hw, micro, losses, monkeypatch):
    """Kernel launches of one of the port's micro-steps with the recipes'
    remat at full SD2.1 width on the meta device (the launchers stubbed by
    counters), as tests/test_torch_train.py counts the depth recipe's."""
    from genpercept_tpu_torch.models import AutoencoderKL, UNet2DConditionModel
    from genpercept_tpu_torch.ops import _dispatch
    from genpercept_tpu_torch.ops import flash_attention as tfa
    from genpercept_tpu_torch.ops import fused_ff as tff
    from genpercept_tpu_torch.pipeline import GenPerceptModels

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
    h, w = hw
    with torch.device("meta"):
        models = GenPerceptModels(unet=UNet2DConditionModel(), vae=AutoencoderKL(),
                                  text_embed=torch.empty(1, 77, 1024))
        batch = {"rgb_norm": torch.empty(micro, h, w, 3), "gt_norm": torch.empty(micro, h, w, 3),
                 "valid_mask": torch.empty(micro, h, w, dtype=torch.bool)}
    cfg = TT.TrainConfig(fix_timesteps=1, compute_dtype=torch.bfloat16, remat_unet=True,
                         loss_names=losses)
    trainable, _, _ = TT.init_train_state(models, cfg)
    loss, _ = TT.build_loss_fn(cfg, models)(batch)
    torch.autograd.grad(loss, list(trainable.values()))
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("hw,micro,decode", [((768, 768), 4, True), ((480, 640), 2, True),
                                             ((480, 640), 8, False), ((768, 768), 16, False)])
def test_chip_smoke_train_extras_launches(hw, micro, decode, monkeypatch):
    """chip_smoke.py's train_extras derives each recipe's launches per
    micro-step from the routing predicates: they equal the port's own on
    the meta device (768^2 with the decode, as normal and dis; LoRA's
    480x640 micro-batch of 2, whose 9600 rows leave K2 out; the latent-only
    archs; the DPT head's 768^2 micro-batch of 16 without the decode)."""
    import chip_smoke as cs

    want = cs.train_step_launches(hw, micro, decode)
    got = _meta_step_launches(hw, micro, ("mse",) if decode else ("latent_mse",), monkeypatch)
    assert {k: want[k] for k in got} == got
    assert not any(v for k, v in want.items() if k not in got)
    assert cs.train_step_launches(cs.TRAIN_HW, cs.MICRO, True) == cs.STEP_LAUNCHES


def test_chip_smoke_train_extras_recipes(tmp_path):
    """Each train_extras recipe, pointed at the phase's files, changes only
    the keys the phase may change, resolves as the JAX package resolves the
    recipe file (dtypes mapped), and draws its first steps from the source
    the phase expects (Hypersim, or DIS5K alone)."""
    import chip_smoke as cs
    from genpercept_tpu_torch.cli.train import resolve_train_config as t_resolve_cfg
    from genpercept_tpu_torch.utils.config import recursive_load_config as t_load

    data = {k: (k, str(tmp_path / k)) for k in ("train", "train_gt", "dis5k", "vkitti", "val",
                                                "vis")}
    for name, recipe in cs.TX_RUNS.items():
        cfg = cs.write_extra_recipe(tmp_path / f"{name}.yaml", recipe, data)
        hw, micro, accum, sources = cs.tx_geometry(cfg)
        loaded = t_load(str(tmp_path / f"{name}.yaml"))
        mode = loaded.get_path("pipeline.kwargs.mode", loaded.get("mode", "depth"))
        want = as_port_config(j_resolve(j_load_config(recipe), grad_accum_steps=accum))
        assert t_resolve_cfg(loaded, grad_accum_steps=accum, mode=mode) == want, name
        assert sources == (["dis5k"] if name == "dis_latent" else ["hypersim"]) * cs.TX_STEPS
        assert hw == ((768, 768) if name in ("normal", "dis_latent", "dpt_head") else (480, 640))
        assert micro * accum == 32, name
        entries = cs.tx_entries(cfg["dataset"]["train"])
        assert entries[0]["dir"] == ("train_gt" if name == "normal" else
                                     "dis5k" if name == "dis_latent" else "train"), name
