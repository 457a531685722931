"""The port's one-step depth slice held to the JAX pipeline on tiny models.

Both pipelines get the same weights (the JAX ``init_*`` trees filled from a
numpy seed, moved with ``state_dict_from_jax``), the same text embedding
and the same uint8 images. The bar is the JAX package's golden bar
(tests/test_golden_768.py): mean absolute depth deviation <= 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpercept_tpu.models import UNetConfig as JUNetConfig
from genpercept_tpu.models import VAEConfig as JVAEConfig
from genpercept_tpu.models import init_unet, init_vae
from genpercept_tpu.pipeline import GenPerceptModels as JModels
from genpercept_tpu.pipeline import GenPerceptPipeline as JPipeline
from genpercept_tpu.pipeline import PipelineConfig as JConfig
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.models import (
    AutoencoderKL,
    UNet2DConditionModel,
    UNetConfig,
    VAEConfig,
)
from genpercept_tpu_torch.pipeline import (
    GenPerceptModels,
    GenPerceptPipeline,
    PipelineConfig,
    build_single_infer,
)
from test_torch_models import numpy_params

torch.set_num_threads(1)

MEAN_TOL = 1e-4
TINY_UNET = dict(block_out_channels=(32, 64, 128, 128),
                 attention_heads=(1, 2, 4, 4), cross_attention_dim=48)
TINY_VAE = dict(block_out_channels=(32, 32, 64, 64))


@pytest.fixture(scope="module")
def pipes():
    ucfg, vcfg = JUNetConfig(**TINY_UNET), JVAEConfig(**TINY_VAE)
    unet_p = numpy_params(init_unet, ucfg, seed=0)
    vae_p = numpy_params(init_vae, vcfg, seed=1)
    embed = np.random.default_rng(2).normal(size=(1, 77, 48)).astype(np.float32)

    jmodels = JModels(unet=unet_p, vae=vae_p, unet_cfg=ucfg, vae_cfg=vcfg,
                      text_embed=jnp.asarray(embed))
    unet = UNet2DConditionModel(UNetConfig(**TINY_UNET))
    unet.load_state_dict(state_dict_from_jax(unet_p), strict=True)
    vae = AutoencoderKL(VAEConfig(**TINY_VAE))
    vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
    tmodels = GenPerceptModels(unet=unet, vae=vae, text_embed=torch.from_numpy(embed))
    jpipe = JPipeline(jmodels, JConfig(mode="depth", processing_res=64))
    tpipe = GenPerceptPipeline(tmodels, PipelineConfig(mode="depth", processing_res=64),
                               device="cpu")
    return jpipe, tpipe


def images(seed, shapes):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(size=s + (3,)) * 255).astype(np.uint8) for s in shapes]


def assert_depth_close(ours, ref):
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all() and ours.min() >= 0.0 and ours.max() <= 1.0
    assert float(np.mean(np.abs(ours - ref))) <= MEAN_TOL


# Every JAX call below runs at one shape, (1, 64, 51, 3): the JAX pipeline
# compiles once per shape, which is most of this file's time on one core.


def test_single_infer_matches_jax(pipes):
    jpipe, tpipe = pipes
    rgb = np.random.default_rng(3).uniform(size=(1, 64, 51, 3)).astype(np.float32)
    ref = np.asarray(jpipe._infer(jpipe._params, jnp.asarray(rgb), None))
    ours = build_single_infer(tpipe.models, tpipe.cfg)(torch.from_numpy(rgb))
    assert ours.dtype == torch.float32
    assert_depth_close(ours.numpy(), ref)


def test_call_non_square_uint8_matches_jax(pipes):
    """100x80 uint8 -> 64x51 processing -> back to 100x80, colorized."""
    jpipe, tpipe = pipes
    (img,) = images(4, [(100, 80)])
    ref, ours = jpipe(img), tpipe(img)
    assert_depth_close(ours.pred_np, ref.pred_np)
    assert ours.pred_colored.shape == (100, 80, 3)
    assert ours.pred_colored.dtype == np.uint8
    diff = np.abs(ours.pred_colored.astype(int) - ref.pred_colored.astype(int))
    assert diff.max() <= 1  # truncation to uint8 at a boundary


def test_batch_matches_jax(pipes):
    """The port batches two images of one processing shape and runs the
    third alone; each must equal the JAX pipeline's single-image result."""
    jpipe, tpipe = pipes
    imgs = images(5, [(100, 80), (200, 160), (50, 40)])
    ours = tpipe.batch(imgs, batch_size=2)
    ref = jpipe.batch(imgs, batch_size=1)
    for o, r, im in zip(ours, ref, imgs):
        assert o.pred_np.shape == im.shape[:2]
        assert_depth_close(o.pred_np, r.pred_np)


def test_batch_needs_batch_size(pipes):
    with pytest.raises(ValueError):
        pipes[1].batch(images(4, [(64, 64)]), batch_size=0)


@pytest.mark.parametrize("field,value", [
    ("arch", "marigold"), ("ensemble_size", 3), ("fused_vae", True),
    ("int8_gptq", True), ("fix_timesteps", 10),
    ("mode", "disparity_dpt_head"),
])
def test_unported_config_raises(field, value):
    with pytest.raises(NotImplementedError):
        PipelineConfig(**{field: value})


@pytest.mark.parametrize("fields", [
    dict(int8_vae=True), dict(int8_vae=True, int8_unet=True, int8_unet_ff=True,
                              int8_vae_attn=True),
    dict(int8_vae=True, int8_unet=True, int8_unet_dense=True, int8_weight_clip=True,
         int8_exclude=(), int8_refine=False, int8_asymmetric=False, int8_selfcheck=False,
         int8_margin=1.2),
])
def test_int8_config_accepted(fields):
    assert PipelineConfig(**fields).int8_vae


def test_int8_unet_needs_int8_vae():
    with pytest.raises(AssertionError):
        PipelineConfig(int8_unet=True)


def test_pipeline_defaults_to_the_card(pipes, monkeypatch):
    """Without a card and without device="cpu" the pipeline raises: it never
    falls back to the CPU unasked."""
    import inspect

    assert inspect.signature(GenPerceptPipeline).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        GenPerceptPipeline(pipes[1].models, pipes[1].cfg)


def test_config_fields_mirror_jax():
    import dataclasses

    names = [f.name for f in dataclasses.fields(PipelineConfig)]
    assert names == [f.name for f in dataclasses.fields(JConfig)]
